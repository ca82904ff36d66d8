"""desco_tpu_torch's halo path (parallel/halo.py, parallel/overlap_check.py)
against desco_tpu's, on the CPU.

desco_tpu runs its per-shard code under ``shard_map`` over 4 of the 8
fake host devices tests/conftest.py sets up; the port runs the same 4
shards in one process on the CPU (its plain versions). Same numpy inputs
from a seed, same weights (desco_tpu's init, carried over with
``params_from_jax``), dropout 0.

Tolerances: partitions and locality orders array-equal; the typed halo
aggregate rtol 1e-5 / atol 1e-6; the SHMP core (SAGE, GIN, GCN, GAT) and
the gossip forward rtol 1e-4 / atol 1e-5, desco_tpu's own bound
(tests/test_halo.py); PNA rtol 2e-4 / atol 1e-4, tests/test_torch_convs.py's
bound (the port takes its variance in two passes); the gossip loss rtol
1e-5 and its gradients rtol 1e-4 with atol 1e-6 of each tensor's scale
(tests/test_torch_grad.py)."""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from conftest import random_graph
from desco_tpu.batch.build import gossip_sample as j_gossip_sample
from desco_tpu.batch.build import neighborhood_sample
from desco_tpu.graph import canonical_neighborhood
from desco_tpu.models import gossip as jgossip
from desco_tpu.models import shmp_gnn as jshmp
from desco_tpu.parallel import halo as jhalo
from desco_tpu.parallel.dp import make_mesh
from desco_tpu.train.checkpoint import _flatten
from desco_tpu_torch.batch.build import gossip_sample
from desco_tpu_torch.batch.packed import auto_capacities, pack_samples
from desco_tpu_torch.graph import Graph
from desco_tpu_torch.models import gossip as tgossip
from desco_tpu_torch.models import shmp_gnn as tshmp
from desco_tpu_torch.parallel import halo
from desco_tpu_torch.parallel.overlap_check import check_halo_overlap
from desco_tpu_torch.train.checkpoint import params_from_jax
from desco_tpu_torch.train.loop import make_adam

from test_torch_grad import assert_grads_match, flatten_grads
from test_torch_shmp import one_torch_thread  # noqa: F401 (autouse)

N_DEV = 4
CPU = [torch.device("cpu")]
FIELDS = ("x", "node_type", "node_mask", "node_graph", "edge_src_int",
          "edge_seg_int", "edge_src_bnd", "edge_seg_bnd", "send_idx",
          "send_mask", "push_tgt", "node_y", "node_range")


def typed_graph(seed=0, n=50, p=0.15):
    """A random graph's nearly whole canonical neighborhood as a typed
    sample (6 edge types), as tests/test_halo.py builds it."""
    g = random_graph(np.random.default_rng(seed), n, p)
    return neighborhood_sample(canonical_neighborhood(g, n - 1, depth=10))


def hub_graph(n=64):
    """A star-like typed hub graph: unique (dst, type) cells << unique
    sources, so the partitioner picks PUSH pairs."""
    hub = n - 1
    src = np.concatenate([np.arange(n - 1), np.full(n - 2, hub)])
    dst = np.concatenate([np.full(n - 1, hub), np.arange(1, n - 1)])
    ety = np.concatenate([np.zeros(n - 1, np.int32),
                          np.ones(n - 2, np.int32)])
    return n, src.astype(np.int32), dst.astype(np.int32), ety


def both_partitions(*args, **kw):
    return (jhalo.partition_typed_graph(*args, **kw),
            halo.partition_typed_graph(*args, **kw))


def assert_same_partition(jp, tp):
    for f in FIELDS:
        a, b = getattr(jp, f), getattr(tp, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=f)
            assert np.asarray(a).dtype == b.dtype, f
    assert (jp.n_graphs, jp.n_types) == (tp.n_graphs, tp.n_types)
    assert halo.partition_caps(tp) == jhalo.partition_caps(jp)


def mesh():
    return jax.sharding.Mesh(make_mesh(N_DEV).devices, ("graph",))


def run_sharded(fn, *args, replicated=0):
    """``fn(*replicated args, shard, ...)`` under shard_map over 4 of the
    fake devices; per-shard outputs gathered to [D, ...]."""
    specs = tuple([P()] * replicated
                  + [P("graph")] * (len(args) - replicated))

    @partial(jax.shard_map, mesh=mesh(), in_specs=specs,
             out_specs=P("graph"))
    def run(*a):
        a = list(a)
        for i in range(replicated, len(a)):
            a[i] = jax.tree_util.tree_map(lambda v: v[0], a[i])
        return fn(*a)[None]

    with mesh():
        return np.asarray(jax.jit(run)(*args))


def port_nodes(part, outs):
    return halo.unpartition_nodes(
        part, np.stack([o.detach().numpy() for o in outs]))


# ------------------------------------------------------------ partitioner
@pytest.mark.parametrize("case", ["default", "force_pull", "drop_cross",
                                  "min_caps", "hub_push", "hub_pull",
                                  "one_shard", "labels"])
def test_partition_is_array_equal(case):
    if case.startswith("hub"):
        n, src, dst, ety = hub_graph()
        x = np.random.default_rng(1).standard_normal((n, 8)).astype(
            np.float32)
        jp, tp = both_partitions(n, np.zeros(n, np.int32), x, src, dst, ety,
                                 N_DEV, n_types=2,
                                 force_pull=case == "hub_pull")
        assert (tp.p_max > 0) == (case == "hub_push")
    else:
        s = typed_graph()
        kw = {"default": {}, "force_pull": {"force_pull": True},
              "drop_cross": {"drop_cross": True},
              "min_caps": {"min_caps": {"n_loc": 40, "e_int": 512,
                                        "e_bnd": 256, "h_max": 24,
                                        "p_max": 16}},
              "one_shard": {},
              "labels": {"node_y": np.arange(2 * s.n_nodes, dtype=np.float32)
                         .reshape(-1, 2),
                         "node_graph": (np.arange(s.n_nodes) > 20)
                         .astype(np.int32), "n_graphs": 2}}[case]
        d = 1 if case == "one_shard" else N_DEV
        jp, tp = both_partitions(s.n_nodes, s.node_type, s.x, s.edge_src,
                                 s.edge_dst, s.edge_type, d, n_types=6, **kw)
        if case == "drop_cross":
            assert tp.send_mask.sum() == 0 and tp.p_max == 0
        if case == "one_shard":
            assert tp.edge_src_bnd.shape[-1] == 0 and tp.p_max == 0
    assert_same_partition(jp, tp)


def community_graph(n=600, k=4, seed=7):
    per = n // k
    r = np.random.default_rng(seed)
    edges = set()
    while len(edges) < 2400:
        c = r.integers(k)
        u, v = c * per + r.integers(0, per, 2)
        if u != v:
            edges.add((min(u, v), max(u, v)))
    while len(edges) < 2450:
        u, v = r.integers(0, n, 2)
        if u != v and u // per != v // per:
            edges.add((min(u, v), max(u, v)))
    e = np.array(sorted(edges), np.int64)
    perm = r.permutation(n)
    return n, perm[e[:, 0]], perm[e[:, 1]]


@pytest.mark.parametrize("method", ["metis", "bfs"])
@pytest.mark.parametrize("graph", ["community", "hub"])
def test_locality_orders_are_array_equal(method, graph):
    if graph == "community":
        n, src, dst = community_graph()
    else:
        n, src, dst, _ = hub_graph(300)
    want = jhalo.locality_order(n, src, dst, method=method)
    got = halo.locality_order(n, src, dst, method=method)
    np.testing.assert_array_equal(got, want)
    assert sorted(got.tolist()) == list(range(n))
    np.testing.assert_array_equal(halo.bfs_locality_order(n, src, dst),
                                  jhalo.bfs_locality_order(n, src, dst))


def test_node_value_layout_round_trips():
    s = typed_graph(seed=3)
    part = halo.partition_typed_graph(
        s.n_nodes, s.node_type, s.x, s.edge_src, s.edge_dst, s.edge_type,
        N_DEV, n_types=6)
    vals = np.arange(3 * s.n_nodes, dtype=np.float32).reshape(-1, 3)
    sharded = halo.partition_node_values(part, vals)
    assert sharded.shape == (N_DEV, part.n_loc, 3)
    np.testing.assert_array_equal(halo.unpartition_nodes(part, sharded),
                                  vals)


# ------------------------------------------------------------- aggregate
@pytest.mark.parametrize("graph", ["typed", "hub_push"])
def test_halo_typed_aggregate_matches_desco_tpu(graph):
    rng = np.random.default_rng(5)
    if graph == "typed":
        s = typed_graph()
        n, nt, src, dst, ety, t = (s.n_nodes, s.node_type, s.edge_src,
                                   s.edge_dst, s.edge_type, 6)
    else:
        n, src, dst, ety = hub_graph()
        nt, t = np.zeros(n, np.int32), 2
    x = rng.standard_normal((n, 8)).astype(np.float32)
    jp, tp = both_partitions(n, nt, x, src, dst, ety, N_DEV, n_types=t)
    assert (tp.p_max > 0) == (graph == "hub_push")
    want = halo.unpartition_nodes(tp, run_sharded(
        lambda sh: jhalo.halo_typed_aggregate(sh.x, sh), jp))
    shards = halo.place_shards(tp, CPU)
    got = port_nodes(tp, halo.halo_typed_aggregate(
        [sh.x for sh in shards], shards))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ SHMP tower
def tower(conv, layers=2, hidden=8, seed=2):
    kw = dict(layer_num=layers, hidden_dim=hidden, conv_type=conv)
    jcfg = jshmp.neighborhood_target_config(**kw)
    jparams = jshmp.init_shmp(jax.random.PRNGKey(seed), jcfg)
    return (jcfg, jparams), (tshmp.neighborhood_target_config(**kw),
                             params_from_jax(_flatten(jparams)))


@pytest.mark.parametrize("conv", ["SAGE", "GIN", "GCN", "GAT", "PNA"])
def test_halo_shmp_core_matches_desco_tpu(conv):
    s = typed_graph(n=40)
    (jcfg, jparams), (tcfg, tparams) = tower(conv, layers=3 if conv == "SAGE"
                                             else 2)
    pull = conv in ("GAT", "PNA")
    jp, tp = both_partitions(s.n_nodes, s.node_type, s.x, s.edge_src,
                             s.edge_dst, s.edge_type, N_DEV,
                             n_types=tcfg.n_edge_types, force_pull=pull)
    want = halo.unpartition_nodes(tp, run_sharded(
        lambda p, sh: jhalo.halo_shmp_core(p, jcfg, sh), jparams, jp,
        replicated=1))
    shards = halo.place_shards(tp, CPU)
    with torch.inference_mode():
        got = port_nodes(tp, halo.halo_shmp_core(tparams, tcfg, shards))
    tol = dict(rtol=2e-4, atol=1e-4) if conv == "PNA" else dict(
        rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("conv", ["GAT", "PNA"])
def test_halo_attention_and_pna_reject_push(conv):
    n, src, dst, ety = hub_graph()
    x = np.random.default_rng(0).standard_normal((n, 8)).astype(np.float32)
    part = halo.partition_typed_graph(n, np.zeros(n, np.int32), x, src, dst,
                                      ety, N_DEV, n_types=2)
    assert part.p_max > 0
    cfg = tshmp.SHMPConfig(n_node_types=1, n_edge_types=2,
                           edge_dst_type=(0, 0), conv_type=conv,
                           hidden_dim=8, layer_num=1)
    params = tshmp.init_shmp(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="force_pull"):
        halo.halo_shmp_core(params, cfg, halo.place_shards(part, CPU))


@pytest.mark.parametrize("conv", ["SAGE", "GAT", "PNA"])
def test_halo_shmp_core_matches_packed_port(conv):
    """The port's halo tower equals its own packed ``apply_shmp_core`` on
    the same sample, value and gradients."""
    s = typed_graph(seed=4, n=45)
    s.x = np.random.default_rng(4).standard_normal(
        (s.n_nodes, 1)).astype(np.float32)
    _, (tcfg, tparams) = tower(conv, layers=3)
    [b] = pack_samples([s], *auto_capacities([s], g_cap=1))
    part = halo.partition_typed_graph(
        s.n_nodes, s.node_type, s.x, s.edge_src, s.edge_dst, s.edge_type,
        N_DEV, n_types=6, force_pull=conv != "SAGE")
    shards = halo.place_shards(part, CPU)
    w = torch.randn(s.n_nodes, tcfg.post_input_dim,
                    generator=torch.Generator().manual_seed(1))
    ref = tshmp.apply_shmp_core(tparams, tcfg, b.to("cpu"))[:s.n_nodes]
    (ref * w).sum().backward()
    want_g = {k: v.copy() for k, v in flatten_grads(tparams).items()}
    tparams.zero_grad()
    got = halo.halo_shmp_core(tparams, tcfg, shards)
    got = torch.cat([o[:int(r[1] - r[0])]
                     for o, r in zip(got, part.node_range)])
    (got * w).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(),
                               rtol=1e-4, atol=1e-5)
    for key, g in flatten_grads(tparams).items():
        scale = float(np.abs(want_g[key]).max())
        np.testing.assert_allclose(g, want_g[key], rtol=1e-4,
                                   atol=1e-6 * max(scale, 1e-30),
                                   err_msg=key)


def test_halo_graph_pool_matches_packed_pooling():
    s = typed_graph(seed=6)
    ng = (np.arange(s.n_nodes) >= s.n_nodes // 3).astype(np.int32)
    part = halo.partition_typed_graph(
        s.n_nodes, s.node_type, s.x, s.edge_src, s.edge_dst, s.edge_type,
        N_DEV, n_types=6, node_graph=ng, n_graphs=2)
    shards = halo.place_shards(part, CPU)
    emb = np.random.default_rng(6).standard_normal(
        (s.n_nodes, 5)).astype(np.float32)
    embs = [torch.from_numpy(e) for e in halo.partition_node_values(part,
                                                                    emb)]
    got = halo.halo_graph_pool(embs, shards, 2).numpy()
    want = np.stack([emb[ng == 0].sum(0), emb[ng == 1].sum(0)])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- gossip
def gossip_case(seed=3, n=36, p=0.15, n_q=2, hidden=8):
    rng = np.random.default_rng(seed)
    jg = random_graph(rng, n, p)
    g = Graph(jg.n_nodes, jg.edges)
    counts = rng.random((n, n_q)).astype(np.float32)
    truth = rng.random((n, n_q)).astype(np.float32)
    s = gossip_sample(g, counts, truth)
    js = j_gossip_sample(jg, counts, truth)
    for f in ("edge_src", "edge_dst", "edge_type"):
        np.testing.assert_array_equal(getattr(s, f), getattr(js, f))
    jp = jgossip.init_gossip_model(jax.random.PRNGKey(seed), hidden_dim=hidden,
                                   emb_channels=hidden)
    q_embs = rng.standard_normal((n_q, hidden)).astype(np.float32)
    return g, s, counts, truth, jp, params_from_jax(_flatten(jp)), q_embs


def test_halo_gossip_single_matches_desco_tpu():
    g, s, counts, truth, jp, tp, q_embs = gossip_case()
    n = g.n_nodes
    jpart, tpart = both_partitions(n, s.node_type, counts, s.edge_src,
                                   s.edge_dst, s.edge_type, N_DEV,
                                   node_y=truth, n_types=2)
    xcol = halo.partition_node_values(tpart, counts)[:, :, 0]
    want = halo.unpartition_nodes(tpart, run_sharded(
        lambda p, q, sh, xc: jhalo.halo_gossip_single(p, sh, xc, q),
        jp, jnp.asarray(q_embs[0]), jpart, jnp.asarray(xcol),
        replicated=2))
    shards = halo.place_shards(tpart, CPU)
    with torch.inference_mode():
        got = port_nodes(tpart, halo.halo_gossip_single(
            tp, shards, [sh.x[:, 0] for sh in shards],
            torch.from_numpy(q_embs[0])))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # and the port's packed gossip on the same graph
    [b] = pack_samples([s], *auto_capacities([s], g_cap=1), n_queries=2)
    with torch.inference_mode():
        packed = tgossip.apply_gossip_single(
            tp, b.to("cpu"), torch.from_numpy(b.x[:, 0]),
            torch.from_numpy(q_embs[0])).numpy()[:n]
    np.testing.assert_allclose(got, packed, rtol=1e-4, atol=1e-5)


def test_halo_gossip_loss_and_gradients_match_desco_tpu():
    g, s, counts, truth, jp, tp, q_embs = gossip_case(seed=5)
    jpart, tpart = both_partitions(g.n_nodes, s.node_type, counts,
                                   s.edge_src, s.edge_dst, s.edge_type,
                                   N_DEV, node_y=truth, n_types=2)

    @partial(jax.shard_map, mesh=mesh(), in_specs=(P(), P("graph"), P()),
             out_specs=(P(), P()))
    def lg(params, part, q):
        shard = jax.tree_util.tree_map(lambda a: a[0], part)
        return jax.value_and_grad(
            lambda p: jhalo.halo_gossip_loss(p, shard, q))(params)

    with mesh():
        want, jgrads = jax.jit(lg)(jp, jpart, jnp.asarray(q_embs))
    shards = halo.place_shards(tpart, CPU)
    loss = halo.halo_gossip_loss(tp, shards, torch.from_numpy(q_embs))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    assert_grads_match(tp, jgrads, min_nonzero=10)
    # the port's packed loss on the same graph
    tp2 = params_from_jax(_flatten(jp))
    [b] = pack_samples([s], *auto_capacities([s], g_cap=1), n_queries=2,
                       need_bwd_perm=True)
    packed = tgossip.gossip_loss(tp2, b.to("cpu", training=True),
                                 torch.from_numpy(q_embs))
    packed.backward()
    np.testing.assert_allclose(float(loss.detach()), float(packed.detach()),
                               rtol=1e-5)
    for key, gr in flatten_grads(tp).items():
        ref = flatten_grads(tp2)[key]
        np.testing.assert_allclose(gr, ref, rtol=1e-4,
                                   atol=1e-6 * max(np.abs(ref).max(), 1e-30),
                                   err_msg=key)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_halo_gossip_step_updates_and_repeats(dropout):
    """One halo train step moves the parameters with a finite loss; two
    steps from the same weights and seed give the same bits."""
    g, s, counts, truth, jp, _, q_embs = gossip_case(seed=7, n=30, p=0.2)
    part = halo.partition_typed_graph(g.n_nodes, s.node_type, counts,
                                      s.edge_src, s.edge_dst, s.edge_type,
                                      N_DEV, node_y=truth, n_types=2)
    shards = halo.place_shards(part, CPU)
    runs = []
    for _ in range(2):
        tp = params_from_jax(_flatten(jp))
        before = {k: v.detach().clone() for k, v in tp.named_parameters()}
        opt = make_adam(tp)
        step = halo.halo_gossip_step_fn(opt, dropout=dropout)
        loss, ok = step(tp, shards, torch.from_numpy(q_embs), 1e-3, seed=11)
        assert bool(ok) and np.isfinite(float(loss))
        moved = sum(float((v.detach() - before[k]).abs().sum())
                    for k, v in tp.named_parameters())
        assert moved > 0.0
        runs.append((float(loss), opt.grad.clone()))
    assert runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_graphed_halo_gossip_step_equals_eager(dropout):
    """Three calls (seeds 11, 12, 11) of the halo train step's graphed
    form (static buffers for the query embeddings and the learning rate,
    no capture on the CPU) against the eager step from the same weights:
    losses, flags, gradients, parameters and Adam's moments bit for bit.
    The graphed form replays over its first call's shards only."""
    g, s, counts, truth, jp, _, q_embs = gossip_case(seed=7, n=30, p=0.2)
    part = halo.partition_typed_graph(g.n_nodes, s.node_type, counts,
                                      s.edge_src, s.edge_dst, s.edge_type,
                                      N_DEV, node_y=truth, n_types=2)
    shards = halo.place_shards(part, CPU)
    q = torch.from_numpy(q_embs)
    runs = []
    for graphed in (False, True):
        tp = params_from_jax(_flatten(jp))
        opt = make_adam(tp)
        step = halo.halo_gossip_step_fn(opt, dropout=dropout,
                                        graphed=graphed)
        calls = []
        for seed in (11, 12, 11):
            loss, ok = step(tp, shards, q, 1e-3, seed=seed)
            calls.append((loss, ok, opt.grad.clone(), opt.flat.clone(),
                          opt.mu.clone(), opt.nu.clone()))
        runs.append(calls)
    for a, b in zip(*runs):
        assert bool(a[1]) and np.isfinite(float(a[0]))
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(runs[0][0][0], runs[0][2][0])
    with pytest.raises(ValueError, match="first call"):
        step(tp, halo.place_shards(part, CPU), q, 1e-3)


def test_direction_degrees_are_computed_once_per_partition(monkeypatch):
    """The direction degrees equal the halo aggregation of the node masks,
    are kept on the shards at the first call (a loss then runs 2 halo
    aggregations per query, none for the degrees), are no inference
    tensors when the first call ran in inference mode, and a loss and
    its gradients on shards with kept degrees equal those on fresh
    shards bit for bit."""
    g, s, counts, truth, jp, tp, q_embs = gossip_case(seed=5)
    part = halo.partition_typed_graph(g.n_nodes, s.node_type, counts,
                                      s.edge_src, s.edge_dst, s.edge_type,
                                      N_DEV, node_y=truth, n_types=2)
    shards = halo.place_shards(part, CPU)
    want = [a[..., 0] for a in halo.halo_typed_aggregate(
        [sh.node_mask[:, None] for sh in shards], shards)]
    with torch.inference_mode():
        first = halo.halo_direction_degrees(shards)
    assert all(torch.equal(a, b) and not a.is_inference()
               for a, b in zip(first, want))
    assert all(a is b for a, b in
               zip(first, halo.halo_direction_degrees(shards)))
    calls = []
    agg = halo.halo_typed_aggregate
    monkeypatch.setattr(halo, "halo_typed_aggregate",
                        lambda *a, **k: calls.append(1) or agg(*a, **k))
    q = torch.from_numpy(q_embs)
    kept = halo.halo_gossip_loss(tp, shards, q)
    assert len(calls) == 2 * len(q_embs)
    kept.backward()
    g_kept = torch.cat([p.grad.reshape(-1) for p in tp.parameters()
                        if p.grad is not None])
    tp2 = params_from_jax(_flatten(jp))
    fresh = halo.halo_gossip_loss(tp2, halo.place_shards(part, CPU), q)
    fresh.backward()
    g_fresh = torch.cat([p.grad.reshape(-1) for p in tp2.parameters()
                         if p.grad is not None])
    assert torch.equal(kept.detach(), fresh.detach())
    assert torch.equal(g_kept, g_fresh)


def test_serve_gossip_counts_matches_packed_gossip_predict():
    g, s, counts, _, jp, tp, _ = gossip_case(seed=9, n=60, p=0.1, n_q=3)
    q_embs = np.random.default_rng(9).standard_normal((3, 8)).astype(
        np.float32)
    [b] = pack_samples([s], *auto_capacities([s], g_cap=1), n_queries=3)
    with torch.inference_mode():
        want = tgossip.gossip_predict(tp, b.to("cpu"),
                                      torch.from_numpy(q_embs)).numpy()[
                                          :g.n_nodes]
    for d in (1, N_DEV):
        got, stats = halo.serve_gossip_counts(
            tp, g, counts, torch.from_numpy(q_embs), n_devices=d,
            return_stats=True, device="cpu")
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        assert stats["n_devices"] == d and stats["n_loc"] >= g.n_nodes / d
    jwant = jhalo.serve_gossip_counts(jp, random_graph(
        np.random.default_rng(9), 60, 0.1), counts, jnp.asarray(q_embs),
        n_devices=N_DEV)
    np.testing.assert_allclose(got, jwant, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------ the overlap
def test_overlap_check_proves_stream_independence():
    s = typed_graph()
    _, (tcfg, tparams) = tower("SAGE", layers=3)
    part = halo.partition_typed_graph(
        s.n_nodes, s.node_type, s.x, s.edge_src, s.edge_dst, s.edge_type,
        N_DEV, n_types=6)
    shards = halo.place_shards(part, CPU)
    rep = check_halo_overlap(
        lambda: halo.halo_shmp_core(tparams, tcfg, shards))
    assert rep.ok, rep.summary()
    assert rep.pull_layers == {0, 1, 2}
    assert rep.interior_layers == {0, 1, 2}
    assert rep.boundary_layers == {0, 1, 2}

    # a push partition: the boundary stream stays off the push exchange
    n, src, dst, ety = hub_graph()
    x = np.random.default_rng(2).standard_normal((n, 8)).astype(np.float32)
    hub = halo.place_shards(halo.partition_typed_graph(
        n, np.zeros(n, np.int32), x, src, dst, ety, N_DEV, n_types=2), CPU)
    rep = check_halo_overlap(lambda: halo.halo_typed_aggregate(
        [sh.x for sh in hub], hub, tag="_L0"))
    assert rep.ok and rep.push_layers == {0}, rep.summary()

    # negative controls: the interior stream made to consume the pull
    # result, and the boundary stream the push result
    def bad_interior():
        xs = [sh.x for sh in shards]
        with torch.profiler.record_function("halo_pull_L0"):
            halos = halo.halo_exchange(xs, shards)
        with torch.profiler.record_function("halo_interior_L0"):
            return [halo.gather_segment_sum(x + h.sum() * 0.0, sh.interior)
                    for x, h, sh in zip(xs, halos, shards)]

    rep_bad = check_halo_overlap(bad_interior)
    assert not rep_bad.ok
    assert any("interior_L0 depends on pull_L0" in v[0]
               for v in rep_bad.violations), rep_bad.summary()

    def bad_boundary():
        xs = [sh.x for sh in hub]
        with torch.profiler.record_function("halo_pull_L0"):
            halos = halo.halo_exchange(xs, hub)
        with torch.profiler.record_function("halo_interior_L0"):
            combs = [halo.gather_segment_sum(x, sh.interior)
                     for x, sh in zip(xs, hub)]
        with torch.profiler.record_function("halo_push_L0"):
            pushed = [torch.stack([c[-8:] for c in combs]) for _ in hub]
        with torch.profiler.record_function("halo_boundary_L0"):
            return [halo.gather_segment_sum(h + p.sum() * 0.0, sh.boundary)
                    for h, p, sh in zip(halos, pushed, hub)
                    if sh.boundary is not None]

    rep_bad = check_halo_overlap(bad_boundary)
    assert any("boundary_L0 depends on push_L0" in v[0]
               for v in rep_bad.violations), rep_bad.summary()
    # and a function with no halo region is no pass
    assert not check_halo_overlap(lambda: shards[0].x * 2).ok
