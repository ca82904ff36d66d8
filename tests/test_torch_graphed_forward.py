"""The compiled serving forwards (desco_tpu_torch/utils/cuda_graphs.py:
``GraphedStep`` with ``inference``, ``ForwardCache``, ``ServingGraphs``)
on the CPU, where they run on their static buffers without a capture.

Each compiled forward must equal its eager path bit for bit (the same
operations on copies of the same inputs): the bounds, the neighborhood
and gossip predicts, the DP predicts at D = 2, the halo serve at 4
shards, the bench's forward and train step, and the baseline drivers'
train step, validation and predict. Against desco_tpu's jitted functions
on the same numpy-seeded inputs and carried weights (dropout 0) they hold
the tolerances of the existing parity tests: the bounds rtol 1e-5
(tests/test_torch_bounds.py), the halo serve rtol 1e-4 with atol 1e-5
(tests/test_torch_halo.py), the predicts' and the bench forward's
de-logged counts rtol 1e-5 with an atol of 1e-5 of the largest count
(2^pred - 1 cancels near 0, where only the absolute error is meaningful).

On the card the bounds' ``index_add_`` sums in no fixed order: graphed
equals eager bit for bit where every partial sum is an integer below
2^24, and within rtol 1e-6 above (chip_smoke.py phase 17). Here the CPU's
order is fixed and they are equal.

The cache keys as ``jax.jit`` keys its cache: a second request of one
bucket replays what the first captured, a grown bucket captures anew and
drops the forward it replaced, and the ensemble members, the query count
(labeled mode's 784) and the bf16 tower key apart. A compiled forward
makes no read-back and no host-to-device copy, which a capture on the
card could not hold.
"""

import copy
import dataclasses
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import random_graph
from desco_tpu.batch.packed import PackedGraphs as JPacked
from desco_tpu.graph.atlas import gen_queries as j_gen_queries
from desco_tpu.models import neighborhood as jneigh
from desco_tpu.parallel import dp as jdp
from desco_tpu.parallel import halo as jhalo
from desco_tpu.train import loop as jloop
from desco_tpu.truth.bounds import neighborhood_count_bounds as j_bounds
from desco_tpu_torch import baseline as tbaseline
from desco_tpu_torch import bench as tbench
from desco_tpu_torch.batch.packed import (PackedGraphs, auto_capacities,
                                          pack_samples)
from desco_tpu_torch.data.workload import Workload
from desco_tpu_torch.graph import Graph, gen_queries, gen_query_ids
from desco_tpu_torch.models import gossip as tgossip
from desco_tpu_torch.models import neighborhood as tneigh
from desco_tpu_torch.models.shmp_gnn import prepare_batch
from desco_tpu_torch.parallel import dp, halo
from desco_tpu_torch.pipeline import model_configs as t_model_configs
from desco_tpu_torch.serving import CountingService
from desco_tpu_torch.utils import cuda_graphs as graphed
from desco_tpu_torch.train import loop as tloop
from desco_tpu_torch.truth.bounds import (_batch_bounds,
                                          _hashable_schedules,
                                          neighborhood_count_bounds)

from test_torch_dp import dp_data, j_host  # noqa: F401
from test_torch_grad import gossip_pair, neigh_pair
from test_torch_halo import N_DEV, gossip_case
from test_torch_shmp import jax_batch, one_torch_thread  # noqa: F401

NEIGH, GOSSIP = "release/r4/neigh.best", "release/r4/gossip.best"
QUERY_IDS = gen_query_ids([3, 4, 5])


def assert_counts_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def models(dp_data):
    """The tiny neighborhood and gossip models from desco_tpu's seeded
    weights, the query embeddings, and the gossip stage's."""
    cfg, tbs, gbs, qb = dp_data
    (jt, jq, jparams), tparams = neigh_pair()
    tparams.requires_grad_(False)
    tt, tq = t_model_configs(cfg, "cpu")
    with torch.inference_mode():
        q_embs = tneigh.embed_queries(tparams, tq, qb.to("cpu"))
    jp, tp = gossip_pair()
    tp.requires_grad_(False)
    g_embs = np.random.default_rng(4).standard_normal(
        (gbs[0].node_y.shape[1], 16)).astype(np.float32)
    return dict(j=(jt, jq, jparams), t=(tt, tq, tparams, q_embs),
                jg=jp, tg=tp, g_embs=g_embs)


# ---------------------------------------------------------------- bounds
def test_bounds_static_equal_eager_and_desco_tpu():
    """Several batches of one shape: one capture, every batch replays
    it; equal to the eager bounds, and to desco_tpu's jitted
    ``_batch_bounds`` within rtol 1e-5."""
    rng = np.random.default_rng(0)
    graphs = [Graph(g.n_nodes, g.edges)
              for g in (random_graph(rng, 16, 0.25) for _ in range(6))]
    samples, _ = Workload(graphs).neighborhood_samples(depth=3)
    batches = pack_samples(samples, *auto_capacities(samples, g_cap=16))
    assert len(batches) > 1
    cache = graphed.ForwardCache()
    got = neighborhood_count_bounds(batches, gen_queries(QUERY_IDS),
                                    device="cpu", cache=cache)
    eager = neighborhood_count_bounds(batches, gen_queries(QUERY_IDS),
                                      device="cpu", graphed=False)
    np.testing.assert_array_equal(got, eager)
    assert cache.captures == 1 and len(cache.entries) == 1
    want = j_bounds([JPacked(**dict(b.fields())) for b in batches],
                    j_gen_queries(QUERY_IDS))
    np.testing.assert_allclose(got, want, rtol=1e-5)


# -------------------------------------------------------------- predicts
def test_predicts_static_equal_eager_and_desco_tpu(dp_data, models):
    """The neighborhood and gossip predicts: one capture per stage (the
    batches share their shape), equal to the eager predicts, and to
    desco_tpu's ``_jit_predict_from_embs`` / ``_jit_gossip_predict``; the
    bf16 tower static against eager."""
    cfg, tbs, gbs, qb = dp_data
    (jt, jq, jparams), (tt, tq, tparams, q_embs) = models["j"], models["t"]
    cache = graphed.ForwardCache()
    got = tloop.predict_neighborhood_counts(tparams, tt, q_embs, list(tbs),
                                            "cpu", cache=cache)
    eager = tloop.predict_neighborhood_counts(tparams, tt, q_embs,
                                              list(tbs), "cpu",
                                              graphed=False)
    np.testing.assert_array_equal(got, eager)
    assert cache.captures == 1
    assert_counts_close(got, jloop.predict_neighborhood_counts(
        jparams, jt, jq, jax_batch(qb), [j_host(b) for b in tbs]))
    # the bf16 target tower (serve_bf16): a forward of its own, static
    # equal to eager
    bf = dataclasses.replace(tt, dtype=torch.bfloat16)
    np.testing.assert_array_equal(
        tloop.predict_neighborhood_counts(tparams, bf, q_embs, list(tbs),
                                          "cpu", cache=cache),
        tloop.predict_neighborhood_counts(tparams, bf, q_embs, list(tbs),
                                          "cpu", graphed=False))
    assert cache.captures == 2

    g_embs = torch.from_numpy(models["g_embs"])
    gcache = graphed.ForwardCache()
    got_g = tloop.predict_gossip_counts(models["tg"], g_embs, list(gbs),
                                        "cpu", cache=gcache)
    eager_g = tloop.predict_gossip_counts(models["tg"], g_embs, list(gbs),
                                          "cpu", graphed=False)
    np.testing.assert_array_equal(got_g, eager_g)
    assert gcache.captures == 1
    assert_counts_close(got_g, jloop.predict_gossip_counts(
        models["jg"], jnp.asarray(models["g_embs"]),
        [j_host(b) for b in gbs]))


def test_dp_predicts_static_equal_eager_and_desco_tpu(dp_data, models):
    """D = 2 replicas on one device: one forward serves both (a replica's
    forward crosses no device), bit-equal to the eager DP predict and to
    one device, and desco_tpu's DP predicts hold."""
    cfg, tbs, gbs, qb = dp_data
    (jt, jq, jparams), (tt, tq, tparams, q_embs) = models["j"], models["t"]
    mesh = dp.make_mesh(2, "cpu")
    cache = graphed.ForwardCache()
    got = dp.dp_predict_neighborhood_counts(tparams, tt, q_embs, list(tbs),
                                            mesh, cache=cache)
    np.testing.assert_array_equal(got, dp.dp_predict_neighborhood_counts(
        tparams, tt, q_embs, list(tbs), mesh, graphed=False))
    np.testing.assert_array_equal(got, tloop.predict_neighborhood_counts(
        tparams, tt, q_embs, list(tbs), "cpu", graphed=False))
    assert len(cache.entries) == 1 and cache.replicas is not None
    assert_counts_close(got, jdp.dp_predict_neighborhood_counts(
        jparams, jt, jq, jax_batch(qb), [j_host(b) for b in tbs],
        jdp.make_mesh(2)))

    g_embs = torch.from_numpy(models["g_embs"])
    got_g = dp.dp_predict_gossip_counts(models["tg"], g_embs, list(gbs),
                                        mesh)
    np.testing.assert_array_equal(got_g, dp.dp_predict_gossip_counts(
        models["tg"], g_embs, list(gbs), mesh, graphed=False))
    assert_counts_close(got_g, jdp.dp_predict_gossip_counts(
        models["jg"], jnp.asarray(models["g_embs"]),
        [j_host(b) for b in gbs], jdp.make_mesh(2)))


def test_halo_serve_static_equals_eager_and_desco_tpu():
    """One query's forward over 4 shards, made once and run for every
    query, against the eager serve and desco_tpu's ``jax.jit(run_one)``."""
    g, s, counts, _, jp, tp, _ = gossip_case(seed=9, n=60, p=0.1, n_q=3)
    q_embs = np.random.default_rng(9).standard_normal((3, 8)).astype(
        np.float32)
    got, stats = halo.serve_gossip_counts(
        tp, g, counts, torch.from_numpy(q_embs), n_devices=N_DEV,
        return_stats=True, device="cpu")
    eager, estats = halo.serve_gossip_counts(
        tp, g, counts, torch.from_numpy(q_embs), n_devices=N_DEV,
        return_stats=True, device="cpu", graphed=False)
    assert stats["graphed"] and not estats["graphed"]
    assert stats["capture_s"] == 0.0  # nothing is captured on the CPU
    np.testing.assert_array_equal(got, eager)
    jwant = jhalo.serve_gossip_counts(jp, random_graph(
        np.random.default_rng(9), 60, 0.1), counts, jnp.asarray(q_embs),
        n_devices=N_DEV)
    np.testing.assert_allclose(got, jwant, rtol=1e-4, atol=1e-5)


# ----------------------------------------------------------------- bench
def test_bench_forward_and_step_static_equal_eager(models):
    """The bench's timed forward (both towers and the count head) and its
    train step: static equals eager, the forward against desco_tpu's
    jitted ``predict_counts``, two steps' losses and parameters equal."""
    (jt, jq, jparams), (tt, tq, tparams, _) = models["j"], models["t"]
    host, host_q = tbench.build_workload(n_graphs=2)
    batch, qb = host.to("cpu", training=True), host_q.to("cpu")
    for b, t in ((batch, tt), (qb, tq)):
        prepare_batch(b, t.n_edge_types, backward=True)

    def forward(b, q):
        return tneigh.predict_counts(tparams, tt, tq, b, q)

    static = tbench.timed_forward(forward, batch, qb, graphed=True,
                                  capture=False)()
    eager = tbench.timed_forward(forward, batch, qb, graphed=False,
                                 capture=False)()
    assert torch.equal(static, eager)
    want = np.asarray(jax.jit(jneigh.predict_counts, static_argnums=(1, 2))(
        jparams, jt, jq, jax_batch(host), jax_batch(host_q)))
    valid = np.asarray(host.graph_mask) > 0
    assert_counts_close(static.numpy()[valid], want[valid])

    labels = np.random.default_rng(0).integers(
        0, 50, (batch.g_cap, 29)).astype(np.float32)
    tb = dataclasses.replace(batch, y=torch.from_numpy(labels))
    prepare_batch(tb, tt.n_edge_types, backward=True)
    runs = []
    for compiled in (False, True):
        params = copy.deepcopy(tparams)
        opt = tloop.make_adam(params)
        loss = torch.zeros(())
        loss_fn = tloop.neighborhood_loss_fn(tt, tq, qb)
        gen = torch.Generator().manual_seed(1)

        def step_on(b, params=params, opt=opt, loss=loss, loss_fn=loss_fn,
                    gen=gen):
            loss.copy_(tloop.train_step(params, opt, loss_fn, b, 1e-4,
                                        gen)[0])

        step = tbench.timed_step(step_on, tb, opt.state_tensors() + [loss],
                                 gen, graphed=compiled, capture=False)
        losses = []
        for _ in range(2):
            step()
            losses.append(float(loss))
        runs.append((losses, opt.flat.clone(), opt.mu.clone()))
    assert runs[0][0] == runs[1][0] and runs[0][0][0] != runs[0][0][1]
    assert torch.equal(runs[0][1], runs[1][1])
    assert torch.equal(runs[0][2], runs[1][2])


# ----------------------------------------------------------- cache keys
def test_cache_keys_parameters_query_count_and_tower_type(dp_data, models):
    """One cache: a second call of one shape replays; another query count
    (labeled mode's expanded set), the bf16 tower and other parameters
    each key a forward of their own; a new shape in a group drops the
    group's forward."""
    _, tbs, _, _ = dp_data
    tt, _, tparams, q_embs = models["t"]
    cache = graphed.ForwardCache()
    b = tbs[0].to("cpu")

    def run(params=tparams, cfg=tt, embs=q_embs, batch=b):
        return tloop.neighborhood_forward(params, cfg, cache=cache)(batch,
                                                                   embs)

    first = run()
    again = run()
    assert torch.equal(first, again) and again is not first
    assert cache.captures == 1
    run(embs=q_embs[:3])
    run(cfg=dataclasses.replace(tt, dtype=torch.bfloat16))
    run(params=copy.deepcopy(tparams))
    assert cache.captures == len(cache.entries) == 4
    # a grown bucket: the same g_cap at a larger n_cap replaces the
    # forward it grew from (the f32 one of these parameters and queries)
    grown = with_more_node_slots(tbs[0], 128).to("cpu")
    assert grown.g_cap == b.g_cap and grown.n_cap == b.n_cap + 128
    grown_out = run(batch=grown)
    assert cache.captures == 5 and len(cache.entries) == 4
    assert torch.equal(grown_out, run(batch=grown))
    assert cache.captures == 5


def with_more_node_slots(b, extra: int):
    """Host batch ``b`` with ``extra`` more padding node slots (the caps a
    pinned bucket grows to): the same graphs at a larger n_cap."""
    pad = {"x": np.zeros((extra,) + b.x.shape[1:], b.x.dtype),
           "node_type": np.zeros(extra, b.node_type.dtype),
           "node_graph": np.full(extra, b.g_cap, b.node_graph.dtype),
           "node_mask": np.zeros(extra, b.node_mask.dtype)}
    return PackedGraphs(**{
        name: np.concatenate([v, pad[name]]) if name in pad else v
        for name, v in b.fields() if name != "node_y"})


@pytest.fixture(scope="module")
def small_graphs():
    """Two requests in one pinned bucket of each stage (33-64
    neighborhoods, 4 graphs): four 10-node paths, then a 33-clique beside
    three edges, whose largest neighborhood and gossip sample outgrow the
    first request's edge caps."""
    def path(n):
        return Graph(n, np.stack([np.arange(n - 1), np.arange(1, n)], 1)
                     .astype(np.int32))

    clique = Graph(33, np.stack(np.triu_indices(33, 1), 1).astype(np.int32))
    return [path(10) for _ in range(4)], [clique] + [path(2)] * 3


def test_service_cache_reuses_grows_and_equals_eager(small_graphs):
    """release/r4 on the CPU (no tail recount: VF2 over the clique's
    neighborhoods takes minutes): a repeated request replays every
    forward it captured; a request that grows the pinned buckets captures
    anew and drops the forwards it replaced, and the first request then
    fits the grown caps; an ensemble keys one cache per member;
    ``graphed=False`` serves the same ``CountResult``."""
    paths, dense = small_graphs
    over = {"verify_budget": 0.0}
    svc = CountingService(NEIGH, GOSSIP, device="cpu",
                          config_overrides=over)
    assert svc.graphed and len(svc.graphs.members) == 1
    first = svc.count(paths)
    stats = svc.graphs.stats()
    # stage 1, the bounds and the gossip forward
    assert stats["captures"] == stats["forwards"] == 3
    svc.count(paths)
    assert svc.graphs.stats() == stats
    caps = (dict(svc._neigh_buckets), dict(svc._gossip_buckets))
    grown = svc.count(dense)
    assert (svc._neigh_buckets.keys(), svc._gossip_buckets.keys()) == (
        caps[0].keys(), caps[1].keys())
    assert svc._neigh_buckets != caps[0] and svc._gossip_buckets != caps[1]
    after = svc.graphs.stats()
    assert after["captures"] == 6 and after["forwards"] == 3
    svc.count(paths)  # fits the grown caps: replays those
    assert svc.graphs.stats()["captures"] == 6

    eager = CountingService(NEIGH, GOSSIP, device="cpu", graphed=False,
                            config_overrides=over)
    assert eager.graphs is None
    for req, want in ((paths, first), (dense, grown)):
        got = eager.count(req)
        for f in dataclasses.fields(want):
            np.testing.assert_array_equal(getattr(got, f.name),
                                          getattr(want, f.name),
                                          err_msg=f.name)

    ens = CountingService([NEIGH, NEIGH], GOSSIP, device="cpu",
                          config_overrides=over)
    ens.count(paths)
    keys = [next(iter(c.entries)) for c in ens.graphs.members]
    assert len(ens.graphs.members) == 2 and keys[0] != keys[1]
    assert all(len(c.entries) == 1 for c in ens.graphs.members)


def test_service_threads_share_its_compiled_forwards(small_graphs):
    """Four threads calling ``count`` on one service at once (a short
    switch interval forces interleaving): the service's lock keeps one
    thread at a time in its forwards' static buffers, so every thread
    gets the result a lone request gets."""
    import sys
    import threading

    paths, dense = small_graphs
    svc = CountingService(NEIGH, GOSSIP, device="cpu",
                          config_overrides={"verify_budget": 0.0})
    want = [svc.count(req).node_counts for req in (paths, dense)]
    got, errors = {}, []

    def worker(i):
        try:
            for j in range(2):
                got[i, j] = svc.count((paths, dense)[(i + j) % 2])
        except Exception as e:  # re-raised below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    for (i, j), res in got.items():
        np.testing.assert_array_equal(res.node_counts, want[(i + j) % 2])
    assert len(got) == 8


# ------------------------------------------------------------ read-backs
def test_compiled_forwards_make_no_read_back(dp_data, models, monkeypatch):
    """After a first call (the set-up a warm-up does on the card), the
    neighborhood, gossip and bounds forwards run on their static buffers
    with every read-back (``item``, ``__bool__``, ``tolist``, ``numpy``,
    ``cpu``, ``float``, ``int``) and every host-to-device tensor
    (``torch.tensor``, ``as_tensor``, ``new_tensor``) raising."""
    _, tbs, gbs, _ = dp_data
    tt, _, tparams, q_embs = models["t"]
    b = tbs[1].to("cpu")
    gb = gbs[1].to("cpu")
    prepare_batch(b, tt.n_edge_types, backward=False)
    tloop.gossip_prepare(gb, backward=False)
    schedules = _hashable_schedules(gen_queries([6, 7]))
    g_embs = torch.from_numpy(models["g_embs"])
    forwards = [
        (graphed.GraphedStep(
            lambda xs: tneigh.predict_counts_from_embs(tparams, tt, *xs),
            (b, q_embs), capture=False, inference=True), (b, q_embs)),
        (graphed.GraphedStep(
            lambda xs: tgossip.gossip_predict(models["tg"], *xs),
            (gb, g_embs), capture=False, inference=True), (gb, g_embs)),
        (graphed.GraphedStep(
            lambda x: _batch_bounds(x, schedules, 1), b, capture=False,
            inference=True), b)]
    firsts = [f(inputs) for f, inputs in forwards]

    def refuse(*_a, **_k):
        raise AssertionError("a read-back or host copy in a forward")

    for name in ("item", "__bool__", "tolist", "numpy", "cpu", "__float__",
                 "__int__", "new_tensor"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "as_tensor", refuse)
    seconds = [f(inputs) for f, inputs in forwards]
    monkeypatch.undo()
    for a, c in zip(firsts, seconds):
        assert torch.equal(a, c)


# ------------------------------------------------------------- baselines
def _strip_times(text: str) -> list:
    return [re.sub(r" [0-9.]+s$", "", line) for line in text.splitlines()]


@pytest.mark.parametrize("kind", ["DIAMNET", "LRP"])
def test_baseline_driver_graphed_equals_eager(kind, tmp_path, monkeypatch,
                                              capsys):
    """``python -m desco_tpu_torch.baseline``, 2 epochs on the CPU, with
    the compiled train step, validation and predict and with ``--eager``:
    the printed losses and figures and the returned weights equal."""
    weights = []
    train = tbaseline._train

    def spy(*a, **k):
        out = train(*a, **k)
        weights.append([p.detach().clone() for p in out.parameters()])
        return out

    monkeypatch.setattr(tbaseline, "_train", spy)
    argv = ["--baseline", kind, "--train_dataset", "Syn_16",
            "--test_dataset", "Syn_16", "--epoch_num", "2", "--hidden_dim",
            "8", "--layer_num", "2", "--query_sizes", "3", "4", "--device",
            "cpu", "--data_root", str(tmp_path)]
    outs = []
    for extra in ([], ["--eager"]):
        assert tbaseline.main(argv + extra) == 0
        outs.append(_strip_times(capsys.readouterr().out))
    assert outs[0] == outs[1]
    assert any(line.startswith("epoch    1") for line in outs[0])
    assert all(torch.equal(a, b) for a, b in zip(*weights))
