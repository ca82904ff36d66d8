"""desco_tpu_torch's halo graph axis across processes (parallel/halo.py and
parallel/topology.py over a process group, ``utils/distributed
.exchange_blocks``) against the same shards in one process and against
desco_tpu, on the CPU.

desco_tpu trains with its ``graph`` axis across processes: a mesh over
every process's devices for ``halo_gossip_step_fn``, and ``make_mesh2d``'s
plain fallback grid wherever ``n_data`` is not a multiple of the process
count. Here two ranks of a gloo group (tests/torch_dist_worker.py, the
harness and timeouts of tests/test_torch_distributed.py: the group 60 s,
a join 120 s) hold the shards between them: 4 shards of one gossip
graph (0-1 on rank 0, 2-3 on rank 1), the 3 x 2 fallback grid (its middle
row crosses the ranks) and a 1 x 2 SHMP forward (SAGE, PNA); three ranks
hold a 2 x 3 grid whose rows span two ranks each (process groups of a
part of the ranks). The graphed steps and forward run as chains split at
their collectives (utils/cuda_graphs.GraphedStep, static buffers without
a capture on the CPU): their split points are checked, and the chain's
raises. Every rank result is held bit for bit against the
same shards in this process; the cross-rank halo step at dropout 0
against desco_tpu's ``halo_gossip_step_fn`` on 4 fake devices within
tests/test_torch_halo.py's tolerances (the loss rtol 1e-5; the
gradients rtol 1e-4 with atol 1e-6 of each tensor's scale)."""

import pickle
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from desco_tpu.parallel import halo as jhalo
from desco_tpu.train.checkpoint import _flatten
from desco_tpu.train.loop import make_adam as j_make_adam
from desco_tpu_torch.parallel import halo, topology
from desco_tpu_torch.train.checkpoint import params_from_jax
from desco_tpu_torch.train.loop import make_adam
from desco_tpu_torch.utils import distributed

from test_torch_distributed import (GROUP_TIMEOUT_S, ROOT, WORKER,
                                    assert_same, host_flat, run_children)
from test_torch_grad import flatten_grads
from test_torch_halo import (N_DEV, assert_same_partition, both_partitions,
                             gossip_case, mesh, tower, typed_graph)
from test_torch_shmp import one_torch_thread  # noqa: F401 (autouse)
from test_torch_topology import replica_specs

CPU = [torch.device("cpu")]
EAGER_NOTE = "the graphed step runs eager"


def step_chain(n_q: int, groups, world: int = 2) -> list:
    """The split points of a graphed gossip step over the rows whose
    exchanges run in ``groups`` (in row order): per row, 2 layers x (pull,
    push) per query forward and the second layer's backward (the first
    reads detached rows), then the gather of every rank's rows."""
    out = []
    for members in groups:
        out += [("all_to_all", members)] * (6 * n_q)
    return out + [("gather", tuple(range(world)))]


def run_ranks(job: dict, tmp, world: int):
    """Start ``world`` ranks of tests/torch_dist_worker.py on ``job``;
    return their results and their (stdout, stderr)."""
    job = dict(job, init_method=f"file://{tmp / 'rendezvous'}",
               world=world, timeout_s=GROUP_TIMEOUT_S, out_dir=str(tmp))
    path = tmp / "job.pkl"
    with open(path, "wb") as f:
        pickle.dump(job, f)
    outs = run_children([[sys.executable, WORKER, str(path), str(r)]
                         for r in range(world)], ROOT)
    ranks = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, outs


def gossip_data():
    """A 4-shard gossip partition (with pull and push pairs), desco_tpu's
    gossip weights and 2 query embeddings."""
    g, s, counts, truth, jp, _, q = gossip_case(seed=7, n=30, p=0.2)
    part = halo.partition_typed_graph(g.n_nodes, s.node_type, counts,
                                      s.edge_src, s.edge_dst, s.edge_type,
                                      N_DEV, node_y=truth, n_types=2)
    assert part.p_max > 0 and part.edge_src_bnd.shape[1] > 0
    return part, jp, q


def grid_parts(n_graph: int) -> list:
    """Three different graphs harmonized to one shape, ``n_graph`` shards
    each."""
    specs = replica_specs(seed=2) + replica_specs(seed=6)[:1]
    return topology.harmonized_partitions(specs, n_graph, n_types=2)


def tower_parts() -> dict:
    """Per conv type (SAGE; PNA, which sums across the shards), the tower's
    config, weights and a 2-shard pull-only partition of a typed graph."""
    s = typed_graph(seed=1, n=40)
    out = {}
    for conv in ("SAGE", "PNA"):
        (_, jparams), (tcfg, _) = tower(conv)
        part = halo.partition_typed_graph(
            s.n_nodes, s.node_type, s.x, s.edge_src, s.edge_dst,
            s.edge_type, 2, n_types=tcfg.n_edge_types, force_pull=True)
        out[conv] = (tcfg, host_flat(jparams), part)
    return out


@pytest.fixture(scope="module")
def ranks_run(tmp_path_factory):
    """Both ranks' results of the ``halo_ranks`` scenario, its job and the
    ranks' standard error."""
    part, jp, q = gossip_data()
    g, _, counts, *_ = gossip_case(seed=9, n=60, p=0.1)
    job = dict(scenario="halo_ranks", halo_part=part,
               halo_gossip=host_flat(jp), halo_q=q,
               grid_parts=grid_parts(2), towers=tower_parts(),
               serve=(g, counts))
    ranks, outs = run_ranks(job, tmp_path_factory.mktemp("halo_ranks"), 2)
    return job, ranks, [err for _, err in outs]


def one_process_steps(params_flat, place, q, make_step, dropout,
                      graphed=False) -> list:
    params = params_from_jax(params_flat)
    opt = make_adam(params)
    step = make_step(opt, dropout=dropout, graphed=graphed)
    calls = []
    for seed in (4, 5):
        loss, ok = step(params, place, q, 1e-3, seed=seed)
        calls.append([float(loss), bool(ok)] + [
            t.numpy().copy() for t in (opt.grad, opt.flat, opt.mu, opt.nu)])
    return calls


# ----------------------------------------------------------- the layout
@pytest.mark.parametrize("shape,want", [
    ((1, 4), [[0, 0, 1, 1]]),
    ((3, 2), [[0, 0], [0, 1], [1, 1]]),
    ((2, 2), [[0, 0], [1, 1]])])
def test_make_mesh2d_slot_layout_over_ranks(ranks_run, shape, want):
    """desco_tpu's flat process-major grid: slot i = d * n_graph + g on
    rank i // (n / P), the same on both ranks, each rank holding its own
    slots; 1 x 4 and 3 x 2 are desco_tpu's fallback grid (a row across
    the ranks), 2 x 2 its hybrid mesh (whole rows); a grid of 3 slots
    over 2 ranks raises."""
    _, ranks, _ = ranks_run
    for r, res in enumerate(ranks):
        got_ranks, held = res["mesh"][shape]
        assert [list(row) for row in got_ranks] == want
        assert held == [[q == r for q in row] for row in want]
        assert "multiple of the process count" in res["odd_error"]
    with pytest.raises(ValueError, match="ascending"):
        halo.place_shards(gossip_data()[0], CPU, ranks=[1, 0, 0, 1])


# ---------------------------------------------------------- the exchange
def test_exchange_blocks_and_its_backward(ranks_run):
    """Block j of every rank goes to rank j; the backward sends each
    cotangent block back to the rank it came from."""
    _, ranks, _ = ranks_run
    send = [np.arange(24, dtype=np.float32).reshape(2, 3, 4) + 100.0 * r
            for r in range(2)]
    cot = [np.arange(24, dtype=np.float32).reshape(2, 3, 4) * (r + 2.0)
           for r in range(2)]
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(
            res["exchange"]["got"], np.stack([send[p][r] for p in range(2)]))
        np.testing.assert_array_equal(
            res["exchange"]["grad"], np.stack([cot[j][r] for j in range(2)]))
    # with one rank it is its input
    t = torch.ones(1, 2)
    assert distributed.exchange_blocks(t) is t
    with pytest.raises(ValueError, match="one block per rank"):
        distributed.exchange_blocks(torch.ones(2, 2))


def test_exchange_blocks_with_counts(ranks_run):
    """With per-rank counts a rank sends only the blocks another rank
    needs: here both of its blocks to the other rank and none to itself;
    the backward sends the cotangents back with the counts swapped."""
    _, ranks, _ = ranks_run
    send = [np.arange(24, dtype=np.float32).reshape(2, 3, 4) + 100.0 * r
            for r in range(2)]
    cot = [np.arange(24, dtype=np.float32).reshape(2, 3, 4) * (r + 2.0)
           for r in range(2)]
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["exchange_counts"]["got"],
                                      send[1 - r])
        np.testing.assert_array_equal(res["exchange_counts"]["grad"],
                                      cot[1 - r])
    with pytest.raises(ValueError, match="counts"):
        distributed.exchange_blocks(torch.ones(2, 2), counts=([2], [1, 1]))


def test_place_shards_rejects_ranks_that_leave_a_rank_out(ranks_run):
    """``ranks`` that give this rank no slot, or name a rank outside the
    group, raise before any shard is placed; ranks that give this rank
    every slot place them all here."""
    _, ranks, _ = ranks_run
    assert ranks[0]["bad_ranks"][(0, 0, 0, 0)] is None
    assert "holds no slot" in ranks[1]["bad_ranks"][(0, 0, 0, 0)]
    for res in ranks:
        assert "the group has 2 ranks" in res["bad_ranks"][(0, 0, 1, 2)]


# ---------------------------------------------------------- the halo step
def test_halo_loss_and_slot_terms_over_ranks_equal_one_process(ranks_run):
    """The 4-shard gossip loss with shards 0-1 on rank 0 and 2-3 on rank 1:
    the psum'd loss on both ranks, each rank's per-slot sums and gradient
    rows (one per slot, of the slot's own parameter leaves) bit-equal to
    the same shards in one process; the rows add up, in slot order, to
    the loss and to the gradient a backward gives the master."""
    job, ranks, _ = ranks_run
    shards = halo.place_shards(job["halo_part"], CPU)
    q = torch.from_numpy(job["halo_q"])
    params = params_from_jax(job["halo_gossip"])
    loss = halo.halo_gossip_loss(params, shards, q)
    sums = [s.detach() for s in halo._slot_sums(
        halo.shard_params(params, torch.float32, shards), shards, q, 0.0,
        False, None)]
    terms = halo.slot_terms(params, shards, q).numpy()
    for r, res in enumerate(ranks):
        assert res["held"] == [r == 0, r == 0, r == 1, r == 1]
        assert res["loss"] == float(loss.detach())
        assert res["sums"] == [float(s) for s in sums[2 * r:2 * r + 2]]
        np.testing.assert_array_equal(res["terms"], terms[2 * r:2 * r + 2])
    loss.backward()
    total = terms[0]
    for row in terms[1:]:
        total = total + row
    assert total[-1] == float(loss.detach())
    np.testing.assert_array_equal(total[:-1], torch.cat([
        (p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
        for p in params.parameters()]).numpy())


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_halo_step_over_ranks_equals_one_process(ranks_run, dropout):
    """Two calls of ``halo_gossip_step_fn`` with the 4 shards over the two
    ranks, eager and graphed (a chain split at its 6 exchanges per query
    and the gather, the same on both ranks; no eager note): losses,
    flags, reduced gradients, parameters and Adam's moments bit-equal to
    the step over the same shards in one process, on both ranks."""
    job, ranks, errs = ranks_run
    want = one_process_steps(job["halo_gossip"],
                             halo.place_shards(job["halo_part"], CPU),
                             torch.from_numpy(job["halo_q"]),
                             halo.halo_gossip_step_fn, dropout)
    assert all(c[1] for c in want) and want[0][0] != want[1][0]
    for r, res in enumerate(ranks):
        for graphed in (False, True):
            assert_same(res["step", dropout, graphed], want,
                        f"rank {r} graphed={graphed}")
    for res in ranks:
        assert res["chain", dropout] == step_chain(len(job["halo_q"]),
                                                   [(0, 1)])
    for err in errs:
        assert EAGER_NOTE not in err


def test_halo_step_over_ranks_matches_desco_tpu(ranks_run):
    """The cross-rank step's first call at dropout 0 against desco_tpu's
    ``halo_gossip_step_fn`` on 4 fake devices (its loss) and its
    ``halo_gossip_loss`` gradient under ``shard_map``."""
    job, ranks, _ = ranks_run
    g, s, counts, truth, jp, _, _ = gossip_case(seed=7, n=30, p=0.2)
    jpart, tpart = both_partitions(g.n_nodes, s.node_type, counts,
                                   s.edge_src, s.edge_dst, s.edge_type,
                                   N_DEV, node_y=truth, n_types=2)
    assert_same_partition(jpart, job["halo_part"])
    q = jnp.asarray(job["halo_q"])

    @partial(jax.shard_map, mesh=mesh(), in_specs=(P(), P("graph"), P()),
             out_specs=(P(), P()))
    def lg(params, part, qe):
        shard = jax.tree_util.tree_map(lambda a: a[0], part)
        return jax.value_and_grad(
            lambda p: jhalo.halo_gossip_loss(p, shard, qe))(params)

    tx = j_make_adam()
    with mesh():
        _, jgrads = jax.jit(lg)(jp, jpart, q)
        _, _, jloss = jax.jit(jhalo.halo_gossip_step_fn(tx, mesh()))(
            jp, tx.init(jp), jpart, q, jnp.float32(1e-3),
            jax.random.PRNGKey(0))
    for res in ranks:
        loss, ok, grad = res["step", 0.0, False][0][:3]
        assert ok
        np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
        tparams = params_from_jax(job["halo_gossip"])
        make_adam(tparams).grad.copy_(torch.from_numpy(grad))
        got = flatten_grads(tparams)
        nonzero = 0
        for key, d in _flatten(jgrads).items():
            scale = float(np.abs(d).max())
            nonzero += scale > 0
            np.testing.assert_allclose(got[key], d, rtol=1e-4,
                                       atol=1e-6 * max(scale, 1e-30),
                                       err_msg=key)
        assert nonzero >= 10


# --------------------------------------------------------------- the grids
def one_process_grid(job, n_data, n_graph) -> dict:
    replicas = topology.place_replicas(
        topology.stack_partitions(job["grid_parts"]),
        topology.make_mesh2d(n_data, n_graph, devices=CPU))
    q = torch.from_numpy(job["halo_q"])
    loss, flat = topology.dp_halo_gossip_loss_and_grads(
        params_from_jax(job["halo_gossip"]), replicas, q)
    out = {"loss": float(loss), "flat": flat.numpy()}
    for graphed in (False, True):
        out[graphed] = one_process_steps(
            job["halo_gossip"], replicas, q, topology.dp_halo_gossip_step_fn,
            0.1, graphed)
    return out


def test_fallback_grid_step_over_ranks_equals_one_process(ranks_run):
    """The 3 x 2 fallback grid over two ranks (row 1's shards on both):
    the composed loss and gradient and two calls of the DP x halo step at
    dropout 0.1, eager and graphed (a chain split at row 1's exchanges and
    the gather), bit-equal to the 3 x 2 grid in one process on both
    ranks."""
    job, ranks, errs = ranks_run
    want = one_process_grid(job, 3, 2)
    for r, res in enumerate(ranks):
        got = res["grid"]
        assert [list(row) for row in got["ranks"]] == [[0, 0], [0, 1],
                                                      [1, 1]]
        assert_same({k: got[k] for k in want}, want, f"rank {r}")
        assert got["chain"] == step_chain(len(job["halo_q"]), [(0, 1)])
    for err in errs:
        assert EAGER_NOTE not in err


@pytest.mark.parametrize("conv", ["SAGE", "PNA"])
def test_sharded_shmp_forward_over_ranks_equals_one_process(ranks_run,
                                                            conv):
    """``dp_halo_shmp_forward`` on a 1 x 2 grid over the two ranks, eager
    and graphed (a chain split at its exchanges), two calls each: each
    rank returns its own shard's embeddings (None for the other's),
    bit-equal to the same grid in one process (PNA's degree normalizer
    is summed across the ranks)."""
    job, ranks, _ = ranks_run
    cfg, flat0, part = job["towers"][conv]
    replicas = topology.place_replicas(
        topology.stack_partitions([part]),
        topology.make_mesh2d(1, 2, devices=CPU))
    with torch.inference_mode():
        [want] = topology.dp_halo_shmp_forward(cfg, graphed=False)(
            params_from_jax(flat0), replicas)
    for r, res in enumerate(ranks):
        for graphed in (False, True):
            for got in res["shmp", conv, graphed]:
                assert [e is None for e in got] == [r != 0, r != 1]
                np.testing.assert_array_equal(got[r], want[r].numpy())
        chain = res["shmp_chain", conv]
        assert chain and set(chain) == {("all_to_all", (0, 1))}
        assert chain == ranks[0]["shmp_chain", conv]


def test_grid_over_three_ranks_equals_one_process(tmp_path):
    """A 2 x 3 grid over three ranks: row 0's shards on ranks 0-1, row 1's
    on ranks 1-2 (a process group of two of the three ranks each, rank 1
    in both); the composed loss and gradient and two calls of the step,
    eager and graphed (a chain split at each row's exchanges in its
    group and the gather of all three), bit-equal to the grid in one
    process on every rank."""
    _, jp, q = gossip_data()
    job = dict(scenario="grid_over_three", halo_gossip=host_flat(jp),
               halo_q=q, grid_parts=grid_parts(3)[:2])
    ranks, outs = run_ranks(job, tmp_path, 3)
    want = one_process_grid(job, 2, 3)
    for r, res in enumerate(ranks):
        assert [list(row) for row in res["ranks"]] == [[0, 0, 1], [1, 2, 2]]
        assert_same({k: res[k] for k in want}, want, f"rank {r}")
    groups = [[(0, 1)], [(0, 1), (1, 2)], [(1, 2)]]
    for res, rows in zip(ranks, groups):
        assert res["chain"] == step_chain(len(q), rows, world=3)
    assert not any(EAGER_NOTE in err for _, err in outs)


def test_chain_raises_over_ranks(ranks_run):
    """A chained step (on the CPU: static buffers, no capture) over the two
    ranks: its first call records two exchanges and gives what eager
    exchanges give; a call with three or one raises on both ranks, and
    the step then runs as before; a barrier or the parameters' check
    inside it raises; ``check_sequence`` raises where the ranks' lists
    differ and passes where they agree."""
    _, ranks, _ = ranks_run
    send = [np.arange(6.0, dtype=np.float32).reshape(2, 3) + 10.0 * r
            for r in range(2)]
    for r, res in enumerate(ranks):
        c = res["chain_checks"]
        # two exchanges: block j to rank j and back, each doubled
        np.testing.assert_array_equal(c["first"], 4.0 * send[r])
        np.testing.assert_array_equal(c["again"], c["first"])
        assert c["sequence"] == [("all_to_all", (0, 1))] * 2
        assert "collective 2 of this call" in c["more"]
        assert "issued 1 collectives, the first 2" in c["fewer"]
        for name in ("barrier", "check"):
            assert "reached inside a chained step's piece" in c[name]
        assert "differ between the ranks of group (0, 1)" in (
            c["ranks_differ"])


def test_halo_serve_in_a_group_serves_the_whole_graph_per_rank(ranks_run):
    """Serving stays per process (desco_tpu cannot read a graph-sharded
    result back across processes): ``serve_gossip_counts`` called inside
    the group shards over the rank's own device and gives every rank the
    whole graph's counts, bit-equal to one process."""
    job, ranks, _ = ranks_run
    graph, x_all = job["serve"]
    with torch.inference_mode():
        want = halo.serve_gossip_counts(
            params_from_jax(job["halo_gossip"]).requires_grad_(False), graph,
            x_all, torch.from_numpy(job["halo_q"]), n_devices=4,
            device="cpu")
    assert want.shape == (graph.n_nodes, x_all.shape[1])
    for res in ranks:
        np.testing.assert_array_equal(res["serve"], want)
