"""desco_tpu_torch's DP x halo composition (parallel/topology.py) against
desco_tpu's, on the CPU.

desco_tpu runs a ("data", "graph") mesh of 2 x 4 of the 8 fake host
devices tests/conftest.py sets up; the port holds the same grid as two
replicas of four shards each, all on the CPU. Same numpy inputs from a
seed, same weights (``params_from_jax``), dropout 0 where compared.

Tolerances: harmonized and stacked partitions array-equal; the composed
gossip loss rtol 1e-5 and its gradients rtol 1e-4 / atol 1e-5, desco_tpu's
own bounds (tests/test_topology.py); the composed loss against the
port's own sum of single-replica halo losses rtol 1e-6 and gradients rtol
1e-6 / atol 1e-9 (the same sums, taken per replica and added in replica
order); the composed SHMP forward rtol 1e-4 / atol 1e-5
(tests/test_torch_halo.py)."""

import copy
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from conftest import random_graph
from desco_tpu.batch.build import gossip_sample as j_gossip_sample
from desco_tpu.models import gossip as jgossip
from desco_tpu.parallel import halo as jhalo
from desco_tpu.parallel import topology as jtopo
from desco_tpu.train.checkpoint import _flatten
from desco_tpu_torch.batch.build import gossip_sample
from desco_tpu_torch.graph import Graph
from desco_tpu_torch.parallel import halo, topology
from desco_tpu_torch.train.checkpoint import params_from_jax
from desco_tpu_torch.train.loop import make_adam

from test_torch_grad import flatten_grads
from test_torch_halo import assert_same_partition, tower, typed_graph
from test_torch_shmp import one_torch_thread  # noqa: F401 (autouse)

N_DATA, N_GRAPH = 2, 4
CPU = [torch.device("cpu")]


def replica_specs(seed=0, q_n=2):
    """Two DIFFERENT graphs (sizes and densities) as partitioner kwargs,
    the same arrays for both packages."""
    rng = np.random.default_rng(seed)
    specs = []
    for n, p in ((34, 0.15), (52, 0.09)):
        jg = random_graph(rng, n, p)
        counts = rng.random((n, q_n)).astype(np.float32)
        truth = rng.random((n, q_n)).astype(np.float32)
        s = gossip_sample(Graph(jg.n_nodes, jg.edges), counts, truth)
        js = j_gossip_sample(jg, counts, truth)
        for f in ("edge_src", "edge_dst", "edge_type", "node_type"):
            np.testing.assert_array_equal(getattr(s, f), getattr(js, f))
        specs.append(dict(n_nodes=n, node_type=s.node_type, x=counts,
                          edge_src=s.edge_src, edge_dst=s.edge_dst,
                          edge_type=s.edge_type, node_y=truth))
    return specs


def gossip_weights(seed=5, hidden=8, q_n=2):
    jp = jgossip.init_gossip_model(jax.random.PRNGKey(seed),
                                   hidden_dim=hidden, emb_channels=hidden)
    q = np.random.default_rng(seed).standard_normal((q_n, hidden)).astype(
        np.float32)
    return jp, q


def test_mesh2d_grid_shape():
    mesh = topology.make_mesh2d(N_DATA, N_GRAPH, devices=CPU)
    assert mesh.shape == (N_DATA, N_GRAPH)
    assert all(d == CPU[0] for row in mesh.devices for d in row)
    two = [torch.device("cpu"), torch.device("meta")]
    grid = topology.make_mesh2d(2, 3, devices=two)
    # the graph axis innermost, cycling over the devices
    assert [[d.type for d in row] for row in grid.devices] == [
        ["cpu", "meta", "cpu"], ["meta", "cpu", "meta"]]
    assert jtopo.make_mesh2d(N_DATA, N_GRAPH).devices.shape == mesh.shape
    if not torch.cuda.is_available():  # the default devices are GPUs
        with pytest.raises(RuntimeError, match="CUDA"):
            topology.make_mesh2d(2, 2)


def test_harmonized_and_stacked_partitions_are_array_equal():
    specs = replica_specs()
    jparts = jtopo.harmonized_partitions(specs, N_GRAPH, n_types=2)
    tparts = topology.harmonized_partitions(specs, N_GRAPH, n_types=2)
    # the two graphs need different caps alone: harmonizing re-partitions
    alone = [halo.partition_caps(halo.partition_typed_graph(
        n_devices=N_GRAPH, n_types=2, **s)) for s in specs]
    assert alone[0] != alone[1]
    for jp, tp in zip(jparts, tparts):
        assert_same_partition(jp, tp)
    assert halo.partition_caps(tparts[0]) == halo.partition_caps(tparts[1])
    jst, tst = jtopo.stack_partitions(jparts), topology.stack_partitions(
        tparts)
    assert tst.n_devices == N_DATA * N_GRAPH
    assert_same_partition(jst, tst)
    replicas = topology.place_replicas(
        tst, topology.make_mesh2d(N_DATA, N_GRAPH, devices=CPU))
    assert [len(r) for r in replicas] == [N_GRAPH] * N_DATA
    for tp, shards in zip(tparts, replicas):
        ref = halo.place_shards(tp, CPU)
        for a, b in zip(shards, ref):
            assert torch.equal(a.x, b.x) and torch.equal(a.node_y, b.node_y)
            assert torch.equal(a.interior.edge_src, b.interior.edge_src)
            assert torch.equal(a.push_rows, b.push_rows)


def test_dp_halo_gossip_loss_and_grads_match():
    specs = replica_specs(seed=1)
    jp, q = gossip_weights()
    stacked = topology.stack_partitions(
        topology.harmonized_partitions(specs, N_GRAPH, n_types=2))
    jmesh = jtopo.make_mesh2d(N_DATA, N_GRAPH)

    @partial(jax.shard_map, mesh=jmesh,
             in_specs=(P(), P(("data", "graph")), P()),
             out_specs=(P(), P()))
    def lg(params, part, qe):
        shard = jax.tree_util.tree_map(lambda a: a[0], part)
        return jax.value_and_grad(
            lambda p: jax.lax.psum(
                jhalo.halo_gossip_loss(p, shard, qe, "graph"), "data"))(
            params)

    jstacked = jtopo.stack_partitions(
        jtopo.harmonized_partitions(specs, N_GRAPH, n_types=2))
    with jmesh:
        want, jgrads = jax.jit(lg)(jp, jstacked, jnp.asarray(q))
    mesh = topology.make_mesh2d(N_DATA, N_GRAPH, devices=CPU)
    replicas = topology.place_replicas(stacked, mesh)
    tp = params_from_jax(_flatten(jp))
    loss, flat = topology.dp_halo_gossip_loss_and_grads(
        tp, replicas, torch.from_numpy(q))
    make_adam(tp).grad.copy_(flat)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    got = flatten_grads(tp)
    for key, d in _flatten(jgrads).items():
        np.testing.assert_allclose(got[key], d, rtol=1e-4, atol=1e-5,
                                   err_msg=key)
    # the port's own sum of single-replica halo losses
    tp2 = params_from_jax(_flatten(jp))
    total = None
    for shards in replicas:
        one = halo.halo_gossip_loss(tp2, shards, torch.from_numpy(q))
        one.backward()
        total = one.detach() if total is None else total + one.detach()
    np.testing.assert_allclose(float(loss), float(total), rtol=1e-6)
    for key, ref in flatten_grads(tp2).items():
        np.testing.assert_allclose(got[key], ref, rtol=1e-6, atol=1e-9,
                                   err_msg=key)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_dp_halo_step_updates_and_repeats(dropout):
    """One composed step moves the parameters with a finite loss; two from
    the same weights and seed give the same bits; a step over one replica
    is that replica's halo loss alone."""
    specs = replica_specs(seed=2)
    jp, q = gossip_weights(seed=3)
    mesh = topology.make_mesh2d(N_DATA, N_GRAPH, devices=CPU)
    replicas = topology.place_replicas(topology.stack_partitions(
        topology.harmonized_partitions(specs, N_GRAPH, n_types=2)), mesh)
    runs = []
    for _ in range(2):
        tp = params_from_jax(_flatten(jp))
        before = copy.deepcopy(tp)
        opt = make_adam(tp)
        step = topology.dp_halo_gossip_step_fn(opt, dropout=dropout)
        loss, ok = step(tp, replicas, torch.from_numpy(q), 1e-3, seed=4)
        assert bool(ok) and np.isfinite(float(loss))
        moved = sum(float((a.detach() - b.detach()).abs().sum())
                    for a, b in zip(tp.parameters(), before.parameters()))
        assert moved > 0.0
        runs.append((float(loss), opt.grad.clone()))
    assert runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1], runs[1][1])
    tp = params_from_jax(_flatten(jp))
    one, _ = topology.dp_halo_gossip_step_fn(make_adam(tp))(
        tp, replicas[:1], torch.from_numpy(q), 0.0)
    with torch.no_grad():
        alone = halo.halo_gossip_loss(params_from_jax(_flatten(jp)),
                                      replicas[0], torch.from_numpy(q))
    assert float(one) == float(alone)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_graphed_dp_halo_step_equals_eager(dropout):
    """Two calls (seeds 4, 5) of the composed step's graphed form (static
    buffers, no capture on the CPU) against the eager step from the same
    weights: losses, flags, gradients, parameters and Adam's moments bit
    for bit."""
    specs = replica_specs(seed=2)
    jp, q = gossip_weights(seed=3)
    mesh = topology.make_mesh2d(N_DATA, N_GRAPH, devices=CPU)
    replicas = topology.place_replicas(topology.stack_partitions(
        topology.harmonized_partitions(specs, N_GRAPH, n_types=2)), mesh)
    runs = []
    for graphed in (False, True):
        tp = params_from_jax(_flatten(jp))
        opt = make_adam(tp)
        step = topology.dp_halo_gossip_step_fn(opt, dropout=dropout,
                                               graphed=graphed)
        calls = []
        for seed in (4, 5):
            loss, ok = step(tp, replicas, torch.from_numpy(q), 1e-3,
                            seed=seed)
            calls.append((loss, ok, opt.grad.clone(), opt.flat.clone(),
                          opt.mu.clone(), opt.nu.clone()))
        runs.append(calls)
    for a, b in zip(*runs):
        assert bool(a[1]) and np.isfinite(float(a[0]))
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("conv", ["SAGE", "GAT"])
def test_dp_halo_shmp_forward_matches(conv):
    """The composed SHMP forward per replica against desco_tpu's
    ``dp_halo_shmp_forward`` and the port's own ``halo_shmp_core``."""
    (jcfg, jparams), (tcfg, tparams) = tower(conv)
    graphs = [typed_graph(seed=1, n=40), typed_graph(seed=4, n=30, p=0.2)]
    specs = [dict(n_nodes=s.n_nodes, node_type=s.node_type, x=s.x,
                  edge_src=s.edge_src, edge_dst=s.edge_dst,
                  edge_type=s.edge_type) for s in graphs]
    kw = dict(n_types=tcfg.n_edge_types, force_pull=conv == "GAT")
    jst = jtopo.stack_partitions(
        jtopo.harmonized_partitions(specs, N_GRAPH, **kw))
    tparts = topology.harmonized_partitions(specs, N_GRAPH, **kw)
    jmesh = jtopo.make_mesh2d(N_DATA, N_GRAPH)
    with jmesh:
        want = np.asarray(jax.jit(jtopo.dp_halo_shmp_forward(jcfg, jmesh))(
            jparams, jst))
    mesh = topology.make_mesh2d(N_DATA, N_GRAPH, devices=CPU)
    replicas = topology.place_replicas(topology.stack_partitions(tparts),
                                       mesh)
    with torch.inference_mode():
        got = topology.dp_halo_shmp_forward(tcfg)(tparams, replicas)
        for d, (part, shards) in enumerate(zip(tparts, replicas)):
            out = np.stack([o.numpy() for o in got[d]])
            rows = slice(d * N_GRAPH, (d + 1) * N_GRAPH)
            np.testing.assert_allclose(
                halo.unpartition_nodes(part, out),
                halo.unpartition_nodes(part, want[rows]),
                rtol=1e-4, atol=1e-5)
            own = halo.halo_shmp_core(tparams, tcfg,
                                      halo.place_shards(part, CPU))
            for a, b in zip(got[d], own):
                assert torch.equal(a, b)
