"""desco_tpu_torch host layer against desco_tpu: the static query table,
canonical-neighborhood samples, packing and gossip samples must be
IDENTICAL (the port copies this code; nothing here is floating point
beyond copies)."""

import numpy as np
import pytest
import torch

from conftest import random_graph
from desco_tpu.batch.packed import auto_capacities as j_auto_capacities
from desco_tpu.batch.packed import pack_samples as j_pack
from desco_tpu.batch.packed import stack_batches as j_stack
from desco_tpu.data.workload import Workload as JWorkload
from desco_tpu.graph.atlas import gen_queries as j_gen_queries
from desco_tpu.graph.atlas import gen_query_ids as j_gen_query_ids
from desco_tpu.graph.atlas_plus_data import EDGELIST_PLUS
from desco_tpu_torch.batch.packed import (
    PAD_EDGE_TYPE, auto_capacities, pack_samples, stack_batches)
from desco_tpu_torch.data.workload import Workload
from desco_tpu_torch.graph import Graph, gen_queries, gen_query_ids
from desco_tpu_torch.graph.atlas import ATLAS
from desco_tpu_torch.truth import native
from test_torch_shmp import one_torch_thread  # noqa: F401 (autouse)


def _graphs(seed, n=6, size=15, p=0.3):
    rng = np.random.default_rng(seed)
    return [random_graph(rng, size, p) for _ in range(n)]


def _same_graphs(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.n_nodes == y.n_nodes
        np.testing.assert_array_equal(x.edges, y.edges)


@pytest.mark.parametrize("sizes", [[3, 4, 5], [3], [4, 5], [5, 3]])
def test_query_table_equals_atlas(sizes):
    ids = gen_query_ids(sizes)
    assert ids == j_gen_query_ids(sizes)
    _same_graphs(gen_queries(ids), j_gen_queries(ids))


def test_query_table_is_the_29_standard_queries():
    ids = gen_query_ids([3, 4, 5])
    assert ids == j_gen_query_ids([3, 4, 5])
    assert len(ids) == 29 and min(ids) == 6 and max(ids) == 52
    # the table is the whole atlas; size 6 scans past the standard set
    assert len(ATLAS) == 1253
    assert gen_query_ids([6]) == j_gen_query_ids([6])


def test_extended_ids_equal_graph_atlas_plus():
    ids = sorted(EDGELIST_PLUS)
    _same_graphs(gen_queries(ids), j_gen_queries(ids))


def _same_samples(a, b):
    assert len(a) == len(b)
    for s, t in zip(a, b):
        for f in ("node_type", "x", "edge_src", "edge_dst", "edge_type",
                  "y"):
            np.testing.assert_array_equal(getattr(s, f), getattr(t, f), f)


@pytest.mark.parametrize("use_tconv,use_native", [
    (True, True), (True, False), (False, True)])
def test_neighborhood_samples_identical(tmp_path, monkeypatch, use_tconv,
                                        use_native):
    from desco_tpu.truth import native as j_native

    if not use_native:  # the pure-Python partition and typing paths
        monkeypatch.setattr(native, "native_available", lambda: False)
        monkeypatch.setattr(j_native, "native_available", lambda: False)
    jgraphs = _graphs(2)
    graphs = [Graph(g.n_nodes, g.edges) for g in jgraphs]
    wl = Workload(graphs)
    truth = np.random.default_rng(0).random((wl.total_nodes, 29))
    samples, nindex = wl.neighborhood_samples(4, use_tconv=use_tconv,
                                              truth=truth)
    jsamples, jindex = JWorkload(jgraphs, root=str(tmp_path)) \
        .neighborhood_samples(4, j_gen_query_ids([3, 4, 5]),
                              use_tconv=use_tconv, truth=truth,
                              use_cache=False)
    _same_samples(samples, jsamples)
    np.testing.assert_array_equal(nindex.index, jindex.index)
    np.testing.assert_array_equal(nindex.indicator, jindex.indicator)


def test_packing_identical(tmp_path):
    jgraphs = _graphs(3, n=8)
    graphs = [Graph(g.n_nodes, g.edges) for g in jgraphs]
    wl = Workload(graphs)
    truth = np.random.default_rng(1).random((wl.total_nodes, 29))
    samples, nindex = wl.neighborhood_samples(3, truth=truth)
    for g_cap, slack in ((16, 1.0), (64, 1.2)):
        caps = auto_capacities(samples, g_cap=g_cap, slack=slack)
        assert caps == j_auto_capacities(samples, g_cap=g_cap, slack=slack)
        ours = pack_samples(samples, *caps, n_queries=29)
        ref = j_pack(samples, *caps, n_queries=29)
        assert len(ours) == len(ref) > 0
        for b, r in zip(ours, ref):
            for name, v in b.fields():
                np.testing.assert_array_equal(v, getattr(r, name), name)
            # layout invariants: pad node last, pad edge type, sorted keys
            pad = b.edge_type == PAD_EDGE_TYPE
            assert np.all(b.edge_src[pad] == b.n_cap - 1)
            keys = b.edge_dst.astype(np.int64) * 6 + b.edge_type
            assert np.all(np.diff(keys) >= 0)
        np.testing.assert_array_equal(stack_batches(ours).x,
                                      j_stack(ref).x)
    # gossip samples over the original graphs
    counts = np.random.default_rng(2).random((len(samples), 29))
    js = JWorkload(jgraphs, root=str(tmp_path)).gossip_samples(
        counts, nindex, truth)
    ts = wl.gossip_samples(counts, nindex, truth)
    _same_samples(ts, js)
    for s, t in zip(ts, js):
        np.testing.assert_array_equal(s.node_y, t.node_y)


def test_packed_batch_to_device_and_stack():
    graphs = [Graph(g.n_nodes, g.edges) for g in _graphs(4)]
    samples, _ = Workload(graphs).neighborhood_samples(2)
    batches = pack_samples(samples, *auto_capacities(samples, g_cap=8))
    stacked = stack_batches(batches)
    # consecutive views of one block stack without a copy
    assert np.shares_memory(stacked.x, batches[0].x)
    dev = stacked.to("cpu")
    assert dev.edge_bwd_perm is None and dev.y is None
    assert dev.edge_src.dtype == torch.int32
    assert dev.n_cap == batches[0].n_cap and dev.g_cap == batches[0].g_cap
    np.testing.assert_array_equal(dev[1].edge_dst.numpy(),
                                  batches[1].edge_dst)


def test_native_engine_builds_outside_native_dir():
    """The port builds the shared C++ source into its own build dir."""
    import os

    assert native.engine() == "native"
    so = native._build()
    assert os.path.dirname(so).endswith(os.path.join("desco_tpu_torch",
                                                     "build", "native"))


@pytest.mark.parametrize("degree_feature", [False, True])
def test_query_batch_identical(degree_feature):
    from desco_tpu.pipeline import PipelineConfig as JConfig
    from desco_tpu.pipeline import build_query_batch as j_build
    from desco_tpu_torch.pipeline import PipelineConfig, build_query_batch

    ours = build_query_batch(PipelineConfig(degree_feature=degree_feature))
    ref = j_build(JConfig(degree_feature=degree_feature))
    for name, v in ours.fields():
        np.testing.assert_array_equal(v, getattr(ref, name), name)
    assert (ours.x.max() > 0) == degree_feature


@pytest.mark.parametrize("sid", [460, 700, 1000, 1379, 1380, 1397, 1415])
def test_synthetic_sizes_follow_syn_1827(sid):
    """The numpy generator draws (nodes, edges) exactly as desco_tpu's
    Syn_1827 recipe does for the same sample id and random state."""
    from desco_tpu.data.synthetic import _syn_1827_samplers
    from desco_tpu_torch.data.synthetic import SIDS, syn_1827_size

    assert SIDS[0] <= sid < SIDS[1]
    for seed in range(20):
        # generate_synthetic's draws for one sample (synthetic.py:245-249)
        rng = np.random.default_rng(seed)
        node_num, avg_degree = _syn_1827_samplers(rng)
        n = max(int(node_num(sid)), 2)
        avg_edges = int(n * avg_degree(sid))
        edge = int(rng.normal(1, 0.1) * avg_edges)
        edge = max(min(edge, n * (n - 1) // 2), n - 1)
        assert syn_1827_size(np.random.default_rng(seed), sid) == (n, edge)
        assert 30 <= n <= 120


def test_synthetic_graphs_connected_and_dense():
    from desco_tpu_torch.data.synthetic import random_connected_graphs

    graphs = random_connected_graphs(40, np.random.default_rng(0))
    for g in graphs:
        assert 30 <= g.n_nodes <= 120
        parent = list(range(g.n_nodes))

        def find(a):
            while parent[a] != a:
                a = parent[a]
            return a

        for u, v in g.edges:
            parent[find(int(u))] = find(int(v))
        assert len({find(v) for v in range(g.n_nodes)}) == 1
    # Syn_1827's grid averages about 6.5 edges per node
    per_node = np.mean([g.n_edges / g.n_nodes for g in graphs])
    assert 4.0 < per_node < 9.0
