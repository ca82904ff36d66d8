"""The port's whole graph atlas against desco_tpu's networkx lookup, and
queries of size 6 end to end: the truth equal, served counts within
rtol 1e-3 of desco_tpu on release/r4 (the serving tolerance of
tests/test_torch_serving.py)."""

import numpy as np
import pytest

from desco_tpu.graph import atlas as jatlas
from desco_tpu.graph.container import Graph as JGraph
from desco_tpu_torch.graph import Graph, atlas
from desco_tpu_torch.graph.atlas_data import ATLAS
from test_torch_shmp import one_torch_thread  # noqa: F401 (autouse)

NEIGH, GOSSIP = "release/r4/neigh.best", "release/r4/gossip.best"
# three size-6 ids, 6, 8 and 15 edges (K6, the scan's last id); the
# sparser trees (77 is the star) take seconds of VF2 on Syn_4's graphs
SIZE6 = [100, 150, 208]


@pytest.mark.parametrize("start", range(0, 1253, 100))
def test_atlas_ids_equal_desco_tpu(start):
    """Every atlas id 0-1252, disconnected graphs included, in blocks of
    100: nodes and edges in desco_tpu's order."""
    for i in range(start, min(start + 100, 1253)):
        want = JGraph.from_networkx(jatlas.graph_atlas_plus(i))
        got = atlas.graph_atlas_plus(i)
        assert got.n_nodes == want.n_nodes == ATLAS[i][0], i
        np.testing.assert_array_equal(got.edges, want.edges, err_msg=str(i))
        assert got.edges.dtype == want.edges.dtype


@pytest.mark.parametrize("sizes", [[3], [6], [7], [3, 4, 5], [6, 5]])
def test_gen_query_ids_equal_desco_tpu(sizes):
    got = atlas.gen_query_ids(sizes)
    assert got == jatlas.gen_query_ids(sizes)
    if sizes == [6]:
        assert len(got) == 112 and (got[0], got[-1]) == (77, 208)
    if sizes == [7]:  # desco_tpu's scan ends before the first 7-node id
        assert got == []


def test_size6_queries_pack_like_desco_tpu():
    """The query tower's samples and packed batch of sizes 3-6 (tconv
    typing, capacities) equal desco_tpu's."""
    from desco_tpu.pipeline import PipelineConfig as JConfig
    from desco_tpu.pipeline import build_query_batch as j_build
    from desco_tpu_torch.pipeline import PipelineConfig, build_query_batch

    ids = atlas.gen_query_ids([3, 6])
    got = build_query_batch(PipelineConfig(custom_query_ids=ids))
    want = j_build(JConfig(custom_query_ids=ids))
    for f in ("node_type", "edge_src", "edge_dst", "edge_type",
              "node_graph", "node_mask", "graph_mask"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_size6_truth_equals_desco_tpu(tmp_path):
    from desco_tpu.data.datasets import load_data as j_load
    from desco_tpu.data.workload import Workload as JWorkload
    from desco_tpu_torch.data.datasets import load_data
    from desco_tpu_torch.data.workload import Workload

    jgraphs = j_load("Syn_4", str(tmp_path / "j"))
    graphs = load_data("Syn_4", str(tmp_path / "t"))
    assert len(graphs) == 4
    for g, h in zip(graphs, jgraphs):
        np.testing.assert_array_equal(g.edges, h.edges)
    want = JWorkload(jgraphs, str(tmp_path / "j" / "Syn_4")
                     ).compute_groundtruth(SIZE6)
    got = Workload(graphs, str(tmp_path / "t" / "Syn_4")
                   ).compute_groundtruth(SIZE6)
    assert got.shape == (sum(g.n_nodes for g in graphs), 3)
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0
    # the truth cache is keyed by the query signature, size-6 ids included
    again = Workload(graphs, str(tmp_path / "t" / "Syn_4")
                     ).compute_groundtruth(SIZE6)
    np.testing.assert_array_equal(again, got)


def test_size6_serving_matches_desco_tpu():
    """release/r4 serving query ids of sizes 3-6: bounds, clamp,
    verification and the gossip over the larger query set."""
    from desco_tpu.data.synthetic import generate_synthetic
    from desco_tpu.serving import CountingService as JService
    from desco_tpu_torch.serving import CountingService

    ids = [6, 7, 13, 29, 77] + SIZE6
    jgraphs = generate_synthetic(4, min_size=10, max_size=20, seed=5)
    graphs = [Graph(g.n_nodes, g.edges.copy()) for g in jgraphs]
    over = {"custom_query_ids": ids}
    got = CountingService(NEIGH, GOSSIP, device="cpu",
                          config_overrides=over).count(graphs)
    want = JService(NEIGH, GOSSIP, config_overrides=over).count(jgraphs)
    assert got.graphlet_counts.shape == (4, len(ids))
    for f in ("neighborhood_counts", "node_counts"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-3, atol=1e-2, err_msg=f)
    np.testing.assert_array_equal(got.verified_rows, want.verified_rows)
    assert np.abs(got.graphlet_counts - want.graphlet_counts).max() <= 1
