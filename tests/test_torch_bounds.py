"""desco_tpu_torch combinatorial count bounds against desco_tpu.

Both run the spanning-tree SpMV chains in float32 over the same packed
batches; the sums are taken in another order, so rtol 1e-5."""

import numpy as np

from conftest import random_graph
from desco_tpu.batch.packed import PackedGraphs as JPacked
from desco_tpu.graph.atlas import gen_queries as j_gen_queries
from desco_tpu.truth.bounds import neighborhood_count_bounds as j_bounds
from desco_tpu_torch.batch.packed import auto_capacities, pack_samples
from desco_tpu_torch.data.workload import Workload
from desco_tpu_torch.graph import Graph, gen_queries, gen_query_ids
from desco_tpu_torch.truth import native
from desco_tpu_torch.truth.bounds import (
    clamp_counts, neighborhood_count_bounds, tree_schedules)
from test_torch_shmp import one_torch_thread  # noqa: F401 (autouse)


def _batches(seed, depth=3):
    rng = np.random.default_rng(seed)
    graphs = [Graph(g.n_nodes, g.edges)
              for g in (random_graph(rng, 16, 0.25) for _ in range(6))]
    samples, _ = Workload(graphs).neighborhood_samples(depth=depth)
    # several batches, the last one part empty
    return graphs, samples, pack_samples(
        samples, *auto_capacities(samples, g_cap=16), need_bwd_perm=False)


def test_bounds_match_desco_tpu():
    _, samples, batches = _batches(0)
    assert len(batches) > 1
    ids = gen_query_ids([3, 4, 5])
    out = neighborhood_count_bounds(batches, gen_queries(ids), device="cpu")
    ref = j_bounds([JPacked(**dict(b.fields())) for b in batches],
                   j_gen_queries(ids))
    assert out.shape == (len(samples), 29) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=1e-5)


def test_bounds_hold_and_clamp():
    """Every exact canonical count lies under its bound; the clamp never
    raises a prediction."""
    graphs, samples, batches = _batches(1, depth=4)
    queries = gen_queries(gen_query_ids([3, 4, 5]))
    ubs = neighborhood_count_bounds(batches, queries, device="cpu")
    wl = Workload(graphs)
    _, nindex = wl.neighborhood_samples(depth=4)
    truth = np.concatenate(native.parallel_canonical_counts(graphs, queries))
    rows = wl.node_offsets[nindex.index[:, 0]] + nindex.index[:, 1]
    assert np.all(truth[rows] <= ubs * (1 + 1e-6))
    pred = np.full_like(ubs, 1e9)
    np.testing.assert_array_equal(clamp_counts(pred, ubs), ubs)
    np.testing.assert_array_equal(clamp_counts(truth[rows], ubs),
                                  truth[rows].astype(np.float64))


def test_tree_schedules_cover_every_rooting():
    for q in gen_queries(gen_query_ids([3, 4, 5])):
        scheds = tree_schedules(q)
        assert len(scheds) == q.n_nodes
        for r, s in enumerate(scheds):
            assert len(s) == q.n_nodes - 1
            assert (s[-1][1] if s else 0) == r  # the root comes last
