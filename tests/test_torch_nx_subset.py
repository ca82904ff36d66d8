"""``desco_tpu_torch.data.nx_subset`` against networkx 3.6.1: each copied
function, on several seeds and sizes, gives the same nodes in the same
order, the same ``edges()`` sequence and the same components in the same
order — what desco_tpu's generators index into."""

import random

import networkx as nx
import numpy as np
import pytest

from desco_tpu_torch.data import nx_subset as nxs


def assert_same(g: nxs.Graph, h: nx.Graph) -> None:
    assert list(g) == list(h)
    assert g.edges() == list(h.edges())
    assert g.number_of_edges() == h.number_of_edges()
    assert [d for _, d in g.degrees()] == [d for _, d in h.degree()]


@pytest.mark.parametrize("n,p", [(1, 0.3), (5, 0.0), (6, 1.0), (30, 0.05),
                                 (40, 0.2), (80, 0.03)])
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_gnp_random_graph(n, p, seed):
    assert_same(nxs.gnp_random_graph(n, p, seed=seed),
                nx.gnp_random_graph(n, p, seed=seed))
    assert nxs.erdos_renyi_graph is nxs.gnp_random_graph


@pytest.mark.parametrize("n,m", [(1, 0), (10, 9), (10, 45), (10, 60),
                                 (50, 120), (200, 300)])
@pytest.mark.parametrize("seed", [0, 3, 99])
def test_gnm_random_graph(n, m, seed):
    assert_same(nxs.gnm_random_graph(n, m, seed=seed),
                nx.gnm_random_graph(n, m, seed=seed))


@pytest.mark.parametrize("n,k,p", [(10, 2, 0.5), (20, 4, 0.1), (20, 20, 0.3),
                                   (30, 7, 0.9), (6, 5, 1.0)])
@pytest.mark.parametrize("seed", [0, 11, 2024])
def test_watts_strogatz_graph(n, k, p, seed):
    assert_same(nxs.watts_strogatz_graph(n, k, p, seed=seed),
                nx.watts_strogatz_graph(n, k, p, seed=seed))


def test_watts_strogatz_rejects_k_above_n():
    with pytest.raises(nxs.NetworkXError, match="k>n"):
        nxs.watts_strogatz_graph(4, 5, 0.1, seed=0)


@pytest.mark.parametrize("n,k,p,tries", [(20, 4, 0.1, 100), (30, 2, 1.0, 1),
                                         (50, 2, 0.3, 1), (20, 3, 0.9, 1)])
def test_connected_watts_strogatz_graph_and_its_failure(n, k, p, tries):
    """Same graph, or the same NetworkXError after the same draws (the
    generator state afterwards is compared through one more draw)."""
    raised = 0
    for seed in range(12):
        rng_a, rng_b = random.Random(seed), random.Random(seed)
        try:
            h = nx.connected_watts_strogatz_graph(n, k, p, tries=tries,
                                                  seed=rng_b)
        except nx.NetworkXError as err:
            with pytest.raises(nxs.NetworkXError, match=str(err)):
                nxs.connected_watts_strogatz_graph(n, k, p, tries=tries,
                                                   seed=rng_a)
            raised += 1
        else:
            assert_same(nxs.connected_watts_strogatz_graph(
                n, k, p, tries=tries, seed=rng_a), h)
        assert rng_a.random() == rng_b.random()
    if tries < 100:
        assert raised > 0, "no seed reached the failure path"
    assert issubclass(nxs.NetworkXError, nxs.NetworkXException)


@pytest.mark.parametrize("n,m", [(2, 1), (10, 1), (30, 3), (100, 5),
                                 (60, 59)])
@pytest.mark.parametrize("seed", [0, 5, 77])
def test_barabasi_albert_graph(n, m, seed):
    assert_same(nxs.barabasi_albert_graph(n, m, seed=seed),
                nx.barabasi_albert_graph(n, m, seed=seed))


def test_barabasi_albert_rejects_bad_m():
    with pytest.raises(nxs.NetworkXError):
        nxs.barabasi_albert_graph(5, 5, seed=0)


@pytest.mark.parametrize("n,m,p", [(10, 1, 0.0), (30, 3, 0.5), (60, 4, 1.0),
                                   (100, 2, 0.1), (8, 8, 0.3)])
@pytest.mark.parametrize("seed", [1, 8, 4096])
def test_powerlaw_cluster_graph(n, m, p, seed):
    assert_same(nxs.powerlaw_cluster_graph(n, m, p, seed=seed),
                nx.powerlaw_cluster_graph(n, m, p, seed=seed))


@pytest.mark.parametrize("k", [3, 4, 8, 20, 64])
def test_from_prufer_sequence(k):
    rng = np.random.default_rng(k)
    for _ in range(10):
        seq = rng.integers(0, k, size=k - 2).tolist()
        assert_same(nxs.from_prufer_sequence(seq),
                    nx.from_prufer_sequence(seq))
    with pytest.raises(nxs.NetworkXError, match="Invalid Prufer"):
        nxs.from_prufer_sequence([0, k + 5] + [0] * (k - 4))


@pytest.mark.parametrize("n,p", [(30, 0.02), (60, 0.02), (200, 0.005),
                                 (600, 0.002)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_connected_components_of_disconnected_graphs(n, p, seed):
    """Same sets, in the same order, iterating in the same order (values
    above the set's table size, where the insertion history decides)."""
    g = nxs.gnp_random_graph(n, p, seed=seed)
    h = nx.gnp_random_graph(n, p, seed=seed)
    mine = [list(c) for c in nxs.connected_components(g)]
    theirs = [list(c) for c in nx.connected_components(h)]
    assert len(theirs) > 1
    assert mine == theirs
    assert nxs.is_connected(g) == nx.is_connected(h)
    # after edges are added out of order, as _connect_components does
    rng = np.random.default_rng(seed)
    for _ in range(n // 4):
        u, v = (int(x) for x in rng.integers(0, n, 2))
        g.add_edge(u, v)
        h.add_edge(u, v)
    assert_same(g, h)
    assert ([list(c) for c in nxs.connected_components(g)]
            == [list(c) for c in nx.connected_components(h)])


def test_is_connected_on_the_null_graph():
    with pytest.raises(nxs.NetworkXException):
        nxs.is_connected(nxs.Graph())
    assert nxs.is_connected(nxs.complete_graph(3))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_from_numpy_array(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 40))
    a = rng.random((n, n)) < 0.15
    a = (a | a.T) & ~np.eye(n, dtype=bool)
    assert_same(nxs.from_numpy_array(a.astype(np.int8)),
                nx.from_numpy_array(a.astype(np.int8)))


@pytest.mark.parametrize("n,p", [(40, 0.03), (40, 0.08), (120, 0.01),
                                 (300, 0.004)])
@pytest.mark.parametrize("seed", [0, 4])
def test_largest_component_relabeled(n, p, seed):
    """``convert_node_labels_to_integers(G.subgraph(c).copy())`` for the
    largest component: both of the copy's node orders are reached (the
    component's own set order below half the graph, the graph's above)."""
    g = nxs.gnp_random_graph(n, p, seed=seed)
    h = nx.gnp_random_graph(n, p, seed=seed)
    c_g = max(nxs.connected_components(g), key=len)
    c_h = max(nx.connected_components(h), key=len)
    sub_h = h.subgraph(c_h).copy()
    assert_same(g.subgraph_copy(c_g), sub_h)
    assert_same(nxs.convert_node_labels_to_integers(g.subgraph_copy(c_g)),
                nx.convert_node_labels_to_integers(sub_h))


def test_subgraph_copy_takes_both_orders():
    g = nxs.empty_graph(10)
    g.add_edges_from([(9, 8), (8, 7), (1, 2)])
    small = g.subgraph_copy([9, 7, 8])
    large = g.subgraph_copy(list(range(9, -1, -1)))
    assert large.nodes() == list(range(10))
    h = nx.empty_graph(10)
    h.add_edges_from([(9, 8), (8, 7), (1, 2)])
    assert_same(small, h.subgraph([9, 7, 8]).copy())
    assert_same(large, h.subgraph(list(range(9, -1, -1))).copy())


def test_graph_methods():
    g, h = nxs.Graph(), nx.Graph()
    for u, v in [(3, 1), (1, 2), (2, 3), (5, 5), (0, 3)]:
        g.add_edge(u, v)
        h.add_edge(u, v)
    assert_same(g, h)
    assert g.degree(5) == h.degree(5) == 2
    assert g.has_edge(1, 3) and not g.has_edge(0, 1) and not g.has_edge(9, 0)
    g.remove_edge(3, 1)
    h.remove_edge(3, 1)
    g.remove_edge(5, 5)
    h.remove_edge(5, 5)
    assert_same(g, h)
    assert list(g.neighbors(3)) == list(h.neighbors(3))
    with pytest.raises(nxs.NetworkXError):
        g.remove_edge(0, 1)
    assert_same(nxs.star_graph(4), nx.star_graph(4))
    assert_same(nxs.complete_graph(5), nx.complete_graph(5))
    assert_same(nxs.empty_graph(3), nx.empty_graph(3))
