"""Synthetic datasets: desco_tpu's ``Syn_<n>`` and ``syn_<n>`` recipes,
graph for graph, and the port's own numpy stand-in ``SynNp``.

``generate_synthetic`` / ``generate_combined_syn`` and the disk cache
(``load_or_generate_synthetic``, ``read_edge_list_dataset``) are copies of
``desco_tpu/data/synthetic.py:33-398``: six graph families (ER, WS,
uniform GNM, BA, extended BA, powerlaw-cluster) chosen uniformly,
parameterized by sampled (node count, edge count), forced connected by
joining components along a random tree, then randomly relabeled;
``Syn_1827`` walks the stratified size/degree grid. desco_tpu draws them
through networkx; here the same code paths run through ``nx_subset``
(networkx 3.6.1's generators copied as plain Python), so both packages
make the same graphs from the same seed, edge for edge, on a machine
without networkx.

``random_connected_graphs`` (``SynNp``) draws random connected graphs
like Syn_1827 with numpy only. desco_tpu's Syn_1827 recipe
(``desco_tpu/data/synthetic.py:199-249``) walks a stratified grid of
sample ids ``sid``: for ``sid < 1380`` it draws ``sid // 23 + 10`` nodes
and ``0.5 * (sid % 23) + 1`` (+/- a triangular 0.5) edges per node, for
the later ids 60-665 nodes with 1-3 edges per node; the edge count is
``n * edges_per_node * N(1, 0.1)``, kept within [n - 1, n(n-1)/2].
``random_connected_graph`` draws ``sid`` uniformly among the ids whose
node count lies in 30-120 (``SIDS``: 920 grid ids of 30-69 nodes and 36
later ids of 55-120 nodes) and keeps those samplers exactly; every graph
is G(n, m) with that edge count, components joined along a random path,
nodes randomly relabeled.
"""

from __future__ import annotations

import os
from math import sqrt
from typing import List

import numpy as np

from ..graph.container import Graph
from . import nx_subset as nxs

# Syn_1827 sample ids whose node count lies in [30, 120]
SIDS = (460, 1416)


def syn_1827_size(rng: np.random.Generator, sid: int) -> tuple:
    """(nodes, edges) of Syn_1827's sample ``sid``, drawn as
    ``generate_synthetic`` draws them."""
    return _draw_size(*_syn_1827_samplers(rng), rng, sid)


def random_connected_graph(rng: np.random.Generator) -> Graph:
    n, m = syn_1827_size(rng, int(rng.integers(*SIDS)))
    iu, ju = np.triu_indices(n, k=1)
    pick = rng.choice(len(iu), size=m, replace=False)
    edges = set(zip(iu[pick].tolist(), ju[pick].tolist()))
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for u, v in edges:
        parent[find(u)] = find(v)
    comps: dict = {}
    for v in range(n):
        comps.setdefault(find(v), []).append(v)
    roots = list(comps)
    order = rng.permutation(len(roots))
    for a, b in zip(order[:-1], order[1:]):
        u = int(rng.choice(comps[roots[a]]))
        v = int(rng.choice(comps[roots[b]]))
        edges.add((min(u, v), max(u, v)))
    perm = rng.permutation(n)
    e = np.sort(perm[np.array(sorted(edges), np.int64)], axis=1)
    return Graph(n, e.astype(np.int32))


def random_connected_graphs(n_graphs: int,
                            rng: np.random.Generator) -> List[Graph]:
    return [random_connected_graph(rng) for _ in range(n_graphs)]


# ------------------------------------------------------ desco_tpu's Syn
_DELTA = 0.001
GENERATORS = ("ER", "WS", "Random", "BA", "EBA", "Power")


def _connect_components(g: nxs.Graph, rng: np.random.Generator) -> nxs.Graph:
    comps = [list(c) for c in nxs.connected_components(g)]
    if len(comps) <= 1:
        return g
    # join components along a uniform random tree (random Pruefer sequence)
    k = len(comps)
    if k == 2:
        tree_edges = [(0, 1)]
    else:
        prufer = rng.integers(0, k, size=k - 2).tolist()
        tree_edges = nxs.from_prufer_sequence(prufer).edges()
    for a, b in tree_edges:
        u = comps[a][rng.integers(len(comps[a]))]
        v = comps[b][rng.integers(len(comps[b]))]
        g.add_edge(u, v)
    return g


def _seeded(rng: np.random.Generator) -> int:
    return int(rng.integers(0, 2**31 - 1))


def gen_er(node: int, edge: int, rng) -> nxs.Graph:
    p = 2 * edge / (node * (node - 1))
    g = nxs.erdos_renyi_graph(node, p, seed=_seeded(rng))
    return _connect_components(g, rng)


def gen_ws(node: int, edge: int, rng, p: float = 0.1) -> nxs.Graph:
    k = min(int(2 * edge / node), node - 1)
    try:
        return nxs.connected_watts_strogatz_graph(node, k, p,
                                                  seed=_seeded(rng))
    except nxs.NetworkXError:
        g = nxs.gnm_random_graph(node, edge, seed=_seeded(rng))
        return _connect_components(g, rng)


def gen_random(node: int, edge: int, rng) -> nxs.Graph:
    g = nxs.gnm_random_graph(node, edge, seed=_seeded(rng))
    return _connect_components(g, rng)


def gen_ba(node: int, edge: int, rng) -> nxs.Graph:
    m = min(max(int(edge / node), 1), node - 1)
    g = nxs.barabasi_albert_graph(node, m, seed=_seeded(rng))
    return _connect_components(g, rng)


def _extended_ba(n: int, m: int, p: float, q: float,
                 rng: np.random.Generator) -> nxs.Graph:
    """Extended Barabasi-Albert model (Albert & Barabasi 2000) as the
    reference's fork of networkx's generator runs it: a new node is added
    EVERY iteration; with prob p m edges are added besides, with prob q m
    edges are rewired. A repeated-node list does the preferential
    sampling."""
    edges: set = set()
    edge_list: list = []
    attach: list = []  # node repeated by degree (preferential sampling)
    num_nodes = m

    def pref_target(exclude_u: int) -> int:
        for _ in range(8):
            t = (attach[rng.integers(len(attach))] if attach
                 else int(rng.integers(num_nodes)))
            if t != exclude_u:
                return t
        return -1

    def add_edge(u: int, v: int) -> bool:
        if u == v:
            return False
        key = (u, v) if u < v else (v, u)
        if key in edges:
            return False
        edges.add(key)
        edge_list.append(key)
        attach.extend((u, v))
        return True

    while num_nodes < n:
        r = rng.random()
        if r < p and num_nodes >= 2:
            # add m edges between existing nodes
            for _ in range(m):
                u = int(rng.integers(num_nodes))
                v = pref_target(u)
                if v >= 0:
                    add_edge(u, v)
        elif p <= r < p + q and edge_list:
            # rewire m edges: detach one endpoint, reattach preferentially
            for _ in range(m):
                if not edge_list:
                    break
                ei = int(rng.integers(len(edge_list)))
                u, v = edge_list[ei]
                w = pref_target(u)
                if w < 0 or ((u, w) if u < w else (w, u)) in edges:
                    continue
                edge_list[ei] = edge_list[-1]
                edge_list.pop()
                edges.discard((u, v))
                attach.remove(v)  # one degree decrement for v
                key = (u, w) if u < w else (w, u)
                edges.add(key)
                edge_list.append(key)
                attach.append(w)
        # always add a new node with m preferential edges
        u = num_nodes
        num_nodes += 1
        made = 0
        for _ in range(4 * m):
            if made >= min(m, num_nodes - 1):
                break
            v = pref_target(u)
            if v >= 0 and add_edge(u, v):
                made += 1
        if made == 0 and num_nodes >= 2:
            add_edge(u, int(rng.integers(num_nodes - 1)))

    g = nxs.Graph()
    g.add_nodes_from(range(n))
    g.add_edges_from(edge_list)
    return g


def gen_eba(node: int, edge: int, rng, q: float = 0.1) -> nxs.Graph:
    m = min(max(int(edge / node), 1), node - 1)
    p = (edge - m * node) / node
    p = max(p, 0.0)
    if p + q >= 1:
        s = p + q
        p, q = p / s - _DELTA, q / s - _DELTA
    g = _extended_ba(node, m, p, q, rng)
    return _connect_components(g, rng)


def gen_power(node: int, edge: int, rng, p: float = 0.1) -> nxs.Graph:
    if node ** 2 - 4 * edge > 0:
        m = int((node - sqrt(node ** 2 - 4 * edge)) / 2)
        if m > 1:
            p = (edge - (node - m) * m) / ((m - 1) * (node - m))
        else:
            p = 0.0
        while p < 0:
            m -= 1
            p = edge / ((node - m) * m) - 1
    else:
        m = int(node / 2)
        p = 0.0
    p = min(p, 1)
    m = max(m, 1)
    g = nxs.powerlaw_cluster_graph(node, m, p, seed=_seeded(rng))
    return _connect_components(g, rng)


_GEN_FNS = {
    "ER": gen_er, "WS": gen_ws, "Random": gen_random,
    "BA": gen_ba, "EBA": gen_eba, "Power": gen_power,
}


def _syn_1827_samplers(rng: np.random.Generator):
    """The stratified Syn_1827 grid."""

    def node_num(sid: int) -> int:
        if sid < 60 * 23:
            return sid // 23 + 10
        node = 5 * ((sid - 1380) // 3) + 60
        return int(node + rng.triangular(-5, 0, 5))

    def avg_degree(sid: int) -> float:
        if sid < 60 * 23:
            return 0.5 * (sid % 23) + 1 + rng.triangular(-0.5, 0, 0.5)
        degree = (sid - 1380) % 3 + 1
        if degree == 1:
            return degree + rng.triangular(0, 0, 1)
        if degree == 2:
            return degree + rng.triangular(-1, 0, 1)
        return degree + rng.triangular(-1, 0, 0)

    return node_num, avg_degree


def _uniform_samplers(rng: np.random.Generator, min_size: int, max_size: int):
    def node_num(sid: int) -> int:
        return int(rng.integers(min_size, max_size))

    def avg_degree(sid: int) -> float:
        return float(rng.uniform(1, 4))

    return node_num, avg_degree


def _draw_size(node_num, avg_degree, rng: np.random.Generator,
               sid: int) -> tuple:
    """(nodes, edges) of sample ``sid``: the edge count is the sampled
    degree times N(1, 0.1), kept within [n - 1, n(n-1)/2]."""
    n = max(int(node_num(sid)), 2)
    avg_edges = int(n * avg_degree(sid))
    edge = int(rng.normal(1, 0.1) * avg_edges)
    edge = min(edge, n * (n - 1) // 2)
    return n, max(edge, n - 1)


def random_relabel(g: nxs.Graph, rng: np.random.Generator) -> Graph:
    """Random relabel (node order must not correlate with the generator's
    structure: the canonical partition depends on it), as a Graph."""
    perm = rng.permutation(g.number_of_nodes())
    edges = np.array(
        [(perm[u], perm[v]) for u, v in g.edges() if u != v],
        dtype=np.int32).reshape(-1, 2)
    return Graph(g.number_of_nodes(), edges)


def generate_synthetic(
    num_graphs: int, min_size: int = 10, max_size: int = 500,
    seed: int = 0,
) -> List[Graph]:
    """desco_tpu's synthetic dataset; ``num_graphs == 1827`` selects the
    standard stratified recipe."""
    rng = np.random.default_rng(seed)
    if num_graphs == 1827:
        samplers = _syn_1827_samplers(rng)
    else:
        samplers = _uniform_samplers(rng, min_size, max_size)
    graphs: List[Graph] = []
    for sid in range(num_graphs):
        n, edge = _draw_size(*samplers, rng, sid)
        name = GENERATORS[int(rng.integers(len(GENERATORS)))]
        graphs.append(random_relabel(_GEN_FNS[name](n, edge, rng), rng))
    return graphs


def generate_combined_syn(
    num_graphs: int, min_size: int = 5, max_size: int = 41, seed: int = 0,
) -> List[Graph]:
    """desco_tpu's legacy ``syn_N`` datasets, the deepsnap-EnsembleGenerator
    mix: sizes uniform over ``min_size + 1 .. max_size``; one of four
    generators chosen uniformly:

    - ER: p ~ Beta(1.3, b) with mean 0.8*log2(n)/n, redrawn until the
      graph is connected;
    - WS: k = max(2, int(Beta(1.3, b)*n)) with density mean log2(n)/n,
      rewire p ~ Beta(2, 2), the connected variant;
    - extended BA: m ~ 1 + choice(int(2*log2(n))), p, q = min(Exp(mean
      20), 0.2), the largest connected component;
    - powerlaw cluster: m as for BA, triangle p ~ U(0, 0.5), the largest
      connected component.

    Unlike ``Syn_N`` there is no forced connection: BA and powerlaw
    graphs shrink to their largest component."""
    rng = np.random.default_rng(seed)
    sizes = np.arange(min_size + 1, max_size + 1)

    def gen_er_beta(n: int) -> nxs.Graph:
        alpha = 1.3
        mean = 0.8 * np.log2(n) / n
        beta = alpha / mean - alpha
        while True:
            p = rng.beta(alpha, beta)
            g = nxs.gnp_random_graph(n, p, seed=_seeded(rng))
            if nxs.is_connected(g):
                return g

    def gen_ws_beta(n: int) -> nxs.Graph:
        d_alpha = 1.3
        d_mean = np.log2(n) / n
        d_beta = d_alpha / d_mean - d_alpha
        while True:
            k = max(int(rng.beta(d_alpha, d_beta) * n), 2)
            p = rng.beta(2, 2)
            try:
                return nxs.connected_watts_strogatz_graph(
                    n, k, p, seed=_seeded(rng))
            except nxs.NetworkXException:
                continue

    def largest_cc(g: nxs.Graph) -> nxs.Graph:
        c = max(nxs.connected_components(g), key=len)
        return nxs.convert_node_labels_to_integers(g.subgraph_copy(c))

    def gen_ba_ext(n: int) -> nxs.Graph:
        max_m = max(int(2 * np.log2(n)), 1)
        m = int(rng.integers(max_m)) + 1
        p = min(rng.exponential(20), 0.2)
        q = min(rng.exponential(20), 0.2)
        if p + q >= 1:  # defensive; cannot happen with 0.2 caps
            p = q = 0.2
        return largest_cc(_extended_ba(n, min(m, n - 1), p, q, rng))

    def gen_plc(n: int) -> nxs.Graph:
        max_m = max(int(2 * np.log2(n)), 1)
        m = int(rng.integers(max_m)) + 1
        p = rng.uniform(0.0, 0.5)
        return largest_cc(
            nxs.powerlaw_cluster_graph(n, min(m, n - 1), p,
                                       seed=_seeded(rng)))

    gens = (gen_er_beta, gen_ws_beta, gen_ba_ext, gen_plc)
    graphs: List[Graph] = []
    for _ in range(num_graphs):
        n = int(rng.choice(sizes))
        g = gens[int(rng.integers(len(gens)))](n)
        graphs.append(random_relabel(g, rng))
    return graphs


# --------------------------------------------------------- disk cache
def raw_paths(root: str) -> tuple:
    """(edge file, graph indicator file) of a cached dataset under
    ``root``, in the TU raw format desco_tpu writes."""
    raw = os.path.join(root, "raw")
    return (os.path.join(raw, "Syn_A.txt"),
            os.path.join(raw, "Syn_graph_indicator.txt"))


def write_edge_list_dataset(graphs: List[Graph], root: str) -> tuple:
    """Write ``graphs`` in the TU raw format (1-based global node ids, each
    edge in both directions); returns the two paths."""
    a_path, ind_path = raw_paths(root)
    os.makedirs(os.path.dirname(a_path), exist_ok=True)
    with open(a_path, "w") as fa, open(ind_path, "w") as fi:
        off = 1
        for gid, g in enumerate(graphs):
            for _ in range(g.n_nodes):
                fi.write(f"{gid + 1}\n")
            for u, v in g.edges:
                fa.write(f"{u + off}, {v + off}\n")
                fa.write(f"{v + off}, {u + off}\n")
            off += g.n_nodes
    return a_path, ind_path


def load_or_generate_synthetic(
    num_graphs: int, root: str, min_size: int = 10, max_size: int = 500,
    seed: int = 0, recipe: str = "Syn",
) -> List[Graph]:
    """Disk-cached synthetic dataset (edge-list + indicator text files
    under ``root/raw``, the same files desco_tpu writes and reads).
    ``recipe``: 'Syn' (stratified / uniform) or 'combined' (the legacy
    deepsnap-ensemble mix). The generating run returns the read-back, so
    every run sees the same canonical edge order."""
    a_path, ind_path = raw_paths(root)
    if os.path.exists(a_path) and os.path.exists(ind_path):
        return read_edge_list_dataset(a_path, ind_path)
    if recipe == "combined":
        graphs = generate_combined_syn(num_graphs, min_size, max_size, seed)
    else:
        graphs = generate_synthetic(num_graphs, min_size, max_size, seed)
    write_edge_list_dataset(graphs, root)
    return read_edge_list_dataset(a_path, ind_path)


def read_edge_list_dataset(a_path: str, ind_path: str) -> List[Graph]:
    """Parse TU-style DS_A.txt / DS_graph_indicator.txt into Graphs, each
    edge once as a sorted (u < v) pair, rows sorted, self-loops dropped."""
    indicator = np.loadtxt(ind_path, dtype=np.int64).reshape(-1)
    edges = np.loadtxt(a_path, delimiter=",", dtype=np.int64).reshape(-1, 2)
    n_graphs = int(indicator.max())
    # node id offsets per graph (TU format: global 1-based ids)
    counts = np.bincount(indicator, minlength=n_graphs + 1)[1:]
    offsets = np.concatenate([[0], np.cumsum(counts)])
    graphs: List[Graph] = []
    eg = indicator[edges[:, 0] - 1] - 1  # graph of each edge
    # group the edges by graph once (each graph's rows are deduplicated
    # and sorted below, so the grouping order does not matter)
    by_graph = np.argsort(eg, kind="stable")
    ends = np.searchsorted(eg[by_graph], np.arange(n_graphs + 1))
    for gid in range(n_graphs):
        e = edges[by_graph[ends[gid]:ends[gid + 1]]] - 1 - offsets[gid]
        # deduplicate (TU lists both directions)
        e = np.unique(np.sort(e, axis=1), axis=0) if len(e) else e.reshape(0, 2)
        e = e[e[:, 0] != e[:, 1]] if len(e) else e
        graphs.append(Graph(int(counts[gid]), e.astype(np.int32)))
    return graphs
