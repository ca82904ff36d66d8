"""The Syn_1827 recipe of DeSCo's synthetic training set, as the
benchmark's traffic generator (a frozen copy of the recipe in
``desco_tpu_torch/data/synthetic.py``, itself networkx's code paths
through ``nx_subset``).

Six graph families (Erdos-Renyi, Watts-Strogatz, uniform G(n, m),
Barabasi-Albert, extended Barabasi-Albert, powerlaw-cluster),
parameterized by a sampled (node count, edge count), forced connected by
joining components along a random tree, then randomly relabeled. The
stratified grid: sample ids ``sid < 1380`` have ``sid // 23 + 10`` nodes
and ``0.5 * (sid % 23) + 1`` (+/- a triangular 0.5) edges per node; the
later ids 60-800 nodes with 1-3 edges per node; the edge count is
``n * edges_per_node * N(1, 0.1)`` kept within [n - 1, n(n - 1) / 2].

Two departures from the recipe keep the work of a run the same from seed
to seed, so that a seed changes which graphs are drawn and not how much
work they are: the benchmark names the set of grid ids a mix uses (the
recipe walks all 1827), and each id's family is fixed by its place in
that set (every sixth id the same family), where the recipe draws it.
Each graph draws from its own generator, seeded by (seed, sid).
"""

from __future__ import annotations

from math import sqrt
from typing import List, Sequence, Tuple

import numpy as np

from . import nx_subset as nxs

_DELTA = 0.001
FAMILIES = ("ER", "WS", "Random", "BA", "EBA", "Power")
N_GRID = 1827


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
    """Extended Barabasi-Albert model (Albert & Barabasi 2000): a new node
    every iteration; with probability p, m edges are added besides, with
    probability q, m edges are rewired. A list of nodes repeated by degree
    does the preferential sampling."""
    edges: set = set()
    edge_list: list = []
    attach: list = []
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
            for _ in range(m):
                u = int(rng.integers(num_nodes))
                v = pref_target(u)
                if v >= 0:
                    add_edge(u, v)
        elif p <= r < p + q and edge_list:
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
                attach.remove(v)
                key = (u, w) if u < w else (w, u)
                edges.add(key)
                edge_list.append(key)
                attach.append(w)
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
    p = max((edge - m * node) / node, 0.0)
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


def grid_node_count(sid: int) -> Tuple[int, int]:
    """(least, most) nodes of grid id ``sid`` (the later ids jitter by up
    to 5 either way)."""
    if sid < 60 * 23:
        n = sid // 23 + 10
        return n, n
    n = 5 * ((sid - 1380) // 3) + 60
    return n - 5, n + 5


def grid_size(rng: np.random.Generator, sid: int) -> Tuple[int, int]:
    """(nodes, edges) of grid id ``sid``, drawn as the recipe draws them."""
    if sid < 60 * 23:
        node = sid // 23 + 10
        degree = 0.5 * (sid % 23) + 1 + rng.triangular(-0.5, 0, 0.5)
    else:
        node = int(5 * ((sid - 1380) // 3) + 60 + rng.triangular(-5, 0, 5))
        d = (sid - 1380) % 3 + 1
        if d == 1:
            degree = d + rng.triangular(0, 0, 1)
        elif d == 2:
            degree = d + rng.triangular(-1, 0, 1)
        else:
            degree = d + rng.triangular(-1, 0, 0)
    n = max(int(node), 2)
    avg_edges = int(n * degree)
    edge = int(rng.normal(1, 0.1) * avg_edges)
    edge = min(edge, n * (n - 1) // 2)
    return n, max(edge, n - 1)


def relabeled_edges(g: nxs.Graph, rng: np.random.Generator) -> np.ndarray:
    """The edges [m, 2] int32 under a random relabel (node order must not
    correlate with the generator's structure: the canonical partition
    depends on it)."""
    perm = rng.permutation(g.number_of_nodes())
    return np.array([(perm[u], perm[v]) for u, v in g.edges() if u != v],
                    dtype=np.int32).reshape(-1, 2)


def grid_ids(lo_nodes: int, hi_nodes: int, modulus: int = 1,
             residue: int = 0) -> List[int]:
    """The grid ids whose node count lies within [lo_nodes, hi_nodes],
    every ``modulus``-th from ``residue``."""
    out = []
    for sid in range(N_GRID):
        lo, hi = grid_node_count(sid)
        if lo >= lo_nodes and hi <= hi_nodes and sid % modulus == residue:
            out.append(sid)
    return out


def make_graphs(sids: Sequence[int],
                seed: int) -> List[Tuple[int, np.ndarray]]:
    """(n_nodes, edges [m, 2] int32) for each grid id of ``sids``: the
    i-th takes family ``FAMILIES[i % 6]`` and draws from a generator
    seeded by (seed, sid)."""
    out = []
    for i, sid in enumerate(sids):
        rng = np.random.default_rng([int(seed) & (2**63 - 1), int(sid)])
        n, m = grid_size(rng, sid)
        g = _GEN_FNS[FAMILIES[i % len(FAMILIES)]](n, m, rng)
        e = relabeled_edges(g, rng)
        e = np.unique(np.sort(e, axis=1), axis=0) if len(e) else e
        out.append((n, e.astype(np.int32)))
    return out
