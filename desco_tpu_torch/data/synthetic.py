"""Random connected graphs drawn like Syn_1827, with numpy only.

desco_tpu's Syn_1827 recipe (``desco_tpu/data/synthetic.py:199-249``)
walks a stratified grid of sample ids ``sid``: for ``sid < 1380`` it
draws ``sid // 23 + 10`` nodes and ``0.5 * (sid % 23) + 1`` (+/- a
triangular 0.5) edges per node, for the later ids 60-665 nodes with 1-3
edges per node; the edge count is ``n * edges_per_node * N(1, 0.1)``,
kept within [n - 1, n(n-1)/2]. This module draws ``sid`` uniformly among
the ids whose node count lies in 30-120 (``SIDS``: 920 grid ids of
30-69 nodes and 36 later ids of 55-120 nodes) and keeps those samplers
exactly, so sizes and densities follow Syn's. Syn then picks one of six
networkx generators; the port's GPU runs have no networkx, so every graph
here is G(n, m) with that edge count, components joined along a random
path, nodes randomly relabeled.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..graph.container import Graph

# Syn_1827 sample ids whose node count lies in [30, 120]
SIDS = (460, 1416)


def syn_1827_size(rng: np.random.Generator, sid: int) -> tuple:
    """(nodes, edges) of Syn_1827's sample ``sid``, drawn as
    desco_tpu/data/synthetic.py:202-249 draws them."""
    if sid < 60 * 23:
        n = sid // 23 + 10
        per_node = 0.5 * (sid % 23) + 1 + rng.triangular(-0.5, 0, 0.5)
    else:
        n = int(5 * ((sid - 1380) // 3) + 60 + rng.triangular(-5, 0, 5))
        degree = (sid - 1380) % 3 + 1
        per_node = degree + (rng.triangular(0, 0, 1) if degree == 1 else
                             rng.triangular(-1, 0, 1) if degree == 2 else
                             rng.triangular(-1, 0, 0))
    n = max(n, 2)
    m = int(rng.normal(1, 0.1) * int(n * per_node))
    return n, max(min(m, n * (n - 1) // 2), n - 1)


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
