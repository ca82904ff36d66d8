"""Query-mining utilities: WL hashing, random-ESU and mfinder-style
frequent-subgraph sampling, random BFS neighborhood sampling.

A copy of ``desco_tpu/utils/mining.py`` (numpy and ``random`` only; the
port imports nothing of desco_tpu), on the port's ``Graph``. It mines
baseline query sets from target datasets: rand-ESU enumerates connected
<=k-subgraphs with per-depth sampling probabilities, mfinder samples
random connected induced neighborhoods; isomorphism classes are grouped
by a Weisfeiler-Lehman hash and the most frequent ones are picked. Same
seed, same graphs: the same queries as desco_tpu.
"""

from __future__ import annotations

import random
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..graph.container import Graph


def wl_hash(g: Graph, iters: Optional[int] = None,
            anchor: Optional[int] = None, dim: int = 8) -> Tuple[int, ...]:
    """Weisfeiler-Lehman graph invariant: iterated neighborhood label
    hashing, summed to an order-invariant signature. Equal graphs hash
    equal; collisions possible (like the reference's wl_hash,
    utils.py:62-79)."""
    n = g.n_nodes
    iters = n if iters is None else iters
    labels = np.zeros(n, dtype=np.uint64)
    if anchor is not None:
        labels[anchor] = 1
    indptr, indices = g.csr()
    for _ in range(iters):
        new = np.zeros_like(labels)
        for v in range(n):
            nbrs = indices[indptr[v]:indptr[v + 1]]
            s = int(labels[v]) + int(labels[nbrs].sum())
            new[v] = hash((s, len(nbrs))) & 0xFFFFFFFFFFFF
        labels = new
    return tuple(sorted(int(x) for x in labels))


def sample_neigh(graphs: List[Graph], size: int,
                 rng: random.Random) -> Tuple[int, List[int]]:
    """Sample a connected node set of exactly ``size`` nodes by random
    BFS growth, from a graph chosen proportionally to node count
    (utils.py:24-45). Returns (graph_index, node_list)."""
    ps = np.array([g.n_nodes for g in graphs], dtype=np.float64)
    ps /= ps.sum()
    while True:
        gi = int(np.searchsorted(np.cumsum(ps), rng.random()))
        gi = min(gi, len(graphs) - 1)
        g = graphs[gi]
        start = rng.randrange(g.n_nodes)
        neigh = [start]
        visited = {start}
        frontier = [v for v in g.neighbors(start) if v not in visited]
        while len(neigh) < size and frontier:
            w = frontier[rng.randrange(len(frontier))]
            neigh.append(w)
            visited.add(w)
            frontier += [int(x) for x in g.neighbors(w)]
            frontier = [x for x in frontier if x not in visited]
        if len(neigh) == size:
            return gi, neigh


def enumerate_subgraphs_esu(
    g: Graph, k: int, rng: random.Random,
    anchored: bool = False,
) -> Dict[Tuple[int, Tuple], List[Tuple[int, ...]]]:
    """Randomized ESU: enumerate connected subgraphs of size <= k with
    depth-dependent sampling probabilities ps[d] = (1 - d/(k+1))^1.5
    (utils.py:113-160). Returns {(size, wl_hash): [node_tuples]}."""
    ps = np.arange(1.0, 0.0, -1.0 / (k + 1)) ** 1.5
    out: Dict[Tuple[int, Tuple], List[Tuple[int, ...]]] = defaultdict(list)

    def record(sg: List[int], anchor_node: int):
        sub, nodes = g.induced_subgraph(np.array(sorted(sg), np.int32))
        a = int(np.nonzero(nodes == anchor_node)[0][0]) if anchored else None
        key = (len(sg), wl_hash(sub, anchor=a))
        out[key].append(tuple(sorted(sg)))

    def sample_frac(items: List[int], p: float) -> List[int]:
        frac = len(items) * p
        n = int(frac) + (1 if rng.random() < frac - int(frac) else 0)
        return rng.sample(items, n)

    def extend(sg: set, v_ext: set, root: int):
        record(list(sg), root)
        if len(sg) == k:
            return
        old_ext = set(v_ext)
        v_ext = set(v_ext)
        while v_ext:
            w = v_ext.pop()
            new_ext = set(v_ext)
            nbrs = [int(x) for x in g.neighbors(w)
                    if x > root and x not in sg and x not in old_ext]
            for x in sample_frac(nbrs, ps[len(sg) + 1]):
                new_ext.add(x)
            sg.add(w)
            extend(sg, new_ext, root)
            sg.remove(w)

    for v in range(g.n_nodes):
        nbrs = [int(x) for x in g.neighbors(v) if x > v]
        ext = set(sample_frac(nbrs, ps[1]))
        extend({v}, ext, v)
    return out


def mine_queries_esu(
    targets: List[Graph], sizes: Dict[int, int], seed: int = 0,
    anchored: bool = False,
) -> List[Graph]:
    """Most-frequent subgraph classes per size via randomized ESU
    (gen_baseline_queries_rand_esu, utils.py:82-110)."""
    rng = random.Random(seed)
    k = max(sizes)
    merged: Dict[Tuple[int, Tuple], List[Tuple[int, Graph]]] = defaultdict(list)
    for ti, t in enumerate(targets):
        for key, node_sets in enumerate_subgraphs_esu(
                t, k, rng, anchored).items():
            merged[key].extend((ti, ns) for ns in node_sets)
    out: List[Graph] = []
    for size, count in sizes.items():
        classes = [(key, v) for key, v in merged.items() if key[0] == size]
        classes.sort(key=lambda kv: len(kv[1]), reverse=True)
        for key, occurrences in classes[:count]:
            ti, ns = occurrences[rng.randrange(len(occurrences))]
            sub, _ = targets[ti].induced_subgraph(np.array(ns, np.int32))
            out.append(sub)
    return out


def mine_queries_mfinder(
    targets: List[Graph], sizes: Dict[int, int], n_samples: int = 10000,
    seed: int = 0,
) -> List[Graph]:
    """Most-frequent classes among randomly sampled connected induced
    subgraphs (gen_baseline_queries_mfinder, utils.py:163-197)."""
    rng = random.Random(seed)
    out: List[Graph] = []
    for size, count in sizes.items():
        classes: Dict[Tuple, List[Graph]] = defaultdict(list)
        for _ in range(n_samples):
            gi, neigh = sample_neigh(targets, size, rng)
            sub, _ = targets[gi].induced_subgraph(
                np.array(sorted(neigh), np.int32))
            classes[wl_hash(sub)].append(sub)
        ranked = sorted(classes.items(), key=lambda kv: len(kv[1]),
                        reverse=True)
        for _, graphs in ranked[:count]:
            out.append(graphs[rng.randrange(len(graphs))])
    return out
