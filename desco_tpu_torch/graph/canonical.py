"""Canonical partition: depth-d canonical neighborhood extraction.

DeSCo's decomposition step. For every node ``v`` of a target graph, the
canonical neighborhood is

    1. the depth-``d`` BFS ball around ``v`` (through *all* nodes),
    2. restricted to nodes with index ``<= v``,
    3. restricted further to the connected component containing ``v``.

``v`` is the *canonical node*; every subgraph occurrence in the target is
attributed to exactly one canonical node (the occurrence's max-index node),
so canonical counts sum exactly to graphlet counts.

Semantics match the reference's ``get_neigh_hetero`` / ``k_neigh``
(data.py:329-338, 375-396): the BFS ball
is computed over the *unrestricted* graph first and the ``<= v`` filter is
applied afterwards — this differs subtly from a BFS that only walks through
``<= v`` nodes (``k_neigh_canonical``, data.py:341-350), and the hetero
(main) pipeline uses the former.

Neighborhoods whose induced subgraph has no edges are dropped (all counts
are provably zero); the boolean ``indicator`` records which nodes survived,
mirroring ``nx_neighs_indicator`` (workload.py:215-294) — it later decides
where stage-1 counts land as gossip node features (workload.py:107-126).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .container import Graph


@dataclasses.dataclass
class Neighborhood:
    """One canonical neighborhood, relabeled to 0..k-1.

    ``canonical`` is the local index of the canonical node. ``nodes`` maps
    local index -> original node id in the parent graph.
    """

    graph: Graph
    canonical: int
    nodes: np.ndarray  # (k,) original node ids
    gid: int = -1  # parent graph index in the dataset
    vid: int = -1  # canonical node id in the parent graph


def bfs_ball(g: Graph, start: int, depth: int) -> np.ndarray:
    """Nodes within ``depth`` hops of ``start`` (unrestricted walk)."""
    indptr, indices = g.csr()
    seen = np.zeros(g.n_nodes, dtype=bool)
    seen[start] = True
    frontier = np.array([start], dtype=np.int32)
    for _ in range(depth):
        if frontier.size == 0:
            break
        nbrs = np.concatenate(
            [indices[indptr[u]:indptr[u + 1]] for u in frontier])
        nbrs = np.unique(nbrs[~seen[nbrs]])
        seen[nbrs] = True
        frontier = nbrs
    return np.nonzero(seen)[0].astype(np.int32)


def canonical_neighborhood(g: Graph, v: int, depth: int) -> Optional[Neighborhood]:
    """Extract the canonical neighborhood of ``v``; None if it has no edges."""
    ball = bfs_ball(g, v, depth)
    keep = ball[ball <= v]
    sub, nodes = g.induced_subgraph(keep)
    # component containing v (v's local index in `keep`)
    v_local = int(np.searchsorted(keep, v))  # keep is sorted ascending
    comp = sub.connected_component_of(v_local)
    if comp.size == keep.size:
        neigh, orig = sub, nodes
    else:
        neigh, local = sub.induced_subgraph(comp)
        orig = nodes[local]
    if neigh.n_edges == 0:
        return None
    canon_local = int(np.nonzero(orig == v)[0][0])
    return Neighborhood(graph=neigh, canonical=canon_local, nodes=orig, vid=v)


def extract_all_neighborhoods(
    graphs: List[Graph], depth: int
) -> tuple[List[Neighborhood], np.ndarray, np.ndarray]:
    """Canonical partition of a whole dataset.

    Returns ``(neighborhoods, index, indicator)`` where ``index`` is an
    ``(#neigh, 2)`` array of ``(gid, vid)`` and ``indicator`` a bool array
    over all nodes of all graphs (dataset node order: graph by graph,
    node id ascending) marking nodes whose neighborhood survived.
    """
    neighs: List[Neighborhood] = []
    index = []
    indicator = []
    for gid, g in enumerate(graphs):
        for v in range(g.n_nodes):
            nb = canonical_neighborhood(g, v, depth)
            if nb is None:
                indicator.append(False)
            else:
                nb.gid = gid
                indicator.append(True)
                index.append((gid, v))
                neighs.append(nb)
    index = np.array(index, dtype=np.int64).reshape(-1, 2)
    return neighs, index, np.array(indicator, dtype=bool)
