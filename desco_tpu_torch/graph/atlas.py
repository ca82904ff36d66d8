"""Query graph machinery: atlas ids and query generation, without networkx.

The standard DeSCo workload is the 29 connected queries of size 3-5 from
the networkx graph atlas (atlas ids 6..52). desco_tpu resolves atlas ids
with ``nx.graph_atlas`` (desco_tpu/graph/atlas.py); the port carries the
whole atlas, ids 0-1252, as data (``atlas_data.ATLAS``), so it runs
where networkx is not installed. Each entry is ``id: (n_nodes, edges)``
with the edges in the order desco_tpu's ``Graph.from_networkx`` emits
them.

Ids 8000-14004 are the hand-crafted 8-14-node benchmark patterns of
``atlas_plus_data.EDGELIST_PLUS``; ``graph_atlas_plus`` replays
networkx's edge iteration order for them, so both packages build the
same ``Graph``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .atlas_data import ATLAS
from .container import Graph

# desco_tpu's scan end: ids below it are every graph of up to 6 nodes
_ATLAS_SCAN_END = 209


def _is_connected(n_nodes: int, edges) -> bool:
    """Union-find over the edge list."""
    parent = list(range(n_nodes))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a
    for u, v in edges:
        parent[find(u)] = find(v)
    return len({find(v) for v in range(n_nodes)}) == 1


def gen_query_ids(query_sizes: Sequence[int]) -> List[int]:
    """Atlas ids of all *connected* graphs whose size is in ``query_sizes``
    (sizes 3/4/5 give the 29 standard queries), ascending by size then
    id. desco_tpu's scan: ids 6..208, stopping at the first graph larger
    than the largest size asked for, so sizes below 3 give nothing and
    size 7, which starts at id 209, gives nothing either."""
    by_size: Dict[int, List[int]] = {}
    for i in range(6, _ATLAS_SCAN_END):
        n, edges = ATLAS[i]
        if _is_connected(n, edges):
            by_size.setdefault(n, []).append(i)
        if n > max(query_sizes):
            break
    return [i for size, ids in by_size.items() if size in query_sizes
            for i in ids]


def _networkx_edge_order(edges, n_nodes: int) -> List[Tuple[int, int]]:
    """The (min, max) edge list desco_tpu's ``Graph.from_networkx`` emits
    for ``nx.Graph(); add_edges_from(edges); add_nodes_from(range(n))``:
    nodes in insertion order, each node's neighbors in insertion order,
    every edge yielded once from the node that comes first."""
    adj: Dict[int, Dict[int, None]] = {}
    for u, v in edges:
        adj.setdefault(u, {})[v] = None
        adj.setdefault(v, {})[u] = None
    for v in range(n_nodes):
        adj.setdefault(v, {})
    out, seen = [], set()
    for u, nbrs in adj.items():
        for v in nbrs:
            if v not in seen and u != v:
                out.append((min(u, v), max(u, v)))
        seen.add(u)
    return out


def graph_atlas_plus(query_id: int) -> Graph:
    """The query graph of an atlas id (0-1252, connected or not) or an
    extended id (8000-14004), nodes 0..k-1."""
    if 0 <= query_id < 1253:
        n, edges = ATLAS[query_id]
        return Graph(n, np.asarray(edges, np.int32).reshape(-1, 2))
    from .atlas_plus_data import EDGELIST_PLUS

    if query_id in EDGELIST_PLUS:
        n = query_id // 1000
        return Graph(n, np.asarray(
            _networkx_edge_order(EDGELIST_PLUS[query_id], n),
            np.int32).reshape(-1, 2))
    raise KeyError(f"unknown extended atlas id {query_id}")


def gen_queries(query_ids: Sequence[int]) -> List[Graph]:
    """Queries as host Graphs, nodes 0..k-1."""
    return [graph_atlas_plus(int(i)) for i in query_ids]


def expand_query_labels(q: Graph, n_labels: int) -> List[Graph]:
    """All ``n_labels ** k`` node-labeled variants of a query, as Graphs
    with one-hot ``node_feat``, in desco_tpu's order (the last node's
    label varies fastest). Exponential; only sensible for small label
    sets."""
    import itertools

    eye = np.eye(n_labels, dtype=np.float32)
    return [Graph(q.n_nodes, q.edges.copy(), eye[list(assign)])
            for assign in itertools.product(range(n_labels),
                                            repeat=q.n_nodes)]
