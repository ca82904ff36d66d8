"""Query graph machinery: atlas ids and query generation, without networkx.

The standard DeSCo workload is the 29 connected queries of size 3-5 from
the networkx graph atlas (atlas ids 6..52). desco_tpu builds them with
``nx.graph_atlas`` (desco_tpu/graph/atlas.py); the port carries them as
data instead (``ATLAS``, generated once from desco_tpu's ``gen_queries``
and checked against it by tests/test_torch_host.py), so it runs where
networkx is not installed. Each entry is ``id: (n_nodes, edges)`` with
the edges in the order desco_tpu's ``Graph.from_networkx`` emits them.

Ids 8000-14004 are the hand-crafted 8-14-node benchmark patterns of
``atlas_plus_data.EDGELIST_PLUS``; ``graph_atlas_plus`` replays
networkx's edge iteration order for them, so both packages build the
same ``Graph``. Other atlas ids (query sizes above 5) are not carried.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .container import Graph

# connected atlas graphs of sizes 3, 4 and 5, in atlas-id order
ATLAS: Dict[int, Tuple[int, List[Tuple[int, int]]]] = {
    6: (3, [(0, 1), (0, 2)]),
    7: (3, [(0, 1), (0, 2), (1, 2)]),
    13: (4, [(0, 3), (1, 3), (2, 3)]),
    14: (4, [(0, 1), (0, 3), (1, 2)]),
    15: (4, [(0, 3), (1, 2), (1, 3), (2, 3)]),
    16: (4, [(0, 1), (0, 3), (1, 2), (2, 3)]),
    17: (4, [(0, 1), (0, 2), (0, 3), (1, 2), (2, 3)]),
    18: (4, [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]),
    29: (5, [(0, 4), (1, 4), (2, 4), (3, 4)]),
    30: (5, [(0, 4), (1, 3), (2, 3), (3, 4)]),
    31: (5, [(0, 1), (0, 4), (1, 2), (2, 3)]),
    34: (5, [(0, 4), (1, 4), (2, 3), (2, 4), (3, 4)]),
    35: (5, [(0, 1), (0, 2), (0, 4), (1, 2), (2, 3)]),
    36: (5, [(0, 4), (1, 2), (1, 3), (2, 3), (3, 4)]),
    37: (5, [(0, 1), (1, 3), (1, 4), (2, 3), (2, 4)]),
    38: (5, [(0, 1), (0, 4), (1, 2), (2, 3), (3, 4)]),
    40: (5, [(0, 1), (1, 2), (1, 3), (1, 4), (2, 3), (2, 4)]),
    41: (5, [(0, 1), (1, 3), (1, 4), (2, 3), (2, 4), (3, 4)]),
    42: (5, [(0, 1), (0, 4), (1, 4), (2, 3), (2, 4), (3, 4)]),
    43: (5, [(0, 1), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4)]),
    44: (5, [(0, 2), (0, 3), (0, 4), (1, 2), (1, 3), (1, 4)]),
    45: (5, [(0, 4), (1, 2), (1, 3), (1, 4), (2, 3), (2, 4), (3, 4)]),
    46: (5, [(0, 3), (0, 4), (1, 3), (1, 4), (2, 3), (2, 4), (3, 4)]),
    47: (5, [(0, 1), (0, 4), (1, 2), (1, 3), (1, 4), (2, 3), (3, 4)]),
    48: (5, [(0, 2), (0, 3), (0, 4), (1, 2), (1, 3), (1, 4), (2, 4)]),
    49: (5, [(0, 1), (0, 3), (0, 4), (1, 3), (1, 4), (2, 3), (2, 4), (3, 4)]),
    50: (5, [(0, 1), (0, 3), (0, 4), (1, 2), (1, 4), (2, 3), (2, 4), (3, 4)]),
    51: (5, [(0, 1), (0, 3), (0, 4), (1, 2), (1, 3), (1, 4), (2, 3), (2, 4), (3, 4)]),
    52: (5, [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (1, 3), (1, 4), (2, 3), (2, 4), (3, 4)]),
}

_SIZES = (3, 4, 5)


def gen_query_ids(query_sizes: Sequence[int]) -> List[int]:
    """Atlas ids of all *connected* graphs whose size is in ``query_sizes``
    (sizes 3/4/5 give the 29 standard queries), ascending by size then
    id, as desco_tpu orders them. Sizes below 3 contribute nothing there
    either (its atlas scan starts at id 6); sizes above 5 are not in the
    table."""
    big = [s for s in query_sizes if s > max(_SIZES)]
    if big:
        raise NotImplementedError(
            f"query sizes {big}: the port carries the connected atlas "
            f"graphs of sizes 3-5 only (ids 6..52); use custom_query_ids "
            f"with ids 8000-14004 for larger patterns")
    return [i for i, (n, _) in ATLAS.items() if n in query_sizes]


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
    """The query graph of an atlas id (3-5 nodes) or an extended id
    (8000-14004), nodes 0..k-1."""
    if query_id in ATLAS:
        n, edges = ATLAS[query_id]
        return Graph(n, np.asarray(edges, np.int32))
    if query_id >= 1253:
        from .atlas_plus_data import EDGELIST_PLUS

        if query_id in EDGELIST_PLUS:
            n = query_id // 1000
            return Graph(n, np.asarray(
                _networkx_edge_order(EDGELIST_PLUS[query_id], n),
                np.int32).reshape(-1, 2))
        raise KeyError(f"unknown extended atlas id {query_id}")
    raise NotImplementedError(
        f"atlas id {query_id}: the port carries ids 6..52 (the connected "
        f"graphs of sizes 3-5) and the extended ids 8000-14004")


def gen_queries(query_ids: Sequence[int]) -> List[Graph]:
    """Queries as host Graphs, nodes 0..k-1."""
    return [graph_atlas_plus(int(i)) for i in query_ids]
