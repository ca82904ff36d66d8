"""Per-edge graphlet orbit counting — the orca replacement for order-4
SHMP edge typing (a copy of ``desco_tpu/graph/orbits.py``, numpy and
pure Python, so the port imports nothing of desco_tpu).

The reference's order-4 path is dead code behind a missing native dep:
``ToQconvHetero`` raises NotImplementedError without the orca C++
submodule (transforms.py:14, 118-165; .gitmodules:1-3), and
``to_hetero(order=4)`` expects edge types ``union_1..union_11``
(lightning_model.py:441-458). This module supplies the missing
primitive exactly:

  * ``edge_orbit_counts(g)`` — for every undirected edge, the number of
    induced occurrences of each of the 13 edge orbits of connected
    graphlets on <= 4 nodes (classes derived from automorphism orbits,
    see _ORBITS below). Enumeration is exact: every connected induced
    3-/4-node subgraph is visited once (ESU order discipline) and each
    of its edges classified by its endpoint-degree pair inside the
    subgraph, which separates all orbit classes.
  * ``order4_edge_types(g)`` — one SHMP type id per edge: the
    highest-priority orbit present (same "any triangle marks the edge"
    convention as order-3 tconv, graph/triangles.py), folded to the 11
    classes the reference names union_1..union_11 (the two paw triangle
    classes merge; upstream never defined the mapping, so the fold is
    documented here rather than guessed from a dead submodule).

Orbit table (index: graphlet, edge class by sorted in-subgraph degrees):
   0: K2 edge                    7: paw pendant (3,1)
   1: P3 edge (1,2)              8: paw hub-triangle (3,2)
   2: K3 edge (2,2)              9: paw far-triangle (2,2)
   3: P4 end (1,2)              10: diamond rim (3,2)
   4: P4 mid (2,2)              11: diamond chord (3,3)
   5: claw (1,3)                12: K4 (3,3)
   6: C4 (2,2)
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .container import Graph

N_EDGE_ORBITS = 13
# 4-node graphlet id by sorted degree sequence
_G4 = {
    (1, 1, 2, 2): "P4",
    (1, 1, 1, 3): "claw",
    (2, 2, 2, 2): "C4",
    (1, 2, 2, 3): "paw",
    (2, 2, 3, 3): "diamond",
    (3, 3, 3, 3): "K4",
}
# (graphlet, sorted endpoint-degree pair) -> orbit id
_ORBIT4 = {
    ("P4", (1, 2)): 3, ("P4", (2, 2)): 4,
    ("claw", (1, 3)): 5,
    ("C4", (2, 2)): 6,
    ("paw", (1, 3)): 7, ("paw", (2, 3)): 8, ("paw", (2, 2)): 9,
    ("diamond", (2, 3)): 10, ("diamond", (3, 3)): 11,
    ("K4", (3, 3)): 12,
}


def _adj_sets(g: Graph) -> List[set]:
    adj: List[set] = [set() for _ in range(g.n_nodes)]
    for a, b in g.edges:
        a, b = int(a), int(b)
        if a != b:
            adj[a].add(b)
            adj[b].add(a)
    return adj


def edge_orbit_counts(g: Graph) -> np.ndarray:
    """[n_undirected_edges, 13] induced edge-orbit counts (table above).

    Exact: connected induced 3-sets come from (edge, common-or-one-side
    neighbor) enumeration; connected induced 4-sets from an ESU-style
    min-root expansion so each set is counted exactly once."""
    adj = _adj_sets(g)
    m = len(g.edges)
    eid: Dict[Tuple[int, int], int] = {}
    for i, (a, b) in enumerate(g.edges):
        a, b = int(a), int(b)
        eid[(min(a, b), max(a, b))] = i
    out = np.zeros((m, N_EDGE_ORBITS), np.int64)
    out[:, 0] = 1  # every edge is a K2

    def bump(sub: List[int]):
        deg = {v: sum(1 for w in sub if w in adj[v]) for v in sub}
        k = len(sub)
        if k == 3:
            tri = min(deg.values()) == 2
            for i in range(3):
                for j in range(i + 1, 3):
                    a, b = sub[i], sub[j]
                    if b in adj[a]:
                        out[eid[(min(a, b), max(a, b))],
                            2 if tri else 1] += 1
            return
        name = _G4.get(tuple(sorted(deg.values())))
        assert name is not None, sorted(deg.values())
        for i in range(4):
            for j in range(i + 1, 4):
                a, b = sub[i], sub[j]
                if b in adj[a]:
                    orb = _ORBIT4[(name, tuple(sorted((deg[a], deg[b]))))]
                    out[eid[(min(a, b), max(a, b))], orb] += 1

    n = g.n_nodes
    for root in range(n):
        # connected induced subgraphs of size 3/4 whose min node == root,
        # grown ESU-style (Wernicke): a node may only enter through its
        # FIRST appearance as a candidate — ``seen`` carries every
        # candidate ever generated on this path (including consumed
        # ones), which is exactly the exclusive-neighborhood rule that
        # makes each subgraph come out once
        def extend(sub: List[int], ext: List[int], seen: frozenset):
            if len(sub) >= 3:
                bump(sub)
            if len(sub) == 4:
                return
            for idx, v in enumerate(ext):
                new_c = [w for w in adj[v]
                         if w > root and w not in seen]
                extend(sub + [v], ext[idx + 1:] + sorted(new_c),
                       seen | frozenset(new_c))

        first = sorted(w for w in adj[root] if w > root)
        extend([root], first, frozenset(first))
    return out


# priority: most structure wins (mirrors order-3 tconv's "any triangle
# marks the edge"); K2 (orbit 0) is never a type of its own — every edge
# has it, so the minimum type is P3-only (an isolated-edge graph has no
# 3-node context and falls back to type 0 too)
_PRIORITY = (12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1)
# fold 13 orbits -> the reference's 11 union types: the two paw triangle
# classes (8, 9) merge; ids are dense in [0, 11)
_FOLD = {1: 0, 2: 1, 3: 2, 4: 3, 5: 4, 6: 5, 7: 6, 8: 7, 9: 7,
         10: 8, 11: 9, 12: 10}
N_ORDER4_TYPES = 11


def order4_edge_types(g: Graph) -> np.ndarray:
    """[n_undirected_edges] SHMP order-4 edge type in [0, 11): the
    highest-priority orbit present on the edge, folded per _FOLD
    (union_1..union_11 analog, lightning_model.py:441-458)."""
    counts = edge_orbit_counts(g)
    types = np.zeros(len(g.edges), np.int32)
    for e in range(len(g.edges)):
        for orb in _PRIORITY:
            if counts[e, orb]:
                types[e] = _FOLD[orb]
                break
    return types
