"""Exact ground truth: induced subgraph-isomorphism enumeration.

DeSCo trains against exact canonical counts: for each (target, query), the
number of *node-induced* subgraph isomorphisms, each occurrence attributed
to its max-index target node (the canonical node), divided by the query's
automorphism count. Semantics mirror the reference's
``MatchSubgraphWorker`` + ``SymmetricFactor``
(workload.py:327-348,
data.py:61-88) which use networkx's VF2 ``GraphMatcher`` — rebuilt here as
a bitset backtracking enumerator (queries are <= a few dozen nodes;
adjacency rows fit in Python ints). A C++ implementation with the same
interface lives in ``desco_tpu_torch.truth.native`` for the hot path.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..graph.container import Graph


def _bit_adj(g: Graph) -> List[int]:
    adj = [0] * g.n_nodes
    for u, v in g.edges:
        adj[u] |= 1 << int(v)
        adj[v] |= 1 << int(u)
    return adj


def _match_order(q: Graph) -> List[int]:
    """Query node order: start at max degree, then always extend with a
    node adjacent to the already-ordered prefix (query is connected)."""
    deg = q.degrees()
    order = [int(np.argmax(deg))]
    seen = {order[0]}
    adj = _bit_adj(q)
    while len(order) < q.n_nodes:
        best, best_score = -1, (-1, -1)
        for v in range(q.n_nodes):
            if v in seen:
                continue
            conn = sum(1 for u in order if (adj[v] >> u) & 1)
            score = (conn, int(deg[v]))
            if conn > 0 and score > best_score:
                best, best_score = v, score
        assert best >= 0, "query must be connected"
        order.append(best)
        seen.add(best)
    return order


def count_induced_embeddings(
    target: Graph, query: Graph, per_max_node: Optional[np.ndarray] = None,
    target_labels: Optional[np.ndarray] = None,
    query_labels: Optional[np.ndarray] = None,
) -> int:
    """Count node-induced embeddings of ``query`` in ``target``.

    If ``per_max_node`` (int64, len n_target) is given, each embedding also
    increments the slot of its maximum target node — the canonical
    attribution rule (workload.py:345-347). Optional integer node labels
    must match under the mapping (the use_node_feature mode,
    workload.py:336-341). Returns the total count (NOT divided by the
    automorphism factor).
    """
    if (target_labels is None) != (query_labels is None):
        # one-sided labels would either crash deep in the recursion
        # (query side only) or silently return the inflated unlabeled
        # count (target side only)
        raise ValueError(
            "target_labels and query_labels must be given together")
    nq, nt = query.n_nodes, target.n_nodes
    if nq > nt:
        return 0
    qadj = _bit_adj(query)
    tadj = _bit_adj(target)
    tdeg = target.degrees()
    qdeg = query.degrees()
    order = _match_order(query)
    # for each position i>0: an already-placed neighbor position, plus the
    # full adjacency pattern of order[i] w.r.t. earlier order positions
    parent = [0] * nq
    for i in range(1, nq):
        for j in range(i):
            if (qadj[order[i]] >> order[j]) & 1:
                parent[i] = j
                break
    # prefix adjacency masks: needed_adj[i] = bitmask over positions j<i
    # that must be adjacent; others must be non-adjacent
    need = [0] * nq
    for i in range(nq):
        m = 0
        for j in range(i):
            if (qadj[order[i]] >> order[j]) & 1:
                m |= 1 << j
        need[i] = m

    mapped = [0] * nq  # target node at each order position
    total = 0

    def extend(i: int, used_mask: int) -> int:
        nonlocal total
        if i == nq:
            total += 1
            if per_max_node is not None:
                per_max_node[max(mapped)] += 1
            return 0
        qn = order[i]
        if i == 0:
            cands = range(nt)
        else:
            cands = _bits(tadj[mapped[parent[i]]])
        needed = need[i]
        for t in cands:
            if (used_mask >> t) & 1:
                continue
            if tdeg[t] < qdeg[qn]:
                continue
            if query_labels is not None and \
                    query_labels[qn] != target_labels[t]:
                continue
            ok = True
            ta = tadj[t]
            for j in range(i):
                adj_t = (ta >> mapped[j]) & 1
                adj_q = (needed >> j) & 1
                if adj_t != adj_q:
                    ok = False
                    break
            if ok:
                mapped[i] = t
                extend(i + 1, used_mask | (1 << t))
        return 0

    extend(0, 0)
    return total


def _bits(x: int):
    while x:
        lsb = x & -x
        yield lsb.bit_length() - 1
        x ^= lsb


def symmetric_factor(query: Graph,
                     labels: Optional[np.ndarray] = None) -> int:
    """|Aut(query)| (label-preserving when labels given): induced
    embeddings of the query into itself (data.py:61-66)."""
    return count_induced_embeddings(query, query, None, labels, labels)


def canonical_counts(
    target: Graph, queries: List[Graph]
) -> np.ndarray:
    """(n_target, n_queries) float64 canonical counts: per node v, the
    number of induced occurrences of query q whose max node is v, divided
    by |Aut(q)| (workload.py:693-696). Values are integral."""
    out = np.zeros((target.n_nodes, len(queries)), dtype=np.float64)
    for qi, q in enumerate(queries):
        per = np.zeros(target.n_nodes, dtype=np.int64)
        count_induced_embeddings(target, q, per)
        out[:, qi] = per / symmetric_factor(q)
    return out

