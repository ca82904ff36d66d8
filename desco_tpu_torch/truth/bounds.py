"""Serving-side combinatorial upper bounds for neighborhood counts — the
port of ``desco_tpu/truth/bounds.py``.

Stage-1 predictions de-log as ``2^pred - 1``; rare out-of-distribution
neighborhoods can de-log astronomically. Every canonical count obeys the
combinatorics of its own neighborhood, so predictions are clamped at
serving time:

  count(Q in N anchored at v) = #induced-embeddings / |Aut(Q)|
    <= #homs(T -> N, some tree node at v) / |Aut(Q)|   (T spanning tree)
  and
    <= C(n-1, k-1) * k! / |Aut(Q)|                     (subset bound)

The tree DP's only primitive is an adjacency SpMV over the packed edge
stream (``index_add_``), run in f32 on the batch's device. Queries whose
BFS spanning trees coincide share one DP. A batch's bounds are one
compiled forward per batch shape (desco_tpu's
``@partial(jax.jit, static_argnums=(1, 2))``): a request's batches move to
the device once and each replays it (utils/cuda_graphs.ForwardCache, keyed by
the schedules and the canonical type).

The bounds are sums of integer-valued f32 values whose order
``index_add_`` does not fix on the card (atomic adds): where every partial
sum is an integer below 2^24 each order gives the same bits; above it
they may differ in the last places.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..batch.packed import PackedGraphs, stack_batches
from ..graph.container import Graph
from ..ops.segment import segment_sum
from ..utils import trace
from ..utils.cuda_graphs import ForwardCache
from .vf2 import symmetric_factor


def _spanning_tree(q: Graph) -> List[Tuple[int, int]]:
    """BFS spanning tree from node 0: list of (child, parent) edges."""
    indptr, indices = q.csr()
    seen = {0}
    order = [0]
    edges: List[Tuple[int, int]] = []
    head = 0
    while head < len(order):
        u = order[head]
        head += 1
        for w in indices[indptr[u]:indptr[u + 1]]:
            w = int(w)
            if w not in seen:
                seen.add(w)
                order.append(w)
                edges.append((w, u))
    if len(seen) != q.n_nodes:
        raise ValueError("query must be connected")
    return edges


def tree_schedules(q: Graph) -> List[List[Tuple[int, int]]]:
    """Per rooting r of the spanning tree: bottom-up (child, parent)
    edge schedule (children always processed before their parent)."""
    tree = _spanning_tree(q)
    adj: List[List[int]] = [[] for _ in range(q.n_nodes)]
    for a, b in tree:
        adj[a].append(b)
        adj[b].append(a)
    scheds = []
    for r in range(q.n_nodes):
        # BFS orientation away from r, then reverse for bottom-up order
        parent = {r: -1}
        order = [r]
        head = 0
        while head < len(order):
            u = order[head]
            head += 1
            for w in adj[u]:
                if w not in parent:
                    parent[w] = u
                    order.append(w)
        scheds.append([(u, parent[u]) for u in reversed(order[1:])])
    return scheds


def _hashable_schedules(queries: Sequence[Graph]):
    """Per query (k, rooting schedules), hashable."""
    return tuple(
        (q.n_nodes, tuple(tuple(tuple(e) for e in s)
                          for s in tree_schedules(q)))
        for q in queries
    )


def _batch_bounds(batch: PackedGraphs, schedules,
                  canonical_type: int) -> torch.Tensor:
    """[G, Q] f32 per-graph upper bound at the canonical node (before
    the |Aut| division)."""
    g_cap = batch.g_cap
    src = batch.edge_src.long()
    dst = batch.edge_dst.long()  # pad edges hit the (zero) pad node
    is_canon = ((batch.node_type == canonical_type)
                & (batch.node_mask > 0)).float()
    # graph sizes for the subset bound
    n_g = segment_sum(batch.node_mask, batch.node_graph, g_cap)

    def spmv(h):
        return torch.zeros_like(h).index_add_(0, dst, h[src])

    ones = batch.node_mask.float()
    tree_memo: Dict[tuple, torch.Tensor] = {}
    cols = []
    for k, scheds in schedules:
        tree_b = tree_memo.get(scheds)
        if tree_b is None:
            tot = torch.zeros_like(ones)
            for sched in scheds:
                h = [ones] * k
                for child, parent in sched:
                    h[parent] = h[parent] * spmv(h[child])
                root = sched[-1][1] if sched else 0
                tot = tot + h[root]
            tree_b = segment_sum(tot * is_canon, batch.node_graph, g_cap)
            tree_memo[scheds] = tree_b
        # C(n-1, k-1) * k!  (the |Aut| division happens on the host)
        m = torch.clamp(n_g - 1.0, min=0.0)
        comb = torch.ones_like(m)
        for i in range(k - 1):
            comb = comb * torch.clamp(m - i, min=0.0) / (i + 1.0)
        subset_b = comb * float(math.factorial(k))
        cols.append(torch.minimum(tree_b, subset_b))
    return torch.stack(cols, dim=1)


def neighborhood_count_bounds(
    batches: List[PackedGraphs], queries: Sequence[Graph],
    canonical_type: int = 1, labeled: bool = False, *, device,
    graphed: bool = True, cache: Optional[ForwardCache] = None,
) -> np.ndarray:
    """(#neighborhoods, Q) f32 upper bounds, rows in the same valid-graph
    order as ``predict_neighborhood_counts``. Host batches are moved to
    ``device`` in one copy. ``graphed``: each batch replays the compiled
    ``_batch_bounds`` from ``cache`` (a fresh one if None); else it runs
    eagerly.

    ``labeled``: divide by the label-preserving |Aut(q)| (queries carry
    one-hot node_feat). The structural divisor is larger (a
    (0, 0, 1)-labeled triangle has 6 structural automorphisms but 2 that
    keep its labels), so it would make the bounds too small and clamp
    away correct labeled predictions.

    Spans: ``bounds.host`` (the schedules and automorphism factors),
    ``bounds.stage`` (the copy to ``device``), ``bounds.replay`` (each
    batch's call), ``bounds.readback``."""
    with trace.span("bounds.host"):
        schedules = _hashable_schedules(queries)
        auts = np.array([
            symmetric_factor(q, (q.node_feat.argmax(-1).astype(np.int32)
                                 if labeled else None))
            for q in queries], dtype=np.float32)

    def forward(b):
        return _batch_bounds(b, schedules, canonical_type)

    if graphed and cache is None:
        cache = ForwardCache()
    with torch.inference_mode():
        with trace.span("bounds.stage"):
            stacked = stack_batches(batches).to(device)
        outs = []
        for i in range(len(batches)):
            with trace.span("bounds.replay"):
                b = stacked[i]
                outs.append(cache(forward, (b,),
                                  static=("bounds", schedules,
                                          canonical_type),
                                  group=b.g_cap)
                            if graphed else forward(b))
        with trace.span("bounds.readback"):
            ubs = torch.cat(outs).cpu().numpy()
            ubs = ubs[np.concatenate([np.asarray(b.graph_mask) > 0
                                      for b in batches])]
            return ubs / auts[None, :]


def clamp_counts(counts: np.ndarray, bounds: np.ndarray) -> np.ndarray:
    """Elementwise min with the combinatorial bound (counts are raw,
    de-logged). Never raises a prediction."""
    return np.minimum(counts, bounds.astype(counts.dtype))
