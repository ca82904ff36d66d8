"""Segment reductions in PyTorch — the port of ``desco_tpu/ops/segment.py``.

``segment_sum`` is ``jax.ops.segment_sum`` written with ``index_add_``.
The sorted reductions (the query tower's typed aggregation and the gossip
direction aggregation through ``typed_edge_aggregate``, graph pooling
through ``graph_pool_sum``) go through K1 (ops/cuda_segment.py): its
CUDA kernel on the card, with the edge gather folded in for the typed
aggregation, its plain ``index_select`` / ``index_add_`` version on the
CPU.

bf16 rows (the bf16 target tower) are summed in f32 everywhere, as the
TPU kernels accumulate them: ``segment_sum`` and
``typed_transform_aggregate`` return the f32 sums (what K1 and K2
return), while ``typed_edge_aggregate`` and ``graph_pool_sum`` fold the
f32 sums back to the rows' dtype, as desco_tpu's return the tower's
dtype. desco_tpu's XLA path on the CPU accumulates a bf16 scatter in
bf16, so the two packages agree there to bf16 rounding only.
"""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """out[s] = sum of data[i] with segment_ids[i] == s. Ids outside
    [0, num_segments) are dropped, as jax.ops.segment_sum drops them:
    they land in one spill row that is sliced off (no host sync). bf16
    data is up-cast and the f32 sums are returned."""
    if data.dtype == torch.bfloat16:
        data = data.float()
    ids = segment_ids.long()
    ids = ids.masked_fill((ids < 0) | (ids >= num_segments), num_segments)
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    out.index_add_(0, ids, data)
    return out[:num_segments]


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, reduce: str = "amax") -> torch.Tensor:
    """out[s] = max (``reduce='amin'``: min) of data[i] with
    segment_ids[i] == s, in data's dtype; an empty segment gives 0, the
    value desco_tpu puts where ``jax.ops.segment_max`` returns -inf
    (models/shmp_gnn.py:208, :289-290). Ids outside [0, num_segments)
    drop into a spill row, as jax drops them (``scatter_reduce`` would
    raise). ``scatter_reduce`` without the initial value: tied maxima
    share the gradient equally, as in jax. The rows start at -inf (+inf
    for the min), as jax's do, and are replaced by 0 only where no value
    arrived: ``scatter_reduce``'s backward counts the initial value among
    the ties when it equals the result, so a start at 0 would take half
    the gradient of a segment whose maximum is 0."""
    ids = segment_ids.long()
    ids = ids.masked_fill((ids < 0) | (ids >= num_segments), num_segments)
    if data.dim() > 1:
        ids = ids.view(-1, *([1] * (data.dim() - 1))).expand_as(data)
    start = float("-inf") if reduce == "amax" else float("inf")
    out = data.new_full((num_segments + 1,) + tuple(data.shape[1:]), start)
    out = out.scatter_reduce(0, ids, data, reduce, include_self=False)
    out = out[:num_segments]
    return torch.where(torch.isfinite(out), out, 0.0)


def typed_edge_aggregate(
    x: torch.Tensor,          # [N, H] node features
    edge_src: torch.Tensor,   # [E] i32
    edge_dst: torch.Tensor,   # [E] i32
    edge_type: torch.Tensor,  # [E] i32, values in [0, T); pad edges 63
    n_types: int,
    streams=None,             # the batch's TypedStreams for n_types
) -> torch.Tensor:
    """SHMP aggregation: out[i, t] = sum over edges e of type t with
    dst(e)==i of x[src(e)]. Returns [N, T, H] in x's dtype (f32 sums of
    bf16 rows are rounded back to bf16).

    Edges are (dst, type)-sorted on the host, so the combined key
    ``dst*T + t`` is sorted: one fused gather + segment-sum over it
    (``ops.cuda_segment.gather_segment_sum``; padding keys fall past N*T
    and are dropped), whose backward is the same kernel over the
    source-sorted stream. ``streams`` (``models.shmp_gnn
    .batch_typed_streams`` of the batch) carries the offsets derived once
    per batch; without it they are derived here, from the edge arrays."""
    from .cuda_segment import gather_segment_sum, typed_streams

    n = x.shape[0]
    if streams is None:
        keys = edge_dst.int() * n_types + edge_type.int()
        streams = typed_streams(edge_src.int().contiguous(),
                                keys.contiguous(), n_types, n, n)
    agg = gather_segment_sum(x, streams)
    return agg.to(x.dtype).reshape(n, n_types, x.shape[1])


def typed_transform_aggregate(
    x: torch.Tensor,          # [N, H]
    conv_w: torch.Tensor,     # [T, H, K] per-type weights
    edge_src: torch.Tensor,   # [E]
    edge_dst: torch.Tensor,   # [E]
    edge_type: torch.Tensor,  # [E]
    n_types: int,
) -> torch.Tensor:
    """Transform-first SHMP aggregation: out[i] = sum over edges into i of
    (x[src] @ W[type]). Returns [N, K] f32 (no bias): the transform runs
    in x's dtype (f32 or bf16) and its rows are summed in f32. Edges whose
    type or dst is out of range (the padding edges) add nothing: the
    order of desco_tpu's ``_fused_legacy``. K2 (ops/cuda_segment.py)
    aggregates first instead."""
    n = x.shape[0]
    flat = torch.matmul(x, conv_w).reshape(n_types * n, conv_w.shape[2])
    idx = edge_type.long() * n + edge_src.long()
    live = (idx >= 0) & (idx < n_types * n)
    msgs = flat[idx.clamp(0, n_types * n - 1)].float() * live[:, None]
    return segment_sum(msgs, edge_dst, n)


def graph_pool_sum(
    node_emb: torch.Tensor,    # [N, H]
    node_graph: torch.Tensor,  # [N] i32, sorted; pad nodes -> n_graphs
    n_graphs: int,
    offs=None,                 # [n_graphs + 1] i32 offsets of node_graph
) -> torch.Tensor:
    """global_add_pool: [G, H] in node_emb's dtype. Nodes are packed graph
    by graph, so ``node_graph`` is sorted and K1 applies; pad nodes (id G)
    drop. ``offs`` (``models.shmp_gnn.batch_pool_offsets``) are derived
    here when not given."""
    from .cuda_segment import segment_offsets, sorted_segment_sum

    seg = node_graph.int()
    if offs is None:
        offs = segment_offsets(seg, n_graphs)
    return sorted_segment_sum(node_emb.contiguous(), seg, n_graphs, offs
                              ).to(node_emb.dtype)
