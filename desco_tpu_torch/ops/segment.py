"""Segment reductions in PyTorch — the port of ``desco_tpu/ops/segment.py``.

``segment_sum`` is ``jax.ops.segment_sum`` written with ``index_add_``.
The sorted reductions of the serving path (SHMP typed aggregation, the
gossip direction aggregation, graph pooling) go through the K1 wrapper
``ops.cuda_segment.sorted_segment_sum``: its CUDA kernel on the card, its
plain ``index_add_`` version on the CPU.
"""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """out[s] = sum of data[i] with segment_ids[i] == s. Ids outside
    [0, num_segments) are dropped, as jax.ops.segment_sum drops them:
    they land in one spill row that is sliced off (no host sync)."""
    ids = segment_ids.long()
    ids = ids.masked_fill((ids < 0) | (ids >= num_segments), num_segments)
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    out.index_add_(0, ids, data)
    return out[:num_segments]


def typed_edge_aggregate(
    x: torch.Tensor,          # [N, H] node features
    edge_src: torch.Tensor,   # [E] i32
    edge_dst: torch.Tensor,   # [E] i32
    edge_type: torch.Tensor,  # [E] i32, values in [0, T); pad edges 63
    n_types: int,
) -> torch.Tensor:
    """SHMP aggregation: out[i, t] = sum over edges e of type t with
    dst(e)==i of x[src(e)]. Returns [N, T, H].

    Edges are (dst, type)-sorted on the host, so the combined key
    ``dst*T + t`` is sorted: one gather, then K1 over the keys (padding
    keys fall past N*T and are dropped).

    The gather is ``index_select``, whose backward is an unsorted
    ``index_add_`` with atomics (as XLA's scatter-add is in desco_tpu):
    the one sum of the training path whose order changes from run to run.
    ``x[edge_src]`` would compute the same forward, but its backward sorts
    the indices and walks duplicates serially, and every padding edge
    points at the one pad node (38 ms per call at the gossip batch of the
    paper config on an H100, PERF.md)."""
    from .cuda_segment import sorted_segment_sum

    n = x.shape[0]
    seg = edge_dst.int() * n_types + edge_type.int()
    msgs = x.index_select(0, edge_src.long())
    agg = sorted_segment_sum(msgs.contiguous(), seg, n_types * n)
    return agg.reshape(n, n_types, x.shape[1])


def typed_transform_aggregate(
    x: torch.Tensor,          # [N, H]
    conv_w: torch.Tensor,     # [T, H, K] per-type weights
    edge_src: torch.Tensor,   # [E]
    edge_dst: torch.Tensor,   # [E]
    edge_type: torch.Tensor,  # [E]
    n_types: int,
) -> torch.Tensor:
    """Transform-first SHMP aggregation: out[i] = sum over edges into i of
    (x[src] @ W[type]). Returns [N, K] (no bias). Edges whose type or dst
    is out of range (the padding edges) add nothing. This is K2's plain
    version (ops/cuda_segment.py)."""
    n = x.shape[0]
    flat = torch.matmul(x, conv_w).reshape(n_types * n, conv_w.shape[2])
    idx = edge_type.long() * n + edge_src.long()
    live = (idx >= 0) & (idx < n_types * n)
    msgs = flat[idx.clamp(0, n_types * n - 1)] * live[:, None]
    return segment_sum(msgs, edge_dst, n)


def graph_pool_sum(
    node_emb: torch.Tensor,    # [N, H]
    node_graph: torch.Tensor,  # [N] i32, sorted; pad nodes -> n_graphs
    n_graphs: int,
) -> torch.Tensor:
    """global_add_pool: [G, H]. Nodes are packed graph by graph, so
    ``node_graph`` is sorted and K1 applies; pad nodes (id G) drop."""
    from .cuda_segment import sorted_segment_sum

    return sorted_segment_sum(node_emb.contiguous(), node_graph.int(),
                              n_graphs)
