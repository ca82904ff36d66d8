"""Whole-graph DIAMNet counting pipeline (GIN embeddings -> DIAMNet) —
the port of ``desco_tpu/models/baseline_diamnet.py``.

A homogeneous per-node GNN (one node type, one edge type, no anchor,
``per_node_output``) embeds whole target graphs and the query patterns;
DIAMNet attends each (graph, query) pair of node sequences against its
memory and regresses log2(count + 1), with the smooth-L1 loss of the main
model. desco_tpu maps the queries with ``jax.vmap``; here every (query,
graph) pair is one row of a [Q * G] batch, and the graph memory, which
reads the graph only, is initialised once per graph.

The graph tower takes the target tower's aggregation for its device
(``default_agg_mode``): on the card its one-type aggregation is the fused
typed transform-aggregate K2, and K3 its backward. The pattern tower
keeps ``aggregate_first`` (the gather-fused K1 and one matmul), as the
query tower of the main model does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..batch.packed import PackedGraphs
from ..ops.segment import segment_sum
from .diamnet import DIAMNetConfig, apply_diamnet, init_diamnet, init_memory
from .init import Tree
from .neighborhood import smooth_l1
from .shmp_gnn import SHMPConfig, apply_shmp, init_shmp


def diamnet_tower_config(hidden_dim: int = 64, layer_num: int = 3,
                         conv_type: str = "GIN",
                         agg_mode: str = "aggregate_first") -> SHMPConfig:
    return SHMPConfig(
        n_node_types=1, n_edge_types=1, edge_dst_type=(0,),
        input_dim=1, hidden_dim=hidden_dim, output_dim=hidden_dim,
        layer_num=layer_num, conv_type=conv_type, use_anchor=False,
        per_node_output=True, agg_mode=agg_mode)


def node_positions(batch: PackedGraphs) -> np.ndarray:
    """Host: the position of each node within its graph (padding nodes
    continue the pad graph's count; ``to_sequences`` drops them)."""
    ng = np.asarray(batch.node_graph)
    pos = np.zeros(len(ng), np.int32)
    counts: dict = {}
    for i, g in enumerate(ng):
        pos[i] = counts.get(int(g), 0)
        counts[int(g)] = pos[i] + 1
    return pos


def to_sequences(node_emb: torch.Tensor, batch: PackedGraphs,
                 positions: torch.Tensor, seq_len: int):
    """[N, D] per-node embeddings -> padded [G, L, D] sequences and
    lengths [G] (a scatter-add into each graph's slots)."""
    g_cap = batch.g_cap
    d = node_emb.shape[-1]
    slot = (batch.node_graph.long() * seq_len
            + positions.long().clamp(max=seq_len - 1))
    seqs = node_emb.new_zeros(((g_cap + 1) * seq_len, d)).index_add(
        0, slot, node_emb * batch.node_mask[:, None].to(node_emb.dtype))
    lengths = segment_sum(batch.node_mask.float(), batch.node_graph, g_cap)
    return seqs.view(g_cap + 1, seq_len, d)[:g_cap], lengths


def init_diamnet_pipeline(tower_cfg: SHMPConfig, dn_cfg: DIAMNetConfig,
                          generator: Optional[torch.Generator] = None
                          ) -> Tree:
    return Tree({
        "graph_tower": init_shmp(tower_cfg, generator),
        "pattern_tower": init_shmp(tower_cfg, generator),
        "diamnet": init_diamnet(dn_cfg, generator),
    })


def diamnet_forward(params, graph_cfg: SHMPConfig, pattern_cfg: SHMPConfig,
                    dn_cfg: DIAMNetConfig, batch: PackedGraphs, batch_pos,
                    batch_seq_len: int, query_batch: PackedGraphs,
                    query_pos, query_seq_len: int) -> torch.Tensor:
    """[G, Q] log-space predictions for every (graph, query) pair."""
    g_emb = apply_shmp(params["graph_tower"], graph_cfg, batch)
    p_emb = apply_shmp(params["pattern_tower"], pattern_cfg, query_batch)
    g_seq, g_len = to_sequences(g_emb, batch, batch_pos, batch_seq_len)
    p_seq, p_len = to_sequences(p_emb, query_batch, query_pos,
                                query_seq_len)
    n_g, n_q = g_seq.shape[0], p_seq.shape[0]
    dn = params["diamnet"]
    mem, mask = init_memory(dn, dn_cfg, g_seq, g_len)

    def per_pair(x):  # [G, ...] -> [Q * G, ...], query-major
        return x.repeat((n_q,) + (1,) * (x.dim() - 1))

    pred = apply_diamnet(
        dn, dn_cfg, p_seq.repeat_interleave(n_g, dim=0),
        p_len.repeat_interleave(n_g), per_pair(g_seq), per_pair(g_len),
        memory=(per_pair(mem), per_pair(mask)))
    return pred.view(n_q, n_g).T


def diamnet_train_loss(params, graph_cfg, pattern_cfg, dn_cfg, batch,
                       batch_pos, batch_seq_len, query_batch, query_pos,
                       query_seq_len) -> torch.Tensor:
    """Smooth L1 against log2(count + 1), averaged over the valid graphs
    per query, then over the queries."""
    pred = diamnet_forward(params, graph_cfg, pattern_cfg, dn_cfg, batch,
                           batch_pos, batch_seq_len, query_batch, query_pos,
                           query_seq_len)
    target = torch.log2(batch.y + 1.0)
    mask = batch.graph_mask
    per_q = (smooth_l1(pred, target) * mask[:, None]).sum(0) / \
        mask.sum().clamp(min=1.0)
    return per_q.mean()
