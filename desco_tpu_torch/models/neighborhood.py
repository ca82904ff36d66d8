"""Neighborhood counting model (stage 2 of DeSCo) — the port of
``desco_tpu/models/neighborhood.py``.

Two SHMP towers (targets, queries) and an MLP count head regressing
log2(count + 1) per (neighborhood, query) pair; the head's first linear
is split into target/query halves so the [Q, G, 4H] activation is two
matmuls and a broadcast add. Prediction de-logs as 2^pred - 1. Training
regresses smooth-L1 on log2(count + 1), averaged over the valid graphs
per query and then over the queries.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..batch.packed import PackedGraphs
from .init import linear_params
from .shmp_gnn import SHMPConfig, apply_shmp, init_shmp


def init_neighborhood_model(
        tgt_cfg: SHMPConfig, qry_cfg: SHMPConfig,
        generator: Optional[torch.Generator] = None) -> nn.ModuleDict:
    h = tgt_cfg.hidden_dim
    return nn.ModuleDict({
        "target": init_shmp(tgt_cfg, generator),
        "query": init_shmp(qry_cfg, generator),
        "count1": linear_params(2 * h, 4 * h, generator=generator),
        "count2": linear_params(4 * h, 1, generator=generator),
    })


def embed_queries(params, qry_cfg: SHMPConfig, query_batch: PackedGraphs,
                  train: bool = False,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """[Q, H] query embeddings (query_batch packs exactly the query set)."""
    return apply_shmp(params["query"], qry_cfg, query_batch, train,
                      generator)


def embed_targets(params, tgt_cfg: SHMPConfig, batch: PackedGraphs,
                  train: bool = False,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    return apply_shmp(params["target"], tgt_cfg, batch, train, generator)


def count_head(params, emb_targets: torch.Tensor,
               emb_queries: torch.Tensor) -> torch.Tensor:
    """pred[g, q] for all (target graph, query) pairs:
    Linear(2H -> 4H) . LeakyReLU(0.01) . Linear(4H -> 1) on
    cat(target, query), with W1 split into its target and query halves.
    The head is f32: a bf16 target tower's embedding is cast up here, and
    nowhere earlier (JAX promotes bf16 @ f32 silently at this matmul,
    desco_tpu/models/neighborhood.py:71; torch.matmul raises on mixed
    types)."""
    w1, b1 = params["count1"].w, params["count1"].b
    w2, b2 = params["count2"].w, params["count2"].b
    emb_targets = emb_targets.to(w1.dtype)
    h = emb_queries.shape[-1]
    wt, wq = w1[:h], w1[h:]
    # [G, 4H] + [Q, 1, 4H] -> [Q, G, 4H]
    hid = emb_targets @ wt + (emb_queries @ wq)[:, None, :] + b1
    hid = F.leaky_relu(hid, negative_slope=0.01)
    pred = (hid @ w2 + b2)[..., 0]  # [Q, G]
    return pred.T  # [G, Q]


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    d = pred - target
    ad = d.abs()
    return torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5)


def _masked_mean(v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over the valid graphs, per query: [Q]."""
    denom = mask.sum().clamp(min=1.0)
    return (v * mask[:, None]).sum(dim=0) / denom


def forward_counts(params, tgt_cfg, qry_cfg, batch, query_batch,
                   train: bool = False,
                   generator: Optional[torch.Generator] = None):
    """pred [G, Q] = log2(count + 1) from both towers. With dropout the
    query tower draws its masks first, then the target tower (desco_tpu
    folds a tag into the key for the query tower instead)."""
    emb_q = embed_queries(params, qry_cfg, query_batch, train, generator)
    emb_t = embed_targets(params, tgt_cfg, batch, train, generator)
    return count_head(params, emb_t, emb_q)


def train_loss(params, tgt_cfg: SHMPConfig, qry_cfg: SHMPConfig,
               batch: PackedGraphs, query_batch: PackedGraphs,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Smooth-L1 on log2(y + 1). Without a generator no dropout mask is
    drawn (the validation pass)."""
    pred = forward_counts(params, tgt_cfg, qry_cfg, batch, query_batch,
                          train=True, generator=generator)
    target = torch.log2(batch.y + 1.0)
    per_query = _masked_mean(smooth_l1(pred, target), batch.graph_mask)
    return per_query.mean()


def test_loss(params, tgt_cfg, qry_cfg, batch, query_batch) -> torch.Tensor:
    """Smooth-L1 of relu(2^(pred - 1)) against the raw counts."""
    pred = forward_counts(params, tgt_cfg, qry_cfg, batch, query_batch)
    depred = torch.relu(torch.exp2(pred - 1.0))
    per_query = _masked_mean(smooth_l1(depred, batch.y), batch.graph_mask)
    return per_query.mean()


test_loss.__test__ = False  # a model function, not a pytest test


def predict_counts(params, tgt_cfg, qry_cfg, batch, query_batch):
    """De-logged count prediction 2^pred - 1, shape [G, Q]; invalid graph
    rows are meaningless (mask outside)."""
    emb_q = embed_queries(params, qry_cfg, query_batch)
    return predict_counts_from_embs(params, tgt_cfg, batch, emb_q)


def predict_counts_from_embs(params, tgt_cfg, batch, emb_q):
    """predict_counts with the query tower hoisted: emb_q ([Q, H], from
    embed_queries) is computed once and reused across target batches."""
    emb_t = embed_targets(params, tgt_cfg, batch)
    return torch.exp2(count_head(params, emb_t, emb_q)) - 1.0
