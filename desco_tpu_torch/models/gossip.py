"""Gossip propagation model (stage 3 of DeSCo) — the port of
``desco_tpu/models/gossip.py``.

A 2-layer gated GNN runs on the *original* graph; node features are the
stage-1 predicted counts of one query; the model outputs a per-node
residual correction:

  * pre_mp(x) is concatenated with the broadcast query embedding;
  * gate g = lin_gate(query_emb) in (0,1): Linear -> sigmoid -> Linear ->
    sigmoid -> LeakyReLU (default slope 0.01); messages on forward edges
    (src < dst) scale by g, reverse edges by 1 - g. The per-edge
    linear-then-scale-then-sum is aggregate-then-linear with the exact
    per-direction degree term for the bias;
  * update = Linear(cat(aggr, x)); relu; concat-skip; per-node post MLP
    (LeakyReLU 0.1) -> scalar residual.

desco_tpu scans over the queries (``lax.scan``); here it is a loop. The
training loss runs each query under ``torch.utils.checkpoint``
(desco_tpu: ``jax.checkpoint`` around the scan body), so one query's
activations live at a time. A query's dropout masks are drawn before its
checkpointed call (``draw_keep_masks``, in the order and at the shapes
the forward applies them) and go in as arguments, so the recomputation
reuses them and draws nothing: the generator ends a step where the
forward left it, and a captured step (utils/cuda_graphs.py) holds the draws.
The checkpoint keeps the masks, 3 x N x hidden bools per query, until the
backward.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..batch.packed import PackedGraphs
from ..ops.segment import typed_edge_aggregate
from .init import linear_params, mlp_params
from .shmp_gnn import apply_keep, batch_typed_streams, keep_mask


def init_gossip_model(input_dim: int = 1, hidden_dim: int = 64,
                      emb_channels: int = 64, layer_num: int = 2,
                      generator: Optional[torch.Generator] = None
                      ) -> nn.ModuleDict:
    g = generator
    d_in0 = hidden_dim + emb_channels  # concat(query_emb, pre(x))
    convs = nn.ModuleList()
    for l in range(layer_num):
        d_in = d_in0 if l == 0 else hidden_dim
        convs.append(nn.ModuleDict({
            "com": linear_params(d_in, hidden_dim, generator=g),
            "upd": linear_params(hidden_dim + d_in, hidden_dim, generator=g),
            "gate": mlp_params([emb_channels, hidden_dim, 1], generator=g),
        }))
    post_in = hidden_dim * layer_num + d_in0
    return nn.ModuleDict({
        "pre": linear_params(input_dim, hidden_dim, generator=g),
        "convs": convs,
        "post": mlp_params([post_in, hidden_dim, hidden_dim, 256, 1],
                           generator=g),
    })


def _gate(conv_params, query_emb: torch.Tensor) -> torch.Tensor:
    """lin_gate: Linear -> sigmoid -> Linear -> sigmoid -> LeakyReLU;
    a scalar in (0,1)."""
    g1, g2 = conv_params["gate"]
    h = torch.sigmoid(g1(query_emb))
    return F.leaky_relu(torch.sigmoid(g2(h)))[0]


def gate_values(params, query_embs: torch.Tensor) -> torch.Tensor:
    """(layers, n_queries) gate table — the paper's homophily /
    antisymmetry analysis output."""
    return torch.stack([
        torch.stack([_gate(conv, q) for q in query_embs])
        for conv in params["convs"]])


def direction_degrees(batch: PackedGraphs) -> torch.Tensor:
    """[N, 2] in-degrees per direction bit (pad edges drop)."""
    return typed_edge_aggregate(
        batch.node_mask[:, None], batch.edge_src, batch.edge_dst,
        batch.edge_type, 2, streams=batch_typed_streams(batch, 2))[..., 0]


def draw_keep_masks(params, n: int, rate: float,
                    generator: torch.Generator, device) -> tuple:
    """One query's dropout keep masks, bool [n, width] each, drawn from
    ``generator`` in the order the forward applies them: the relu of every
    conv layer, then the first post linear (``models/shmp_gnn.keep_mask``,
    the draws ``dropout`` makes)."""
    widths = [conv["upd"].w.shape[-1] for conv in params["convs"]]
    widths.append(params["post"][0].w.shape[-1])
    return tuple(keep_mask((n, w), rate, generator, device) for w in widths)


def apply_gossip_single(params, batch: PackedGraphs, x_col: torch.Tensor,
                        query_emb: torch.Tensor,
                        deg: Optional[torch.Tensor] = None,
                        dropout: float = 0.0,
                        keep: Optional[Sequence[torch.Tensor]] = None
                        ) -> torch.Tensor:
    """Per-node residual [N] for ONE query. x_col: [N] stage-1 counts for
    this query; query_emb: [H_emb]; deg: ``direction_degrees(batch)``,
    computed here when not given. The input cat(query_emb, pre(x)) is
    detached, as desco_tpu stops its gradient: ``pre`` gets no gradient.
    ``keep`` (training with dropout): the query's masks from
    ``draw_keep_masks``, applied after the relu of each layer and after
    the first post linear with inverted-dropout scaling by ``dropout``."""
    nmask = batch.node_mask[:, None]
    keep = list(keep or ())

    def drop(x):
        return apply_keep(x, keep.pop(0), dropout) if keep else x

    x = params["pre"](x_col[:, None])
    qe = query_emb[None, :].expand(x.shape[0], query_emb.shape[0])
    x = torch.cat([qe, x], dim=-1).detach() * nmask
    embs = [x]
    if deg is None:
        deg = direction_degrees(batch)
    for conv in params["convs"]:
        g = _gate(conv, query_emb)
        agg = typed_edge_aggregate(
            x, batch.edge_src, batch.edge_dst, batch.edge_type, 2,
            streams=batch_typed_streams(batch, 2))
        mixed = g * agg[:, 0] + (1.0 - g) * agg[:, 1]
        wdeg = (g * deg[:, 0] + (1.0 - g) * deg[:, 1])[:, None]
        aggr = mixed @ conv["com"].w + conv["com"].b * wdeg
        x = conv["upd"](torch.cat([aggr, x], dim=-1))
        x = drop(torch.relu(x)) * nmask
        embs.append(x)

    # per-node post MLP (no pooling, no anchor)
    post = params["post"]
    h = drop(post[0](torch.cat(embs, dim=-1)))
    h = F.leaky_relu(h, negative_slope=0.1)
    h = torch.relu(post[1](h))
    h = torch.relu(post[2](h))
    return post[3](h)[:, 0] * batch.node_mask


def gossip_predict(params, batch: PackedGraphs,
                   query_embs: torch.Tensor) -> torch.Tensor:
    """[N, Q] refined counts: stage-1 count + gossip residual."""
    deg = direction_degrees(batch)
    cols = [apply_gossip_single(params, batch, batch.x[:, q], q_emb, deg)
            + batch.x[:, q]
            for q, q_emb in enumerate(query_embs)]
    return torch.stack(cols, dim=1)


def gossip_loss(params, batch: PackedGraphs, query_embs: torch.Tensor,
                dropout: float = 0.0, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Sum over queries and valid nodes of log2(|gossip + neigh - truth|
    + 1). batch.x: [N, Q] stage-1 counts; batch.node_y: [N, Q] truth.
    Training with dropout and a generator: each query's masks are drawn
    ahead of its checkpointed call and passed into it."""
    deg = direction_degrees(batch)
    draws = train and dropout > 0.0 and generator is not None

    def one_query(q_emb, x_col, y_col, *keep):
        res = apply_gossip_single(params, batch, x_col, q_emb, deg,
                                  dropout, keep)
        loss = torch.log2((res + x_col - y_col).abs() + 1.0)
        return (loss * batch.node_mask).sum()

    total = batch.x.new_zeros(())
    for q, q_emb in enumerate(query_embs):
        keep = (draw_keep_masks(params, batch.x.shape[0], dropout, generator,
                                batch.x.device) if draws else ())
        args = (q_emb, batch.x[:, q], batch.node_y[:, q], *keep)
        if torch.is_grad_enabled():
            total = total + checkpoint(one_query, *args,
                                       use_reentrant=False,
                                       preserve_rng_state=False)
        else:
            total = total + one_query(*args)
    return total
