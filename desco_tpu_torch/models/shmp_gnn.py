"""SHMP GNN core + embedding head — the port of ``desco_tpu/models/shmp_gnn.py``
(SAGE convolution).

SHMP is data, not module structure: edges carry a type id, and every
layer is

    x_neigh[i] = sum over t of (sum over type-t edges into i of x[src]) @ W[t]
                 + per-dst-type bias
    x          = relu(update_by_node_type(cat(x_neigh, x)))       (SAGE)

with the concat-skip of all layer outputs, the anchor MLP
(LeakyReLU 0.1) on canonical nodes, global add pooling and the post MLP.
The target tower's typed aggregation is the fused kernel K2 on the card
(``agg_mode='kernel'``, ops/cuda_segment.py). The query tower keeps
desco_tpu's default mode (``aggregate_first``), since desco_tpu's
``query_config`` sets no agg_mode either; on the card that mode is the
sorted segment-sum kernel K1 over (dst, type) keys, then one matmul. A
service runs the query tower once, when it loads.

Parameters are ``nn.Module`` trees in desco_tpu's pytree layout
(models/init.py); the forward is a plain function of (params, config,
batch), as in desco_tpu. GIN, GCN, GAT and PNA convolutions are not
ported yet (ROADMAP.md, Queue 1 M3).

Dropout (``cfg.dropout``, training only) follows desco_tpu's places: after
the relu of every layer and after the first post linear. desco_tpu folds
and splits a JAX key per site; a ``torch.Generator`` has no fold, so the
caller hands one generator (on the tensors' device) and the masks are
drawn from it in the fixed order of the forward. The two packages draw
different masks from the same seed; parity tests run with dropout 0.

Padding invariant: node features of padding slots are forced to zero
after every dense op, so padded edges (src = pad node) contribute nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..batch.packed import PackedGraphs
from ..ops.segment import graph_pool_sum, typed_edge_aggregate
from .init import linear_params, mlp_params

AGG_MODES = ("aggregate_first", "kernel")


@dataclasses.dataclass(frozen=True)
class SHMPConfig:
    """Static model configuration (desco_tpu's SHMPConfig minus the dtype
    and the per-node output of the baselines)."""

    n_node_types: int = 2
    n_edge_types: int = 6
    edge_dst_type: Tuple[int, ...] = (0, 0, 1, 1, 0, 0)
    input_dim: int = 1
    hidden_dim: int = 64
    output_dim: int = 64
    layer_num: int = 8
    conv_type: str = "SAGE"
    dropout: float = 0.0
    use_anchor: bool = True        # anchor MLP on canonical nodes
    canonical_type: int = 1
    # 'aggregate_first': gather + K1 into [N, T, H], then one
    # [N, T*H] @ [T*H, K] matmul (desco_tpu's CPU default);
    # 'kernel': K2, z = x @ W[t] then the fused gather-reduce
    # (ops/cuda_segment.py) — its plain version for CPU tensors
    agg_mode: str = "aggregate_first"

    def __post_init__(self):
        if self.conv_type != "SAGE":
            raise NotImplementedError(
                f"conv_type={self.conv_type!r}: the port has SAGE only so "
                f"far (GIN, GCN, GAT, PNA: ROADMAP.md, Queue 1 M3)")
        if self.agg_mode not in AGG_MODES:
            raise ValueError(f"agg_mode={self.agg_mode!r}: the port has "
                             f"{', '.join(AGG_MODES)}")

    @property
    def post_input_dim(self) -> int:
        return self.hidden_dim * self.layer_num + self.hidden_dim


def init_shmp(cfg: SHMPConfig,
              generator: Optional[torch.Generator] = None) -> nn.ModuleDict:
    """Fresh parameters for the SHMP BaseGNN, desco_tpu's tree layout."""
    h, p = cfg.hidden_dim, cfg.post_input_dim
    g = generator
    params = nn.ModuleDict({
        # pre_mp cloned per node type (to_hetero semantics)
        "pre": linear_params(cfg.input_dim, h, cfg.n_node_types,
                             generator=g),
        # conv lin per (layer, edge type)
        "conv": linear_params(h, h, cfg.layer_num, cfg.n_edge_types,
                              generator=g),
        "post": mlp_params([p, h, h, 256, cfg.output_dim], generator=g),
        "upd": linear_params(2 * h, h, cfg.layer_num, cfg.n_node_types,
                             generator=g),
    })
    if cfg.use_anchor:
        params["anchor"] = linear_params(p, p, generator=g)
    return params


def _per_type_linear(x, w, b, node_type, n_types):
    """y[i] = x[i] @ w[type(i)] + b[type(i)] — all-types matmul + select
    (desco_tpu's select semantics: a chain of where, not a gather)."""
    y_all = torch.matmul(x, w) + b[:, None, :]
    out = y_all[0]
    for t in range(1, n_types):
        out = torch.where((node_type == t)[:, None], y_all[t], out)
    return out


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: keep each entry with probability 1 - rate and
    rescale by 1 / (1 - rate). The mask is drawn from ``generator``, which
    lies on x's device; without one nothing is dropped (desco_tpu's
    ``rng=None``: the validation pass of the training loss)."""
    if not train or rate <= 0.0 or generator is None:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=x.dtype) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def batch_typed_streams(batch: PackedGraphs, n_edge_types: int):
    """The batch's ``TypedStreams`` (keys, offsets and, when the batch
    carries ``edge_bwd_perm``, the source-keyed backward streams),
    derived at first use and kept on the batch object: every layer of
    every step over a device-resident batch shares them. They are no
    field of ``PackedGraphs``, so stacking and ``.to`` never see them."""
    from ..ops.cuda_segment import typed_streams

    cached = getattr(batch, "_typed_streams", None)
    if cached is not None and cached.n_types == n_edge_types:
        return cached
    keys = batch.edge_dst.int() * n_edge_types + batch.edge_type.int()
    perm = batch.edge_bwd_perm
    st = typed_streams(batch.edge_src.int().contiguous(), keys.contiguous(),
                       n_edge_types, batch.n_cap, batch.n_cap,
                       None if perm is None else perm.int().contiguous())
    batch._typed_streams = st
    return st


def packed_aggregator(cfg: SHMPConfig, batch: PackedGraphs):
    """fn(x, conv_w) -> x_neigh [N, K] for ``cfg.agg_mode`` (the port of
    desco_tpu's ``packed_aggregator``, shmp_gnn.py:144-177)."""
    t_e = cfg.n_edge_types
    if cfg.agg_mode == "kernel":
        from ..ops.cuda_segment import fused_typed_transform_aggregate

        st = batch_typed_streams(batch, t_e)

        def agg_fn(x, conv_w):
            return fused_typed_transform_aggregate(
                x, st.edge_src, st.keys, conv_w, t_e, batch.n_cap,
                streams=st)
    else:
        def agg_fn(x, conv_w):
            agg = typed_edge_aggregate(
                x, batch.edge_src, batch.edge_dst, batch.edge_type,
                t_e)  # [N, T_e, H]
            return agg.reshape(x.shape[0], -1) @ conv_w.reshape(
                -1, conv_w.shape[2])
    return agg_fn


def run_shmp_layers(params, cfg: SHMPConfig, x, ntype, nmask,
                    aggregate_fn, train: bool = False,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """The L conv layers with concat-skip. ``aggregate_fn(x, conv_w)``
    returns the type-transformed neighbor sum [N, K] (no bias)."""
    # per-dst-type conv bias: bias_by_ntype[t_n] = sum of the conv biases
    # of the edge types whose dst node type is t_n
    dst_t = torch.as_tensor(cfg.edge_dst_type, device=x.device)
    conv, upd = params["conv"], params["upd"]
    embs = [x]
    for l in range(cfg.layer_num):
        x_neigh = aggregate_fn(x, conv.w[l])
        bias_by_ntype = x.new_zeros(
            (cfg.n_node_types, conv.b.shape[-1])).index_add_(
                0, dst_t, conv.b[l])
        bias_rows = bias_by_ntype[0]
        for t in range(1, cfg.n_node_types):  # select, not gather
            bias_rows = torch.where((ntype == t)[:, None],
                                    bias_by_ntype[t], bias_rows)
        x_neigh = x_neigh + bias_rows
        upd_in = torch.cat([x_neigh, x], dim=-1)
        x = _per_type_linear(upd_in, upd.w[l], upd.b[l], ntype,
                             cfg.n_node_types)
        x = dropout(torch.relu(x), cfg.dropout, train, generator) * nmask
        embs.append(x)
    return torch.cat(embs, dim=-1)


def apply_shmp_core(params, cfg: SHMPConfig, batch: PackedGraphs,
                    train: bool = False,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """BaseGNNCore.forward: [N, post_input_dim] concat-skip embeddings
    with padded rows zeroed."""
    nmask = batch.node_mask[:, None]
    ntype = batch.node_type
    x = _per_type_linear(batch.x, params["pre"].w, params["pre"].b,
                         ntype, cfg.n_node_types)
    x = x * nmask
    return run_shmp_layers(params, cfg, x, ntype, nmask,
                           packed_aggregator(cfg, batch), train, generator)


def apply_shmp(params, cfg: SHMPConfig, batch: PackedGraphs,
               train: bool = False,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """BaseGNN.forward: core -> anchor MLP on canonical nodes -> global
    add pool -> post MLP. Returns [G, out]."""
    emb = apply_shmp_core(params, cfg, batch, train, generator)
    if cfg.use_anchor:
        anchored = F.leaky_relu(params["anchor"](emb), negative_slope=0.1)
        is_canon = (batch.node_type == cfg.canonical_type)[:, None]
        emb = torch.where(is_canon, anchored, emb)
    emb = emb * batch.node_mask[:, None]
    pooled = graph_pool_sum(emb, batch.node_graph, batch.g_cap)
    return _apply_post(params["post"], pooled, cfg.dropout, train, generator)


def _apply_post(post, x, rate: float = 0.0, train: bool = False,
                generator: Optional[torch.Generator] = None):
    """post_mp: Linear -> Dropout -> LeakyReLU(0.1) -> Linear -> ReLU ->
    Linear -> ReLU -> Linear."""
    x = dropout(post[0](x), rate, train, generator)
    x = F.leaky_relu(x, negative_slope=0.1)
    x = torch.relu(post[1](x))
    x = torch.relu(post[2](x))
    return post[3](x)


# ----------------------------------------------------------------- configs
def neighborhood_target_config(
    use_tconv: bool = True, use_hetero: bool = True, order: int = 3, **kw
) -> SHMPConfig:
    from ..batch.build import NEIGH_PLAIN_DST, NEIGH_TCONV_DST

    if order != 3 or not use_hetero:
        raise NotImplementedError(
            "order-4 SHMP and the homogeneous (use_hetero=False) ablation "
            "are not ported yet (ROADMAP.md, Queue 1 M14)")
    if use_tconv:
        return SHMPConfig(n_node_types=2, n_edge_types=6,
                          edge_dst_type=NEIGH_TCONV_DST, **kw)
    return SHMPConfig(n_node_types=2, n_edge_types=3,
                      edge_dst_type=NEIGH_PLAIN_DST, **kw)


def query_config(use_tconv: bool = True, **kw) -> SHMPConfig:
    from ..batch.build import QUERY_PLAIN_DST, QUERY_TCONV_DST

    if use_tconv:
        return SHMPConfig(n_node_types=1, n_edge_types=2,
                          edge_dst_type=QUERY_TCONV_DST,
                          use_anchor=True, canonical_type=1, **kw)
    return SHMPConfig(n_node_types=1, n_edge_types=1,
                      edge_dst_type=QUERY_PLAIN_DST,
                      use_anchor=True, canonical_type=1, **kw)
