"""SHMP GNN core + embedding head — the port of ``desco_tpu/models/shmp_gnn.py``.

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
gather-fused sorted segment-sum K1 over (dst, type) keys (forward and
backward), then one matmul. A
service runs the query tower once, when it loads.

The conv types are desco_tpu's five. SAGE, GIN (a two-linear update per
node type on x_neigh + x, eps 0) and GCN (x = x_neigh) aggregate as
above, so K2 / K3 or the gather-fused K1 run them on the card. GAT and
PNA aggregate through their own providers (``gat_aggregator``,
``pna_aggregator``): the typed transform z = x @ W[t] is a matmul, their
sums over the (dst, type)-sorted edge stream go through K1 (GAT's
numerator and denominator in one launch, ``sorted_segment_sum_pair``;
PNA's ``sorted_segment_sum``; the backward is K4), PNA's counts are the
stream's offsets apart (``segment_counts``), and their segment max / min
go through ``scatter_reduce`` (``ops.segment.segment_max``), as
desco_tpu leaves those to ``jax.ops``.

Parameters are ``nn.Module`` trees in desco_tpu's pytree layout
(models/init.py); the forward is a plain function of (params, config,
batch), as in desco_tpu.

Dropout (``cfg.dropout``, training only) follows desco_tpu's places: after
the relu of every layer and after the first post linear. desco_tpu folds
and splits a JAX key per site; a ``torch.Generator`` has no fold, so the
caller hands one generator (on the tensors' device) and the masks are
drawn from it in the fixed order of the forward. The two packages draw
different masks from the same seed; parity tests run with dropout 0.

``cfg.dtype=torch.bfloat16`` runs a whole tower in bf16 (desco_tpu's
``SHMPConfig.dtype``): the parameters stay f32 ``nn.Parameter``s, the
masters, and are cast inside the forward (``cast_params``), so autograd
returns f32 gradients; activations, the transform z = x @ W and the
update linears run in bf16; every segment reduction accumulates in f32
(K1, K2 and their plain versions) and is folded back to bf16. PNA's
degree counts and moments stay f32, as desco_tpu keeps them. The count
head lives outside this module and stays f32.

Padding invariant: node features of padding slots are forced to zero
after every dense op, so padded edges (src = pad node) contribute nothing;
it survives the bf16 casts (the mask is 0 or 1 in either type).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..batch.packed import PackedGraphs
from ..ops.segment import graph_pool_sum, segment_max, typed_edge_aggregate
from .init import Linear, Tree, linear_params, mlp_params

AGG_MODES = ("aggregate_first", "kernel")
CONV_TYPES = ("SAGE", "GIN", "GCN", "GAT", "PNA")


@dataclasses.dataclass(frozen=True)
class SHMPConfig:
    """Static model configuration (desco_tpu's SHMPConfig). ``agg_mode``
    is the SAGE, GIN and GCN aggregation; GAT and PNA aggregate through
    their own providers in every mode, as in desco_tpu."""

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
    # the post MLP per node, no pooling (the DIAMNet baseline's towers)
    per_node_output: bool = False
    canonical_type: int = 1
    # the tower's working type: float32, or bfloat16 with f32 master
    # parameters and f32 accumulation in every segment reduction
    dtype: torch.dtype = torch.float32
    # 'aggregate_first': gather-fused K1 into [N, T, H], then one
    # [N, T*H] @ [T*H, K] matmul (desco_tpu's CPU default);
    # 'kernel': K2, z = x @ W[t] then the fused gather-reduce
    # (ops/cuda_segment.py) — its plain version for CPU tensors
    agg_mode: str = "aggregate_first"

    def __post_init__(self):
        if self.conv_type not in CONV_TYPES:
            raise NotImplementedError(
                f"conv_type={self.conv_type!r}: desco_tpu's conv types are "
                f"{', '.join(CONV_TYPES)}")
        if self.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype={self.dtype}: a tower runs in "
                             f"torch.float32 or torch.bfloat16")
        if self.agg_mode not in AGG_MODES:
            raise ValueError(f"agg_mode={self.agg_mode!r}: the port has "
                             f"{', '.join(AGG_MODES)}")

    @property
    def post_input_dim(self) -> int:
        return self.hidden_dim * self.layer_num + self.hidden_dim


def init_shmp(cfg: SHMPConfig,
              generator: Optional[torch.Generator] = None) -> Tree:
    """Fresh parameters for the SHMP BaseGNN, desco_tpu's tree layout:
    per conv type ``upd`` (SAGE), ``upd1`` and ``upd2`` (GIN), nothing
    (GCN), ``att`` = (a_src, a_dst) [L, T, H] each (GAT), ``pna_mix``
    [L, T, 12H, H] (PNA)."""
    h, p = cfg.hidden_dim, cfg.post_input_dim
    L, t_e, t_n = cfg.layer_num, cfg.n_edge_types, cfg.n_node_types
    g = generator
    params = Tree({
        # pre_mp cloned per node type (to_hetero semantics)
        "pre": linear_params(cfg.input_dim, h, t_n, generator=g),
        # conv lin per (layer, edge type)
        "conv": linear_params(h, h, L, t_e, generator=g),
        "post": mlp_params([p, h, h, 256, cfg.output_dim], generator=g),
    })
    if cfg.conv_type == "SAGE":
        params["upd"] = linear_params(2 * h, h, L, t_n, generator=g)
    elif cfg.conv_type == "GIN":
        # 2-layer update MLP per (layer, node type); eps fixed at 0
        params["upd1"] = linear_params(h, h, L, t_n, generator=g)
        params["upd2"] = linear_params(h, h, L, t_n, generator=g)
    elif cfg.conv_type == "GAT":
        # per-(layer, edge-type) attention vectors (GATConv, heads=1)
        params["att"] = nn.ParameterList([
            torch.randn(L, t_e, h, generator=g) / math.sqrt(h)
            for _ in range(2)])
    elif cfg.conv_type == "PNA":
        # per-(layer, edge-type) mixer over 3 scalers x 4 aggregators x H
        k = 1.0 / math.sqrt(12 * h)
        params["pna_mix"] = nn.Parameter(
            torch.empty(L, t_e, 12 * h, h).uniform_(-k, k, generator=g))
    if cfg.use_anchor:
        params["anchor"] = linear_params(p, p, generator=g)
    return params


class _CastLinear(NamedTuple):
    """A ``Linear``'s (w, b) cast to a tower's working type."""

    w: torch.Tensor
    b: torch.Tensor

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


def cast_params(params, dtype: torch.dtype, device=None):
    """The tower's parameter tree with every f32 leaf cast to ``dtype``
    (the tree itself for f32): desco_tpu's ``cast_params``. The stored
    parameters stay the f32 masters; the casts are part of the forward's
    graph, so their gradients arrive in f32. ``device``: the leaves are
    also copied there (the halo path's shards on other devices), again
    inside the graph."""
    if dtype == torch.float32 and device is None:
        return params
    return map_params(params, lambda p: p.to(device, dtype))


def map_params(params, fn):
    """The tower's parameter tree with ``fn`` applied to every leaf, in the
    shape ``cast_params`` gives it."""
    if isinstance(params, Linear):
        return _CastLinear(fn(params.w), fn(params.b))
    if isinstance(params, nn.ParameterList):  # GAT's (a_src, a_dst)
        return [fn(p) for p in params]
    if isinstance(params, nn.ModuleList):
        return [map_params(m, fn) for m in params]
    out = {name: map_params(m, fn) for name, m in params.items()}
    out.update({name: fn(p)  # PNA's pna_mix
                for name, p in params.named_parameters(recurse=False)})
    return out


def _per_type_linear(x, w, b, node_type, n_types):
    """y[i] = x[i] @ w[type(i)] + b[type(i)] — all-types matmul + select
    (desco_tpu's select semantics: a chain of where, not a gather)."""
    y_all = torch.matmul(x, w) + b[:, None, :]
    out = y_all[0]
    for t in range(1, n_types):
        out = torch.where((node_type == t)[:, None], y_all[t], out)
    return out


def keep_mask(shape, rate: float, generator: torch.Generator, device,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A dropout keep mask: bool, true with probability 1 - rate, drawn
    from ``generator`` (on ``device``) as one uniform of ``dtype`` per
    entry."""
    return torch.rand(shape, generator=generator, device=device,
                      dtype=dtype) >= rate


def apply_keep(x: torch.Tensor, keep: torch.Tensor,
               rate: float) -> torch.Tensor:
    """Inverted dropout with a drawn mask: kept entries rescaled by
    1 / (1 - rate), the rest zero."""
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: keep each entry with probability 1 - rate and
    rescale by 1 / (1 - rate). The mask is drawn from ``generator``, which
    lies on x's device; without one nothing is dropped (desco_tpu's
    ``rng=None``: the validation pass of the training loss)."""
    if not train or rate <= 0.0 or generator is None:
        return x
    return apply_keep(x, keep_mask(x.shape, rate, generator, x.device,
                                   x.dtype), rate)


def batch_pool_offsets(batch: PackedGraphs) -> torch.Tensor:
    """The CSR offsets [g_cap + 1] of the batch's graph pooling (its nodes
    are packed graph by graph, so ``node_graph`` is sorted), derived at
    first use and kept on the batch object as its streams are."""
    from ..ops.cuda_segment import segment_offsets

    offs = getattr(batch, "_pool_offsets", None)
    if offs is None:
        offs = segment_offsets(batch.node_graph.int(), batch.g_cap)
        batch._pool_offsets = offs
    return offs


def prepare_batch(batch: PackedGraphs, n_edge_types: int,
                  backward: bool, pooling: bool = True) -> None:
    """Derive, ahead of a loop over a resident batch, the per-batch state
    a tower would otherwise derive at its first step: the
    ``TypedStreams`` for ``n_edge_types``, their source-sorted backward
    streams (``backward``) and the pooling offsets (``pooling``). A
    captured step (utils/cuda_graphs.py) must find them ready: deriving the
    streams checks the batch's permutation with a read-back."""
    from ..ops.cuda_segment import ensure_backward_streams

    with torch.no_grad():
        st = batch_typed_streams(batch, n_edge_types)
    if backward:
        ensure_backward_streams(st)
    if pooling:
        batch_pool_offsets(batch)


def batch_typed_streams(batch: PackedGraphs, n_edge_types: int):
    """The batch's ``TypedStreams`` (keys, offsets and the source-keyed
    backward streams), derived at first use and kept on the batch
    object: every layer of every step over a device-resident batch shares
    them. The backward streams come from the batch's ``edge_bwd_perm``;
    a batch packed without it gets the permutation derived on its device
    once gradients are wanted (``ensure_backward_streams``). They are no
    field of ``PackedGraphs``, so stacking and ``.to`` never see them."""
    from ..ops.cuda_segment import ensure_backward_streams, typed_streams

    st = getattr(batch, "_typed_streams", None)
    if st is None or st.n_types != n_edge_types:
        keys = batch.edge_dst.int() * n_edge_types + batch.edge_type.int()
        perm = batch.edge_bwd_perm
        st = typed_streams(batch.edge_src.int().contiguous(),
                           keys.contiguous(), n_edge_types, batch.n_cap,
                           batch.n_cap,
                           None if perm is None else perm.int().contiguous())
        batch._typed_streams = st
    if torch.is_grad_enabled():
        ensure_backward_streams(st)
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
        st = batch_typed_streams(batch, t_e)

        def agg_fn(x, conv_w):
            agg = typed_edge_aggregate(
                x, batch.edge_src, batch.edge_dst, batch.edge_type,
                t_e, streams=st)  # [N, T_e, H]
            return agg.reshape(x.shape[0], -1) @ conv_w.reshape(
                -1, conv_w.shape[2])
    return agg_fn


def _edge_stream(batch: PackedGraphs, n_types: int):
    """(keys, rows): the (dst, type) keys dst*T + type of the batch's
    sorted edge stream, int32 and ascending (padding keys fall past
    n_cap*T and every sum drops them), and the row type*n_cap + src of
    each edge's transformed source in z [T*n_cap, K] (padding edges'
    types clipped into range, as desco_tpu clips them)."""
    keys = (batch.edge_dst.int() * n_types
            + batch.edge_type.int()).contiguous()
    e_t = batch.edge_type.long().clamp(0, n_types - 1)
    return keys, e_t * batch.n_cap + batch.edge_src.long()


def gat_aggregator(cfg: SHMPConfig, batch: PackedGraphs, att):
    """Typed GAT attention aggregation (conv_type='GAT'; desco_tpu's
    ``gat_aggregator``, shmp_gnn.py:180-231): attention softmax-normalized
    within each (dst, edge-type) segment with a self-loop term, per-type
    outputs summed. fn(x, conv_w, layer) -> [N, K] (f32 for a bf16
    tower: the softmax sums are K1's f32 sums, numerator and denominator
    in one launch, their cotangents in one K4 launch)."""
    from ..ops.cuda_segment import segment_offsets, sorted_segment_sum_pair

    a_src_all, a_dst_all = att  # [L, T, H] each
    t_n = cfg.n_edge_types
    keys, rows = _edge_stream(batch, t_n)
    offs = segment_offsets(keys, batch.n_cap * t_n)
    e_t = batch.edge_type.long().clamp(0, t_n - 1)
    src, dst = batch.edge_src.long(), batch.edge_dst.long()

    def agg_fn(x, conv_w, layer):
        n = x.shape[0]
        n_seg = n * t_n
        a_src, a_dst = a_src_all[layer], a_dst_all[layer]
        z = torch.matmul(x, conv_w)                       # [T, N, K]
        s_src = torch.einsum("tnk,tk->tn", z, a_src)      # [T, N]
        s_dst = torch.einsum("tnk,tk->tn", z, a_dst)
        s_e = F.leaky_relu(s_src[e_t, src] + s_dst[e_t, dst], 0.2)
        m = segment_max(s_e, keys, n_seg)  # empty segments -> 0
        # padding keys subtract 0 (desco_tpu's take with fill 0); their
        # terms are dropped by the sums
        p = torch.exp(s_e - segment_pick(m, keys, n_seg))
        z_src = z.reshape(n_seg, -1)[rows]                # [E, K]
        num, den = sorted_segment_sum_pair(p[:, None] * z_src, p, keys,
                                           n_seg, offs)
        return gat_softmax_out(num, den, m, s_src, s_dst, z)
    return agg_fn


def segment_pick(table: torch.Tensor, keys: torch.Tensor,
                 n_seg: int) -> torch.Tensor:
    """table[keys] for a stream's segment keys, 0 for padding keys (>=
    n_seg): desco_tpu's take with fill 0."""
    return torch.cat([table, table.new_zeros(1)])[
        keys.long().clamp(max=n_seg)]


def gat_softmax_out(num, den, m, s_src, s_dst, z) -> torch.Tensor:
    """GAT's output [N, K] from its per-(node, type) softmax sums: num
    [N*T, K] and den [N*T] the sums of exp(s_e - m) z_src and of
    exp(s_e - m) over each segment's edges, m [N*T] the segment maxima
    (0 where empty), s_src / s_dst [T, N] the logits, z [T, N, K] the
    transformed rows. The self-loop candidate is merged into each
    softmax; an empty segment (den == 0) anchors the rescale at the
    self-logit, so the result is exactly z_self there. The types are
    summed."""
    t_n, n = s_src.shape
    num, den, m2 = num.view(n, t_n, -1), den.view(n, t_n), m.view(n, t_n)
    s_self = F.leaky_relu(s_src + s_dst, 0.2).T           # [N, T]
    empty = den == 0
    big = torch.where(empty, s_self, torch.maximum(m2, s_self))
    w_edges = torch.where(empty, 0.0, torch.exp(m2 - big))
    w_self = torch.exp(s_self - big)
    z_self = z.transpose(0, 1)                            # [N, T, K]
    out_t = ((num * w_edges[..., None] + w_self[..., None] * z_self)
             / (den * w_edges + w_self)[..., None])
    return out_t.sum(dim=1)


def pna_aggregator(cfg: SHMPConfig, batch: PackedGraphs, mix_w_all):
    """Typed PNA aggregation (conv_type='PNA'; desco_tpu's
    ``pna_aggregator``, shmp_gnn.py:234-305): [mean, min, max, std] of
    z = x @ W[t] over each (dst, type) segment, scaled by {1,
    log(d+1)/delta, delta/log(d+1)} and mixed by ``mix_w[t]``, summed
    over the types; d is the segment's in-degree clamped to >= 1 and
    delta the batch's mean log(total in-degree + 1) over its valid nodes,
    without gradient. Counts and moments are f32 under a bf16 tower (a
    bf16 count saturates at 256). fn(x, conv_w, layer) -> [N, H] f32.

    The variance is taken in two passes, the sum of (z - mean)^2 over the
    segment: desco_tpu's E[z^2] - E[z]^2 is the same function, but in f32
    it cancels to rounding noise where a segment's values nearly tie
    (relative variance under about 1e-7), and sqrt's gradient 1 / (2 std)
    with it, so a change of summation order (the card against the CPU)
    moves the gradients by 1e-3 of their scale at eight layers. The mean
    goes back to the edges through K4 (``sorted_gather``). The counts
    are the stream's offsets apart (``segment_counts``): desco_tpu's
    segment-sum of ones, exact, with no launch."""
    from ..ops.cuda_segment import (segment_counts, segment_offsets,
                                    sorted_gather, sorted_segment_sum)

    t_n = cfg.n_edge_types
    keys, rows = _edge_stream(batch, t_n)
    offs = segment_offsets(keys, batch.n_cap * t_n)
    cnt = segment_counts(offs)                            # [N*T]
    nmask_f = batch.node_mask.float()

    def agg_fn(x, conv_w, layer):
        n = x.shape[0]
        n_seg = n * t_n
        mix_w = mix_w_all[layer]                          # [T, 12H, H]
        z = torch.matmul(x, conv_w)                       # [T, N, K]
        z_src = z.reshape(n_seg, -1)[rows]                # [E, K]
        z32 = z_src.float()
        d = cnt.clamp(min=1.0)[:, None]
        mean = sorted_segment_sum(z32, keys, n_seg, offs) / d
        dev_e = z32 - sorted_gather(mean, keys, n_seg, offs)
        var = sorted_segment_sum(dev_e * dev_e, keys, n_seg, offs) / d
        mn = segment_max(z_src, keys, n_seg, "amin")  # empty -> 0
        mx = segment_max(z_src, keys, n_seg, "amax")
        lsum, valid = pna_log_degree_sum(cnt, nmask_f)
        return pna_mix(cnt, mean, var, mn, mx, lsum, valid, mix_w)
    return agg_fn


def pna_log_degree_sum(cnt, nmask_f):
    """(sum of log(total in-degree + 1) over the valid nodes, their
    count): the parts of PNA's delta, the mean, from the (dst, type)
    counts cnt [N*T] and the node mask [N] (a sharded graph sums them
    over its shards)."""
    d_tot = cnt.view(nmask_f.shape[0], -1).sum(dim=1)
    return ((torch.log(d_tot.clamp(min=1.0) + 1.0) * nmask_f).sum(),
            nmask_f.sum())


def pna_mix(cnt, mean, var, mn, mx, lsum, valid, mix_w) -> torch.Tensor:
    """PNA's output [N, H] from its per-(dst, type) statistics (cnt [N*T],
    mean / var [N*T, K] f32, mn / mx [N*T, K]), the delta parts of
    ``pna_log_degree_sum`` and the layer's mix_w [T, 12K, H]: [mean, min,
    max, std] scaled by {1, log(d+1)/delta, delta/log(d+1)} and mixed,
    summed over the types; delta without gradient."""
    t_n = mix_w.shape[0]
    n = cnt.shape[0] // t_n
    # gradient-safe sqrt: var == 0 (empty or single-element segments)
    # gives zero gradient, not sqrt'(0) = inf
    pos = var > 0
    std = torch.where(pos, torch.sqrt(torch.where(pos, var, 1.0)), 0.0)
    feats = torch.cat([mean, mn.float(), mx.float(), std],
                      dim=-1).view(n, t_n, -1)            # [N, T, 4K]
    logd = torch.log(cnt.clamp(min=1.0) + 1.0).view(n, t_n)
    delta = (lsum / valid.clamp(min=1.0)).clamp(min=1e-6).detach()
    amp = (logd / delta)[..., None]
    att = (delta / logd)[..., None]
    # mixed in f32, as JAX promotes a bf16 mix_w against f32 features
    w_id, w_amp, w_att = mix_w.to(feats.dtype).split(
        mix_w.shape[1] // 3, dim=1)                       # [T, 4K, H] each

    def mix(f, w):  # "ntf,tfh->nh"
        return f.reshape(n, -1) @ w.reshape(-1, w.shape[-1])

    return mix(feats, w_id) + mix(feats * amp, w_amp) + mix(
        feats * att, w_att)


def aggregator(cfg: SHMPConfig, batch: PackedGraphs, params):
    """The layer aggregation fn(x, conv_w, layer) of ``cfg.conv_type``
    for parameters already cast to the tower's type (desco_tpu's choice
    in ``apply_shmp_core``)."""
    if cfg.conv_type == "GAT":
        return gat_aggregator(cfg, batch, params["att"])
    if cfg.conv_type == "PNA":
        return pna_aggregator(cfg, batch, params["pna_mix"])
    agg = packed_aggregator(cfg, batch)
    return lambda x, conv_w, layer: agg(x, conv_w)


def run_shmp_layers(params, cfg: SHMPConfig, x, ntype, nmask,
                    aggregate_fn, train: bool = False,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """The L conv layers with concat-skip. ``aggregate_fn(x, conv_w,
    layer)`` returns the type-transformed neighbor sum [N, K] (no
    bias)."""
    return run_shmp_layers_sharded(
        [params], cfg, [x], [ntype], [nmask],
        lambda xs, conv_ws, layer: [aggregate_fn(xs[0], conv_ws[0], layer)],
        train, [generator])[0]


def run_shmp_layers_sharded(shard_params, cfg: SHMPConfig, xs, ntypes,
                            nmasks, aggregate_fn, train: bool = False,
                            generators=None) -> list:
    """``run_shmp_layers`` over the shards of one partitioned graph
    (parallel/halo.py), in lockstep: per layer, ``aggregate_fn(xs,
    conv_ws, layer)`` maps the list of the shards' x to the list of their
    x_neigh (it exchanges rows between the shards), then every shard runs
    the layer body on its own rows. ``shard_params``, ``ntypes``,
    ``nmasks`` and ``generators`` (or None) are per shard, on its device.
    Returns the list of the shards' concat-skip embeddings."""
    generators = generators or [None] * len(xs)
    # per-dst-type conv bias: bias_by_ntype[t_n] = sum of the conv biases
    # of the edge types whose dst node type is t_n (a sum per node type,
    # not an atomic index_add_: the same bits every run)
    by_ntype = {x.device: _bias_types(cfg.edge_dst_type, cfg.n_node_types,
                                      x.device) for x in xs}
    embs = [[x] for x in xs]
    for l in range(cfg.layer_num):
        x_neighs = aggregate_fn(xs, [p["conv"].w[l] for p in shard_params],
                                l)
        xs = [_layer_body(p, cfg, l, x, x_neigh, ntype, nmask,
                          by_ntype[x.device], train, gen)
              for p, x, x_neigh, ntype, nmask, gen in zip(
                  shard_params, xs, x_neighs, ntypes, nmasks, generators)]
        for e, x in zip(embs, xs):
            e.append(x)
    return [torch.cat(e, dim=-1) for e in embs]


@functools.lru_cache(maxsize=None)
def _bias_types(edge_dst_type: Tuple[int, ...], n_node_types: int,
                device: torch.device) -> Tuple[torch.Tensor, ...]:
    """Per node type, the [k] int64 ids on ``device`` of the edge types
    whose destination has that type. Made once per config and device: a
    forward makes no host-to-device copy, which a captured step
    (utils/cuda_graphs.py) could not hold. Made outside inference mode, so a
    training forward can save them whichever forward made them first."""
    with torch.inference_mode(False):
        return tuple(
            torch.tensor([t for t, d in enumerate(edge_dst_type) if d == nt],
                         dtype=torch.long, device=device)
            for nt in range(n_node_types))


def _layer_body(params, cfg: SHMPConfig, l: int, x, x_neigh, ntype, nmask,
                by_ntype, train, generator):
    """Layer ``l`` after its aggregation: conv bias, update, relu,
    dropout and the padding mask."""
    conv = params["conv"]
    # the aggregation may accumulate and return f32 (K2 does, and its
    # plain version): fold back to the tower's type so a bf16 tower stays
    # bf16 through the concat / update chain
    x_neigh = x_neigh.to(cfg.dtype)
    bias_rows = conv.b[l].index_select(0, by_ntype[0]).sum(dim=0)
    for t in range(1, cfg.n_node_types):  # select, not gather
        bias_rows = torch.where(
            (ntype == t)[:, None],
            conv.b[l].index_select(0, by_ntype[t]).sum(dim=0),
            bias_rows)
    x_neigh = x_neigh + bias_rows
    if cfg.conv_type == "SAGE":
        upd = params["upd"]
        x = _per_type_linear(torch.cat([x_neigh, x], dim=-1), upd.w[l],
                             upd.b[l], ntype, cfg.n_node_types)
    elif cfg.conv_type == "GIN":  # update MLP on x_neigh + (1 + 0) x
        u1, u2 = params["upd1"], params["upd2"]
        hmid = torch.relu(_per_type_linear(
            x_neigh + x, u1.w[l], u1.b[l], ntype, cfg.n_node_types))
        x = _per_type_linear(hmid, u2.w[l], u2.b[l], ntype,
                             cfg.n_node_types)
    else:  # GCN, GAT, PNA: the conv output itself
        x = x_neigh
    return dropout(torch.relu(x), cfg.dropout, train, generator) * nmask


def apply_shmp_core(params, cfg: SHMPConfig, batch: PackedGraphs,
                    train: bool = False,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """BaseGNNCore.forward: [N, post_input_dim] concat-skip embeddings
    with padded rows zeroed, in ``cfg.dtype``."""
    return _shmp_core(cast_params(params, cfg.dtype), cfg, batch, train,
                      generator)


def _shmp_core(params, cfg: SHMPConfig, batch: PackedGraphs, train,
               generator) -> torch.Tensor:
    """``apply_shmp_core`` on parameters already cast to ``cfg.dtype``."""
    nmask = batch.node_mask[:, None].to(cfg.dtype)
    ntype = batch.node_type
    x = _per_type_linear(batch.x.to(cfg.dtype), params["pre"].w,
                         params["pre"].b, ntype, cfg.n_node_types)
    x = x * nmask
    return run_shmp_layers(params, cfg, x, ntype, nmask,
                           aggregator(cfg, batch, params), train, generator)


def apply_shmp(params, cfg: SHMPConfig, batch: PackedGraphs,
               train: bool = False,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """BaseGNN.forward: core -> anchor MLP on canonical nodes -> global
    add pool -> post MLP. Returns [G, out] in ``cfg.dtype``, or [N, out]
    with ``cfg.per_node_output`` (the post MLP per node, padding rows
    zeroed)."""
    params = cast_params(params, cfg.dtype)
    emb = _shmp_core(params, cfg, batch, train, generator)
    if cfg.use_anchor:
        anchored = F.leaky_relu(params["anchor"](emb), negative_slope=0.1)
        is_canon = (batch.node_type == cfg.canonical_type)[:, None]
        emb = torch.where(is_canon, anchored, emb)
    nmask = batch.node_mask[:, None].to(cfg.dtype)
    if cfg.per_node_output:
        return _apply_post(params["post"], emb, cfg.dropout, train,
                           generator) * nmask
    emb = emb * nmask
    pooled = graph_pool_sum(emb, batch.node_graph, batch.g_cap,
                            batch_pool_offsets(batch))
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
    from ..batch.build import (
        NEIGH_ORDER4_DST,
        NEIGH_PLAIN_DST,
        NEIGH_TCONV_DST,
    )

    if order == 4:
        # order-4 SHMP: 11 edge-orbit classes x 3 canonical combos
        return SHMPConfig(n_node_types=2, n_edge_types=33,
                          edge_dst_type=NEIGH_ORDER4_DST, **kw)
    if not use_hetero:
        return SHMPConfig(n_node_types=1, n_edge_types=1,
                          edge_dst_type=(0,), use_anchor=True,
                          canonical_type=1, **kw)
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
