"""DIAMNet baseline: the dynamic-memory attention counter — the port of
``desco_tpu/models/diamnet.py``.

Graphs and patterns arrive as padded [B, L, D] node sequences with their
lengths. A memory of ``mem_len`` slots is initialised from the graph
sequence, then ``recurrent_steps`` times attends to the pattern and to
the graph through gated pre-LN multi-head attention
(out = g * q + (1 - g) * attn, the gate bias 1 so a fresh model passes
the query through); a two-layer head reads the memory with
[len, len, 1/len, 1/len] features and returns a log count.

All ten memory initialisations of desco_tpu: strided windows over the
sequence (stride len // m, kernel len - (m - 1) * stride) pooled by
``mean``, ``sum`` or ``max``; ``attn``, one gated-MHA step per window
with the query carried across windows; ``lstm``, an LSTM over each
window's elements with the carry crossing windows (desco_tpu's own cell,
gates in the order i, f, g, o of its ``wi`` / ``wh`` / ``b`` columns);
and the ``circular_`` variant of each, which first extends the sequence
circularly by ceil((len + 1) / 2) - 1 positions. A sequence shorter than
the memory fills slot w with element w.

Parameters are a ``Tree`` in desco_tpu's layout (models/init.py): the
attention blocks keep their bare arrays ``q``, ``k``, ``v``, ``o``,
``g_w``, ``g_b`` and their layer norms as (scale, bias) pairs; fresh
weights are N(0, 1/sqrt(h)) (attention N(0, 1/sqrt(h // 4))) drawn from
an explicit ``torch.Generator``, biases zero.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from .init import Linear, Tree

MEM_INITS = ("mean", "sum", "max", "attn", "lstm", "circular_mean",
             "circular_sum", "circular_max", "circular_attn",
             "circular_lstm")


@dataclasses.dataclass(frozen=True)
class DIAMNetConfig:
    pattern_dim: int = 64
    graph_dim: int = 64
    hidden_dim: int = 64
    num_heads: int = 4
    mem_len: int = 4
    recurrent_steps: int = 1
    # mean | sum | max | attn | lstm | circular_{mean,sum,max,attn,lstm}
    mem_init: str = "mean"

    def __post_init__(self):
        if self.mem_init not in MEM_INITS:
            raise ValueError(f"mem_init={self.mem_init!r}: one of "
                             f"{', '.join(MEM_INITS)}")


def _normal(shape, scale: float, g: Optional[torch.Generator]):
    return nn.Parameter(torch.randn(*shape, generator=g) * scale)


def _pair(a: torch.Tensor, b: torch.Tensor) -> nn.ParameterList:
    return nn.ParameterList([nn.Parameter(a), nn.Parameter(b)])


def _attn_params(q_dim, k_dim, v_dim, h,
                 g: Optional[torch.Generator]) -> Tree:
    scale = 1.0 / math.sqrt(h // 4)
    tree = Tree()
    tree["q"] = _normal((q_dim, h), scale, g)
    tree["k"] = _normal((k_dim, h), scale, g)
    tree["v"] = _normal((v_dim, h), scale, g)
    tree["o"] = _normal((h, q_dim), scale, g)
    tree["g_w"] = _normal((2 * q_dim, q_dim), scale, g)
    tree["g_b"] = nn.Parameter(torch.ones(q_dim))  # gate starts open
    for name, d in (("ln_q", q_dim), ("ln_k", k_dim), ("ln_v", v_dim)):
        tree[name] = _pair(torch.ones(d), torch.zeros(d))
    return tree


def init_diamnet(cfg: DIAMNetConfig,
                 generator: Optional[torch.Generator] = None) -> Tree:
    h = cfg.hidden_dim
    scale = 1.0 / math.sqrt(h)
    g = generator

    def lin(fan_in, fan_out, zero_w=False):
        w = (torch.zeros(fan_in, fan_out) if zero_w
             else torch.randn(fan_in, fan_out, generator=g) * scale)
        return Linear(w, torch.zeros(fan_out))

    params = Tree({
        "g_layer": lin(cfg.graph_dim, h),
        "p_attn": _attn_params(h, cfg.pattern_dim, cfg.pattern_dim, h, g),
        "g_attn": _attn_params(h, cfg.graph_dim, cfg.graph_dim, h, g),
        "pred1": lin(cfg.mem_len * h + 4, h),
        "pred2": lin(h + 4, 1, zero_w=True),
    })
    if cfg.mem_init.endswith("attn"):
        # window self-attention: queries in hidden space, keys and values
        # the raw graph features
        params["mem_attn"] = _attn_params(h, cfg.graph_dim, cfg.graph_dim,
                                          h, g)
    elif cfg.mem_init.endswith("lstm"):
        lstm = Tree()
        lstm["wi"] = _normal((cfg.graph_dim, 4 * h), scale, g)
        lstm["wh"] = _normal((h, 4 * h), scale, g)
        lstm["b"] = nn.Parameter(torch.zeros(4 * h))
        params["mem_lstm"] = lstm
    return params


def layer_norm(x, scale, bias, eps: float = 1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def gated_mha(p, q, k, v, k_mask, num_heads: int):
    """Gated pre-LN multi-head attention. q: [B, M, Dq]; k / v:
    [B, L, Dk]; k_mask: [B, L] (1 = valid)."""
    b, m, _ = q.shape
    ln_q = layer_norm(q, *p["ln_q"])
    ln_k = layer_norm(k, *p["ln_k"])
    ln_v = layer_norm(v, *p["ln_v"])
    h = p["q"].shape[1]
    hd = h // num_heads
    hq = (ln_q @ p["q"]).reshape(b, m, num_heads, hd)
    hk = (ln_k @ p["k"]).reshape(b, -1, num_heads, hd)
    hv = (ln_v @ p["v"]).reshape(b, -1, num_heads, hd)
    logits = torch.einsum("bmnd,blnd->bnml", hq, hk) / math.sqrt(hd)
    # a Python scalar, not a tensor made from one: a compiled step
    # (utils/cuda_graphs.py) holds no host-to-device copy
    logits = torch.where(k_mask[:, None, None, :] > 0, logits, -1e30)
    attn = torch.softmax(logits, dim=-1)
    vec = torch.einsum("bnml,blnd->bmnd", attn, hv).reshape(b, m, h)
    out = vec @ p["o"]
    gate = torch.sigmoid(torch.cat([q, out], dim=-1) @ p["g_w"] + p["g_b"])
    return gate * q + (1.0 - gate) * out


def _mem_windows(g_len, L: int, m: int):
    """The strided windows shared by every memory initialisation:
    (membership [B, M, L], kernel [B], lengths [B])."""
    lens = g_len.long()
    stride = torch.div(lens, m, rounding_mode="floor")
    kernel = lens - (m - 1) * stride
    w_idx = torch.arange(m, device=lens.device)[None, :, None]
    l_idx = torch.arange(L, device=lens.device)[None, None, :]
    lo = w_idx * stride[:, None, None]
    hi = lo + kernel[:, None, None]
    return (l_idx >= lo) & (l_idx < hi), kernel, lens


def _mem_short(g, lens, m: int):
    """Shorter than the memory: slot w takes element w, zero past the
    length."""
    L = g.shape[1]
    w_idx = torch.arange(m, device=g.device)[None, :, None]
    l_idx = torch.arange(L, device=g.device)[None, None, :]
    w_short = ((l_idx == w_idx) & (l_idx < lens[:, None, None])).to(g.dtype)
    return torch.einsum("bml,bld->bmd", w_short, g)


def _mem_mask(lens, m: int, dtype):
    slots = torch.arange(m, device=lens.device)[None, :]
    return torch.where(lens[:, None] < m, slots < lens[:, None],
                       torch.ones_like(slots, dtype=torch.bool)).to(dtype)


def _masked_max(g, member):
    """Max over a window's members ([B, M, L] membership), 0 where a
    window has none."""
    masked = torch.where(member[..., None], g[:, None, :, :], -math.inf)
    mx = masked.amax(dim=2)
    return torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))


def init_mem_pool(g, g_len, mem_len: int, kind: str = "mean"):
    """init_mem 'mean' / 'sum' / 'max': the strided windows pooled.
    g: [B, L, D]; g_len: [B]. Returns ([B, M, D], mask [B, M])."""
    m = mem_len
    in_win, kernel, lens = _mem_windows(g_len, g.shape[1], m)
    if kind == "mean":
        w_long = (in_win / kernel.clamp(min=1)[:, None, None]).to(g.dtype)
        mem_long = torch.einsum("bml,bld->bmd", w_long, g)
    elif kind == "sum":
        mem_long = torch.einsum("bml,bld->bmd", in_win.to(g.dtype), g)
    else:
        mem_long = _masked_max(g, in_win)
    use_short = (lens < m)[:, None, None]
    mem = torch.where(use_short, _mem_short(g, lens, m), mem_long)
    return mem, _mem_mask(lens, m, g.dtype)


def _circular_geometry(g_len, L: int):
    """(lengths, extended lengths, the static extended cap): the
    circular variants extend a sequence by ceil((len + 1) / 2) - 1
    positions."""
    lens = g_len.long()
    pad = torch.div(lens + 2, 2, rounding_mode="floor") - 1
    return lens, lens + pad, L + (L + 1) // 2


def init_mem_circular(g, g_len, mem_len: int, kind: str = "mean"):
    """init_mem 'circular_mean' / 'circular_sum' / 'circular_max': the
    strided windows over the circularly extended sequence, as a count
    per (window, original index) — a window that spans the wrap touches
    an index twice, and circular_sum counts it twice. A length equal to
    the memory's bypasses the extension (the short path)."""
    b, L, _ = g.shape
    m = mem_len
    lens, ext, L_ext = _circular_geometry(g_len, L)
    in_win, kernel, _ = _mem_windows(ext, L_ext, m)
    e2 = torch.arange(L_ext, device=g.device)[None, :]
    in_win = in_win & (e2 < ext[:, None])[:, None, :]
    orig = e2 % lens.clamp(min=1)[:, None]                # [B, Le]
    onehot = ((orig[:, :, None]
               == torch.arange(L, device=g.device)[None, None, :])
              & (e2 < ext[:, None])[:, :, None])          # [B, Le, L]
    cnt = torch.einsum("bme,bel->bml", in_win.to(g.dtype),
                       onehot.to(g.dtype))                # [B, M, L]
    if kind == "mean":
        w = cnt / kernel.clamp(min=1)[:, None, None].to(g.dtype)
        mem_long = torch.einsum("bml,bld->bmd", w, g)
    elif kind == "sum":
        mem_long = torch.einsum("bml,bld->bmd", cnt, g)
    else:  # max: membership only
        mem_long = _masked_max(g, cnt > 0)
    use_short = (lens <= m)[:, None, None]
    mem = torch.where(use_short, _mem_short(g, lens, m), mem_long)
    return mem, _mem_mask(lens, m, g.dtype)


def _circular_extend(g, g_len):
    """The circularly extended sequence ext[b, e] = g[b, e % len] for
    e < len + pad, zero beyond, and the extended lengths."""
    b, L, d = g.shape
    lens, ext, L_ext = _circular_geometry(g_len, L)
    e2 = torch.arange(L_ext, device=g.device)[None, :]
    orig = (e2 % lens.clamp(min=1)[:, None]).clamp(max=L - 1)
    ext_g = torch.gather(g, 1, orig[:, :, None].expand(b, L_ext, d))
    ext_g = torch.where((e2 < ext[:, None])[:, :, None], ext_g,
                        torch.zeros_like(ext_g))
    return ext_g, ext


def _window_seq(g, g_len, m: int, circular: bool):
    """(sequence, window membership [B, M, L]) of the attn and lstm
    variants: the sequence itself, or its circular extension."""
    if circular:
        seq, ext = _circular_extend(g, g_len)
        return seq, _mem_windows(ext, seq.shape[1], m)[0]
    return g, _mem_windows(g_len, g.shape[1], m)[0]


def _short_or(params, g, lens, m: int, circular: bool, mem_long):
    """The attn / lstm memories in hidden space: short sequences (up to
    the memory's length when circular) take the projected short path."""
    use_short = ((lens <= m) if circular else (lens < m))[:, None, None]
    return torch.where(use_short, params["g_layer"](_mem_short(g, lens, m)),
                       mem_long)


def init_mem_attn(params, cfg: DIAMNetConfig, g, g_len,
                  circular: bool = False):
    """init_mem 'attn' / 'circular_attn': one gated-MHA step per strided
    window, the query carried across windows (it starts at 1/sqrt(h));
    each step's output is one memory slot, in hidden space."""
    m, h_dim = cfg.mem_len, cfg.hidden_dim
    lens = g_len.long()
    keys, in_win = _window_seq(g, g_len, m, circular)
    h = torch.full((g.shape[0], 1, h_dim), 1.0 / math.sqrt(h_dim),
                   dtype=g.dtype, device=g.device)
    slots = []
    for w in range(m):
        h = gated_mha(params["mem_attn"], h, keys, keys,
                      in_win[:, w, :].to(g.dtype), cfg.num_heads)
        slots.append(h)
    mem = _short_or(params, g, lens, m, circular, torch.cat(slots, dim=1))
    return mem, _mem_mask(lens, m, g.dtype)


def init_mem_lstm(params, cfg: DIAMNetConfig, g, g_len,
                  circular: bool = False):
    """init_mem 'lstm' / 'circular_lstm': an LSTM consumes each window's
    elements in order (steps outside the window keep the carry); the
    hidden state after window w is slot w, and the carry crosses
    windows."""
    m, h_dim = cfg.mem_len, cfg.hidden_dim
    lens = g_len.long()
    seq, in_win = _window_seq(g, g_len, m, circular)
    p = params["mem_lstm"]
    x_proj = seq @ p["wi"]                                # [B, L, 4H]
    h = g.new_zeros((g.shape[0], h_dim))
    c = g.new_zeros((g.shape[0], h_dim))
    slots = []
    for w in range(m):
        for pos in range(seq.shape[1]):
            gates = x_proj[:, pos] + h @ p["wh"] + p["b"]
            i, f, gg, o = gates.chunk(4, dim=-1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            valid = in_win[:, w, pos][:, None]
            h = torch.where(valid, h_new, h)
            c = torch.where(valid, c_new, c)
        slots.append(h[:, None, :])
    mem = _short_or(params, g, lens, m, circular, torch.cat(slots, dim=1))
    return mem, _mem_mask(lens, m, g.dtype)


def init_memory(params, cfg: DIAMNetConfig, graph, g_len):
    """The memory ([B, M, H], mask [B, M]) of ``cfg.mem_init``; it reads
    the graph only."""
    kind = cfg.mem_init
    circular = kind.startswith("circular_")
    if kind.endswith("attn"):
        return init_mem_attn(params, cfg, graph, g_len, circular)
    if kind.endswith("lstm"):
        return init_mem_lstm(params, cfg, graph, g_len, circular)
    pool = kind.split("_", 1)[1] if circular else kind
    mem, mask = (init_mem_circular if circular else init_mem_pool)(
        graph, g_len, cfg.mem_len, pool)
    return params["g_layer"](mem), mask


def apply_diamnet(params, cfg: DIAMNetConfig, pattern, p_len, graph, g_len,
                  memory=None):
    """[B, 1] predicted log counts. pattern: [B, Lp, Dp]; graph:
    [B, Lg, Dg]; *_len: [B] valid lengths. ``memory``: the
    ``init_memory`` of these graphs, when the caller already has it."""
    b = pattern.shape[0]
    p_mask = (torch.arange(pattern.shape[1], device=pattern.device)[None, :]
              < p_len[:, None]).to(pattern.dtype)
    g_mask = (torch.arange(graph.shape[1], device=graph.device)[None, :]
              < g_len[:, None]).to(graph.dtype)
    mem, _ = (memory if memory is not None
              else init_memory(params, cfg, graph, g_len))
    for _ in range(cfg.recurrent_steps):
        mem = gated_mha(params["p_attn"], mem, pattern, pattern, p_mask,
                        cfg.num_heads)
        mem = gated_mha(params["g_attn"], mem, graph, graph, g_mask,
                        cfg.num_heads)
    plf = p_len.float()[:, None]
    glf = g_len.float()[:, None]
    # 1/len with a safe denominator: padding graphs have length 0
    lens = torch.cat([plf, glf, 1.0 / plf.clamp(min=1.0),
                      1.0 / glf.clamp(min=1.0)], dim=-1)
    y = torch.relu(params["pred1"](torch.cat([mem.reshape(b, -1), lens],
                                             dim=-1)))
    return params["pred2"](torch.cat([y, lens], dim=-1))
