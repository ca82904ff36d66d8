"""The port's hand-written CUDA kernels, with their plain PyTorch twins.

K1 ``sorted_segment_sum`` replaces desco_tpu's Pallas
``pallas_sorted_segment_sum`` (desco_tpu/ops/pallas_segment.py:310, bodies
``_segsum_kernel_v2`` :201 and ``_segsum_kernel`` :72). K2
``fused_typed_transform_aggregate`` replaces desco_tpu's
``fused_typed_transform_aggregate`` -> ``_fused_legacy`` (:476, :500), the
SHMP target tower's typed aggregation, run 8 times per packed batch. K3
``typed_cotangent_sums`` is the reduction of K2's backward, desco_tpu's
``_bwd_perm`` (:559, the VJP of ``_fused_perm`` :548). K4
``segment_sum_vjp`` is K1's backward, the gather of desco_tpu's
``sorted_segment_sum_ad`` (:448, ``_ssum_ad_bwd`` :464).

What bounds them on an H100: the reductions are bound by bytes. Each
edge adds one K-float row, a quarter of an f32 operation per byte moved,
far below the card's f32 ridge (67 TFLOP/s over 3.35 TB/s, 20 operations
per byte). K1 moves the message rows (E*K*4 B), the segment ids
(4 B/edge) and the output. K2's reduction moves 8 B/edge of keys and
sources, one z row (K*4 B) per edge gathered from a z table of
T*N*K*4 B — 6*N*256 B at the paper width, about the card's 50 MB L2 at
N = 30k — and the output. K2 as a whole is bound by operations: its
transform ``z = x @ W`` (2*N*H*K*T f32 operations, TF32 off; left to
``torch.matmul`` as desco_tpu left it to XLA) outweighs its bytes at the
paper width. K3's reduction writes u [N*T, K] f32, most of whose
(source, type) rows are empty and are zeros all the same: that write,
not the gather from a cotangent table g [N, K] that stays in L2, is what
the card must move; K3 as a whole (with the two einsums that turn u into
dx and dW, left to ``torch.einsum`` as desco_tpu left them to XLA) is
bound by the einsums' operations. K4 is one [E, K] write and as many
bytes read (PERF.md has the measured times beside the bounds).

What the design does about it: a sorted stream is CSR, so one
``torch.searchsorted`` gives the row offsets (as the JAX wrapper does at
pallas_segment.py:345) and padding keys sort past the last offset, dropped
without a pass. One warp owns one segment and reads its rows in order
with float2/float4 loads, summing in f32 registers: every output row is
written once, with no atomics and a deterministic order. K2 decodes each
edge's type from its key and gathers its z row inside the reduction, so
the [E, K] message tensor that ``_fused_legacy`` writes and reads back
never exists; K3 gathers the cotangent row g[dst] the same way, so
``_bwd_perm``'s [E, K] ``g_rows`` never exists either. The index streams
and offsets of a batch (``TypedStreams``) are derived once per batch,
not in every layer of every step as desco_tpu's jitted step re-derives
them. None of the TPU kernel's structure (one-hot MXU matmuls, 128-lane
padding, SEG_TILE/CE/GSZ tiles, VMEM guard) is carried over.

Types: the rows a reduction reads are float32 or bfloat16, as the TPU
kernels reduce bf16 rows with f32 accumulation (pallas_segment.py:322,
:503-508, :582-586). K1 takes bf16 messages, K2 a bf16 x and W (z = x @ W
stays bf16, as ``_fused_legacy``'s ``zp``), K3 a bf16 cotangent table;
all three accumulate and return f32, and the caller folds back to its
working type. K4 reads the f32 cotangent of K1's output and writes the
dtype of K1's messages (``_ssum_ad_bwd``, :464-469). Nothing up-casts an
[E, K] tensor on the card: the kernels convert in registers. Mixed types
(a bf16 x with an f32 W) raise.

Gradients: ``sorted_segment_sum`` and ``fused_typed_transform_aggregate``
are ``torch.autograd.Function``s on every device. Their backward is K4
and K3 (kernels on the card, plain versions on the CPU); without a
backward permutation K2's backward is desco_tpu's legacy ``_bwd`` (:524)
in plain torch, as it is plain XLA there.

Each wrapper takes its plain version only for CPU tensors; a CUDA tensor
launches the kernel or raises. Each counts its launches in a plain int
attribute (``sorted_segment_sum.launches``) so a run can show that the
main path went through the kernel. The library is built from
``csrc/segment_sum.cu`` with nvcc at first use (ops/cuda_build.py), into
``desco_tpu_torch/build/kernels/`` (listed in .gitignore); nothing here
touches CUDA when the module is imported.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Optional

import torch

from . import cuda_build
from .segment import segment_sum, typed_transform_aggregate

STEM = "desco_segment"
SOURCE = cuda_build.source_path(STEM)
ROW_DTYPES = (torch.float32, torch.bfloat16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lib = None
_lock = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(cuda_build.build(STEM))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.desco_segment_sum_abi_version.restype = i
            if lib.desco_segment_sum_abi_version() != 3:
                raise RuntimeError("segment_sum kernel ABI mismatch")
            lib.desco_cuda_error_string.restype = ctypes.c_char_p
            lib.desco_cuda_error_string.argtypes = [i]
            lib.desco_sorted_segment_sum.restype = i
            lib.desco_sorted_segment_sum.argtypes = [p, i, p, i, i, p, p]
            lib.desco_fused_typed_gather_segsum.restype = i
            lib.desco_fused_typed_gather_segsum.argtypes = [
                p, i, p, p, p, i, i, i, i, p, p]
            lib.desco_gather_rows_segsum.restype = i
            lib.desco_gather_rows_segsum.argtypes = [
                p, i, p, p, i, i, i, p, p]
            lib.desco_segment_sum_vjp_gather.restype = i
            lib.desco_segment_sum_vjp_gather.argtypes = [
                p, p, i, i, i, p, i, p]
            _lib = lib
        return _lib


def default_agg_mode(device) -> str:
    """The target tower's aggregation for tensors on ``device``: the
    fused kernel ('kernel') on CUDA, desco_tpu's CPU default
    ('aggregate_first') on the CPU."""
    return "kernel" if torch.device(device).type == "cuda" else \
        "aggregate_first"


# ----------------------------------------------------------- validation
def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _require_cuda(*ts) -> None:
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(
            f"CUDA kernel inputs must all lie on one CUDA device, got "
            f"{[str(t.device) for t in ts]}")


def _require(t: torch.Tensor, name: str, dtypes, ndim: int) -> None:
    """``dtypes``: the dtype, or the tuple of dtypes, the kernel takes."""
    if isinstance(dtypes, torch.dtype):
        dtypes = (dtypes,)
    if t.dtype not in dtypes or t.dim() != ndim or not t.is_contiguous():
        want = " or ".join(str(d) for d in dtypes)
        raise ValueError(
            f"{name} must be a contiguous {ndim}-d {want} tensor, got "
            f"{t.dtype} of shape {tuple(t.shape)}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def _check(rc: int) -> None:
    if rc != 0:
        msg = library().desco_cuda_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel launch failed: {msg} ({rc})")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _count(wrapper, dtype) -> None:
    """One launch of ``wrapper``'s kernel: ``launches`` counts them all,
    ``launches_bf16`` those on bf16 rows (K4: a bf16 result)."""
    wrapper.launches += 1
    if dtype == torch.bfloat16:
        wrapper.launches_bf16 += 1


# -------------------------------------------------------------- launches
# One function per kernel: the bare launch on the current stream, on
# tensors the wrapper has checked. The wrappers call them and count; the
# timing tools call them to time a kernel without its wrapper.
def launch_k1(msgs, offs, n_segments: int, out) -> None:
    with torch.cuda.device(msgs.device):
        _check(library().desco_sorted_segment_sum(
            msgs.data_ptr(), _DTYPE_CODE[msgs.dtype], offs.data_ptr(),
            n_segments, msgs.shape[1], out.data_ptr(),
            _stream(msgs.device)))


def launch_k2(z, st: "TypedStreams", out) -> None:
    with torch.cuda.device(z.device):
        _check(library().desco_fused_typed_gather_segsum(
            z.data_ptr(), _DTYPE_CODE[z.dtype], st.edge_src.data_ptr(),
            st.keys.data_ptr(), st.fwd_offs.data_ptr(), st.n_nodes,
            st.n_rows, st.n_types, z.shape[-1], out.data_ptr(),
            _stream(z.device)))


def launch_k3(g, st: "TypedStreams", out) -> None:
    with torch.cuda.device(g.device):
        _check(library().desco_gather_rows_segsum(
            g.data_ptr(), _DTYPE_CODE[g.dtype], st.bwd_rows.data_ptr(),
            st.bwd_offs.data_ptr(), st.n_rows * st.n_types, st.n_nodes,
            g.shape[1], out.data_ptr(), _stream(g.device)))


def launch_k4(g, seg, n_segments: int, out) -> None:
    with torch.cuda.device(g.device):
        _check(library().desco_segment_sum_vjp_gather(
            g.data_ptr(), seg.data_ptr(), seg.shape[0], n_segments,
            g.shape[1], out.data_ptr(), _DTYPE_CODE[out.dtype],
            _stream(g.device)))


# ------------------------------------------------------------------- K1
def sorted_segment_sum_plain(msgs: torch.Tensor, seg: torch.Tensor,
                             n_segments: int) -> torch.Tensor:
    """K1's plain version: ``index_add_`` of the rows (f32 or bf16,
    up-cast to f32) into their segment, ids outside [0, n_segments)
    dropped. [n_segments, K] f32."""
    return segment_sum(msgs.float(), seg, n_segments)


def _sorted_segment_sum_forward(msgs, seg, n_segments):
    if _on_cpu(msgs, seg):
        return sorted_segment_sum_plain(msgs, seg, n_segments)
    _require_cuda(msgs, seg)
    _require(msgs, "msgs", ROW_DTYPES, 2)
    _require(seg, "seg", torch.int32, 1)
    if seg.shape[0] != msgs.shape[0]:
        raise ValueError(f"seg has {seg.shape[0]} ids for "
                         f"{msgs.shape[0]} message rows")
    if not 0 <= n_segments < 2 ** 31 - 1:
        raise ValueError(f"n_segments={n_segments} out of int32 range")
    k = msgs.shape[1]
    out = torch.empty((n_segments, k), dtype=torch.float32,
                      device=msgs.device)
    if n_segments == 0 or k == 0:
        return out
    bounds = torch.arange(n_segments + 1, dtype=torch.int32,
                          device=msgs.device)
    offs = torch.searchsorted(seg, bounds, out_int32=True)
    launch_k1(msgs, offs, n_segments, out)
    _count(sorted_segment_sum, msgs.dtype)
    return out


class _SortedSegmentSum(torch.autograd.Function):
    """K1 forward, K4 backward (desco_tpu's ``sorted_segment_sum_ad``)."""

    @staticmethod
    def forward(ctx, msgs, seg, n_segments):
        ctx.save_for_backward(seg)
        ctx.n_segments = n_segments
        ctx.msgs_dtype = msgs.dtype  # the cotangent follows the primal
        return _sorted_segment_sum_forward(msgs, seg, n_segments)

    @staticmethod
    def backward(ctx, g):
        (seg,) = ctx.saved_tensors
        return segment_sum_vjp(g, seg, ctx.n_segments,
                               dtype=ctx.msgs_dtype), None, None


def sorted_segment_sum(msgs: torch.Tensor, seg: torch.Tensor,
                       n_segments: int) -> torch.Tensor:
    """Segment-sum of a sorted stream: out[s] = sum of msgs[e] over the
    edges with seg[e] == s. msgs [E, K] f32 or bf16; seg [E] int32,
    ascending; ids >= n_segments (padding keys) and < 0 are dropped.
    Accumulates in f32 and returns [n_segments, K] f32 for either type.
    Differentiable in msgs (backward: K4, in msgs' dtype)."""
    return _SortedSegmentSum.apply(msgs, seg, n_segments)


sorted_segment_sum.launches = 0
sorted_segment_sum.launches_bf16 = 0


# ------------------------------------------------------------------- K4
def segment_sum_vjp_plain(g: torch.Tensor, seg: torch.Tensor,
                          n_segments: int,
                          dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """K4's plain version: ``index_select`` of the cotangent rows by
    segment id, times the mask of ids inside [0, n_segments), cast to
    ``dtype`` (default: g's)."""
    dtype = dtype or g.dtype
    ids = seg.long()
    live = (ids >= 0) & (ids < n_segments)
    if n_segments == 0:
        return g.new_zeros((seg.shape[0], g.shape[1]), dtype=dtype)
    rows = g.index_select(0, ids.clamp(0, n_segments - 1))
    return (rows * live[:, None].to(g.dtype)).to(dtype)


def segment_sum_vjp(g: torch.Tensor, seg: torch.Tensor, n_segments: int,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The cotangent of K1's messages: d[e] = g[seg[e]] where
    0 <= seg[e] < n_segments, else 0. g [n_segments, K] f32, the
    cotangent of K1's f32 output (made contiguous here: autograd hands
    over expanded or strided cotangents); seg [E] int32. Returns [E, K]
    in ``dtype``, the dtype of K1's messages (f32 or bf16, rounded to
    nearest even)."""
    if dtype not in ROW_DTYPES:
        raise ValueError(f"the cotangent of K1's messages is f32 or bf16, "
                         f"not {dtype}")
    if _on_cpu(g, seg):
        return segment_sum_vjp_plain(g, seg, n_segments, dtype)
    _require_cuda(g, seg)
    g = g.contiguous()
    _require(g, "g", torch.float32, 2)
    _require(seg, "seg", torch.int32, 1)
    if g.shape[0] != n_segments:
        raise ValueError(f"g has {g.shape[0]} rows for {n_segments} "
                         f"segments")
    e, k = seg.shape[0], g.shape[1]
    if e >= 2 ** 31 - 1:
        raise ValueError(f"{e} rows do not fit the kernel's int32 count")
    out = torch.empty((e, k), dtype=dtype, device=g.device)
    if e == 0 or k == 0:
        return out
    if n_segments == 0:
        return out.zero_()
    launch_k4(g, seg, n_segments, out)
    _count(segment_sum_vjp, dtype)
    return out


segment_sum_vjp.launches = 0
segment_sum_vjp.launches_bf16 = 0


# ------------------------------------------------------- K2 and K3 streams
PAD_SKEY = 2 ** 30  # source key of dead edges, past every segment


@dataclasses.dataclass
class TypedStreams:
    """The index streams of one (dst,type)-sorted edge set, derived once
    per batch and shared by every layer and step that aggregates over it.

    ``fwd_offs`` are K2's CSR offsets over the destination nodes. With a
    backward permutation (``edge_bwd_perm`` of ``pack_samples``: the edge
    slots in (src, type) order, dead edges last) the stream is CSR again
    over the n_rows*T (source, type) segments: ``bwd_rows`` is the
    destination of each permuted edge (the cotangent row K3 gathers),
    ``bwd_skey`` its source key src*T + type (``PAD_SKEY`` for dead
    edges) and ``bwd_offs`` the offsets of the segments in it."""

    edge_src: torch.Tensor   # [E] i32
    keys: torch.Tensor       # [E] i32, dst*T + type, ascending
    n_types: int
    n_nodes: int             # output rows (destinations)
    n_rows: int              # rows of x (sources)
    fwd_offs: torch.Tensor   # [n_nodes + 1] i32
    bwd_rows: Optional[torch.Tensor] = None  # [E] i32
    bwd_skey: Optional[torch.Tensor] = None  # [E] i32, ascending
    bwd_offs: Optional[torch.Tensor] = None  # [n_rows*T + 1] i32


def typed_streams(edge_src: torch.Tensor, keys: torch.Tensor, n_types: int,
                  n_nodes: int, n_rows: int,
                  bwd_perm: Optional[torch.Tensor] = None) -> TypedStreams:
    """Derive a batch's ``TypedStreams``. With ``bwd_perm`` it checks, at
    the cost of one read-back per batch, that the permuted source keys
    ascend: a permutation that is not the (src, type) order with dead
    edges last would make K3 sum wrong rows silently."""
    _require(edge_src, "edge_src", torch.int32, 1)
    _require(keys, "keys", torch.int32, 1)
    if edge_src.shape != keys.shape:
        raise ValueError("edge_src and keys differ in length")
    if n_rows == 0 or max(n_nodes + 1, n_rows) * n_types >= PAD_SKEY:
        raise ValueError(f"{n_rows} rows / {n_nodes} nodes x {n_types} "
                         f"types do not fit the kernel's int32 keys")
    dev = keys.device
    bounds = torch.arange(n_nodes + 1, dtype=torch.int32,
                          device=dev) * n_types
    st = TypedStreams(edge_src, keys, n_types, n_nodes, n_rows,
                      torch.searchsorted(keys, bounds, out_int32=True))
    if bwd_perm is None:
        return st
    _require(bwd_perm, "bwd_perm", torch.int32, 1)
    if bwd_perm.shape != keys.shape:
        raise ValueError("bwd_perm and keys differ in length")
    perm = bwd_perm.long()
    keys_p, src_p = keys[perm], edge_src[perm]
    dst_p = torch.div(keys_p, n_types, rounding_mode="floor")
    typ_p = keys_p - dst_p * n_types
    live = ((keys_p >= 0) & (keys_p < n_nodes * n_types)
            & (src_p >= 0) & (src_p < n_rows))
    skey = torch.where(live, src_p * n_types + typ_p,
                       torch.full_like(keys_p, PAD_SKEY))
    if skey.numel() > 1 and not bool((skey[1:] >= skey[:-1]).all()):
        raise ValueError(
            "bwd_perm does not put the edges in (src, type) order with "
            "dead edges last (pack_samples' edge_bwd_perm does)")
    seg_bounds = torch.arange(n_rows * n_types + 1, dtype=torch.int32,
                              device=dev)
    st.bwd_rows = dst_p.clamp(0, max(n_nodes - 1, 0)).contiguous()
    st.bwd_skey = skey.contiguous()
    st.bwd_offs = torch.searchsorted(st.bwd_skey, seg_bounds, out_int32=True)
    return st


# ------------------------------------------------------------------- K2
def fused_typed_transform_aggregate_plain(
        x: torch.Tensor, edge_src: torch.Tensor, keys: torch.Tensor,
        conv_w: torch.Tensor, n_types: int, n_nodes: int) -> torch.Tensor:
    """K2's plain version, ``_fused_legacy``: decode dst = key // T and
    type = key mod T, then ``typed_transform_aggregate`` (transform in
    x's dtype, gather into edge order, ``index_add_`` over dst in f32).
    [n_nodes, K] f32."""
    keys = keys.long()
    dst = torch.div(keys, n_types, rounding_mode="floor")
    out = typed_transform_aggregate(x, conv_w, edge_src, dst,
                                    keys - dst * n_types, n_types)
    n = x.shape[0]
    if n_nodes <= n:  # rows of dst in [n_nodes, n) are dropped
        return out[:n_nodes]
    return torch.cat([out, out.new_zeros((n_nodes - n, out.shape[1]))])


def _fused_forward(x, conv_w, st: TypedStreams):
    if x.dtype != conv_w.dtype:
        raise ValueError(f"x is {x.dtype} and conv_w {conv_w.dtype}: K2 "
                         f"takes both in one type (f32 or bf16)")
    if _on_cpu(x, st.edge_src, st.keys, conv_w):
        return fused_typed_transform_aggregate_plain(
            x, st.edge_src, st.keys, conv_w, st.n_types, st.n_nodes)
    _require_cuda(x, st.edge_src, st.keys, conv_w, st.fwd_offs)
    _require(x, "x", ROW_DTYPES, 2)
    _require(conv_w, "conv_w", x.dtype, 3)
    n, h = x.shape
    if n != st.n_rows:
        raise ValueError(f"x has {n} rows, the streams were derived for "
                         f"{st.n_rows}")
    if conv_w.shape[0] != st.n_types or conv_w.shape[1] != h:
        raise ValueError(f"conv_w {tuple(conv_w.shape)} does not match "
                         f"{st.n_types} types of width {h}")
    k = conv_w.shape[2]
    # [T, N, K] in x's dtype: f32 (TF32 off) or bf16, as _fused_legacy's
    # bf16 zp; the kernel gathers its rows and accumulates f32
    z = torch.matmul(x, conv_w).contiguous()
    out = torch.empty((st.n_nodes, k), dtype=torch.float32, device=x.device)
    if st.n_nodes == 0 or k == 0:
        return out
    launch_k2(z, st, out)
    _count(fused_typed_transform_aggregate, z.dtype)
    return out


class _FusedTypedAggregate(torch.autograd.Function):
    """K2 forward; backward K3 with a backward permutation in the
    streams, desco_tpu's legacy ``_bwd`` without."""

    @staticmethod
    def forward(ctx, x, conv_w, streams):
        ctx.save_for_backward(x, conv_w)
        ctx.streams = streams
        return _fused_forward(x, conv_w, streams)

    @staticmethod
    def backward(ctx, g):
        x, conv_w = ctx.saved_tensors
        st = ctx.streams
        if st.bwd_rows is None:
            dx, dw = typed_aggregate_bwd_legacy(g, x, conv_w, st)
        else:
            dx, dw = typed_aggregate_bwd(g, x, conv_w, st)
        return dx, dw, None


def fused_typed_transform_aggregate(
        x: torch.Tensor, edge_src: torch.Tensor, keys: torch.Tensor,
        conv_w: torch.Tensor, n_types: int, n_nodes: int,
        bwd_perm: Optional[torch.Tensor] = None,
        streams: Optional[TypedStreams] = None) -> torch.Tensor:
    """x_neigh [n_nodes, K]: sum over (dst,type)-sorted edges of
    x[src] @ W[type]. keys [E] int32 = dst*T + type, ascending; padding
    keys >= n_nodes*T decode past the last node and are dropped. x
    [N, H] with x[pad node] == 0 and conv_w [T, H, K], both f32 or both
    bf16; the sum is accumulated and returned in f32 for either.

    Differentiable in x and conv_w, the gradients in their dtypes.
    ``bwd_perm`` ([E] int32, the edge
    slots in (src, type) order with dead edges last, ``edge_bwd_perm`` of
    ``pack_samples``) selects the source-keyed backward K3; without it
    the backward is the legacy one. ``streams`` (``typed_streams`` of
    the same arguments) skips deriving the offsets again: a batch that
    runs many layers and steps passes it."""
    if streams is None:
        streams = typed_streams(edge_src, keys, n_types, n_nodes,
                                x.shape[0], bwd_perm)
    return _FusedTypedAggregate.apply(x, conv_w, streams)


fused_typed_transform_aggregate.launches = 0
fused_typed_transform_aggregate.launches_bf16 = 0


# ------------------------------------------------------------------- K3
def typed_cotangent_sums_plain(g: torch.Tensor,
                               st: TypedStreams) -> torch.Tensor:
    """K3's plain version: ``index_select`` of the cotangent rows (f32 or
    bf16, up-cast to f32) of the permuted edges, ``index_add_`` over
    their source keys. [n_rows*T, K] f32."""
    rows = g.float().index_select(0, st.bwd_rows.long())
    return segment_sum(rows, st.bwd_skey, st.n_rows * st.n_types)


def typed_cotangent_sums(g: torch.Tensor, st: TypedStreams) -> torch.Tensor:
    """u [n_rows*T, K]: u[s*T + t] = sum over the live type-t edges
    s -> d of g[d]. g [n_nodes, K] f32 or bf16 (made contiguous here:
    autograd hands over expanded or strided cotangents), accumulated and
    returned in f32; ``st`` carries a backward permutation."""
    if st.bwd_rows is None:
        raise ValueError("the streams carry no backward permutation")
    if _on_cpu(g, st.bwd_rows):
        return typed_cotangent_sums_plain(g, st)
    _require_cuda(g, st.bwd_rows, st.bwd_offs)
    g = g.contiguous()
    _require(g, "g", ROW_DTYPES, 2)
    if g.shape[0] != st.n_nodes:
        raise ValueError(f"g has {g.shape[0]} rows for {st.n_nodes} nodes")
    n_seg, k = st.n_rows * st.n_types, g.shape[1]
    out = torch.empty((n_seg, k), dtype=torch.float32, device=g.device)
    if k == 0:
        return out
    if st.n_nodes == 0:
        return out.zero_()
    launch_k3(g, st, out)
    _count(typed_cotangent_sums, g.dtype)
    return out


typed_cotangent_sums.launches = 0
typed_cotangent_sums.launches_bf16 = 0


def _bwd_einsums(u, x, conv_w, st: TypedStreams):
    """dx and dW from the f32 sums u, computed in f32 (JAX promotes a
    bf16 x or W against the f32 u, pallas_segment.py:587-588; torch
    raises on mixed types, so the cast is written out) and returned in
    the primals' dtypes (:589-591)."""
    u = u.view(st.n_rows, st.n_types, u.shape[1])
    dx = torch.einsum("ntk,thk->nh", u, conv_w.float())
    dw = torch.einsum("nh,ntk->thk", x.float(), u)
    return dx.to(x.dtype), dw.to(conv_w.dtype)


def _cotangent_table(g, x):
    """The cotangent table K3 gathers from: for a bf16 tower the rows are
    rounded to bf16 first, as ``_bwd_perm`` reduces bf16 cotangent rows
    (an [N, K] cast, not an [E, K] one)."""
    return g.to(torch.bfloat16) if x.dtype == torch.bfloat16 else g


def typed_aggregate_bwd(g, x, conv_w, st: TypedStreams):
    """(dx, dW) of K2 from ONE source-keyed reduction of the output
    cotangent (desco_tpu's ``_bwd_perm``): u by K3, then
    dx = einsum(u, W) and dW = einsum(x, u), in the primals' dtypes."""
    u = typed_cotangent_sums(_cotangent_table(g, x), st)
    return _bwd_einsums(u, x, conv_w, st)


def typed_aggregate_bwd_plain(g, x, conv_w, st: TypedStreams):
    """``typed_aggregate_bwd`` with K3's plain version."""
    u = typed_cotangent_sums_plain(_cotangent_table(g, x), st)
    return _bwd_einsums(u, x, conv_w, st)


def typed_aggregate_bwd_legacy(g, x, conv_w, st: TypedStreams):
    """(dx, dW) of K2 without a backward permutation: desco_tpu's legacy
    ``_bwd`` (pallas_segment.py:524) — per-type masked matmuls and an
    unsorted ``index_add_`` over the sources, plain torch on any device,
    computed in f32 and returned in the primals' dtypes."""
    x_dtype, w_dtype = x.dtype, conv_w.dtype
    x, conv_w = x.float(), conv_w.float()
    keys = st.keys.long()
    dst = torch.div(keys, st.n_types, rounding_mode="floor")
    etype = keys - dst * st.n_types
    live = (keys >= 0) & (dst < st.n_nodes)
    g_rows = g.float().index_select(0, dst.clamp(0, max(st.n_nodes - 1, 0)))
    g_rows = g_rows * live[:, None]
    seg = torch.where(live, etype, torch.full_like(etype, st.n_types))
    src = st.edge_src.long().clamp(0, st.n_rows - 1)
    msgs = x.index_select(0, src)
    dmsgs = g_rows.new_zeros((g_rows.shape[0], x.shape[1]))
    dw = []
    for t in range(st.n_types):
        m = (seg == t)[:, None]
        dmsgs = dmsgs + (g_rows @ conv_w[t].T) * m
        dw.append((msgs * m).T @ g_rows)
    dx = segment_sum(dmsgs, st.edge_src, st.n_rows)
    return dx.to(x_dtype), torch.stack(dw).to(w_dtype)


# every kernel wrapper of this module, for launch accounting
KERNELS = (sorted_segment_sum, fused_typed_transform_aggregate,
           typed_cotangent_sums, segment_sum_vjp)


def reset_launches() -> None:
    for kern in KERNELS:
        kern.launches = 0
        kern.launches_bf16 = 0


def read_launches() -> dict:
    """{wrapper name: launches} and {wrapper name + '_bf16': those on
    bf16 rows} since the last ``reset_launches``."""
    out = {kern.__name__: kern.launches for kern in KERNELS}
    out.update({kern.__name__ + "_bf16": kern.launches_bf16
                for kern in KERNELS})
    return out
