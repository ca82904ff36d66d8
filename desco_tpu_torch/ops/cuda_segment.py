"""The port's hand-written CUDA kernels, with their plain PyTorch twins.

K1 ``sorted_segment_sum`` replaces desco_tpu's Pallas
``pallas_sorted_segment_sum`` (desco_tpu/ops/pallas_segment.py:310, bodies
``_segsum_kernel_v2`` :201 and ``_segsum_kernel`` :72). Its kernel also
carries the gather in front of it: ``gather_segment_sum`` is desco_tpu's
``typed_edge_aggregate`` ("one fused gather + segment-sum",
desco_tpu/ops/segment.py:29), and its backward ``gather_segment_sum_bwd``
is the same kernel over the source-sorted stream. K2
``fused_typed_transform_aggregate`` replaces desco_tpu's
``fused_typed_transform_aggregate`` -> ``_fused_legacy`` (:476, :500), the
SHMP target tower's typed aggregation, run 8 times per packed batch. K3
``typed_aggregate_bwd`` is K2's backward, desco_tpu's ``_bwd_perm`` (:559,
the VJP of ``_fused_perm`` :548). K4 ``segment_sum_vjp`` is K1's
backward behind graph pooling, the gather of desco_tpu's
``sorted_segment_sum_ad`` (:448, ``_ssum_ad_bwd`` :464).

K1 and K4 (``csrc/segment_sum.cu``) are bound by bytes: each edge adds or
copies one K-float row, a quarter of an f32 operation per byte moved, far
below the card's f32 ridge (67 TFLOP/s over 3.35 TB/s). A sorted stream is
CSR: K1 takes its row offsets (``segment_offsets``, one
``torch.searchsorted`` per stream, as the JAX wrapper does at
pallas_segment.py:345, shared by the stream's sums; the (dst, type) and
(src, type) offsets of ``TypedStreams`` for the typed aggregation, derived
once per batch) and, optionally, the row of x each edge reads. Padding
keys sort past the last offset and are never visited. One warp owns one
segment and one chunk of columns of a wide row (wide rows are split over
warps); rows of at most 16 elements give each segment a group of 1-16
lanes, so a warp sums up to 32 segments (a segment of more edges than
the warp has lane groups is summed by its whole warp). Wide rows are
edge-order sums; narrow rows take a fixed fold order (lane groups over
strided edges, folded as a tree). Either way the sums stay in f32
registers and are written once, with no atomics, in an order fixed by
the segment alone. So the typed
aggregation writes no [E, K] messages, and its backward is neither K4
nor the atomic ``index_add_`` behind ``index_select``: dx[s] = the sum
of the cotangent rows g[dst*T + type] over the edges out of s, read in
(src, type) order.
K4: one thread per 16-byte output piece. ``sorted_segment_sum_pair``
sums a one-column operand beside rows of more than 16 elements in the
same launch, on the rows' own warps (GAT's softmax denominator beside its
numerator; at 16 elements or fewer it is K1 on each, two launches), and
its backward writes both cotangents in one K4 launch; a count of ones is ``segment_counts`` of the
offsets, with no launch at all (PNA's degrees).

K2 and K3 (``csrc/typed_aggregate.cu``, redesigned for Hopper) aggregate
first and transform after: x_neigh = sum_t A_t @ W_t with A[d, t] the sum
of x[src] over the type-t edges into d (desco_tpu's ``aggregate_first``
order), and for the backward U[s, t] = sum over the type-t edges s -> d of
g[d], dx = sum_t U_t @ W_t^T, dW_t = x^T U_t. A block takes tiles of 32
rows; lane groups gather the tile's rows with 16-byte loads into a
shared-memory tile in f32 (one owner per (row, type) run, fixed order, no
atomics), and ``mma.sync`` multiplies the tile on the tensor cores in
split TF32 (f32 operands as hi + lo, three passes; bf16 operands are exact
in TF32, two passes), with W copied into shared memory by ``cp.async``.
So neither desco_tpu's transform z = x @ W [T*N, K] nor the cotangent sums
u [N*T, K] are ever written to device memory. dW crosses blocks: each
block writes one f32 partial and a second small kernel sums them in
block order. Where a tile's buffers for all T types do not fit in shared
memory (T above 11 for K2', 21 for K3' at H = K = 64; order-4 typing has
33), the types run in chunks (``chunk_types``), the outputs kept in
registers across them and the types summed in the same order, so the
result is the same bits. What bounds them at the paper width (H = K =
64, T = 6) is
the split-TF32 products on the tensor cores and the gather of one
128-256 B row per live edge from L2. The widths are at most 128 (odd widths are padded with zeros here).
The index streams of a batch (``TypedStreams``) are derived once per
batch, not in every layer of every step as desco_tpu's jitted step
re-derives them. None of the TPU kernels' structure (one-hot MXU matmuls,
128-lane padding, SEG_TILE/CE/GSZ tiles, VMEM guard) is carried over.

Types: rows are float32 or bfloat16, as the TPU kernels reduce bf16 rows
with f32 accumulation (pallas_segment.py:322, :503-508, :582-586). K1
takes bf16 messages, K2 a bf16 x and W, K3 a bf16 cotangent table (for a
bf16 tower, as ``_bwd_perm`` reduces bf16 cotangent rows); they
accumulate in f32, K1 and K2 return f32 and K3 returns dx and dW in the
primals' dtypes; the caller folds back to its working type. K2 rounds no
product to bf16 where ``_fused_legacy`` rounds z (ROADMAP Queue 3). K4
reads the f32 cotangent of K1's output and writes the dtype of K1's
messages (``_ssum_ad_bwd``, :464-469). Nothing up-casts an [E, K] tensor
on the card: the kernels convert in registers. Mixed types raise.

Gradients: ``sorted_segment_sum``, ``gather_segment_sum`` and
``fused_typed_transform_aggregate`` are ``torch.autograd.Function``s on
the card (``gather_segment_sum`` takes its plain twin and autograd on the
CPU). Their backward is K4, K1 over the source-sorted stream and K3
(kernels on the card, plain versions on the CPU); the gather-fused
backward derives a missing permutation on the device, while without one
K2's backward is desco_tpu's legacy ``_bwd`` (:524) in plain torch, as it
is plain XLA there.

Each wrapper takes its plain version only for CPU tensors; a CUDA tensor
launches the kernel or raises. Each counts its calls that launch a kernel
in a plain int attribute (``sorted_segment_sum.launches``) so a run can
show that the main path went through the kernel. A CUDA graph replay
(utils/cuda_graphs.py) runs no wrapper: ``LaunchRecord`` keeps what the
wrappers counted while the graph was captured and adds it per replay.
The launches themselves are capture-safe: they go to the current stream,
the kernels neither allocate nor synchronize, and each kernel's
shared-memory attribute is set at its first launch, before any capture. The libraries are built
from ``csrc/*.cu`` with nvcc at first use (ops/cuda_build.py), into
``desco_tpu_torch/build/kernels/`` (listed in .gitignore); nothing here
touches CUDA when the module is imported.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import threading
from typing import Optional

import torch

from . import cuda_build
from .segment import segment_sum

STEM = "desco_segment"
SOURCE = cuda_build.source_path(STEM)
TYPED_STEM = "desco_typed"
TYPED_SOURCE = cuda_build.source_path(TYPED_STEM)
ROW_DTYPES = (torch.float32, torch.bfloat16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
TILE_ROWS = 32    # rows of a K2 / K3 tile (kBM in typed_aggregate.cu)
MAX_WIDTH = 128   # the widest H and K the K2 / K3 kernels take

_libs: dict = {}
_lock = threading.Lock()


def _load(stem: str, abi_fn: str, abi: int, sigs: dict) -> ctypes.CDLL:
    with _lock:
        if stem not in _libs:
            lib = ctypes.CDLL(cuda_build.build(stem))
            getattr(lib, abi_fn).restype = ctypes.c_int
            if getattr(lib, abi_fn)() != abi:
                raise RuntimeError(f"{stem} kernel ABI mismatch")
            for name, argtypes in sigs.items():
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = argtypes
            _libs[stem] = lib
        return _libs[stem]


def library() -> ctypes.CDLL:
    """The loaded K1 / K4 library (built on first use)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    return _load(STEM, "desco_segment_sum_abi_version", 6, {
        "desco_sorted_segment_sum": [p, i, p, p, i, i, p, p],
        "desco_sorted_segment_sum_pair": [p, p, i, p, i, i, p, p, p],
        "desco_segment_sum_vjp_gather": [p, p, i, i, i, p, i, p],
        "desco_segment_sum_vjp_gather_pair": [p, p, p, i, i, i, p, p, i,
                                              p]})


def typed_library() -> ctypes.CDLL:
    """The loaded K2 / K3 library (built on first use)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    return _load(TYPED_STEM, "desco_typed_aggregate_abi_version", 2, {
        "desco_typed_aggregate_fwd": [p, i, i, i, p, p, i, i, p, i, p, i, p],
        "desco_typed_aggregate_bwd_blocks": [i, i, i, i, i],
        "desco_typed_aggregate_chunk_types": [i, i, i, i, i],
        "desco_typed_aggregate_set_chunk_cap": [i],
        "desco_typed_aggregate_bwd": [p, i, i, i, p, p, p, i, i, p, i, p, i,
                                      p, i, p],
        "desco_typed_aggregate_dw_reduce": [p, i, i, i, i, i, i, p, i, p]})


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


def _check(rc: int, lib: Optional[ctypes.CDLL] = None) -> None:
    """Raise on a nonzero return code of ``lib``'s C function (default:
    the K1 / K4 library), naming the CUDA error."""
    if rc != 0:
        err = (lib or library()).desco_cuda_error_string
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        raise RuntimeError(
            f"CUDA kernel launch failed: {err(rc).decode()} ({rc})")


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
def launch_k1(x, offs, n_segments: int, out, rows=None) -> None:
    """K1: out[r] = sum of x[rows[e]] over e in [offs[r], offs[r+1]);
    ``rows`` None is the identity (x holds the sorted messages)."""
    with torch.cuda.device(x.device):
        _check(library().desco_sorted_segment_sum(
            x.data_ptr(), _DTYPE_CODE[x.dtype],
            None if rows is None else rows.data_ptr(), offs.data_ptr(),
            n_segments, x.shape[1], out.data_ptr(), _stream(x.device)))


def launch_k2(x, conv_w, st: "TypedStreams", out) -> None:
    """K2': x [n_rows, h8] and conv_w [T, h8, k8] as ``pad_operands``
    leaves them; out [n_nodes, K] f32 with K <= k8."""
    with torch.cuda.device(x.device):
        lib = typed_library()
        _check(lib.desco_typed_aggregate_fwd(
            x.data_ptr(), _DTYPE_CODE[x.dtype], x.shape[0], x.shape[1],
            st.edge_src.data_ptr(), st.fwd_toffs.data_ptr(), st.n_nodes,
            st.n_types, conv_w.data_ptr(), conv_w.shape[2], out.data_ptr(),
            out.shape[1], _stream(x.device)), lib)


def k3_blocks(x, conv_w, st: "TypedStreams") -> int:
    """The blocks (so the dW partials) K3' runs on this card for these
    padded operands."""
    with torch.cuda.device(x.device):
        lib = typed_library()
        nb = lib.desco_typed_aggregate_bwd_blocks(
            _DTYPE_CODE[x.dtype], x.shape[1], conv_w.shape[2], st.n_types,
            st.n_rows)
        if nb <= 0:
            _check(-nb or 1, lib)
        return nb


def chunk_types(dtype: torch.dtype, h: int, k: int, n_types: int,
                backward: bool = False) -> int:
    """The types per chunk K2' (or, ``backward``, K3') runs for widths H,
    K and ``n_types`` types on the current card: all of them where one
    tile's per-type buffers fit in shared memory, else the even split
    into the fewest chunks that fit."""
    lib = typed_library()
    tc = lib.desco_typed_aggregate_chunk_types(
        _DTYPE_CODE[dtype], _round8(h), _round8(k), n_types, int(backward))
    if tc <= 0:
        _check(-tc or 1, lib)
    return tc


def set_chunk_cap(cap: int) -> None:
    """Cap the types per chunk of K2' and K3' at ``cap`` (0: as many as
    fit, the default). The types are summed in one order whatever the
    chunking, so a cap changes no result: it lets a check run the chunked
    path at a T that fits whole and compare the two bit for bit."""
    typed_library().desco_typed_aggregate_set_chunk_cap(int(cap))


def launch_k3(g, x, conv_w, st: "TypedStreams", dx, partial) -> None:
    """K3': g [n_nodes, k8], x [n_rows, h8], conv_w [T, h8, k8] (padded,
    one dtype); dx [n_rows, H] in x's dtype; partial [blocks, T, HP, KP]
    f32 (``k3_blocks``, ``_tile_width``)."""
    with torch.cuda.device(g.device):
        lib = typed_library()
        _check(lib.desco_typed_aggregate_bwd(
            g.data_ptr(), _DTYPE_CODE[g.dtype], g.shape[0], g.shape[1],
            st.bwd_rows.data_ptr(), st.bwd_offs.data_ptr(), x.data_ptr(),
            x.shape[0], x.shape[1], conv_w.data_ptr(), st.n_types,
            dx.data_ptr(), dx.shape[1], partial.data_ptr(), partial.shape[0],
            _stream(g.device)), lib)


def launch_k3_reduce(partial, dw) -> None:
    """K3's second launch: dw [T, H, K] (W's dtype) = the sum of the
    per-block partials [blocks, T, HP, KP] in block order."""
    nb, t, hp, kp = partial.shape
    with torch.cuda.device(partial.device):
        lib = typed_library()
        _check(lib.desco_typed_aggregate_dw_reduce(
            partial.data_ptr(), nb, t, hp, kp, dw.shape[1], dw.shape[2],
            dw.data_ptr(), _DTYPE_CODE[dw.dtype], _stream(dw.device)), lib)


def launch_k4(g, seg, n_segments: int, out) -> None:
    with torch.cuda.device(g.device):
        _check(library().desco_segment_sum_vjp_gather(
            g.data_ptr(), seg.data_ptr(), seg.shape[0], n_segments,
            g.shape[1], out.data_ptr(), _DTYPE_CODE[out.dtype],
            _stream(g.device)))


def launch_k1_pair(x, aux, offs, n_segments: int, out, aux_out) -> None:
    """K1 over identity rows with a one-column second operand: out as
    ``launch_k1`` and aux_out[r] = sum of aux[e] over the same edges. One
    launch for rows of more than 16 elements; K1 on each (two launches)
    at 16 or fewer."""
    with torch.cuda.device(x.device):
        _check(library().desco_sorted_segment_sum_pair(
            x.data_ptr(), aux.data_ptr(), _DTYPE_CODE[x.dtype],
            offs.data_ptr(), n_segments, x.shape[1], out.data_ptr(),
            aux_out.data_ptr(), _stream(x.device)))


def launch_k4_pair(g, g_aux, seg, n_segments: int, out, aux_out) -> None:
    """K4 for both operands of ``launch_k1_pair`` in one launch."""
    with torch.cuda.device(g.device):
        _check(library().desco_segment_sum_vjp_gather_pair(
            g.data_ptr(), g_aux.data_ptr(), seg.data_ptr(), seg.shape[0],
            n_segments, g.shape[1], out.data_ptr(), aux_out.data_ptr(),
            _DTYPE_CODE[out.dtype], _stream(g.device)))


# ------------------------------------------------------------------- K1
def sorted_segment_sum_plain(msgs: torch.Tensor, seg: torch.Tensor,
                             n_segments: int) -> torch.Tensor:
    """K1's plain version: ``index_add_`` of the rows (f32 or bf16,
    up-cast to f32) into their segment, ids outside [0, n_segments)
    dropped. [n_segments, K] f32."""
    return segment_sum(msgs.float(), seg, n_segments)


def segment_offsets(seg: torch.Tensor, n_segments: int) -> torch.Tensor:
    """The CSR offsets [n_segments + 1] int32 of a sorted int32 id stream:
    segment s is [offs[s], offs[s + 1]); ids past the last segment (padding
    keys) lie past offs[-1]. One ``searchsorted``, on seg's device."""
    bounds = torch.arange(n_segments + 1, dtype=torch.int32,
                          device=seg.device)
    return torch.searchsorted(seg, bounds, out_int32=True)


def segment_counts(offs: torch.Tensor) -> torch.Tensor:
    """[n_segments] f32: the edges of each segment, offs[s + 1] -
    offs[s] — the segment-sum of a column of ones over the stream
    (padding and negative keys dropped alike), exact below 2^24, with no
    launch and no gradient."""
    return (offs[1:] - offs[:-1]).float()


def _sorted_segment_sum_forward(msgs, seg, n_segments, offs):
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
    if offs.dtype != torch.int32 or offs.shape != (n_segments + 1,):
        raise ValueError(f"offs must be the [{n_segments + 1}] int32 "
                         f"offsets of seg, got {offs.dtype} "
                         f"{tuple(offs.shape)}")
    launch_k1(msgs, offs, n_segments, out)
    _count(sorted_segment_sum, msgs.dtype)
    return out


class _SortedSegmentSum(torch.autograd.Function):
    """K1 forward, K4 backward (desco_tpu's ``sorted_segment_sum_ad``)."""

    @staticmethod
    def forward(ctx, msgs, seg, n_segments, offs):
        ctx.save_for_backward(seg)
        ctx.n_segments = n_segments
        ctx.msgs_dtype = msgs.dtype  # the cotangent follows the primal
        return _sorted_segment_sum_forward(msgs, seg, n_segments, offs)

    @staticmethod
    def backward(ctx, g):
        (seg,) = ctx.saved_tensors
        return segment_sum_vjp(g, seg, ctx.n_segments,
                               dtype=ctx.msgs_dtype), None, None, None


def sorted_segment_sum(msgs: torch.Tensor, seg: torch.Tensor,
                       n_segments: int, offs: torch.Tensor) -> torch.Tensor:
    """Segment-sum of a sorted stream: out[s] = sum of msgs[e] over the
    edges with seg[e] == s. msgs [E, K] f32 or bf16; seg [E] int32,
    ascending; ids >= n_segments (padding keys) and < 0 are dropped.
    Accumulates in f32 and returns [n_segments, K] f32 for either type.
    Differentiable in msgs (backward: K4, in msgs' dtype). ``offs``: the
    stream's [n_segments + 1] int32 offsets (``segment_offsets``), which
    the caller derives once per stream and shares between its sums; the
    plain version on the CPU does not read them."""
    return _SortedSegmentSum.apply(msgs, seg, n_segments, offs)


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


class _SortedGather(torch.autograd.Function):
    """K4 forward, K1 backward: the transpose of ``_SortedSegmentSum``."""

    @staticmethod
    def forward(ctx, table, seg, n_segments, offs):
        ctx.save_for_backward(seg)
        ctx.n_segments = n_segments
        ctx.offs = offs
        return segment_sum_vjp(table, seg, n_segments)

    @staticmethod
    def backward(ctx, g):
        (seg,) = ctx.saved_tensors
        return (_sorted_segment_sum_forward(g.contiguous(), seg,
                                            ctx.n_segments, ctx.offs),
                None, None, None)


def sorted_gather(table: torch.Tensor, seg: torch.Tensor,
                  n_segments: int, offs: torch.Tensor) -> torch.Tensor:
    """rows [E, K] f32: rows[e] = table[seg[e]] where 0 <= seg[e] <
    n_segments, else 0 (padding keys): a per-segment value handed back to
    the segment's rows. table [n_segments, K] f32; seg [E] int32,
    ascending. On the card K4's kernel; differentiable in table, the
    backward is K1 over the same keys (no atomics; ``offs`` as for
    ``sorted_segment_sum``)."""
    return _SortedGather.apply(table, seg, n_segments, offs)


# --------------------------------------------- K1 and K4 on an operand pair
def sorted_segment_sum_pair_plain(msgs: torch.Tensor, aux: torch.Tensor,
                                  seg: torch.Tensor, n_segments: int):
    """The pair's plain version: two ``sorted_segment_sum_plain`` calls,
    (msgs' sums [n_segments, K], aux's sums [n_segments]), f32."""
    return (sorted_segment_sum_plain(msgs, seg, n_segments),
            sorted_segment_sum_plain(aux[:, None], seg, n_segments)[:, 0])


def _pair_forward(msgs, aux, seg, n_segments, offs):
    if _on_cpu(msgs, aux, seg):
        return sorted_segment_sum_pair_plain(msgs, aux, seg, n_segments)
    _require_cuda(msgs, aux, seg, offs)
    _require(msgs, "msgs", ROW_DTYPES, 2)
    _require(aux, "aux", msgs.dtype, 1)
    _require(seg, "seg", torch.int32, 1)
    e, k = msgs.shape
    if seg.shape[0] != e or aux.shape[0] != e:
        raise ValueError(f"seg has {seg.shape[0]} ids and aux "
                         f"{aux.shape[0]} rows for {e} message rows")
    if k == 0:
        raise ValueError("the pair's messages need at least one column")
    if not 0 <= n_segments < 2 ** 31 - 1:
        raise ValueError(f"n_segments={n_segments} out of int32 range")
    if offs.dtype != torch.int32 or offs.shape != (n_segments + 1,):
        raise ValueError(f"offs must be the [{n_segments + 1}] int32 "
                         f"offsets of seg, got {offs.dtype} "
                         f"{tuple(offs.shape)}")
    out = torch.empty((n_segments, k), dtype=torch.float32,
                      device=msgs.device)
    aux_out = torch.empty(n_segments, dtype=torch.float32,
                          device=msgs.device)
    if n_segments:
        launch_k1_pair(msgs, aux, offs, n_segments, out, aux_out)
        _count(sorted_segment_sum_pair, msgs.dtype)
    return out, aux_out


class _SortedSegmentSumPair(torch.autograd.Function):
    """K1 on both operands in one launch; backward K4 on both, one
    launch."""

    @staticmethod
    def forward(ctx, msgs, aux, seg, n_segments, offs):
        ctx.save_for_backward(seg)
        ctx.n_segments = n_segments
        ctx.dtype = msgs.dtype
        return _pair_forward(msgs, aux, seg, n_segments, offs)

    @staticmethod
    def backward(ctx, g, g_aux):
        (seg,) = ctx.saved_tensors
        d, d_aux = segment_sum_vjp_pair(g, g_aux, seg, ctx.n_segments,
                                        dtype=ctx.dtype)
        return d, d_aux, None, None, None


def sorted_segment_sum_pair(msgs: torch.Tensor, aux: torch.Tensor,
                            seg: torch.Tensor, n_segments: int,
                            offs: torch.Tensor):
    """Two segment-sums over one sorted stream in one K1 launch: (out
    [n_segments, K] f32, the sums of msgs [E, K]; aux_out [n_segments]
    f32, the sums of aux [E]), as ``sorted_segment_sum`` computes each
    (GAT's softmax numerator and denominator); at K <= 16 the call makes
    two K1 launches, counted as one call of the pair. msgs and aux are f32
    or both bf16. Differentiable in both: the backward is one K4 launch that
    writes both cotangents from one read of seg. On the CPU the plain
    versions (two ``sorted_segment_sum_plain`` calls, two K4 gathers)."""
    return _SortedSegmentSumPair.apply(msgs, aux, seg, n_segments, offs)


sorted_segment_sum_pair.launches = 0
sorted_segment_sum_pair.launches_bf16 = 0


def segment_sum_vjp_pair_plain(g, g_aux, seg, n_segments: int,
                               dtype: Optional[torch.dtype] = None):
    """The pair's backward, plainly: two ``segment_sum_vjp_plain``
    gathers, ([E, K], [E]) in ``dtype`` (default: g's)."""
    return (segment_sum_vjp_plain(g, seg, n_segments, dtype),
            segment_sum_vjp_plain(g_aux[:, None], seg, n_segments,
                                  dtype)[:, 0])


def segment_sum_vjp_pair(g: torch.Tensor, g_aux: torch.Tensor,
                         seg: torch.Tensor, n_segments: int,
                         dtype: torch.dtype = torch.float32):
    """The cotangents of ``sorted_segment_sum_pair``'s operands: (d [E, K]
    with d[e] = g[seg[e]], d_aux [E] with d_aux[e] = g_aux[seg[e]]), 0
    where seg[e] is outside [0, n_segments), in ``dtype`` (the messages'),
    from one K4 launch on the card. g [n_segments, K] and g_aux
    [n_segments] f32 (made contiguous here)."""
    if dtype not in ROW_DTYPES:
        raise ValueError(f"the cotangent of K1's messages is f32 or bf16, "
                         f"not {dtype}")
    if _on_cpu(g, g_aux, seg):
        return segment_sum_vjp_pair_plain(g, g_aux, seg, n_segments, dtype)
    _require_cuda(g, g_aux, seg)
    g, g_aux = g.contiguous(), g_aux.contiguous()
    _require(g, "g", torch.float32, 2)
    _require(g_aux, "g_aux", torch.float32, 1)
    _require(seg, "seg", torch.int32, 1)
    if g.shape[0] != n_segments or g_aux.shape[0] != n_segments:
        raise ValueError(f"g has {g.shape[0]} rows and g_aux "
                         f"{g_aux.shape[0]} for {n_segments} segments")
    e, k = seg.shape[0], g.shape[1]
    if e >= 2 ** 31 - 1 or k == 0:
        raise ValueError(f"{e} rows of {k} columns: the pair takes fewer "
                         f"than 2^31 - 1 rows of at least one column")
    out = torch.empty((e, k), dtype=dtype, device=g.device)
    aux_out = torch.empty(e, dtype=dtype, device=g.device)
    if e == 0:
        return out, aux_out
    if n_segments == 0:
        return out.zero_(), aux_out.zero_()
    launch_k4_pair(g, g_aux, seg, n_segments, out, aux_out)
    _count(segment_sum_vjp_pair, dtype)
    return out, aux_out


segment_sum_vjp_pair.launches = 0
segment_sum_vjp_pair.launches_bf16 = 0


# ------------------------------------------------------- K2 and K3 streams
PAD_SKEY = 2 ** 30  # source key of dead edges, past every segment


@dataclasses.dataclass
class TypedStreams:
    """The index streams of one (dst,type)-sorted edge set, derived once
    per batch and shared by every layer and step that aggregates over it.

    ``fwd_toffs`` are the CSR offsets over the n_nodes*T (destination,
    type) runs of the stream: run d*T + t is [fwd_toffs[d*T + t],
    fwd_toffs[d*T + t + 1]), and the T runs of one destination are one
    contiguous range (K2 and the gather-fused K1 walk them). With a
    backward permutation (``edge_bwd_perm`` of ``pack_samples``, or one
    derived on the device: the edge slots in (src, type) order, dead edges
    last) the stream is CSR again over the n_rows*T (source, type) runs:
    ``bwd_rows`` is the destination of each permuted edge (the cotangent
    row K3 gathers), ``bwd_skey`` its source key src*T + type
    (``PAD_SKEY`` for dead edges), ``bwd_offs`` the offsets of the runs in
    it; ``bwd_keys`` = dst*T + type of each permuted edge (0 for dead
    edges: the cotangent row of [n_nodes*T, K] that the gather-fused
    backward reads) and ``bwd_soffs`` = bwd_offs[::T], one range per
    source, since a source's T runs are contiguous."""

    edge_src: torch.Tensor   # [E] i32
    keys: torch.Tensor       # [E] i32, dst*T + type, ascending
    n_types: int
    n_nodes: int             # output rows (destinations)
    n_rows: int              # rows of x (sources)
    fwd_toffs: torch.Tensor  # [n_nodes*T + 1] i32
    bwd_rows: Optional[torch.Tensor] = None   # [E] i32
    bwd_skey: Optional[torch.Tensor] = None   # [E] i32, ascending
    bwd_offs: Optional[torch.Tensor] = None   # [n_rows*T + 1] i32
    bwd_keys: Optional[torch.Tensor] = None   # [E] i32
    bwd_soffs: Optional[torch.Tensor] = None  # [n_rows + 1] i32


def typed_streams(edge_src: torch.Tensor, keys: torch.Tensor, n_types: int,
                  n_nodes: int, n_rows: int,
                  bwd_perm: Optional[torch.Tensor] = None) -> TypedStreams:
    """Derive a batch's ``TypedStreams``. With ``bwd_perm`` it checks, at
    the cost of one read-back per batch, that the permuted source keys
    ascend: a permutation that is not the (src, type) order with dead
    edges last would make K3 and the gather-fused backward sum wrong rows
    silently."""
    _require(edge_src, "edge_src", torch.int32, 1)
    _require(keys, "keys", torch.int32, 1)
    if edge_src.shape != keys.shape:
        raise ValueError("edge_src and keys differ in length")
    if n_rows == 0 or max(n_nodes + 1, n_rows) * n_types >= PAD_SKEY:
        raise ValueError(f"{n_rows} rows / {n_nodes} nodes x {n_types} "
                         f"types do not fit the kernel's int32 keys")
    st = TypedStreams(edge_src, keys, n_types, n_nodes, n_rows,
                      segment_offsets(keys, n_nodes * n_types))
    if bwd_perm is not None:
        _require(bwd_perm, "bwd_perm", torch.int32, 1)
        if bwd_perm.shape != keys.shape:
            raise ValueError("bwd_perm and keys differ in length")
        _add_backward_streams(st, bwd_perm.long(), check=True)
    return st


def _live_source_keys(src, keys, st: TypedStreams):
    """(src*T + type where the edge is live, else ``PAD_SKEY``; dst;
    type) of edges with sources ``src`` and keys ``keys`` (int64)."""
    t = st.n_types
    dst = torch.div(keys, t, rounding_mode="floor")
    typ = keys - dst * t
    live = ((keys >= 0) & (keys < st.n_nodes * t)
            & (src >= 0) & (src < st.n_rows))
    skey = torch.where(live, src * t + typ, torch.full_like(keys, PAD_SKEY))
    return skey, dst, typ


def derive_bwd_perm(st: TypedStreams) -> torch.Tensor:
    """[E] int32: the edge slots in (src, type) order with dead edges
    last, by a stable sort of src*T + type on the streams' device — the
    permutation ``pack_samples`` writes as ``edge_bwd_perm``, for batches
    packed without it."""
    skey, _, _ = _live_source_keys(st.edge_src.long(), st.keys.long(), st)
    return torch.sort(skey, stable=True).indices.int()


def _add_backward_streams(st: TypedStreams, perm: torch.Tensor,
                          check: bool) -> None:
    keys_p, src_p = st.keys.long()[perm], st.edge_src.long()[perm]
    skey, dst_p, typ_p = _live_source_keys(src_p, keys_p, st)
    if check and skey.numel() > 1 and not bool(
            (skey[1:] >= skey[:-1]).all()):
        raise ValueError(
            "bwd_perm does not put the edges in (src, type) order with "
            "dead edges last (pack_samples' edge_bwd_perm does)")
    t = st.n_types
    seg_bounds = torch.arange(st.n_rows * t + 1, dtype=torch.int32,
                              device=st.keys.device)
    rows = dst_p.clamp(0, max(st.n_nodes - 1, 0))
    st.bwd_rows = rows.int().contiguous()
    st.bwd_skey = skey.int().contiguous()
    st.bwd_offs = torch.searchsorted(st.bwd_skey, seg_bounds, out_int32=True)
    st.bwd_keys = torch.where(skey < PAD_SKEY, rows * t + typ_p,
                              torch.zeros_like(rows)).int().contiguous()
    st.bwd_soffs = st.bwd_offs[::t].contiguous()


def ensure_backward_streams(st: TypedStreams) -> TypedStreams:
    """``st`` with its source-sorted streams: a batch packed without
    ``edge_bwd_perm`` gets the permutation derived on its device
    (``derive_bwd_perm``), once, kept in ``st``."""
    if st.bwd_rows is None:
        _add_backward_streams(st, derive_bwd_perm(st).long(), check=False)
    return st


def tile_edge_ranges(offs: torch.Tensor, n_out: int,
                     n_types: int) -> torch.Tensor:
    """[n_tiles, 2] int64: the edge range [lo, hi) each K2 / K3 tile of
    ``TILE_ROWS`` output rows walks, from the per-(row, type) offsets
    ``offs`` [n_out*T + 1] (``fwd_toffs`` or ``bwd_offs``), as the kernels
    compute it. The ranges tile [0, offs[-1]), the live edges."""
    starts = torch.arange(0, n_out, TILE_ROWS, device=offs.device)
    lo = offs.long()[starts * n_types]
    hi = offs.long()[torch.clamp(starts + TILE_ROWS, max=n_out) * n_types]
    return torch.stack([lo, hi], dim=1)


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def _tile_width(n: int) -> int:
    """The padded width a K2 / K3 kernel instantiates for n columns."""
    return 32 if n <= 32 else (64 if n <= 64 else 128)


def _padded(t: torch.Tensor, shape) -> torch.Tensor:
    """``t`` itself where it already has ``shape`` and a 16-byte aligned
    start, else a zero tensor of ``shape`` with ``t`` in its leading
    corner."""
    shape = tuple(shape)
    if tuple(t.shape) == shape and t.data_ptr() % 16 == 0:
        return t
    out = t.new_zeros(shape)
    out[tuple(slice(0, n) for n in t.shape)] = t
    return out


def pad_operands(x: torch.Tensor, conv_w: torch.Tensor):
    """(x [N, h8], conv_w [T, h8, k8]): H and K rounded up to multiples
    of 8 with zero columns and rows, which add nothing to any product.
    The K2 / K3 wrappers hand these to the kernels (at the paper width,
    64, they are the tensors themselves) and write outputs of the real
    widths."""
    t, h, k = conv_w.shape
    h8, k8 = _round8(h), _round8(k)
    return (_padded(x, (x.shape[0], h8)), _padded(conv_w, (t, h8, k8)))


def _check_widths(h: int, k: int) -> None:
    if not 0 < h <= MAX_WIDTH or not 0 < k <= MAX_WIDTH:
        raise ValueError(f"the typed-aggregate kernels take widths 1..."
                         f"{MAX_WIDTH}, got H={h}, K={k}")


# ------------------------------------------------------------------- K2
def fused_typed_transform_aggregate_plain(
        x: torch.Tensor, edge_src: torch.Tensor, keys: torch.Tensor,
        conv_w: torch.Tensor, n_types: int, n_nodes: int) -> torch.Tensor:
    """K2's plain version: the f32 maths of the function, in K2's
    aggregate-first order. Decode dst = key // T and type = key mod T;
    A [n_nodes*T, H] = ``index_add_`` of the rows x[src] (up-cast to f32)
    over the live keys (padding keys >= n_nodes*T drop); then
    out = A.view(n_nodes, T*H) @ W.view(T*H, K) in f32. desco_tpu's
    ``_fused_legacy`` transforms first (z = x @ W) and, on bf16 rows,
    rounds z to bf16; this rounds nothing. [n_nodes, K] f32."""
    t, h, k = conv_w.shape
    keys = keys.long()
    live = (keys >= 0) & (keys < n_nodes * n_types)
    src = edge_src.long().clamp(0, x.shape[0] - 1)
    rows = x.float().index_select(0, src) * live[:, None]
    agg = segment_sum(rows, torch.where(live, keys, n_nodes * n_types),
                      n_nodes * n_types)
    return agg.view(n_nodes, n_types * h) @ conv_w.float().reshape(
        n_types * h, k)


def _fused_forward(x, conv_w, st: TypedStreams):
    if x.dtype != conv_w.dtype:
        raise ValueError(f"x is {x.dtype} and conv_w {conv_w.dtype}: K2 "
                         f"takes both in one type (f32 or bf16)")
    if _on_cpu(x, st.edge_src, st.keys, conv_w):
        return fused_typed_transform_aggregate_plain(
            x, st.edge_src, st.keys, conv_w, st.n_types, st.n_nodes)
    _require_cuda(x, st.edge_src, st.keys, conv_w, st.fwd_toffs)
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
    out = torch.empty((st.n_nodes, k), dtype=torch.float32, device=x.device)
    if st.n_nodes == 0 or k == 0:
        return out
    if h == 0:
        return out.zero_()
    _check_widths(h, k)
    launch_k2(*pad_operands(x, conv_w), st, out)
    _count(fused_typed_transform_aggregate, x.dtype)
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
    [N, H] and conv_w [T, H, K], both f32 or both bf16, H and K at most
    ``MAX_WIDTH`` on the card; the sum is accumulated and returned in f32
    for either.

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
    """u [n_rows*T, K] f32, u[s*T + t] = the sum of g[d] (f32 or bf16,
    up-cast) over the live type-t edges s -> d: ``index_select`` of the
    cotangent rows of the permuted edges, ``index_add_`` over their
    source keys. K3's plain version computes dx and dW from it; the
    kernel never writes it."""
    rows = g.float().index_select(0, st.bwd_rows.long())
    return segment_sum(rows, st.bwd_skey, st.n_rows * st.n_types)


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
    """(dx, dW) of K2 from the source-keyed sums of the output cotangent
    (desco_tpu's ``_bwd_perm``): U[s, t] = sum over the type-t edges
    s -> d of g[d], dx = sum_t U_t @ W_t^T, dW_t = x^T U_t, in the
    primals' dtypes. g [n_nodes, K] f32 (made contiguous here: autograd
    hands over expanded or strided cotangents), rounded to bf16 first for
    a bf16 tower; ``st`` carries a backward permutation. On the card: K3'
    (dx and the per-block dW partials) and the partials' reduction, two
    launches, counted as one call."""
    if st.bwd_rows is None:
        raise ValueError("the streams carry no backward permutation")
    if x.dtype != conv_w.dtype:
        raise ValueError(f"x is {x.dtype} and conv_w {conv_w.dtype}: K3 "
                         f"takes both in one type (f32 or bf16)")
    table = _cotangent_table(g, x)
    if _on_cpu(table, x, conv_w, st.bwd_rows):
        return typed_aggregate_bwd_plain(g, x, conv_w, st)
    _require_cuda(table, x, conv_w, st.bwd_rows, st.bwd_offs)
    table = table.contiguous()
    _require(table, "g", ROW_DTYPES, 2)
    _require(x, "x", ROW_DTYPES, 2)
    _require(conv_w, "conv_w", x.dtype, 3)
    t, h, k = conv_w.shape
    if (table.shape != (st.n_nodes, k) or x.shape != (st.n_rows, h)
            or t != st.n_types):
        raise ValueError(
            f"g {tuple(table.shape)}, x {tuple(x.shape)} and conv_w "
            f"{tuple(conv_w.shape)} do not match the streams' {st.n_nodes} "
            f"nodes, {st.n_rows} rows and {st.n_types} types")
    dx = torch.empty((st.n_rows, h), dtype=x.dtype, device=x.device)
    dw = torch.empty((t, h, k), dtype=conv_w.dtype, device=x.device)
    if h == 0 or k == 0 or st.n_nodes == 0:
        return dx.zero_(), dw.zero_()
    _check_widths(h, k)
    xp, wp = pad_operands(x, conv_w)
    gp = _padded(table, (st.n_nodes, wp.shape[2]))
    nb = k3_blocks(xp, wp, st)
    partial = torch.empty((nb, t, _tile_width(wp.shape[1]),
                           _tile_width(wp.shape[2])), dtype=torch.float32,
                          device=x.device)
    launch_k3(gp, xp, wp, st, dx, partial)
    launch_k3_reduce(partial, dw)
    _count(typed_aggregate_bwd, x.dtype)
    return dx, dw


typed_aggregate_bwd.launches = 0
typed_aggregate_bwd.launches_bf16 = 0


def typed_aggregate_bwd_plain(g, x, conv_w, st: TypedStreams):
    """K3's plain version, the f32 maths of ``_bwd_perm``: u by
    ``typed_cotangent_sums_plain`` of the cotangent table, then the two
    einsums in f32, returned in the primals' dtypes."""
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


# ------------------------------------------------- K1 with the gather fused
def gather_rows_segment_sum_plain(x: torch.Tensor,
                                  rows: Optional[torch.Tensor],
                                  offs: torch.Tensor,
                                  n_segments: int) -> torch.Tensor:
    """K1's plain version in its general form: out[r] = the sum of
    x[rows[e]] (up-cast to f32) over e in [offs[r], offs[r+1]), rows None
    the identity; ``index_select`` of the rows, ``index_add_`` by the
    segment each edge's position falls in (edges outside [offs[0],
    offs[-1]) drop). [n_segments, K] f32."""
    if x.shape[0] == 0:
        return x.new_zeros((n_segments, x.shape[1]), dtype=torch.float32)
    n_edges = x.shape[0] if rows is None else rows.shape[0]
    pos = torch.arange(n_edges, device=x.device)
    seg = torch.searchsorted(offs.long(), pos, right=True) - 1
    src = pos if rows is None else rows.long().clamp(0, x.shape[0] - 1)
    return segment_sum(x.float().index_select(0, src), seg, n_segments)


def gather_segment_sum_plain(x: torch.Tensor,
                             st: "TypedStreams") -> torch.Tensor:
    """The gather-fused K1's plain twin: ``index_select`` of the x rows
    by edge source, then ``segment_sum`` by key dst*T + type (padding keys
    drop), with autograd's backward (an ``index_add_``). [n_nodes*T, K]
    f32."""
    msgs = x.index_select(0, st.edge_src.long())
    return segment_sum(msgs, st.keys, st.n_nodes * st.n_types)


def gather_segment_sum_bwd_plain(g: torch.Tensor, st: "TypedStreams",
                                 dtype: torch.dtype = torch.float32
                                 ) -> torch.Tensor:
    """dx of ``gather_segment_sum_plain`` as autograd computes it, read
    off the (dst, type) stream and not the source-sorted one: the
    cotangent rows g[key] of the live edges (``index_select``), summed
    into their sources by ``index_add_``. [n_rows, K] in ``dtype``."""
    n_seg = st.n_nodes * st.n_types
    keys = st.keys.long()
    live = (keys >= 0) & (keys < n_seg)
    dx = g.new_zeros((st.n_rows, g.shape[1]), dtype=torch.float32)
    if n_seg:
        rows = g.float().index_select(0, keys.clamp(0, n_seg - 1))
        dx.index_add_(0, st.edge_src.long(), rows * live[:, None])
    return dx.to(dtype)


def _gather_forward(x, st: "TypedStreams"):
    _require_cuda(x, st.edge_src, st.fwd_toffs)
    _require(x, "x", ROW_DTYPES, 2)
    if x.shape[0] != st.n_rows:
        raise ValueError(f"x has {x.shape[0]} rows, the streams were "
                         f"derived for {st.n_rows}")
    n_seg, k = st.n_nodes * st.n_types, x.shape[1]
    out = torch.empty((n_seg, k), dtype=torch.float32, device=x.device)
    if n_seg == 0 or k == 0:
        return out
    launch_k1(x, st.fwd_toffs, n_seg, out, rows=st.edge_src)
    _count(gather_segment_sum, x.dtype)
    return out


class _GatherSegmentSum(torch.autograd.Function):
    """The gather-fused K1 forward over the (dst, type) stream; backward:
    the same kernel over the source-sorted stream."""

    @staticmethod
    def forward(ctx, x, st):
        ctx.streams = st
        ctx.x_dtype = x.dtype
        return _gather_forward(x, st)

    @staticmethod
    def backward(ctx, g):
        return gather_segment_sum_bwd(g, ctx.streams, ctx.x_dtype), None


def gather_segment_sum(x: torch.Tensor, st: "TypedStreams") -> torch.Tensor:
    """out [n_nodes*T, K] f32, out[d*T + t] = the sum of x[src] over the
    type-t edges src -> d of the streams (desco_tpu's "one fused gather +
    segment-sum", ``typed_edge_aggregate``). x [n_rows, K] f32 or bf16,
    summed in f32. On the card one launch of K1 with the edge sources as
    its rows and ``fwd_toffs`` as its offsets: no [E, K] messages.
    Differentiable in x: the backward (``gather_segment_sum_bwd``) is the
    same kernel over the source-sorted stream, deterministic, dx in x's
    dtype. CPU tensors take the plain twin and autograd."""
    if _on_cpu(x, st.edge_src):
        return gather_segment_sum_plain(x, st)
    return _GatherSegmentSum.apply(x.contiguous(), st)


gather_segment_sum.launches = 0
gather_segment_sum.launches_bf16 = 0


def gather_segment_sum_bwd(g: torch.Tensor, st: "TypedStreams",
                           dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """dx [n_rows, K] of ``gather_segment_sum``: dx[s] = the sum over t
    and over the type-t edges s -> d of g[d*T + t], in ``dtype`` (x's).
    g [n_nodes*T, K] f32 (made contiguous here: autograd hands over
    strided cotangents). On the card: K1 with ``bwd_keys`` as its rows and
    ``bwd_soffs`` as its offsets (derived first where the batch carries no
    permutation), one write of dx, no atomics; dead edges sort last and
    are never read. CPU tensors take K1's plain version over the same
    stream."""
    if dtype not in ROW_DTYPES:
        raise ValueError(f"dx of the gather-fused K1 is f32 or bf16, not "
                         f"{dtype}")
    ensure_backward_streams(st)
    if _on_cpu(g, st.bwd_keys):
        return gather_rows_segment_sum_plain(
            g, st.bwd_keys, st.bwd_soffs, st.n_rows).to(dtype)
    _require_cuda(g, st.bwd_keys, st.bwd_soffs)
    g = g.contiguous()
    _require(g, "g", torch.float32, 2)
    if g.shape[0] != st.n_nodes * st.n_types:
        raise ValueError(f"g has {g.shape[0]} rows for {st.n_nodes} nodes "
                         f"x {st.n_types} types")
    dx = torch.empty((st.n_rows, g.shape[1]), dtype=torch.float32,
                     device=g.device)
    if g.shape[1] == 0:
        return dx.to(dtype)
    launch_k1(g, st.bwd_soffs, st.n_rows, dx, rows=st.bwd_keys)
    _count(gather_segment_sum_bwd, dtype)
    return dx.to(dtype)


gather_segment_sum_bwd.launches = 0
gather_segment_sum_bwd.launches_bf16 = 0


# every kernel wrapper of this module, for launch accounting
KERNELS = (sorted_segment_sum, fused_typed_transform_aggregate,
           typed_aggregate_bwd, segment_sum_vjp, gather_segment_sum,
           gather_segment_sum_bwd, sorted_segment_sum_pair,
           segment_sum_vjp_pair)


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


def add_launches(counts: dict, times: int = 1) -> None:
    """Add ``times`` x ``counts`` (``read_launches``' keys) to the
    counters."""
    for kern in KERNELS:
        kern.launches += times * counts[kern.__name__]
        kern.launches_bf16 += times * counts[kern.__name__ + "_bf16"]


class LaunchRecord:
    """The launches of a region captured into a CUDA graph: a capture
    runs no kernel and a replay runs no wrapper, so ``capture()`` keeps
    what the wrappers counted while it recorded and puts the counters
    back, and every ``replayed()`` adds it, as an eager run of the region
    would count."""

    def __init__(self):
        self.counts = {name: 0 for name in read_launches()}

    @contextlib.contextmanager
    def capture(self):
        before = read_launches()
        yield self
        after = read_launches()
        self.counts = {k: after[k] - before[k] for k in after}
        reset_launches()
        add_launches(before)

    def replayed(self, times: int = 1) -> None:
        add_launches(self.counts, times)
