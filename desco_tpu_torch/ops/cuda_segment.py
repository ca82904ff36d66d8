"""The port's hand-written CUDA kernels, with their plain PyTorch twins.

K1 ``sorted_segment_sum`` replaces desco_tpu's Pallas
``pallas_sorted_segment_sum`` (desco_tpu/ops/pallas_segment.py:310, bodies
``_segsum_kernel_v2`` :201 and ``_segsum_kernel`` :72). K2
``fused_typed_transform_aggregate`` replaces desco_tpu's
``fused_typed_transform_aggregate`` -> ``_fused_legacy`` (:476, :500), the
SHMP target tower's typed aggregation, run 8 times per packed batch.

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
paper width (PERF.md has the measured times beside both bounds).

What the design does about it: a sorted stream is CSR, so one
``torch.searchsorted`` gives the row offsets (as the JAX wrapper does at
pallas_segment.py:345) and padding keys sort past the last offset, dropped
without a pass. One warp owns one segment and reads its rows in order
with float2/float4 loads, summing in f32 registers: every output row is
written once, with no atomics and a deterministic order. K2 decodes each
edge's type from its key and gathers its z row inside the reduction, so
the [E, K] message tensor that ``_fused_legacy`` writes and reads back
never exists. None of the TPU kernel's structure (one-hot MXU matmuls,
128-lane padding, SEG_TILE/CE/GSZ tiles, VMEM guard) is carried over.

Inputs are f32 and accumulate in f32 (desco_tpu's Pallas kernel reduces
bf16 messages). The kernels have no backward yet (desco_tpu's ``_bwd_perm``,
K3 in ROADMAP.md): a CUDA input that requires grad raises.

Each wrapper takes its plain version only for CPU tensors; a CUDA tensor
launches the kernel or raises. Each counts its launches in a plain int
attribute (``sorted_segment_sum.launches``) so a run can show that the
main path went through the kernel. The library is built from
``csrc/segment_sum.cu`` with nvcc at first use, into
``desco_tpu_torch/build/kernels/`` (listed in .gitignore); nothing here
touches CUDA when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

from .segment import segment_sum, typed_transform_aggregate

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "segment_sum.cu")
_BUILD_DIR = os.path.join(_PKG_DIR, "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lib = None
_lock = threading.Lock()
build_seconds = 0.0  # time the last build in this process took (0: cached)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of "
        "desco_tpu_torch are built from csrc/segment_sum.cu at first use")


def build() -> str:
    """Compile the kernel library if this source and these flags have no
    build yet; return its path. The file name carries a digest of both,
    and the rename is atomic, so concurrent processes share one build."""
    global build_seconds
    with open(SOURCE, "rb") as f:
        src = f.read()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    so_path = os.path.join(_BUILD_DIR, f"libdesco_segment-{tag}.so")
    if os.path.exists(so_path) and os.path.getsize(so_path) > 0:
        return so_path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {SOURCE}:\n{proc.stderr[-4000:]}")
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    build_seconds = time.perf_counter() - t0
    return so_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.desco_segment_sum_abi_version.restype = i
            if lib.desco_segment_sum_abi_version() != 1:
                raise RuntimeError("segment_sum kernel ABI mismatch")
            lib.desco_cuda_error_string.restype = ctypes.c_char_p
            lib.desco_cuda_error_string.argtypes = [i]
            lib.desco_sorted_segment_sum.restype = i
            lib.desco_sorted_segment_sum.argtypes = [p, p, i, i, p, p]
            lib.desco_fused_typed_gather_segsum.restype = i
            lib.desco_fused_typed_gather_segsum.argtypes = [
                p, p, p, p, i, i, i, i, p, p]
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
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            "the CUDA segment-sum kernels have no backward yet (desco_tpu's "
            "_bwd_perm, K3 in ROADMAP.md): call them under "
            "torch.inference_mode()")


def _require(t: torch.Tensor, name: str, dtype, ndim: int) -> None:
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {ndim}-d {dtype} tensor, got "
            f"{t.dtype} of shape {tuple(t.shape)}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def _check(rc: int) -> None:
    if rc != 0:
        msg = library().desco_cuda_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel launch failed: {msg} ({rc})")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# ------------------------------------------------------------------- K1
def sorted_segment_sum_plain(msgs: torch.Tensor, seg: torch.Tensor,
                             n_segments: int) -> torch.Tensor:
    """K1's plain version: ``index_add_`` of the rows into their segment,
    ids outside [0, n_segments) dropped. [n_segments, K] f32."""
    return segment_sum(msgs.float(), seg, n_segments)


def sorted_segment_sum(msgs: torch.Tensor, seg: torch.Tensor,
                       n_segments: int) -> torch.Tensor:
    """Segment-sum of a sorted stream: out[s] = sum of msgs[e] over the
    edges with seg[e] == s. msgs [E, K] f32; seg [E] int32, ascending;
    ids >= n_segments (padding keys) and < 0 are dropped. Returns
    [n_segments, K] f32."""
    if _on_cpu(msgs, seg):
        return sorted_segment_sum_plain(msgs, seg, n_segments)
    _require_cuda(msgs, seg)
    _require(msgs, "msgs", torch.float32, 2)
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
    with torch.cuda.device(msgs.device):
        rc = library().desco_sorted_segment_sum(
            msgs.data_ptr(), offs.data_ptr(), n_segments, k,
            out.data_ptr(), _stream(msgs.device))
    _check(rc)
    sorted_segment_sum.launches += 1
    return out


sorted_segment_sum.launches = 0


# ------------------------------------------------------------------- K2
def fused_typed_transform_aggregate_plain(
        x: torch.Tensor, edge_src: torch.Tensor, keys: torch.Tensor,
        conv_w: torch.Tensor, n_types: int, n_nodes: int) -> torch.Tensor:
    """K2's plain version, ``_fused_legacy`` in f32: decode dst = key // T
    and type = key mod T, then ``typed_transform_aggregate`` (transform,
    gather into edge order, ``index_add_`` over dst)."""
    keys = keys.long()
    dst = torch.div(keys, n_types, rounding_mode="floor")
    out = typed_transform_aggregate(x, conv_w, edge_src, dst,
                                    keys - dst * n_types, n_types)
    n = x.shape[0]
    if n_nodes <= n:  # rows of dst in [n_nodes, n) are dropped
        return out[:n_nodes]
    return torch.cat([out, out.new_zeros((n_nodes - n, out.shape[1]))])


def fused_typed_transform_aggregate(
        x: torch.Tensor, edge_src: torch.Tensor, keys: torch.Tensor,
        conv_w: torch.Tensor, n_types: int, n_nodes: int) -> torch.Tensor:
    """x_neigh [n_nodes, K]: sum over (dst,type)-sorted edges of
    x[src] @ W[type]. keys [E] int32 = dst*T + type, ascending; padding
    keys >= n_nodes*T decode past the last node and are dropped. x
    [N, H] f32 with x[pad node] == 0; conv_w [T, H, K] f32."""
    if _on_cpu(x, edge_src, keys, conv_w):
        return fused_typed_transform_aggregate_plain(
            x, edge_src, keys, conv_w, n_types, n_nodes)
    _require_cuda(x, edge_src, keys, conv_w)
    _require(x, "x", torch.float32, 2)
    _require(conv_w, "conv_w", torch.float32, 3)
    _require(edge_src, "edge_src", torch.int32, 1)
    _require(keys, "keys", torch.int32, 1)
    n, h = x.shape
    if conv_w.shape[0] != n_types or conv_w.shape[1] != h:
        raise ValueError(f"conv_w {tuple(conv_w.shape)} does not match "
                         f"{n_types} types of width {h}")
    if edge_src.shape != keys.shape:
        raise ValueError("edge_src and keys differ in length")
    if n == 0 or max(n_nodes + 1, n) * n_types >= 2 ** 31:
        raise ValueError(f"{n} rows / {n_nodes} nodes x {n_types} types "
                         f"do not fit the kernel's int32 keys")
    k = conv_w.shape[2]
    z = torch.matmul(x, conv_w).contiguous()  # [T, N, K], f32 (TF32 off)
    out = torch.empty((n_nodes, k), dtype=torch.float32, device=x.device)
    if n_nodes == 0 or k == 0:
        return out
    bounds = torch.arange(n_nodes + 1, dtype=torch.int32,
                          device=x.device) * n_types
    offs = torch.searchsorted(keys, bounds, out_int32=True)
    with torch.cuda.device(x.device):
        rc = library().desco_fused_typed_gather_segsum(
            z.data_ptr(), edge_src.data_ptr(), keys.data_ptr(),
            offs.data_ptr(), n_nodes, n, n_types, k, out.data_ptr(),
            _stream(x.device))
    _check(rc)
    fused_typed_transform_aggregate.launches += 1
    return out


fused_typed_transform_aggregate.launches = 0

# every kernel wrapper of this module, for launch accounting
KERNELS = (sorted_segment_sum, fused_typed_transform_aggregate)
