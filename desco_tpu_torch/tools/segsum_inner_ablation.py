"""K5 — which part of the sorted segment-sum kernel (K1) costs on the GPU:
stripped variants of its inner loop timed on the bench edge stream, and
the shipped kernels K1-K4 timed the same way.

    python -m desco_tpu_torch.tools.segsum_inner_ablation [--seed 0]
        [--out output/segsum_inner_ablation.json]

The port of the repo's ``analysis/segsum_inner_ablation.py``, which strips
the Pallas kernel's inner loop in steps down to its DMA floor (window
search, one-hot build, MXU matmul). The CUDA K1 has none of those parts;
its parts are the CSR offsets with their ragged per-segment loops, the
convert-and-add chain in registers, and the row stream itself. The
variants strip these in turn (``csrc/segment_sum_probe.cu``, one
instantiation of K1's own kernel template per mode). Some are WRONG as a
segment-sum by design: this is a timing probe. Each is still a defined
function of its inputs, with a plain PyTorch version beside it:

  full    ``probe_full(msgs, seg, n)``: K1 itself on bf16 rows, bit-equal
          to ``sorted_segment_sum``.
  nooffs  ``probe_nooffs``: no offsets, no ragged loop. With run =
          ceil(E / n), out[w] = f32 sum of msgs[w*run : min((w+1)*run, E)].
  noacc   ``probe_noacc``: nooffs with convert-and-add replaced by an OR
          of the rows' raw 16-bit patterns; out[w, c] is the OR-ed
          pattern of column c over the run, as a number in 0..65535.
  stream  ``probe_stream``: the floor for these bytes. Returns (out,
          check): out [n, K] f32 all zeros, check int32 [1] the OR of all
          32-bit words of msgs, read once with grid-stride 16-byte loads.

Inputs as the JAX script: the bench batch's (dst, type)-sorted edge
stream (``bench.build_workload``), segments = destination nodes (n =
``batch.n_cap``, padding edges keyed 2^30), messages bf16 [e_cap, 128]
from numpy seed 0; and the same at K = 64, the paper width.

Timing: 8 launches captured in one CUDA graph (the counterpart of the JAX
script's "8 calls inside one jit": no Python between launches), replayed
in a CUDA-event-timed loop, median of three series. Two series per
variant: "hot" re-reads one copy of the stream, which at these sizes fits
the card's 50 MB L2; "cold" rotates over copies that together exceed
twice the L2, so every launch reads from device memory. Beside each time
stands the bytes bound: the rows the variant reads + the ids + the f32
output over the card's memory rate.

The shipped kernels: ``kernel_cases`` builds K1-K4's inputs in f32 and
bf16 at the shapes of real packed batches (a serving target batch, its
gossip batch, a training batch) and ``time_cases`` times each bare kernel
launch, and each whole function as the model calls it, in CUDA graphs
(K2 is one launch, so its two times are one; K3's function adds the
launch that sums its per-block dW partials; the gather-fused K1, forward
and backward, beside the ``index_select`` + K1 and K4 + ``index_add_``
composition it replaced).
chip_smoke.py uses both on its own batches. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import threading
from typing import Callable, Dict

import numpy as np
import torch

from ..ops import cuda_build
from ..ops import cuda_segment as cs

STEM = "desco_segment_probe"
SOURCE = cuda_build.source_path(STEM)
PAD_KEY = 2 ** 30
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
L2_BYTES = 50e6
MODES = {"full": 0, "nooffs": 1, "noacc": 2}

_lib = None
_lock = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded probe library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(cuda_build.build(STEM))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.desco_probe_abi_version.restype = i
            if lib.desco_probe_abi_version() != 1:
                raise RuntimeError("segment_sum_probe ABI mismatch")
            lib.desco_probe_segsum.restype = i
            lib.desco_probe_segsum.argtypes = [p, p, i, i, i, i, i, p, p]
            lib.desco_probe_stream.restype = i
            lib.desco_probe_stream.argtypes = [p, ll, p, ll, p, p]
            _lib = lib
        return _lib


# ------------------------------------------------------------ plain versions
def _run_len(e: int, n_segments: int) -> int:
    return -(-e // max(n_segments, 1))


def _runs(msgs: torch.Tensor, n_segments: int) -> torch.Tensor:
    """msgs zero-padded and cut into the fixed runs: [n, run, K]."""
    e, k = msgs.shape
    run = _run_len(e, n_segments)
    pad = msgs.new_zeros((n_segments * run, k))
    pad[:min(e, n_segments * run)] = msgs[:n_segments * run]
    return pad.view(n_segments, run, k)


def _or_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise OR along ``dim`` (torch has no such reduction)."""
    out = None
    for piece in x.unbind(dim):
        out = piece if out is None else out | piece
    return out


def probe_full_plain(msgs, seg, n_segments):
    return cs.sorted_segment_sum_plain(msgs, seg, n_segments)


def probe_nooffs_plain(msgs, seg, n_segments):
    return _runs(msgs, n_segments).float().sum(dim=1)


def probe_noacc_plain(msgs, seg, n_segments):
    bits = _runs(msgs, n_segments).view(torch.int16).int() & 0xFFFF
    if bits.shape[1] == 0:
        return msgs.new_zeros((n_segments, msgs.shape[1]),
                              dtype=torch.float32)
    return _or_reduce(bits, 1).float()


def probe_stream_plain(msgs, seg, n_segments):
    words = msgs.reshape(-1).view(torch.int32)
    # OR of all words: fold the array in halves (a zero pads an odd half)
    while words.numel() > 1:
        half = (words.numel() + 1) // 2
        lo, hi = words[:half], words[half:]
        if hi.numel() < half:
            hi = torch.cat([hi, hi.new_zeros(half - hi.numel())])
        words = lo | hi
    check = words.clone() if words.numel() else words.new_zeros(1)
    out = msgs.new_zeros((n_segments, msgs.shape[1]), dtype=torch.float32)
    return out, check


# ------------------------------------------------------------------ launches
def launch_segsum(mode: str, msgs, offs, n_segments: int, out) -> None:
    """Bare launch of one of the modes of K1's kernel template."""
    e, k = msgs.shape
    with torch.cuda.device(msgs.device):
        cs._check(library().desco_probe_segsum(
            msgs.data_ptr(), offs.data_ptr(), MODES[mode], n_segments, k,
            _run_len(e, n_segments), e, out.data_ptr(),
            cs._stream(msgs.device)))


def launch_stream(msgs, out, check) -> None:
    with torch.cuda.device(msgs.device):
        cs._check(library().desco_probe_stream(
            msgs.data_ptr(), msgs.numel() * msgs.element_size(),
            out.data_ptr(), out.numel(), check.data_ptr(),
            cs._stream(msgs.device)))


def _check_inputs(msgs, seg, n_segments) -> None:
    cs._require_cuda(msgs, seg)
    cs._require(msgs, "msgs", torch.bfloat16, 2)
    cs._require(seg, "seg", torch.int32, 1)
    if seg.shape[0] != msgs.shape[0]:
        raise ValueError(f"seg has {seg.shape[0]} ids for "
                         f"{msgs.shape[0]} message rows")
    if not 0 < n_segments < 2 ** 31 - 1 or msgs.shape[1] == 0:
        raise ValueError("the probe wants at least one segment and column")


def _segsum_variant(mode: str, plain: Callable) -> Callable:
    def variant(msgs: torch.Tensor, seg: torch.Tensor, n_segments: int):
        if cs._on_cpu(msgs, seg):
            return plain(msgs, seg, n_segments)
        _check_inputs(msgs, seg, n_segments)
        out = torch.empty((n_segments, msgs.shape[1]), dtype=torch.float32,
                          device=msgs.device)
        launch_segsum(mode, msgs, cs.segment_offsets(seg, n_segments),
                      n_segments, out)
        variant.launches += 1
        return out

    variant.launches = 0
    variant.__name__ = f"probe_{mode}"
    variant.__doc__ = (f"The ``{mode}`` variant of K1 (module docs): msgs "
                       f"bf16 [E, K], seg int32 [E] ascending -> f32 "
                       f"[n_segments, K]. Plain version on CPU tensors.")
    return variant


probe_full = _segsum_variant("full", probe_full_plain)
probe_nooffs = _segsum_variant("nooffs", probe_nooffs_plain)
probe_noacc = _segsum_variant("noacc", probe_noacc_plain)


def probe_stream(msgs: torch.Tensor, seg: torch.Tensor, n_segments: int):
    """The ``stream`` variant (module docs): (out [n_segments, K] f32 of
    zeros, check int32 [1] = OR of all 32-bit words of msgs). The stream
    must be a multiple of 16 bytes and K of 4."""
    if cs._on_cpu(msgs, seg):
        return probe_stream_plain(msgs, seg, n_segments)
    _check_inputs(msgs, seg, n_segments)
    if (msgs.numel() * 2) % 16 or msgs.shape[1] % 4:
        raise ValueError("probe_stream reads 16-byte pieces: E*K*2 must be "
                         "a multiple of 16 and K of 4")
    out = torch.empty((n_segments, msgs.shape[1]), dtype=torch.float32,
                      device=msgs.device)
    check = torch.zeros(1, dtype=torch.int32, device=msgs.device)
    launch_stream(msgs, out, check)
    probe_stream.launches += 1
    return out, check


probe_stream.launches = 0

VARIANTS: Dict[str, Callable] = {
    "full": probe_full, "nooffs": probe_nooffs, "noacc": probe_noacc,
    "stream": probe_stream}
PLAIN: Dict[str, Callable] = {
    "full": probe_full_plain, "nooffs": probe_nooffs_plain,
    "noacc": probe_noacc_plain, "stream": probe_stream_plain}


# -------------------------------------------------------------------- timing
def graph_us(launch: Callable[[int], None], n_launch: int = 8,
             min_ms: float = 60.0) -> float:
    """Microseconds per launch: ``launch(i)`` for i in 0..n_launch-1 is
    captured in one CUDA graph and the graph replayed in an event-timed
    loop of at least ``min_ms``; the median of three loops."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream
        for i in range(n_launch):
            launch(i)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_launch):
            launch(i)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def loop(reps: int) -> float:
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    loop(3)
    reps = max(3, int(min_ms / max(loop(3) / 3, 1e-3)))
    series = sorted(loop(reps) for _ in range(3))
    return series[1] * 1e3 / (reps * n_launch)


def bench_stream(device, k: int, seed: int = 0):
    """(msgs bf16 [e_cap, k], seg int32 [e_cap], n): the bench batch's
    (dst, type)-sorted edge stream keyed by destination, padding edges
    keyed 2^30, messages from numpy ``seed``."""
    from ..bench import build_workload

    batch, _ = build_workload()
    n = batch.n_cap
    dst = np.asarray(batch.edge_dst, np.int64).copy()
    dst[np.asarray(batch.edge_type) >= 6] = PAD_KEY
    if not bool(np.all(np.diff(dst) >= 0)):
        raise RuntimeError("the bench edge stream is not sorted by dst")
    msgs = np.random.default_rng(seed).standard_normal(
        (dst.shape[0], k)).astype(np.float32)
    return (torch.from_numpy(msgs).to(device).to(torch.bfloat16),
            torch.from_numpy(dst.astype(np.int32)).to(device), n)


def time_variants(msgs, seg, n: int) -> dict:
    """Hot and cold µs per call of the four variants, with their bounds."""
    e, k = msgs.shape
    dev = msgs.device
    offs = cs.segment_offsets(seg, n)
    e_live = int(offs[-1])
    stream_bytes = e * k * 2
    n_copies = int(2 * L2_BYTES // stream_bytes) + 2
    copies = [msgs] + [msgs.clone() for _ in range(n_copies - 1)]
    outs = [torch.empty((n, k), dtype=torch.float32, device=dev)
            for _ in range(2)]
    check = torch.zeros(1, dtype=torch.int32, device=dev)
    rows = {}
    for name in VARIANTS:
        if name == "stream":
            def launch(i, hot):
                launch_stream(copies[0 if hot else i % n_copies],
                              outs[i % 2], check)
        else:
            def launch(i, hot, name=name):
                launch_segsum(name, copies[0 if hot else i % n_copies],
                              offs, n, outs[i % 2])
        read_rows = e_live if name == "full" else e
        bytes_ = read_rows * k * 2 + e * 4 + n * k * 4
        rows[name] = {
            "hot_us": graph_us(lambda i: launch(i, True)),
            "cold_us": graph_us(lambda i: launch(i, False)),
            "bound_us": bytes_ / HBM_BYTES_PER_S * 1e6,
            "bytes": bytes_,
        }
    return {"e": e, "k": k, "n_segments": n, "e_live": e_live,
            "stream_bytes": stream_bytes, "copies_cold": n_copies,
            "variants": rows}


def probe_series(device, k: int, seed: int = 0, log=print) -> dict:
    """One series of the probe at width ``k`` on the bench stream: every
    variant through its wrapper once (``full`` must equal K1 bit for
    bit), then the hot and cold timings."""
    msgs, seg, n = bench_stream(device, k, seed)
    with torch.inference_mode():
        outs = {name: fn(msgs, seg, n) for name, fn in VARIANTS.items()}
        if not torch.equal(outs["full"], cs.sorted_segment_sum(
                msgs, seg, n, cs.segment_offsets(seg, n))):
            raise RuntimeError("probe_full is not bit-equal to K1")
        row = time_variants(msgs, seg, n)
    log(f"bench stream: msgs bf16 [{row['e']}, {k}] "
        f"({row['stream_bytes'] / 1e6:.1f} MB, {row['e_live']} live rows), "
        f"{n} segments; cold series over {row['copies_cold']} copies")
    for name, r in row["variants"].items():
        log(f"{name:>7}: {r['hot_us']:8.2f} us hot  {r['cold_us']:8.2f} us "
            f"cold  bound {r['bound_us']:6.2f} us ({r['bytes'] / 1e6:.1f} "
            f"MB over 3.35 TB/s)")
    return row


# ------------------------------------------------- the shipped kernels K1-K4
def kernel_cases(tb, gb, trb, conv_w) -> dict:
    """K1-K4's inputs at the shapes of real packed batches, f32: ``tb`` a
    serving target batch, ``gb`` a gossip batch, ``trb`` a training batch
    (with ``edge_bwd_perm``), all on the card; ``conv_w`` [T, H, K] f32.
    The gather-fused K1 at the gossip layer-0 aggregation (x [n_cap, 128]
    over 2 * n_cap (node, direction) segments, and its backward from a
    cotangent [2 * n_cap, 128]; the gossip batch's permutation is derived
    on the card when it was packed without one); K1 and K4 at the target
    tower's pooling (K = 576)."""
    from ..models.shmp_gnn import batch_typed_streams

    dev = conv_w.device
    t, h, k = conv_w.shape
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    return {
        "gossip": dict(x=randn(gb.n_cap, 128) * gb.node_mask[:, None],
                       g=randn(2 * gb.n_cap, 128),
                       st=cs.ensure_backward_streams(
                           batch_typed_streams(gb, 2))),
        "k1_pool": dict(msgs=randn(tb.n_cap, 576) * tb.node_mask[:, None],
                        seg=tb.node_graph.int().contiguous(), n=tb.g_cap),
        "k2": dict(x=randn(tb.n_cap, h) * tb.node_mask[:, None], w=conv_w,
                   st=batch_typed_streams(tb, t)),
        "k3": dict(g=randn(trb.n_cap, k),
                   x=randn(trb.n_cap, h) * trb.node_mask[:, None], w=conv_w,
                   st=batch_typed_streams(trb, t)),
        "k4_pool": dict(g=randn(trb.g_cap, 576),
                        seg=trb.node_graph.int().contiguous()),
    }


def gather_old_forward(x, st):
    """What the gossip aggregation ran before K1 took the gather: the
    [E, K] messages by ``index_select``, then K1 over the keys."""
    return cs.sorted_segment_sum(x.index_select(0, st.edge_src.long()),
                                 st.keys, st.n_nodes * st.n_types,
                                 st.fwd_toffs)


def gather_old_backward(g, st, dtype):
    """... and its backward: K4 writes the [E, K] message cotangents,
    ``index_add_`` (atomic, in ``dtype``) scatters them into dx."""
    d = cs.segment_sum_vjp(g, st.keys, st.n_nodes * st.n_types, dtype=dtype)
    dx = torch.zeros((st.n_rows, g.shape[1]), dtype=dtype, device=g.device)
    return dx.index_add_(0, st.edge_src.long(), d)


def time_cases(cases: dict) -> dict:
    """CUDA-graph µs per call of K1-K4 in f32 and bf16: ``alone_us`` is
    the bare kernel launch on prepared inputs, ``function_us`` the whole
    function as the model calls it (K1 at the pooling: offsets + kernel;
    the gather-fused K1 and its backward: the wrapper, which reads
    offsets derived once per batch, and ``old_us`` the composition it
    replaced, ``index_select`` + K1 and K4 + ``index_add_``; K2: the
    kernel, so alone = function; K3: the kernel and its dW reduction
    launch, alone = the kernel without the reduction; K4: the kernel)."""
    out = {}
    bf = torch.bfloat16
    for dname, dtype in (("f32", torch.float32), ("bf16", bf)):
        c = cases["k1_pool"]
        msgs, seg, n = c["msgs"].to(dtype), c["seg"], c["n"]
        offs = cs.segment_offsets(seg, n)
        res = torch.empty((n, msgs.shape[1]), device=msgs.device)
        out[f"k1_pool_{dname}"] = {
            "alone_us": graph_us(lambda i: cs.launch_k1(msgs, offs, n, res)),
            "function_us": graph_us(lambda i: cs.sorted_segment_sum(
                msgs, seg, n, cs.segment_offsets(seg, n))),
        }
        c = cases["gossip"]
        x, g, st = c["x"].to(dtype), c["g"], c["st"]
        n_seg = st.n_nodes * st.n_types
        fwd = torch.empty((n_seg, x.shape[1]), device=x.device)
        dx = torch.empty((st.n_rows, g.shape[1]), device=x.device)
        out[f"gather_fwd_{dname}"] = {
            "alone_us": graph_us(lambda i: cs.launch_k1(
                x, st.fwd_toffs, n_seg, fwd, rows=st.edge_src)),
            "function_us": graph_us(
                lambda i: cs.gather_segment_sum(x, st)),
            "old_us": graph_us(lambda i: gather_old_forward(x, st)),
        }
        out[f"gather_bwd_{dname}"] = {
            "alone_us": graph_us(lambda i: cs.launch_k1(
                g, st.bwd_soffs, st.n_rows, dx, rows=st.bwd_keys)),
            "function_us": graph_us(
                lambda i: cs.gather_segment_sum_bwd(g, st, dtype)),
            "old_us": graph_us(lambda i: gather_old_backward(g, st, dtype)),
        }
        c = cases["k2"]
        x, w, st = c["x"].to(dtype), c["w"].to(dtype), c["st"]
        us = graph_us(lambda i: cs.fused_typed_transform_aggregate(
            x, st.edge_src, st.keys, w, st.n_types, st.n_nodes, streams=st))
        out[f"k2_{dname}"] = {"alone_us": us, "function_us": us}
        c = cases["k3"]
        g, x, w, st = c["g"], c["x"].to(dtype), c["w"].to(dtype), c["st"]
        xp, wp = cs.pad_operands(x, w)
        gt = g.to(dtype)
        dx = torch.empty_like(x)
        partial = torch.empty(
            (cs.k3_blocks(xp, wp, st), st.n_types, cs._tile_width(
                wp.shape[1]), cs._tile_width(wp.shape[2])),
            device=g.device)
        out[f"k3_{dname}"] = {
            "alone_us": graph_us(
                lambda i: cs.launch_k3(gt, xp, wp, st, dx, partial)),
            "function_us": graph_us(
                lambda i: cs.typed_aggregate_bwd(g, x, w, st)),
        }
        c = cases["k4_pool"]
        g, seg = c["g"], c["seg"]
        res = torch.empty((seg.shape[0], g.shape[1]), dtype=dtype,
                          device=g.device)
        us = graph_us(lambda i: cs.launch_k4(g, seg, g.shape[0], res))
        out[f"k4_pool_{dname}"] = {"alone_us": us, "function_us": us}
    return out


def _own_cases(device, seed: int) -> dict:
    """The cases from the tool's own batches: the 256-graph request of
    chip_smoke.py (release/r4's serving capacity buckets) and batch 0 of
    the ``SynNp_320`` training set, packed without labels."""
    from ..batch.packed import auto_capacities, pack_samples
    from ..data.datasets import load_data
    from ..data.synthetic import random_connected_graphs
    from ..data.workload import Workload
    from ..pipeline import prepare_gossip_batches, prepare_stage_data
    from ..serving import CountingService

    svc = CountingService(os.path.join("release", "r4", "neigh.best"),
                          os.path.join("release", "r4", "gossip.best"),
                          device=device)
    rng = np.random.default_rng(seed)
    random_connected_graphs(16, rng)  # chip_smoke.py's warm-up draw
    stage = prepare_stage_data(svc.cfg, random_connected_graphs(256, rng),
                               capacities=svc._select_neigh_caps)
    gb = prepare_gossip_batches(
        svc.cfg, stage, np.zeros((len(stage.samples), 29)),
        capacities=lambda s: svc._pin_caps(
            svc._gossip_buckets, s, svc.cfg.gossip_batch_size))[0]
    samples, _ = Workload(load_data(f"SynNp_320_{seed}")
                          ).neighborhood_samples(svc.cfg.depth)
    trb = pack_samples(samples, *auto_capacities(samples, g_cap=512))[0]
    conv_w = svc.members[0]["target"]["conv"].w[3].contiguous()
    return kernel_cases(stage.batches[0].to(device), gb.to(device),
                        trb.to(device, training=True), conv_w)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m desco_tpu_torch.tools.segsum_inner_ablation")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from ..utils.device import resolve_device

    device = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    cuda_build.build_all()
    report: dict = {"card": card, "probe": [], "shipped": None}
    for k in (128, 64):
        report["probe"].append(probe_series(device, k, args.seed))
    with torch.inference_mode():
        report["shipped"] = time_cases(_own_cases(device, args.seed))
    for name, r in report["shipped"].items():
        old = f"  replaced {r['old_us']:8.2f} us" if "old_us" in r else ""
        print(f"{name:>15}: alone {r['alone_us']:8.2f} us  function "
              f"{r['function_us']:8.2f} us{old}", flush=True)
    print(card, flush=True)
    print(json.dumps(report), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
