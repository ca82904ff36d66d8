#!/usr/bin/env python3
"""GPU smoke run of desco_tpu_torch, the PyTorch/CUDA port of desco_tpu.

Run from the repository root on a machine with one NVIDIA GPU (H100):

    python3 chip_smoke.py [--seed 0]

It imports nothing of JAX or desco_tpu. Phases, each of which exits
nonzero on a failed check (no phase catches its own failure):

  1. environment: the card's name and power limit, torch/CUDA versions;
     build the CUDA kernels (nvcc, sm_90a) and the native host library.
  2. kernels: K1 ``sorted_segment_sum``, K2
     ``fused_typed_transform_aggregate``, K3 ``typed_cotangent_sums`` (with
     the einsums of K2's backward) and K4 ``segment_sum_vjp`` against
     their plain PyTorch versions on the card in f32 (rtol 1e-5, atol
     1e-5 * max|ref|: only the summation order differs), on edge cases
     and at the shapes of real packed batches of the phase-3 request and
     of the phase-6 training set; kernel, plain and library times with
     CUDA events, and the least time the card could take for the same
     work.
  3. serving at full width: ``CountingService`` on release/r4 (SAGE SHMP,
     8 layers, hidden 64, 6 edge types, 29 queries; 2-layer gossip) over
     random graphs drawn like Syn_1827, made with numpy from ``--seed``
     (desco_tpu_torch/data/synthetic.py): a 16-graph
     warm-up, a 256-graph request (twice) and ``count_stream`` over 4x64
     graphs. Every launch counter is zeroed just before these requests
     and read just after: K2 must have run exactly 8 times per packed
     target batch. Counts must be finite and >= 0, verified rows must
     equal a VF2 recount, and CUDA must match the port on the CPU
     (verify_budget=0) within rtol 1e-3 of each count (floored at 1).
  4. daemon: ``python -m desco_tpu_torch.serve`` answers two JSON lines.
  5. gradients: ``train_loss`` and ``gossip_loss`` gradients through the
     kernels against the same on the CPU through the plain versions, same
     weights and batch, dropout 0: max error <= 1e-4 of each tensor's
     scale.
  6. training at full width: a ``SynNp_320`` train set (= valid set) with
     exact VF2 ground truth, ten epochs of the neighborhood stage (paper
     config: batch 512, lr 1e-4; its epoch loss spikes now and then in
     the first epochs, so three are too few to show a fall every time)
     and forty of the gossip stage
     (batch 256, lr 1e-3, dropout 0.01: two steps per epoch; the summed
     loss wanders by a few percent from epoch to epoch and falls by as
     much only over tens of epochs) through ``train_neighborhood_stage``
     / ``train_gossip_stage``. Counters zeroed before, read after: K3 = 8 x
     neighborhood train steps, K2 = 8 x (train steps + val batches +
     predict batches), K4 > 0 in both stages; losses finite and falling.
  7. entry point: ``python -m desco_tpu_torch.main --train_neigh
     --train_gossip --test_gossip`` in a subprocess on a small SynNp set
     at paper width; then ``CountingService`` serves one request from the
     two checkpoints it wrote.
  8. one JSON line of kernels, the card line, then the final ok line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
R4_NEIGH = os.path.join(REPO, "release", "r4", "neigh.best")
R4_GOSSIP = os.path.join(REPO, "release", "r4", "gossip.best")
# H100 SXM data sheet: HBM3 rate, and the f32 rate outside the tensor
# cores (the port runs f32 with TF32 off)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
PAD_KEY = 2 ** 30  # the padding id of desco_tpu's segment-sum streams


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


# ---------------------------------------------------------------- helpers
def cuda_ms(torch, fn, reps: int = 50, warmup: int = 5) -> float:
    """Mean time of one call, CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_err(torch, out, ref, what: str) -> float:
    """Check out == ref within rtol 1e-5, atol 1e-5 * max|ref|."""
    check(tuple(out.shape) == tuple(ref.shape),
          f"{what}: shape {tuple(out.shape)} != {tuple(ref.shape)}")
    check(bool(torch.isfinite(out).all()), f"{what}: non-finite output")
    err = (out - ref).abs()
    if ref.numel() == 0:
        return 0.0
    atol = 1e-5 * float(ref.abs().max())
    bad = err > atol + 1e-5 * ref.abs()
    check(not bool(bad.any()),
          f"{what}: {int(bad.sum())} elements off, max err "
          f"{float(err.max()):.3g} (atol {atol:.3g})")
    return float(err.max())


def bound(bytes_moved: float, ops: float) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------ phase 2: K1
def k1_case(torch, cs, rng, dev, e_live, k, n_seg, pad=0, long_seg=0,
            neg=0):
    ids = np.sort(rng.integers(0, max(n_seg, 1), e_live))
    if long_seg:
        ids = np.sort(np.concatenate([ids, np.full(long_seg, n_seg // 2)]))
    ids = np.concatenate([np.full(neg, -1), ids, np.full(pad, PAD_KEY)])
    seg = torch.as_tensor(ids.astype(np.int32), device=dev)
    msgs = torch.randn(len(ids), k, device=dev)
    return msgs, seg, n_seg


def k1_edge_cases(torch, cs, rng, dev) -> None:
    cases = {
        "gaps+negative+pad tail, K=64, E=1001":
            dict(e_live=1001 - 64 - 3, k=64, n_seg=700, pad=64, neg=3),
        "long segment (5000 rows), K=128":
            dict(e_live=3000, k=128, n_seg=900, long_seg=5000),
        "odd K=33, E=777": dict(e_live=777, k=33, n_seg=50),
        "all padding, K=64": dict(e_live=0, k=64, n_seg=40, pad=513),
        "empty stream, K=128": dict(e_live=0, k=128, n_seg=17),
        "pooling width K=576": dict(e_live=5000, k=576, n_seg=64, pad=7),
    }
    for name, kw in cases.items():
        msgs, seg, n = k1_case(torch, cs, rng, dev, **kw)
        out = cs.sorted_segment_sum(msgs, seg, n)
        torch.cuda.synchronize()
        err = max_err(torch, out, cs.sorted_segment_sum_plain(msgs, seg, n),
                      f"K1 {name}")
        print(f"K1 edge case ok: {name} (max err {err:.3g})", flush=True)


def k1_main(torch, cs, dev, msgs, seg, n, label) -> dict:
    """Check K1 at one main-path shape; time kernel, plain, index_add_."""
    out = cs.sorted_segment_sum(msgs, seg, n)
    torch.cuda.synchronize()
    err = max_err(torch, out, cs.sorted_segment_sum_plain(msgs, seg, n),
                  f"K1 {label}")
    ids = seg.long().masked_fill((seg < 0) | (seg >= n), n)
    lib_out = torch.zeros(n + 1, msgs.shape[1], device=dev)

    def library():
        lib_out.zero_()
        lib_out.index_add_(0, ids, msgs)

    e_live = int(((seg >= 0) & (seg < n)).sum())
    k = msgs.shape[1]
    b_ms, b_by = bound(e_live * k * 4 + seg.numel() * 4 + n * k * 4,
                       e_live * k)
    row = {
        "ms": cuda_ms(torch, lambda: cs.sorted_segment_sum(msgs, seg, n)),
        "plain_ms": cuda_ms(
            torch, lambda: cs.sorted_segment_sum_plain(msgs, seg, n)),
        "library_ms": cuda_ms(torch, library),
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
    }
    print(f"K1 at {label}: msgs {tuple(msgs.shape)}, {n} segments, "
          f"{e_live} live rows: {json.dumps(row)}", flush=True)
    return row


# ------------------------------------------------------------ phase 2: K2
def k2_case(torch, rng, dev, n, t, h, k, e_live, long_seg=0, pad=64):
    dst = rng.integers(0, n - 1, e_live)
    if long_seg:
        dst = np.concatenate([dst, np.full(long_seg, 7)])
    typ = rng.integers(0, t, len(dst))
    src = rng.integers(0, n - 1, len(dst))
    keys = dst * t + typ
    order = np.argsort(keys, kind="stable")
    keys = np.concatenate([keys[order], np.full(pad, (n - 1) * t + 63)])
    src = np.concatenate([src[order], np.full(pad, n - 1)])
    x = torch.randn(n, h, device=dev)
    x[n - 1] = 0.0  # the pad node
    w = torch.randn(t, h, k, device=dev) * 0.1
    return (x, torch.as_tensor(src.astype(np.int32), device=dev),
            torch.as_tensor(keys.astype(np.int32), device=dev), w)


def k2_edge_cases(torch, cs, rng, dev) -> None:
    cases = {
        "N=300 T=6 K=64, E=1001 with pad keys":
            dict(n=300, t=6, h=64, k=64, e_live=1001 - 64),
        "K=128 (H=64), empty nodes": dict(n=2000, t=6, h=64, k=128,
                                          e_live=700),
        "long segment (5000 edges), T=2": dict(n=500, t=2, h=64, k=64,
                                               e_live=900, long_seg=5000),
        "all padding": dict(n=129, t=6, h=64, k=64, e_live=0, pad=512),
        "odd K=33": dict(n=300, t=3, h=16, k=33, e_live=999),
    }
    for name, kw in cases.items():
        x, src, keys, w = k2_case(torch, rng, dev, **kw)
        t, n = kw["t"], kw["n"]
        out = cs.fused_typed_transform_aggregate(x, src, keys, w, t, n)
        torch.cuda.synchronize()
        ref = cs.fused_typed_transform_aggregate_plain(x, src, keys, w, t, n)
        err = max_err(torch, out, ref, f"K2 {name}")
        print(f"K2 edge case ok: {name} (max err {err:.3g})", flush=True)


def k2_main(torch, cs, dev, batch, conv_w) -> dict:
    """Check K2 at a real packed target batch of the main request."""
    t = conv_w.shape[0]
    n, h = batch.n_cap, conv_w.shape[1]
    k = conv_w.shape[2]
    x = torch.randn(n, h, device=dev) * batch.node_mask[:, None]
    keys = batch.edge_dst * t + batch.edge_type
    src = batch.edge_src
    args = (x, src, keys, conv_w, t, n)
    out = cs.fused_typed_transform_aggregate(*args)
    torch.cuda.synchronize()
    err = max_err(torch, out, cs.fused_typed_transform_aggregate_plain(*args),
                  "K2 main-path batch")
    live = keys < n * t
    e_live = int(live.sum())
    # the z rows this batch's live edges read (data-dependent work)
    rows = torch.unique((keys[live] % t).long() * n + src[live].long())
    z = torch.matmul(x, conv_w).contiguous()
    bounds_ = torch.arange(n + 1, dtype=torch.int32, device=dev) * t
    offs = torch.searchsorted(keys, bounds_, out_int32=True)
    kout = torch.empty(n, k, device=dev)
    lib = cs.library()

    def kernel_only():
        cs._check(lib.desco_fused_typed_gather_segsum(
            z.data_ptr(), src.data_ptr(), keys.data_ptr(), offs.data_ptr(),
            n, n, t, k, kout.data_ptr(), cs._stream(dev)))

    b_ms, b_by = bound(
        x.numel() * 4 + conv_w.numel() * 4 + src.numel() * 4
        + keys.numel() * 4 + n * k * 4,
        2 * n * h * k * t + e_live * k)
    row = {
        "ms": cuda_ms(torch, lambda: cs.fused_typed_transform_aggregate(
            *args)),
        "plain_ms": cuda_ms(
            torch, lambda: cs.fused_typed_transform_aggregate_plain(*args)),
        "library_ms": None,
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
        "kernel_only_ms": cuda_ms(torch, kernel_only),
        "kernel_only_bound_ms": bound(
            rows.numel() * k * 4 + e_live * 8 + (n + 1) * 4 + n * k * 4,
            e_live * k)[0],
    }
    print(f"K2 at the main path: x {tuple(x.shape)}, {keys.numel()} edge "
          f"slots ({e_live} live, {rows.numel()} distinct z rows), "
          f"{t} types: {json.dumps(row)}", flush=True)
    return row


# ------------------------------------------------------------ phase 2: K3
def bwd_perm_of(src, keys, t, n):
    """Edge slots in (src, type) order, dead edges last."""
    return np.lexsort((keys % t, src, keys >= n * t)).astype(np.int32)


def k3_streams(torch, cs, dev, src, keys, t, n):
    perm = bwd_perm_of(src.cpu().numpy(), keys.cpu().numpy(), t, n)
    return cs.typed_streams(src, keys, t, n, n,
                            torch.as_tensor(perm, device=dev))


def k3_check(torch, cs, g, x, w, st, what) -> float:
    """u, dx and dW through the kernel against the plain version."""
    u = cs.typed_cotangent_sums(g, st)
    dx, dw = cs.typed_aggregate_bwd(g, x, w, st)
    torch.cuda.synchronize()
    gc = g.contiguous()
    dx_ref, dw_ref = cs.typed_aggregate_bwd_plain(gc, x, w, st)
    return max(
        max_err(torch, u, cs.typed_cotangent_sums_plain(gc, st),
                f"K3 u, {what}"),
        max_err(torch, dx, dx_ref, f"K3 dx, {what}"),
        max_err(torch, dw, dw_ref, f"K3 dW, {what}"))


def k3_edge_cases(torch, cs, rng, dev) -> None:
    cases = {
        "N=300 T=6 K=64, pad edges last":
            dict(n=300, t=6, h=64, k=64, e_live=1001 - 64),
        "K=128 (H=64), mostly empty segments":
            dict(n=2000, t=6, h=64, k=128, e_live=700),
        "one long (source, type) segment (5000 edges), T=2":
            dict(n=500, t=2, h=64, k=64, e_live=900, long_seg=5000),
        "all-pad stream": dict(n=129, t=6, h=64, k=64, e_live=0, pad=512),
        "odd K=33": dict(n=300, t=3, h=16, k=33, e_live=999),
    }
    for name, kw in cases.items():
        x, src, keys, w = k2_case(torch, rng, dev, **kw)
        t, n, k = kw["t"], kw["n"], kw["k"]
        if kw.get("long_seg"):  # k2_case made one long destination row:
            # swap the roles so one source sends the long run instead
            dst = torch.div(keys, t, rounding_mode="floor")
            live = keys < n * t
            new_keys = torch.where(live, src * t + keys % t, keys)
            new_src = torch.where(live, dst, src)
            order = torch.argsort(new_keys, stable=True)
            keys, src = (new_keys[order].contiguous(),
                         new_src[order].contiguous())
        st = k3_streams(torch, cs, dev, src, keys, t, n)
        g = torch.randn(n, k, device=dev)
        err = k3_check(torch, cs, g, x, w, st, name)
        # cotangents as autograd hands them over: a strided view and an
        # expanded scalar
        wide = torch.randn(n, 2 * k, device=dev)[:, :k]
        err = max(err, k3_check(torch, cs, wide, x, w, st,
                                name + ", strided g"))
        ones = torch.ones((), device=dev).expand(n, k)
        err = max(err, k3_check(torch, cs, ones, x, w, st,
                                name + ", expanded g"))
        print(f"K3 edge case ok: {name} (max err {err:.3g})", flush=True)


def k3_main(torch, cs, dev, batch, conv_w) -> dict:
    """Check K3 at a real packed training batch; time the whole backward
    (kernel + the two einsums), its plain version and the kernel alone."""
    from desco_tpu_torch.models.shmp_gnn import batch_typed_streams

    t, h, k = conv_w.shape
    n = batch.n_cap
    st = batch_typed_streams(batch, t)
    x = torch.randn(n, h, device=dev) * batch.node_mask[:, None]
    g = torch.randn(n, k, device=dev)
    err = k3_check(torch, cs, g, x, conv_w, st, "main-path training batch")
    e_live = int(st.bwd_offs[-1])
    n_seg = n * t
    filled = int((st.bwd_offs[1:] > st.bwd_offs[:-1]).sum())
    g_rows = int(torch.unique(st.bwd_rows[:e_live]).numel())
    u = torch.empty(n_seg, k, device=dev)
    lib = cs.library()

    def kernel_only():
        cs._check(lib.desco_gather_rows_segsum(
            g.data_ptr(), st.bwd_rows.data_ptr(), st.bwd_offs.data_ptr(),
            n_seg, n, k, u.data_ptr(), cs._stream(dev)))

    einsum_ops = 2 * (2 * n * t * k * h)
    b_ms, b_by = bound(
        (g.numel() + x.numel() + conv_w.numel()) * 4 + e_live * 4
        + (n_seg + 1) * 4 + (x.numel() + conv_w.numel()) * 4,
        e_live * k + einsum_ops)
    row = {
        "ms": cuda_ms(torch, lambda: cs.typed_aggregate_bwd(
            g, x, conv_w, st)),
        "plain_ms": cuda_ms(torch, lambda: cs.typed_aggregate_bwd_plain(
            g, x, conv_w, st)),
        "library_ms": None,
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
        "kernel_only_ms": cuda_ms(torch, kernel_only),
        "kernel_only_bound_ms": bound(
            g_rows * k * 4 + e_live * 4 + (n_seg + 1) * 4 + n_seg * k * 4,
            e_live * k)[0],
    }
    print(f"K3 at the main path: g {tuple(g.shape)}, {st.keys.numel()} edge "
          f"slots ({e_live} live), u [{n_seg}, {k}] with {filled} non-empty "
          f"(source, type) rows, {t} types: {json.dumps(row)}", flush=True)
    return row


# ------------------------------------------------------------ phase 2: K4
def k4_edge_cases(torch, cs, rng, dev) -> None:
    cases = {
        "gaps+negative+pad tail, K=64, E=1001":
            dict(e_live=1001 - 64 - 3, k=64, n_seg=700, pad=64, neg=3),
        "long segment (5000 rows), K=128":
            dict(e_live=3000, k=128, n_seg=900, long_seg=5000),
        "odd K=33, E=777": dict(e_live=777, k=33, n_seg=50),
        "K=2 mod 4 (66)": dict(e_live=500, k=66, n_seg=50, pad=9),
        "all padding, K=64": dict(e_live=0, k=64, n_seg=40, pad=513),
        "empty stream, K=128": dict(e_live=0, k=128, n_seg=17),
        "pooling width K=576": dict(e_live=5000, k=576, n_seg=64, pad=7),
    }
    for name, kw in cases.items():
        _, seg, n = k1_case(torch, cs, rng, dev, **kw)
        k = kw["k"]
        g = torch.randn(n, k, device=dev)
        wide = torch.randn(n, 2 * k, device=dev)[:, :k]  # strided
        err = 0.0
        for gi, tag in ((g, ""), (wide, ", strided g")):
            out = cs.segment_sum_vjp(gi, seg, n)
            torch.cuda.synchronize()
            err = max(err, max_err(
                torch, out, cs.segment_sum_vjp_plain(gi.contiguous(), seg, n),
                f"K4 {name}{tag}"))
        print(f"K4 edge case ok: {name} (max err {err:.3g})", flush=True)


def k4_main(torch, cs, dev, g, seg, label) -> dict:
    """Check K4 at one main-path shape; time kernel, plain, index_select."""
    n, k = g.shape
    out = cs.segment_sum_vjp(g, seg, n)
    torch.cuda.synchronize()
    err = max_err(torch, out, cs.segment_sum_vjp_plain(g, seg, n),
                  f"K4 {label}")
    ids = seg.long().clamp(0, n - 1)
    lib_out = torch.empty(seg.numel(), k, device=dev)
    b_ms, b_by = bound(g.numel() * 4 + seg.numel() * 4
                       + seg.numel() * k * 4, 0)
    row = {
        "ms": cuda_ms(torch, lambda: cs.segment_sum_vjp(g, seg, n)),
        "plain_ms": cuda_ms(
            torch, lambda: cs.segment_sum_vjp_plain(g, seg, n)),
        "library_ms": cuda_ms(
            torch, lambda: torch.index_select(g, 0, ids, out=lib_out)),
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
    }
    print(f"K4 at {label}: g {tuple(g.shape)} -> d [{seg.numel()}, {k}]: "
          f"{json.dumps(row)}", flush=True)
    return row


# ------------------------------------------------- phase 5: gradient check
def grad_errors(torch, loss_on, params, what: str) -> float:
    """Gradients of ``loss_on(params, device)`` on CUDA (kernels) against
    the CPU (plain versions): the largest error relative to its tensor's
    scale, which must stay within 1e-4."""
    import copy

    grads = {}
    for dev in ("cuda", "cpu"):
        p = copy.deepcopy(params).to(dev).requires_grad_(True)
        loss = loss_on(p, torch.device(dev))
        check(bool(torch.isfinite(loss)), f"{what}: loss on {dev} not finite")
        loss.backward()
        grads[dev] = {n: (q.grad if q.grad is not None
                          else torch.zeros_like(q)).cpu()
                      for n, q in p.named_parameters()}
        grads[dev]["(loss)"] = loss.detach().cpu().reshape(1)
    worst = 0.0
    for name, ref in grads["cpu"].items():
        scale = float(ref.abs().max())
        err = float((grads["cuda"][name] - ref).abs().max())
        rel = err / scale if scale > 0 else (0.0 if err == 0 else float("inf"))
        check(rel <= 1e-4, f"{what}: gradient of {name} off by {rel:.3g} of "
              f"its scale {scale:.3g}")
        worst = max(worst, rel)
    return worst


# --------------------------------------------------------- phase 3 checks
def check_counts(res, n_graphs: int, what: str) -> None:
    check(res.graphlet_counts.shape == (n_graphs, 29),
          f"{what}: graphlet counts {res.graphlet_counts.shape}")
    for name in ("graphlet_counts", "node_counts", "neighborhood_counts"):
        check(np.isfinite(getattr(res, name)).all(),
              f"{what}: non-finite {name}")
    check((res.graphlet_counts >= 0).all() and (res.node_counts >= 0).all(),
          f"{what}: negative counts")
    check(res.refined, f"{what}: gossip refinement did not run")


def close_counts(a, b, what: str) -> float:
    """|a - b| <= 1e-3 * max(|b|, 1): rtol 1e-3 on de-logged counts,
    floored at one occurrence."""
    check(a.shape == b.shape, f"{what}: shapes {a.shape} != {b.shape}")
    rel = np.abs(a - b) / np.maximum(np.abs(b), 1.0)
    check(rel.max(initial=0.0) <= 1e-3,
          f"{what}: max relative difference {rel.max():.3g} > 1e-3")
    return float(rel.max(initial=0.0))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA device")
    from desco_tpu_torch.data.datasets import load_data
    from desco_tpu_torch.data.synthetic import random_connected_graphs
    from desco_tpu_torch.data.workload import Workload
    from desco_tpu_torch.graph import Graph
    from desco_tpu_torch.graph.canonical import canonical_neighborhood
    from desco_tpu_torch.models import gossip as gossip_mod
    from desco_tpu_torch.models import neighborhood as neigh_mod
    from desco_tpu_torch.ops import cuda_segment as cs
    from desco_tpu_torch.pipeline import (
        PipelineConfig, build_query_batch, model_configs,
        neighborhood_predictions, pipeline_queries, prepare_gossip_batches,
        prepare_stage_data, train_gossip_stage, train_neighborhood_stage)
    from desco_tpu_torch.serving import CountingService
    from desco_tpu_torch.truth import native as truth_native

    # ---------------------------------------------------- 1. environment
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}, count "
          f"{torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    cs.library()
    print(f"kernels built from {os.path.relpath(cs.SOURCE, REPO)} with "
          f"nvcc {' '.join(cs.NVCC_FLAGS)} in {cs.build_seconds:.2f} s "
          f"(load {time.perf_counter() - t0:.2f} s)", flush=True)
    t0 = time.perf_counter()
    engine = truth_native.engine()
    print(f"VF2 / sample-prep engine: {engine} "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    dev = torch.device("cuda")

    # graphs of every request, made up front from the seed
    rng = np.random.default_rng(args.seed)
    warm = random_connected_graphs(16, rng)
    main_req = random_connected_graphs(256, rng)
    stream = [random_connected_graphs(64, rng) for _ in range(4)]
    print(f"graphs: 256-graph request has "
          f"{sum(g.n_nodes for g in main_req)} nodes, "
          f"{sum(g.n_edges for g in main_req)} edges", flush=True)

    svc = CountingService(R4_NEIGH, R4_GOSSIP, device="cuda")
    check(svc.tgt_cfg.agg_mode == "kernel",
          f"target tower agg_mode {svc.tgt_cfg.agg_mode!r}, not the kernel")
    check((svc.tgt_cfg.layer_num, svc.tgt_cfg.hidden_dim,
           svc.tgt_cfg.n_edge_types, len(pipeline_queries(svc.cfg))) ==
          (8, 64, 6, 29), "release/r4 is not at the paper width")

    # host prep of every request, twice: the first pass pins the serving
    # capacity buckets at their final size, the second counts the packed
    # target batches each request will run
    requests = [warm, main_req, main_req] + stream
    for g in requests:
        prepare_stage_data(svc.cfg, g, capacities=svc._select_neigh_caps)
    stages = [prepare_stage_data(svc.cfg, g,
                                 capacities=svc._select_neigh_caps)
              for g in requests]
    n_batches = [len(s.batches) for s in stages]
    main_stage = stages[1]
    print(f"target batches per request: {n_batches} (n_cap "
          f"{main_stage.batches[0].n_cap}, e_cap "
          f"{main_stage.batches[0].e_cap}, g_cap "
          f"{main_stage.batches[0].g_cap})", flush=True)

    # the training set of phase 6 (train = valid), with exact ground
    # truth: paper config, a few epochs per stage
    workdir = tempfile.TemporaryDirectory(prefix="desco_smoke_")
    tcfg = PipelineConfig(neigh_epochs=10, gossip_epochs=40, seed=args.seed,
                          data_root=os.path.join(workdir.name, "data"))
    train_name = f"SynNp_320_{args.seed}"
    train_graphs = load_data(train_name)
    n_train_nodes = sum(g.n_nodes for g in train_graphs)
    t0 = time.perf_counter()
    Workload(train_graphs, root=os.path.join(tcfg.data_root, train_name),
             name=train_name).compute_groundtruth(tcfg.query_ids)
    truth_s = time.perf_counter() - t0
    print(f"truth: {truth_s:.2f} s of C++ VF2 ({os.cpu_count()} host "
          f"threads) for {train_name}: {len(train_graphs)} graphs, "
          f"{n_train_nodes} nodes, "
          f"{sum(g.n_edges for g in train_graphs)} edges; "
          f"{truth_s / n_train_nodes * 1e3:.3f} s per 1000 nodes",
          flush=True)
    t0 = time.perf_counter()
    train_stage = prepare_stage_data(tcfg, train_graphs, name=train_name,
                                     need_truth=True)
    tb0 = train_stage.batches[0]
    print(f"training set staged in {time.perf_counter() - t0:.2f} s (truth "
          f"from its cache): {len(train_stage.samples)} neighborhoods in "
          f"{len(train_stage.batches)} batches of n_cap {tb0.n_cap}, e_cap "
          f"{tb0.e_cap}, g_cap {tb0.g_cap}", flush=True)

    # -------------------------------------------------------- 2. kernels
    krng = np.random.default_rng(args.seed + 1)
    with torch.inference_mode():
        k1_edge_cases(torch, cs, krng, dev)
        k2_edge_cases(torch, cs, krng, dev)
        k3_edge_cases(torch, cs, krng, dev)
        k4_edge_cases(torch, cs, krng, dev)
        tb = main_stage.batches[0].to(dev)
        conv_w = svc.neigh_params["target"]["conv"].w[3].contiguous()
        k2_row = k2_main(torch, cs, dev, tb, conv_w)
        # K1 runs in the gossip direction aggregation ([E, 128] messages
        # in layer 0) and in the target tower's graph pooling
        gb = prepare_gossip_batches(
            svc.cfg, main_stage,
            np.zeros((len(main_stage.samples), 29)),
            capacities=lambda s: svc._pin_caps(
                svc._gossip_buckets, s, svc.cfg.gossip_batch_size))[0].to(dev)
        xg = torch.randn(gb.n_cap, 128, device=dev) * gb.node_mask[:, None]
        k1_row = k1_main(torch, cs, dev,
                         xg[gb.edge_src.long()].contiguous(),
                         gb.edge_dst * 2 + gb.edge_type, 2 * gb.n_cap,
                         "the gossip layer-0 aggregation")
        emb = torch.randn(tb.n_cap, 576, device=dev) * tb.node_mask[:, None]
        k1_main(torch, cs, dev, emb, tb.node_graph, tb.g_cap,
                "the target-tower pooling")
        # K3 behind every K2 of a training step; K4 behind the gossip
        # direction aggregation (its largest use) and behind pooling
        trb = tb0.to(dev, training=True)
        k3_row = k3_main(torch, cs, dev, trb, conv_w)
        k4_row = k4_main(torch, cs, dev,
                         torch.randn(2 * gb.n_cap, 128, device=dev),
                         gb.edge_dst * 2 + gb.edge_type,
                         "the gossip layer-0 aggregation's backward")
        k4_main(torch, cs, dev, torch.randn(trb.g_cap, 576, device=dev),
                trb.node_graph, "the target-tower pooling's backward")

    # -------------------------------------------------------- 3. serving
    for kern in cs.KERNELS:
        kern.launches = 0
    torch.cuda.synchronize()
    timings = {}
    t0 = time.perf_counter()
    res_warm = svc.count(warm)
    timings["warm-up 16 graphs (first request)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_main = svc.count(main_req)
    timings["256 graphs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_main2 = svc.count(main_req)
    timings["256 graphs, repeat"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_stream = list(svc.count_stream(stream))
    timings["count_stream 4x64 graphs"] = time.perf_counter() - t0
    launches = {kern.__name__: kern.launches for kern in cs.KERNELS}
    print(f"serving-path launches: {json.dumps(launches)}; expected K2 = 8 "
          f"x {sum(n_batches)} target batches", flush=True)
    check(launches["fused_typed_transform_aggregate"] == 8 * sum(n_batches),
          "K2 launches != 8 x packed target batches")
    for name in ("sorted_segment_sum", "fused_typed_transform_aggregate"):
        check(launches[name] > 0,
              f"kernel {name} never launched on the serving path")
    for name in ("typed_cotangent_sums", "segment_sum_vjp"):
        check(launches[name] == 0,
              f"backward kernel {name} launched while serving")

    check_counts(res_warm, 16, "warm-up")
    check_counts(res_main, 256, "256-graph request")
    check_counts(res_main2, 256, "256-graph repeat")
    check(len(res_stream) == 4, "count_stream yielded "
          f"{len(res_stream)} results for 4 requests")
    for i, r in enumerate(res_stream):
        check_counts(r, 64, f"stream request {i}")
    close_counts(res_main2.neighborhood_counts, res_main.neighborhood_counts,
                 "repeat vs first 256-graph request")

    # verified rows equal an independent VF2 recount
    rows = res_main.verified_rows
    check(len(rows) > 0, "no neighborhood was verified")
    idx = main_stage.nindex.index[rows]
    nbs = [canonical_neighborhood(main_req[int(g)], int(v), svc.cfg.depth)
           for g, v in idx]
    recount = truth_native.parallel_canonical_counts(
        [nb.graph for nb in nbs], pipeline_queries(svc.cfg))
    exact = np.stack([c[nb.canonical] for nb, c in zip(nbs, recount)])
    got = res_main.neighborhood_counts[rows]
    check(np.array_equal(got, exact.astype(got.dtype)),
          "verified rows differ from the VF2 recount")
    print(f"verified rows: {len(rows)} equal the VF2 recount", flush=True)

    for name, sec in timings.items():
        n_g = {"warm-up 16 graphs (first request)": 16}.get(name, 256)
        print(f"serving {name}: {sec * 1e3:.1f} ms, "
              f"{n_g / sec:.1f} graphs/s", flush=True)

    # CUDA vs the port on the CPU, without the top-k recount
    over = {"verify_budget": 0.0}
    svc_gpu = CountingService(R4_NEIGH, R4_GOSSIP, config_overrides=over,
                              device="cuda")
    svc_cpu = CountingService(R4_NEIGH, R4_GOSSIP, config_overrides=over,
                              device="cpu")
    r_gpu = svc_gpu.count(main_req)
    t0 = time.perf_counter()
    r_cpu = svc_cpu.count(main_req)
    cpu_s = time.perf_counter() - t0
    d_neigh = close_counts(r_gpu.neighborhood_counts, r_cpu.neighborhood_counts,
                           "CUDA vs CPU neighborhood counts")
    d_node = close_counts(r_gpu.node_counts, r_cpu.node_counts,
                          "CUDA vs CPU node counts")
    print(f"CUDA vs CPU (verify_budget=0): neighborhood counts max rel "
          f"{d_neigh:.3g}, node counts max rel {d_node:.3g} (CPU request "
          f"{cpu_s:.1f} s)", flush=True)

    # --------------------------------------------------------- 4. daemon
    reqs = [
        {"id": 1, "graphs": [{"n": g.n_nodes, "edges": g.edges.tolist()}
                             for g in main_req[:3]]},
        {"id": 2, "graphs": [{"n": g.n_nodes, "edges": g.edges.tolist()}
                             for g in main_req[3:8]], "node_counts": True},
    ]
    stdin = "".join(json.dumps(r) + "\n" for r in reqs) + "quit\n"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "desco_tpu_torch.serve",
         "--neigh_ckpt", R4_NEIGH, "--gossip_ckpt", R4_GOSSIP],
        input=stdin, capture_output=True, text=True, timeout=600, cwd=REPO)
    check(proc.returncode == 0,
          f"daemon exited {proc.returncode}: {proc.stderr[-2000:]}")
    replies = [json.loads(line) for line in proc.stdout.splitlines()
               if line.strip()]
    check([r.get("id") for r in replies] == [1, 2],
          f"daemon replies {[r.get('id') for r in replies]}")
    for req, rep in zip(reqs, replies):
        check("error" not in rep, f"daemon error: {rep.get('error')}")
        got = np.asarray(rep["graphlet_counts"])
        n_g = len(req["graphs"])
        check(got.shape == (n_g, 29) and np.isfinite(got).all()
              and (got >= 0).all(), f"daemon reply {rep['id']} malformed")
        want = svc.count([Graph(g["n"], np.asarray(g["edges"], np.int32))
                          for g in req["graphs"]]).graphlet_counts
        check(np.all(np.abs(got - want) <= np.maximum(1.0, 1e-3 * want)),
              f"daemon reply {rep['id']} differs from the in-process "
              f"service")
    check(len(replies[1].get("node_counts", [])) ==
          sum(g["n"] for g in reqs[1]["graphs"]), "daemon node_counts")
    print(f"daemon: 2 requests answered in {time.perf_counter() - t0:.1f} s "
          f"(process start and model load included)", flush=True)

    # ------------------------------------------------------ 5. gradients
    tgt_cfg, qry_cfg = model_configs(tcfg, dev)
    check(tgt_cfg.agg_mode == "kernel" and (
        tgt_cfg.layer_num, tgt_cfg.hidden_dim, tgt_cfg.n_edge_types,
        len(tcfg.query_ids)) == (8, 64, 6, 29),
          "the training config is not at the paper width")
    qb = build_query_batch(tcfg)
    gen = torch.Generator().manual_seed(args.seed)
    neigh_params = neigh_mod.init_neighborhood_model(tgt_cfg, qry_cfg, gen)
    before = cs.typed_cotangent_sums.launches
    t0 = time.perf_counter()
    worst = grad_errors(
        torch, lambda p, d: neigh_mod.train_loss(
            p, tgt_cfg, qry_cfg, tb0.to(d, training=True), qb.to(d)),
        neigh_params, "train_loss")
    check(cs.typed_cotangent_sums.launches == before + 8,
          "train_loss's backward did not launch K3 once per layer")
    print(f"gradients: train_loss through K1-K4 on CUDA vs the plain "
          f"versions on the CPU, {sum(p.numel() for p in neigh_params.parameters())} "
          f"parameters: max error {worst:.3g} of a tensor's scale "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    with torch.no_grad():
        fresh_embs = neigh_mod.embed_queries(
            neigh_params.to(dev), qry_cfg, qb.to(dev)).cpu()
    neigh_params.to("cpu")
    fake_counts = (train_stage.truth[train_stage.nindex.indicator]
                   * np.random.default_rng(args.seed).uniform(
                       0.5, 1.5, (len(train_stage.samples), 1)))
    ggb = prepare_gossip_batches(tcfg, train_stage, fake_counts,
                                 need_bwd_perm=True)[0]
    gossip_params = gossip_mod.init_gossip_model(
        hidden_dim=tcfg.gossip_hidden_dim,
        emb_channels=tcfg.neigh_hidden_dim, generator=gen)
    before = cs.segment_sum_vjp.launches
    t0 = time.perf_counter()
    worst = grad_errors(
        torch, lambda p, d: gossip_mod.gossip_loss(
            p, ggb.to(d, training=True), fresh_embs.to(d)),
        gossip_params, "gossip_loss")
    check(cs.segment_sum_vjp.launches > before,
          "gossip_loss's backward did not launch K4")
    print(f"gradients: gossip_loss (29 checkpointed queries) on CUDA vs "
          f"the CPU: max error {worst:.3g} of a tensor's scale "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # ------------------------------------------- 6. training, full width
    for kern in cs.KERNELS:
        kern.launches = 0
    n_b = len(train_stage.batches)
    logs = []

    def log(line):
        logs.append(line)
        print(f"  {line}", flush=True)

    t0 = time.perf_counter()
    res, tgt_cfg, qry_cfg = train_neighborhood_stage(
        tcfg, train_stage, train_stage, qb, log_fn=log, log_every=1,
        ckpt_path=os.path.join(workdir.name, "ck", "neigh"))
    neigh_s = time.perf_counter() - t0
    after_neigh = {kern.__name__: kern.launches for kern in cs.KERNELS}
    steps = tcfg.neigh_epochs * n_b
    check(np.isfinite(res.train_losses).all()
          and np.isfinite(res.val_losses).all(),
          f"neighborhood losses not finite: {res.train_losses}")
    check(res.train_losses[-1] < res.train_losses[0],
          f"neighborhood train loss did not fall: {res.train_losses}")
    check(after_neigh["typed_cotangent_sums"] == 8 * steps,
          f"K3 launches {after_neigh['typed_cotangent_sums']} != 8 x "
          f"{steps} neighborhood train steps")
    check(after_neigh["fused_typed_transform_aggregate"] == 8 * 2 * steps,
          f"K2 launches {after_neigh['fused_typed_transform_aggregate']} "
          f"!= 8 x ({steps} train steps + {steps} val batches)")
    check(after_neigh["segment_sum_vjp"] > 0 and
          after_neigh["sorted_segment_sum"] > 0,
          "K1 / K4 never launched in the neighborhood stage")
    live_edges = int(sum((b.edge_type != 63).sum()
                         for b in train_stage.batches))
    neigh_step_ms = 1e3 * float(np.mean(res.train_times[1:])) / n_b
    print(f"neighborhood stage: {tcfg.neigh_epochs} epochs x {n_b} steps in "
          f"{neigh_s:.1f} s; train loss {res.train_losses[0]:.4f} -> "
          f"{res.train_losses[-1]:.4f}, best val {res.best_val:.4f}; "
          f"{neigh_step_ms:.2f} ms per train step (epochs after the "
          f"first), {live_edges / np.mean(res.train_times[1:]) / 1e6:.2f}M "
          f"live edges/s per epoch; launches {json.dumps(after_neigh)}",
          flush=True)

    best = res.best_params.requires_grad_(False).to(dev)
    with torch.inference_mode():
        q_embs = neigh_mod.embed_queries(best, qry_cfg, qb.to(dev))
    t0 = time.perf_counter()
    counts_train, _ = neighborhood_predictions(
        best, tgt_cfg, q_embs, train_stage, tcfg, dev)
    check(counts_train.shape == (len(train_stage.samples), 29)
          and np.isfinite(counts_train).all(),
          "stage-1 predictions of the training set malformed")
    print(f"stage-1 predictions of the training set (clamp + VF2 tail "
          f"verification): {time.perf_counter() - t0:.1f} s", flush=True)
    after_pred = {kern.__name__: kern.launches for kern in cs.KERNELS}
    check(after_pred["fused_typed_transform_aggregate"]
          == 8 * (2 * steps + n_b),
          "K2 launches != 8 x (train steps + val batches + predict batches)")
    gbatches = prepare_gossip_batches(tcfg, train_stage, counts_train,
                                      need_bwd_perm=True)
    n_gb = len(gbatches)
    t0 = time.perf_counter()
    gres, _ = train_gossip_stage(
        tcfg, best, tgt_cfg, qry_cfg, qb, gbatches, gbatches, log_fn=log,
        log_every=5, ckpt_path=os.path.join(workdir.name, "ck", "gossip"))
    gossip_s = time.perf_counter() - t0
    train_launches = {kern.__name__: kern.launches for kern in cs.KERNELS}
    check(np.isfinite(gres.train_losses).all()
          and np.isfinite(gres.val_losses).all(),
          f"gossip losses not finite: {gres.train_losses}")
    check(gres.train_losses[-1] < gres.train_losses[0],
          f"gossip train loss did not fall: {gres.train_losses}")
    check(train_launches["segment_sum_vjp"] > after_pred["segment_sum_vjp"],
          "K4 never launched in the gossip stage")
    check(train_launches["sorted_segment_sum"]
          > after_pred["sorted_segment_sum"],
          "K1 never launched in the gossip stage")
    check(train_launches["typed_cotangent_sums"] == 8 * steps and
          train_launches["fused_typed_transform_aggregate"]
          == 8 * (2 * steps + n_b),
          "the gossip stage launched K2 or K3")
    g_edges = int(sum((b.edge_type != 63).sum() for b in gbatches))
    gossip_step_ms = 1e3 * float(np.mean(gres.train_times[1:])) / n_gb
    print(f"gossip stage: {tcfg.gossip_epochs} epochs x {n_gb} steps (n_cap "
          f"{gbatches[0].n_cap}, e_cap {gbatches[0].e_cap}) in "
          f"{gossip_s:.1f} s; train loss {gres.train_losses[0]:.1f} -> "
          f"{gres.train_losses[-1]:.1f}, best val {gres.best_val:.4f}; "
          f"{gossip_step_ms:.2f} ms per train step (epochs after the "
          f"first), {g_edges / np.mean(gres.train_times[1:]) / 1e6:.3f}M "
          f"live edges/s per epoch", flush=True)
    print(f"training-path launches: {json.dumps(train_launches)}; K3 = 8 x "
          f"{steps} train steps, K2 = 8 x ({steps} train steps + {steps} "
          f"val batches + {n_b} predict batches)", flush=True)
    for name, n in train_launches.items():
        check(n > 0, f"kernel {name} never launched on the training path")

    # --------------------------------------------------- 7. entry point
    cli_dir = os.path.join(workdir.name, "cli")
    cmd = [sys.executable, "-m", "desco_tpu_torch.main", "--train_neigh",
           "--train_gossip", "--test_gossip",
           "--train_dataset", "SynNp_24", "--valid_dataset", "SynNp_24",
           "--test_dataset", "SynNp_8_1", "--neigh_epoch_num", "2",
           "--gossip_epoch_num", "2", "--seed", str(args.seed),
           "--data_root", os.path.join(cli_dir, "data"),
           "--output_dir", os.path.join(cli_dir, "out"),
           "--neigh_model_path", os.path.join(cli_dir, "neigh"),
           "--gossip_model_path", os.path.join(cli_dir, "gossip")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                          cwd=REPO)
    check(proc.returncode == 0, f"python -m desco_tpu_torch.main exited "
          f"{proc.returncode}: {proc.stderr[-3000:]}")
    metric_lines = [ln for ln in proc.stdout.splitlines()
                    if ln.startswith("graphlet_")]
    check(len(metric_lines) == 4 and "done" in proc.stdout,
          f"entry point printed no metrics: {proc.stdout[-2000:]}")
    check("(device cuda)" in proc.stdout,
          "the entry point did not default to the CUDA device")
    for stem in ("neigh", "gossip"):
        check(os.path.exists(os.path.join(
            cli_dir, stem + ".best.params.npz")),
            f"entry point wrote no {stem}.best checkpoint")
    print(f"entry point: python -m desco_tpu_torch.main trained and "
          f"evaluated in {time.perf_counter() - t0:.1f} s (process start "
          f"and kernel load included); {metric_lines[-2]}", flush=True)
    svc_new = CountingService(os.path.join(cli_dir, "neigh.best"),
                              os.path.join(cli_dir, "gossip.best"),
                              device="cuda")
    check(svc_new.tgt_cfg.agg_mode == "kernel"
          and svc_new.cfg.neigh_hidden_dim == 64,
          "the service did not rehydrate the trained config")
    check_counts(svc_new.count(main_req[:16]), 16,
                 "request served from the trained checkpoints")
    print("service: one 16-graph request served on the card from the two "
          "checkpoints the entry point wrote", flush=True)
    workdir.cleanup()

    # ------------------------------------------------------ 8. the record
    def both(name):
        return dict(launches=launches[name] + train_launches[name],
                    launches_serving=launches[name],
                    launches_training=train_launches[name])

    kernels = [
        dict(name="sorted_segment_sum (K1)", route="cuda",
             source="desco_tpu_torch/csrc/segment_sum.cu",
             replaces="desco_tpu/ops/pallas_segment.py:310",
             **both("sorted_segment_sum"), **k1_row),
        dict(name="fused_typed_transform_aggregate (K2)", route="cuda",
             source="desco_tpu_torch/csrc/segment_sum.cu",
             replaces="desco_tpu/ops/pallas_segment.py:476",
             **both("fused_typed_transform_aggregate"), **k2_row),
        dict(name="typed_cotangent_sums (K3)", route="cuda",
             source="desco_tpu_torch/csrc/segment_sum.cu",
             replaces="desco_tpu/ops/pallas_segment.py:559",
             **both("typed_cotangent_sums"), **k3_row),
        dict(name="segment_sum_vjp (K4)", route="cuda",
             source="desco_tpu_torch/csrc/segment_sum.cu",
             replaces="desco_tpu/ops/pallas_segment.py:448",
             **both("segment_sum_vjp"), **k4_row),
    ]
    print(f"training summary: truth {truth_s:.2f} s "
          f"({truth_s / n_train_nodes * 1e3:.3f} s per 1000 nodes), "
          f"{neigh_step_ms:.2f} ms per neighborhood train step, "
          f"{gossip_step_ms:.2f} ms per gossip train step", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
