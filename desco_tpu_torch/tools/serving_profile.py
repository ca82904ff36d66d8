"""Where one serving request's time goes on the GPU.

    python -m desco_tpu_torch.tools.serving_profile [--graphs 256]
        [--seed 0] [--out output/serving_profile.json]

Serves release/r4 on CUDA over random graphs drawn like Syn_1827
(data/synthetic.py): a 16-graph warm-up, then the same request twice.

1. Stage times, unprofiled: each serving stage function is wrapped with
   a host clock that synchronizes the device on entry and exit (so a
   stage owns its device work), and the request's wall time is taken
   around the whole call.
2. Device time, profiled: the request again under ``torch.profiler``
   (CPU + CUDA activity): the device's busy time (union of its kernel
   and copy intervals), its idle share over the profiled wall time, the
   number of device operations, and the kernels with the most device
   time. The profiler slows the host; its wall time is reported beside.

Prints one JSON object (and writes it to ``--out``). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import time
from collections import defaultdict

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _time_stages(torch, stages, totals):
    """Wrap ``(owner, attribute, label)`` callables with a synchronizing
    host clock that adds into ``totals[label]`` (seconds)."""
    for owner, attr, label in stages:
        fn = getattr(owner, attr)

        @functools.wraps(fn)
        def timed(*a, _fn=fn, _label=label, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                totals[_label] += time.perf_counter() - t0

        setattr(owner, attr, timed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m desco_tpu_torch.tools.serving_profile")
    ap.add_argument("--graphs", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from .. import pipeline, serving
    from ..data.synthetic import random_connected_graphs
    from ..train import loop

    if not torch.cuda.is_available():
        raise SystemExit("serving_profile needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    svc = serving.CountingService(
        os.path.join(REPO, "release/r4/neigh.best"),
        os.path.join(REPO, "release/r4/gossip.best"), device="cuda")
    rng = np.random.default_rng(args.seed)
    warm = random_connected_graphs(16, rng)
    req = random_connected_graphs(args.graphs, rng)
    svc.count(warm)

    totals: dict = defaultdict(float)
    _time_stages(torch, [
        (serving, "prepare_stage_data", "prepare (host)"),
        (loop, "predict_neighborhood_counts", "neighborhood forward"),
        (pipeline, "stage_bounds", "bounds"),
        (pipeline, "verify_tail_counts", "verify (VF2)"),
        (serving, "prepare_gossip_batches", "gossip packing (host)"),
        (serving, "predict_gossip_counts", "gossip forward"),
        (serving.CountingService, "_guard_and_package", "guards"),
    ], totals)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svc.count(req)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    stage_ms = {k: v * 1e3 for k, v in totals.items()}
    # (the guards' re-read of the memoized bounds counts under both: it
    # takes microseconds)
    stage_ms["other"] = wall_ms - sum(stage_ms.values())

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svc.count(req)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3

    device, by_kernel = [], defaultdict(lambda: [0, 0.0])
    for ev in prof.events():
        # device-side kernels and copies; user annotations mirrored on
        # the device timeline are not device work
        if (ev.device_type != DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)):
            continue
        device.append((ev.time_range.start, ev.time_range.end))
        k = by_kernel[ev.name]
        k[0] += 1
        k[1] += ev.time_range.elapsed_us()
    busy_ms = _busy_us(device) / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:12]
    out = {
        "card": card,
        "device": torch.cuda.get_device_name(0),
        "graphs": args.graphs,
        "request_ms": wall_ms,
        "stage_ms": stage_ms,
        "profiled_request_ms": prof_wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / prof_wall_ms,
        "device_ops": len(device),
        "top_kernels": [{"name": n[:100], "calls": c, "ms": us / 1e3}
                        for n, (c, us) in top],
    }
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
