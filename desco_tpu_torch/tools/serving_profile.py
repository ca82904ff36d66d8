"""Where one serving request's time goes on the GPU.

    python -m desco_tpu_torch.tools.serving_profile [--graphs 256]
        [--seed 0] [--out output/serving_profile.json] [--eager]

Serves release/r4 on CUDA over random graphs drawn like Syn_1827
(data/synthetic.py): a 16-graph warm-up and the request once, untimed (it
pins its buckets and, graphed, captures their forwards, as a service's
first request of a shape does), then the same request twice.

1. Stage times, unprofiled: each serving stage function is wrapped with
   a host clock that synchronizes the device on entry and exit (so a
   stage owns its device work), and the request's wall time is taken
   around the whole call.
2. Device time, profiled: the request again under ``torch.profiler``
   (CPU + CUDA activity): the device's busy time (union of its kernel
   and copy intervals), its idle share over the profiled wall time, the
   number of device operations, and the kernels with the most device
   time. The profiler slows the host; its wall time is reported beside.

The service replays its compiled forwards (CUDA graphs) as it does by
default; ``--eager`` serves with the eager forwards. The object names the
mode (``graphed``) and, graphed, the forwards held, their captures and
capture seconds and the bytes of their memory pool (``compiled``).

Prints one JSON object (and writes it to ``--out``). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
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


def stage_clock(torch):
    """A context manager that wraps each serving stage function with a
    host clock that synchronizes the device on entry and exit (so a stage
    owns its device work) and puts the functions back on exit; it yields
    {stage: seconds}."""
    from .. import pipeline, serving
    from ..parallel import dp

    stages = [
        (serving, "prepare_stage_data", "prepare (host)"),
        (dp, "dp_predict_neighborhood_counts", "neighborhood forward"),
        (pipeline, "stage_bounds", "bounds"),
        (pipeline, "verify_tail_counts", "verify (VF2)"),
        (serving, "prepare_gossip_batches", "gossip packing (host)"),
        (serving, "dp_predict_gossip_counts", "gossip forward"),
        (serving.CountingService, "_guard_and_package", "guards")]

    @contextlib.contextmanager
    def clock():
        totals = {label: 0.0 for _, _, label in stages}
        saved = [(owner, attr, getattr(owner, attr))
                 for owner, attr, _ in stages]
        for (owner, attr, label), (_, _, fn) in zip(stages, saved):
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
        try:
            yield totals
        finally:
            for owner, attr, fn in saved:
                setattr(owner, attr, fn)

    return clock()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m desco_tpu_torch.tools.serving_profile")
    ap.add_argument("--graphs", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--eager", action="store_true",
                    help="serve with the eager forwards")
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from .. import serving
    from ..data.synthetic import random_connected_graphs

    if not torch.cuda.is_available():
        raise SystemExit("serving_profile needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    svc = serving.CountingService(
        os.path.join(REPO, "release/r4/neigh.best"),
        os.path.join(REPO, "release/r4/gossip.best"), device="cuda",
        graphed=not args.eager)
    rng = np.random.default_rng(args.seed)
    warm = random_connected_graphs(16, rng)
    req = random_connected_graphs(args.graphs, rng)
    svc.count(warm)
    svc.count(req)

    with stage_clock(torch) as totals:
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
        "graphed": svc.graphed,
        "compiled": svc.graphs.stats() if svc.graphs is not None else None,
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
