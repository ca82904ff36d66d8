"""Where one serving request's time goes on the GPU.

    python -m desco_tpu_torch.tools.serving_profile [--graphs 256]
        [--seed 0] [--out output/serving_profile.json] [--eager]

Serves release/r4 on CUDA over random graphs drawn like Syn_1827
(data/synthetic.py): a 16-graph warm-up and the request once, untimed (it
pins its buckets and, graphed, captures their forwards, as a service's
first request of a shape does), then the same request twice.

1. Host time by span, unprofiled: the request under the port's tracer
   (utils/trace.py), with no synchronize added: each span's self time
   (its duration less its children's), summed by span name, and the
   request's wall time around the whole call.
2. Device time by span, profiled: the request again under the tracer
   and ``torch.profiler`` (CUDA activity), whose device events carry the
   tracer's clock: the device's busy time (union of its kernel and copy
   intervals), its idle share over the profiled wall time, the number of
   device operations, the kernels with the most device time, and, by
   the innermost span open on the serving thread, the device time that
   began under it and the device's idle time (each gap by its middle).
   The profiler slows the host; its wall time is reported beside.

The service replays its compiled forwards (CUDA graphs) as it does by
default; ``--eager`` serves with the eager forwards. The object names the
mode (``graphed``) and, graphed, the forwards held, their captures and
capture seconds and the bytes of their memory pool (``compiled``).

Prints one JSON object (and writes it to ``--out``). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import threading
import time
from collections import defaultdict

import numpy as np

from ..utils import trace

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


def self_ms(spans) -> dict:
    """{span name: {"ms": summed self time, "calls": spans}}, largest
    first."""
    out = defaultdict(lambda: {"ms": 0.0, "calls": 0})
    for sp in spans:
        out[sp.name]["ms"] += sp.self_ns / 1e6
        out[sp.name]["calls"] += 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["ms"]))


def device_events(prof) -> list:
    """(name, start ns, end ns) of every device kernel, copy and set in a
    finished ``torch.profiler`` run, on ``time.time_ns``'s clock; user
    annotations mirrored on the device timeline are not device work."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if (str(ev.device_type()) != "DeviceType.CUDA"
                or ev.is_user_annotation()):
            continue
        out.append((ev.name(), ev.start_ns(), ev.end_ns()))
    return out


def under_spans(events, spans, lo: int, hi: int, threads: set) -> dict:
    """The device's busy ms by the innermost span of ``threads`` open
    when each event began, and its idle ms inside [lo, hi) by the one
    open in the middle of each gap ("between spans" where none is)."""
    busy, idle = defaultdict(float), defaultdict(float)
    starts = [s for _, s, _ in events]
    for (_, s, e), sp in zip(events, trace.innermost(spans, starts,
                                                     threads)):
        busy[sp.name if sp is not None else "between spans"] += (e - s) / 1e6
    gaps, reach = [], lo
    for _, s, e in sorted(events, key=lambda ev: ev[1]):
        if s > reach:
            gaps.append((reach, min(s, hi)))
        reach = max(reach, e)
    if hi > reach:
        gaps.append((reach, hi))
    gaps = [(a, b) for a, b in gaps if b > a]
    for (a, b), sp in zip(gaps, trace.innermost(
            spans, [(a + b) // 2 for a, b in gaps], threads)):
        idle[sp.name if sp is not None else "between spans"] += (b - a) / 1e6

    def order(d):
        return dict(sorted(d.items(), key=lambda kv: -kv[1]))

    return {"busy_ms": order(busy), "idle_ms": order(idle)}


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

    trace.drain()
    trace.enable()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.count(req)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        spans, counters = trace.drain()
        span_ms = self_ms(spans)
        # the serving thread's time outside every span
        other_ms = wall_ms - sum(sp.self_ns for sp in spans
                                 if sp.thread == threading.get_ident()
                                 ) / 1e6

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            lo = time.time_ns()
            t0 = time.perf_counter()
            svc.count(req)
            torch.cuda.synchronize()
            prof_wall_ms = (time.perf_counter() - t0) * 1e3
            hi = time.time_ns()
    finally:
        trace.disable()
    prof_spans, _ = trace.drain()

    events = device_events(prof)
    by_kernel = defaultdict(lambda: [0, 0.0])
    for name, s, e in events:
        k = by_kernel[name]
        k[0] += 1
        k[1] += (e - s) / 1e3
    busy_ms = _busy_us([(s, e) for _, s, e in events]) / 1e6
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:12]
    out = {
        "card": card,
        "device": torch.cuda.get_device_name(0),
        "graphs": args.graphs,
        "graphed": svc.graphed,
        "compiled": svc.graphs.stats() if svc.graphs is not None else None,
        "request_ms": wall_ms,
        "span_ms": span_ms,
        "other_ms": other_ms,
        "counters": counters,
        "profiled_request_ms": prof_wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / prof_wall_ms,
        "device_ops": len(events),
        "device_by_span": under_spans(events, prof_spans, lo, hi,
                                      {threading.get_ident()}),
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
