"""Spans, counters and the device trace of a traced run.

Spans are the benchmark's own: host intervals on the wall clock in ns
(``time.time_ns``, the clock the profiler stamps its device events
with), recorded around the calls into the program's layers. The device
trace is ``torch.profiler`` with CUDA activity alone (kernels, copies,
sets), read from its raw events. Busy time is the union of the device
intervals; idle is one minus busy over the traced window.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import time
from collections import defaultdict
from typing import Callable, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Span:
    name: str
    thread: int
    t0: int  # ns, wall clock
    t1: int
    info: dict


class Recorder:
    """Spans, kept in memory."""

    def __init__(self):
        self.spans: List[Span] = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str, **info):
        t0 = time.time_ns()
        try:
            yield info
        finally:
            s = Span(name, threading.get_ident(), t0, time.time_ns(), info)
            with self._lock:
                self.spans.append(s)

    def wrap(self, owner, attr: str, name: str,
             info_of: Optional[Callable] = None):
        """Replace ``owner.attr`` by a version that records a span around
        each call; ``info_of(args, kwargs, result) -> dict``, called after
        the span closes, adds to it. Returns a function that puts the
        original back."""
        fn = getattr(owner, attr)

        @functools.wraps(fn)
        def timed(*a, **k):
            with self.span(name) as info:
                out = fn(*a, **k)
            # read outside the span, so it does not count as the layer's
            if info_of is not None:
                info.update(info_of(a, k, out))
            return out

        setattr(owner, attr, timed)
        return lambda: setattr(owner, attr, fn)


@dataclasses.dataclass
class DeviceTrace:
    names: List[str]
    start: np.ndarray  # ns
    end: np.ndarray

    def busy_ns(self, lo: Optional[int] = None,
                hi: Optional[int] = None) -> float:
        return union_ns(self.start, self.end, lo, hi)

    def matching(self, patterns: Sequence[str]) -> np.ndarray:
        """Mask of the events whose name contains one of ``patterns``."""
        return np.array([any(p in n for p in patterns) for n in self.names],
                        dtype=bool)


def union_ns(start: np.ndarray, end: np.ndarray, lo: Optional[int] = None,
             hi: Optional[int] = None) -> float:
    """Length of the union of [start, end) intervals, clipped to [lo,
    hi)."""
    if lo is not None:
        start = np.maximum(start, lo)
    if hi is not None:
        end = np.minimum(end, hi)
    keep = end > start
    s, e = start[keep], end[keep]
    if not len(s):
        return 0.0
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    reach = np.maximum.accumulate(e)
    # an interval opens a new run where it starts past every earlier end
    new = np.empty(len(s), bool)
    new[0] = True
    new[1:] = s[1:] > reach[:-1]
    run_id = np.cumsum(new) - 1
    run_start = s[new]
    run_end = np.zeros(len(run_start), e.dtype)
    np.maximum.at(run_end, run_id, e)
    return float((run_end - run_start).sum())


def busy_intervals(start: np.ndarray, end: np.ndarray):
    """The union of the intervals as sorted disjoint (start, end) runs."""
    if not len(start):
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    order = np.argsort(start, kind="stable")
    s, e = start[order], end[order]
    reach = np.maximum.accumulate(e)
    new = np.empty(len(s), bool)
    new[0] = True
    new[1:] = s[1:] > reach[:-1]
    run_id = np.cumsum(new) - 1
    run_end = np.zeros(int(new.sum()), e.dtype)
    np.maximum.at(run_end, run_id, e)
    return s[new], run_end


@contextlib.contextmanager
def device_profile(enabled: bool, device_type: str = "cuda"):
    """Yields a list that holds one DeviceTrace after the block when
    ``enabled`` (the CUDA activity of the block; on the CPU, which only
    the tests ask for, its CPU operations), and stays empty otherwise."""
    out: list = []
    if not enabled:
        yield out
        return
    from torch.profiler import ProfilerActivity, profile

    on_card = device_type == "cuda"
    kind = "DeviceType.CUDA" if on_card else "DeviceType.CPU"
    with profile(activities=[ProfilerActivity.CUDA if on_card
                             else ProfilerActivity.CPU]) as prof:
        yield out
    names, start, end = [], [], []
    for ev in prof.profiler.kineto_results.events():
        if str(ev.device_type()) != kind:
            continue
        if ev.is_user_annotation():
            continue
        names.append(ev.name())
        start.append(ev.start_ns())
        end.append(ev.end_ns())
    out.append(DeviceTrace(names, np.asarray(start, np.int64),
                           np.asarray(end, np.int64)))


def span_mask(trace: DeviceTrace, spans: Sequence[Span]) -> np.ndarray:
    """Mask of the device events that start inside one of ``spans``."""
    if not spans or not len(trace.start):
        return np.zeros(len(trace.start), bool)
    t0 = np.array(sorted(s.t0 for s in spans))
    t1 = np.array([s.t1 for s in sorted(spans, key=lambda s: s.t0)])
    i = np.searchsorted(t0, trace.start, side="right") - 1
    ok = i >= 0
    inside = np.zeros(len(trace.start), bool)
    inside[ok] = trace.start[ok] < t1[i[ok]]
    return inside


def breakdown(trace: DeviceTrace, spans: Sequence[Span], lo: int, hi: int,
              host_threads: Optional[set] = None) -> dict:
    """The device operations that took most time, and the device's idle
    time inside [lo, hi) by what the host was doing (the span of
    ``host_threads`` open in the middle of each gap)."""
    dur = defaultdict(float)
    for n, s, e in zip(trace.names, trace.start, trace.end):
        dur[n] += (e - s) / 1e9
    ops = sorted(dur.items(), key=lambda kv: -kv[1])[:10]
    runs_s, runs_e = busy_intervals(np.maximum(trace.start, lo),
                                    np.minimum(trace.end, hi))
    gap_s = np.concatenate([[lo], runs_e])
    gap_e = np.concatenate([runs_s, [hi]])
    keep = gap_e > gap_s
    gap_s, gap_e = gap_s[keep], gap_e[keep]
    host = [s for s in spans
            if host_threads is None or s.thread in host_threads]
    host.sort(key=lambda s: s.t0)
    starts = np.array([s.t0 for s in host], np.int64)
    by = defaultdict(float)
    for a, b in zip(gap_s, gap_e):
        mid = (a + b) // 2
        # the latest-starting span, if it is still open at mid
        j = int(np.searchsorted(starts, mid, side="right")) - 1
        label = (host[j].name if j >= 0 and host[j].t1 > mid
                 else "between spans")
        by[label] += (b - a) / 1e9
    gaps = sorted(by.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:120], float(v)] for n, v in ops],
            "idle_gaps": [[n, float(v)] for n, v in gaps]}
