"""The port's spans and counters: where a request's or a step's host time
goes, on the clock the device profiler stamps its events with.

Off by default. ``enable()`` turns recording on for the whole process and
``disable()`` off; ``drain()`` hands back what was recorded since the last
drain and forgets it. While tracing is off a span site costs one test of
a global: ``span`` returns one shared context manager that does nothing
and ``add`` returns at once, so no clock is read and no record is made.

A span (``Span``) is a named host interval on one thread, ``t0`` to
``t1`` in ``time.time_ns()`` nanoseconds: the wall clock
``torch.profiler`` stamps its device events with, so a device kernel or
copy can be placed under the span open when it ran (``innermost``). A
span's parent is the span open on the same thread when it began; its
request is the id of the serving request it works for, given to the
outermost span of a request and inherited by every span inside it.
``drain`` sets each span's ``self_ns``: its duration less what its
children cover. A counter is a named integer that sites add to.

The serving stream (serving.py): ``request.prepare`` on the producer
thread (children ``prepare.decompose``, ``prepare.pack``),
``request.wait`` from the end of a request's preparation to the serving
thread taking it from the queue (time blocked handing it over and time
queued), ``stream.starved`` while the serving thread waits for the next
request, ``request.serve`` around its device stages and guards; counters
``requests``, ``graphs``. Inside a request: ``device_lock.wait`` (taking
the lock over the device stages), ``stage1.*`` and ``gossip.*`` (the
neighborhood and gossip forwards: ``.stage`` the batches' copy to the
card, ``.replay`` each compiled forward's call, ``.readback`` stacking
and reading the predictions back), ``bounds.*`` (``.host`` the query
schedules and automorphism factors, then as above), ``verify``,
``gossip.pack``, ``guards``; counter ``h2d_bytes``, the bytes of the host
arrays copied to the card. Compiled steps and forwards
(utils/cuda_graphs.py): ``graph.capture``, ``step.copy_in`` (the batch
into the static buffers), ``step.replay``, ``step.collective`` (a split
point's collective across ranks); counters ``copy_in_bytes``,
``replays``, ``captures``.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

_on = False
_lock = threading.Lock()
_spans: List["Span"] = []
_counters: Dict[str, int] = {}
_local = threading.local()
_ids = itertools.count(1)
_requests = itertools.count(1)


class Span:
    """One recorded host interval (see the module's docstring)."""

    __slots__ = ("name", "thread", "t0", "t1", "id", "parent", "request",
                 "info", "self_ns")

    def __init__(self, name: str, thread: int, t0: int, t1: int, id: int,
                 parent: Optional[int], request: Optional[int],
                 info: dict):
        self.name, self.thread, self.t0, self.t1 = name, thread, t0, t1
        self.id, self.parent, self.request = id, parent, request
        self.info = info
        self.self_ns = t1 - t0


class _Off:
    """The one context manager every span site gets while tracing is
    off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    """A span being recorded: opened on ``__enter__``, kept on ``__exit__``."""

    __slots__ = ("name", "request", "info", "span")

    def __init__(self, name: str, request: Optional[int], info: dict):
        self.name, self.request, self.info = name, request, info

    def __enter__(self) -> Span:
        stack = _stack()
        up = stack[-1] if stack else None
        request = self.request
        if request is None and up is not None:
            request = up.request
        s = self.span = Span(self.name, threading.get_ident(), 0, 0,
                             next(_ids), up.id if up is not None else None,
                             request, self.info)
        stack.append(s)
        s.t0 = time.time_ns()
        return s

    def __exit__(self, *exc) -> bool:
        s = self.span
        s.t1 = time.time_ns()
        stack = _stack()
        if stack and stack[-1] is s:
            stack.pop()
        with _lock:
            _spans.append(s)
        return False


def enable() -> None:
    """Record spans and counters from now on, on every thread."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording; what was recorded stays until ``drain``."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def span(name: str, request: Optional[int] = None, **info):
    """A context manager that records the span ``name`` around its block
    and yields the ``Span`` (None while tracing is off). ``request``: the
    id of the request it serves (default: its parent's); ``info``: a few
    values kept with it."""
    if not _on:
        return _OFF
    return _Open(name, request, info)


def add(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    if not _on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def record(name: str, t0: int, t1: int, request: Optional[int] = None,
           thread: Optional[int] = None, **info) -> None:
    """Keep a span already timed (``t0``, ``t1`` from ``now()``) that
    belongs to no open span, on ``thread`` (default: the caller's): an
    interval that began on another thread."""
    if not _on:
        return
    s = Span(name, thread if thread is not None else threading.get_ident(),
             t0, t1, next(_ids), None, request, info)
    with _lock:
        _spans.append(s)


def now() -> Optional[int]:
    """``time.time_ns()`` while tracing is on, None while it is off."""
    return time.time_ns() if _on else None


def new_request() -> Optional[int]:
    """A fresh request id while tracing is on, None while it is off."""
    return next(_requests) if _on else None


def lock(held, name: str):
    """``held`` (a lock) as a context manager whose acquisition is the
    span ``name`` while tracing is on; ``held`` itself while it is off."""
    if not _on:
        return held
    return _TimedLock(held, name)


class _TimedLock:
    __slots__ = ("held", "name")

    def __init__(self, held, name: str):
        self.held, self.name = held, name

    def __enter__(self):
        with span(self.name):
            self.held.acquire()
        return self.held

    def __exit__(self, *exc) -> bool:
        self.held.release()
        return False


def drain() -> Tuple[List[Span], Dict[str, int]]:
    """(spans, counters) recorded since the last drain, which are
    forgotten here; each span's ``self_ns`` is set. Spans still open are
    kept by the drain after they close."""
    with _lock:
        spans = list(_spans)
        counters = dict(_counters)
        _spans.clear()
        _counters.clear()
    _set_self_times(spans)
    return spans, counters


def _set_self_times(spans: Sequence[Span]) -> None:
    """Each span's ``self_ns``: its duration less the union of its
    children's intervals inside it."""
    kids = defaultdict(list)
    for s in spans:
        if s.parent is not None:
            kids[s.parent].append(s)
    for s in spans:
        covered, reach = 0, s.t0
        for c in sorted(kids.get(s.id, ()), key=lambda c: c.t0):
            a, b = max(c.t0, reach), min(c.t1, s.t1)
            if b > a:
                covered += b - a
                reach = b
        s.self_ns = (s.t1 - s.t0) - covered


def innermost(spans: Sequence[Span], times: Sequence[int],
              threads: Optional[set] = None) -> List[Optional[Span]]:
    """Per time in ``times`` (ns), the innermost span open at it (the
    latest-starting of those that contain it) among the spans of
    ``threads`` (every thread when None); None where none is open."""
    host = sorted((s for s in spans
                   if threads is None or s.thread in threads),
                  key=lambda s: s.t0)
    out: List[Optional[Span]] = [None] * len(times)
    # one sweep in time order: the open spans on a heap, latest start on
    # top; a span that has closed stays closed for every later time
    heap: list = []
    j = 0
    for i in sorted(range(len(times)), key=lambda i: times[i]):
        t = times[i]
        while j < len(host) and host[j].t0 <= t:
            heapq.heappush(heap, (-host[j].t0, j))
            j += 1
        while heap and host[heap[0][1]].t1 <= t:
            heapq.heappop(heap)
        if heap:
            out[i] = host[heap[0][1]]
    return out
