"""What a per-layer metric's reader reads: the traced window, the spans
and counters the run recorded, the device trace, and the configuration."""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from .trace import DeviceTrace, Span, span_mask, union_ns


@dataclasses.dataclass
class Context:
    cfg: dict
    traffic: dict
    trace: DeviceTrace
    spans: List[Span]
    lo: int  # the traced window on the wall clock, ns
    hi: int
    counters: Dict[str, float]
    peaks: dict
    shapes: Dict[str, list]  # per kind of batch, the live shapes served

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e9

    @property
    def busy_s(self) -> float:
        return self.trace.busy_ns(self.lo, self.hi) / 1e9

    def spans_named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def host_s(self, name: str) -> float:
        return sum(s.t1 - s.t0 for s in self.spans_named(name)) / 1e9

    def device_s_in(self, name: str, patterns=None) -> float:
        """Busy device time of the events that start inside the spans
        called ``name`` (and match one of ``patterns`` when given)."""
        mask = span_mask(self.trace, self.spans_named(name))
        if patterns is not None:
            mask &= self.trace.matching(patterns)
        return union_ns(self.trace.start[mask], self.trace.end[mask]) / 1e9

    def device_s_matching(self, patterns) -> float:
        mask = self.trace.matching(patterns)
        return union_ns(self.trace.start[mask], self.trace.end[mask],
                        self.lo, self.hi) / 1e9
