"""The traced run: ``torch.profiler`` over the first units of the window,
read into device intervals and the benchmark's host spans.

Device intervals are the kernels, copies and fills the profiler records
on the card.  The benchmark's spans are its own ``record_function`` ranges
around each unit (``hb.unit``) and the parts of a unit that the kind
reports in host-clock time (``Span``), placed on the profiler's clock by
the unit's range.  Busy time is the union of device intervals inside the
traced window; an idle gap is a hole in that union, named by the
innermost host span that holds its middle.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

UNIT_RANGE = "hb.unit"


@dataclasses.dataclass(frozen=True)
class Span:
    """A labelled interval, host clock (``time.perf_counter`` seconds) or
    the profiler's (microseconds), as its user says."""

    label: str
    start: float
    end: float


@dataclasses.dataclass
class Trace:
    """What the traced window holds: device intervals (name, start, end in
    us), the unit ranges and the labelled host spans on the same clock."""

    device: List[Tuple[str, float, float]]
    units: List[Tuple[float, float]]
    spans: List[Span]

    @property
    def window(self) -> Tuple[float, float]:
        return self.units[0][0], self.units[-1][1]

    @property
    def window_s(self) -> float:
        w0, w1 = self.window
        return (w1 - w0) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of device intervals, clipped to the window."""
        w0, w1 = self.window
        ivs = sorted((max(s, w0), min(e, w1)) for _, s, e in self.device
                     if e > w0 and s < w1)
        merged: List[List[float]] = []
        for s, e in ivs:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """(label, seconds) of every hole in the busy union, named by
        the innermost span holding its middle."""
        w0, w1 = self.window
        gaps, at = [], w0
        for s, e in self.busy_intervals() + [(w1, w1)]:
            if s > at:
                gaps.append((self.label_at((at + s) / 2), (s - at) * 1e-6))
            at = max(at, e)
        return gaps

    def label_at(self, t: float) -> str:
        """The innermost labelled span holding t; ``between`` outside
        every unit."""
        best: Optional[Span] = None
        for sp in self.spans:
            if sp.start <= t < sp.end and (
                    best is None or sp.end - sp.start < best.end - best.start):
                best = sp
        return best.label if best is not None else "between"

    def device_time(self, match: Sequence[str]) -> Tuple[float, int]:
        """(seconds, count) of the device intervals whose name holds one
        of ``match``."""
        total, n = 0.0, 0
        for name, s, e in self.device:
            if any(m in name for m in match):
                total += (e - s) * 1e-6
                n += 1
        return total, n

    def top_ops(self, k: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for name, s, e in self.device:
            by[name] = by.get(name, 0.0) + (e - s) * 1e-6
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[name[:160], sec] for name, sec in top]

    def longest_gaps(self, k: int = 10) -> List[List]:
        return [[label, sec] for label, sec in
                sorted(self.idle_gaps(), key=lambda g: -g[1])[:k]]


def start_profiler():
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def read(prof, unit_host: Sequence[Tuple[float, float]],
         host_spans: Sequence[Sequence[Span]]) -> Trace:
    """The stopped profiler's events as a ``Trace``.  ``unit_host`` are the
    traced units' (start, end) on the host clock and ``host_spans`` each
    unit's labelled parts on the same clock; each unit's offset to the
    profiler's clock is taken from its ``hb.unit`` range."""
    from torch.autograd import DeviceType
    device, ranges = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            # the card's copy of a host range is an annotation, not work
            if e.name != UNIT_RANGE:
                device.append((e.name, float(tr.start), float(tr.end)))
        elif e.name == UNIT_RANGE:
            ranges.append((float(tr.start), float(tr.end)))
    ranges.sort()
    if len(ranges) != len(unit_host):
        raise RuntimeError(f"the trace holds {len(ranges)} unit ranges for "
                           f"{len(unit_host)} traced units")
    spans = []
    for (r0, r1), (h0, _), parts in zip(ranges, unit_host, host_spans):
        off = r0 - h0 * 1e6
        spans.append(Span("unit", r0, r1))
        spans += [Span(p.label, p.start * 1e6 + off, p.end * 1e6 + off)
                  for p in parts]
    return Trace(device=device, units=ranges, spans=spans)
