"""What the program reports of itself, read for the per-layer metrics
that rest on it: its fit reports (``repro_torch/obs.py::FITS``), the
device kernels its wrappers declare (``kernels/ops.py::device_kernels``)
and its spans in the profiler's trace (``obs.span``, names starting
``repro_torch.``).  A program without them (one older than they are)
gives nothing to read: each reader returns None then, and raises
nothing.
"""
from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

from .trace import Span, Trace
from .trace import read as read_trace

PREFIX = "repro_torch."


def fit_reports(units: Sequence[dict]) -> Optional[list]:
    """The program's report of each unit's fit, the one report whose
    host-clock bounds lie inside the unit's; None where the program keeps
    none or a unit has not exactly one."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    fits = list(obs.FITS)
    out = []
    for u in units:
        inside = [f for f in fits if u["t0"] <= f.t0 and f.t1 <= u["t1"]]
        if len(inside) != 1:
            return None
        out.append(inside[0])
    return out


def device_kernels(entry: str) -> Optional[Tuple[str, ...]]:
    """The patterns of the device kernels one call of the kernel entry
    point ``entry`` launches, as the program declares them."""
    try:
        from repro_torch.kernels import ops
        return tuple(ops.device_kernels()[entry])
    except (ImportError, AttributeError, KeyError):
        return None


def device_time(trace: Trace, patterns: Sequence[str]) -> Tuple[float, int]:
    """(seconds, count) of the device intervals whose name one of the
    patterns matches (``re.search``)."""
    total, n = 0.0, 0
    for name, s, e in trace.device:
        if any(re.search(p, name) for p in patterns):
            total += (e - s) * 1e-6
            n += 1
    return total, n


def work(trace: Trace) -> Trace:
    """The trace without the device-side copies of the program's ranges,
    which are annotations, not work."""
    return Trace(device=[d for d in trace.device
                         if not d[0].startswith(PREFIX)],
                 units=trace.units, spans=trace.spans)


def idle_us(busy: List[Tuple[float, float]], start: float,
            end: float) -> float:
    """Microseconds of [start, end) outside the sorted, disjoint busy
    intervals."""
    covered = sum(max(0.0, min(e, end) - max(s, start)) for s, e in busy)
    return (end - start) - covered


def read(prof, unit_host: Sequence[Tuple[float, float]],
         host_spans: Sequence[Sequence[Span]]) -> Trace:
    """``trace.read``'s Trace of the stopped profiler, with the program's
    ranges in place of the benchmark's own parts of each unit, which they
    cover: their device-side copies dropped from the device intervals, and
    their host-side ranges, with the unit ranges, the labelled spans; so a
    gap is named by the innermost span of the program that holds it.
    Without such ranges it is ``trace.read``'s Trace."""
    from torch.autograd import DeviceType
    ranges = [Span(e.name, float(e.time_range.start), float(e.time_range.end))
              for e in prof.events()
              if e.device_type == DeviceType.CPU and e.name.startswith(PREFIX)]
    if ranges:
        host_spans = [[] for _ in host_spans]
    tr = work(read_trace(prof, unit_host, host_spans))
    tr.spans += ranges
    return tr
