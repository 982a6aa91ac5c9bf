"""The program's own spans and counters, for whoever measures it.

``span(name)`` is a range on ``torch.profiler``'s clock while a profiler
runs, and one shared null context otherwise, so tracing off costs a flag
test a call.  The range is a ``FUNCTION``-scope record
(``_RecordFunctionFast``), not ``record_function``'s user scope: the
profiler copies a user-scope range onto the card's timeline, where a
reader of the device's busy time would count it as work.  Ranges nest on
the one host thread, so each has its parent in the trace.

``FITS`` holds the reports of the process's last fits (``Trainer.fit``),
newest last: a bounded ring, as ``serve/metrics.py`` keeps the last
requests.  A reader picks a fit out by its host-clock bounds.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Deque, Dict, Tuple

import torch
import torch.autograd.profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: the range ``name`` while a profiler runs."""
    if _profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF


Interval = Tuple[float, float]


@dataclasses.dataclass(frozen=True)
class FitReport:
    """One fit on the host clock (``time.perf_counter`` seconds): its
    bounds and those of its phases, the spans of the same names
    (``repro_torch.fit.pad``, ``.h2d``, ``.unsup``, ``.sup``); the captures
    its step programs made; the kernel launches it counted (the change of
    ``kernels.ops.launch_counts()``, entries that moved); the bytes its
    ``h2d`` phase copied from the host (``h2d_bytes`` in ``fit``'s
    return)."""

    t0: float
    t1: float
    pad: Interval
    h2d: Interval
    unsup: Interval
    sup: Interval
    captures: int
    launches: Dict[str, int]
    h2d_bytes: int = 0


FITS: Deque[FitReport] = collections.deque(maxlen=1024)
