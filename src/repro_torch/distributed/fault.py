"""Fault-tolerance utilities (mirrors ``repro/distributed/fault.py``):
the worker-loss signal and the straggler detector.

Straggler mitigation is observability first: per-step wall times are
tracked online (median + MAD), and outlier steps are attributed and
logged so a scheduler can drain or replace slow hosts.  The elastic mesh
helpers of the JAX module belong to the data-parallel fit, which is not
ported yet (ROADMAP.md queue A item 7).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np


class WorkerLost(RuntimeError):
    """A worker (device or host) dropped out of the run.

    Raised by fault-injection hooks (``Trainer.fit(on_chunk=...)``) and by
    real loss detectors; the recovery is to restore the latest checkpoint
    and resume the fit from its stored cursor."""


@dataclasses.dataclass
class StepTimer:
    """Online step-time tracker with robust outlier detection.

    ``_times`` is trimmed to the last ``window`` entries on every
    ``stop``, so the tracker is O(window) memory however long the serving
    engine or fit runs; ``median`` is the median of that window, the
    statistic the outlier test uses."""

    window: int = 50
    threshold: float = 3.0  # MADs above median = straggler event
    _times: List[float] = dataclasses.field(default_factory=list)
    _t0: Optional[float] = None
    events: List[dict] = dataclasses.field(default_factory=list)

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, step: int, tag: Optional[str] = None) -> float:
        """Close the started window; ``tag`` attributes the step to an
        owner (the serving engine passes the model name).  A ``stop()``
        with no open window is a caller bug and raises."""
        if self._t0 is None:
            raise RuntimeError(
                f"StepTimer.stop(step={step}, tag={tag!r}) called without "
                f"a prior start() — every timed window must be opened "
                f"with start() before it is closed")
        dt = time.perf_counter() - self._t0
        self._t0 = None
        hist = self._times  # already at most `window` entries
        if len(hist) >= 8:
            med = float(np.median(hist))
            mad = float(np.median(np.abs(np.asarray(hist) - med))) + 1e-9
            if dt > med + self.threshold * 1.4826 * mad:
                ev = {"step": step, "time": dt, "median": med}
                if tag is not None:
                    ev["tag"] = tag
                self.events.append(ev)
        self._times.append(dt)
        if len(self._times) > self.window:
            del self._times[: -self.window]
        return dt

    @property
    def median(self) -> float:
        """Median over the retained window (the last ``window`` steps)."""
        return float(np.median(self._times)) if self._times else 0.0
