"""Deterministic fault injection for the serving robustness layer (mirrors
``repro/serve/faultinject.py``).

The engine exposes four named injection points, consulted only when a
``FaultInjector`` is wired in (``BCPNNService(fault_injector=...)``) —
production wiring passes ``None`` and pays a single attribute check:

* ``infer-raise`` — the forward of one microbatch raises
  (transient device/runtime failure).  Exercises the engine's
  poison-request bisection: the group splits and retries, so a
  transient failure costs a retry, not the whole batch.
* ``fold-raise`` — one feedback fold raises mid-learn.  Exercises
  worker supervision: the crash is counted, the batch's labeled samples
  are dropped, and the worker keeps serving.
* ``nan-state``  — the state a fold produced is corrupted with a NaN
  before the engine's non-finite sentinel sees it.  Exercises
  learning-state quarantine: rollback to the last-good snapshot +
  inference-only degradation.
* ``slow-batch`` — one microbatch is delayed by ``slow_ms`` before
  compute (a straggler).  Exercises the ``StepTimer`` wiring: the delay
  must surface as an attributed straggler event, not silent tail
  latency.
* ``engine-kill`` — the engine worker raises ``EngineKilled`` (a
  BaseException) before one microbatch's compute: the WHOLE engine dies
  abruptly, every pending future completes ``WorkerDied``.  Exercises
  the router's engine-loss recovery (reroute + re-placement).

Determinism: every point owns an independent counter and an independent
``np.random.default_rng([seed, point_index])`` stream, so WHICH
invocation of a point fires depends only on ``(seed, rates/schedule)``,
never on thread timing or on the other points' traffic.  An explicit
``schedule={point: {indices}}`` pins exact firing invocations (the unit
tests use this); ``rates={point: p}`` drives the seeded Bernoulli
schedule (the chaos soak uses this).  ``poison(request_id)`` marks
specific admitted requests as malformed — the engine raises
``FaultInjected`` for any microbatch containing one, which is what the
bisection isolates.

Every fired fault is recorded in ``events`` (point, invocation index,
wall time) so a soak can attribute exactly what was injected.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Iterable, List, Mapping, Optional, Set

import numpy as np

from .errors import FaultInjected

# "engine-kill" is appended LAST so the per-point rng stream indices of
# the original four points stay stable across seeds recorded in older
# soak baselines.  It is consulted on the microbatch path and raises
# EngineKilled (a BaseException): the whole engine dies abruptly — the
# router-level chaos soak uses it to exercise engine-loss recovery.
POINTS = ("infer-raise", "fold-raise", "nan-state", "slow-batch",
          "engine-kill")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One fired injection: which point, its per-point invocation index,
    and (slow-batch only) the injected delay."""

    point: str
    index: int
    delay_s: float = 0.0
    t: float = 0.0   # wall time at firing (attribution only)


class FaultInjector:
    """Seeded, thread-safe fault schedule over the engine's named
    injection points."""

    def __init__(self, seed: int = 0,
                 rates: Optional[Mapping[str, float]] = None,
                 schedule: Optional[Mapping[str, Iterable[int]]] = None,
                 slow_ms: float = 25.0):
        for m in (rates or {}), (schedule or {}):
            unknown = set(m) - set(POINTS)
            if unknown:
                raise ValueError(f"unknown injection points {sorted(unknown)}; "
                                 f"known: {list(POINTS)}")
        self.seed = seed
        self.slow_ms = slow_ms
        self._rates = {p: float((rates or {}).get(p, 0.0)) for p in POINTS}
        self._schedule = {p: set((schedule or {}).get(p, ()))
                          for p in POINTS}
        # one independent stream per point: point A's traffic volume can
        # never shift WHICH of point B's invocations fire
        self._rngs = {p: np.random.default_rng([seed, i])
                      for i, p in enumerate(POINTS)}
        self._counts = {p: 0 for p in POINTS}
        self._poison: Set[int] = set()
        self._lock = threading.Lock()
        self.events: List[Fault] = []

    # ------------------------------------------------------------ points --
    def maybe(self, point: str) -> Optional[Fault]:
        """Advance ``point``'s invocation counter; return a ``Fault`` if
        this invocation fires (explicit schedule first, then the seeded
        Bernoulli draw — the draw happens every invocation so the stream
        stays aligned with the counter regardless of the schedule)."""
        with self._lock:
            k = self._counts[point]
            self._counts[point] = k + 1
            draw = float(self._rngs[point].random())
            fire = k in self._schedule[point] or draw < self._rates[point]
            if not fire:
                return None
            f = Fault(point=point, index=k,
                      delay_s=(self.slow_ms * 1e-3
                               if point == "slow-batch" else 0.0),
                      t=time.perf_counter())
            self.events.append(f)
            return f

    def raise_if(self, point: str) -> None:
        """``maybe`` + raise ``FaultInjected`` when the point fires."""
        f = self.maybe(point)
        if f is not None:
            raise FaultInjected(f"injected {point} "
                                f"(invocation {f.index}, seed {self.seed})")

    # ----------------------------------------------------------- poison --
    def poison(self, request_id: int) -> None:
        """Mark one admitted request as malformed: any microbatch that
        contains it fails infer, until bisection isolates it."""
        with self._lock:
            self._poison.add(request_id)

    def check_group(self, request_ids: Iterable[int]) -> None:
        """Raise ``FaultInjected`` if the group contains a poisoned id
        (the engine calls this where a malformed input would crash the
        forward)."""
        with self._lock:
            bad = [r for r in request_ids if r in self._poison]
        if bad:
            raise FaultInjected(f"injected poison request(s) {bad}")

    # -------------------------------------------------------- nan-state --
    @staticmethod
    def corrupt_state(state):
        """A new state equal to ``state`` but with a NaN in the first
        element of its first float tensor (the first stack projection's
        ``pi``): what a numerically-diverged fold looks like to the
        sentinel.  ``state``'s own tensors are not written (the corrupted
        tensor is a copy), so a last-good snapshot that shares them stays
        intact for the rollback."""
        p0 = state.projs[0]
        pi = p0.traces.pi.clone()
        pi.view(-1)[0] = float("nan")
        proj = dataclasses.replace(
            p0, traces=dataclasses.replace(p0.traces, pi=pi))
        return dataclasses.replace(state, projs=(proj,) + state.projs[1:])

    # ----------------------------------------------------------- report --
    def counts(self) -> Dict[str, int]:
        """Fired-event count per point (attribution summary)."""
        with self._lock:
            out = {p: 0 for p in POINTS}
            for f in self.events:
                out[f.point] += 1
            return out
