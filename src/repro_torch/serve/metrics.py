"""Serving metrics: per-request latency records + aggregate snapshots
(mirrors ``repro/serve/metrics.py``).

The registry is written from two sides — the front-end thread records
admissions, the engine worker records batch executions, completions and
learn steps — so every mutation takes the lock.  Latencies are kept in a
bounded ring (last ``window`` requests); percentiles are computed on
demand from that ring, which is the usual serving-telemetry trade-off
(exact recent-window percentiles, O(window) memory).

Two more bounded windows feed the engine's adaptive bucket selection
(DESIGN.md §6): recent arrival timestamps (``arrival_rate_hz``) and
recent microbatch group sizes (``group_p90``).  Every record method takes
an optional explicit ``now`` so tests can drive a deterministic clock.

In a multi-model engine each model owns one ``ServeMetrics``;
``ServeMetrics.aggregate`` merges a set of them into one engine-wide
snapshot (counters summed, percentiles over the concatenated latency
rings).
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, Iterable, Optional

import numpy as np


def _percentile_keys(lat: np.ndarray) -> Dict[str, float]:
    out = {}
    for name, q in (("p50_ms", 50), ("p90_ms", 90), ("p99_ms", 99)):
        out[name] = float(np.percentile(lat, q) * 1e3) if lat.size else 0.0
    out["mean_ms"] = float(lat.mean() * 1e3) if lat.size else 0.0
    return out


class ServeMetrics:
    """Thread-safe aggregate metrics for one served model."""

    def __init__(self, window: int = 4096, rate_window: int = 256):
        self._lock = threading.Lock()
        self._lat_s = collections.deque(maxlen=window)
        self._arrivals = collections.deque(maxlen=rate_window)
        self._groups = collections.deque(maxlen=rate_window)
        self.submitted = 0
        self.completed = 0
        self.batches = 0
        self.occupied_slots = 0   # genuine samples across all batches
        self.padded_slots = 0     # pad slots across all batches
        self.learn_steps = 0
        self.learn_samples = 0
        # Robustness ladder (DESIGN.md §10).  Request accounting closes:
        # submitted == completed + shed + failed + still-pending.
        self.rejected = 0         # Overloaded at admission (never admitted)
        self.shed = 0             # deadline-expired, shed at dequeue
        self.failed = 0           # completed exceptionally (infer failure)
        self.crashes = 0          # supervised worker exceptions survived
        self.bisects = 0          # group splits while isolating a poison
        self.quarantine_events = 0  # non-finite folds rolled back
        self.feedback_dropped = 0   # labeled samples lost to fold
        #                             failure or quarantine
        self._t_start: Optional[float] = None
        self._t_last: Optional[float] = None

    # ------------------------------------------------------------ record --
    def record_submit(self, n: int = 1, now: Optional[float] = None) -> None:
        now = time.perf_counter() if now is None else now
        with self._lock:
            self.submitted += n
            self._arrivals.append(now)
            if self._t_start is None:
                self._t_start = now

    def record_batch(self, n_valid: int, bucket: int) -> None:
        with self._lock:
            self.batches += 1
            self.occupied_slots += n_valid
            self.padded_slots += bucket - n_valid
            self._groups.append(n_valid)

    def record_complete(self, latency_s: float,
                        now: Optional[float] = None) -> None:
        now = time.perf_counter() if now is None else now
        with self._lock:
            self.completed += 1
            self._lat_s.append(latency_s)
            self._t_last = now

    def record_learn(self, n_samples: int) -> None:
        with self._lock:
            self.learn_steps += 1
            self.learn_samples += n_samples

    def record_rejected(self, n: int = 1) -> None:
        with self._lock:
            self.rejected += n

    def record_shed(self, n: int = 1) -> None:
        with self._lock:
            self.shed += n

    def record_failed(self, n: int = 1) -> None:
        with self._lock:
            self.failed += n

    def record_crash(self) -> None:
        with self._lock:
            self.crashes += 1

    def record_bisect(self) -> None:
        with self._lock:
            self.bisects += 1

    def record_quarantine(self) -> None:
        with self._lock:
            self.quarantine_events += 1

    def record_feedback_dropped(self, n: int) -> None:
        with self._lock:
            self.feedback_dropped += n

    # ------------------------------------------------- adaptive windows --
    def arrival_rate_hz(self) -> float:
        """Observed arrival rate over the recent-arrival window (0 until
        two arrivals have landed)."""
        with self._lock:
            if len(self._arrivals) < 2:
                return 0.0
            span = self._arrivals[-1] - self._arrivals[0]
            if span <= 0:
                return 0.0
            return (len(self._arrivals) - 1) / span

    def group_p90(self) -> float:
        """90th-percentile genuine-group size over recent microbatches
        (0 until a batch has run) — the occupancy window the adaptive
        bucket policy uses to keep a backlog-sized bucket active."""
        with self._lock:
            if not self._groups:
                return 0.0
            return float(np.percentile(np.asarray(self._groups, np.float64),
                                       90))

    # ---------------------------------------------------------- snapshot --
    def snapshot(self, queue_depth: int = 0) -> Dict[str, float]:
        """Aggregate view: throughput over the active window, latency
        percentiles over the recent ring, batching efficiency."""
        with self._lock:
            lat = np.asarray(self._lat_s, np.float64)
            elapsed = ((self._t_last - self._t_start)
                       if self._t_start is not None and self._t_last is not None
                       else 0.0)
            slots = self.occupied_slots + self.padded_slots
            out = {
                "submitted": float(self.submitted),
                "completed": float(self.completed),
                "queue_depth": float(queue_depth),
                "batches": float(self.batches),
                "batch_occupancy": (self.occupied_slots / slots
                                    if slots else 0.0),
                "learn_steps": float(self.learn_steps),
                "learn_samples": float(self.learn_samples),
                "rejected": float(self.rejected),
                "shed": float(self.shed),
                "failed": float(self.failed),
                "crashes": float(self.crashes),
                "bisects": float(self.bisects),
                "quarantine_events": float(self.quarantine_events),
                "feedback_dropped": float(self.feedback_dropped),
                "images_per_s": (self.completed / elapsed
                                 if elapsed > 0 else 0.0),
            }
        out["arrival_rate_hz"] = self.arrival_rate_hz()
        out.update(_percentile_keys(lat))
        return out

    @staticmethod
    def aggregate(metrics: Iterable["ServeMetrics"],
                  queue_depth: int = 0) -> Dict[str, float]:
        """One engine-wide snapshot over per-model registries: counters
        summed, occupancy over pooled slots, throughput over the earliest
        start / latest completion, percentiles over the concatenated
        latency rings."""
        ms = list(metrics)
        lats, t0s, t1s = [], [], []
        out = {"submitted": 0.0, "completed": 0.0, "batches": 0.0,
               "learn_steps": 0.0, "learn_samples": 0.0,
               "rejected": 0.0, "shed": 0.0, "failed": 0.0, "crashes": 0.0,
               "bisects": 0.0, "quarantine_events": 0.0,
               "feedback_dropped": 0.0}
        occupied = padded = 0
        for m in ms:
            with m._lock:
                lats.append(np.asarray(m._lat_s, np.float64))
                out["submitted"] += m.submitted
                out["completed"] += m.completed
                out["batches"] += m.batches
                out["learn_steps"] += m.learn_steps
                out["learn_samples"] += m.learn_samples
                out["rejected"] += m.rejected
                out["shed"] += m.shed
                out["failed"] += m.failed
                out["crashes"] += m.crashes
                out["bisects"] += m.bisects
                out["quarantine_events"] += m.quarantine_events
                out["feedback_dropped"] += m.feedback_dropped
                occupied += m.occupied_slots
                padded += m.padded_slots
                if m._t_start is not None:
                    t0s.append(m._t_start)
                if m._t_last is not None:
                    t1s.append(m._t_last)
        lat = np.concatenate(lats) if lats else np.zeros((0,))
        slots = occupied + padded
        elapsed = (max(t1s) - min(t0s)) if t0s and t1s else 0.0
        out["queue_depth"] = float(queue_depth)
        out["batch_occupancy"] = occupied / slots if slots else 0.0
        out["images_per_s"] = (out["completed"] / elapsed
                               if elapsed > 0 else 0.0)
        out["arrival_rate_hz"] = sum(m.arrival_rate_hz() for m in ms)
        out.update(_percentile_keys(lat))
        return out


class RouterMetrics:
    """Thread-safe counters for the cross-engine router's own failure
    ladder (the per-engine ``ServeMetrics`` stay authoritative for
    engine-side accounting; these count what only the ROUTER can see:
    reroutes, engine losses, re-placements, reconciliation outcomes).

    Router accounting closes the same way the engine's does:
    ``submitted == completed + failed + pending`` over router-issued
    ids, and ``offered == submitted + rejected`` (rejected =
    ``NoHealthyReplica`` — no engine ever admitted the request)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.submitted = 0          # admitted somewhere, router id issued
        self.completed = 0          # resolved with a result
        self.failed = 0             # resolved with a typed error
        self.rejected = 0           # NoHealthyReplica (never admitted)
        self.reroutes = 0           # extra submission attempts past the 1st
        self.engine_losses = 0      # engines declared dead
        self.replacements = 0       # models re-placed after a loss
        self.reconciliations = 0    # replica sets verified consistent
        self.mismatches = 0         # replica sets found diverged
        self.repairs = 0            # replica states repaired/installed
        self.quarantine_drains = 0  # replica-level drain+revalidate cycles
        self.crashes = 0            # survived router-maintenance errors
        self._loss_t: Dict[str, float] = {}       # engine -> loss time
        self.recovery_s: Dict[str, float] = {}    # engine -> re-place lag

    def record_submit(self, n: int = 1) -> None:
        with self._lock:
            self.submitted += n

    def record_complete(self, n: int = 1) -> None:
        with self._lock:
            self.completed += n

    def record_failed(self, n: int = 1) -> None:
        with self._lock:
            self.failed += n

    def record_rejected(self, n: int = 1) -> None:
        with self._lock:
            self.rejected += n

    def record_reroute(self, n: int = 1) -> None:
        with self._lock:
            self.reroutes += n

    def record_engine_loss(self, engine: str,
                           now: Optional[float] = None) -> None:
        now = time.perf_counter() if now is None else now
        with self._lock:
            self.engine_losses += 1
            self._loss_t[engine] = now

    def record_replacement(self, engine: str,
                           now: Optional[float] = None) -> None:
        """One model re-placed after ``engine``'s loss; the lag from the
        loss to the LAST replacement is the recovery time the bench
        reports."""
        now = time.perf_counter() if now is None else now
        with self._lock:
            self.replacements += 1
            t0 = self._loss_t.get(engine)
            if t0 is not None:
                self.recovery_s[engine] = now - t0

    def record_reconciliation(self, consistent: bool) -> None:
        with self._lock:
            if consistent:
                self.reconciliations += 1
            else:
                self.mismatches += 1

    def record_repair(self, n: int = 1) -> None:
        with self._lock:
            self.repairs += n

    def record_quarantine_drain(self) -> None:
        with self._lock:
            self.quarantine_drains += 1

    def record_crash(self) -> None:
        with self._lock:
            self.crashes += 1

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            out = {
                "submitted": float(self.submitted),
                "completed": float(self.completed),
                "failed": float(self.failed),
                "rejected": float(self.rejected),
                "reroutes": float(self.reroutes),
                "engine_losses": float(self.engine_losses),
                "replacements": float(self.replacements),
                "reconciliations": float(self.reconciliations),
                "mismatches": float(self.mismatches),
                "repairs": float(self.repairs),
                "quarantine_drains": float(self.quarantine_drains),
                "crashes": float(self.crashes),
            }
            if self.recovery_s:
                out["recovery_s_max"] = max(self.recovery_s.values())
            return out
