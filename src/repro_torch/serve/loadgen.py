"""Synthetic open-loop load generators for the serving engine (mirrors
``repro/serve/loadgen.py``).

Open loop means arrivals follow their own clock (Poisson at a target
rate), never waiting for responses — the honest way to measure a serving
system, since closed-loop generators self-throttle and hide queueing
collapse.  Each tick submits one sample from a pool; optionally a labeled
feedback sample rides along (the online-learning stream), emulating
deployed traffic where a fraction of predictions later gets ground truth.

``run_open_loop`` drives one model's stream; ``run_multi_open_loop``
merges several models' independent Poisson processes into one arrival
stream (superposition: combined rate = Σ rates, each arrival belongs to
model m with probability rate_m/Σ), the skewed multi-tenant load the
engine's per-model fairness is measured under.

Both generators are robustness-aware (DESIGN.md §10): an ``Overloaded``
rejection at submit is counted and the tick continues (an open-loop
client does not retry into a collapsing queue), a ``Quarantined`` slot
silently drops the feedback tick, and collection tolerates typed
per-request failures (``DeadlineExceeded``, bisected poison errors,
timeouts) — every error lands in ``LoadReport.errors`` so a chaos soak
can assert that EVERY submitted id resolved one way or the other.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

from .engine import ServeResult
from .errors import FaultInjected, Overloaded, Quarantined, ServeError

# Any serving front with submit/result/feedback and the typed error
# ladder: a BCPNNService, or a BCPNNRouter over several of them (its
# NoHealthyReplica rejection IS an Overloaded — open-loop clients need
# no router-specific branch).
ServingFront = Any


@dataclasses.dataclass
class LoadReport:
    """Outcome of one open-loop run (one model's stream).

    ``results``/``labels`` hold only the SUCCESSFUL requests (aligned,
    submission order), so ``accuracy`` is over served predictions;
    failed-but-resolved requests are in ``errors`` and never-admitted
    ones are counted by ``n_rejected``.  Accounting closes:
    submitted = len(results) + len(errors), offered = submitted +
    n_rejected."""

    results: List[ServeResult]   # successful requests, submission order
    labels: np.ndarray           # (n,) ground truth per successful request
    wall_s: float
    offered_rate_hz: float
    errors: List[BaseException] = dataclasses.field(default_factory=list)
    n_rejected: int = 0          # Overloaded at submit (never admitted)

    @property
    def achieved_rate_hz(self) -> float:
        return len(self.results) / max(self.wall_s, 1e-9)

    @property
    def max_latency_ms(self) -> float:
        return max((r.latency_ms for r in self.results), default=0.0)

    def error_counts(self) -> Dict[str, int]:
        """{error type name: count} over the resolved-with-error ids."""
        out: Dict[str, int] = {}
        for e in self.errors:
            out[type(e).__name__] = out.get(type(e).__name__, 0) + 1
        return out

    def accuracy(self, lo: float = 0.0, hi: float = 1.0) -> float:
        """Accuracy of the served predictions over the [lo, hi) fraction
        of the request stream (e.g. (0, .5) vs (.5, 1) shows online
        learning improving the stream as it runs)."""
        n = len(self.results)
        a, b = int(lo * n), max(int(lo * n) + 1, int(hi * n))
        pred = np.asarray([r.pred for r in self.results[a:b]])
        return float(np.mean(pred == self.labels[a:b]))


@dataclasses.dataclass
class StreamSpec:
    """One model's traffic in a multi-model run."""

    x_pool: np.ndarray
    y_pool: np.ndarray
    rate_hz: float
    feedback_frac: float = 0.0
    fb_x: Optional[np.ndarray] = None  # defaults to x_pool
    fb_y: Optional[np.ndarray] = None


def _submit_tick(service: ServingFront, x, model: Optional[str],
                 deadline_s: Optional[float]) -> Optional[int]:
    """One open-loop admission: the id, or None on Overloaded (the
    open-loop client counts the rejection and moves on — retrying into
    an already-full queue would just convert rejection into latency)."""
    try:
        return service.submit(x, model=model, deadline_s=deadline_s)
    except Overloaded:
        return None


def _feedback_tick(service: ServingFront, x, y: int,
                   model: Optional[str]) -> None:
    try:
        service.feedback(x, y, model=model)
    except Quarantined:
        pass  # slot degraded to inference-only; the label tick is lost


def _collect(service: ServingFront,
             submitted: List[Tuple[int, int]], timeout_s: float,
             ) -> Tuple[List[ServeResult], List[int], List[BaseException]]:
    """Resolve every submitted id: successes keep (result, label)
    aligned; typed failures (shed deadlines, bisected poison, worker
    death, collect timeout) are gathered — never raised — so one bad
    request cannot abort collection of the rest.  Anything OUTSIDE the
    typed ladder still propagates: a genuine bug must not be absorbed
    into a load report."""
    results: List[ServeResult] = []
    labels: List[int] = []
    errors: List[BaseException] = []
    for rid, label in submitted:
        try:
            results.append(service.result(rid, timeout=timeout_s))
            labels.append(label)
        except (ServeError, FaultInjected, TimeoutError) as e:
            errors.append(e)
    return results, labels, errors


def run_open_loop(
    service: ServingFront,
    x_pool: np.ndarray,
    y_pool: np.ndarray,
    n_requests: int,
    rate_hz: float,
    seed: int = 0,
    feedback_frac: float = 0.0,
    fb_x: Optional[np.ndarray] = None,
    fb_y: Optional[np.ndarray] = None,
    timeout_s: float = 120.0,
    model: Optional[str] = None,
    deadline_s: Optional[float] = None,
    replace: bool = True,
) -> LoadReport:
    """Submit ``n_requests`` samples (drawn with replacement from the
    pool, or with ``replace=False`` each pool row at most once, in a
    seeded random order) at Poisson-``rate_hz``, then collect every
    result.

    With ``feedback_frac > 0`` each tick also submits, with that
    probability, one labeled sample from the feedback pool (defaults to
    the request pool) — the label stream the online-learning mode folds
    into the network while inference traffic keeps flowing.  ``model``
    routes the whole stream to one model of a multi-model service;
    ``deadline_s`` stamps a per-request queueing deadline on every
    submit (expired requests are shed and land in ``errors``).
    """
    rng = np.random.default_rng(seed)
    picks = (rng.integers(0, len(x_pool), size=n_requests) if replace
             else rng.permutation(len(x_pool))[:n_requests])
    waits = rng.exponential(1.0 / max(rate_hz, 1e-9), size=n_requests)
    fb_x = x_pool if fb_x is None else fb_x
    fb_y = y_pool if fb_y is None else fb_y
    submitted: List[Tuple[int, int]] = []
    n_rejected = 0
    t0 = time.perf_counter()
    next_t = t0
    for k, i in enumerate(picks):
        next_t += waits[k]
        delay = next_t - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        rid = _submit_tick(service, x_pool[i], model, deadline_s)
        if rid is None:
            n_rejected += 1
        else:
            submitted.append((rid, int(y_pool[i])))
        if feedback_frac > 0 and rng.random() < feedback_frac:
            j = rng.integers(0, len(fb_x))
            _feedback_tick(service, fb_x[j], int(fb_y[j]), model)
    results, labels, errors = _collect(service, submitted, timeout_s)
    wall = time.perf_counter() - t0
    return LoadReport(results=results,
                      labels=np.asarray(labels, np.int64),
                      wall_s=wall, offered_rate_hz=rate_hz,
                      errors=errors, n_rejected=n_rejected)


def run_multi_open_loop(
    service: ServingFront,
    streams: Mapping[str, StreamSpec],
    n_requests: int,
    seed: int = 0,
    timeout_s: float = 120.0,
    deadline_s: Optional[float] = None,
) -> Dict[str, LoadReport]:
    """One merged open-loop arrival process over several models.

    ``n_requests`` total arrivals are generated from the superposed
    Poisson process (combined rate = sum of per-stream rates); each
    arrival is assigned to model ``m`` with probability
    ``rate_m / rate_total`` — the exact decomposition of independent
    Poisson streams, so each model sees Poisson arrivals at its own rate
    while the engine sees the true interleaved mix.  Returns one
    ``LoadReport`` per model.
    """
    names = list(streams)
    if not names:
        raise ValueError("run_multi_open_loop needs at least one stream")
    rates = np.asarray([streams[n].rate_hz for n in names], np.float64)
    if (rates <= 0).any():
        raise ValueError(f"every stream needs rate_hz > 0 (got {rates})")
    total = float(rates.sum())
    rng = np.random.default_rng(seed)
    owners = rng.choice(len(names), size=n_requests, p=rates / total)
    waits = rng.exponential(1.0 / total, size=n_requests)
    submitted: Dict[str, List[Tuple[int, int]]] = {n: [] for n in names}
    rejected: Dict[str, int] = {n: 0 for n in names}
    t0 = time.perf_counter()
    next_t = t0
    for k in range(n_requests):
        name = names[int(owners[k])]
        s = streams[name]
        next_t += waits[k]
        delay = next_t - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        i = rng.integers(0, len(s.x_pool))
        rid = _submit_tick(service, s.x_pool[i], name, deadline_s)
        if rid is None:
            rejected[name] += 1
        else:
            submitted[name].append((rid, int(s.y_pool[i])))
        if s.feedback_frac > 0 and rng.random() < s.feedback_frac:
            fb_x = s.x_pool if s.fb_x is None else s.fb_x
            fb_y = s.y_pool if s.fb_y is None else s.fb_y
            j = rng.integers(0, len(fb_x))
            _feedback_tick(service, fb_x[j], int(fb_y[j]), name)
    collected = {name: _collect(service, submitted[name], timeout_s)
                 for name in names}
    wall = time.perf_counter() - t0  # one clock for every stream's report
    return {name: LoadReport(
        results=collected[name][0],
        labels=np.asarray(collected[name][1], np.int64),
        wall_s=wall,
        offered_rate_hz=float(streams[name].rate_hz),
        errors=collected[name][2],
        n_rejected=rejected[name]) for name in names}
