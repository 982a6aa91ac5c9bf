"""Admission queue + shape-bucketed microbatching (mirrors
``repro/serve/batching.py``).

Requests arrive one sample at a time; the engine wants device-sized
batches of a FIXED small set of shapes so each shape hits an
already-captured CUDA graph of ``infer_packed`` (the serving analogue of
the paper's pre-synthesized bitstreams: a handful of configurations,
selected at runtime, never recaptured).  The batcher collects whatever is
queued — up to the largest bucket, waiting at most ``max_wait_s`` after
the first request of a batch — and the collector pads the group up to the
smallest admissible bucket with zero rows plus a validity mask, which
``core.network.infer_packed`` uses to make pad-slot outputs inert.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from .errors import Overloaded


def default_buckets(max_batch: int) -> Tuple[int, ...]:
    """Powers of two up to ``max_batch`` (always including it)."""
    if max_batch < 1:
        raise ValueError("max_batch must be >= 1")
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket that fits ``n`` samples (``n`` <= max(buckets))."""
    for b in sorted(buckets):
        if b >= n:
            return b
    raise ValueError(f"group of {n} exceeds largest bucket {max(buckets)}")


def pad_group(xs: List[np.ndarray], bucket: int) -> Tuple[np.ndarray, np.ndarray]:
    """Stack samples (each (N,)) into a (bucket, N) batch + validity mask."""
    n = len(xs)
    x = np.zeros((bucket, xs[0].shape[-1]), np.float32)
    x[:n] = np.stack(xs).astype(np.float32)
    valid = np.zeros((bucket,), np.float32)
    valid[:n] = 1.0
    return x, valid


@dataclasses.dataclass
class Request:
    """One admitted inference request."""

    id: int
    x: np.ndarray                 # (N,) encoded input rates
    enqueue_t: float
    model: str = "default"        # owning model in a multi-model engine
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    result: Optional[Any] = None  # ServeResult once completed
    error: Optional[BaseException] = None
    # Absolute perf_counter deadline (None = no deadline).  Checked at
    # dequeue time: an expired request is shed BEFORE padding/compute and
    # completed with DeadlineExceeded — device time is never spent on a
    # result nobody is waiting for.
    deadline_t: Optional[float] = None

    def expired(self, now: float) -> bool:
        return self.deadline_t is not None and now > self.deadline_t


class MicroBatcher:
    """Admission queue that hands the engine bucket-sized request groups.

    ``max_depth`` bounds the queue: ``put`` raises a typed ``Overloaded``
    once the bound is reached (admission control — an unbounded queue
    converts overload into unbounded latency instead of fast rejection;
    None keeps the legacy unbounded behavior)."""

    def __init__(self, buckets: Sequence[int], max_wait_s: float = 2e-3,
                 max_depth: Optional[int] = None):
        if max_depth is not None and max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self.buckets = tuple(sorted(buckets))
        self.max_batch = self.buckets[-1]
        self.max_wait_s = max_wait_s
        self.max_depth = max_depth
        self._q: "queue.Queue[Request]" = queue.Queue()

    def put(self, req: Request) -> None:
        # qsize() is exact here: the engine admits under one lock, and a
        # concurrent worker dequeue only makes the queue SHORTER — the
        # bound can never be overshot, only momentarily under-filled.
        if self.max_depth is not None and self._q.qsize() >= self.max_depth:
            raise Overloaded(req.model, self._q.qsize(), self.max_depth)
        self._q.put(req)

    def depth(self) -> int:
        return self._q.qsize()

    def next_group(self, timeout_s: float = 0.05,
                   target: Optional[int] = None) -> List[Request]:
        """Block up to ``timeout_s`` for the first request, then drain the
        queue for at most ``max_wait_s`` more or until the group fills.
        Returns [] on timeout (lets the engine poll its stop flag and fold
        pending online-learning feedback between batches).

        ``target`` (optional) caps how large a group the collect loop
        WAITS for — the engine's adaptive bucket selection passes its
        predicted bucket here, so a low-rate stream stops dawdling for
        arrivals that won't come inside the window.  The cap never splits
        an existing backlog: whatever is already queued when the group
        starts is always admitted up to ``max_batch``.
        """
        try:
            if timeout_s > 0:
                first = self._q.get(timeout=timeout_s)
            else:
                first = self._q.get_nowait()
        except queue.Empty:
            return []
        cap = self.max_batch
        if target is not None:
            backlog = 1 + self._q.qsize()
            cap = max(min(target, self.max_batch),
                      min(backlog, self.max_batch))
        group = [first]
        deadline = time.perf_counter() + self.max_wait_s
        while len(group) < cap:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                # past the window: keep only what is already queued
                try:
                    group.append(self._q.get_nowait())
                    continue
                except queue.Empty:
                    break
            try:
                group.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return group
