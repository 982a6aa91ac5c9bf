"""Typed failure ladder of the serving tier (DESIGN.md §10; mirrors
``repro/serve/errors.py``).

Every way a request or a labeled feedback sample can fail to be served
normally has ONE exception type, so clients can branch on class instead
of parsing messages:

* ``Overloaded``       — rejected at admission: the target model's queue
  is at its ``max_queue`` bound.  The request was never admitted; retry
  with backoff (or against a replica).
* ``DeadlineExceeded`` — admitted, but shed at dequeue time because its
  per-request deadline had already expired before padding/compute.  No
  device work was spent on it.
* ``WorkerDied``       — the engine worker thread exited abnormally; the
  request (and every other pending one) was completed exceptionally so
  nothing hangs.  The service instance is dead — ``stop()`` re-raises
  the cause.
* ``Quarantined``      — the target model's learning state tripped the
  non-finite sentinel and the slot is serving inference-only from its
  last-good snapshot; labeled feedback is refused until
  ``revalidate()`` clears the quarantine.
* ``FaultInjected``    — raised by ``serve/faultinject.py`` injection
  points (and by nothing else); seeing it outside a fault-injection run
  means an injector leaked into production wiring.

``ServeError`` is the common base for the first four, so "any serving
failure" is one except clause.
"""
from __future__ import annotations


class ServeError(RuntimeError):
    """Base class of all typed serving-tier failures."""


class Overloaded(ServeError):
    """Admission rejected: the per-model queue is at its bound."""

    def __init__(self, model: str, depth: int, max_queue: int):
        super().__init__(
            f"model {model!r} queue at max_queue bound "
            f"({depth}/{max_queue}); request rejected at admission")
        self.model = model
        self.depth = depth
        self.max_queue = max_queue


class NoHealthyReplica(Overloaded):
    """Router-level rejection: every candidate replica rejected the
    request (``Overloaded``/``WorkerDied``) within the bounded reroute
    budget, or the request's deadline expired mid-reroute.  Subclasses
    ``Overloaded`` so open-loop clients that already treat admission
    rejection as "count and move on" need no new branch — the request
    was never admitted anywhere."""

    def __init__(self, model: str, attempts: int,
                 last_error: "BaseException | None" = None):
        detail = (f"; last: {type(last_error).__name__}: {last_error}"
                  if last_error is not None else "")
        RuntimeError.__init__(
            self, f"model {model!r}: no healthy replica admitted the "
                  f"request after {attempts} attempt(s){detail}")
        self.model = model
        self.attempts = attempts
        self.last_error = last_error
        self.depth = -1        # Overloaded attr compat: not one queue's
        self.max_queue = -1    # bound but the whole replica set's


class EngineKilled(BaseException):
    """Injected abrupt engine death (chaos testing only).  Deliberately
    a ``BaseException`` so the supervised worker loop's ``except
    Exception`` does NOT survive it — it reaches the terminal ``_die``
    path exactly like a real interpreter-level failure would, completing
    every pending future with ``WorkerDied``."""


class DeadlineExceeded(ServeError):
    """Admitted request shed at dequeue: its deadline expired before
    padding/compute."""

    def __init__(self, request_id: int, deadline_s: float, waited_s: float):
        super().__init__(
            f"request {request_id} shed: deadline {deadline_s * 1e3:.1f}ms "
            f"expired after {waited_s * 1e3:.1f}ms in queue")
        self.request_id = request_id
        self.deadline_s = deadline_s
        self.waited_s = waited_s


class WorkerDied(ServeError):
    """The engine worker thread exited abnormally; pending requests were
    completed with this error so nothing hangs."""


class Quarantined(ServeError):
    """The model's learning state is quarantined (inference-only from
    its last-good snapshot); feedback is refused until revalidate()."""

    def __init__(self, model: str):
        super().__init__(
            f"model {model!r} is quarantined (non-finite learning state "
            f"detected and rolled back); serving inference-only — call "
            f"revalidate() to re-arm learning")
        self.model = model


class FaultInjected(RuntimeError):
    """Raised only by serve/faultinject.py injection points."""
