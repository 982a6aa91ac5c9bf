"""BCPNNService — the multi-model streaming serving engine (mirrors
``repro/serve/engine.py``).

One worker thread owns N checkpointed ``DeepState``s (each a "model
slot": its own spec, shape buckets, metrics and a served-batch program
captured once per (model, bucket) as a CUDA graph,
``core/graphs.py::ServeProgram`` — the counterpart of a library of
pre-synthesized bitstreams selected at runtime) and drains a SHARED
admission front into shape-bucketed microbatches:

  * **Per-model weighted fairness**: each slot has its own admission
    queue; the worker picks the pending slot with the smallest virtual
    finish time (start-time fair queueing): serving ``n`` samples of a
    model advances its finish tag by ``n * cost / weight``, where
    ``cost`` is the model's per-sample MAC estimate from its spec and
    ``weight`` its provisioned share.  A Model-3-sized stack therefore
    pays for its size in virtual time and cannot starve cheap models;
    with equal costs and weights the tags tie every pass and the
    cursor tie-break degenerates to exact round-robin (the PR 5
    behavior — under a 10:1 skewed arrival mix the minority model is
    never more than one microbatch away from service).
  * **Adaptive bucket selection**: each model's active bucket is
    re-derived from its observed arrival-rate and group-occupancy
    windows (``ServeMetrics``): the collect loop stops waiting once the
    group reaches the bucket the observed rate can fill inside the batch
    window, instead of dawdling ``max_wait_ms`` for arrivals that won't
    come — low-rate streams get small-bucket latency, bursts still fill
    the largest bucket (an existing backlog always overrides the cap).
    All buckets stay captured (warmup covers the full set); adaptation
    only moves which bucket a group WAITS for.
  * **Online learning in deployment** (``online_learning=True``): labeled
    feedback buffers per model and is folded between inference
    microbatches.  ``learn_stack=False`` updates only the readout
    (``supervised_readout_step``); ``learn_stack=True`` additionally
    runs deterministic plasticity on every stack projection and the
    ``struct_every`` structural-plasticity cold path
    (``core.network.online_learn_step``) — receptive fields keep
    rewiring while the same deployment serves traffic, and the fold is
    bit-reproducible against an offline replay of the same feedback
    batches.

  * **Robustness ladder** (DESIGN.md §10): bounded per-model admission
    queues (``max_queue`` -> typed ``Overloaded`` rejection), per-request
    deadlines (``submit(deadline_s=...)``; expired requests are shed at
    dequeue time BEFORE padding/compute and resolve with
    ``DeadlineExceeded``), a supervised worker loop (fold/infer/adapt
    exceptions are counted and survived, never fatal; a group-level
    infer failure bisects the microbatch so one poison request resolves
    exceptionally while its groupmates still serve), learning-state
    quarantine (a non-finite post-fold state rolls back to the last-good
    snapshot and degrades the slot to inference-only until
    ``revalidate()``), and dead-worker detection (``submit``/``result``/
    ``stop`` raise ``WorkerDied`` instead of hanging if the worker
    thread ever exits abnormally — every pending future is completed
    exceptionally on the way down).

Thread model: ``submit``/``feedback`` may be called from any thread (they
only enqueue host arrays); all device work — inference and learning —
happens on the single worker thread, so no model state needs a lock and
learning can never race an in-flight forward pass.  The graphs are
captured in ``warmup()``, before the worker starts, and by
``add_model(live=True)`` on the calling thread while the worker (and
other engines' workers) serve.  A capture fails while another thread
synchronises or allocates on the card, so every engine does its card work
— captures, served batches, folds, state installs — under one lock
(``core/graphs.py::card_lock``): engines on one card take turns, and a
live capture holds the others' batches back until it ends.

On the card the folds run eagerly and out of place (never donated), so
``last_good`` keeps its own tensors and a rejected candidate is simply
never installed; each committed fold rewrites the static serving pack in
place (``ServeProgram.load``).  On the CPU the served batch runs eagerly.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.bcpnn_layer import INFER_DTYPES, validate_patchy_state
from ..core.graphs import ServeProgram, card_lock, state_tensors
from ..core.network import (
    as_spec, online_learn_step, supervised_readout_step,
)
from ..distributed.fault import StepTimer
from .batching import MicroBatcher, Request, default_buckets, pad_group, pick_bucket
from .errors import (
    DeadlineExceeded, EngineKilled, Overloaded, Quarantined, WorkerDied,
)
from .faultinject import FaultInjector
from .metrics import ServeMetrics

DEFAULT_MODEL = "default"


@dataclasses.dataclass
class ServeResult:
    """Completed inference for one request."""

    request_id: int
    probs: np.ndarray   # (n_classes,)
    pred: int
    latency_ms: float
    model: str = DEFAULT_MODEL


def cycle_batch(items: Sequence[Tuple[np.ndarray, int]],
                batch: int) -> Tuple[np.ndarray, np.ndarray]:
    """(x, y) arrays for one learn fold: a short group is padded by
    CYCLING the genuine samples (every row stays real data, so the
    batch-mean trace update needs no mask — padding only reweights within
    the batch), keeping a single learn shape.  Module-level so
    an offline parity reference can replay the engine's exact batch
    composition."""
    n = len(items)
    idx = [i % n for i in range(batch)]
    x = np.stack([items[i][0] for i in idx]).astype(np.float32)
    y = np.asarray([items[i][1] for i in idx], np.int32)
    return x, y


def _spec_cost(spec: Any) -> float:
    """Virtual per-sample service cost of one model: the MAC estimate of
    its forward pass (patchy projections count only their ``nact`` active
    input hypercolumns).  Only RATIOS between hosted models matter — the
    weighted scheduler divides by it, so equal-geometry models degenerate
    to unit quanta."""
    total = 0.0
    for p in list(spec.projs) + [spec.readout]:
        fan_in = (p.nact * p.pre.M) if p.nact else p.pre.N
        total += float(fan_in * p.post.N)
    return max(total, 1.0)


@dataclasses.dataclass
class _ModelSlot:
    """Everything one hosted model owns inside the engine."""

    name: str
    state: Any                       # DeepState (worker thread only)
    spec: Any                        # NetworkSpec
    batcher: MicroBatcher
    metrics: ServeMetrics
    program: ServeProgram            # the served batch, per bucket
    learn_fn: Any
    feedback: collections.deque
    target_bucket: int               # adaptive active bucket (worker only)
    # Weighted fair scheduling (start-time fair queueing): ``cost`` is
    # the per-sample MAC estimate from the spec, ``weight`` the
    # provisioned share, ``vft`` the slot's virtual finish tag — serving
    # n samples advances it by n * cost / weight (worker thread only).
    weight: float = 1.0
    cost: float = 1.0
    vft: float = 0.0
    pack: Any = None                 # InferParams the program serves from
    # Learning-state quarantine (worker thread only).  ``last_good`` is
    # the newest state that passed the post-fold non-finite sentinel; a
    # failing fold rolls back to it and flips ``quarantined`` — the slot
    # keeps SERVING from the last-good pack but accepts no feedback
    # until revalidate() re-arms it.
    last_good: Any = None
    quarantined: bool = False

    def repack(self) -> None:
        """Re-derive the serving-dtype inference weights from the fp32
        state.  Called at fold boundaries ONLY (model registration, after
        each feedback fold / in-deployment rewire, state swap) — never on
        the per-request path; requests between folds serve the packed
        weights as-is (DESIGN.md §8).  On the card the new pack is written
        into the tensors the bucket graphs read; a patchy pack reuses the
        memoized index table unless the mask changed (a rewire)."""
        self.pack = self.program.load(self.state)


def _validate_state(state, spec, name: str) -> None:
    # Deployment boundary for arbitrary (possibly pre-exactly-nact-fix or
    # hand-migrated) checkpoints: the patchy infer path assumes the
    # exactly-nact mask invariant, and compact-resident projections
    # additionally assume their index-table leaf agrees with the mask —
    # verify both on the concrete state before any request is served (a
    # drifted table would route the WRONG synapses silently).
    for l, (proj, pspec) in enumerate(zip(state.projs, spec.projs)):
        validate_patchy_state(proj, pspec, where=f"model {name!r} stack "
                                                 f"proj {l}")
    validate_patchy_state(state.readout, spec.readout,
                          where=f"model {name!r} readout")


@dataclasses.dataclass
class _ControlOp:
    """One deferred control-plane operation (state install/read): the
    worker runs ``fn`` at the top of its loop — a fold boundary — and
    completes ``done``; the caller blocks on it (or gets WorkerDied)."""

    fn: Any
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    result: Any = None
    error: Optional[BaseException] = None


def _state_finite(state) -> bool:
    """Cheap post-fold sentinel: True iff every float tensor of the state
    (traces, weights, biases, masks — everything a diverged fold could
    poison) is finite.  One reduction per tensor on the device, stacked,
    and one read back per fold — noise next to the learn step itself."""
    flags = [torch.isfinite(t).all() for t in state_tensors(state)
             if t.is_floating_point()]
    if not flags:
        return True
    return bool(torch.stack(flags).all())


class BCPNNService:
    """Microbatched streaming front-end over trained ``DeepState``s.

    API: ``submit`` (async admission) + ``result`` (blocking collect),
    ``classify`` (synchronous convenience), ``feedback`` (labeled sample
    for the online-learning mode), ``metrics``/``snapshot`` (aggregate +
    per-model telemetry).  Constructed single-model
    (``BCPNNService(state, spec)``) requests need no model name; use
    ``BCPNNService.multi({...})`` / ``add_model`` to host several
    checkpoints behind one admission front, then route with
    ``submit(x, model=...)``.
    """

    def __init__(self, state=None, spec_or_cfg=None, max_batch: int = 64,
                 buckets: Optional[Sequence[int]] = None,
                 max_wait_ms: float = 2.0, online_learning: bool = False,
                 feedback_batch: int = 32, metrics_window: int = 4096,
                 poll_ms: float = 20.0, result_retention: int = 4096,
                 learn_stack: bool = False, adaptive_buckets: bool = True,
                 feedback_eager: bool = True, name: str = DEFAULT_MODEL,
                 infer_dtype: Optional[str] = None,
                 max_queue: Optional[int] = None,
                 default_deadline_s: Optional[float] = None,
                 fault_injector: Optional[FaultInjector] = None):
        if infer_dtype is not None and infer_dtype not in INFER_DTYPES:
            raise ValueError(f"infer_dtype must be one of {INFER_DTYPES}, "
                             f"got {infer_dtype!r}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        # Admission control: per-model queue bound (Overloaded past it)
        # and the engine-wide default deadline stamped on every submit
        # that does not carry its own (None = no deadline).
        self.max_queue = max_queue
        self.default_deadline_s = default_deadline_s
        self.fault_injector = fault_injector
        # Engine-wide serving-precision override: when set, every hosted
        # model's spec is re-tagged with this infer_dtype at registration
        # (None = honor each spec/checkpoint's own tag).  Learning state
        # stays fp32 either way — precision only changes the derived
        # inference weights (DESIGN.md §8).
        self.infer_dtype = infer_dtype
        self.online_learning = online_learning
        self.learn_stack = learn_stack
        self.adaptive_buckets = adaptive_buckets
        # eager: fold partial feedback batches whenever the worker idles
        # (lowest label-to-weight latency).  Non-eager: fold only FULL
        # batches until the stop() drain — the fold compositions then
        # depend only on the feedback stream order, never on worker
        # timing, which is what makes a served learning run bit-exactly
        # replayable offline (the parity tests rely on this).
        self.feedback_eager = feedback_eager
        self.feedback_batch = feedback_batch
        self.metrics_window = metrics_window
        self._poll_s = poll_ms * 1e-3
        self._buckets = tuple(sorted(buckets or default_buckets(max_batch)))
        self._max_wait_s = max_wait_ms * 1e-3
        self._slots: Dict[str, _ModelSlot] = {}
        self._order: List[str] = []          # slot registration order
        self._cursor = 0                     # tie-break cursor (worker only)
        self._vclock = 0.0                   # virtual clock (worker only)
        self._fb_cursor = 0                  # next slot to fold feedback
        self._requests: Dict[int, Request] = {}
        self._requests_lock = threading.Lock()
        # Completed-but-uncollected results are retained for the most
        # recent ``result_retention`` requests only; older ones are
        # evicted so fire-and-forget submitters cannot grow the registry
        # without bound.  Collect promptly (result() frees the slot).
        self.result_retention = result_retention
        self._done_ids: collections.deque = collections.deque()
        self._next_id = 0
        self._stop = threading.Event()
        self._work = threading.Event()       # any-slot work signal
        # Admission gate: submit()/feedback() enqueue under this lock and
        # stop() sets the stop flag under it, so every enqueue strictly
        # precedes the flag flip — the worker can then treat "stop set +
        # queues empty" as "everything admitted is done" with no window
        # for a straggler to land in a dead queue.
        self._admit_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        # Worker supervision state.  ``_dead`` flips (under the admission
        # lock) only if the worker thread exits abnormally; from then on
        # submit/feedback/result/stop raise WorkerDied instead of
        # hanging, and every future pending at death completes
        # exceptionally.  ``_last_crash`` is the newest SURVIVED
        # exception (supervised: counted, never fatal).
        self._dead = threading.Event()
        self._worker_error: Optional[BaseException] = None
        self._last_crash: Optional[BaseException] = None
        # Per-microbatch wall times feed the shared straggler detector;
        # stop(tag=model) attributes outlier batches (injected slow-batch
        # faults included) to the slot that stalled.
        self.step_timer = StepTimer()
        self._batch_seq = 0
        # Control plane: deferred operations (state install/read) the
        # worker executes at the top of its loop — a fold boundary, so a
        # router-installed reconciled state can never race a fold or an
        # in-flight forward.  Appended under the admission lock; drained
        # by the worker (also under the lock) or by _die.
        self._control: collections.deque = collections.deque()
        # Chaos kill switch: set by kill(); the worker raises
        # EngineKilled on its next pass (terminal, like a real abort).
        self._kill_reason: Optional[str] = None
        if state is not None or spec_or_cfg is not None:
            if state is None or spec_or_cfg is None:
                raise ValueError("pass BOTH state and spec_or_cfg (or "
                                 "neither, for an engine that starts "
                                 "empty behind a router)")
            self.add_model(name, state, spec_or_cfg)

    @classmethod
    def multi(cls, models: Mapping[str, Tuple[Any, Any]],
              **kwargs) -> "BCPNNService":
        """Multi-model engine from ``{name: (state, spec)}`` — every
        model behind one shared admission front, served fairly."""
        items = list(models.items())
        if not items:
            raise ValueError("multi() needs at least one model")
        name0, (state0, spec0) = items[0]
        svc = cls(state0, spec0, name=name0, **kwargs)
        for name, (state, spec) in items[1:]:
            svc.add_model(name, state, spec)
        return svc

    # ---------------------------------------------------------- models ----
    def add_model(self, name: str, state, spec_or_cfg,
                  weight: float = 1.0, live: bool = False) -> None:
        """Register one checkpointed model.

        By default registration is a construction-time operation (a
        running service raises).  ``live=True`` is the router's
        engine-loss recovery path: the slot is built and, on the card, its
        bucket graphs captured on the CALLING thread (under the card lock,
        so no engine serves meanwhile), then published to the worker
        atomically under the admission lock — the worker's scheduler scan
        only ever sees it fully formed, and no request pays a capture.  A
        capture that fails raises; the slot is not published.

        ``weight`` is the model's provisioned share for the weighted
        fair scheduler (>0; service time is proportional to
        weight/cost, so a 2x weight buys 2x the virtual-time share)."""
        if self._thread is not None and not live:
            raise RuntimeError("cannot add a model to a running service "
                               "(pass live=True for an online placement, "
                               "e.g. router engine-loss recovery)")
        if name in self._slots:
            raise ValueError(f"model {name!r} already registered")
        if not (weight > 0):
            raise ValueError(f"weight must be > 0, got {weight}")
        spec = as_spec(spec_or_cfg)
        if self.infer_dtype is not None:
            spec = spec.with_infer_dtype(self.infer_dtype)
        with card_lock:
            _validate_state(state, spec, name)
        # The serving forward runs over the slot's packed inference
        # weights (InferParams), not the fp32 learning state: fp32 packs
        # hold the state's values (bit-identical to infer()), bf16/int8
        # packs are re-derived only when a fold changes the state.  The
        # folds are out of place: ``last_good`` must survive a rejected
        # candidate.
        if self.learn_stack:
            learn_fn = (lambda st, x, y, _spec=spec:
                        online_learn_step(st, _spec, x, y, learn_stack=True))
        else:
            learn_fn = (lambda st, x, y, _spec=spec:
                        supervised_readout_step(st, _spec, x, y))
        slot = _ModelSlot(
            name=name, state=state, spec=spec,
            batcher=MicroBatcher(self._buckets, max_wait_s=self._max_wait_s,
                                 max_depth=self.max_queue),
            metrics=ServeMetrics(window=self.metrics_window),
            program=ServeProgram(spec), learn_fn=learn_fn,
            feedback=collections.deque(),
            target_bucket=self._buckets[-1],
            weight=float(weight), cost=_spec_cost(spec),
            last_good=state,
        )
        with card_lock:
            slot.repack()
            if live and self._thread is not None:
                self._warm_slot(slot)  # capture off the serving path
        with self._admit_lock:
            if self._thread is not None:
                self._check_alive()
            # a late joiner starts at the current virtual clock so it
            # cannot claim credit for virtual time it never waited
            slot.vft = self._vclock
            self._slots[name] = slot
            self._order.append(name)

    def models(self) -> Tuple[str, ...]:
        return tuple(self._order)

    def _slot(self, model: Optional[str]) -> _ModelSlot:
        if model is None:
            if len(self._slots) == 1:
                return self._slots[self._order[0]]
            raise ValueError(
                f"multi-model service hosts {sorted(self._slots)}; pass "
                f"model=<name> to route the request")
        try:
            return self._slots[model]
        except KeyError:
            raise KeyError(f"unknown model {model!r}; hosted models: "
                           f"{sorted(self._slots)}") from None

    def model_state(self, model: Optional[str] = None):
        """The current DeepState of one hosted model (the worker owns it
        while running — read after ``stop`` for a settled value)."""
        return self._slot(model).state

    def model_spec(self, model: Optional[str] = None):
        return self._slot(model).spec

    def model_pack(self, model: Optional[str] = None):
        """The packed serving-dtype inference weights (``InferParams``)
        the model currently serves from — derived at the last fold
        boundary (read after ``stop`` for a settled value)."""
        return self._slot(model).pack

    def revalidate(self) -> None:
        """Re-run the deployment-boundary patchy/compact invariants on the
        CURRENT states — cheap (vectorized host check), useful after a
        run with in-deployment rewires.  Additionally re-arms any
        quarantined slot whose current (rolled-back) state is finite:
        quarantine is a degradation, not a death sentence — an operator
        (or a test) calls revalidate() to resume learning from the
        last-good snapshot."""
        with card_lock:
            for slot in self._slots.values():
                _validate_state(slot.state, slot.spec, slot.name)
                if slot.quarantined and _state_finite(slot.state):
                    slot.quarantined = False

    # --------------------------------------- single-model back-compat -----
    @property
    def state(self):
        return self.model_state()

    @state.setter
    def state(self, value):
        slot = self._slot(None)
        slot.state = value
        slot.repack()  # a state swap is a fold boundary

    @property
    def spec(self):
        return self.model_spec()

    @property
    def metrics(self) -> ServeMetrics:
        return self._slot(None).metrics

    @metrics.setter
    def metrics(self, value: ServeMetrics) -> None:
        self._slot(None).metrics = value

    @property
    def _feedback(self) -> collections.deque:
        return self._slot(None).feedback

    # ---------------------------------------------------------- lifecycle --
    def start(self, warmup: bool = True) -> "BCPNNService":
        if self._thread is not None:
            raise RuntimeError("service already started")
        if self._dead.is_set():
            raise WorkerDied(f"service worker died and cannot be "
                             f"restarted: {self._worker_error!r}")
        if warmup:
            self.warmup()
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="bcpnn-serve")
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 60.0) -> None:
        """Drain: the worker finishes everything already admitted (requests
        and feedback) before exiting; admissions racing stop() either land
        before the flag flips (and are served) or raise.

        Never hangs silently: the join is bounded by ``timeout_s`` (a
        wedged worker raises RuntimeError naming the last survived
        crash), and a worker that died abnormally raises ``WorkerDied``
        naming its terminal exception instead of returning as if the
        drain succeeded."""
        if self._thread is None:
            return
        with self._admit_lock:
            self._stop.set()
            self._work.set()
        self._thread.join(timeout_s)
        alive = self._thread.is_alive()
        self._thread = None
        if alive:
            hint = (f" (last survived crash: {self._last_crash!r})"
                    if self._last_crash is not None else "")
            raise RuntimeError(f"serving worker failed to drain within "
                               f"{timeout_s}s{hint}")
        if self._worker_error is not None:
            raise WorkerDied(f"serving worker died: "
                             f"{type(self._worker_error).__name__}: "
                             f"{self._worker_error}")

    def warmup(self) -> None:
        """On the card, capture every (model, bucket) graph and run the
        learn step once, so no request pays a capture or the kernel build
        on the serving path.  Called before the worker starts.  On the CPU
        there is nothing to prepare."""
        with card_lock:
            for slot in self._slots.values():
                self._warm_slot(slot)

    def _warm_slot(self, slot: _ModelSlot) -> None:
        """Capture a slot's buckets and warm its learn step; the caller
        holds the card lock (nothing to do on the CPU)."""
        ni, dev = slot.spec.input_geom.N, slot.state.device
        if dev.type != "cuda":
            return
        for b in self._buckets:
            if b not in slot.program.buckets:
                slot.program.capture(b)
        if self.online_learning:
            # discarded: builds the kernel library, fills launcher caches
            slot.learn_fn(
                slot.state,
                torch.zeros((self.feedback_batch, ni), dtype=torch.float32,
                            device=dev),
                torch.zeros((self.feedback_batch,), dtype=torch.int32,
                            device=dev))

    # ---------------------------------------------------------- front-end --
    def submit(self, x: np.ndarray, model: Optional[str] = None,
               deadline_s: Optional[float] = None,
               deadline_t: Optional[float] = None) -> int:
        """Admit one sample ((N,) encoded rates); returns a request id.
        Multi-model services route by ``model`` name.

        ``deadline_s`` (or the engine's ``default_deadline_s``) bounds
        how long the request may WAIT: if it is still queued past the
        deadline it is shed at dequeue time and ``result`` raises
        ``DeadlineExceeded``.  ``deadline_t`` is the same bound as an
        ABSOLUTE ``time.perf_counter()`` instant and wins over both —
        it is how a router re-submitting a rerouted request carries the
        ORIGINAL admission deadline across hops, so a retry can never
        resurrect an expired budget.  A full admission queue
        (``max_queue``) raises ``Overloaded`` here instead of admitting
        — the request is never registered, so rejection is O(1) and
        allocation-free for the engine."""
        slot = self._slot(model)
        with self._admit_lock:
            self._check_alive()
            now = time.perf_counter()
            if deadline_t is None:
                d = (self.default_deadline_s if deadline_s is None
                     else deadline_s)
                deadline_t = (now + d) if d is not None else None
            with self._requests_lock:
                rid = self._next_id
                self._next_id += 1
                req = Request(id=rid, x=np.asarray(x, np.float32),
                              enqueue_t=now, model=slot.name,
                              deadline_t=deadline_t)
                self._requests[rid] = req
            try:
                slot.batcher.put(req)
            except Overloaded:
                with self._requests_lock:
                    self._requests.pop(rid, None)
                slot.metrics.record_rejected()
                raise
            slot.metrics.record_submit(now=now)
            self._work.set()
        return rid

    def _check_alive(self) -> None:
        """Admission-side liveness gate (call under ``_admit_lock``)."""
        if self._dead.is_set():
            raise WorkerDied(f"service worker is dead: "
                             f"{self._worker_error!r}")
        if self._thread is None or self._stop.is_set():
            raise RuntimeError("service is not running")

    def result(self, request_id: int, timeout: Optional[float] = None) -> ServeResult:
        """Block until ``request_id`` completes and return its result.

        The id is forgotten on return AND on timeout — a timed-out request
        still executes (its work is already admitted) but the result is
        discarded, so abandoned requests cannot leak registry entries.

        Shed, rejected-at-source or failed requests re-raise their typed
        error here (``DeadlineExceeded``, infer failure, ...).  A worker
        that dies mid-wait completes every pending future with
        ``WorkerDied`` on its way down, so this never hangs on a dead
        service; the bounded wait slices below are belt-and-braces for a
        death racing registration.
        """
        with self._requests_lock:
            req = self._requests[request_id]
        try:
            end = (time.perf_counter() + timeout
                   if timeout is not None else None)
            while not req.done.wait(
                    0.2 if end is None
                    else max(0.0, min(0.2, end - time.perf_counter()))):
                if req.done.is_set():
                    break
                if self._dead.is_set():
                    raise WorkerDied(f"request {request_id} abandoned: "
                                     f"worker died "
                                     f"({self._worker_error!r})")
                if end is not None and time.perf_counter() >= end:
                    raise TimeoutError(f"request {request_id} not done "
                                       f"within {timeout}s")
        finally:
            with self._requests_lock:
                self._requests.pop(request_id, None)
        if req.error is not None:
            raise req.error
        return req.result

    def classify(self, x: np.ndarray, timeout: Optional[float] = None,
                 model: Optional[str] = None) -> ServeResult:
        """Synchronous convenience: submit + wait."""
        return self.result(self.submit(x, model=model), timeout=timeout)

    def feedback(self, x: np.ndarray, label: int,
                 model: Optional[str] = None) -> None:
        """Queue one labeled sample for the online-learning mode.  A
        quarantined slot raises ``Quarantined`` — it still serves
        inference from its last-good state, but learning stays off until
        ``revalidate()`` re-arms it."""
        if not self.online_learning:
            raise RuntimeError("service was built with online_learning=False")
        slot = self._slot(model)
        with self._admit_lock:
            self._check_alive()
            if slot.quarantined:
                raise Quarantined(slot.name)
            slot.feedback.append((np.asarray(x, np.float32), int(label)))
            self._work.set()

    def queue_depth(self, model: Optional[str] = None) -> int:
        if model is None and len(self._slots) != 1:
            # engine-wide total (0 for an empty router-managed engine)
            return sum(s.batcher.depth() for s in self._slots.values())
        return self._slot(model).batcher.depth()

    def feedback_depth(self, model: Optional[str] = None) -> int:
        """Buffered (not yet folded) labeled samples for one model — the
        router's quiescence probe: a replica with an empty buffer has
        folded its whole feedback prefix, which is when reconciliation
        can compare replicas bit-exactly."""
        if model is None and len(self._slots) != 1:
            return sum(len(s.feedback) for s in self._slots.values())
        return len(self._slot(model).feedback)

    def alive(self) -> bool:
        """True while the engine can take traffic: started, not stopped,
        worker not dead."""
        return (self._thread is not None and not self._dead.is_set()
                and not self._stop.is_set())

    def quarantined(self, model: Optional[str] = None) -> bool:
        return self._slot(model).quarantined

    # ----------------------------------------------------- control plane --
    def kill(self, reason: str = "killed") -> None:
        """Abrupt death (chaos testing): the worker raises
        ``EngineKilled`` on its next pass, which takes the same terminal
        ``_die`` path as a real interpreter-level failure — every
        pending future completes ``WorkerDied``, later admissions fail
        fast.  No drain, no cleanup: that is the point."""
        with self._admit_lock:
            if self._dead.is_set() or self._thread is None:
                return  # already dead or never started: nothing to kill
            self._kill_reason = reason
            self._work.set()

    def _control_call(self, fn, timeout_s: float = 60.0):
        """Run ``fn`` on the worker thread at its next fold boundary and
        return its result (raises the op's error, ``WorkerDied`` if the
        engine dies while waiting, or TimeoutError)."""
        op = _ControlOp(fn=fn)
        with self._admit_lock:
            self._check_alive()
            self._control.append(op)
            self._work.set()
        end = time.perf_counter() + timeout_s
        while not op.done.wait(0.1):
            if op.done.is_set():
                break
            if self._dead.is_set():
                raise WorkerDied(f"control op abandoned: worker died "
                                 f"({self._worker_error!r})")
            if time.perf_counter() >= end:
                raise TimeoutError(f"control op not served within "
                                   f"{timeout_s}s")
        if op.error is not None:
            raise op.error
        return op.result

    def set_model_state(self, model: Optional[str], state,
                        timeout_s: float = 60.0) -> None:
        """Install ``state`` as one model's new learning state — the
        router's replica-repair/reconciliation hook.  On a running
        engine the install happens on the worker thread at a fold
        boundary (never racing a fold or an in-flight forward) and is a
        fold boundary itself: last-good resets, the serving pack is
        re-derived, and a finite state clears any quarantine."""
        slot = self._slot(model)

        def install():
            with card_lock:
                _validate_state(state, slot.spec, slot.name)
                slot.state = state
                slot.last_good = state
                slot.repack()
                if slot.quarantined and _state_finite(state):
                    slot.quarantined = False

        if self._thread is None:
            install()
        else:
            self._control_call(install, timeout_s=timeout_s)

    def model_state_sync(self, model: Optional[str] = None,
                         timeout_s: float = 60.0):
        """One model's state read AT A FOLD BOUNDARY of the running
        worker (falls back to a direct read on a stopped engine) — the
        consistent snapshot replica reconciliation compares.  A plain
        ``model_state`` read can observe a state mid-sequence; this one
        cannot."""
        slot = self._slot(model)
        if self._thread is None:
            return slot.state
        return self._control_call(lambda: slot.state, timeout_s=timeout_s)

    def active_buckets(self, model: Optional[str] = None) -> Tuple[int, ...]:
        """The bucket subset the adaptive policy currently collects
        toward for one model (the full set stays captured; larger
        buckets re-activate instantly when a backlog demands them)."""
        target = self._slot(model).target_bucket
        return tuple(b for b in self._buckets if b <= target)

    def snapshot(self, model: Optional[str] = None) -> Dict[str, float]:
        """Aggregate engine snapshot; multi-model services additionally
        carry a ``per_model`` breakdown (each with its adaptive
        ``target_bucket``).  ``model=<name>`` narrows to one model."""
        if model is not None:
            slot = self._slot(model)
            out = slot.metrics.snapshot(queue_depth=slot.batcher.depth())
            out["target_bucket"] = float(slot.target_bucket)
            out["quarantined"] = 1.0 if slot.quarantined else 0.0
            out["straggler_events"] = float(
                sum(1 for e in self.step_timer.events
                    if e.get("tag") == slot.name))
            return out
        if len(self._slots) == 1:
            return self.snapshot(model=self._order[0])
        out = ServeMetrics.aggregate(
            (s.metrics for s in self._slots.values()),
            queue_depth=self.queue_depth())
        out["quarantined"] = float(
            sum(1 for s in self._slots.values() if s.quarantined))
        out["straggler_events"] = float(len(self.step_timer.events))
        out["per_model"] = {name: self.snapshot(model=name)
                            for name in self._order}
        return out

    # ------------------------------------------------------------- worker --
    def _run(self) -> None:
        # Outermost supervision: _serve_loop survives every Exception on
        # its own; anything that still escapes (KeyboardInterrupt, a
        # MemoryError, a bug in the supervisor itself) must not strand
        # the callers blocked in result() — _die completes every pending
        # future with WorkerDied and flips the dead flag so later
        # admissions fail fast instead of queueing into the void.
        try:
            self._serve_loop()
        except EngineKilled as e:
            self._die(e)  # intentional kill(): bookkept, no excepthook spam
        except BaseException as e:
            self._die(e)
            raise

    def _serve_loop(self) -> None:
        while True:
            group = []
            try:
                if self._kill_reason is not None:
                    raise EngineKilled(self._kill_reason)
                self._drain_control()
                group, slot = self._next_work()
                if group:
                    self._execute(slot, group)
                if self.online_learning:
                    # Fold between microbatches: immediately when a full
                    # learn batch is buffered, opportunistically when
                    # idle (eager mode only).
                    self._fold_feedback(
                        force=(not group) and self.feedback_eager)
                if self._stop.is_set() and not group \
                        and all(s.batcher.depth() == 0
                                for s in self._slots.values()):
                    while self.online_learning \
                            and any(s.feedback for s in self._slots.values()):
                        # flush EVERY model's buffer, one batch at a time
                        self._fold_feedback(force=True)
                    return
            except Exception as e:
                # Supervised: scheduler/adapt/metrics bugs are counted
                # and survived (the request-completing paths below have
                # their own containment, so nothing admitted is lost).
                self._note_crash(e)
                time.sleep(self._poll_s)  # never hot-spin a crash loop

    def _drain_control(self) -> None:
        """Serve queued control ops (state installs/reads) — the loop
        top is a fold boundary: no forward is in flight and the previous
        iteration's fold has committed."""
        while True:
            with self._admit_lock:
                if not self._control:
                    return
                op = self._control.popleft()
            try:
                with card_lock:
                    op.result = op.fn()
            except Exception as e:
                op.error = e
            op.done.set()

    def _note_crash(self, e: Exception) -> None:
        """Count one survived worker exception.  Attribution: scheduler-
        level crashes have no owning slot, so they land in the first
        slot's registry — aggregate accounting stays closed either way."""
        self._last_crash = e
        if self._order:
            self._slots[self._order[0]].metrics.record_crash()

    def _die(self, exc: BaseException) -> None:
        """Terminal path: record the killer, flip the dead flag under the
        admission gate (no new request can land after it), and complete
        every pending future exceptionally so no caller hangs."""
        self._worker_error = exc
        err = WorkerDied(f"serving worker died: "
                         f"{type(exc).__name__}: {exc}")
        with self._admit_lock:
            self._dead.set()
            with self._requests_lock:
                pending = [r for r in self._requests.values()
                           if not r.done.is_set()]
            for r in pending:
                r.error = err
                r.done.set()
            # control-plane callers must not hang on a dead worker either
            while self._control:
                op = self._control.popleft()
                op.error = err
                op.done.set()

    def _next_work(self) -> Tuple[List[Request], Optional[_ModelSlot]]:
        """Weighted fair scheduler (start-time fair queueing): among
        slots with pending requests, serve one microbatch of the slot
        with the smallest virtual start ``max(slot.vft, vclock)`` —
        serving n samples advances the slot's finish tag by
        ``n * cost / weight``, so an expensive model pays for its size
        in virtual time instead of taking one unit-cost turn per pass.
        Tag ties break by round-robin distance from the cursor, which
        makes equal-cost equal-weight slots degenerate to EXACT
        round-robin (the deterministic PR 5 fairness the scheduler tests
        pin).  ``max(vft, vclock)`` re-bases an idle slot's tag to the
        current virtual clock, so a model cannot bank credit while it
        has no traffic and then monopolize the engine.

        When nothing is pending anywhere, block briefly on the shared
        work signal (a submit landing after the scan re-sets it, so no
        wakeup is lost — the worker always rescans after the wait)."""
        n = len(self._order)
        best_i = -1
        best_key: Optional[Tuple[float, int]] = None
        for i in range(n):
            slot = self._slots[self._order[(self._cursor + i) % n]]
            if slot.batcher.depth() > 0:
                key = (max(slot.vft, self._vclock), i)
                if best_key is None or key < best_key:
                    best_key, best_i = key, i
        if best_key is None:
            self._work.wait(self._poll_s)
            self._work.clear()
            return [], None
        slot = self._slots[self._order[(self._cursor + best_i) % n]]
        self._adapt(slot)
        group = slot.batcher.next_group(
            timeout_s=0.0,
            target=(slot.target_bucket if self.adaptive_buckets
                    else None))
        if not group:
            return [], None
        self._cursor = (self._cursor + best_i + 1) % n
        start = max(slot.vft, self._vclock)
        self._vclock = start
        slot.vft = start + len(group) * slot.cost / slot.weight
        live = self._shed_expired(slot, group)
        if not live:
            # whole group expired; rescan from the advanced cursor on
            # the next loop pass
            return [], None
        return live, slot

    def _shed_expired(self, slot: _ModelSlot,
                      group: List[Request]) -> List[Request]:
        """Load shedding at the dequeue boundary: requests whose deadline
        passed while queued complete with ``DeadlineExceeded`` NOW —
        before padding and compute — so an overloaded engine spends
        device time only on results somebody is still waiting for."""
        now = time.perf_counter()
        live = [r for r in group if not r.expired(now)]
        n_shed = len(group) - len(live)
        if n_shed:
            slot.metrics.record_shed(n_shed)
            for r in group:
                if r.expired(now):
                    self._finish_exceptionally(
                        r, DeadlineExceeded(r.id,
                                            r.deadline_t - r.enqueue_t,
                                            now - r.enqueue_t))
        return live

    def _finish_exceptionally(self, r: Request,
                              exc: BaseException) -> None:
        """Complete one request's future with a typed error (no-op if it
        already resolved) and keep the done-id retention window tight."""
        if r.done.is_set():
            return
        r.error = exc
        r.done.set()
        self._done_ids.append(r.id)
        self._evict_done()

    def _evict_done(self) -> None:
        while len(self._done_ids) > self.result_retention:
            stale = self._done_ids.popleft()  # usually already collected
            with self._requests_lock:
                self._requests.pop(stale, None)

    def _adapt(self, slot: _ModelSlot) -> None:
        """Re-derive the slot's active bucket from its observed windows:
        the group the arrival rate can fill inside one batch window
        (with headroom), floored by the recent p90 group size so a
        steady backlog-driven batch keeps its bucket."""
        if not self.adaptive_buckets:
            slot.target_bucket = self._buckets[-1]
            return
        window = self._max_wait_s + self._poll_s
        predicted = slot.metrics.arrival_rate_hz() * window * 1.5
        want = max(1.0, predicted, slot.metrics.group_p90())
        n = min(int(math.ceil(want)), self._buckets[-1])
        slot.target_bucket = pick_bucket(n, self._buckets)

    def _execute(self, slot: _ModelSlot, group: List[Request]) -> None:
        """Supervised microbatch execution with poison bisection.

        A request handed to _execute ALWAYS resolves.  A group-level
        infer failure splits the group and retries each half (recursion
        depth log2(max_batch)): a single poison request costs O(log n)
        retry batches and resolves exceptionally ALONE — its groupmates
        still get genuine results instead of inheriting its error, and
        a transient failure simply succeeds on retry.

        The deadline check repeats at EVERY bisection hop against the
        request's absolute ``deadline_t``: retry time is queue time, so
        a request whose budget ran out during its groupmate's isolation
        sheds here instead of being resurrected by the retry."""
        group = self._shed_expired(slot, group)
        if not group:
            return
        try:
            self._infer_group(slot, group)
        except Exception as e:
            slot.metrics.record_crash()
            if len(group) == 1:
                slot.metrics.record_failed()
                self._finish_exceptionally(group[0], e)
                return
            slot.metrics.record_bisect()
            mid = len(group) // 2
            self._execute(slot, group[:mid])
            self._execute(slot, group[mid:])

    def _infer_group(self, slot: _ModelSlot, group: List[Request]) -> None:
        """One padded forward + completion sweep (raises on failure; the
        caller owns containment)."""
        bucket = pick_bucket(len(group), self._buckets)
        inj = self.fault_injector
        self._batch_seq += 1
        self.step_timer.start()
        try:
            if inj is not None:
                f = inj.maybe("slow-batch")
                if f is not None:
                    time.sleep(f.delay_s)  # injected straggler
                k = inj.maybe("engine-kill")
                if k is not None:
                    # BaseException: skips every supervision layer and
                    # lands in _die — the whole engine goes down with
                    # this batch in flight (router chaos soak fodder)
                    raise EngineKilled(
                        f"injected engine-kill (invocation {k.index})")
                inj.check_group([r.id for r in group])
                inj.raise_if("infer-raise")
            x, valid = pad_group([r.x for r in group], bucket)
            with card_lock:
                probs, pred = slot.program.serve(x, valid)
        finally:
            # even a failing batch is a timed step: injected or genuine
            # stragglers surface as events attributed to this model
            self.step_timer.stop(self._batch_seq, tag=slot.name)
        t_done = time.perf_counter()
        slot.metrics.record_batch(n_valid=len(group), bucket=bucket)
        for i, r in enumerate(group):
            r.result = ServeResult(request_id=r.id, probs=probs[i],
                                   pred=int(pred[i]),
                                   latency_ms=(t_done - r.enqueue_t) * 1e3,
                                   model=slot.name)
            slot.metrics.record_complete(t_done - r.enqueue_t)
            r.done.set()
            self._done_ids.append(r.id)
        self._evict_done()

    def _fold_feedback(self, force: bool = False) -> None:
        """At most ONE learn fold per call, rotating fairly across models:
        one ``learn_fn`` step (readout-only or stack+rewire, see
        ``learn_stack``) on up to ``feedback_batch`` buffered labeled
        samples of the first slot, from the feedback cursor, that is
        ready (full batch buffered, or anything buffered under
        ``force``).

        The fold is the engine's only state-mutating path, so its
        containment lives here: a raising fold drops that batch's
        samples and keeps serving (counted), and every fold's output
        passes the non-finite sentinel BEFORE it is committed — a
        diverged fold rolls the slot back to the last-good snapshot
        (bit-identical: the candidate state is simply never installed)
        and quarantines the slot to inference-only mode."""
        n = len(self._order)
        for i in range(n):
            j = (self._fb_cursor + i) % n
            slot = self._slots[self._order[j]]
            with self._admit_lock:
                if not slot.feedback:
                    continue
                if slot.quarantined:
                    # inference-only: feedback admitted before the
                    # quarantine flipped is dropped (counted), so a
                    # stop() drain can never wedge on a dead buffer
                    dropped = len(slot.feedback)
                    slot.feedback.clear()
                    slot.metrics.record_feedback_dropped(dropped)
                    continue
                if len(slot.feedback) < self.feedback_batch and not force:
                    continue
                items = [slot.feedback.popleft()
                         for _ in range(min(len(slot.feedback),
                                            self.feedback_batch))]
            self._fb_cursor = (j + 1) % n
            with card_lock:
                inj = self.fault_injector
                try:
                    if inj is not None:
                        inj.raise_if("fold-raise")
                    x, y = cycle_batch(items, self.feedback_batch)
                    dev = slot.state.device
                    cand = slot.learn_fn(slot.state,
                                         torch.from_numpy(x).to(dev),
                                         torch.from_numpy(y).to(dev))
                    if inj is not None and \
                            inj.maybe("nan-state") is not None:
                        cand = FaultInjector.corrupt_state(cand)
                except Exception:
                    # survived: this batch's labels are lost, serving and
                    # later folds continue on the unchanged state
                    slot.metrics.record_crash()
                    slot.metrics.record_feedback_dropped(len(items))
                    return
                if not _state_finite(cand):
                    # Quarantine: the candidate is never installed, so the
                    # slot keeps serving from ``last_good`` unchanged — the
                    # explicit restore makes the rollback contract literal
                    # (and bitwise-checkable).
                    slot.metrics.record_quarantine()
                    slot.metrics.record_feedback_dropped(len(items))
                    slot.state = slot.last_good
                    slot.quarantined = True
                    return
                slot.state = cand
                slot.last_good = cand
                # THE fold boundary: the fold (and any struct_every rewire
                # inside it) just replaced the fp32 state, so the packed
                # serving weights are re-derived here — stale int8 scales
                # or bf16 casts never outlive a fold.
                slot.repack()
                slot.metrics.record_learn(len(items))
                return
