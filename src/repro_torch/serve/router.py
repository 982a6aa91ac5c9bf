"""BCPNNRouter — a fault-tolerant multi-engine serving front (mirrors
``repro/serve/router.py``).

The PR 8 ladder made ONE engine survive bad requests, bad folds and a
dying worker; the router composes N engines so the tier survives the
loss of an ENTIRE engine (DESIGN.md §11).  It fronts ``EngineHandle``s
(in-process ``LocalEngineHandle`` today; the interface is shaped for a
multiprocess transport) and owns five concerns:

* **Sticky placement with replica fan-out** — ``add_model(replicas=k)``
  pins a model to the k least-loaded engines and keeps serving it from
  those engines (stickiness keeps per-engine jit caches and adaptive
  buckets warm); hot models replicate, cheap ones do not.
* **Bounded reroute over per-engine admission** — a submit that hits
  ``Overloaded`` or ``WorkerDied`` on one replica retries on the next
  (least-depth first), at most ``max_reroutes`` extra hops; the
  ABSOLUTE deadline stamped at ROUTER admission rides along unchanged
  (``submit(deadline_t=...)``), so a rerouted request sheds at its
  original budget — a retry can never resurrect an expired request.
  Exhaustion raises ``NoHealthyReplica`` (an ``Overloaded``): the
  request was never admitted anywhere.
* **Engine-loss recovery** — a dead engine's in-flight futures were
  already completed ``WorkerDied`` by the engine's own ``_die`` (typed,
  exactly once — the router only translates ids, it never re-executes a
  possibly-served request).  The router then removes the engine from
  every placement and re-places orphaned/under-replicated models onto
  survivors, from a live peer's fold-boundary state when one exists,
  else from the model's last checkpoint (registration-time, refreshed
  at every reconciliation), moved to the device the placement serves
  on.
* **Replica-level quarantine drain** — a replica that trips the
  engine-level quarantine stops receiving new work for that model
  (``draining``), its already-admitted share drains on the engine, then
  ``revalidate()`` re-arms it and its state is repaired from a healthy
  peer before it rejoins the rotation (``heal``).
* **Replica reconciliation** — for replicated online-learning models
  the router broadcasts feedback to all replicas in one admission
  order; with ``feedback_eager=False`` engines, quiescent replicas are
  bit-identical by construction, and ``reconcile()`` verifies exactly
  that with the disjoint-support merge (``serve/reconcile.py``) —
  repairing any diverged replica from the authoritative one (max folded
  samples, finite).

Weighted fairness is delegated: placement passes each model's
``weight`` to the engines, whose start-time-fair scheduler charges
``n * cost/weight`` virtual time per microbatch — a Model-3-sized stack
pays for its size on every engine it lands on.

Copies, not shared states: the port's tensors are mutable (a fold, an
in-place step), so every replica gets tensors and a generator of its own
(``reconcile.copy_state``) — at placement, at re-placement, at repair —
and the recovery checkpoint is a host copy.  A placement serves on the
device of the state it was added with; a re-placement goes back there,
from the host checkpoint too.

Locking: ``_lock`` (RLock) guards placement/liveness; recovery runs
under it — submits briefly block while a lost engine's models re-place
(bounded, honest unavailability), and feedback broadcast holds it so
every replica sees one admission order.  ``_requests_lock`` guards only
the id map.  Router accounting closes like the engine's: every router
id resolves exactly once (result/typed error), offered = submitted +
rejected.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from .engine import BCPNNService, ServeResult
from .errors import (
    NoHealthyReplica, Overloaded, Quarantined, ServeError, WorkerDied,
)
from .handle import EngineHandle, LocalEngineHandle
from .metrics import RouterMetrics
from .reconcile import (
    copy_state, merge_replica_states, state_divergence, state_finite,
    states_bitwise_equal,
)


def _host_copy(state: Any) -> Any:
    """Host snapshot of a state, in tensors of its own (what a checkpoint
    codec would serialize — the process-boundary-safe form)."""
    return copy_state(state, "cpu")


@dataclasses.dataclass
class _Placement:
    """Router-side record of one hosted model."""

    model: str
    spec: Any
    weight: float
    online: bool                  # replicated feedback + reconciliation
    desired: int                  # replica fan-out target
    replicas: List[str]           # engine ids currently hosting (sticky)
    device: torch.device          # where every replica serves
    draining: Set[str] = dataclasses.field(default_factory=set)
    rr: int = 0                   # tie-break rotation for equal depths


class BCPNNRouter:
    """Cross-engine router over N ``EngineHandle``s (see module doc)."""

    def __init__(self, engines: Sequence[EngineHandle],
                 max_reroutes: int = 2,
                 default_deadline_s: Optional[float] = None):
        if not engines:
            raise ValueError("router needs at least one engine")
        names = [h.name for h in engines]
        if len(set(names)) != len(names):
            raise ValueError(f"engine names must be unique, got {names}")
        if max_reroutes < 0:
            raise ValueError(f"max_reroutes must be >= 0, got {max_reroutes}")
        self._engines: Dict[str, EngineHandle] = {h.name: h for h in engines}
        self.max_reroutes = max_reroutes
        self.default_deadline_s = default_deadline_s
        self._lock = threading.RLock()
        self._live: Set[str] = set(self._engines)
        self._placements: Dict[str, _Placement] = {}
        # model -> (host state, spec): the engine-loss recovery source of
        # last resort.  Written at add_model, refreshed by reconcile().
        # Its tensors are its own: no engine holds them.
        self._checkpoints: Dict[str, Tuple[Any, Any]] = {}
        self._requests: Dict[int, Tuple[str, int, str]] = {}
        self._requests_lock = threading.Lock()
        self._next_id = 0
        self._started = False
        self.metrics = RouterMetrics()
        self.engine_errors: Dict[str, BaseException] = {}
        self._last_crash: Optional[BaseException] = None
        self._maint_thread: Optional[threading.Thread] = None
        self._maint_stop = threading.Event()

    # ------------------------------------------------------- construction --
    @classmethod
    def local(cls, n_engines: int, max_reroutes: int = 2,
              default_deadline_s: Optional[float] = None,
              **engine_kwargs) -> "BCPNNRouter":
        """Router over ``n_engines`` fresh in-process engines (each an
        EMPTY ``BCPNNService`` — models arrive via ``add_model``).
        ``engine_kwargs`` (max_batch, online_learning, feedback_batch,
        feedback_eager, max_queue, fault injectors are per-engine — pass
        a list via ``fault_injectors`` ...) configure every engine."""
        if n_engines < 1:
            raise ValueError(f"need >= 1 engines, got {n_engines}")
        injectors = engine_kwargs.pop("fault_injectors", None)
        if injectors is not None and len(injectors) != n_engines:
            raise ValueError(f"fault_injectors has {len(injectors)} "
                             f"entries for {n_engines} engines")
        handles = []
        for i in range(n_engines):
            kw = dict(engine_kwargs)
            if injectors is not None:
                kw["fault_injector"] = injectors[i]
            svc = BCPNNService(name=f"engine{i}", **kw)
            handles.append(LocalEngineHandle(svc, name=f"engine{i}"))
        return cls(handles, max_reroutes=max_reroutes,
                   default_deadline_s=default_deadline_s)

    # ---------------------------------------------------------- placement --
    def add_model(self, model: str, state, spec, replicas: int = 1,
                  weight: float = 1.0,
                  online: bool = False) -> Tuple[str, ...]:
        """Place one model on the ``replicas`` least-loaded live engines
        (sticky), each with a copy of ``state`` of its own on ``state``'s
        device, where the model then serves.  ``online=True`` marks it for
        feedback broadcast + replica reconciliation.  Returns the chosen
        engine ids."""
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        with self._lock:
            if model in self._placements:
                raise ValueError(f"model {model!r} already placed")
            targets = self._pick_engines(model, replicas)
            if len(targets) < 1:
                raise RuntimeError("no live engine available for placement")
            for eid in targets:
                self._engines[eid].add_model(model, copy_state(state), spec,
                                             weight=weight,
                                             live=self._started)
            place = _Placement(model=model, spec=spec, weight=weight,
                               online=online, desired=replicas,
                               replicas=list(targets), device=state.device)
            self._placements[model] = place
            self._checkpoints[model] = (_host_copy(state), spec)
            return tuple(targets)

    def _pick_engines(self, model: str, k: int,
                      exclude: Set[str] = frozenset()) -> List[str]:
        """The k least-loaded live engines not already hosting ``model``
        (load = hosted model count, ties by engine id — deterministic)."""
        cands = [eid for eid in sorted(self._live)
                 if eid not in exclude
                 and model not in self._engines[eid].models()]
        cands.sort(key=lambda e: (len(self._engines[e].models()), e))
        return cands[:k]

    def models(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(self._placements)

    def placement(self, model: str) -> Dict[str, Any]:
        with self._lock:
            p = self._placement(model)
            return {"replicas": tuple(p.replicas), "desired": p.desired,
                    "draining": tuple(sorted(p.draining)),
                    "weight": p.weight, "online": p.online}

    def _placement(self, model: Optional[str]) -> _Placement:
        if model is None:
            if len(self._placements) == 1:
                return next(iter(self._placements.values()))
            raise ValueError(
                f"router hosts {sorted(self._placements)}; pass "
                f"model=<name> to route the request")
        try:
            return self._placements[model]
        except KeyError:
            raise KeyError(f"unknown model {model!r}; hosted: "
                           f"{sorted(self._placements)}") from None

    # ----------------------------------------------------------- lifecycle --
    def start(self, warmup: bool = True) -> "BCPNNRouter":
        with self._lock:
            for eid in sorted(self._live):
                self._engines[eid].start(warmup=warmup)
            self._started = True
        return self

    def stop(self, timeout_s: float = 60.0) -> Dict[str, BaseException]:
        """Drain every live engine.  Engines that died (chaos kills,
        real faults) raise their terminal ``WorkerDied`` from stop();
        the router RECORDS those instead of propagating — the loss was
        already handled, and a clean router shutdown must not depend on
        every engine having survived.  Returns {engine: error}."""
        self.stop_maintenance()
        errors: Dict[str, BaseException] = {}
        for eid in sorted(self._engines):
            try:
                self._engines[eid].stop(timeout_s=timeout_s)
            except (ServeError, RuntimeError) as e:
                errors[eid] = e
                self._on_engine_loss(eid, recover=False)
        with self._lock:
            self.engine_errors.update(errors)
            self._started = False
        return errors

    # ---------------------------------------------------------- data plane --
    def submit(self, x: np.ndarray, model: Optional[str] = None,
               deadline_s: Optional[float] = None) -> int:
        """Admit one sample; returns a ROUTER request id.

        The deadline becomes ABSOLUTE here, at router admission, and is
        carried verbatim across every reroute hop — the budget is one
        request's end-to-end allowance, not per-attempt.  ``Overloaded``
        / ``WorkerDied`` on a replica triggers rerouting to the next
        (bounded by ``max_reroutes`` extra attempts, each to a distinct
        replica); exhaustion — or a budget that expired mid-reroute —
        raises ``NoHealthyReplica`` without having admitted anywhere."""
        with self._lock:
            model = self._placement(model).model
        d = self.default_deadline_s if deadline_s is None else deadline_s
        deadline_t = (time.perf_counter() + d) if d is not None else None
        attempts = 0
        tried: Set[str] = set()
        last: Optional[BaseException] = None
        while attempts < 1 + self.max_reroutes:
            if deadline_t is not None and time.perf_counter() > deadline_t:
                break  # expired mid-reroute: never resurrect it
            eid = self._pick_replica(model, tried)
            if eid is None:
                break
            attempts += 1
            if attempts > 1:
                self.metrics.record_reroute()
            try:
                erid = self._engines[eid].submit(x, model=model,
                                                 deadline_t=deadline_t)
            except Overloaded as e:
                last = e
                tried.add(eid)
                continue
            except WorkerDied as e:
                last = e
                tried.add(eid)
                self._on_engine_loss(eid)
                continue
            with self._requests_lock:
                rid = self._next_id
                self._next_id += 1
                self._requests[rid] = (eid, erid, model)
            self.metrics.record_submit()
            return rid
        self.metrics.record_rejected()
        raise NoHealthyReplica(model, attempts, last)

    def _pick_replica(self, model: str, exclude: Set[str]) -> Optional[str]:
        """Least-depth live non-draining replica (deadline-aware queue
        picking: depth is the wait), ties rotated so equal-depth
        replicas share load."""
        with self._lock:
            place = self._placements[model]
            cands = [e for e in place.replicas
                     if e in self._live and e not in place.draining
                     and e not in exclude]
            if not cands:
                return None
            rr = place.rr
            place.rr = rr + 1
            order = {e: (cands.index(e) - rr) % len(cands) for e in cands}
            return min(cands, key=lambda e: (
                self._engines[e].queue_depth(model), order[e]))

    def result(self, request_id: int,
               timeout: Optional[float] = None) -> ServeResult:
        """Resolve one router id exactly once (result or typed error;
        the id is forgotten either way).  A ``WorkerDied`` here is the
        exactly-once completion of an in-flight request on a lost engine
        — the router triggers recovery and re-raises; it never re-runs
        the request (it may have executed before the death)."""
        with self._requests_lock:
            eid, erid, model = self._requests[request_id]
        try:
            res = self._engines[eid].result(erid, timeout=timeout)
        except WorkerDied:
            self.metrics.record_failed()
            self._on_engine_loss(eid)
            raise
        except BaseException:
            # typed serving errors, fault injections, timeouts — router
            # accounting counts the failure and re-raises unchanged
            self.metrics.record_failed()
            raise
        finally:
            with self._requests_lock:
                self._requests.pop(request_id, None)
        self.metrics.record_complete()
        return dataclasses.replace(res, request_id=request_id)

    def classify(self, x: np.ndarray, timeout: Optional[float] = None,
                 model: Optional[str] = None) -> ServeResult:
        return self.result(self.submit(x, model=model), timeout=timeout)

    def feedback(self, x: np.ndarray, label: int,
                 model: Optional[str] = None) -> None:
        """Broadcast one labeled sample to every live replica, under the
        router lock so all replicas see the SAME admission order — the
        precondition for bit-identical replicas (reconcile.py).  Raises
        ``Quarantined`` only if NO replica folded it (the label tick is
        lost, as the single-engine ladder already defines)."""
        for _ in range(2):  # one retry round if a loss re-placed mid-cast
            with self._lock:
                place = self._placement(model)
                model = place.model
                targets = [e for e in place.replicas if e in self._live]
                delivered = 0
                lost: List[str] = []
                for eid in targets:
                    try:
                        self._engines[eid].feedback(x, int(label), model)
                        delivered += 1
                    except Quarantined:
                        place.draining.add(eid)
                    except WorkerDied:
                        lost.append(eid)
                for eid in lost:
                    self._on_engine_loss(eid)
            if delivered > 0:
                return
            if not lost:
                break
        raise Quarantined(model)

    # ------------------------------------------------- engine-loss ladder --
    def check_engines(self) -> Tuple[str, ...]:
        """Probe liveness; declare dead engines lost (idempotent).
        Returns the engines declared lost by THIS call."""
        with self._lock:
            dead = tuple(e for e in sorted(self._live)
                         if not self._engines[e].alive())
        for eid in dead:
            self._on_engine_loss(eid)
        return dead

    def _on_engine_loss(self, eid: str, recover: bool = True) -> None:
        """Declare one engine dead and re-place its models (idempotent:
        a loss observed concurrently by submit, result, feedback and the
        maintenance probe runs recovery once).  Runs under the router
        lock: admission blocks for the (bounded) re-placement — honest,
        visible unavailability instead of racing a half-recovered
        placement."""
        with self._lock:
            if eid not in self._live:
                return
            self._live.discard(eid)
            self.metrics.record_engine_loss(eid)
            for place in self._placements.values():
                if eid in place.replicas:
                    place.replicas.remove(eid)
                    place.draining.discard(eid)
            if not recover:
                return
            for place in self._placements.values():
                self._top_up(place, lost=eid)

    def _top_up(self, place: _Placement, lost: Optional[str] = None) -> None:
        """Restore a placement to its desired replica count from live
        peer state (preferred: newest folds) or the model's checkpoint,
        copied onto the placement's device.  Caller holds the lock."""
        while True:
            live = [e for e in place.replicas if e in self._live]
            if len(live) >= place.desired:
                return
            targets = self._pick_engines(place.model, 1)
            if not targets:
                return  # not enough engines left; serve degraded
            state, spec = self._recovery_source(place, live)
            eid = targets[0]
            self._engines[eid].add_model(place.model,
                                         copy_state(state, place.device),
                                         spec,
                                         weight=place.weight,
                                         live=self._started)
            place.replicas.append(eid)
            if lost is not None:
                self.metrics.record_replacement(lost)

    def _recovery_source(self, place: _Placement,
                         live: Sequence[str]) -> Tuple[Any, Any]:
        """Newest usable state for a re-placement: a live peer's
        fold-boundary snapshot when one answers (it has every fold since
        the checkpoint), else the checkpoint."""
        for eid in live:
            if eid in place.draining:
                continue
            try:
                state = self._engines[eid].model_state_sync(place.model)
                if state_finite(state):
                    return state, self._engines[eid].model_spec(place.model)
            except (ServeError, TimeoutError):
                continue  # peer is struggling; fall through to checkpoint
        ckpt_state, ckpt_spec = self._checkpoints[place.model]
        return ckpt_state, ckpt_spec

    # ------------------------------------------- quarantine drain + heal --
    def heal(self, model: Optional[str] = None,
             drain_timeout_s: float = 30.0) -> Dict[str, List[str]]:
        """Replica-level quarantine ladder (DESIGN.md §11): quarantined
        replicas are marked ``draining`` (no new routed work — their
        share sheds to healthy peers), their already-admitted queue
        drains on the engine, then ``revalidate()`` re-arms them and
        their state is repaired from a healthy peer before they rejoin.
        Returns {model: [healed engine ids]}."""
        with self._lock:
            targets = ([self._placement(model).model] if model is not None
                       else list(self._placements))
            for m in targets:
                place = self._placements[m]
                for eid in place.replicas:
                    if eid in self._live and \
                            self._engines[eid].quarantined(m):
                        place.draining.add(eid)
            work = {m: [e for e in self._placements[m].draining
                        if e in self._live] for m in targets}
        healed: Dict[str, List[str]] = {m: [] for m in targets}
        for m, eids in work.items():
            for eid in eids:
                if self._drain_and_revalidate(m, eid, drain_timeout_s):
                    healed[m].append(eid)
        return {m: v for m, v in healed.items() if v}

    def _drain_and_revalidate(self, model: str, eid: str,
                              drain_timeout_s: float) -> bool:
        """One replica's drain -> revalidate -> repair -> rejoin."""
        handle = self._engines[eid]
        end = time.perf_counter() + drain_timeout_s
        while handle.queue_depth(model) > 0:
            if not handle.alive():
                self._on_engine_loss(eid)
                return False
            if time.perf_counter() > end:
                return False  # still draining; a later heal() retries
            time.sleep(0.005)
        with self._lock:  # freeze feedback while repairing
            place = self._placements[model]
            try:
                handle.revalidate()
                peers = [e for e in place.replicas
                         if e in self._live and e != eid
                         and e not in place.draining]
                if peers:
                    src = self._engines[peers[0]]
                    peer_state = src.model_state_sync(model)
                    handle.set_model_state(
                        model, copy_state(peer_state, place.device))
                    self.metrics.record_repair()
            except WorkerDied:
                self._on_engine_loss(eid)
                return False
            except (ServeError, TimeoutError, ValueError) as e:
                self._note_crash(e)
                return False
            place.draining.discard(eid)
            self.metrics.record_quarantine_drain()
            return True

    # ------------------------------------------------------ reconciliation --
    def reconcile(self, model: Optional[str] = None) -> Dict[str, Dict]:
        """Verify (and repair) replica consistency for online-learning
        models via the disjoint-support merge.  Holds the router lock:
        no feedback lands mid-comparison, and every state is read at a
        fold boundary (``model_state_sync``) — so a consistent verdict
        is a statement about the same folded prefix on every replica.
        Non-quiescent placements (buffered unfolded feedback) are
        SKIPPED, not guessed at: with ``feedback_eager=False`` a partial
        buffer means the replicas are mid-prefix by design.

        Returns {model: report}; consistent replica sets refresh the
        model's recovery checkpoint."""
        out: Dict[str, Dict] = {}
        with self._lock:
            targets = ([self._placement(model).model] if model is not None
                       else [m for m, p in self._placements.items()
                             if p.online])
            for m in targets:
                out[m] = self._reconcile_one(self._placements[m])
        return out

    def _reconcile_one(self, place: _Placement) -> Dict[str, Any]:
        """Caller holds the lock."""
        eids = [e for e in place.replicas
                if e in self._live and e not in place.draining]
        if not eids:
            return {"skipped": "no live replicas"}
        try:
            depths = {e: self._engines[e].feedback_depth(place.model)
                      for e in eids}
        except ServeError as e:
            self._note_crash(e)
            return {"skipped": f"telemetry failed: {e}"}
        if any(depths.values()):
            return {"skipped": f"not quiescent (buffered feedback "
                               f"{depths})"}
        states: Dict[str, Any] = {}
        for e in eids:
            try:
                states[e] = self._engines[e].model_state_sync(place.model)
            except WorkerDied:
                self._on_engine_loss(e)
            except (ServeError, TimeoutError) as err:
                self._note_crash(err)
        if not states:
            return {"skipped": "no replica answered"}
        order = sorted(states)
        merged = merge_replica_states([states[e] for e in order])
        consistent = all(states_bitwise_equal(merged, states[e])
                         for e in order)
        self.metrics.record_reconciliation(consistent)
        report: Dict[str, Any] = {"consistent": consistent,
                                  "replicas": order}
        if consistent:
            with self._lock:  # re-entrant; the lexical block is the contract
                # the merge is a host state of its own
                self._checkpoints[place.model] = (merged, place.spec)
            return report
        # diverged: crown the replica with the most folded samples (and
        # a finite state) authoritative, repair the laggards
        def folded(e: str) -> float:
            return self._engines[e].snapshot(
                model=place.model).get("learn_samples", 0.0)
        finite = [e for e in order if state_finite(states[e])]
        if not finite:
            report["repaired"] = []
            report["error"] = "no finite replica state; left untouched"
            return report
        # most folded samples wins; on a tie (e.g. a stale state restore
        # keeps the counters equal) the first replica id, deterministically
        auth = min(finite, key=lambda e: (-folded(e), e))
        repaired: List[str] = []
        for e in order:
            if e == auth or states_bitwise_equal(states[e], states[auth]):
                continue
            report.setdefault("divergence", state_divergence(
                states[auth], states[e])[:4])
            try:
                self._engines[e].set_model_state(
                    place.model, copy_state(states[auth], place.device))
                self.metrics.record_repair()
                repaired.append(e)
            except WorkerDied:
                self._on_engine_loss(e)
            except (ServeError, TimeoutError, ValueError) as err:
                self._note_crash(err)
        report["authoritative"] = auth
        report["repaired"] = repaired
        with self._lock:
            self._checkpoints[place.model] = (_host_copy(states[auth]),
                                              place.spec)
        return report

    # ----------------------------------------------------------- telemetry --
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            live = sorted(self._live)
            dead = sorted(set(self._engines) - self._live)
            placements = {m: self.placement(m) for m in self._placements}
        out: Dict[str, Any] = {"router": self.metrics.snapshot(),
                               "live_engines": live,
                               "dead_engines": dead,
                               "placements": placements}
        out["engines"] = {}
        for eid in live:
            try:
                out["engines"][eid] = self._engines[eid].snapshot()
            except (ServeError, RuntimeError) as e:
                out["engines"][eid] = {"error": repr(e)}
        return out

    def _note_crash(self, e: BaseException) -> None:
        """Supervision sink for survivable router-side errors (counted,
        never silently swallowed)."""
        self.metrics.record_crash()
        self._last_crash = e

    # ---------------------------------------------------------- maintenance --
    def start_maintenance(self, period_s: float = 1.0) -> None:
        """Background supervision: periodic liveness probe + quarantine
        heal + reconciliation.  Optional — every pass is also callable
        directly (tests drive the ladder deterministically)."""
        if self._maint_thread is not None:
            raise RuntimeError("maintenance already running")
        self._maint_stop.clear()

        def loop() -> None:
            while not self._maint_stop.wait(period_s):
                try:
                    self.check_engines()
                    self.heal()
                    self.reconcile()
                except Exception as e:
                    # supervised: a maintenance bug must not kill the
                    # router's background ladder
                    self._note_crash(e)

        self._maint_thread = threading.Thread(
            target=loop, daemon=True, name="bcpnn-router-maint")
        self._maint_thread.start()

    def stop_maintenance(self) -> None:
        t = self._maint_thread
        if t is None:
            return
        self._maint_stop.set()
        t.join(timeout=30.0)
        self._maint_thread = None
