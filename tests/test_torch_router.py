"""The port's multi-engine router (``repro_torch.serve.BCPNNRouter``), on
the CPU at small sizes: the 18 cases of ``tests/test_router.py`` (sticky
placement with replica fan-out, bounded reroute carrying the ORIGINAL
absolute deadline, engine-loss recovery with exactly-once typed failure,
replica quarantine drain + heal, weighted fairness, reconciliation, and
the engine-loss chaos soak, here seeded: kills and faults at request and
invocation indices, no timers), one comparison with the JAX router over
the same numpy state, and the port's own rules: every replica owns its
tensors and generator, and a recovered model comes back on the device its
placement serves on.

Tolerances: served probabilities against the JAX router within 1e-5 with
equal predictions; the port's replicas, repairs and recoveries bitwise.
"""
import sys
import time
from typing import Any, Dict, Tuple

import jax
import numpy as np
import pytest
import torch

from repro.configs.bcpnn_models import deep_synth_spec as j_deep_synth_spec
from repro.core import network as jn
from repro.serve import BCPNNRouter as JRouter
from repro_torch import convert
from repro_torch.configs.bcpnn_models import deep_synth_spec
from repro_torch.core import infer, init_deep
from repro_torch.core.graphs import state_tensors
from repro_torch.serve import (
    BCPNNRouter, BCPNNService, EngineHandle, FaultInjected, FaultInjector,
    NoHealthyReplica, Overloaded, Request, ServeError, WorkerDied,
    merge_replica_states, run_open_loop, state_finite, states_bitwise_equal,
)
from repro_torch.serve.reconcile import copy_state

FWD_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(side=6, n_classes=3):
    return dict(side=side, depth=1, n_classes=n_classes, hidden_hc=4,
                hidden_mc=8)


def _small_net(seed=0, side=6, n_classes=3):
    spec = deep_synth_spec(backend="cuda", **_kw(side, n_classes))
    return spec, init_deep(spec, seed, "cpu")


def _stream(spec, n, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.random((n, spec.input_geom.N)).astype(np.float32)
    ys = rng.integers(0, spec.n_classes, size=n).astype(np.int64)
    return xs, ys


def _wait(cond, what="condition", timeout_s=30.0):
    deadline = time.perf_counter() + timeout_s
    while not cond():
        assert time.perf_counter() < deadline, f"{what} never held"
        time.sleep(0.005)


def _quiescent(r, model="m"):
    _wait(lambda: not any(r._engines[e].feedback_depth(model)
                          for e in r.placement(model)["replicas"]),
          "feedback never folded")


def _storages(state):
    return {t.untyped_storage().data_ptr() for t in state_tensors(state)}


def _owns(a, b) -> bool:
    """``a`` shares no tensor storage and no generator with ``b``."""
    return not (_storages(a) & _storages(b)) and \
        a.generator is not b.generator


# ------------------------------------------------------- stub engines --
# The router is EngineHandle-typed, so the admission/reroute/deadline
# ladder is unit-testable against scripted engines — no worker threads,
# no timing, every hop observable.

class _StubEngine(EngineHandle):
    """Scripted EngineHandle: raises what it is told at submit, records
    every hop's deadline_t."""

    def __init__(self, name: str, fail=()):
        self.name = name
        self.fail = list(fail)        # exceptions to raise, in order
        self.seen_deadlines = []      # deadline_t of every submit hop
        self.submits = 0
        self._models: Dict[str, Tuple[Any, Any]] = {}
        self._depth = 0
        self._alive = True

    def models(self):
        return tuple(self._models)

    def add_model(self, model, state, spec, weight=1.0, live=False):
        self._models[model] = (state, spec)

    def start(self, warmup=True):
        pass

    def stop(self, timeout_s=60.0):
        pass

    def alive(self):
        return self._alive

    def submit(self, x, model, deadline_t=None):
        self.seen_deadlines.append(deadline_t)
        self.submits += 1
        if self.fail:
            raise self.fail.pop(0)
        return self.submits

    def result(self, request_id, timeout=None):
        raise NotImplementedError

    def queue_depth(self, model=None):
        return self._depth

    def feedback_depth(self, model=None):
        return 0

    def quarantined(self, model):
        return False

    def model_spec(self, model):
        return self._models[model][1]

    def model_state_sync(self, model, timeout_s=60.0):
        return self._models[model][0]


def _stub_state():
    return _small_net()[1]


def _stub_router(*stubs, **kw):
    r = BCPNNRouter(stubs, **kw)
    r.add_model("m", _stub_state(), spec=None, replicas=len(stubs))
    return r


def test_reroute_on_overload_reaches_healthy_replica():
    a = _StubEngine("a", fail=[Overloaded("m", 8, 8)])
    b = _StubEngine("b")
    r = _stub_router(a, b)
    rid = r.submit(np.zeros(4, np.float32))
    assert rid == 0 and b.submits == 1
    snap = r.metrics.snapshot()
    assert snap["reroutes"] == 1 and snap["submitted"] == 1
    assert snap["rejected"] == 0


def test_reroute_exhaustion_raises_no_healthy_replica():
    stubs = [_StubEngine(n, fail=[Overloaded("m", 8, 8)])
             for n in ("a", "b", "c")]
    r = _stub_router(*stubs, max_reroutes=2)
    with pytest.raises(NoHealthyReplica) as ei:
        r.submit(np.zeros(4, np.float32))
    assert ei.value.attempts == 3
    assert isinstance(ei.value, Overloaded)
    assert isinstance(ei.value.last_error, Overloaded)
    snap = r.metrics.snapshot()
    assert snap["rejected"] == 1 and snap["submitted"] == 0
    assert snap["reroutes"] == 2  # the bound held: 1 + max_reroutes hops


def test_reroute_budget_bound_each_hop_distinct_replica():
    """max_reroutes bounds EXTRA attempts, and no replica is retried."""
    stubs = [_StubEngine(n, fail=[Overloaded("m", 8, 8)] * 5)
             for n in ("a", "b", "c", "d", "e")]
    r = _stub_router(*stubs, max_reroutes=3)
    with pytest.raises(NoHealthyReplica):
        r.submit(np.zeros(4, np.float32))
    assert sum(s.submits for s in stubs) == 4  # 1 + max_reroutes
    assert max(s.submits for s in stubs) == 1  # all distinct replicas


def test_worker_died_at_submit_triggers_loss_and_reroute():
    a = _StubEngine("a", fail=[WorkerDied("boom")])
    b = _StubEngine("b")
    r = _stub_router(a, b)
    rid = r.submit(np.zeros(4, np.float32))
    assert rid == 0 and b.submits >= 1
    snap = r.metrics.snapshot()
    assert snap["engine_losses"] == 1
    assert "a" not in r.snapshot()["live_engines"]
    assert "b" in r.placement("m")["replicas"]


def test_rerouted_request_carries_original_deadline():
    """The ABSOLUTE deadline stamped at router admission is what every
    hop sees — a reroute does not refresh the budget."""
    a = _StubEngine("a", fail=[Overloaded("m", 8, 8)])
    b = _StubEngine("b")
    r = _stub_router(a, b)
    t0 = time.perf_counter()
    r.submit(np.zeros(4, np.float32), deadline_s=5.0)
    assert len(a.seen_deadlines) == 1 and len(b.seen_deadlines) == 1
    assert a.seen_deadlines[0] == b.seen_deadlines[0]
    assert abs(a.seen_deadlines[0] - (t0 + 5.0)) < 0.5


def test_expired_budget_is_never_resurrected_by_reroute():
    """A request whose original budget expired while the first hop was
    failing is SHED at the router — the healthy replica never sees it."""

    class _SlowOverload(_StubEngine):
        def submit(self, x, model, deadline_t=None):
            self.seen_deadlines.append(deadline_t)
            self.submits += 1
            time.sleep(0.06)  # hop latency eats the whole budget
            raise Overloaded("m", 8, 8)

    a = _SlowOverload("a")
    b = _StubEngine("b")
    r = _stub_router(a, b)
    with pytest.raises(NoHealthyReplica) as ei:
        r.submit(np.zeros(4, np.float32), deadline_s=0.03)
    assert b.submits == 0
    assert ei.value.attempts == 1
    assert r.metrics.snapshot()["rejected"] == 1


def test_router_rejects_bad_construction():
    st = _stub_state()
    with pytest.raises(ValueError, match="at least one"):
        BCPNNRouter([])
    with pytest.raises(ValueError, match="unique"):
        BCPNNRouter([_StubEngine("a"), _StubEngine("a")])
    r = BCPNNRouter([_StubEngine("a")])
    with pytest.raises(ValueError, match="replicas"):
        r.add_model("m", st, None, replicas=0)
    r.add_model("m", st, None)
    with pytest.raises(ValueError, match="already placed"):
        r.add_model("m", st, None)
    with pytest.raises(KeyError, match="unknown model"):
        r.submit(np.zeros(2, np.float32), model="nope")


def test_placement_spreads_least_loaded_and_replicates_distinct():
    stubs = [_StubEngine(n) for n in ("a", "b", "c")]
    r = BCPNNRouter(stubs)
    st = _stub_state()
    assert r.add_model("m0", st, None) == ("a",)
    assert r.add_model("m1", st, None) == ("b",)   # least-loaded next
    assert r.add_model("m2", st, None) == ("c",)
    got = r.add_model("m3", st, None, replicas=2)
    assert len(set(got)) == 2                      # distinct engines
    held = [stubs["abc".index(e)]._models["m3"][0] for e in got]
    assert _owns(held[0], held[1]) and _owns(held[0], st)  # copies
    with pytest.raises(ValueError, match="pass model"):
        r.submit(np.zeros(2, np.float32))          # ambiguous: 4 models


# ----------------------------------------------------- live integration --

def test_routed_classify_matches_direct_infer_across_replicas():
    spec, state = _small_net()
    r = BCPNNRouter.local(3, max_batch=4)
    r.add_model("m", state, spec, replicas=2)
    r.start()
    xs, _ = _stream(spec, 8, seed=2)
    try:
        got = [r.classify(x, timeout=30) for x in xs]
        ids = [r.submit(x) for x in xs]
        got += [r.result(i, timeout=30) for i in ids]
    finally:
        r.stop()
    _, pred_ref = infer(state, spec, torch.from_numpy(xs))
    ref = pred_ref.tolist()
    assert [g.pred for g in got] == ref + ref
    snap = r.metrics.snapshot()
    assert snap["completed"] == snap["submitted"] == 16
    assert snap["failed"] == snap["rejected"] == 0


def test_feedback_broadcast_keeps_replicas_bitwise_identical():
    """One admission order + feedback_eager=False => quiescent replicas
    are bit-identical, and the disjoint-support merge equals both."""
    spec, state = _small_net()
    r = BCPNNRouter.local(2, max_batch=4, online_learning=True,
                          feedback_batch=4, feedback_eager=False)
    r.add_model("m", state, spec, replicas=2, online=True)
    r.start()
    xs, ys = _stream(spec, 12, seed=3)
    try:
        for x, y in zip(xs, ys):
            r.feedback(x, int(y), model="m")
        _quiescent(r)
        rep = r.reconcile()
    finally:
        r.stop()
    assert rep["m"]["consistent"], rep
    states = [r._engines[e].model_state_sync("m")
              for e in r.placement("m")["replicas"]]
    assert states_bitwise_equal(states[0], states[1])
    assert _owns(states[0], states[1])
    assert states_bitwise_equal(merge_replica_states(states), states[0])
    assert not states_bitwise_equal(states[0], state)


def test_reconcile_repairs_diverged_replica():
    """A replica whose state drifts (forced via set_model_state) is
    detected by the merge contract and repaired from the replica with
    the most folded samples."""
    spec, state = _small_net()
    r = BCPNNRouter.local(2, max_batch=4, online_learning=True,
                          feedback_batch=4, feedback_eager=False)
    r.add_model("m", state, spec, replicas=2, online=True)
    r.start()
    xs, ys = _stream(spec, 8, seed=4)
    try:
        for x, y in zip(xs, ys):
            r.feedback(x, int(y), model="m")
        _quiescent(r)
        lagger = r.placement("m")["replicas"][1]
        r._engines[lagger].set_model_state("m", copy_state(state))  # stale
        rep = r.reconcile()["m"]
        assert rep["consistent"] is False
        assert rep["repaired"] == [lagger]
        assert rep["authoritative"] != lagger
        assert rep["divergence"]  # names the drifted leaves
        rep2 = r.reconcile()["m"]
        assert rep2["consistent"] is True
    finally:
        r.stop()
    snap = r.metrics.snapshot()
    assert snap["mismatches"] == 1 and snap["repairs"] == 1
    assert snap["reconciliations"] == 1


def test_reconcile_skips_non_quiescent_replicas():
    spec, state = _small_net()
    r = BCPNNRouter.local(2, online_learning=True, feedback_batch=64,
                          feedback_eager=False)
    r.add_model("m", state, spec, replicas=2, online=True)
    r.start()
    xs, ys = _stream(spec, 3, seed=5)
    try:
        for x, y in zip(xs, ys):
            r.feedback(x, int(y), model="m")  # buffers, never folds (64)
        rep = r.reconcile()["m"]
        assert "skipped" in rep and "quiescent" in rep["skipped"]
    finally:
        r.stop()


def test_engine_loss_recovery_fails_inflight_typed_and_replaces():
    """Kill a hosting engine mid-flight: every in-flight request on it
    resolves WorkerDied exactly once, the model re-places onto a
    survivor, and serving resumes."""
    spec, state = _small_net()
    r = BCPNNRouter.local(3, max_batch=4)
    r.add_model("m", state, spec, replicas=2)
    r.start()
    xs, _ = _stream(spec, 40, seed=6)
    try:
        ids = [r.submit(x) for x in xs]
        victim = r.placement("m")["replicas"][0]
        r._engines[victim].kill("chaos")
        outcomes: Dict[int, Any] = {}
        for rid in ids:
            try:
                outcomes[rid] = r.result(rid, timeout=30)
            except ServeError as e:
                outcomes[rid] = e
        assert len(outcomes) == len(ids) == len(set(ids))
        died = [v for v in outcomes.values() if isinstance(v, WorkerDied)]
        ok = [v for v in outcomes.values() if not isinstance(v, Exception)]
        assert len(died) + len(ok) == len(ids)
        with pytest.raises(KeyError):
            r.result(ids[0], timeout=1)
        _wait(lambda: (r.check_engines(),
                       victim not in r.snapshot()["live_engines"])[1],
              "the loss")
        place = r.placement("m")
        assert victim not in place["replicas"]
        assert len(place["replicas"]) == 2  # back at desired fan-out
        res = r.classify(xs[0], timeout=30)  # serving resumed
        assert res.pred >= 0
    finally:
        r.stop()
    snap = r.metrics.snapshot()
    assert snap["engine_losses"] == 1 and snap["replacements"] >= 1
    assert snap["submitted"] == snap["completed"] + snap["failed"]


def test_engine_loss_recovers_online_model_from_peer_folds():
    """Recovery prefers a live peer's fold-boundary state over the
    registration checkpoint: the re-placed replica carries every fold,
    bit-for-bit, in tensors of its own."""
    spec, state = _small_net()
    r = BCPNNRouter.local(3, max_batch=4, online_learning=True,
                          feedback_batch=4, feedback_eager=False)
    r.add_model("m", state, spec, replicas=2, online=True)
    r.start()
    xs, ys = _stream(spec, 8, seed=7)
    try:
        for x, y in zip(xs, ys):
            r.feedback(x, int(y), model="m")
        _quiescent(r)
        survivor = r.placement("m")["replicas"][1]
        want = r._engines[survivor].model_state_sync("m")
        victim = r.placement("m")["replicas"][0]
        r._engines[victim].kill("chaos")
        _wait(lambda: bool(r.check_engines()), "the loss")
        place = r.placement("m")
        newcomer = [e for e in place["replicas"] if e != survivor][0]
        got = r._engines[newcomer].model_state_sync("m")
        assert states_bitwise_equal(got, want)  # folds carried over
        assert _owns(got, want)
        assert not states_bitwise_equal(got, state)  # not the checkpoint
    finally:
        r.stop()


def test_quarantine_drain_and_heal_repairs_from_peer():
    """An injected NaN fold quarantines ONE replica; its share drains to
    the healthy peer, heal() revalidates + repairs it from the peer, and
    it rejoins the rotation with a bit-identical state of its own."""
    spec, state = _small_net()
    inj = FaultInjector(seed=0, schedule={"nan-state": {0}})
    r = BCPNNRouter.local(2, max_batch=4, online_learning=True,
                          feedback_batch=4, feedback_eager=False,
                          fault_injectors=[inj, None])
    r.add_model("m", state, spec, replicas=2, online=True)
    r.start()
    xs, ys = _stream(spec, 8, seed=8)
    sick, healthy = r.placement("m")["replicas"]
    assert sick == "engine0"
    try:
        for x, y in zip(xs, ys):
            r.feedback(x, int(y), model="m")
        _wait(lambda: r._engines[sick].quarantined("m"), "quarantine")
        r.feedback(xs[0], int(ys[0]), model="m")
        assert sick in r.placement("m")["draining"]
        for x in xs:
            r.classify(x, timeout=30)
        assert r._engines[sick].snapshot(model="m")["completed"] == 0.0
        healed = r.heal()
        assert healed == {"m": [sick]}
        assert r.placement("m")["draining"] == ()
        assert not r._engines[sick].quarantined("m")
        a = r._engines[sick].model_state_sync("m")
        b = r._engines[healthy].model_state_sync("m")
        assert states_bitwise_equal(a, b) and _owns(a, b)
        assert not states_bitwise_equal(a, state)
    finally:
        r.stop()
    assert r.metrics.snapshot()["quarantine_drains"] == 1


def test_weighted_fairness_vft_schedule():
    """White-box scheduler fairness: with weights 3:1 and equal costs,
    the weight-3 model is served ~3 samples per 1 of the other."""
    spec, state = _small_net()
    svc = BCPNNService(max_batch=4, max_wait_ms=0.0, poll_ms=1.0)
    svc.add_model("heavy", state, spec, weight=3.0)
    svc.add_model("light", state, spec, weight=1.0)
    x = np.zeros((spec.input_geom.N,), np.float32)
    for i in range(24):
        svc._slots["heavy"].batcher.put(
            Request(id=i, x=x, enqueue_t=0.0, model="heavy"))
    for i in range(24):
        svc._slots["light"].batcher.put(
            Request(id=100 + i, x=x, enqueue_t=0.0, model="light"))
    order = []
    while True:
        group, slot = svc._next_work()
        if not group:
            break
        order.append((slot.name, len(group)))
    served = {"heavy": 0, "light": 0}
    prefix = []
    for name, n in order:
        served[name] += n
        prefix.append(dict(served))
    assert served == {"heavy": 24, "light": 24}
    mid = prefix[7]
    assert mid["heavy"] == 24 and mid["light"] == 8


class _KillAt:
    """A serving front over a router that kills ``victim`` when the
    ``at``-th request is admitted: an engine loss at a request index, not
    on a timer."""

    def __init__(self, router, victim, at):
        self.router, self.victim, self.at = router, victim, at
        self.admitted = 0

    def submit(self, x, model=None, deadline_s=None):
        rid = self.router.submit(x, model=model, deadline_s=deadline_s)
        self.admitted += 1
        if self.admitted == self.at:
            self.router._engines[self.victim].kill("soak")
        return rid

    def result(self, request_id, timeout=None):
        return self.router.result(request_id, timeout=timeout)

    def feedback(self, x, label, model=None):
        self.router.feedback(x, label, model=model)


def _typed(e) -> bool:
    """A typed resolution: the serving ladder's errors, or an injected
    fault that a group of one cannot bisect away."""
    return isinstance(e, (ServeError, FaultInjected))


def test_router_mini_engine_loss_soak_accounting_closes():
    """Fast chaos mini-soak: open-loop Poisson into 3 engines with one
    engine killed at a seeded admitted-request index.  Every submitted id
    completes, sheds, or fails TYPED — zero lost, zero hung."""
    spec, state = _small_net()
    r = BCPNNRouter.local(3, max_batch=8, max_queue=64)
    r.add_model("m", state, spec, replicas=2)
    r.start()
    xs, ys = _stream(spec, 32, seed=9)
    victim = r.placement("m")["replicas"][0]
    front = _KillAt(r, victim, int(np.random.default_rng(9).integers(40, 110)))
    try:
        rep = run_open_loop(front, xs, ys, n_requests=150, rate_hz=400.0,
                            seed=10, timeout_s=60.0, deadline_s=5.0,
                            model="m")
        r.check_engines()  # a loss no request happened to observe
    finally:
        r.stop()
    assert len(rep.results) + len(rep.errors) + rep.n_rejected == 150
    for e in rep.errors:
        assert isinstance(e, ServeError), repr(e)
    snap = r.metrics.snapshot()
    assert snap["submitted"] == snap["completed"] + snap["failed"]
    assert snap["engine_losses"] == 1
    assert len(rep.results) > 0  # the tier kept serving through the kill


def _soak_injectors(rng, n_engines):
    """Per engine, faults at seeded invocation indices of each point; the
    nan-state fault on one engine only (a quarantined replica drains until
    heal(), and with every replica draining the router admits nothing)."""
    sick = int(rng.integers(n_engines))
    out = []
    for i in range(n_engines):
        sched = {"infer-raise": rng.choice(60, 2, replace=False),
                 "fold-raise": rng.choice(8, 1),
                 "slow-batch": rng.choice(60, 2, replace=False)}
        if i == sick:
            sched["nan-state"] = rng.choice(8, 1)
        out.append(FaultInjector(seed=int(rng.integers(1 << 30)),
                                 schedule={k: {int(j) for j in v}
                                           for k, v in sched.items()}))
    return out


def test_router_engine_loss_chaos_soak():
    """The chaos soak, seeded: one hosting replica killed at a seeded
    admitted-request index and the engine fault points fired at seeded
    invocation indices, under Poisson load across a replicated online
    router.  Accounting closes at the router; after heal, stop and
    reconcile the replica states are finite and bit-identical."""
    spec, state = _small_net(side=8)
    rng = np.random.default_rng(123)
    injectors = _soak_injectors(rng, 4)
    r = BCPNNRouter.local(4, max_batch=8, max_queue=32,
                          online_learning=True, feedback_batch=8,
                          feedback_eager=False, fault_injectors=injectors)
    r.add_model("m", state, spec, replicas=3, online=True)
    r.start()
    xs, ys = _stream(spec, 64, seed=11)
    victim = r.placement("m")["replicas"][int(rng.integers(0, 3))]
    front = _KillAt(r, victim, int(rng.integers(100, 300)))
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the threads far more finely
    try:
        rep = run_open_loop(front, xs, ys, n_requests=600, rate_hz=500.0,
                            seed=12, timeout_s=120.0, deadline_s=2.0,
                            feedback_frac=0.2, model="m")
    finally:
        sys.setswitchinterval(switch)
        r.check_engines()
        r.heal()
        # stop drains: every engine flushes its buffered feedback tail,
        # so the post-stop reconcile compares fully-folded settled states
        r.stop()
        rec = r.reconcile()["m"]
    assert len(rep.results) + len(rep.errors) + rep.n_rejected == 600
    for e in rep.errors:
        assert _typed(e), repr(e)
    snap = r.metrics.snapshot()
    assert snap["submitted"] == snap["completed"] + snap["failed"]
    assert snap["engine_losses"] == 1
    assert len(rep.results) > 0
    assert "skipped" not in rec, rec
    place = r.placement("m")
    assert victim not in place["replicas"] and len(place["replicas"]) == 3
    states = [r._engines[e].model_state_sync("m") for e in place["replicas"]]
    for s in states:
        assert state_finite(s)
    for s in states[1:]:
        assert states_bitwise_equal(states[0], s) and _owns(states[0], s)


# ------------------------------------------------ the port's own rules --

def test_failed_live_placement_raises_and_publishes_nothing():
    """A live placement whose warm-up (on the card: its captures) fails
    raises to the caller; the engine serves on without the slot — no
    eager fallback is published."""
    spec, state = _small_net()
    svc = BCPNNService(state, spec, max_batch=4).start()
    x = _stream(spec, 1)[0][0]

    def broken(slot):
        raise RuntimeError("capture failed")

    svc._warm_slot = broken
    try:
        with pytest.raises(RuntimeError, match="capture failed"):
            svc.add_model("late", copy_state(state), spec, live=True)
        assert svc.models() == ("default",)
        with pytest.raises(KeyError, match="unknown model"):
            svc.submit(x, model="late")
        assert svc.classify(x, timeout=30).pred >= 0
    finally:
        svc.stop()


def test_routed_rows_match_the_jax_router():
    """The same numpy state behind a JAX and a port router (2 engines,
    replicas=2): equal predictions, probabilities within 1e-5."""
    jspec = j_deep_synth_spec(backend="jnp", **_kw())
    jst = jn.init_deep(jspec, jax.random.PRNGKey(3))
    tspec, _ = _small_net()

    def proj(p):
        return {"traces": {k: np.asarray(getattr(p.traces, k))
                           for k in ("pi", "pj", "pij", "t")},
                "w": np.asarray(p.w), "b": np.asarray(p.b),
                "mask": np.asarray(p.mask), "table": None}

    tst = convert.state_from_numpy(
        {"projs": [proj(p) for p in jst.projs], "readout": proj(jst.readout),
         "step": int(jst.step)}, tspec, "cpu")
    xs, _ = _stream(tspec, 12, seed=13)
    got = {}
    for name, router, st, spec in (("jax", JRouter, jst, jspec),
                                   ("port", BCPNNRouter, tst, tspec)):
        r = router.local(2, max_batch=4)
        r.add_model("m", st, spec, replicas=2)
        r.start()
        try:
            got[name] = [r.classify(x, timeout=120) for x in xs]
        finally:
            r.stop()
    assert [g.pred for g in got["port"]] == [g.pred for g in got["jax"]]
    np.testing.assert_allclose(np.stack([g.probs for g in got["port"]]),
                               np.stack([np.asarray(g.probs)
                                         for g in got["jax"]]),
                               atol=FWD_TOL)


def test_repaired_replica_does_not_change_when_its_peer_folds():
    """The aliasing rule: a replica repaired from a peer holds tensors and
    a generator of its own, so the peer's later folds — and writes into
    the peer's tensors in place, as a donated step makes — leave it
    unchanged."""
    spec, state = _small_net()
    r = BCPNNRouter.local(2, max_batch=4, online_learning=True,
                          feedback_batch=4, feedback_eager=False)
    r.add_model("m", state, spec, replicas=2, online=True)
    r.start()
    xs, ys = _stream(spec, 12, seed=14)
    try:
        for x, y in zip(xs[:8], ys[:8]):
            r.feedback(x, int(y), model="m")
        _quiescent(r)
        lagger = r.placement("m")["replicas"][1]
        r._engines[lagger].set_model_state("m", copy_state(state))
        rep = r.reconcile()["m"]
        assert rep["repaired"] == [lagger]
        peer = r._engines[rep["authoritative"]]
        src = peer.model_state_sync("m")
        got = r._engines[lagger].model_state_sync("m")
        assert states_bitwise_equal(got, src) and _owns(got, src)
        before = [t.clone() for t in state_tensors(got)]
        gen_before = got.generator.get_state()
        folds = peer.snapshot(model="m")["learn_steps"]
        for x, y in zip(xs[8:], ys[8:]):  # the peer alone folds again
            peer.feedback(x, int(y), "m")
        _wait(lambda: peer.snapshot(model="m")["learn_steps"] == folds + 1,
              "the peer's fold")
        for t in state_tensors(src):  # and its old tensors are written
            t.add_(1)
        torch.rand(3, generator=src.generator)
        after = r._engines[lagger].model_state_sync("m")
    finally:
        r.stop()
    assert after is got
    for t, u in zip(state_tensors(after), before):
        assert torch.equal(t, u)
    assert torch.equal(after.generator.get_state(), gen_before)


def test_recovery_from_the_checkpoint_comes_back_on_the_placement_device():
    """With no live peer, a lost model is re-placed from the router's host
    checkpoint onto the device its placement serves on, in tensors of its
    own (on the card: ``tests/test_torch_cuda.py``)."""
    spec, state = _small_net()
    r = BCPNNRouter.local(2, max_batch=4)
    assert r.add_model("m", state, spec) == ("engine0",)
    ckpt, _ = r._checkpoints["m"]
    assert ckpt.device.type == "cpu" and _owns(ckpt, state)
    assert states_bitwise_equal(ckpt, state)
    r.start()
    xs, _ = _stream(spec, 4, seed=15)
    try:
        r._engines["engine0"].kill("test")
        _wait(lambda: bool(r.check_engines()), "the loss")
        assert r.placement("m")["replicas"] == ("engine1",)
        got = r._engines["engine1"].model_state_sync("m")
        served = [r.classify(x, timeout=30) for x in xs]
    finally:
        r.stop()
    assert got.device == r._placements["m"].device == state.device
    assert states_bitwise_equal(got, ckpt) and _owns(got, ckpt)
    _, pred = infer(state, spec, torch.from_numpy(xs))
    assert [s.pred for s in served] == pred.tolist()
    assert r.metrics.snapshot()["replacements"] == 1
