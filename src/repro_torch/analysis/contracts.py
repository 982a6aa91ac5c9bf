"""Runtime contract checks of the port (mirrors the runtime half of
``repro/analysis/contracts.py``).

Where the AST rules (``rules.py``) read the source, these run small real
programs on the port's serving engine and router, on the CPU
(``device="cpu"``: the wrappers take their plain versions), and inspect
what they did:

* ``quarantine-rollback``: a fold whose output fails the non-finite
  sentinel leaves the slot's state bit-identical to the last-good state,
  flips the slot to inference-only (``Quarantined`` on feedback, surfaced
  in ``snapshot()``), and re-arms through ``revalidate()``.
* ``router-exactly-once``: an engine killed under a live ``BCPNNRouter``;
  every router-issued id resolves exactly once (a result or one typed
  error), the accounting closes, and a tier with no healthy replica
  rejects within the reroute budget.
* ``replica-merge``: the disjoint-support merge of agreeing replicas of a
  real folded state is bit-identical to each, and a diverged set cannot
  merge clean (``serve/reconcile.py``).
* ``cuda-plans``: the CUDA kernel audit (``plans.py``).

The JAX checks ``donation-guard``, ``recompile-sentinel``, ``dp-seams``
and ``masked-seams`` inspect jaxprs, jit caches and donated XLA buffers,
none of which the port has; they have no counterpart here.

Every check returns a list of problem strings; empty means the contract
holds.  ``run_contracts`` drives any subset by name.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

from .plans import check_cuda_plans


def _small_net(seed: int = 0):
    """A 2x2-input, one 1x4 hidden layer, 2-class network on the CPU."""
    from ..core.network import init_network, make_network_spec
    spec = make_network_spec((2, 2), [(1, 4)], 2)
    return spec, init_network(spec, seed, "cpu")


def _wait(cond, deadline: float) -> bool:
    while not cond():
        if time.perf_counter() > deadline:
            return False
        time.sleep(0.002)
    return True


# --------------------------------------------- quarantine rollback ----

def check_quarantine_rollback() -> List[str]:
    """The serving quarantine contract (DESIGN.md §10): a fold whose
    output fails the non-finite sentinel must (a) leave the slot's state
    bit-identical to the last-good pre-fold state, (b) flip the slot to
    inference-only (``Quarantined`` on feedback, surfaced in
    ``snapshot()``), and (c) re-arm through ``revalidate()``."""
    import numpy as np
    import torch
    from ..core.graphs import state_tensors
    from ..serve.engine import BCPNNService
    from ..serve.errors import Quarantined
    from ..serve.faultinject import FaultInjector

    spec, state = _small_net()
    # fold invocation 0 stays clean (a non-trivial last-good snapshot),
    # invocation 1 is corrupted; feedback_eager=False folds only full
    # feedback batches, so invocations map to batches deterministically
    inj = FaultInjector(seed=0, schedule={"nan-state": {1}})
    svc = BCPNNService(state, spec, buckets=(1, 2), max_wait_ms=0.5,
                       online_learning=True, feedback_batch=2,
                       feedback_eager=False, fault_injector=inj)
    problems: List[str] = []
    svc.start(warmup=True)
    try:
        rng = np.random.default_rng(0)
        ni = spec.input_geom.N
        deadline = time.perf_counter() + 30.0
        for i in range(2):
            svc.feedback(rng.random(ni).astype(np.float32), i % 2)
        if not _wait(lambda: svc.snapshot()["learn_steps"] >= 1, deadline):
            return ["clean fold never landed"]
        good = [t.clone() for t in state_tensors(svc.model_state())]
        for i in range(2):
            svc.feedback(rng.random(ni).astype(np.float32), i % 2)
        if not _wait(lambda: svc._slot(None).quarantined, deadline):
            return ["nan-injected fold never quarantined"]
        after = state_tensors(svc.model_state())
        if len(after) != len(good) or not all(
                g.dtype == a.dtype and torch.equal(g, a)
                for g, a in zip(good, after)):
            problems.append("quarantine rollback is not bit-identical to "
                            "the last-good state — a corrupted fold leaked "
                            "into the served state")
        if svc.snapshot().get("quarantined") != 1.0:
            problems.append("quarantine not surfaced in snapshot()")
        try:
            svc.feedback(rng.random(ni).astype(np.float32), 0)
            problems.append("quarantined slot accepted feedback "
                            "(expected Quarantined)")
        except Quarantined:
            pass
        svc.revalidate()
        if svc._slot(None).quarantined:
            problems.append("revalidate() failed to re-arm a finite "
                            "rolled-back slot")
    finally:
        svc.stop()
    return problems


# ------------------------------------------- router exactly-once ----

def check_router_exactly_once() -> List[str]:
    """The router failure ladder (DESIGN.md §11): with an engine killed
    under load, every router-issued id resolves exactly once — a result or
    one typed error, never a hang, never a second resolution — router
    accounting closes, and a submit against a tier with no healthy
    replica rejects within the reroute budget."""
    import numpy as np
    from ..serve import BCPNNRouter, NoHealthyReplica, ServeError

    spec, state = _small_net()
    rng = np.random.default_rng(0)
    ni = spec.input_geom.N
    problems: List[str] = []

    r = BCPNNRouter.local(2, max_batch=4, max_queue=256)
    r.add_model("m", state, spec, replicas=2)
    r.start()
    try:
        ids = [r.submit(rng.random(ni).astype(np.float32), model="m")
               for _ in range(16)]
        victim = r.placement("m")["replicas"][0]
        r._engines[victim].kill("contract-probe")
        resolved = 0
        for rid in ids:
            try:
                r.result(rid, timeout=30.0)
                resolved += 1
            except ServeError:
                resolved += 1  # a typed failure is a resolution
            except TimeoutError:
                problems.append(f"router id {rid} hung past its engine's "
                                f"death — an in-flight future was lost")
        if resolved != len(ids) and not problems:
            problems.append(f"{len(ids) - resolved} of {len(ids)} router "
                            f"ids vanished without a typed resolution")
        try:
            r.result(ids[0], timeout=1.0)
            problems.append("an already-resolved router id resolved a "
                            "SECOND time — exactly-once is broken")
        except KeyError:
            pass
        snap = r.metrics.snapshot()
        if snap["submitted"] != snap["completed"] + snap["failed"]:
            problems.append(
                f"router accounting does not close: submitted="
                f"{snap['submitted']} != completed={snap['completed']} "
                f"+ failed={snap['failed']}")
    finally:
        r.stop()

    # the reroute budget: a tier with no healthy replica rejects typed,
    # within 1 + max_reroutes admission attempts
    r2 = BCPNNRouter.local(1, max_reroutes=2)
    r2.add_model("m", state, spec)
    r2.start()
    try:
        r2._engines["engine0"].kill("contract-probe")
        if not _wait(lambda: not r2._engines["engine0"].alive(),
                     time.perf_counter() + 30.0):
            return problems + ["killed engine never died"]
        try:
            r2.submit(rng.random(ni).astype(np.float32), model="m")
            problems.append("submit admitted a request on a tier with no "
                            "healthy replica")
        except NoHealthyReplica as e:
            if e.attempts > 1 + r2.max_reroutes:
                problems.append(f"reroute budget exceeded: {e.attempts} "
                                f"attempts > 1 + {r2.max_reroutes}")
        if r2.metrics.snapshot()["rejected"] != 1.0:
            problems.append("NoHealthyReplica rejection not counted")
    finally:
        r2.stop()
    return problems


# ------------------------------------------------- replica merge ----

def check_replica_merge() -> List[str]:
    """The reconciliation merge's bitwise contract on a real folded state:
    merging K agreeing replicas is bit-identical to each replica (the
    disjoint-support reassembly is lossless for every leaf), and a
    diverged replica set cannot merge clean."""
    import numpy as np
    import torch
    from ..core.network import supervised_readout_step
    from ..serve.reconcile import (copy_state, merge_replica_states,
                                   state_divergence, states_bitwise_equal)

    spec, state0 = _small_net(seed=1)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.random((4, spec.input_geom.N))
                         .astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 2, size=4).astype(np.int64))
    folded = supervised_readout_step(copy_state(state0), spec, x, y)

    problems: List[str] = []
    for k in (1, 2, 3):
        merged = merge_replica_states([folded] * k)
        if not states_bitwise_equal(merged, folded):
            div = "; ".join(state_divergence(merged, folded)[:3])
            problems.append(f"merge of {k} agreeing replicas is not "
                            f"bit-identical: {div}")
    mixed = merge_replica_states([folded, state0])
    if states_bitwise_equal(mixed, folded) and \
            states_bitwise_equal(mixed, state0):
        problems.append("merge failed to expose a diverged replica set — "
                        "reconcile() could report drifted replicas as "
                        "consistent")
    return problems


# -------------------------------------------------------------- driver ----

CONTRACTS: Dict[str, Callable[[], List[str]]] = {
    "cuda-plans": check_cuda_plans,
    "quarantine-rollback": check_quarantine_rollback,
    "router-exactly-once": check_router_exactly_once,
    "replica-merge": check_replica_merge,
}


def run_contracts(names: Optional[Sequence[str]] = None
                  ) -> Dict[str, List[str]]:
    """Run the named contract checks (all by default) -> {name: problems}."""
    picked = list(names) if names else sorted(CONTRACTS)
    unknown = [n for n in picked if n not in CONTRACTS]
    if unknown:
        raise ValueError(f"unknown contract checks {unknown}; known: "
                         f"{sorted(CONTRACTS)}")
    return {name: CONTRACTS[name]() for name in picked}
