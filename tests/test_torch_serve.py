"""The port's serving engine (``repro_torch.serve``) and its launcher, on
the CPU at small sizes: the counterparts of ``tests/test_serve.py``,
``test_serve_faults.py`` and ``test_serve_metrics.py`` by behaviour, with
one comparison against the JAX engine where it runs here.

On the CPU a served batch runs ``infer_packed`` eagerly over the pack of
the last fold (on the card each bucket replays its CUDA graph:
``tests/test_torch_cuda.py``).  Tolerances (DESIGN.md §3): served rows
against the JAX service within 1e-5 with equal predictions; online folds
against the JAX folds of the same feedback within 1e-4 (weights; traces
1e-5); the port's own replays bitwise.
"""
import dataclasses
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs.bcpnn_models import deep_synth_spec as j_deep_synth_spec
from repro.core import network as jn
from repro.serve import BCPNNService as JService
from repro_torch import convert
from repro_torch.checkpoint import load_models
from repro_torch.configs.bcpnn_models import deep_synth_spec
from repro_torch.core import (Trainer, infer, init_deep, init_projection,
                              online_learn_step, supervised_readout_step)
from repro_torch.core.graphs import state_tensors
from repro_torch.core.network import infer_packed, pack_state
from repro_torch.device import make_generator
from repro_torch.launch import serve_bcpnn
from repro_torch.serve import (
    BCPNNService, DeadlineExceeded, Fault, FaultInjected, FaultInjector,
    Overloaded, Quarantined, Request, ServeMetrics, StreamSpec, WorkerDied,
    cycle_batch, default_buckets, pad_group, pick_bucket,
    run_multi_open_loop, run_open_loop)
from repro_torch.serve.engine import _state_finite

FWD_TOL = 1e-5
TRACE_TOL = 1e-5
W_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(**over):
    kw = dict(side=6, depth=1, n_classes=3, hidden_hc=4, hidden_mc=8)
    kw.update(over)
    return kw


def _small_net(seed=0, backend="cuda", **over):
    spec = deep_synth_spec(backend=backend, **_kw(**over))
    return spec, init_deep(spec, seed, "cpu")


def _x(spec, seed=0, n=1):
    x = np.random.default_rng(seed).random(
        (n, spec.input_geom.N)).astype(np.float32)
    return x[0] if n == 1 else x


def _wait(cond, timeout_s: float = 30.0) -> None:
    deadline = time.perf_counter() + timeout_s
    while not cond():
        assert time.perf_counter() < deadline, "condition never held"
        time.sleep(0.002)


def _jax_pair(seed=0, **over):
    """A JAX state and the port state of the same arrays."""
    jspec = j_deep_synth_spec(backend="jnp", **_kw(**over))
    tspec = deep_synth_spec(backend="cuda", **_kw(**over))
    jst = jn.init_deep(jspec, jax.random.PRNGKey(seed))

    def proj(p):
        return {"traces": {k: np.asarray(getattr(p.traces, k))
                           for k in ("pi", "pj", "pij", "t")},
                "w": np.asarray(p.w), "b": np.asarray(p.b),
                "mask": np.asarray(p.mask),
                "table": None if p.table is None else np.asarray(p.table)}

    tree = {"projs": [proj(p) for p in jst.projs],
            "readout": proj(jst.readout), "step": int(jst.step)}
    return jspec, jst, tspec, convert.state_from_numpy(tree, tspec, "cpu")


def _assert_states_bitwise(a, b):
    for i, (u, v) in enumerate(zip(state_tensors(a), state_tensors(b))):
        assert torch.equal(u, v), f"tensor {i} diverged"


class _Blocker(FaultInjector):
    """The worker blocks at the slow-batch point until released, so a
    test can build a backlog behind an in-flight microbatch."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.entered = threading.Event()
        self.release = threading.Event()

    def maybe(self, point):
        if point == "slow-batch":
            self.entered.set()
            assert self.release.wait(30.0), "blocker never released"
        return super().maybe(point)


# ------------------------------------------------------------- batching --

def test_default_buckets_pick_and_pad():
    assert default_buckets(16) == (1, 2, 4, 8, 16)
    assert default_buckets(12) == (1, 2, 4, 8, 12)
    assert default_buckets(64) == (1, 2, 4, 8, 16, 32, 64)
    assert pick_bucket(3, (1, 2, 4, 8)) == 4
    with pytest.raises(ValueError):
        pick_bucket(9, (1, 2, 4, 8))
    x, valid = pad_group([np.full((5,), i, np.float32) for i in range(3)], 8)
    assert x.shape == (8, 5)
    np.testing.assert_array_equal(valid, [1, 1, 1, 0, 0, 0, 0, 0])
    np.testing.assert_array_equal(x[3:], 0.0)


def test_cycle_batch_composition():
    items = [(np.full((2,), i, np.float32), i) for i in range(3)]
    x, y = cycle_batch(items, 8)
    np.testing.assert_array_equal(y, [0, 1, 2, 0, 1, 2, 0, 1])
    np.testing.assert_array_equal(x[:, 0], y.astype(np.float32))


# ------------------------------------------------------------- serving ----

def test_served_results_match_the_jax_service():
    """The same state behind the JAX service and the port's: every served
    row within 1e-5, predictions equal, singles and a padded burst."""
    jspec, jst, tspec, tst = _jax_pair(seed=1, depth=2)
    xs = _x(tspec, seed=2, n=5)
    out = {}
    for name, svc in (("jax", JService(jst, jspec, max_batch=8)),
                      ("port", BCPNNService(tst, tspec, max_batch=8))):
        svc.start()
        try:
            got = [svc.classify(x, timeout=30) for x in xs]
            ids = [svc.submit(x) for x in xs]
            got += [svc.result(i, timeout=30) for i in ids]
        finally:
            svc.stop()
        out[name] = got
    for a, b in zip(out["jax"], out["port"]):
        assert a.pred == b.pred
        np.testing.assert_allclose(b.probs, a.probs, atol=FWD_TOL)
    probs, pred = infer(tst, tspec, torch.from_numpy(xs))
    for k, r in enumerate(out["port"]):
        assert r.pred == int(pred[k % 5]) and r.latency_ms >= 0.0
        np.testing.assert_array_equal(r.probs, probs[k % 5].numpy())


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_low_precision_service_serves_its_pack(dtype):
    """An engine-wide ``infer_dtype`` serves the packed weights: every row
    equals ``infer_packed`` on the same padded bucket, bit for bit."""
    spec, state = _small_net(seed=3, nact=[20], patchy_traces=True,
                             compact=True)
    xs = _x(spec, seed=4, n=3)
    svc = BCPNNService(state, spec, max_batch=4, infer_dtype=dtype,
                       adaptive_buckets=False, max_wait_ms=50.0).start()
    try:
        ids = [svc.submit(x) for x in xs]
        got = [svc.result(i, timeout=30) for i in ids]
    finally:
        svc.stop()
    sp = spec.with_infer_dtype(dtype)
    x, valid = pad_group(list(xs), 4)
    probs, pred = infer_packed(pack_state(state, sp), sp,
                               torch.from_numpy(x), torch.from_numpy(valid))
    for i, r in enumerate(got):
        assert r.pred == int(pred[i])
        np.testing.assert_array_equal(r.probs, probs[i].numpy())


def test_async_submit_from_many_threads_all_complete():
    spec, state = _small_net()
    svc = BCPNNService(state, spec, max_batch=8).start()
    ids, lock = [], threading.Lock()
    x = np.ones((spec.input_geom.N,), np.float32)

    def client(n):
        for _ in range(n):
            rid = svc.submit(x)
            with lock:
                ids.append(rid)

    threads = [threading.Thread(target=client, args=(10,)) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    results = [svc.result(rid, timeout=30) for rid in ids]
    svc.stop()
    assert len({r.request_id for r in results}) == 40
    snap = svc.snapshot()
    assert snap["completed"] == snap["submitted"] == 40
    assert snap["queue_depth"] == 0
    assert 0 < snap["p50_ms"] <= snap["p99_ms"]


def test_feedback_requires_online_mode_and_a_running_service():
    spec, state = _small_net()
    svc = BCPNNService(state, spec, max_batch=4)
    with pytest.raises(RuntimeError, match="online_learning"):
        svc.feedback(np.zeros((spec.input_geom.N,), np.float32), 0)
    with pytest.raises(RuntimeError, match="not running"):
        svc.submit(np.zeros((spec.input_geom.N,), np.float32))


def test_stop_drains_feedback_and_racing_submits():
    spec, state = _small_net()
    svc = BCPNNService(state, spec, max_batch=4, max_wait_ms=0.5,
                       online_learning=True, feedback_batch=16,
                       result_retention=1_000_000).start()
    x = np.ones((spec.input_geom.N,), np.float32)
    for i in range(100):
        svc.feedback(x, i % 3)
    ids, done = [], threading.Event()

    def client():
        while not done.is_set():
            try:
                ids.append(svc.submit(x))
            except RuntimeError:
                return

    threads = [threading.Thread(target=client) for _ in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.02)
    svc.stop()
    done.set()
    for t in threads:
        t.join()
    for rid in ids:
        assert svc.result(rid, timeout=10).pred >= 0
    snap = svc.snapshot()
    assert snap["learn_samples"] == 100 and snap["learn_steps"] >= 6
    assert len(svc._feedback) == 0 and len(svc._requests) == 0
    with pytest.raises(RuntimeError, match="not running"):
        svc.feedback(x, 0)


def test_result_retention_evicts_oldest_uncollected():
    spec, state = _small_net()
    svc = BCPNNService(state, spec, max_batch=4, result_retention=8).start()
    x = np.ones((spec.input_geom.N,), np.float32)
    ids = [svc.submit(x) for _ in range(30)]
    svc.stop()
    assert len(svc._requests) <= 8
    for rid in ids[-4:]:
        assert svc.result(rid, timeout=5).pred >= 0
    with pytest.raises(KeyError):
        svc.result(ids[0], timeout=5)


# -------------------------------------------------------- multi-model ----

def test_multi_model_routing_names_and_registration():
    spec_a, state_a = _small_net(seed=0)
    spec_b, state_b = _small_net(seed=1, depth=2, side=5, n_classes=4)
    xa, xb = _x(spec_a, 2, n=4), _x(spec_b, 3, n=4)
    svc = BCPNNService.multi({"a": (state_a, spec_a),
                              "b": (state_b, spec_b)}, max_batch=4,
                             online_learning=True)
    with pytest.raises(ValueError, match="pass model="):
        svc.state
    with pytest.raises(ValueError, match="already registered"):
        svc.add_model("a", state_a, spec_a)
    svc.start()
    try:
        with pytest.raises(ValueError, match="pass model="):
            svc.submit(xa[0])
        with pytest.raises(KeyError, match="unknown model"):
            svc.feedback(xa[0], 0, model="nope")
        with pytest.raises(RuntimeError, match="live=True"):
            svc.add_model("late", state_a, spec_a)
        ids_a = [svc.submit(x, model="a") for x in xa]
        svc.add_model("c", state_b, spec_b, live=True)  # while serving
        ids_b = [svc.submit(x, model="b") for x in xb]
        ids_c = [svc.submit(x, model="c") for x in xb]
        got_a = [svc.result(i, timeout=30) for i in ids_a]
        got_b = [svc.result(i, timeout=30) for i in ids_b]
        got_c = [svc.result(i, timeout=30) for i in ids_c]
    finally:
        svc.stop()
    assert svc.models() == ("a", "b", "c")
    _, ra = infer(state_a, spec_a, torch.from_numpy(xa))
    _, rb = infer(state_b, spec_b, torch.from_numpy(xb))
    assert [r.model for r in got_a] == ["a"] * 4
    assert [r.pred for r in got_a] == ra.tolist()
    assert [r.pred for r in got_b] == rb.tolist()
    assert [r.model for r in got_c] == ["c"] * 4
    assert [r.pred for r in got_c] == rb.tolist()
    snap = svc.snapshot()
    assert snap["per_model"]["a"]["completed"] == 4
    assert svc.snapshot(model="b")["submitted"] == 4
    with pytest.raises(ValueError, match="at least one"):
        BCPNNService.multi({})


def test_scheduler_never_starves_the_minority():
    spec, state = _small_net()
    svc = BCPNNService.multi({"a": (state, spec), "b": (state, spec)},
                             max_batch=4, max_wait_ms=0.0, poll_ms=1.0)
    x = np.zeros((spec.input_geom.N,), np.float32)
    for i in range(12):
        svc._slots["a"].batcher.put(Request(id=i, x=x, enqueue_t=0.0,
                                            model="a"))
    for i in range(2):
        svc._slots["b"].batcher.put(Request(id=100 + i, x=x, enqueue_t=0.0,
                                            model="b"))
    order = []
    while True:
        group, slot = svc._next_work()
        if not group:
            break
        order.append((slot.name, len(group)))
    names = [n for n, _ in order]
    assert names.index("b") <= 1, names
    assert sum(k for n, k in order if n == "a") == 12


def test_fairness_under_skewed_open_loop_load():
    spec_a, state_a = _small_net(seed=0)
    spec_b, state_b = _small_net(seed=1)
    xe = _x(spec_a, 5, n=32)
    ye = np.zeros((32,), np.int64)
    svc = BCPNNService.multi({"major": (state_a, spec_a),
                              "minor": (state_b, spec_b)},
                             max_batch=8, max_wait_ms=2.0).start()
    try:
        reports = run_multi_open_loop(
            svc, {"major": StreamSpec(xe, ye, rate_hz=400.0),
                  "minor": StreamSpec(xe, ye, rate_hz=40.0)},
            n_requests=120, seed=0)
    finally:
        svc.stop()
    snap = svc.snapshot()
    assert snap["completed"] == snap["submitted"] == 120
    assert len(reports["minor"].results) > 0
    assert reports["minor"].max_latency_ms < 5000.0
    with pytest.raises(ValueError, match="rate_hz > 0"):
        run_multi_open_loop(svc, {"a": StreamSpec(xe, ye, rate_hz=0.0)},
                            n_requests=1)


def test_open_loop_without_replacement_sends_every_row_once():
    """``replace=False`` (the port's addition to ``run_open_loop``) sends
    each pool row once, so a stream's accuracy is the pool's."""
    spec, state = _small_net()
    xs = _x(spec, 8, n=40)
    ys = np.arange(40) % spec.n_classes
    svc = BCPNNService(state, spec, max_batch=8).start()
    try:
        rep = run_open_loop(svc, xs, ys, n_requests=40, rate_hz=2000.0,
                            seed=3, replace=False)
    finally:
        svc.stop()
    assert len(rep.results) == 40 and sorted(rep.labels) == sorted(ys)
    _, pred = infer(state, spec, torch.from_numpy(xs))
    assert rep.accuracy() == float((pred.numpy() == ys).mean())


def test_adaptive_target_bucket_tracks_arrival_rate():
    spec, state = _small_net()
    svc = BCPNNService(state, spec, max_batch=16, max_wait_ms=10.0,
                       poll_ms=10.0)
    slot = svc._slots["default"]
    svc._adapt(slot)
    assert slot.target_bucket == 1 and svc.active_buckets() == (1,)
    for k in range(64):                     # ~100 Hz
        slot.metrics.record_submit(now=k * 0.01)
    svc._adapt(slot)
    assert slot.target_bucket == 4
    slow = ServeMetrics()
    for k in range(8):
        slow.record_submit(now=k * 1.0)
        slow.record_batch(n_valid=8, bucket=8)
    slot.metrics = slow
    svc._adapt(slot)
    assert slot.target_bucket == 8
    off = BCPNNService(state, spec, max_batch=16, adaptive_buckets=False)
    off._adapt(off._slots["default"])
    assert off.active_buckets() == (1, 2, 4, 8, 16)


# ----------------------------------------------------- online learning ----

def _feedback_stream(spec, n, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.random((n, spec.input_geom.N)).astype(np.float32)
    ys = rng.integers(0, spec.n_classes, size=n).astype(np.int32)
    return xs, ys


def _replay(state, spec, xs, ys, batch, learn_stack):
    """The port's offline replay: the engine's learn step over the same
    batch compositions (full batches, then one cycled tail)."""
    items = list(zip(xs, ys))
    while items:
        chunk, items = items[:batch], items[batch:]
        x, y = (torch.from_numpy(a) for a in cycle_batch(chunk, batch))
        state = (online_learn_step(state, spec, x, y, learn_stack=True)
                 if learn_stack else
                 supervised_readout_step(state, spec, x, y))
    return state


def _served_folds(state, spec, xs, ys, learn_stack, cls=BCPNNService):
    svc = cls(state, spec, max_batch=4, online_learning=True,
              learn_stack=learn_stack, feedback_batch=8,
              feedback_eager=False).start()
    for x, y in zip(xs, ys):
        svc.feedback(x, int(y))
    svc.stop()
    return svc.state


@pytest.mark.parametrize("learn_stack", [False, True],
                         ids=["readout", "stack"])
def test_online_folds_match_the_jax_service(learn_stack):
    """The same feedback stream folded by the JAX service and the port's,
    from the same state: traces within 1e-5, weights within 1e-4, clocks
    and masks equal."""
    jspec, jst, tspec, tst = _jax_pair(seed=2, depth=2)
    xs, ys = _feedback_stream(tspec, 21, seed=1)
    jgot = _served_folds(jst, jspec, xs, ys, learn_stack, cls=JService)
    tgot = _served_folds(tst, tspec, xs, ys, learn_stack)
    for pt, pj in zip(tgot.projs + (tgot.readout,),
                      jgot.projs + (jgot.readout,)):
        for name in ("pi", "pj", "pij"):
            np.testing.assert_allclose(
                getattr(pt.traces, name).numpy(),
                np.asarray(getattr(pj.traces, name)), atol=TRACE_TOL)
        np.testing.assert_allclose(pt.w.numpy(), np.asarray(pj.w),
                                   atol=W_TOL)
        np.testing.assert_allclose(pt.b.numpy(), np.asarray(pj.b),
                                   atol=W_TOL)
        np.testing.assert_array_equal(pt.mask.numpy(), np.asarray(pj.mask))
        assert int(pt.traces.t) == int(pj.traces.t) == pt.traces.t_host
    assert int(tgot.step) == int(jgot.step) == 3


def test_readout_online_learning_parity_bitwise():
    spec, state = _small_net()
    xs, ys = _feedback_stream(spec, 24, seed=1)
    got = _served_folds(state, spec, xs, ys, learn_stack=False)
    _assert_states_bitwise(got, _replay(state, spec, xs, ys, 8, False))


def test_stack_online_learning_parity_dense_bitwise():
    spec, state = _small_net(depth=2)
    xs, ys = _feedback_stream(spec, 21, seed=2)  # 2 full batches + tail 5
    got = _served_folds(state, spec, xs, ys, learn_stack=True)
    _assert_states_bitwise(got, _replay(state, spec, xs, ys, 8, True))
    assert got.projs[0].traces.t_host == 3
    assert not torch.equal(got.projs[0].w, state.projs[0].w)


@pytest.mark.parametrize("compact", [False, True],
                         ids=["patchy-held", "compact"])
def test_stack_online_learning_parity_with_rewire_bitwise(compact):
    """A dense and a patchy model served side by side with stack learning
    and ``struct_every`` rewires: each equals its offline replay bit for
    bit, and requests served after the rewire equal ``infer_packed`` on
    the folded state."""
    spec_d, state_d = _small_net(seed=3)
    spec_p, state_p = _small_net(seed=4, nact=[9], patchy_traces=True,
                                 compact=compact, struct_every=2)
    fb = 8
    xs_d, ys_d = _feedback_stream(spec_d, 2 * fb, seed=5)
    xs_p, ys_p = _feedback_stream(spec_p, 3 * fb, seed=6)
    svc = BCPNNService.multi(
        {"dense": (state_d, spec_d), "patchy": (state_p, spec_p)},
        max_batch=4, online_learning=True, learn_stack=True,
        feedback_batch=fb, feedback_eager=False).start()
    for i in range(len(xs_p)):
        if i < len(xs_d):
            svc.feedback(xs_d[i], int(ys_d[i]), model="dense")
        svc.feedback(xs_p[i], int(ys_p[i]), model="patchy")
    _wait(lambda: svc.snapshot(model="patchy")["learn_steps"] == 3)
    xq = _x(spec_p, 7, n=3)
    served = [svc.classify(x, timeout=30, model="patchy") for x in xq]
    svc.stop()
    svc.revalidate()
    got_p = svc.model_state("patchy")
    assert got_p.projs[0].traces.t_host == 3  # crossed the t=2 rewire
    _assert_states_bitwise(svc.model_state("dense"),
                           _replay(state_d, spec_d, xs_d, ys_d, fb, True))
    _assert_states_bitwise(got_p, _replay(state_p, spec_p, xs_p, ys_p, fb,
                                          True))
    for x, r in zip(xq, served):
        probs, pred = infer_packed(pack_state(got_p, spec_p), spec_p,
                                   torch.from_numpy(x[None]),
                                   torch.ones(1))
        assert r.pred == int(pred[0])
        np.testing.assert_array_equal(r.probs, probs[0].numpy())


def test_online_learning_relearns_a_cold_readout_under_traffic():
    from repro_torch.data.synthetic import encode_images, make_synthetic
    ds = make_synthetic(512, 192, 8, 4, seed=3, max_shift=1)
    xt, xe = encode_images(ds.x_train), encode_images(ds.x_test)
    spec = deep_synth_spec(side=8, depth=1, n_classes=4, hidden_hc=8,
                           hidden_mc=16)
    tr = Trainer(spec, seed=0, device="cpu")
    tr.fit(xt, ds.y_train, epochs=4, batch=64)
    cold = dataclasses.replace(tr.state, readout=init_projection(
        spec.readout, make_generator(7, tr.device)))
    acc_cold = _accuracy(cold, spec, xe, ds.y_test)
    svc = BCPNNService(cold, spec, max_batch=8, online_learning=True,
                       feedback_batch=16).start()
    rep = run_open_loop(svc, xe, ds.y_test, n_requests=160, rate_hz=800,
                        seed=2, feedback_frac=1.0, fb_x=xt, fb_y=ds.y_train)
    svc.stop()
    snap = svc.snapshot()
    assert snap["completed"] == 160 and len(rep.results) == 160
    assert snap["learn_steps"] > 0
    assert _accuracy(svc.state, spec, xe, ds.y_test) > acc_cold + 0.1


def _accuracy(state, spec, x, y):
    _, pred = infer(state, spec, torch.from_numpy(x))
    return float((pred.numpy() == y).mean())


# -------------------------------------------------- the failure ladder ----

def test_fault_injector_schedule_rates_and_corruption():
    with pytest.raises(ValueError):
        FaultInjector(rates={"no-such-point": 0.5})
    inj = FaultInjector(seed=7, schedule={"infer-raise": {0, 2}})
    assert [inj.maybe("infer-raise") is not None for _ in range(4)] \
        == [True, False, True, False]
    a = FaultInjector(seed=3, rates={"infer-raise": 0.3, "slow-batch": 0.3})
    b = FaultInjector(seed=3, rates={"infer-raise": 0.3, "slow-batch": 0.3})
    seq_a = [a.maybe("infer-raise") is not None for _ in range(40)]
    _ = [b.maybe("slow-batch") for _ in range(3)]
    assert seq_a == [b.maybe("infer-raise") is not None for _ in range(40)]
    with pytest.raises(Exception):
        Fault(point="infer-raise", index=0).index = 1
    _, state = _small_net()
    before = [t.clone() for t in state_tensors(state)]
    bad = FaultInjector.corrupt_state(state)
    assert _state_finite(state) and not _state_finite(bad)
    for t, u in zip(state_tensors(state), before):  # input untouched
        assert torch.equal(t, u)


def test_overloaded_at_queue_bound_and_deadline_shedding():
    spec, state = _small_net()
    blk = _Blocker()
    svc = BCPNNService(state, spec, max_batch=4, max_queue=3,
                       fault_injector=blk).start()
    try:
        x = _x(spec)
        first = svc.submit(x)
        assert blk.entered.wait(10.0)
        doomed = svc.submit(x, deadline_s=0.05)
        backlog = [svc.submit(x) for _ in range(2)]
        with pytest.raises(Overloaded, match="3/3"):
            svc.submit(x)
        time.sleep(0.12)
        blk.release.set()
        svc.result(first, timeout=30.0)
        with pytest.raises(DeadlineExceeded, match=f"request {doomed}"):
            svc.result(doomed, timeout=30.0)
        for rid in backlog:
            svc.result(rid, timeout=30.0)
        snap = svc.snapshot()
        assert snap["rejected"] == 1.0 and snap["shed"] == 1.0
        assert snap["submitted"] == snap["completed"] + snap["shed"]
    finally:
        blk.release.set()
        svc.stop()


def test_poison_bisection_isolates_exactly_the_bad_request():
    spec, state = _small_net()
    blk = _Blocker()
    svc = BCPNNService(state, spec, max_batch=8, fault_injector=blk).start()
    try:
        xs = _x(spec, seed=5, n=6)
        first = svc.submit(_x(spec))
        assert blk.entered.wait(10.0)
        rids = [svc.submit(xs[i]) for i in range(6)]
        blk.poison(rids[2])
        blk.release.set()
        svc.result(first, timeout=30.0)
        with pytest.raises(FaultInjected, match=str(rids[2])):
            svc.result(rids[2], timeout=30.0)
        _, pred = infer(state, spec, torch.from_numpy(xs))
        for i, rid in enumerate(rids):
            if i != 2:
                assert svc.result(rid, timeout=30.0).pred == int(pred[i])
        snap = svc.snapshot()
        assert snap["failed"] == 1.0 and snap["bisects"] >= 1.0
        assert snap["completed"] == 6.0
    finally:
        blk.release.set()
        svc.stop()


def test_transient_infer_raise_costs_a_retry_not_the_batch():
    spec, state = _small_net()
    blk = _Blocker(seed=0, schedule={"infer-raise": {1}})
    svc = BCPNNService(state, spec, max_batch=8, fault_injector=blk).start()
    try:
        first = svc.submit(_x(spec))
        assert blk.entered.wait(10.0)
        rids = [svc.submit(_x(spec, seed=3 + i)) for i in range(4)]
        blk.release.set()
        svc.result(first, timeout=30.0)
        for rid in rids:
            assert svc.result(rid, timeout=30.0).pred >= 0
        snap = svc.snapshot()
        assert snap["failed"] == 0.0 and snap["bisects"] >= 1.0
        assert snap["completed"] == 5.0
    finally:
        blk.release.set()
        svc.stop()


@pytest.mark.parametrize("fault", ["nan-state", "nan-feedback"])
def test_quarantine_rolls_back_bitwise_and_keeps_serving(fault):
    """A fold whose candidate holds a NaN (injected into the state, or
    carried in by a feedback row through the update path) is never
    installed: the slot rolls back to the last-good state bit for bit,
    serves from it, refuses feedback until ``revalidate``."""
    spec, state = _small_net()
    inj = FaultInjector(seed=0, schedule=(
        {"nan-state": {1}} if fault == "nan-state" else {}))
    svc = BCPNNService(state, spec, max_batch=4, online_learning=True,
                       feedback_batch=2, feedback_eager=False,
                       fault_injector=inj).start()
    try:
        rng = np.random.default_rng(0)
        ni = spec.input_geom.N

        def fb(nan=False):
            x = rng.random(ni).astype(np.float32)
            if nan:
                x[3] = np.nan
            svc.feedback(x, int(rng.integers(0, spec.n_classes)))

        fb(), fb()
        _wait(lambda: svc.snapshot()["learn_steps"] >= 1)
        good = [t.clone() for t in state_tensors(svc.model_state())]
        fb(nan=fault == "nan-feedback"), fb()
        _wait(lambda: svc.snapshot()["quarantined"] == 1.0)
        for g, a in zip(good, state_tensors(svc.model_state())):
            assert torch.equal(g, a)
        x = _x(spec, seed=9)
        res = svc.classify(x, timeout=30.0)
        probs, pred = infer(svc.model_state(), spec,
                            torch.from_numpy(x[None]))
        assert res.pred == int(pred[0])
        np.testing.assert_array_equal(res.probs, probs[0].numpy())
        with pytest.raises(Quarantined):
            fb()
        snap = svc.snapshot()
        assert snap["quarantine_events"] == 1.0
        assert snap["learn_steps"] == 1.0
        svc.revalidate()
        assert svc.snapshot()["quarantined"] == 0.0
        fb(), fb()
        _wait(lambda: svc.snapshot()["learn_steps"] >= 2)
        assert _state_finite(svc.model_state())
    finally:
        svc.stop()


def test_fold_raise_is_survived_and_counted():
    spec, state = _small_net()
    inj = FaultInjector(seed=0, schedule={"fold-raise": {0}})
    svc = BCPNNService(state, spec, max_batch=4, online_learning=True,
                       feedback_batch=2, feedback_eager=False,
                       fault_injector=inj).start()
    try:
        rng = np.random.default_rng(0)
        ni = spec.input_geom.N
        for i in range(2):
            svc.feedback(rng.random(ni).astype(np.float32), i % 2)
        _wait(lambda: svc.snapshot()["feedback_dropped"] >= 2.0)
        assert svc.snapshot()["learn_steps"] == 0.0
        assert svc.classify(_x(spec), timeout=30.0).pred >= 0
        for i in range(2):
            svc.feedback(rng.random(ni).astype(np.float32), i % 2)
        _wait(lambda: svc.snapshot()["learn_steps"] >= 1)
    finally:
        svc.stop()


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_dead_worker_fails_futures_and_raises_everywhere():
    spec, state = _small_net()
    blk = _Blocker()
    svc = BCPNNService(state, spec, max_batch=4, fault_injector=blk).start()
    slot = svc._slot(None)

    def _boom(*a, **k):
        raise KeyboardInterrupt("injected terminal failure")

    x = _x(spec)
    first = svc.submit(x)
    assert blk.entered.wait(10.0)
    pending = svc.submit(x)
    slot.program.serve = _boom          # the next batch kills the worker
    blk.release.set()
    with pytest.raises(WorkerDied):
        svc.result(first, timeout=30.0)
    with pytest.raises(WorkerDied):
        svc.result(pending, timeout=30.0)
    with pytest.raises(WorkerDied):
        svc.submit(x)
    with pytest.raises(WorkerDied, match="KeyboardInterrupt"):
        svc.stop()
    with pytest.raises(WorkerDied):
        svc.start()


def test_stop_timeout_raises_instead_of_hanging():
    spec, state = _small_net()
    blk = _Blocker()
    svc = BCPNNService(state, spec, max_batch=4, fault_injector=blk).start()
    svc.submit(_x(spec))
    assert blk.entered.wait(10.0)
    with pytest.raises(RuntimeError, match="failed to drain"):
        svc.stop(timeout_s=0.3)
    blk.release.set()


def test_injected_slow_batch_surfaces_as_attributed_straggler():
    """The injected delay (1.5 s) sits far above any batch a loaded
    machine takes here, so the event does not depend on the load."""
    spec, state = _small_net()
    inj = FaultInjector(seed=0, schedule={"slow-batch": {10}},
                        slow_ms=1500.0)
    svc = BCPNNService(state, spec, max_batch=4, fault_injector=inj).start()
    try:
        x = _x(spec)
        for _ in range(11):
            svc.classify(x, timeout=30.0)
        ev = [e for e in svc.step_timer.events if e.get("tag") == "default"]
        assert ev and ev[-1]["time"] >= 1.4
        assert svc.snapshot()["straggler_events"] >= 1.0
    finally:
        svc.stop()


def test_set_model_state_and_sync_read_at_a_fold_boundary():
    spec, state = _small_net(seed=0)
    _, other = _small_net(seed=5)
    svc = BCPNNService(state, spec, max_batch=4, online_learning=True).start()
    try:
        assert svc.model_state_sync() is state
        svc.set_model_state(None, other)
        assert svc.model_state_sync() is other
        x = _x(spec, seed=1)
        r = svc.classify(x, timeout=30)
        _, pred = infer(other, spec, torch.from_numpy(x[None]))
        assert r.pred == int(pred[0])
    finally:
        svc.stop()


# ------------------------------------------------ loading and launching ----

def test_load_models_serves_each_checkpoint(tmp_path):
    spec, _ = _small_net()
    tr = Trainer(spec, seed=0, device="cpu")
    d = str(tmp_path / "modelA")
    tr.save(d)
    models = load_models([d, d], device="cpu")
    assert set(models) == {"modelA", "modelA#2"}
    svc = BCPNNService.multi(models, max_batch=4).start()
    try:
        r = svc.classify(np.zeros((spec.input_geom.N,), np.float32),
                         timeout=30, model="modelA#2")
        assert r.model == "modelA#2"
    finally:
        svc.stop()


def test_launcher_smoke_on_the_cpu(tmp_path, capsys):
    """``serve_bcpnn --smoke --device cpu`` in-process: phases 1-5 with
    their assertions, the router failover (phase 5) included; ``--router``
    runs phase 5 without ``--smoke``, ``--no-router`` skips it."""
    ckpt = str(tmp_path / "ckpt")
    serve_bcpnn.main(["--smoke", "--device", "cpu", "--ckpt-dir", ckpt])
    out = capsys.readouterr().out
    assert "multi-model + rewire phase OK" in out
    assert "router failover phase OK" in out
    assert "1 engine losses, 1 replacements" in out
    assert out.rstrip().endswith("smoke OK")
    serve_bcpnn.main(["--device", "cpu", "--ckpt-dir", ckpt, "--no-online",
                      "--requests", "16"])
    out = capsys.readouterr().out
    assert "restored step" in out and "router" not in out
    serve_bcpnn.main(["--device", "cpu", "--ckpt-dir", ckpt, "--no-online",
                      "--requests", "16", "--router"])
    assert "router failover phase OK" in capsys.readouterr().out
