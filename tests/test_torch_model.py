"""The port's layer, network and trainer, held against the JAX package on
the CPU at small sizes.

Backends pair up as JAX ``"pallas"`` (Pallas kernels in interpret mode) ↔
port ``"cuda"`` (kernel wrappers, which run their plain versions on CPU
tensors) and JAX ``"jnp"`` ↔ port ``"torch"``.  States cross over as numpy
trees (``repro_torch.convert``); the exploration noise of the unsupervised
step is drawn by JAX and injected, since the two packages' generators draw
different numbers.

Tolerances (absolute): 1e-5 for forward rates and traces, 1e-4 for
weights after several learn steps (DESIGN.md §3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.bcpnn_models import deep_synth_spec as j_deep_synth_spec
from repro.core import bcpnn_layer as jl
from repro.core import network as jn
from repro.core.hypercolumns import LayerGeom as JGeom
from repro.core.trainer import Trainer as JTrainer
from repro.data import synthetic as jsyn
from repro_torch import convert
from repro_torch.configs.bcpnn_models import deep_synth_spec
from repro_torch.core import bcpnn_layer as tl
from repro_torch.core import network as tn
from repro_torch.core.hypercolumns import LayerGeom
from repro_torch.core.traces import Traces
from repro_torch.core.trainer import Trainer
from repro_torch.data import synthetic as tsyn

FWD_TOL = 1e-5
TRACE_TOL = 1e-5
W_TOL = 1e-4
BACKENDS = [("pallas", "cuda"), ("jnp", "torch")]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers; torch's intra-op pool would take
    every core of the machine for these small shapes and slow the
    timing-sensitive tests running beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _jproj_tree(p):
    return {"traces": {"pi": np.asarray(p.traces.pi),
                       "pj": np.asarray(p.traces.pj),
                       "pij": np.asarray(p.traces.pij),
                       "t": int(p.traces.t)},
            "w": np.asarray(p.w), "b": np.asarray(p.b),
            "mask": np.asarray(p.mask), "table": None}


def _jstate_tree(st):
    return {"projs": [_jproj_tree(p) for p in st.projs],
            "readout": _jproj_tree(st.readout), "step": int(st.step)}


def _port_proj(p):
    tr = _jproj_tree(p)["traces"]
    return tl.Projection(
        traces=Traces(pi=_t(tr["pi"]), pj=_t(tr["pj"]), pij=_t(tr["pij"]),
                      t=torch.tensor(tr["t"], dtype=torch.int32)),
        w=_t(p.w), b=_t(p.b), mask=_t(p.mask))


def _assert_proj_close(pt, pj, where=""):
    np.testing.assert_allclose(pt.traces.pi.numpy(), np.asarray(pj.traces.pi),
                               atol=TRACE_TOL, err_msg=f"pi {where}")
    np.testing.assert_allclose(pt.traces.pj.numpy(), np.asarray(pj.traces.pj),
                               atol=TRACE_TOL, err_msg=f"pj {where}")
    np.testing.assert_allclose(pt.traces.pij.numpy(),
                               np.asarray(pj.traces.pij),
                               atol=TRACE_TOL, err_msg=f"pij {where}")
    assert int(pt.traces.t) == int(pj.traces.t)
    np.testing.assert_allclose(pt.w.numpy(), np.asarray(pj.w), atol=W_TOL,
                               err_msg=f"w {where}")
    np.testing.assert_allclose(pt.b.numpy(), np.asarray(pj.b), atol=W_TOL,
                               err_msg=f"b {where}")


def _assert_state_close(st_t, st_j, where=""):
    for l, (pt, pj) in enumerate(zip(st_t.projs, st_j.projs)):
        _assert_proj_close(pt, pj, f"projs[{l}] {where}")
    _assert_proj_close(st_t.readout, st_j.readout, f"readout {where}")
    assert int(st_t.step) == int(st_j.step)


# ------------------------------------------------------------ layer ----

@pytest.mark.parametrize("jb,tb", BACKENDS)
def test_layer_forward_normalize_match_jax(jb, tb):
    jspec = jl.ProjSpec(JGeom(30, 2), JGeom(3, 10), alpha=0.1, backend=jb)
    tspec = tl.ProjSpec(LayerGeom(30, 2), LayerGeom(3, 10), alpha=0.1,
                        backend=tb)
    proj_j = jl.init_projection(jspec, jax.random.PRNGKey(0))
    proj_t = _port_proj(proj_j)
    rng = np.random.default_rng(3)
    x = rng.random((37, 60), dtype=np.float32)
    s = (rng.standard_normal((37, 30)) * 3).astype(np.float32)
    np.testing.assert_allclose(
        tl.forward(proj_t, tspec, _t(x)).numpy(),
        np.asarray(jl.forward(proj_j, jspec, jnp.asarray(x))), atol=FWD_TOL)
    np.testing.assert_allclose(
        tl.normalize(_t(s), tspec).numpy(),
        np.asarray(jl.normalize(jnp.asarray(s), jspec)), atol=FWD_TOL)


@pytest.mark.parametrize("jb,tb", BACKENDS)
def test_layer_learn_parity_across_bias_correction_crossover(jb, tb):
    """Ten chained learn steps with alpha=0.25: the smoothing is the
    running mean 1/(t+1) until t=4, the fixed-alpha EMA after; every step
    is compared on traces, weights and bias."""
    jspec = jl.ProjSpec(JGeom(12, 2), JGeom(4, 8), alpha=0.25, backend=jb)
    tspec = tl.ProjSpec(LayerGeom(12, 2), LayerGeom(4, 8), alpha=0.25,
                        backend=tb)
    proj_j = jl.init_projection(jspec, jax.random.PRNGKey(0))
    proj_t = _port_proj(proj_j)
    rng = np.random.default_rng(4)
    crossed = False
    for step in range(10):
        x = rng.random((16, 24), dtype=np.float32)
        y = rng.random((16, 32), dtype=np.float32)
        proj_j = jl.learn(proj_j, jspec, jnp.asarray(x), jnp.asarray(y))
        proj_t = tl.learn(proj_t, tspec, _t(x), _t(y))
        t = int(proj_t.traces.t)
        crossed = crossed or 1.0 / t < tspec.alpha
        _assert_proj_close(proj_t, proj_j, f"step {step}")
    assert crossed, "sweep never left the bias-correction regime"


@pytest.mark.parametrize("jb,tb", BACKENDS)
def test_layer_learn_masked_matches_jax(jb, tb):
    """Chained masked steps with pad rows scattered through the batch: the
    port's ``"cuda"`` backend runs the update kernel with the genuine row
    count as divisor, JAX runs the step plain on both backends."""
    jspec = jl.ProjSpec(JGeom(12, 2), JGeom(4, 8), alpha=0.25, backend=jb)
    tspec = tl.ProjSpec(LayerGeom(12, 2), LayerGeom(4, 8), alpha=0.25,
                        backend=tb)
    proj_j = jl.init_projection(jspec, jax.random.PRNGKey(0))
    proj_t = _port_proj(proj_j)
    rng = np.random.default_rng(8)
    for step, n_valid in enumerate((5, 16, 1, 9, 12, 3)):
        x = rng.random((16, 24), dtype=np.float32)
        y = rng.random((16, 32), dtype=np.float32)
        valid = np.zeros(16, np.float32)
        valid[rng.permutation(16)[:n_valid]] = 1.0
        proj_j = jl.learn_masked(proj_j, jspec, jnp.asarray(x),
                                 jnp.asarray(y), jnp.asarray(valid))
        proj_t = tl.learn_masked(proj_t, tspec, _t(x), _t(y), _t(valid))
        _assert_proj_close(proj_t, proj_j, f"step {step}")


def test_unported_layouts_raise():
    """Nothing is left unported here any more: bf16 and int8 specs
    initialise and learn exactly as fp32 ones (learning state stays fp32,
    DESIGN.md §8) and pack into their serving dtype; the patchy layout
    builds an exactly-nact mask."""
    geo = (LayerGeom(8, 2), LayerGeom(2, 4))
    rng = np.random.default_rng(0)
    x, y = _t(rng.random((5, 16))), _t(rng.random((5, 8)))
    fp32 = tl.ProjSpec(*geo, nact=3)
    want = tl.learn(tl.init_projection(fp32, torch.Generator().manual_seed(0)),
                    fp32, x, y)
    assert want.mask.sum(0).tolist() == [3.0, 3.0]
    for dtype, wdt in (("bf16", torch.bfloat16), ("int8", torch.int8)):
        spec = tl.ProjSpec(*geo, nact=3, infer_dtype=dtype)
        proj = tl.learn(
            tl.init_projection(spec, torch.Generator().manual_seed(0)), spec,
            x, y)
        for got, ref in ((proj.w, want.w), (proj.b, want.b),
                         (proj.traces.pij, want.traces.pij),
                         (proj.traces.pi, want.traces.pi)):
            assert got.dtype == torch.float32
            assert torch.equal(got, ref)
        pack = tl.pack_projection(proj, spec)
        assert pack.w.dtype == wdt and pack.w.shape == proj.w.shape
        assert (pack.scale is not None) == (dtype == "int8")
        assert pack.table.tolist() == tl.pack_projection(want, fp32)\
            .table.tolist()


# ---------------------------------------------------------- network ----

def _specs(jb, tb, depth):
    kw = dict(side=12, depth=depth, hidden_hc=4, hidden_mc=8)
    return j_deep_synth_spec(backend=jb, **kw), deep_synth_spec(backend=tb, **kw)


def _inputs(spec_t, b=37, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.random((b, spec_t.input_geom.H), dtype=np.float32)
    xe = np.stack([x, 1 - x], -1).reshape(b, -1)
    labels = rng.integers(0, spec_t.n_classes, b).astype(np.int32)
    return xe, labels


@pytest.mark.parametrize("jb,tb", BACKENDS)
@pytest.mark.parametrize("depth", [1, 2])
def test_train_projection_step_with_injected_noise(jb, tb, depth):
    jspec, tspec = _specs(jb, tb, depth)
    st_j = jn.init_deep(jspec, jax.random.PRNGKey(0))
    st_t = convert.state_from_numpy(_jstate_tree(st_j), tspec, device="cpu")
    for layer in range(depth):
        for k in range(3):
            x, _ = _inputs(tspec, seed=10 * layer + k)
            h_j = jn.stack_rates(st_j, jspec, jnp.asarray(x), depth=layer)
            h_t = tn.stack_rates(st_t, tspec, _t(x), depth=layer)
            # layer 0 reads the input itself; upper layers read rates
            # through weights that have learned, to W_TOL, for 3 steps
            np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j),
                                       atol=FWD_TOL if layer == 0 else W_TOL)
            _, sub = jax.random.split(st_j.key)
            noise = jax.random.normal(
                sub, (x.shape[0], jspec.projs[layer].post.N), jnp.float32)
            st_j = jn.train_projection_step(st_j, jspec, h_j, layer)
            st_t = tn.train_projection_step(st_t, tspec, h_t, layer,
                                            noise=_t(noise))
            _assert_state_close(st_t, st_j, f"layer {layer} step {k}")


@pytest.mark.parametrize("jb,tb", BACKENDS)
def test_readout_and_online_steps_and_infer(jb, tb):
    jspec, tspec = _specs(jb, tb, 2)
    st_j = jn.init_deep(jspec, jax.random.PRNGKey(1))
    st_t = convert.state_from_numpy(_jstate_tree(st_j), tspec, device="cpu")
    x, labels = _inputs(tspec)
    valid = (np.arange(37) < 30).astype(np.float32)
    # readout steps, whole batch then masked tail
    st_j = jn.supervised_readout_step(st_j, jspec, jnp.asarray(x),
                                      jnp.asarray(labels))
    st_t = tn.supervised_readout_step(st_t, tspec, _t(x),
                                      torch.from_numpy(labels))
    _assert_state_close(st_t, st_j, "readout step")
    st_j = jn.supervised_readout_step(st_j, jspec, jnp.asarray(x),
                                      jnp.asarray(labels),
                                      valid=jnp.asarray(valid))
    st_t = tn.supervised_readout_step(st_t, tspec, _t(x),
                                      torch.from_numpy(labels),
                                      valid=_t(valid))
    _assert_state_close(st_t, st_j, "masked readout step")
    # online folds, readout-only and whole stack
    for learn_stack in (False, True):
        st_j = jn.online_learn_step(st_j, jspec, jnp.asarray(x),
                                    jnp.asarray(labels),
                                    learn_stack=learn_stack)
        st_t = tn.online_learn_step(st_t, tspec, _t(x),
                                    torch.from_numpy(labels),
                                    learn_stack=learn_stack)
        _assert_state_close(st_t, st_j, f"online learn_stack={learn_stack}")
    # inference with a validity mask: pad rows give probs 0 and pred -1
    probs_j, pred_j = jn.infer(st_j, jspec, jnp.asarray(x),
                               valid=jnp.asarray(valid))
    probs_t, pred_t = tn.infer(st_t, tspec, _t(x), valid=_t(valid))
    np.testing.assert_allclose(probs_t.numpy(), np.asarray(probs_j),
                               atol=FWD_TOL)
    np.testing.assert_array_equal(pred_t.numpy(), np.asarray(pred_j))
    assert np.all(pred_t.numpy()[30:] == -1)
    assert np.all(probs_t.numpy()[30:] == 0.0)
    # the packed serving path gives the same answer
    pt, qt = tn.infer_packed(tn.pack_state(st_t, tspec), tspec, _t(x))
    np.testing.assert_allclose(pt.numpy()[:30], probs_t.numpy()[:30],
                               atol=FWD_TOL)
    np.testing.assert_array_equal(qt.numpy()[:30], pred_t.numpy()[:30])


def _fit_spec(spec, noise_steps=60):
    projs = tuple(dataclasses.replace(p, noise_steps=noise_steps)
                  for p in spec.projs)
    return type(spec)(projs=projs, readout=spec.readout)


def test_fit_through_padded_tail_matches_jax_accuracy():
    """1500 samples at batch 64 leave a 28-row tail, so both fits take the
    masked step.  The noise streams differ, so the two are compared on
    test accuracy (within 5 points) rather than state."""
    ds = jsyn.make_synthetic(1500, 500, 12, 5, seed=0)
    xtr, xte = jsyn.encode_images(ds.x_train), jsyn.encode_images(ds.x_test)
    kw = dict(side=12, depth=1, hidden_hc=16, hidden_mc=32)
    jtr = JTrainer(_fit_spec(j_deep_synth_spec(backend="jnp", **kw)), seed=0)
    jtr.fit(xtr, ds.y_train, epochs=4, batch=64)
    acc_j = jtr.evaluate(xte, ds.y_test)
    ttr = Trainer(_fit_spec(deep_synth_spec(backend="cuda", **kw)), seed=0,
                  device="cpu")
    stats = ttr.fit(xtr, ds.y_train, epochs=4, batch=64)
    acc_t = ttr.evaluate(xte, ds.y_test)
    assert set(stats) == {"unsup_s", "sup_s", "train_ms_per_img",
                          "straggler_events"}
    assert acc_t > 0.5, acc_t  # chance is 0.2
    assert abs(acc_t - acc_j) <= 0.05, (acc_t, acc_j)
    pred = ttr.predict(xte[:50])
    assert pred.shape == (50,) and pred.dtype == np.int64


def test_fit_masks_only_the_tail_batch(monkeypatch):
    """100 samples at batch 32: three whole batches take ``learn`` and the
    4-row tail alone takes ``learn_masked``, in every unsupervised epoch
    and in the readout pass."""
    calls = {"learn": 0, "learn_masked": 0}

    def counted(name):
        fn = getattr(tn, name)

        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    for name in calls:
        monkeypatch.setattr(tn, name, counted(name))
    ds = tsyn.make_synthetic(100, 10, 12, 5, seed=0)
    spec = deep_synth_spec(side=12, depth=1, hidden_hc=4, hidden_mc=8)
    Trainer(spec, seed=0, device="cpu").fit(
        tsyn.encode_images(ds.x_train), ds.y_train, epochs=2, batch=32)
    assert calls == {"learn": 2 * 3 + 3, "learn_masked": 2 + 1}


# ----------------------------------------------------------- odds & ends --

def test_spec_from_jax_dict_maps_backends():
    for jb, tb in BACKENDS:
        jspec = j_deep_synth_spec(backend=jb, depth=2)
        d = jn.spec_to_dict(jspec)
        tspec = tn.spec_from_dict(d)
        assert tspec == deep_synth_spec(backend=tb, depth=2)
        back = tn.spec_to_dict(tspec)
        for p_back, p_jax in zip(back["projs"] + [back["readout"]],
                                 d["projs"] + [d["readout"]]):
            assert p_back == {**p_jax, "backend": tb}


def test_make_synthetic_equals_jax():
    a = jsyn.make_synthetic(64, 16, 12, 5, seed=3)
    b = tsyn.make_synthetic(64, 16, 12, 5, seed=3)
    for f in ("x_train", "y_train", "x_test", "y_test"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(jsyn.encode_images(a.x_test),
                                  tsyn.encode_images(b.x_test))


def test_state_numpy_round_trip():
    jspec, tspec = _specs("pallas", "cuda", 2)
    tree = _jstate_tree(jn.init_deep(jspec, jax.random.PRNGKey(2)))
    back = convert.state_to_numpy(
        convert.state_from_numpy(tree, tspec, device="cpu"))
    assert back["step"] == tree["step"]
    for pb, pt in zip(back["projs"] + [back["readout"]],
                      tree["projs"] + [tree["readout"]]):
        for k in ("pi", "pj", "pij", "t"):
            np.testing.assert_array_equal(pb["traces"][k], pt["traces"][k])
        for k in ("w", "b", "mask"):
            np.testing.assert_array_equal(pb[k], pt[k])
    with pytest.raises(ValueError):
        convert.state_from_numpy(tree, deep_synth_spec(depth=1),
                                 device="cpu")


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = deep_synth_spec(depth=1, hidden_hc=4, hidden_mc=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(spec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tn.init_deep(spec)
    Trainer(spec, device="cpu")  # the explicit CPU is fine


def test_trainer_takes_the_jax_argument_order():
    """``Trainer(cfg, seed, mesh, data_axis)`` as in the JAX package, with
    ``device`` a keyword only; ``fit``'s keywords in the JAX order."""
    import inspect
    spec = deep_synth_spec(depth=1, hidden_hc=4, hidden_mc=8)
    for port, ref in ((Trainer.__init__, JTrainer.__init__),
                      (Trainer.fit, JTrainer.fit)):
        want = list(inspect.signature(ref).parameters)
        got = list(inspect.signature(port).parameters)
        assert got[:len(want)] == want, (port.__qualname__, got, want)
    params = inspect.signature(Trainer.__init__).parameters
    assert params["device"].kind is inspect.Parameter.KEYWORD_ONLY
    # a mesh in the JAX position reaches the named refusal, not
    # torch.device
    with pytest.raises(NotImplementedError, match="queue A item 7"):
        Trainer(spec, 0, object(), device="cpu")
    with pytest.raises(NotImplementedError, match="queue A item 7"):
        Trainer(spec, 0, None, "batch", device="cpu")
    with pytest.raises(TypeError):
        Trainer(spec, 0, None, "data", "cpu")  # device is keyword only
    assert Trainer(spec, 3, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("kwargs", [
    {"ckpt_every_batches": 4}, {"on_chunk": lambda cursor: None},
    {"ckpt_dir": "ckpt"}, {"resume": True}])
def test_fit_checkpoint_arguments_match_jax(kwargs, tmp_path):
    """Each of ``fit``'s checkpoint arguments is accepted, or refused with
    the JAX ``ValueError``, as ``repro.core.Trainer.fit`` does: chunks
    without a directory write nothing, the callback sees the same cursors,
    a directory alone gets one final checkpoint with the same cursor, and
    ``resume`` without a directory is refused alike."""
    jspec = j_deep_synth_spec(depth=1, hidden_hc=4, hidden_mc=8)
    spec = deep_synth_spec(depth=1, hidden_hc=4, hidden_mc=8)
    rng = np.random.default_rng(0)
    x = rng.random((12, spec.projs[0].pre.N)).astype(np.float32)
    y = rng.integers(0, spec.n_classes, size=12).astype(np.int32)
    outcomes = []
    for pkg, trainer in (("jax", JTrainer(jspec, seed=0)),
                         ("port", Trainer(spec, seed=0, device="cpu"))):
        kw = dict(kwargs)
        seen = []
        if "on_chunk" in kw:
            kw["on_chunk"] = lambda cur: seen.append(cur.to_dict())
        if "ckpt_dir" in kw:
            kw["ckpt_dir"] = str(tmp_path / pkg)
        try:
            trainer.fit(x, y, epochs=1, batch=4, **kw)
        except ValueError as e:
            outcomes.append(("ValueError", str(e), seen))
            continue
        written = None
        if "ckpt_dir" in kw:
            from repro.checkpoint import CheckpointManager as JManager
            mgr = JManager(kw["ckpt_dir"])
            written = (mgr.all_steps(),
                       mgr.read_extra(mgr.latest_step())["cursor"])
        outcomes.append(("ok", written, seen))
    assert outcomes[0] == outcomes[1]
    if "resume" in kwargs:
        assert outcomes[0][0] == "ValueError"
        assert "requires ckpt_dir" in outcomes[0][1]


def test_core_helpers_match_jax():
    """The ported helpers off the main path: hardmax, scalar encoding, the
    trace update, mutual information and the expanded HC mask."""
    from repro.core import hypercolumns as jh
    from repro.core import traces as jt
    from repro_torch.core import hypercolumns as th
    from repro_torch.core import traces as tt
    rng = np.random.default_rng(6)
    s = rng.standard_normal((9, 12)).astype(np.float32)
    s[0, :3] = 1.0  # a tie: the first maximum wins
    np.testing.assert_array_equal(
        th.hc_hardmax(_t(s), LayerGeom(4, 3)).numpy(),
        np.asarray(jh.hc_hardmax(jnp.asarray(s), JGeom(4, 3))))
    f = rng.random((5, 7), dtype=np.float32) * 1.4 - 0.2
    np.testing.assert_array_equal(
        th.encode_scalar_hcs(_t(f)).numpy(),
        np.asarray(jh.encode_scalar_hcs(jnp.asarray(f))))
    pij = rng.random((6, 8), dtype=np.float32) * 0.1
    x = rng.random((11, 6), dtype=np.float32)
    y = rng.random((11, 8), dtype=np.float32)
    tr_j = jt.Traces(pi=jnp.full((6,), 0.5), pj=jnp.full((8,), 0.25),
                     pij=jnp.asarray(pij), t=jnp.asarray(2, jnp.int32))
    tr_t = Traces(pi=torch.full((6,), 0.5), pj=torch.full((8,), 0.25),
                  pij=_t(pij), t=torch.tensor(2, dtype=torch.int32))
    up_j = jt.update_traces(tr_j, jnp.asarray(x), jnp.asarray(y), 0.1)
    up_t = tt.update_traces(tr_t, _t(x), _t(y), 0.1)
    for k in ("pi", "pj", "pij"):
        np.testing.assert_allclose(getattr(up_t, k).numpy(),
                                   np.asarray(getattr(up_j, k)),
                                   atol=TRACE_TOL)
    assert int(up_t.t) == 3
    np.testing.assert_allclose(
        tt.mutual_information(up_t, 3, 2, 2, 4).numpy(),
        np.asarray(jt.mutual_information(up_j, 3, 2, 2, 4)), atol=W_TOL)
    mask = (rng.random((3, 2)) > 0.5).astype(np.float32)
    jspec = jl.ProjSpec(JGeom(3, 2), JGeom(2, 4))
    tspec = tl.ProjSpec(LayerGeom(3, 2), LayerGeom(2, 4))
    np.testing.assert_array_equal(
        tl.expand_hc_mask(_t(mask), tspec).numpy(),
        np.asarray(jl.expand_hc_mask(jnp.asarray(mask), jspec)))
