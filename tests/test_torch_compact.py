"""The compact-resident layout of the port, structural plasticity and the
struct presets, held against the JAX package on the CPU.

Layout conversions compare bitwise; chained learning through a rewire,
the masked tail step and converted-state inference within the tolerances
of ``test_torch_patchy.py`` (traces 1e-6/1e-5, weights 1e-4, rates 1e-5).
Fits are compared on test accuracy only: the two packages draw different
noise.

    python tests/test_torch_compact.py --reference-accuracy

fits Table-1 Model 1-struct in the compact layout with the JAX package on
the CPU and prints the test accuracy that ``chip_smoke.py`` holds the
port's card fit to.
"""
import dataclasses
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.bcpnn_models import deep_synth_spec as j_deep_synth_spec
from repro.core import bcpnn_layer as jl
from repro.core import compact as jc
from repro.core import network as jn
from repro.core.trainer import Trainer as JTrainer
from repro.data import synthetic as jsyn
from repro_torch import convert
from repro_torch.configs.bcpnn_models import (MODEL1_MNIST_STRUCT,
                                              deep_synth_spec)
from repro_torch.core import bcpnn_layer as tl
from repro_torch.core import compact as tc
from repro_torch.core import network as tn
from repro_torch.core.traces import Traces
from repro_torch.core.trainer import Trainer
from repro_torch.kernels import ops as tops

from test_torch_patchy import (_jspec, _port_proj, _steps, _t, _tspec,
                               assert_proj_close)

FWD_TOL = 1e-5
# Hi, Mi, Hj, Mj, nact.  One silent pre-HC per post-HC: silent pairs sit at
# MI ~0 with rounding noise that differs between the packages, so a rewire
# that picks among several of them is a near-tie (see _compact_case).
GEOM = (5, 2, 5, 10, 4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _compact_specs(jb="jnp", tb="torch", **kw):
    kw = dict(alpha=0.2, patchy_traces=True, compact=True, **kw)
    return _jspec(*GEOM, backend=jb, **kw), _tspec(*GEOM, backend=tb, **kw)


# ------------------------------------------------- layout conversions ----

def test_compactify_densify_round_trip_matches_jax_bitwise():
    jspec, tspec = _compact_specs()
    held_j = dataclasses.replace(jspec, compact=False)
    dense_j = jl.init_projection(held_j, jax.random.PRNGKey(3))
    for x, y in _steps(5, 3, 19, 10, 50):  # silent entries drift from init
        dense_j = jl.learn(dense_j, held_j, jnp.asarray(x), jnp.asarray(y))
    comp_j = jc.compactify_projection(dense_j, jspec)
    comp_t = tc.compactify_projection(_port_proj(dense_j), tspec)
    assert comp_t.w.shape == (5, 8, 10) and comp_t.table.shape == (5, 4)
    for a, b in ((comp_t.traces.pij, comp_j.traces.pij), (comp_t.w, comp_j.w),
                 (comp_t.table, comp_j.table)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back_j = jc.densify_projection(comp_j, jspec)
    back_t = tc.densify_projection(comp_t, tspec)
    assert back_t.table is None
    np.testing.assert_array_equal(back_t.traces.pij.numpy(),
                                  np.asarray(back_j.traces.pij))
    np.testing.assert_array_equal(back_t.w.numpy(), np.asarray(back_j.w))
    # whole states: every eligible projection flips, inference unchanged
    spec_t = deep_synth_spec(side=6, depth=2, hidden_hc=5, hidden_mc=6,
                             nact=[9, 3], patchy_traces=True)
    st = tn.init_deep(spec_t, seed=1, device="cpu")
    st_c, spec_c = tc.compactify_state(st, spec_t)
    assert [p.compact for p in spec_c.projs] == [True, True]
    assert st_c.projs[0].w.shape == (5, 18, 6)
    x = torch.rand(11, spec_t.input_geom.N)
    np.testing.assert_allclose(tn.infer(st_c, spec_c, x)[0].numpy(),
                               tn.infer(st, spec_t, x)[0].numpy(),
                               atol=FWD_TOL)


# ----------------------------------------------------------- learning ----

@pytest.mark.parametrize("jb,tb", [("pallas", "cuda"), ("jnp", "torch")])
def test_compact_learn_chain_with_rewire_matches_jax(jb, tb):
    """8 chained compact learn steps with a rewire after step 4: traces,
    weights, mask and table after every step, and the forward through the
    compact kernel's plain version."""
    jspec, tspec = _compact_specs(jb, tb)
    pj = jl.init_projection(jspec, jax.random.PRNGKey(0))
    pt = _port_proj(pj)
    rng = np.random.default_rng(2)
    for i, (x, y) in enumerate(_steps(1, 8, 19, 10, 50)):
        pj = jl.learn(pj, jspec, jnp.asarray(x), jnp.asarray(y))
        pt = tl.learn(pt, tspec, _t(x), _t(y))
        assert_proj_close(pt, pj, f"step {i}", pij_tol=1e-6)
        if i == 3:
            pj, pt = jl.rewire(pj, jspec), tl.rewire(pt, tspec)
            assert_proj_close(pt, pj, "after rewire", pij_tol=1e-6)
            tl.validate_patchy_state(pt, tspec)
        xf = rng.random((7, 10), dtype=np.float32)
        np.testing.assert_allclose(
            tl.forward(pt, tspec, _t(xf)).numpy(),
            np.asarray(jl.forward(pj, jspec, jnp.asarray(xf))), atol=FWD_TOL)
    assert pt.w.shape == (5, 8, 10)


@pytest.mark.parametrize("jb,tb", [("pallas", "cuda"), ("jnp", "torch")])
def test_compact_learn_masked_matches_jax(jb, tb):
    """Chained masked tail steps: the port's cuda backend runs the compact
    update kernel's plain version with the genuine-row count, JAX its
    plain masked stats."""
    jspec, tspec = _compact_specs(jb, tb)
    pj = jl.init_projection(jspec, jax.random.PRNGKey(1))
    pt = _port_proj(pj)
    rng = np.random.default_rng(8)
    for step, n_valid in enumerate((5, 19, 1, 12)):
        x = rng.random((19, 10), dtype=np.float32)
        y = rng.random((19, 50), dtype=np.float32)
        valid = np.zeros(19, np.float32)
        valid[rng.permutation(19)[:n_valid]] = 1.0
        pj = jl.learn_masked(pj, jspec, jnp.asarray(x), jnp.asarray(y),
                             jnp.asarray(valid))
        pt = tl.learn_masked(pt, tspec, _t(x), _t(y), _t(valid))
        assert_proj_close(pt, pj, f"step {step}", pij_tol=1e-6)


def _compact_case(case):
    """(JAX compact spec, port spec, JAX projection) with compact traces
    set up for a rewire.  "separated": one silent pre-HC per post-HC
    (Hi = nact + 1); each live block's joint is c*p_i*p_j, so its MI is
    c*log(c), far from the silent pair's ~0, and the live pre-HC with
    c = 0.5 (MI -0.35) is swapped for the silent one.  "tied": p_i = p_j =
    1, so every silent pair's MI is exactly 0 in both packages and every
    live pair's negative: the rewire picks the lowest-index silent
    pre-HCs."""
    hi = 5 if case == "separated" else 13
    geom = (hi, 2, 5, 10, 4)
    kw = dict(alpha=0.2, patchy_traces=True, compact=True)
    jspec, tspec = _jspec(*geom, **kw), _tspec(*geom, backend="torch", **kw)
    base = jl.init_projection(jspec, jax.random.PRNGKey(0))
    ni, nj = hi * 2, 50
    if case == "separated":
        pi, pj = np.full(ni, 0.5, np.float32), np.full(nj, 0.1, np.float32)
        c = np.array([0.5, 1.2, 1.5, 1.8], np.float32)
        c = np.stack([np.roll(c, j) for j in range(5)])        # (Hj, nact)
        pij_c = np.repeat(c, 2, axis=1)[:, :, None] * 0.05     # (Hj, K, 1)
        pij_c = np.broadcast_to(pij_c, (5, 8, 10))
    else:
        pi, pj = np.ones(ni, np.float32), np.ones(nj, np.float32)
        pij_c = np.random.default_rng(0).random((5, 8, 10)) * 0.5 + 0.1
    tr = jl.Traces(pi=jnp.asarray(pi), pj=jnp.asarray(pj),
                   pij=jnp.asarray(pij_c, jnp.float32),
                   t=jnp.asarray(64, jnp.int32))
    return jspec, tspec, dataclasses.replace(base, traces=tr)


@pytest.mark.parametrize("case", ["separated", "tied"])
def test_rewire_compact_masks_match_jax_bitwise(case):
    jspec, tspec, proj = _compact_case(case)
    pj = jl.rewire(proj, jspec)
    pt = tl.rewire(_port_proj(proj), tspec)
    assert not np.array_equal(np.asarray(pj.mask), np.asarray(proj.mask))
    assert_proj_close(pt, pj, f"rewire_compact {case}", pij_tol=1e-7)
    tl.validate_patchy_state(pt, tspec)
    if case == "tied":
        mask = np.asarray(proj.mask)
        for j in range(5):
            silent = np.flatnonzero(mask[:, j] == 0)[:4]
            np.testing.assert_array_equal(np.flatnonzero(pt.mask[:, j]),
                                          silent)


# ----------------------------------------------- conversion + serving ----

def _jtree(st):
    def proj(p):
        return {"traces": {k: np.asarray(getattr(p.traces, k))
                           for k in ("pi", "pj", "pij", "t")},
                "w": np.asarray(p.w), "b": np.asarray(p.b),
                "mask": np.asarray(p.mask),
                "table": None if p.table is None else np.asarray(p.table)}
    return {"projs": [proj(p) for p in st.projs],
            "readout": proj(st.readout), "step": int(st.step)}


def test_jax_compact_state_converts_and_infers_like_jax():
    kw = dict(side=6, depth=2, hidden_hc=5, hidden_mc=6, nact=[9, 3],
              patchy_traces=True, compact=True, struct_every=2)
    jspec = j_deep_synth_spec(backend="pallas", **kw)
    tspec = deep_synth_spec(backend="cuda", **kw)
    st_j = jn.init_deep(jspec, jax.random.PRNGKey(4))
    rng = np.random.default_rng(4)
    for _ in range(3):
        x = rng.random((13, 72), dtype=np.float32)
        labels = rng.integers(0, 5, 13)
        st_j = jn.online_learn_step(st_j, jspec, jnp.asarray(x),
                                    jnp.asarray(labels))
    tree = _jtree(st_j)
    st_t = convert.state_from_numpy(tree, tspec, device="cpu")
    for p, ps in zip(st_t.projs, tspec.projs):
        tl.validate_patchy_state(p, ps)
        assert p.traces.t_host == 3
    x = rng.random((21, 72), dtype=np.float32)
    pj_, qj = jn.infer(st_j, jspec, jnp.asarray(x))
    pt_, qt = tn.infer(st_t, tspec, _t(x))
    np.testing.assert_allclose(pt_.numpy(), np.asarray(pj_), atol=FWD_TOL)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    pk, _ = tn.infer_packed(tn.pack_state(st_t, tspec), tspec, _t(x))
    np.testing.assert_allclose(pk.numpy(), pt_.numpy(), atol=FWD_TOL)
    back = convert.state_to_numpy(st_t)
    for pb, pt in zip(back["projs"], tree["projs"]):
        np.testing.assert_array_equal(pb["table"], pt["table"])
        np.testing.assert_array_equal(pb["w"], pt["w"])
    bad = dict(tree, projs=[dict(tree["projs"][0], table=None)]
               + tree["projs"][1:])
    with pytest.raises(ValueError, match="table"):
        convert.state_from_numpy(bad, tspec, device="cpu")


# ------------------------------------------------ structural plasticity ----

def test_rewire_fires_at_struct_every_multiples_on_the_host_clock(
        monkeypatch):
    """``maybe_rewire`` decides on ``Traces.t_host``: the unsupervised step
    and the online fold rewire exactly when the clock is a multiple of
    ``struct_every``, and the mirror always equals the device clock."""
    spec = deep_synth_spec(side=6, depth=1, hidden_hc=5, hidden_mc=6,
                           nact=[9], patchy_traces=True, compact=True,
                           struct_every=3)
    fired = []
    real = tl.rewire

    def spy(proj, pspec):
        fired.append(proj.traces.t_host)
        return real(proj, pspec)

    monkeypatch.setattr(tl, "rewire", spy)
    st = tn.init_deep(spec, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    for k in range(8):
        x = _t(rng.random((9, 72), dtype=np.float32))
        if k % 2:
            st = tn.online_learn_step(st, spec, x, torch.zeros(9).long())
        else:
            st = tn.train_projection_step(st, spec, x, 0)
        p = st.projs[0]
        assert p.traces.t_host == int(p.traces.t) == k + 1
    assert fired == [3, 6]
    with pytest.raises(ValueError, match="t_host"):
        Traces(pi=p.traces.pi, pj=p.traces.pj, pij=p.traces.pij,
               t=torch.zeros((), dtype=torch.int32, device="meta"))


def test_table_memo_hits_on_the_same_mask_and_misses_after_rewire(
        monkeypatch):
    """Dense-resident patchy steps hand one mask tensor on, so the table is
    built once until a rewire (a new mask) or an in-place edit; the
    compact hot path never builds one."""
    calls = []
    real = tc.build_table

    def spy(mask, nact):
        calls.append(1)
        return real(mask, nact)

    monkeypatch.setattr(tc, "build_table", spy)
    tc._TABLE_CACHE.clear()
    _, tspec = _compact_specs(tb="cuda")
    held = dataclasses.replace(tspec, compact=False)
    proj = tl.init_projection(held, torch.Generator().manual_seed(0))
    x, y = next(_steps(0, 1, 19, 10, 50))
    for _ in range(3):
        proj = tl.learn(proj, held, _t(x), _t(y))
        tl.forward(proj, held, _t(x))
    assert len(calls) == 1
    proj = tl.rewire(proj, held)
    tl.forward(proj, held, _t(x))
    assert len(calls) == 2
    proj.mask.mul_(1.0)  # an in-place edit bumps the version
    tl.forward(proj, held, _t(x))
    assert len(calls) == 3
    calls.clear()
    comp = tl.init_projection(tspec, torch.Generator().manual_seed(0))
    n0 = len(calls)
    for _ in range(3):
        comp = tl.learn(comp, tspec, _t(x), _t(y))
        tl.forward(comp, tspec, _t(x))
    assert len(calls) == n0


def test_validate_patchy_state_refuses_broken_states():
    _, tspec = _compact_specs()
    proj = tl.init_projection(tspec, torch.Generator().manual_seed(0))
    tl.validate_patchy_state(proj, tspec)
    over = proj.mask.clone()
    over[:, 0] = 1.0
    with pytest.raises(ValueError, match="exceeding nact"):
        tl.validate_patchy_state(dataclasses.replace(proj, mask=over), tspec)
    drift = proj.table.clone()
    drift[1] = drift[0]
    with pytest.raises(ValueError, match="disagrees"):
        tl.validate_patchy_state(dataclasses.replace(proj, table=drift),
                                 tspec)
    with pytest.raises(ValueError, match="no index table"):
        tl.validate_patchy_state(dataclasses.replace(proj, table=None),
                                 tspec)
    with pytest.raises(ValueError, match="dense-layout"):
        tops.fused_learn(dataclasses.replace(proj, table=None), tspec,
                         torch.rand(3, 10), torch.rand(3, 50))


@pytest.mark.parametrize("layout", ["paper", "patchy_held", "compact"])
def test_model1_struct_variants_build_and_step_at_full_width(layout):
    """Table-1 Model 1-struct in each plasticity layout: an exactly-nact
    patchy mask, the compact shapes where asked, and two unsupervised
    steps plus the readout pass of a 256-image fit on the CPU."""
    kw = {"paper": {}, "patchy_held": dict(patchy_traces=True),
          "compact": dict(patchy_traces=True, compact=True)}[layout]
    cfg = dataclasses.replace(MODEL1_MNIST_STRUCT, **kw)
    rng = np.random.default_rng(0)
    x = rng.random((256, 784), dtype=np.float32)
    xe = np.stack([x, 1 - x], -1).reshape(256, -1)
    tr = Trainer(cfg, seed=0, device="cpu")
    p = tr.state.projs[0]
    assert np.all(p.mask.numpy().sum(0) == 128)
    want = (32, 256, 128) if cfg.compact else (1568, 4096)
    assert tuple(p.w.shape) == tuple(p.traces.pij.shape) == want
    tr.fit(xe, rng.integers(0, 10, 256), epochs=1, batch=128)
    p = tr.state.projs[0]
    assert p.traces.t_host == int(p.traces.t) == 2
    assert np.isfinite(p.w.numpy()).all()
    tl.validate_patchy_state(p, tr.spec.projs[0])


def _fit_spec(spec, noise_steps=60):
    projs = tuple(dataclasses.replace(p, noise_steps=noise_steps)
                  for p in spec.projs)
    return type(spec)(projs=projs, readout=spec.readout)


def test_compact_struct_fit_matches_jax_accuracy():
    """A small compact struct fit (nact 48 of 144 input HCs, rewire every
    16 steps, a 28-row masked tail) on the port's cuda backend (plain
    versions on the CPU) and on JAX's jnp: test accuracy within 5 points
    (chance is 0.2); the masks stay exactly-nact and valid."""
    ds = jsyn.make_synthetic(1500, 500, 12, 5, seed=0)
    xtr, xte = jsyn.encode_images(ds.x_train), jsyn.encode_images(ds.x_test)
    kw = dict(side=12, depth=1, hidden_hc=16, hidden_mc=32, nact=[48],
              patchy_traces=True, compact=True, struct_every=16)
    jtr = JTrainer(_fit_spec(j_deep_synth_spec(backend="jnp", **kw)), seed=0)
    jtr.fit(xtr, ds.y_train, epochs=4, batch=64)
    acc_j = jtr.evaluate(xte, ds.y_test)
    ttr = Trainer(_fit_spec(deep_synth_spec(backend="cuda", **kw)), seed=0,
                  device="cpu")
    ttr.fit(xtr, ds.y_train, epochs=4, batch=64)
    acc_t = ttr.evaluate(xte, ds.y_test)
    assert acc_t > 0.4, acc_t
    assert abs(acc_t - acc_j) <= 0.05, (acc_t, acc_j)
    tl.validate_patchy_state(ttr.state.projs[0], ttr.spec.projs[0])
    assert ttr.state.projs[0].traces.t_host == 4 * 24


# ----------------------------------------------- reference accuracy ----

def jax_reference_accuracy() -> None:
    """Table-1 Model 1-struct fitted by the JAX package on the jnp backend
    in each plasticity layout ((c) compact-resident, (b) patchy-held,
    (a) as published): 5 epochs and the readout pass on
    ``make_synthetic(16384, 2048, 28, 10, seed=0)``, then test accuracy
    and the number of pre-HCs the rewires moved."""
    from repro.configs.bcpnn_models import MODEL1_MNIST_STRUCT as J_STRUCT
    ds = jsyn.make_synthetic(16384, 2048, 28, 10, seed=0)
    xtr, xte = jsyn.encode_images(ds.x_train), jsyn.encode_images(ds.x_test)
    for variant, kw in (("c", dict(patchy_traces=True, compact=True)),
                        ("b", dict(patchy_traces=True)), ("a", {})):
        cfg = dataclasses.replace(J_STRUCT, backend="jnp", **kw)
        t = time.perf_counter()
        tr = JTrainer(cfg, seed=0)
        mask0 = np.asarray(tr.state.projs[0].mask)
        tr.fit(xtr, ds.y_train, epochs=5, batch=128)
        acc = tr.evaluate(xte, ds.y_test)
        moved = int((np.asarray(tr.state.projs[0].mask) != mask0).sum()) // 2
        print(f"JAX jnp Model 1-struct ({variant}): test accuracy {acc:.4f}, "
              f"{moved} pre-HCs moved by the rewires "
              f"({time.perf_counter() - t:.1f} s)", flush=True)


if __name__ == "__main__" and sys.argv[1:] == ["--reference-accuracy"]:
    jax_reference_accuracy()
