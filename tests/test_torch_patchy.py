"""The patchy path of the port, held against the JAX package on the CPU:
index tables, gathers and scatters, the four patchy kernels' plain
versions against the JAX wrappers (Pallas in interpret mode off-TPU), the
patchy-held plasticity layout through chained learning and a rewire, and
the rewire itself.

Shapes are small and hostile (non-power-of-two, as the JAX suite's
``HOSTILE``).  Tolerances (absolute): forward rates 1e-5; traces 1e-6 on
values ~1e-2 (1e-5 after several steps); weights 1e-4 (the log fold
amplifies relative pij differences near the eps² floor).  Index work and
masks compare bitwise.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bcpnn_layer as jl
from repro.core import compact as jc
from repro.core.hypercolumns import LayerGeom as JGeom
from repro.kernels import ops as jops
from repro.kernels import patchy as jpatchy
from repro_torch.core import bcpnn_layer as tl
from repro_torch.core import compact as tc
from repro_torch.core.hypercolumns import LayerGeom
from repro_torch.core.traces import Traces
from repro_torch.kernels import ops as tops

ROOT = Path(__file__).resolve().parents[1]
FWD_TOL = 1e-5
PIJ_TOL = 1e-6
TRACE_TOL = 1e-5
W_TOL = 1e-4

# (B, Hi, Mi, Hj, Mj, nact)
SHAPES = [(19, 13, 2, 5, 10, 4), (37, 13, 2, 5, 10, 4), (16, 9, 3, 3, 12, 2),
          (33, 64, 2, 4, 16, 17)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers; torch's intra-op pool would take
    every core of the machine for these small shapes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _i32(a):
    return torch.from_numpy(np.array(a, np.int32))


def _mask(rng, hi, hj, nact):
    """A random exactly-nact (Hi, Hj) mask."""
    m = np.zeros((hi, hj), np.float32)
    for j in range(hj):
        m[rng.permutation(hi)[:nact], j] = 1.0
    return m


def _jspec(hi, mi, hj, mj, nact, **kw):
    return jl.ProjSpec(JGeom(hi, mi), JGeom(hj, mj), nact=nact, **kw)


def _tspec(hi, mi, hj, mj, nact, **kw):
    return tl.ProjSpec(LayerGeom(hi, mi), LayerGeom(hj, mj), nact=nact, **kw)


def _port_proj(p):
    """A JAX projection (any layout) as a port projection on the CPU."""
    return tl.Projection(
        traces=Traces(pi=_t(p.traces.pi), pj=_t(p.traces.pj),
                      pij=_t(p.traces.pij),
                      t=torch.tensor(int(p.traces.t), dtype=torch.int32)),
        w=_t(p.w), b=_t(p.b), mask=_t(p.mask),
        table=None if p.table is None else _i32(p.table))


def assert_proj_close(pt, pj, where="", pij_tol=TRACE_TOL):
    for name in ("pi", "pj", "pij"):
        np.testing.assert_allclose(
            getattr(pt.traces, name).numpy(),
            np.asarray(getattr(pj.traces, name)),
            atol=pij_tol if name == "pij" else TRACE_TOL,
            err_msg=f"{name} {where}")
    assert int(pt.traces.t) == int(pj.traces.t) == pt.traces.t_host
    np.testing.assert_allclose(pt.w.numpy(), np.asarray(pj.w), atol=W_TOL,
                               err_msg=f"w {where}")
    np.testing.assert_allclose(pt.b.numpy(), np.asarray(pj.b), atol=W_TOL,
                               err_msg=f"b {where}")
    np.testing.assert_array_equal(pt.mask.numpy(), np.asarray(pj.mask),
                                  err_msg=f"mask {where}")
    if pj.table is None:
        assert pt.table is None
    else:
        np.testing.assert_array_equal(pt.table.numpy(), np.asarray(pj.table))


# ------------------------------------------------------- index work ----

@pytest.mark.parametrize("b,hi,mi,hj,mj,nact", SHAPES)
def test_tables_indices_gathers_scatters_match_jax_bitwise(b, hi, mi, hj, mj,
                                                           nact):
    rng = np.random.default_rng(hi * 100 + nact)
    mask = _mask(rng, hi, hj, nact)
    tab_j = jc.build_table(jnp.asarray(mask), nact)
    tab_t = tc.build_table(_t(mask), nact)
    np.testing.assert_array_equal(tab_t.numpy(), np.asarray(tab_j))
    assert tab_t.dtype == torch.int32 and tab_t.is_contiguous()
    ni, nj = hi * mi, hj * mj
    for k_pad, sentinel in ((0, -1), (3, ni), (5, ni + 7)):
        ui_j = jc.unit_indices(tab_j, mi, k_pad, sentinel)
        ui_t = tc.unit_indices(tab_t, mi, k_pad, sentinel)
        np.testing.assert_array_equal(ui_t.numpy(), np.asarray(ui_j))
        if sentinel < 0:
            continue
        x = rng.random((b, ni), dtype=np.float32)
        dense = rng.random((ni, nj), dtype=np.float32)
        np.testing.assert_array_equal(
            tc.gather_pre(_t(x), ui_t).numpy(),
            np.asarray(jc.gather_pre(jnp.asarray(x), ui_j)))
        g_t = tc.gather_dense(_t(dense), ui_t, hj, mj)
        np.testing.assert_array_equal(
            g_t.numpy(),
            np.asarray(jc.gather_dense(jnp.asarray(dense), ui_j, hj, mj)))
        base = rng.random((ni, hj, mj), dtype=np.float32)
        vals = rng.random(tuple(g_t.shape), dtype=np.float32)
        np.testing.assert_array_equal(
            tc.scatter_dense(_t(base), ui_t, _t(vals)).numpy(),
            np.asarray(jc.scatter_dense(jnp.asarray(base), ui_j,
                                        jnp.asarray(vals))))
    pij_c = rng.random((hj, nact * mi, mj), dtype=np.float32) * 0.01
    pi = rng.random(ni, dtype=np.float32) * 0.5
    pj = rng.random(nj, dtype=np.float32) * 0.5
    np.testing.assert_array_equal(
        tc.densify_pij(_t(pij_c), _t(pi), _t(pj), tab_t, mi).numpy(),
        np.asarray(jc.densify_pij(jnp.asarray(pij_c), jnp.asarray(pi),
                                  jnp.asarray(pj), tab_j, mi)))
    assert tc.table_matches_mask(_t(mask), tab_t, nact)
    bad = tab_t.clone()
    bad[0, 0] = bad[0, 1]  # a duplicate entry
    assert not tc.table_matches_mask(_t(mask), bad, nact)


def test_build_table_off_budget_masks_match_jax():
    """Columns with more or fewer live pre-HCs than nact: the stable sort
    keeps ``lax.top_k``'s choice (ties toward the lower index)."""
    mask = np.zeros((7, 3), np.float32)
    mask[[1, 2, 4, 6], 0] = 1.0   # over budget
    mask[[5], 1] = 1.0            # under budget
    mask[[0, 3, 6], 2] = 1.0      # exactly nact
    np.testing.assert_array_equal(
        tc.build_table(_t(mask), 3).numpy(),
        np.asarray(jc.build_table(jnp.asarray(mask), 3)))


# --------------------------------------------------- kernels (plain) ----

def _kernel_inputs(seed, b, hi, mi, hj, mj, nact):
    rng = np.random.default_rng(seed)
    ni, nj = hi * mi, hj * mj
    table = np.asarray(jc.build_table(jnp.asarray(_mask(rng, hi, hj, nact)),
                                      nact))
    return rng, ni, nj, table


@pytest.mark.parametrize("b,hi,mi,hj,mj,nact", SHAPES)
def test_patchy_and_compact_forward_match_jax(b, hi, mi, hj, mj, nact):
    rng, ni, nj, table = _kernel_inputs(1, b, hi, mi, hj, mj, nact)
    x = rng.random((b, ni), dtype=np.float32)
    w = (rng.standard_normal((ni, nj)) * 0.3).astype(np.float32)
    w_c = (rng.standard_normal((hj, nact * mi, mj)) * 0.3).astype(np.float32)
    bias = rng.standard_normal(nj).astype(np.float32)
    interp = jops._interpret()
    want = jpatchy.patchy_forward(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(bias), jnp.asarray(table), mi,
                                  hj, mj, 1.5, interpret=interp)
    got = tops.patchy_forward(_t(x), _t(w), _t(bias), _i32(table), mi, hj,
                              mj, 1.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL)
    want = jpatchy.compact_forward(jnp.asarray(x), jnp.asarray(w_c),
                                   jnp.asarray(bias), jnp.asarray(table), mi,
                                   1.5, interpret=interp)
    got = tops.compact_forward(_t(x), _t(w_c), _t(bias), _i32(table), mi,
                               1.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL)


@pytest.mark.parametrize("b,hi,mi,hj,mj,nact", SHAPES)
@pytest.mark.parametrize("n_valid", [None, 7])
def test_patchy_and_compact_update_match_jax(b, hi, mi, hj, mj, nact,
                                             n_valid):
    """Whole batches; and zero-padded rows divided by ``count``, against
    the JAX kernel on the genuine rows alone (its divisor is static)."""
    rng, ni, nj, table = _kernel_inputs(2, b, hi, mi, hj, mj, nact)
    pij = (rng.random((ni, nj)) * 0.01 + 1e-5).astype(np.float32)
    pij_c = (rng.random((hj, nact * mi, mj)) * 0.01 + 1e-5).astype(np.float32)
    lpi = np.log(rng.random(ni) * 0.5 + 1e-4).astype(np.float32)
    lpj = np.log(rng.random(nj) * 0.5 + 1e-4).astype(np.float32)
    x = rng.random((b, ni), dtype=np.float32)
    y = rng.random((b, nj), dtype=np.float32)
    alpha = np.float32(0.02)
    n = b if n_valid is None else n_valid
    count = None if n_valid is None else torch.tensor(float(n_valid))
    xt, yt = x.copy(), y.copy()
    xt[n:], yt[n:] = 0.0, 0.0
    interp = jops._interpret()
    args_j = (jnp.asarray(lpi), jnp.asarray(lpj), jnp.asarray(x[:n]),
              jnp.asarray(y[:n]), jnp.asarray(table), jnp.asarray(alpha))
    args_t = (_t(lpi), _t(lpj), _t(xt), _t(yt), _i32(table),
              torch.tensor(alpha))
    jp, jw = jpatchy.patchy_update(jnp.asarray(pij), *args_j, mi, hj, mj,
                                   interpret=interp)
    tp, tw = tops.patchy_update(_t(pij), *args_t, mi, hj, mj, count=count)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=PIJ_TOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=W_TOL)
    jp, jw = jpatchy.compact_update(jnp.asarray(pij_c), *args_j, mi,
                                    interpret=interp)
    tp, tw = tops.compact_update(_t(pij_c), *args_t, mi, count=count)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=PIJ_TOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=W_TOL)


def test_cpu_tensors_take_plain_patchy_versions_without_counting():
    before = tops.launch_counts()
    assert set(before) == {"hc_softmax", "bcpnn_fwd", "bcpnn_update",
                           "patchy_forward", "compact_forward",
                           "patchy_update", "compact_update", "quant_fwd",
                           "quant_compact_forward", "quant_patchy_forward"}
    table = torch.tensor([[0, 2], [1, 2]], dtype=torch.int32)
    x = torch.rand(3, 6)
    tops.patchy_forward(x, torch.randn(6, 8), torch.zeros(8), table, 2, 2, 4)
    tops.compact_forward(x, torch.randn(2, 4, 4), torch.zeros(8), table, 2)
    tops.patchy_update(torch.full((6, 8), 0.05), torch.zeros(6),
                       torch.zeros(8), x, torch.rand(3, 8), table, 0.1, 2, 2,
                       4)
    tops.compact_update(torch.full((2, 4, 4), 0.05), torch.zeros(6),
                        torch.zeros(8), x, torch.rand(3, 8), table, 0.1, 2)
    assert tops.launch_counts() == before


def test_patchy_wrappers_refuse_other_devices():
    """Neither CPU nor CUDA: the wrappers raise instead of falling back."""
    meta = dict(device="meta")
    table = torch.empty(2, 2, dtype=torch.int32, **meta)
    x = torch.empty(3, 6, **meta)
    with pytest.raises(ValueError):
        tops.patchy_forward(x, torch.empty(6, 8, **meta),
                            torch.empty(8, **meta), table, 2, 2, 4)
    with pytest.raises(ValueError):
        tops.compact_update(torch.empty(2, 4, 4, **meta),
                            torch.empty(6, **meta), torch.empty(8, **meta),
                            x, torch.empty(3, 8, **meta), table, 0.1, 2)


# -------------------------------------------------- patchy-held layer ----

def _steps(seed, n, b, ni, nj):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield (rng.random((b, ni), dtype=np.float32),
               rng.random((b, nj), dtype=np.float32))


@pytest.mark.parametrize("jb,tb", [("pallas", "cuda"), ("jnp", "torch")])
@pytest.mark.parametrize("patchy_traces", [False, True])
def test_patchy_learn_chain_with_rewire_matches_jax(jb, tb, patchy_traces):
    """8 chained learn steps with a rewire after step 4, in the paper's
    default layout (dense update under the patchy mask) and the
    patchy-held one; the forward after every step through the patchy
    kernel's plain version."""
    jspec = _jspec(13, 2, 5, 10, 4, alpha=0.2, backend=jb,
                   patchy_traces=patchy_traces)
    tspec = _tspec(13, 2, 5, 10, 4, alpha=0.2, backend=tb,
                   patchy_traces=patchy_traces)
    pj = jl.init_projection(jspec, jax.random.PRNGKey(0))
    pt = _port_proj(pj)
    rng = np.random.default_rng(9)
    for i, (x, y) in enumerate(_steps(3, 8, 19, 26, 50)):
        pj = jl.learn(pj, jspec, jnp.asarray(x), jnp.asarray(y))
        pt = tl.learn(pt, tspec, _t(x), _t(y))
        assert_proj_close(pt, pj, f"step {i}")
        if i == 3:
            pj, pt = jl.rewire(pj, jspec), tl.rewire(pt, tspec)
            assert_proj_close(pt, pj, "after rewire")
            assert np.all(pt.mask.numpy().sum(0) == 4)
        xf = rng.random((7, 26), dtype=np.float32)
        np.testing.assert_allclose(
            tl.forward(pt, tspec, _t(xf)).numpy(),
            np.asarray(jl.forward(pj, jspec, jnp.asarray(xf))), atol=FWD_TOL)


def _separated_traces(rng, hi, mi, hj, mj):
    """Traces whose per-column MI values are far apart (no near-ties)."""
    ni, nj = hi * mi, hj * mj
    pi = np.full(ni, 1.0 / mi, np.float32)
    pj = np.full(nj, 1.0 / mj, np.float32)
    strength = rng.permutation(hi * hj).reshape(hi, hj).astype(np.float32)
    pert = rng.standard_normal((hi, mi, hj, mj)).astype(np.float32)
    pij = (np.outer(pi, pj).reshape(hi, mi, hj, mj)
           * np.exp(0.02 * (1 + strength[:, None, :, None]) * pert))
    return pi, pj, pij.reshape(ni, nj).astype(np.float32)


def test_rewire_masks_match_jax_on_separated_and_tied_mi():
    hi, mi, hj, mj, nact = 13, 2, 5, 10, 4
    jspec = _jspec(hi, mi, hj, mj, nact, backend="jnp")
    tspec = _tspec(hi, mi, hj, mj, nact, backend="torch")
    base = jl.init_projection(jspec, jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)
    pi, pj, pij = _separated_traces(rng, hi, mi, hj, mj)
    # tied: every HC pair at independence, MI exactly 0 everywhere
    tied = np.outer(pi, pj).astype(np.float32)
    for joint in (pij, tied):
        tr = type(base.traces)(pi=jnp.asarray(pi), pj=jnp.asarray(pj),
                               pij=jnp.asarray(joint),
                               t=jnp.asarray(5, jnp.int32))
        pj_ = jl.rewire(dataclasses.replace(base, traces=tr), jspec)
        pt_ = tl.rewire(_port_proj(dataclasses.replace(base, traces=tr)),
                        tspec)
        np.testing.assert_array_equal(pt_.mask.numpy(), np.asarray(pj_.mask))
        np.testing.assert_allclose(pt_.w.numpy(), np.asarray(pj_.w),
                                   atol=W_TOL)
    # all tied: the first nact pre-HCs win in every column
    np.testing.assert_array_equal(
        pt_.mask.numpy(),
        np.repeat((np.arange(hi) < nact)[:, None], hj, 1).astype(np.float32))


def test_port_imports_without_jax_or_the_jax_package():
    """Every module of the port imports with ``jax`` and ``repro`` made
    unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert len(names) > 15, names\n"
        "print(len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
