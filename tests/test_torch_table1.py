"""Table-1 Models 2 and 3 and their -struct presets in the port, held
against the JAX package on the CPU at the presets' real layer shapes.

Model 2 (pneumonia): 784x2 -> 32x256 -> 2; Model 3 (breast): 4096x2 ->
32x128 -> 2; the -struct presets keep nact 128 and rewire every 16 and
every 8 steps.  The fit's batch is 64 and the example's data end in padded
tails of 36 (4708 = 73*64 + 36) and 34 (546 = 8*64 + 34) rows.  Single
steps from one state only: Model 3's traces are 134 MB a copy.

The port runs its ``cuda`` backend (the kernels' plain versions on CPU
tensors), JAX its ``jnp`` backend; states cross as numpy trees
(``convert.state_from_numpy``) and the unsupervised step's noise is drawn
by JAX and injected.  Tolerances (absolute, DESIGN.md §3): 1e-5 on
forward rates and traces, 1e-4 on weights and biases; masks and tables
compared exactly.

    python tests/test_torch_table1.py --reference-accuracy

fits the four presets with the JAX package on the CPU, with the data and
protocol of ``chip_smoke.py``'s phase 14, and prints the test accuracies
that phase holds the port's card fits to.
"""
import dataclasses
import hashlib
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.bcpnn_models import BCPNN_MODELS as J_MODELS
from repro.core import bcpnn_layer as jl
from repro.core import network as jn
from repro.core.trainer import Trainer as JTrainer
from repro.data import synthetic as jsyn
from repro_torch import convert
from repro_torch.configs.bcpnn_models import BCPNN_MODELS
from repro_torch.core import bcpnn_layer as tl
from repro_torch.core import network as tn
from repro_torch.data import synthetic as tsyn

ROOT = Path(__file__).resolve().parents[1]
FWD_TOL = 1e-5
TRACE_TOL = 1e-5
W_TOL = 1e-4
BATCH = 64
# name -> (train rows, test rows, side) of load_or_synthesize's table
PRESET_DATA = {"pneumonia": (4708, 624, 28), "breast": (546, 156, 64)}
# the padded tail of each training set at the fit's batch of 64
TAIL = {"pneumonia": 4708 % BATCH, "breast": 546 % BATCH}
UNPORTED = ("model2-pneumonia", "model3-breast", "model2-pneumonia-struct",
            "model3-breast-struct")
LAYOUTS = {"a": {}, "b": dict(patchy_traces=True),
           "c": dict(patchy_traces=True, compact=True)}
CASES = [("model2-pneumonia", "a"), ("model3-breast", "a")] + [
    (name, layout) for name in UNPORTED[2:] for layout in LAYOUTS]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers: one intra-op thread, so these
    full-width products do not slow the timing-sensitive tests beside
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def eval_batch(dataset: str) -> int:
    """The JAX medical example's evaluation batch."""
    return 52 if dataset == "breast" else 64


def _specs(name, layout="a"):
    """(JAX spec on jnp, port spec on cuda, dataset) of a preset in one
    plasticity layout."""
    cfg_j, dataset, _ = J_MODELS[name]
    cfg_t = BCPNN_MODELS[name][0]
    kw = LAYOUTS[layout]
    return (dataclasses.replace(cfg_j, backend="jnp", **kw).network_spec(),
            dataclasses.replace(cfg_t, backend="cuda", **kw).network_spec(),
            dataset)


def _data(dataset, seed=0):
    """A batch of 64 encoded rows of the preset's surrogate, with labels,
    and the same batch zero-padded past the dataset's tail with its
    validity mask."""
    side = PRESET_DATA[dataset][2]
    ds = jsyn.make_synthetic(BATCH, 8, side, 2, seed=seed)
    x = jsyn.encode_images(ds.x_train).astype(np.float32)
    y = ds.y_train.astype(np.int32)
    valid = (np.arange(BATCH) < TAIL[dataset]).astype(np.float32)
    return x, y, x * valid[:, None], y * valid.astype(np.int32), valid


def _jtree(st):
    def proj(p):
        return {"traces": {k: np.asarray(getattr(p.traces, k))
                           for k in ("pi", "pj", "pij", "t")},
                "w": np.asarray(p.w), "b": np.asarray(p.b),
                "mask": np.asarray(p.mask),
                "table": None if p.table is None else np.asarray(p.table)}
    return {"projs": [proj(p) for p in st.projs],
            "readout": proj(st.readout), "step": int(st.step)}


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _assert_close(got, want, tol, what):
    """Max |got - want| <= tol (in torch: numpy's assert_allclose takes
    seconds on the 33M-entry traces)."""
    err = (got - torch.from_numpy(np.array(want))).abs().max().item()
    assert err <= tol, f"{what}: max abs err {err:.3e} > {tol}"


def _assert_proj_close(pt, pj, where):
    for k in ("pi", "pj", "pij"):
        _assert_close(getattr(pt.traces, k), getattr(pj.traces, k),
                      TRACE_TOL, f"{k} {where}")
    assert int(pt.traces.t) == int(pj.traces.t) == pt.traces.t_host, where
    _assert_close(pt.w, pj.w, W_TOL, f"w {where}")
    _assert_close(pt.b, pj.b, W_TOL, f"b {where}")
    assert torch.equal(pt.mask, torch.from_numpy(np.array(pj.mask))), \
        f"mask {where}"
    assert (pt.table is None) == (pj.table is None), where
    if pt.table is not None:
        assert torch.equal(pt.table, torch.from_numpy(np.array(pj.table))), \
            f"table {where}"


def _assert_state_close(st_t, st_j, where):
    for l, (pt, pj) in enumerate(zip(st_t.projs, st_j.projs)):
        _assert_proj_close(pt, pj, f"projs[{l}] {where}")
    _assert_proj_close(st_t.readout, st_j.readout, f"readout {where}")
    assert int(st_t.step) == int(st_j.step)


def _states(jspec, tspec, seed):
    st_j = jn.init_deep(jspec, jax.random.PRNGKey(seed))
    return st_j, convert.state_from_numpy(_jtree(st_j), tspec, device="cpu")


# ------------------------------------------------------------ presets ----

def test_presets_equal_jax_field_for_field():
    """All six Table-1 presets: every config field (the backend default
    aside: the port's is ``cuda``), the dataset and the paper's epochs."""
    assert set(BCPNN_MODELS) == set(J_MODELS)
    for name, (cfg_j, dataset, epochs) in J_MODELS.items():
        cfg_t, dataset_t, epochs_t = BCPNN_MODELS[name]
        got = dataclasses.asdict(cfg_t)
        want = dataclasses.asdict(cfg_j)
        assert got.pop("backend") == "cuda" and want.pop("backend") == "jnp"
        assert got == want, name
        assert (dataset_t, epochs_t) == (dataset, epochs), name


# ------------------------------------------------------------- steps ----

@pytest.mark.parametrize("name,layout", CASES)
def test_unsupervised_step_and_rewire_match_jax(name, layout):
    """One noisy unsupervised step at batch 64 from a JAX-initialized state
    (the hidden rates it reads within 1e-5, every state array within
    DESIGN.md's tolerances, masks and tables equal); for the -struct
    presets then one rewire of the stepped state, whose masks and tables
    must equal JAX's (in (a) and (b) it moves pre-HCs; a compact rewire
    from one step's traces moves none, in JAX as here)."""
    jspec, tspec, dataset = _specs(name, layout)
    x, _, _, _, _ = _data(dataset)
    st_j, st_t = _states(jspec, tspec, seed=0)
    h_j = jn.stack_rates(st_j, jspec, jnp.asarray(x), depth=0)
    rates_j = jl.forward(st_j.projs[0], jspec.projs[0], jnp.asarray(x))
    rates_t = tl.forward(st_t.projs[0], tspec.projs[0], _t(x))
    _assert_close(rates_t, rates_j, FWD_TOL, f"{name} hidden rates")
    _, sub = jax.random.split(st_j.key)
    noise = jax.random.normal(sub, (BATCH, jspec.projs[0].post.N),
                              jnp.float32)
    st_j = jn.train_projection_step(st_j, jspec, h_j, 0)
    st_t = tn.train_projection_step(st_t, tspec, _t(x), 0, noise=_t(noise))
    _assert_state_close(st_t, st_j, f"{name} ({layout}) step")
    if tspec.projs[0].struct_every:
        pj = jl.rewire(st_j.projs[0], jspec.projs[0])
        pt = tl.rewire(st_t.projs[0], tspec.projs[0])
        if layout != "c":  # a compact rewire may move none (as in JAX)
            assert not np.array_equal(np.asarray(pj.mask),
                                      np.asarray(st_j.projs[0].mask))
        _assert_proj_close(pt, pj, f"{name} ({layout}) rewire")
        tl.validate_patchy_state(pt, tspec.projs[0])


@pytest.mark.parametrize("name", UNPORTED)
def test_readout_and_masked_eval_steps_match_jax(name):
    """The readout step on a whole batch of 64, the masked readout step on
    the dataset's padded tail (36 rows for pneumonia, 34 for breast) and
    the masked eval step over that tail: probabilities within 1e-5 and the
    same predictions, pad rows inert."""
    jspec, tspec, dataset = _specs(name)
    x, y, xp, yp, valid = _data(dataset, seed=1)
    st_j, st_t = _states(jspec, tspec, seed=1)
    st_j = jn.supervised_readout_step(st_j, jspec, jnp.asarray(x),
                                      jnp.asarray(y))
    st_t = tn.supervised_readout_step(st_t, tspec, _t(x),
                                      torch.from_numpy(y))
    _assert_state_close(st_t, st_j, f"{name} readout step")
    st_j = jn.supervised_readout_step(st_j, jspec, jnp.asarray(xp),
                                      jnp.asarray(yp),
                                      valid=jnp.asarray(valid))
    st_t = tn.supervised_readout_step(st_t, tspec, _t(xp),
                                      torch.from_numpy(yp), valid=_t(valid))
    _assert_state_close(st_t, st_j, f"{name} masked readout step")
    probs_j, pred_j = jn.infer(st_j, jspec, jnp.asarray(xp),
                               valid=jnp.asarray(valid))
    probs_t, pred_t = tn.infer(st_t, tspec, _t(xp), valid=_t(valid))
    np.testing.assert_allclose(probs_t.numpy(), np.asarray(probs_j),
                               atol=FWD_TOL)
    np.testing.assert_array_equal(pred_t.numpy(), np.asarray(pred_j))
    tail = TAIL[dataset]
    assert (probs_t[tail:] == 0).all() and (pred_t[tail:] == -1).all()


# --------------------------------------------------------- surrogates ----

_DIGEST = """
import hashlib, sys
from repro_torch.data.synthetic import load_or_synthesize
h = hashlib.sha256()
for name in ("pneumonia", "breast"):
    ds = load_or_synthesize(name, path_hint=sys.argv[1])
    for a in (ds.x_train, ds.y_train, ds.x_test, ds.y_test):
        h.update(a.tobytes())
print(h.hexdigest())
"""


def test_surrogates_are_the_same_in_every_process(tmp_path):
    """``load_or_synthesize`` seeds from the name by CRC-32, so two
    processes with different ``PYTHONHASHSEED`` make the same arrays (the
    reference's ``hash(name)`` would not)."""
    digests = []
    for hash_seed in ("1", "2"):
        proc = subprocess.run(
            [sys.executable, "-c", _DIGEST, str(tmp_path)], cwd=ROOT,
            env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
                 "PYTHONHASHSEED": hash_seed, "OMP_NUM_THREADS": "1"},
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        digests.append(proc.stdout.strip())
    assert digests[0] == digests[1]
    h = hashlib.sha256()
    for name in ("pneumonia", "breast"):
        n_train, n_test, side = PRESET_DATA[name]
        ds = jsyn.make_synthetic(n_train, n_test, side, 2,
                                 seed=tsyn.surrogate_seed(name))
        for a in (ds.x_train, ds.y_train, ds.x_test, ds.y_test):
            h.update(a.tobytes())
    assert digests[0] == h.hexdigest()


@pytest.mark.parametrize("name", ["mnist", "pneumonia", "breast"])
def test_surrogate_shapes_equal_jax_table(name, tmp_path):
    """The port's surrogates have the reference's shapes, dtypes and
    classes (its table of paper sizes), and ``make_synthetic`` is the
    reference's bit for bit."""
    got = tsyn.load_or_synthesize(name, path_hint=str(tmp_path))
    want = jsyn.load_or_synthesize(name, path_hint=str(tmp_path))
    for a, b in zip((got.x_train, got.y_train, got.x_test, got.y_test),
                    (want.x_train, want.y_train, want.x_test, want.y_test)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert set(np.unique(got.y_train)) == set(np.unique(want.y_train))
    a = tsyn.make_synthetic(40, 8, 12, 3, seed=5)
    b = jsyn.make_synthetic(40, 8, 12, 3, seed=5)
    np.testing.assert_array_equal(a.x_train, b.x_train)
    np.testing.assert_array_equal(a.y_test, b.y_test)


# ----------------------------------------------- reference accuracy ----

def jax_reference_accuracy() -> None:
    """The four presets fitted by the JAX package on the jnp backend, as
    published (layout (a)): the paper's epochs at batch 64 on
    ``make_synthetic(n_train, n_test, side, 2, seed=0)``, then test
    accuracy at the example's evaluation batch."""
    for name in UNPORTED:
        cfg, dataset, epochs = J_MODELS[name]
        n_train, n_test, side = PRESET_DATA[dataset]
        ds = jsyn.make_synthetic(n_train, n_test, side, 2, seed=0)
        xtr = jsyn.encode_images(ds.x_train)
        xte = jsyn.encode_images(ds.x_test)
        t = time.perf_counter()
        tr = JTrainer(dataclasses.replace(cfg, backend="jnp"), seed=0)
        tr.fit(xtr, ds.y_train, epochs=epochs, batch=64)
        acc_train = tr.evaluate(xtr, ds.y_train, batch=eval_batch(dataset))
        acc = tr.evaluate(xte, ds.y_test, batch=eval_batch(dataset))
        print(f"JAX jnp {name}: {epochs} epochs, train accuracy "
              f"{acc_train:.4f}, test accuracy {acc:.4f} "
              f"({time.perf_counter() - t:.1f} s)", flush=True)


if __name__ == "__main__" and sys.argv[1:] == ["--reference-accuracy"]:
    jax_reference_accuracy()
