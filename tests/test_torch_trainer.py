"""The port's epoch programs and depth-1 helpers, held against the JAX
package on the CPU at small sizes (side 12, 4x8 hidden HCs, depth 1 and 2;
dense, and the three patchy layouts with a binding ``nact``).

On the CPU an epoch program runs its donated step eagerly, batch by batch,
as the card replays the captured one; the host's share of a step (the
clock mirror, the rewire) is the same code on both.  The JAX exploration
noise is replayed into the port's epoch through ``noise=``, drawn with the
JAX epoch's own key-split chain.  JAX runs ``"jnp"``, the reference whose
programs compile quickly; the port runs its ``"cuda"`` backend (the kernel
wrappers' plain versions, writing in place) and its ``"torch"`` one.

Tolerances (absolute, DESIGN.md §3): 1e-5 for forward rates and traces,
1e-4 for weights and biases after several learn steps, and for the traces
of a projection whose input comes through learned weights (an upper
layer); masks, tables and clocks exactly.  A donated step is held to the
functional one bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.bcpnn_models import deep_synth_spec as j_deep_synth_spec
from repro.core import network as jn
from repro.core import trainer as jt
from repro_torch import convert, obs
from repro_torch.configs.bcpnn_models import deep_synth_spec
from repro_torch.core import (BCPNNConfig, Trainer, eval_batches,
                              evaluate_padded, graphs, hidden_rates,
                              init_deep, init_network, supervised_epoch,
                              supervised_step, unsupervised_epoch,
                              unsupervised_layer_epoch, unsupervised_step)
from repro_torch.core import network as tn
from repro_torch.core import trainer as tt
from repro_torch.kernels import ops

FWD_TOL = 1e-5
TRACE_TOL = 1e-5
W_TOL = 1e-4
B, NB, STRUCT_EVERY = 16, 5, 3  # a rewire at clock 3 inside each epoch

# layout -> deep_synth_spec fields, per depth (nact binds on every layer)
LAYOUTS = {
    "dense": lambda depth: {},
    "a": lambda depth: dict(nact=[40, 3][:depth]),
    "b": lambda depth: dict(nact=[40, 3][:depth], patchy_traces=True),
    "c": lambda depth: dict(nact=[40, 3][:depth], patchy_traces=True,
                            compact=True),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _specs(layout, depth, tb="cuda", struct_every=STRUCT_EVERY):
    kw = dict(side=12, depth=depth, hidden_hc=4, hidden_mc=8,
              struct_every=struct_every, **LAYOUTS[layout](depth))
    return (j_deep_synth_spec(backend="jnp", **kw),
            deep_synth_spec(backend=tb, **kw))


def _jtree(st):
    def proj(p):
        return {"traces": {k: np.asarray(getattr(p.traces, k))
                           for k in ("pi", "pj", "pij", "t")},
                "w": np.asarray(p.w), "b": np.asarray(p.b),
                "mask": np.asarray(p.mask),
                "table": None if p.table is None else np.asarray(p.table)}
    return {"projs": [proj(p) for p in st.projs],
            "readout": proj(st.readout), "step": int(st.step)}


def _states(layout, depth, tb="cuda", seed=0, **kw):
    jspec, tspec = _specs(layout, depth, tb, **kw)
    st_j = jn.init_deep(jspec, jax.random.PRNGKey(seed))
    st_t = convert.state_from_numpy(_jtree(st_j), tspec, device="cpu")
    return jspec, tspec, st_j, st_t


def _batches(spec, nb=NB, b=B, seed=5, n_valid=None):
    """(nb, B, N_input) encoded rates, (nb, B) labels, (nb, B) validity:
    the last batch holds ``n_valid`` genuine rows."""
    rng = np.random.default_rng(seed)
    x = rng.random((nb, b, spec.input_geom.H), dtype=np.float32)
    xs = np.stack([x, 1 - x], -1).reshape(nb, b, -1)
    ys = rng.integers(0, spec.n_classes, (nb, b)).astype(np.int32)
    valid = np.ones((nb, b), np.float32)
    if n_valid is not None:
        xs[-1, n_valid:] = 0.0
        ys[-1, n_valid:] = 0
        valid[-1, n_valid:] = 0.0
    return xs, ys, valid


def _jax_noise(key, nb, b, nj):
    """The draws of a JAX epoch of ``nb`` unsupervised steps from ``key``:
    each step splits the state's key and draws from the second half."""
    out = []
    for _ in range(nb):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, (b, nj), jnp.float32)))
    return _t(np.stack(out))


def _assert_proj_close(pt, pj, where, trace_tol=TRACE_TOL):
    for k in ("pi", "pj", "pij"):
        np.testing.assert_allclose(getattr(pt.traces, k).numpy(),
                                   np.asarray(getattr(pj.traces, k)),
                                   atol=trace_tol, err_msg=f"{k} {where}")
    for k in ("w", "b"):
        np.testing.assert_allclose(getattr(pt, k).numpy(),
                                   np.asarray(getattr(pj, k)), atol=W_TOL,
                                   err_msg=f"{k} {where}")
    np.testing.assert_array_equal(pt.mask.numpy(), np.asarray(pj.mask),
                                  err_msg=f"mask {where}")
    if pj.table is not None:
        np.testing.assert_array_equal(pt.table.numpy(), np.asarray(pj.table),
                                      err_msg=f"table {where}")
    assert int(pt.traces.t) == int(pj.traces.t) == pt.traces.t_host, where


def _assert_state_close(st_t, st_j, where=""):
    for l, (pt, pj) in enumerate(zip(st_t.projs, st_j.projs)):
        _assert_proj_close(pt, pj, f"projs[{l}] {where}",
                           TRACE_TOL if l == 0 else W_TOL)
    _assert_proj_close(st_t.readout, st_j.readout, f"readout {where}",
                       W_TOL)
    assert int(st_t.step) == int(st_j.step), where


def _assert_states_equal(a, b, where=""):
    """Bit for bit, every tensor and every clock mirror."""
    for x, y in zip(graphs.state_tensors(a), graphs.state_tensors(b)):
        assert x.shape == y.shape and torch.equal(x, y), where
    for p, q in zip(a.projs + (a.readout,), b.projs + (b.readout,)):
        assert p.traces.t_host == q.traces.t_host, where


def _snapshot(state):
    return [t.clone() for t in graphs.state_tensors(state)]


# ------------------------------------------------------ epoch programs --

@pytest.mark.parametrize("tb", ["cuda", "torch"])
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_unsupervised_layer_epoch_matches_jax(layout, depth, tb):
    """Each layer's epoch in turn, five steps with a rewire at clock 3, the
    JAX noise replayed: the states after every epoch within the
    tolerances, masks and tables exactly."""
    jspec, tspec, st_j, st_t = _states(layout, depth, tb)
    xs, _, _ = _batches(tspec)
    for layer in range(depth):
        noise = _jax_noise(st_j.key, NB, B, jspec.projs[layer].post.N)
        mask0 = st_t.projs[layer].mask.clone()
        st_j = jt.unsupervised_layer_epoch(st_j, jspec, jnp.asarray(xs),
                                           layer)
        st_t = unsupervised_layer_epoch(st_t, tspec, _t(xs), layer,
                                        noise=noise)
        _assert_state_close(st_t, st_j, f"after layer {layer}'s epoch")
        if layout in ("a", "b"):  # the rewire ran and moved pre-HCs
            assert not torch.equal(st_t.projs[layer].mask, mask0)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_supervised_epoch_and_eval_batches_match_jax(layout):
    """A readout epoch with a padded tail (JAX masks every batch of such
    an epoch, the port only the tail: fp32 rounding apart), then the
    accuracy of eval_batches with and without a validity mask."""
    jspec, tspec, st_j, st_t = _states(layout, 2, seed=1)
    xs, ys, valid = _batches(tspec, n_valid=9)
    args_j = (jnp.asarray(xs), jnp.asarray(ys))
    args_t = (_t(xs), torch.from_numpy(ys))
    st_j = jt._supervised_epoch_masked(st_j, jspec, *args_j,
                                       jnp.asarray(valid))
    st_t = tt._supervised_epoch_masked(st_t, tspec, *args_t, _t(valid))
    _assert_state_close(st_t, st_j, "after the masked readout epoch")
    st_j = jt.supervised_epoch(st_j, jspec, *args_j)
    st_t = supervised_epoch(st_t, tspec, *args_t)
    _assert_state_close(st_t, st_j, "after the readout epoch")
    for v in (None, valid):
        acc_j = float(jt.eval_batches(st_j, jspec, *args_j,
                                      None if v is None else jnp.asarray(v)))
        acc_t = eval_batches(st_t, tspec, *args_t,
                             None if v is None else _t(v))
        assert acc_t.dim() == 0 and acc_t.device.type == "cpu"
        assert abs(float(acc_t) - acc_j) <= 1e-6, (float(acc_t), acc_j)
    xe = xs.reshape(NB * B, -1)[:NB * B - B + 9]
    ye = ys.reshape(-1)[:len(xe)]
    acc = evaluate_padded(st_t, tspec, xe, ye, batch=B)
    assert abs(acc - jt.evaluate_padded(st_j, jspec, xe, ye, batch=B)) \
        <= 1e-6


def test_unsupervised_epoch_is_the_layer_0_epoch():
    jspec, tspec, st_j, st_t = _states("c", 1)
    xs, _, _ = _batches(tspec)
    noise = _jax_noise(st_j.key, NB, B, jspec.projs[0].post.N)
    a = unsupervised_epoch(convert.state_from_numpy(_jtree(st_j), tspec,
                                                    device="cpu"),
                           tspec, _t(xs), noise=noise)
    b = unsupervised_layer_epoch(st_t, tspec, _t(xs), 0, noise=noise)
    _assert_states_equal(a, b)
    assert a.projs[0].traces.t_host == NB


# ----------------------------------------------------- depth-1 helpers --

def _cfgs(**kw):
    kw = dict(input_hc=36, hidden_hc=4, hidden_mc=8, n_classes=5, nact_hi=12,
              alpha=0.05, noise_steps=50, **kw)
    from repro.core.network import BCPNNConfig as JConfig
    return JConfig(backend="jnp", **kw), BCPNNConfig(backend="cuda", **kw)


def test_init_network_matches_the_jax_tree():
    """``init_network`` takes a config or a spec and gives ``init_deep``'s
    state; its tree has the JAX tree's leaves, shapes and dtypes, and the
    leaves that draw nothing (marginals, clocks, the dense readout's
    mask) equal JAX's."""
    jcfg, tcfg = _cfgs(patchy_traces=True, compact=True)
    st = init_network(tcfg, seed=3, device="cpu")
    _assert_states_equal(st, init_deep(tcfg.network_spec(), 3, "cpu"))
    _assert_states_equal(st, init_network(tcfg.network_spec(), 3, "cpu"))
    tree_t = convert.state_to_numpy(st)
    tree_j = _jtree(jn.init_network(jcfg, jax.random.PRNGKey(3)))
    assert tree_t["step"] == tree_j["step"] == 0
    for pt, pj in zip(tree_t["projs"] + [tree_t["readout"]],
                      tree_j["projs"] + [tree_j["readout"]]):
        leaves = [(pt["traces"][k], pj["traces"][k]) for k in
                  ("pi", "pj", "pij")]
        leaves += [(pt[k], pj[k]) for k in ("w", "b", "mask", "table")]
        for a, b in leaves:
            assert (a is None) == (b is None)
            if a is not None:
                assert a.shape == b.shape and a.dtype == b.dtype
        for k in ("pi", "pj"):
            np.testing.assert_array_equal(pt["traces"][k], pj["traces"][k])
        assert pt["traces"]["t"] == int(pj["traces"]["t"]) == 0
    np.testing.assert_array_equal(tree_t["readout"]["mask"],
                                  tree_j["readout"]["mask"])
    # the JAX tree itself initialises the port's state
    back = convert.state_from_numpy(tree_j, tcfg, device="cpu")
    assert back.projs[0].w.shape == st.projs[0].w.shape


@pytest.mark.parametrize("layout", ["dense", "c"])
def test_depth1_steps_match_jax(layout):
    """``hidden_rates``, three ``unsupervised_step``s (the JAX noise
    injected) and a ``supervised_step`` from one JAX state."""
    kw = {} if layout == "dense" else dict(patchy_traces=True, compact=True)
    jcfg, tcfg = _cfgs(struct_every=2, **kw)
    if layout == "dense":
        jcfg = dataclasses.replace(jcfg, nact_hi=36)
        tcfg = dataclasses.replace(tcfg, nact_hi=36)
    st_j = jn.init_network(jcfg, jax.random.PRNGKey(2))
    st_t = convert.state_from_numpy(_jtree(st_j), tcfg, device="cpu")
    xs, ys, _ = _batches(tcfg.network_spec(), nb=3, b=11, seed=3)
    np.testing.assert_allclose(
        hidden_rates(st_t, tcfg, _t(xs[0])).numpy(),
        np.asarray(jn.hidden_rates(st_j, jcfg, jnp.asarray(xs[0]))),
        atol=FWD_TOL)
    for k in range(3):
        _, sub = jax.random.split(st_j.key)
        noise = _t(jax.random.normal(sub, (11, tcfg.hidden_geom.N)))
        st_j = jn.unsupervised_step(st_j, jcfg, jnp.asarray(xs[k]))
        st_t = unsupervised_step(st_t, tcfg, _t(xs[k]), noise=noise)
        _assert_state_close(st_t, st_j, f"unsupervised step {k}")
    st_j = jn.supervised_step(st_j, jcfg, jnp.asarray(xs[0]),
                              jnp.asarray(ys[0]))
    st_t = supervised_step(st_t, tcfg, _t(xs[0]), torch.from_numpy(ys[0]))
    _assert_state_close(st_t, st_j, "supervised step")
    np.testing.assert_allclose(
        hidden_rates(st_t, tcfg, _t(xs[1])).numpy(),
        np.asarray(jn.hidden_rates(st_j, jcfg, jnp.asarray(xs[1]))),
        atol=W_TOL)


# ----------------------------------------------------------- donation --

@pytest.mark.parametrize("tb", ["cuda", "torch"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_donated_steps_equal_the_functional_steps(layout, tb):
    """From one state at trace clock 2 (the next learn crosses the rewire
    at 3): the plain, masked and readout steps, donated, equal the
    functional steps bit for bit, return the input's own tensors, and the
    functional steps leave their input as it was."""
    _, tspec, _, st = _states(layout, 2, tb, seed=4)
    xs, ys, valid = _batches(tspec, nb=2, n_valid=7)
    for _ in range(2):  # clock 2 on layer 0
        st = tn.train_projection_step(st, tspec, _t(xs[0]), 0)
    g = torch.Generator().manual_seed(9)
    noise = torch.randn((B, tspec.projs[0].post.N), generator=g)
    steps = {
        "unsupervised, across a rewire": lambda s, **kw:
            tn.train_projection_step(s, tspec, _t(xs[1]), 0, noise=noise,
                                     **kw),
        "masked unsupervised": lambda s, **kw:
            tn.train_projection_step(
                s, tspec, tn.stack_rates(s, tspec, _t(xs[1]), depth=1), 1,
                valid=_t(valid[1]), noise=noise, **kw),
        "readout": lambda s, **kw:
            tn.supervised_readout_step(s, tspec, _t(xs[1]),
                                       torch.from_numpy(ys[1]), **kw),
        "masked readout": lambda s, **kw:
            tn.supervised_readout_step(s, tspec, _t(xs[1]),
                                       torch.from_numpy(ys[1]),
                                       _t(valid[1]), **kw),
    }
    for name, step in steps.items():
        before = _snapshot(st)
        want = step(st)
        for a, b in zip(graphs.state_tensors(st), before):
            assert torch.equal(a, b), f"{name}: the functional step wrote"
        donor = graphs.scratch_clone(st)
        donor = dataclasses.replace(donor, projs=tuple(
            dataclasses.replace(p, mask=p.mask.clone(),
                                table=None if p.table is None
                                else p.table.clone())
            for p in donor.projs))
        held = graphs.state_tensors(donor)
        got = step(donor, donate=True)
        _assert_states_equal(got, want, name)
        assert all(a is b for a, b in zip(graphs.state_tensors(got), held)), \
            f"{name}: the donated step moved a tensor"
    assert want.projs[0].traces.t_host == 2


def test_update_wrappers_write_where_told():
    """The three update wrappers' ``out``: their results written over pij
    and w equal the fresh results bit for bit (the plain versions here);
    an ``out`` that overlaps pij without being it is refused on the
    card-side check."""
    from repro_torch.kernels._build import require_outputs
    rng = np.random.default_rng(0)
    hi, mi, hj, mj, nact, b = 6, 2, 3, 4, 2, 5
    ni, nj = hi * mi, hj * mj
    x, y = _t(rng.random((b, ni))), _t(rng.random((b, nj)))
    pij = _t(rng.random((ni, nj)) * 0.05)
    pij_c = _t(rng.random((hj, nact * mi, mj)) * 0.05)
    lpi, lpj = _t(-rng.random(ni)), _t(-rng.random(nj))
    mask = torch.zeros((hi, hj))
    mask[:nact] = 1.0
    table = torch.tensor([[0, 1]] * hj, dtype=torch.int32)
    a = torch.tensor(0.3)
    calls = {
        "bcpnn_update": (pij, lambda p, **kw: ops.bcpnn_update(
            p, lpi, lpj, x, y, mask, a, **kw)),
        "patchy_update": (pij, lambda p, **kw: ops.patchy_update(
            p, lpi, lpj, x, y, table, a, mi, hj, mj, **kw)),
        "compact_update": (pij_c, lambda p, **kw: ops.compact_update(
            p, lpi, lpj, x, y, table, a, mi, **kw)),
    }
    for name, (p0, call) in calls.items():
        want = call(p0)
        p, w = p0.clone(), torch.full_like(p0, 7.0)
        got = call(p, out=(p, w))
        assert got[0] is p and got[1] is w, name
        assert torch.equal(p, want[0]) and torch.equal(w, want[1]), name
    buf = torch.zeros(2 * ni * nj)
    base = buf[:ni * nj].view(ni, nj)
    with pytest.raises(ValueError, match="overlaps"):
        require_outputs((buf[1:ni * nj + 1].view(ni, nj),
                         torch.empty(ni, nj)), base, base.device)
    with pytest.raises(ValueError, match="shares memory"):
        require_outputs((base, buf[ni * nj - 1:2 * ni * nj - 1].view(ni, nj)),
                        base, base.device)


# ----------------------------------------------------- the trainer ----

def _eager_fit(tr, xtr, ytr, epochs, batch):
    """The fit as a loop of functional steps: what the epoch programs
    replay, step for step."""
    xs_np, valid_np = tt._batchify_padded(np.asarray(xtr, np.float32), batch)
    ys_np, _ = tt._batchify_padded(np.asarray(ytr, np.int32), batch)
    xs, ys, valid = _t(xs_np), torch.from_numpy(ys_np), _t(valid_np)
    nb = xs.shape[0]
    tail = nb - 1 if valid_np.min() < 1 else -1
    st, spec = tr.state, tr.spec
    cur = xs
    for layer in range(spec.depth):
        for _ in range(epochs):
            for b in range(nb):
                st = tn.train_projection_step(
                    st, spec, cur[b], layer,
                    valid=valid[b] if b == tail else None)
        if layer + 1 < spec.depth:
            cur = torch.stack([tn.forward(st.projs[layer], spec.projs[layer],
                                          h) for h in cur])
    for b in range(nb):
        st = tn.supervised_readout_step(st, spec, xs[b], ys[b],
                                        valid=valid[b] if b == tail else None)
    return st


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_fit_through_the_programs_equals_the_step_loop(layout):
    """``Trainer.fit`` (two epochs a layer, depth 2, a padded tail and a
    rewire every 3 steps) ends in the state of the functional step loop
    from the same seed, bit for bit; ``evaluate`` through the cached eval
    program gives ``evaluate_padded``'s accuracy, twice."""
    _, tspec = _specs(layout, 2)
    rng = np.random.default_rng(7)
    x = rng.random((75, tspec.input_geom.H), dtype=np.float32)
    xtr = np.stack([x, 1 - x], -1).reshape(75, -1)
    ytr = rng.integers(0, tspec.n_classes, 75)
    tr = Trainer(tspec, seed=3, device="cpu")
    want = _eager_fit(Trainer(tspec, seed=3, device="cpu"), xtr, ytr, 2, 16)
    stats = tr.fit(xtr, ytr, epochs=2, batch=16)
    _assert_states_equal(tr.state, want)
    assert tr.state.projs[1].traces.t_host == 10 and stats["sup_s"] >= 0
    acc = tr.evaluate(xtr, ytr, batch=16)
    assert acc == tr.evaluate(xtr, ytr, batch=16)
    assert acc == evaluate_padded(want, tspec, xtr, ytr, batch=16)


# ------------------------------------------------ the fit's staging --

@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("n,xdt,ydt,slot", [
    (64, np.float32, np.int32, None),   # whole batches
    (75, np.float32, np.int32, None),   # a tail
    (5, np.float32, np.int32, None),    # fewer rows than a batch
    (0, np.float32, np.int32, None),    # no rows: one batch, all pad
    (75, np.float64, np.int64, None),   # converted as numpy converts
    (75, np.float64, np.int64, 5 * 24 * 4),  # 5-row slots: 15 chunks
])
def test_staged_batches_equal_the_padded_host_arrays(monkeypatch, n, xdt,
                                                     ydt, slot, ring):
    """``_stage_padded``'s batches, straight or through a staging ring
    (plain slots on the CPU), equal ``_batchify_padded``'s arrays of the
    float32 rows and int32 labels bit for bit, with the same ``masked``;
    it counts the rows' and labels' bytes it copied."""
    if slot is not None:
        monkeypatch.setattr(tt, "STAGING_SLOT_BYTES", slot)
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((n, 12, 2)) * 1e3).astype(xdt)
    y = rng.integers(-2**40, 2**40, n).astype(ydt)
    batch = 16
    cpu = torch.device("cpu")
    r = tt._StagingRing(cpu, 24 * 4) if ring else None
    got = tt._stage_padded(x, y, batch, cpu, r)
    xs, valid = tt._batchify_padded(np.asarray(x, np.float32), batch)
    ys, _ = tt._batchify_padded(np.asarray(y, np.int32), batch)
    for a, b in ((got.xs, xs), (got.ys, ys), (got.valid, valid)):
        assert a.dtype == torch.from_numpy(b).dtype and a.shape == b.shape
        assert np.array_equal(a.numpy().view(np.uint8),
                              b.view(np.uint8))
    assert got.masked == bool(valid.min() < 1) and got.n_img == n
    assert got.h2d_bytes == n * (24 + 1) * 4
    with pytest.raises(ValueError, match="labels"):
        tt._stage_padded(x, np.zeros(n + 1, ydt), batch, cpu, r)


def test_a_fit_reports_the_bytes_it_staged():
    """A CPU fit makes no staging ring and reports the bytes of its rows
    as float32 and its labels as int32, whatever the caller's dtypes, in
    its stats and its report."""
    _, tspec = _specs("dense", 1)
    rng = np.random.default_rng(1)
    x = rng.random((75, tspec.input_geom.N))  # float64
    y = rng.integers(0, tspec.n_classes, 75)  # int64
    allocs = tt.STAGING_ALLOCS
    tr = Trainer(tspec, seed=0, device="cpu")
    stats = tr.fit(x, y, epochs=1, batch=16)
    want = x.astype(np.float32).nbytes + y.astype(np.int32).nbytes
    assert stats["h2d_bytes"] == want == obs.FITS[-1].h2d_bytes
    assert tr._ring is None and tt.STAGING_ALLOCS == allocs


# ------------------------------------------- launch-count bookkeeping --

def test_launch_counts_are_taken_back_from_a_capture_and_added_per_replay():
    """What a capture counts is returned and taken back, also when the
    capture raises; a replay adds it again."""
    import importlib
    bcpnn_fwd = importlib.import_module("repro_torch.kernels.bcpnn_fwd")
    patchy = importlib.import_module("repro_torch.kernels.patchy")
    ops.reset_launch_counts()
    ops.set_launch_counts({"bcpnn_fwd": 5})

    def capture():  # the wrappers run and count; nothing launches
        bcpnn_fwd.LAUNCHES += 2
        patchy.LAUNCHES["compact_update"] += 1

    delta = graphs.count_launches(capture)
    assert delta == {"bcpnn_fwd": 2, "compact_update": 1}
    assert ops.launch_counts()["bcpnn_fwd"] == 5
    assert ops.launch_counts()["compact_update"] == 0
    for _ in range(3):
        ops.add_launch_counts(delta)
    got = ops.launch_counts()
    assert got["bcpnn_fwd"] == 11 and got["compact_update"] == 3
    assert sum(got.values()) == 14

    def failing():
        capture()
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        graphs.count_launches(failing)
    assert ops.launch_counts() == got
    ops.reset_launch_counts()
    assert not any(ops.launch_counts().values())


def test_a_cuda_state_never_falls_back_to_the_eager_step(monkeypatch):
    """A program handed a state on the card captures or raises: here, with
    no card, it raises before any step runs, and the state is untouched."""
    _, tspec, _, st = _states("dense", 1)
    xs, _, _ = _batches(tspec, nb=1)
    before = _snapshot(st)
    monkeypatch.setattr(tn.DeepState, "device",
                        property(lambda self: torch.device("cuda")))
    program = tt._projection_program(tspec, 0, frozen=False, noise=False)
    with pytest.raises((RuntimeError, AssertionError, AttributeError)):
        program(st, _t(xs[0]))
    for a, b in zip(graphs.state_tensors(st), before):
        assert torch.equal(a, b)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(tspec)
