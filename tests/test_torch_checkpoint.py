"""The port's checkpoints (``repro_torch.checkpoint``), its resumable fit
and its dense -> compact migration, held against the JAX package on the
CPU at small sizes (side 6, 4x8 hidden HCs, depth 1 and 2).

Both packages write and read one on-disk format, so the tests cross it in
both directions.  Tolerances (DESIGN.md §3): arrays read from a file
bitwise; the port's ``infer`` against the JAX ``infer`` on the same state
within 1e-5; a killed and resumed port fit against the uninterrupted one
bitwise (same package, same generator).
"""
import importlib.util
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint import load_model as j_load_model
from repro.configs.bcpnn_models import deep_synth_spec as j_deep_synth_spec
from repro.core import network as jn
from repro.core.trainer import FitCursor as JFitCursor
from repro.core.trainer import Trainer as JTrainer
from repro_torch.checkpoint import CheckpointManager, load_model, load_models
from repro_torch.checkpoint.ckpt import generator_key, key_seed
from repro_torch.checkpoint.migrate import MigrationRefused, migrate_checkpoint
from repro_torch.checkpoint.migrate import main as migrate_main
from repro_torch.configs.bcpnn_models import deep_synth_spec
from repro_torch.core import Trainer, infer, init_deep
from repro_torch.core.graphs import state_tensors
from repro_torch.core.trainer import FitCursor
from repro_torch.distributed import WorkerLost

FWD_TOL = 1e-5

# layout -> deep_synth_spec fields; (c) rewires every 3 steps of its clock
LAYOUTS = {
    "dense": dict(depth=2),
    "c": dict(depth=1, nact=[20], patchy_traces=True, compact=True,
              struct_every=3),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _specs(layout="dense", tb="cuda"):
    kw = dict(side=6, n_classes=3, hidden_hc=4, hidden_mc=8,
              **LAYOUTS[layout])
    return j_deep_synth_spec(backend="jnp", **kw), \
        deep_synth_spec(backend=tb, **kw)


def _data(spec, n=100, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((n, spec.input_geom.N)).astype(np.float32)
    y = rng.integers(0, spec.n_classes, size=n).astype(np.int32)
    return x, y


def _assert_states_equal(a, b):
    ta, tb = state_tensors(a), state_tensors(b)
    assert len(ta) == len(tb)
    for i, (u, v) in enumerate(zip(ta, tb)):
        assert u.dtype == v.dtype and torch.equal(u, v), f"tensor {i}"
    for p, q in zip(a.projs + (a.readout,), b.projs + (b.readout,)):
        assert p.traces.t_host == q.traces.t_host == int(q.traces.t)


def _jax_leaves(state):
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {"/".join(str(getattr(k, "name", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf) for path, leaf in flat}


def _port_arrays(state):
    """The port state's arrays under the JAX leaf names."""
    out = {}
    for prefix, p in ([(f"projs/{l}", p) for l, p in enumerate(state.projs)]
                      + [("readout", state.readout)]):
        tr = p.traces
        for name, t in (("traces/pi", tr.pi), ("traces/pj", tr.pj),
                        ("traces/pij", tr.pij), ("traces/t", tr.t),
                        ("w", p.w), ("b", p.b), ("mask", p.mask),
                        ("table", p.table)):
            if t is not None:
                out[f"{prefix}/{name}"] = t.numpy()
    out["step"] = state.step.numpy()
    return out


# ------------------------------------------------- the on-disk format ----

@pytest.mark.parametrize("layout", ["dense", "c"])
def test_jax_checkpoint_loads_into_the_port(tmp_path, layout):
    """A JAX ``Trainer.save`` directory, through the port's ``load_model``
    alone: every array equal, ``infer`` within 1e-5 of the JAX ``infer``,
    the clocks' host mirrors from the ``t`` leaves, and the generator
    re-seeded from the ``key`` leaf."""
    jspec, tspec = _specs(layout)
    x, y = _data(tspec)
    jt = JTrainer(jspec, seed=3)
    jt.fit(x, y, epochs=1, batch=16)
    d = str(tmp_path / "jax")
    jt.save(d)
    state, spec, step = load_model(d, device="cpu")
    assert spec == tspec.with_backend("torch")  # "jnp" maps to "torch"
    assert step == int(jt.state.step)
    want = _jax_leaves(jt.state)
    got = _port_arrays(state)
    assert set(want) == set(got) | {"key"}
    for name, a in got.items():
        np.testing.assert_array_equal(a, want[name], err_msg=name)
    assert state.projs[0].traces.t_host == int(jt.state.projs[0].traces.t)
    assert state.generator.initial_seed() == key_seed(want["key"])
    jp, jpred = jn.infer(jt.state, jspec, x[:32])
    tp, tpred = infer(state, spec, torch.from_numpy(x[:32]))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=FWD_TOL)
    np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))


@pytest.mark.parametrize("layout", ["dense", "c"])
def test_port_checkpoint_restores_in_jax(tmp_path, layout):
    """A port ``Trainer.save`` directory restores in the JAX
    ``CheckpointManager`` (into a JAX ``init_deep`` target) and in the JAX
    ``load_model``, with the same leaves and inference within 1e-5; its
    ``key`` leaf is the generator's seed."""
    jspec, tspec = _specs(layout)
    x, y = _data(tspec)
    tr = Trainer(tspec, seed=5, device="cpu")
    tr.fit(x, y, epochs=1, batch=16)
    d = str(tmp_path / "port")
    tr.save(d)
    mgr = JManager(d)
    step = mgr.latest_step()
    assert step == int(tr.state.step)
    jstate = mgr.restore(step, jn.init_deep(jspec, jax.random.PRNGKey(0)))
    jstate2, jspec2, _ = j_load_model(d)
    assert jspec2 == jspec.with_backend("pallas")
    arrays = _port_arrays(tr.state)
    for st in (jstate, jstate2):
        leaves = _jax_leaves(st)
        for name, a in arrays.items():
            np.testing.assert_array_equal(leaves[name], a, err_msg=name)
        np.testing.assert_array_equal(leaves["key"],
                                      generator_key(tr.state.generator))
    assert key_seed(_jax_leaves(jstate)["key"]) == 5
    tp, tpred = infer(tr.state, tspec, torch.from_numpy(x[:32]))
    jp, jpred = jn.infer(jstate, jspec, x[:32])
    np.testing.assert_allclose(np.asarray(jp), tp.numpy(), atol=FWD_TOL)
    np.testing.assert_array_equal(np.asarray(jpred), tpred.numpy())


def test_manifest_carries_spec_and_generator(tmp_path):
    _, tspec = _specs()
    tr = Trainer(tspec, seed=2, device="cpu")
    d = str(tmp_path / "m")
    tr.save(d, step=7)
    with open(os.path.join(d, "step_7", "manifest.json")) as f:
        man = json.load(f)
    assert man["step"] == 7
    assert man["leaves"]["key"] == {"shape": [2], "dtype": "uint32"}
    assert man["leaves"]["step"] == {"shape": [], "dtype": "int32"}
    assert {p["backend"] for p in man["extra"]["spec"]["projs"]} \
        == {"pallas"}
    gen = man["extra"]["torch_generator"]
    assert gen["device"] == "cpu"
    assert gen["state"] == tr.state.generator.get_state().tolist()


# -------------------------------------------------------- the generator ----

def test_same_device_restore_resumes_the_random_stream(tmp_path):
    """A port checkpoint restored on the device type it was saved on
    continues the generator's stream exactly."""
    _, tspec = _specs()
    tr = Trainer(tspec, seed=4, device="cpu")
    torch.rand(17, generator=tr.state.generator)  # move off the seed
    d = str(tmp_path / "g")
    tr.save(d)
    state, _, _ = load_model(d, seed=99, device="cpu")
    assert state.generator is not tr.state.generator
    a = torch.rand(64, generator=tr.state.generator)
    b = torch.rand(64, generator=state.generator)
    assert torch.equal(a, b)


def test_other_device_or_jax_checkpoint_reseeds_from_key(tmp_path):
    """A manifest whose generator was saved on another device type (here:
    rewritten to say ``cuda``) re-seeds from the ``key`` leaf, as a JAX
    checkpoint does."""
    _, tspec = _specs()
    tr = Trainer(tspec, seed=11, device="cpu")
    torch.rand(5, generator=tr.state.generator)
    d = str(tmp_path / "g")
    tr.save(d, step=1)
    path = os.path.join(d, "step_1", "manifest.json")
    with open(path) as f:
        man = json.load(f)
    man["extra"]["torch_generator"]["device"] = "cuda"
    with open(path, "w") as f:
        json.dump(man, f)
    state, _, _ = load_model(d, device="cpu")
    fresh = torch.Generator().manual_seed(11)
    assert state.generator.initial_seed() == 11
    assert torch.equal(torch.rand(8, generator=state.generator),
                       torch.rand(8, generator=fresh))
    assert key_seed(np.array([1, 2], np.uint32)) == (1 << 32) | 2


# ----------------------------------------------------- manager behaviour ----

def test_keep_last_garbage_collection_and_threaded_save(tmp_path):
    _, tspec = _specs()
    state = init_deep(tspec, 0, "cpu")
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    for s in range(5):
        mgr.save(s, state, blocking=(s % 2 == 0), extra={"s": s})
    mgr.wait()
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4
    assert mgr.read_extra(3)["s"] == 3
    step, extra = mgr.resume_point()
    assert step == 4 and extra["s"] == 4
    assert CheckpointManager(str(tmp_path / "empty")).resume_point() is None
    restored = mgr.restore(4, init_deep(tspec, 1, "cpu"))
    _assert_states_equal(restored, state)


def test_threaded_save_of_a_cpu_state_is_the_state_at_the_call(
        tmp_path, monkeypatch):
    """The writer thread is held back while a donated step writes the
    saved CPU state in place; the checkpoint still holds the state at the
    call (the JAX ``save`` reads immutable arrays)."""
    from repro_torch.core.network import unsupervised_layer_step
    _, tspec = _specs()
    state = init_deep(tspec, 0, "cpu")
    at_call = [t.clone() for t in state_tensors(state)]
    release, savez = threading.Event(), np.savez

    def held_savez(*args, **kwargs):
        assert release.wait(30.0), "writer never released"
        savez(*args, **kwargs)

    monkeypatch.setattr(np, "savez", held_savez)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, state, blocking=False)
    x, _ = _data(tspec, 8)
    stepped = unsupervised_layer_step(state, tspec, torch.from_numpy(x), 0,
                                      donate=True)
    assert stepped.projs[0].traces.pij is state.projs[0].traces.pij
    assert not torch.equal(state.projs[0].traces.pij,
                           at_call[2])  # written in place
    release.set()
    mgr.wait()
    monkeypatch.setattr(np, "savez", savez)
    saved = np.load(tmp_path / "step_0" / "arrays.npz")
    np.testing.assert_array_equal(saved["projs/0/traces/pij"],
                                  at_call[2].numpy())
    restored = mgr.restore(0, init_deep(tspec, 1, "cpu"))
    for t, u in zip(state_tensors(restored), at_call):
        assert torch.equal(t, u)


def test_restore_writes_nothing_of_the_target(tmp_path):
    _, tspec = _specs()
    a = init_deep(tspec, 0, "cpu")
    b = init_deep(tspec, 1, "cpu")
    before = [t.clone() for t in state_tensors(b)]
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, a, blocking=True)
    out = mgr.restore(0, b)
    for t, u in zip(state_tensors(b), before):
        assert torch.equal(t, u)
    assert all(x is not y for x, y in zip(state_tensors(out),
                                          state_tensors(b)))


def test_restore_mismatch_errors_and_hints(tmp_path):
    """The JAX manager's refusals: another depth names the missing and
    extra leaves; a table leaf on one side only names the dense vs compact
    layout and the migration; a trace of another rank names the 2-D vs
    3-D layout; a shardings tree of another leaf count is refused with the
    JAX error."""
    _, dense = _specs()
    mgr = CheckpointManager(str(tmp_path / "d"))
    mgr.save(0, init_deep(dense, 0, "cpu"), blocking=True)
    _, one = _specs("c")
    with pytest.raises(ValueError, match="missing leaves|extra leaves"):
        mgr.restore(0, init_deep(
            deep_synth_spec(side=6, n_classes=3, hidden_hc=4, hidden_mc=8,
                            depth=1), 0, "cpu"))
    patchy = deep_synth_spec(side=6, n_classes=3, hidden_hc=4, hidden_mc=8,
                             depth=1, nact=[20], patchy_traces=True)
    mp = CheckpointManager(str(tmp_path / "p"))
    mp.save(0, init_deep(patchy, 0, "cpu"), blocking=True)
    with pytest.raises(ValueError, match="dense vs compact-resident.*"
                                         "repro_torch.checkpoint.migrate"):
        mp.restore(0, init_deep(one, 0, "cpu"))
    # same leaf names, one pij of rank 2 against rank 3: a hand-made
    # checkpoint of the compact names over dense traces
    state_c = init_deep(one, 0, "cpu")
    bad = CheckpointManager(str(tmp_path / "bad"))
    bad.save(0, state_c, blocking=True)
    arrays = dict(np.load(os.path.join(str(tmp_path / "bad"), "step_0",
                                       "arrays.npz")))
    arrays["projs/0/traces/pij"] = np.zeros((72, 32), np.float32)
    np.savez(os.path.join(str(tmp_path / "bad"), "step_0", "arrays.npz"),
             **arrays)
    with pytest.raises(ValueError, match="2-D vs 3-D"):
        bad.restore(0, state_c)
    # a shardings tree of another leaf count: the JAX error
    n_leaves = len(np.load(os.path.join(str(tmp_path / "d"), "step_0",
                                        "arrays.npz")).files)
    with pytest.raises(ValueError, match=f"shardings tree has 1 leaves for "
                                         f"{n_leaves} target leaves"):
        mgr.restore(0, init_deep(dense, 0, "cpu"), shardings=[None])


def test_load_model_and_load_models_naming(tmp_path):
    _, tspec = _specs()
    tr = Trainer(tspec, seed=0, device="cpu")
    d = str(tmp_path / "modelA")
    tr.save(d)
    state, spec, step = load_model(d, device="cpu")
    assert spec == tspec and step == 0
    _assert_states_equal(state, tr.state)
    models = load_models([d, d], device="cpu")
    assert list(models) == ["modelA", "modelA#2"]
    with pytest.raises(FileNotFoundError):
        load_model(str(tmp_path / "missing"), device="cpu")
    bare = str(tmp_path / "bare")
    CheckpointManager(bare).save(1, tr.state, blocking=True)
    with pytest.raises(ValueError, match="no spec metadata"):
        load_model(bare, device="cpu")


# ------------------------------------------------------- resumable fit ----

def test_fit_cursor_dict_matches_jax():
    for cur in (FitCursor(), FitCursor("unsupervised", 1, 2, 3),
                FitCursor("supervised", 2, 0, 5), FitCursor("done", 2)):
        d = cur.to_dict()
        assert JFitCursor.from_dict(d).to_dict() == d
        assert FitCursor.from_dict(JFitCursor.from_dict(d).to_dict()) == cur
    assert list(FitCursor().to_dict()) == list(JFitCursor().to_dict())


@pytest.mark.parametrize("kill_at", [2, 5, 7])
@pytest.mark.parametrize("layout", ["dense", "c"])
def test_killed_and_resumed_fit_equals_uninterrupted(tmp_path, layout,
                                                     kill_at):
    """A fit checkpointing every 3 batches, killed by ``on_chunk`` raising
    ``WorkerLost`` after chunk ``kill_at`` (mid epoch, at an epoch's end,
    in the readout pass), then resumed by a new trainer of another seed,
    ends in the uninterrupted fit's state bit for bit, generator
    included.  100 rows make 7 batches of 16 with a 4-row tail; (c)
    rewires every 3 steps of its clock, across the kill."""
    _, tspec = _specs(layout)
    x, y = _data(tspec)
    ref = Trainer(tspec, seed=1, device="cpu")
    ref.fit(x, y, epochs=2, batch=16)
    d = str(tmp_path / "ckpt")
    tr = Trainer(tspec, seed=1, device="cpu")
    seen = []

    def boom(cur):
        seen.append(cur)
        if len(seen) == kill_at:
            raise WorkerLost(str(cur))

    with pytest.raises(WorkerLost):
        tr.fit(x, y, epochs=2, batch=16, ckpt_dir=d, ckpt_every_batches=3,
               on_chunk=boom)
    extra = CheckpointManager(d).read_extra(
        CheckpointManager(d).latest_step())
    assert FitCursor.from_dict(extra["cursor"]) == seen[-1]
    again = Trainer(tspec, seed=9, device="cpu")
    stats = again.fit(x, y, epochs=2, batch=16, ckpt_dir=d,
                      ckpt_every_batches=3, resume=True)
    _assert_states_equal(again.state, ref.state)
    assert torch.equal(again.state.generator.get_state(),
                       ref.state.generator.get_state())
    assert stats["straggler_events"] >= 0.0
    final = CheckpointManager(d).read_extra(
        CheckpointManager(d).latest_step())
    assert final["cursor"] == FitCursor("done", tspec.depth).to_dict()


def test_chunked_fit_equals_one_chunk_and_counts_chunks(tmp_path):
    _, tspec = _specs()
    x, y = _data(tspec)
    ref = Trainer(tspec, seed=1, device="cpu")
    ref.fit(x, y, epochs=1, batch=16)
    tr = Trainer(tspec, seed=1, device="cpu")
    cursors = []
    tr.fit(x, y, epochs=1, batch=16, ckpt_every_batches=2,
           on_chunk=cursors.append)
    _assert_states_equal(tr.state, ref.state)
    # 7 batches in chunks of 2: 4 chunks per greedy phase (2 layers) and
    # 4 in the readout pass; nothing written without ckpt_dir
    assert len(cursors) == 12
    assert cursors[0] == FitCursor("unsupervised", 0, 0, 2)
    assert cursors[3] == FitCursor("unsupervised", 1, 0, 0)
    assert cursors[-1] == FitCursor("done", 2, 0, 0)
    assert len(tr.timer._times) == 12


def test_fit_checkpoint_refusals_match_jax(tmp_path):
    _, tspec = _specs()
    x, y = _data(tspec, n=32)
    tr = Trainer(tspec, seed=0, device="cpu")
    with pytest.raises(ValueError, match="requires ckpt_dir"):
        tr.fit(x, y, epochs=1, batch=16, resume=True)
    d = str(tmp_path / "final")
    tr.fit(x, y, epochs=1, batch=16, ckpt_dir=d)  # one final checkpoint
    assert CheckpointManager(d).read_extra(2 * 2 + 2)["cursor"]["phase"] \
        == "done"
    tr.save(d, step=100)  # a final artifact: no cursor
    with pytest.raises(ValueError, match="carries no fit cursor"):
        Trainer(tspec, seed=0, device="cpu").fit(
            x, y, epochs=1, batch=16, ckpt_dir=d, resume=True)
    # an empty directory resumes from the start
    fresh = Trainer(tspec, seed=0, device="cpu")
    fresh.fit(x, y, epochs=1, batch=16, ckpt_dir=str(tmp_path / "e"),
              resume=True)
    ref = Trainer(tspec, seed=0, device="cpu")
    ref.fit(x, y, epochs=1, batch=16)
    _assert_states_equal(fresh.state, ref.state)


def test_trainer_save_restore_roundtrip(tmp_path):
    _, tspec = _specs("c")
    x, y = _data(tspec, n=64)
    tr = Trainer(tspec, seed=0, device="cpu")
    tr.fit(x, y, epochs=1, batch=16)
    d = str(tmp_path / "t")
    tr.save(d)
    other = Trainer(tspec, seed=4, device="cpu")
    assert other.restore(d) == int(tr.state.step)
    _assert_states_equal(other.state, tr.state)
    assert other.evaluate(x, y, batch=16) == tr.evaluate(x, y, batch=16)
    with pytest.raises(FileNotFoundError):
        other.restore(str(tmp_path / "none"))


# ----------------------------------------------------------- migration ----

def _jax_migrate():
    path = os.path.join(os.path.dirname(__file__), os.pardir, "scripts",
                        "migrate_ckpt.py")
    mod_spec = importlib.util.spec_from_file_location("migrate_ckpt", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def test_migration_equals_the_jax_script_bitwise(tmp_path):
    """One patchy-held checkpoint through the JAX script and through the
    port's migration: equal arrays bit for bit, equal specs, and the
    port's migrated state serves what the dense-resident one does."""
    kw = dict(side=6, n_classes=3, hidden_hc=4, hidden_mc=8, depth=1,
              nact=[20], patchy_traces=True, struct_every=3)
    jspec = j_deep_synth_spec(backend="jnp", **kw)
    x, y = _data(jspec, n=64)
    jt = JTrainer(jspec, seed=0)
    jt.fit(x, y, epochs=1, batch=16)
    src = str(tmp_path / "dense")
    jt.save(src)
    assert _jax_migrate().main(["--ckpt", src, "--out",
                                str(tmp_path / "jax")]) == 0
    step, lines = migrate_checkpoint(src, str(tmp_path / "port"),
                                     device="cpu")
    assert step == int(jt.state.step) and "compact" in lines[0]

    def arrays(d):
        return dict(np.load(os.path.join(d, f"step_{step}", "arrays.npz")))

    want, got = arrays(str(tmp_path / "jax")), arrays(str(tmp_path / "port"))
    assert set(want) == set(got)
    for name in want:
        assert want[name].dtype == got[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    jm = JManager(str(tmp_path / "jax")).read_extra(step)["spec"]
    tm = CheckpointManager(str(tmp_path / "port")).read_extra(step)["spec"]
    assert jm == tm
    dense, dspec, _ = load_model(src, device="cpu")
    comp, cspec, _ = load_model(str(tmp_path / "port"), device="cpu")
    assert cspec.projs[0].compact and comp.projs[0].table is not None
    xs = torch.from_numpy(x[:16])
    pd, qd = infer(dense, dspec, xs)
    pc, qc = infer(comp, cspec, xs)
    np.testing.assert_allclose(pc.numpy(), pd.numpy(), atol=FWD_TOL)
    np.testing.assert_array_equal(qc.numpy(), qd.numpy())


def test_migration_refuses_what_the_jax_script_refuses(tmp_path, capsys):
    _, tspec = _specs()
    tr = Trainer(tspec, seed=0, device="cpu")
    src = str(tmp_path / "dense")
    tr.save(src)
    out = str(tmp_path / "out")
    assert _jax_migrate().main(["--ckpt", src, "--out", out]) == 2
    assert migrate_main(["--ckpt", src, "--out", out,
                         "--device", "cpu"]) == 2
    assert "no dense-resident patchy-trace" in capsys.readouterr().err
    assert migrate_main(["--ckpt", str(tmp_path / "nowhere"), "--out", out,
                         "--device", "cpu"]) == 2
    os.makedirs(str(tmp_path / "empty"))
    with pytest.raises(MigrationRefused, match="no checkpoints"):
        migrate_checkpoint(str(tmp_path / "empty"), out, device="cpu")
