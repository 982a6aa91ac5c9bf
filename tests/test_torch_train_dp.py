"""The port's data-parallel fit (counterpart of tests/test_train_dp.py):
``Trainer(cfg, seed, mesh)`` on 2 and 3 rank processes (gloo groups on
the CPU; rank bodies in tests/torch_dp_ranks.py) against the port's
single-device fit, bit for bit on every state array, clock and the
generator's state, for dense, patchy-held and compact-resident projections
on whole-batch and padded-tail data; elastic kill-resume from 2 ranks to
2 and to 1, and a seeded chaos soak of it; the refusals; the launcher.

The port masks only a padded fit's last batch (the single-device fit's
convention); the DP fit does the same, which is what lets it equal that
fit.  Each group runs once per module (fixtures); the tests are cases over
its results.
"""
import json

import numpy as np
import pytest
import torch

import torch_dp_ranks as R
from repro_torch.core import Trainer
from repro_torch.core.hypercolumns import LayerGeom
from repro_torch.core.network import make_network_spec
from repro_torch.distributed import (WorkerLost, elastic_mesh, rank_devices,
                                     run_group)
from repro_torch.launch import train_dp
from repro_torch.launch.train_dp import snapshots_equal

KINDS = ["dense", "patchy", "compact"]
# rows -> (batch, rows): whole batches and a padded tail, on 2 and 3 ranks
SIZES = {2: (16, [48, 41]), 3: (18, [54, 47])}
KILL_SEEDS = 3  # chaos trials


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # as every CPU rank runs
    yield
    torch.set_num_threads(n)


def _spec(kind="dense", depth1=True):
    kw = dict(alpha=1e-2, backend="torch", support_noise=2.0,
              noise_steps=50)
    layers = [(6, 8)] if depth1 else [(6, 8), (6, 4)]
    if kind == "patchy":
        kw.update(nact=[4] * len(layers), patchy_traces=True)
    if kind == "compact":
        kw.update(nact=[4] * len(layers), patchy_traces=True, compact=True)
    return make_network_spec(LayerGeom(12, 2), layers, 3, **kw)


def _data(n, seed=0, n_classes=3, dim=24):
    rng = np.random.default_rng(seed)
    return (rng.random((n, dim)).astype(np.float32),
            rng.integers(0, n_classes, n).astype(np.int32))


def _single(spec, x, y, batch=16, epochs=2):
    t = Trainer(spec, seed=0, device="cpu")
    t.fit(x, y, epochs=epochs, batch=batch)
    return t


def _fit_jobs(n_ranks):
    batch, sizes = SIZES[n_ranks]
    return [("fit", dict(spec=_spec(k), x=_data(n)[0], y=_data(n)[1],
                         batch=batch))
            for k in KINDS for n in sizes]


def _chaos_trials():
    """Seeded trials: (data seed, kill chunk, surviving ranks)."""
    rng = np.random.default_rng(0)
    return [(int(rng.integers(1 << 30)), int(rng.integers(1, 9)),
             int(rng.integers(1, 3))) for _ in range(KILL_SEEDS)]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_fits")
    return {name: str(root / name)
            for name in ["full", "same", "elastic"]
            + [f"trial{i}" for i in range(KILL_SEEDS)]}


@pytest.fixture(scope="module")
def group2(dirs):
    """On 2 ranks: the six fits; the chunked checkpointing depth-2 fit;
    a fit killed at chunk 3 and resumed on the same 2 ranks; the chaos
    trials' killed fits, and the resumes of those that keep 2 ranks."""
    spec = _spec("dense", depth1=False)
    x, y = _data(41, seed=1)
    ck = dict(spec=spec, x=x, y=y, ckpt_every=2)
    jobs = _fit_jobs(2)
    jobs += [("fit", dict(ck, ckpt_dir=dirs["full"], evaluate=True)),
             ("fit", dict(ck, ckpt_dir=dirs["same"], kill_at=3)),
             ("fit", dict(ck, ckpt_dir=dirs["same"], resume=True,
                          evaluate=True))]
    for i, (seed, kill_at, keep) in enumerate(_chaos_trials()):
        xt, yt = _data(41, seed=seed)
        tk = dict(spec=spec, x=xt, y=yt, ckpt_every=2,
                  ckpt_dir=dirs[f"trial{i}"])
        jobs.append(("fit", dict(tk, kill_at=kill_at)))
        if keep == 2:
            jobs.append(("fit", dict(tk, resume=True, evaluate=True)))
    return run_group(R.run, 2, backend="gloo", device="cpu", args=(jobs,),
                     timeout_s=300)


@pytest.fixture(scope="module")
def group3():
    return run_group(R.run, 3, backend="gloo", device="cpu",
                     args=(_fit_jobs(3),), timeout_s=300)


def _assert_all_ranks(ranks, job, want, context):
    for r, res in enumerate(ranks):
        assert snapshots_equal({k: v for k, v in res[job].items()
                                if k in want}, want), f"{context} rank {r}"


# ------------------------------------------- DP fit vs single-device --

@pytest.mark.parametrize("n_ranks", [2, 3])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("padded", [False, True],
                         ids=["whole-batch", "padded-tail"])
def test_dp_fit_matches_single_device_bitwise(group2, group3, n_ranks, kind,
                                              padded):
    batch, sizes = SIZES[n_ranks]
    n = sizes[padded]
    ranks = {2: group2, 3: group3}[n_ranks]
    job = KINDS.index(kind) * 2 + padded
    want = R.tree(_single(_spec(kind), *_data(n), batch=batch).state)
    _assert_all_ranks(ranks, job, want, f"{kind} n={n} on {n_ranks}")
    assert "comm_s" in ranks[0][job]["stats"]


def test_dp_fit_rejects_unshardable_batch():
    mesh = elastic_mesh((2,), ("data",), devices=rank_devices(2))
    t = Trainer(_spec("dense"), 0, mesh, device="cpu")
    x, y = _data(34)
    with pytest.raises(ValueError, match="cannot shard"):
        t.fit(x, y, epochs=1, batch=17)


def test_dp_trainer_rejects_unshardable_geometry():
    spec = make_network_spec(LayerGeom(12, 2), [(5, 8)], 3, backend="torch")
    mesh = elastic_mesh((2,), ("data",), devices=rank_devices(2))
    with pytest.raises(ValueError, match="not divisible"):
        Trainer(spec, 0, mesh, device="cpu")


# ------------------------------------------------- elastic kill-resume --

@pytest.fixture(scope="module")
def reference():
    """The uninterrupted, unchunked single-device depth-2 fit."""
    x, y = _data(41, seed=1)
    t = _single(_spec("dense", depth1=False), x, y)
    return R.tree(t.state), t.evaluate(x, y, batch=16)


def test_chunked_dp_fit_equals_the_single_device_fit(group2, reference):
    want, acc = reference
    _assert_all_ranks(group2, 6, want, "chunked DP")
    assert all(r[6]["acc"] == acc for r in group2)
    assert "straggler_events" in group2[0][6]["stats"]


def test_kill_resume_on_the_same_mesh(group2, reference):
    want, acc = reference
    for r in group2:
        assert r[7]["killed"]["phase"] == "unsupervised"
    _assert_all_ranks(group2, 8, want, "same-mesh resume")
    assert all(r[8]["acc"] == acc for r in group2)


def test_worker_lost_reaches_the_parent_and_resumes_on_one_rank(dirs,
                                                                reference):
    """A rank's WorkerLost ends the group and is raised again here; the
    largest mesh of the one surviving rank resumes the fit from its
    checkpoint in this process and lands on the uninterrupted fit's
    bits."""
    spec = _spec("dense", depth1=False)
    x, y = _data(41, seed=1)
    with pytest.raises(WorkerLost, match="simulated loss"):
        run_group(R.run, 2, backend="gloo", device="cpu", args=(
            [("fit", dict(spec=spec, x=x, y=y, ckpt_every=2,
                          ckpt_dir=dirs["elastic"], kill_at=3,
                          catch=False))],), timeout_s=120)
    mesh1 = elastic_mesh((2,), ("data",), devices=rank_devices(2)[:1])
    assert dict(mesh1.shape) == {"data": 1}
    t = Trainer(spec, 0, mesh1, device="cpu")
    t.fit(x, y, epochs=2, batch=16, ckpt_dir=dirs["elastic"],
          ckpt_every_batches=2, resume=True)
    want, acc = reference
    assert snapshots_equal(R.tree(t.state), want)
    assert t.evaluate(x, y, batch=16) == acc


@pytest.mark.parametrize("trial", range(KILL_SEEDS))
def test_chaos_kill_resume_soak(group2, dirs, trial):
    """Seeded kill chunks and data: every interrupted DP fit, resumed on
    the same 2 ranks or on 1, lands on its uninterrupted single-device fit
    bit for bit, with equal accuracy."""
    seed, kill_at, keep = _chaos_trials()[trial]
    spec = _spec("dense", depth1=False)
    x, y = _data(41, seed=seed)
    ref = _single(spec, x, y)
    job = 9 + sum(1 + (k == 2) for _, _, k in _chaos_trials()[:trial])
    assert all("killed" in r[job] for r in group2), kill_at
    if keep == 2:
        _assert_all_ranks(group2, job + 1, R.tree(ref.state),
                          f"trial {trial}")
        assert all(r[job + 1]["acc"] == ref.evaluate(x, y, batch=16)
                   for r in group2)
        return
    t = Trainer(spec, 0, elastic_mesh((2,), ("data",),
                                      devices=rank_devices(1)),
                device="cpu")
    t.fit(x, y, epochs=2, batch=16, ckpt_dir=dirs[f"trial{trial}"],
          ckpt_every_batches=2, resume=True)
    assert snapshots_equal(R.tree(t.state), R.tree(ref.state))
    assert t.evaluate(x, y) == ref.evaluate(x, y)


def test_chaos_trials_cover_both_survivor_counts():
    assert {k for _, _, k in _chaos_trials()} == {1, 2}


# ------------------------------------------------------------ launcher --

JAX_JSON_KEYS = {"devices", "train_n", "batch", "epochs", "depth",
                 "single_s", "single_images_per_s", "single_acc", "dp_s",
                 "dp_images_per_s", "dp_acc", "scaling_x", "kill_resume_s",
                 "recovery_overhead_s", "resumed_acc",
                 "resumed_bit_identical"}


def test_launcher_smoke_on_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train_dp --smoke --device cpu`` at its
    defaults, in-process: the DP fit and the 2 -> 1 kill-resume both
    bit-identical to the single-device fit; the JAX launcher's JSON keys."""
    out = tmp_path / "dp.json"
    assert train_dp.main(["--smoke", "--device", "cpu", "--json",
                          str(out)]) == 0
    got = json.loads(out.read_text())
    assert set(got) == JAX_JSON_KEYS
    assert got["resumed_bit_identical"] is True
    assert got["dp_acc"] == got["single_acc"] == got["resumed_acc"]
    assert "smoke OK" in capsys.readouterr().out
    assert train_dp.build_parser().parse_args([]).device == "cuda"
