"""Fault-tolerant data-parallel training launcher (mirrors
``repro/launch/train_dp.py``; DESIGN.md §12).

    PYTHONPATH=src python -m repro_torch.launch.train_dp --smoke \
        [--device cpu] [--backend gloo|nccl]

Phases:
  1. synthetic task + single-device baseline fit in this process (the
     bit-exactness reference; the default --train-n does NOT divide the
     batch, so the padded-tail masked path runs end to end);
  2. data-parallel fit on ``--devices`` rank processes (one process per
     rank, ``distributed.run_group`` over ``--backend``): the same
     layerwise-greedy schedule through the data-parallel epoch programs;
     ``--smoke`` asserts every rank's final state, the generator's
     included, is bit-identical to the single-device fit, and reports
     images/s;
  3. kill-resume: a fresh DP fit checkpoints every ``--ckpt-every``
     batches and a fault hook raises ``WorkerLost`` at chunk
     ``--kill-at-chunk``; the launcher rebuilds the largest mesh of the
     surviving ranks with ``elastic_mesh`` (one rank is "lost"), starts a
     group of the survivors, restores the latest checkpoint and resumes
     from its cursor; ``--smoke`` asserts the recovered state is STILL
     bit-identical to the uninterrupted run (column-sharded DP is exact
     for any shard count), and the recovery overhead is reported.

Everything runs on ``--device`` (default ``cuda``: rank r on card
``r % card count``; several ranks may share a card under gloo, where they
measure the protocol, not scaling).  The ranks of phases 2 and 3's killed
fit are one group, started before phase 1 so their start-up overlaps it;
the survivors are a second group.  Walls are the slowest rank's: the fit
alone, and for the killed and resumed fits Trainer construction and fit,
as the JAX launcher times them; process start-up is excluded.
``--json PATH`` writes the measured numbers under the JAX launcher's keys.
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--smoke", action="store_true",
                   help="assert bit-exactness + recovery, tiny workload")
    p.add_argument("--devices", type=int, default=2,
                   help="rank processes (data-axis width)")
    p.add_argument("--side", type=int, default=12)
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--classes", type=int, default=5)
    p.add_argument("--train-n", type=int, default=328,
                   help="train samples (default leaves a padded tail)")
    p.add_argument("--test-n", type=int, default=256)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--ckpt-every", type=int, default=2,
                   help="checkpoint cadence in batches for the kill phase")
    p.add_argument("--kill-at-chunk", type=int, default=3,
                   help="which chunk boundary raises the simulated loss")
    p.add_argument("--warmup", action="store_true",
                   help="one untimed fit first (captures outside timings)")
    p.add_argument("--no-single", action="store_true",
                   help="skip the single-device reference (bench mode)")
    p.add_argument("--no-kill", action="store_true",
                   help="skip the kill-resume phase (pure scaling rows)")
    p.add_argument("--json", type=str, default=None,
                   help="write measured numbers to this path")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the state lives (default: the card)")
    p.add_argument("--backend", choices=("gloo", "nccl"), default="gloo",
                   help="the collective backend of the rank groups")
    return p


def snapshot(state) -> dict:
    """A state as numpy arrays of their own: every tensor (``convert``'s
    tree), the clocks' host mirrors and the generator's state."""
    from ..convert import state_to_numpy

    def own(x):
        if isinstance(x, dict):
            return {k: own(v) for k, v in x.items()}
        if isinstance(x, list):
            return [own(v) for v in x]
        return np.array(x) if isinstance(x, np.ndarray) else x

    return own({"state": state_to_numpy(state),
                "t_host": [p.traces.t_host
                           for p in state.projs + (state.readout,)],
                "generator": state.generator.get_state().numpy()})


def snapshots_equal(a, b) -> bool:
    """Whether two ``snapshot`` trees hold the same values bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(snapshots_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(snapshots_equal(u, v)
                                        for u, v in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and np.array_equal(a, b))
    return a == b


def _dp_rank(rank, device, job: dict) -> dict:
    """One rank of a group: the DP fit (timed), then the fit killed at
    ``job["kill_at"]`` (``WorkerLost`` caught: the rank is "lost"), or the
    fit resumed from ``job["resume_dir"]``, each on a mesh of the group's
    ranks."""
    from ..core import Trainer
    from ..distributed import WorkerLost, elastic_mesh
    n = job["n_ranks"]
    mesh = elastic_mesh((n,), ("data",))
    xtr, ytr, xte, yte = job["data"]
    fit_kw = dict(epochs=job["epochs"], batch=job["batch"])
    out: dict = {}
    if job.get("fit"):
        tr = Trainer(job["spec"], seed=0, mesh=mesh, device=device)
        if job.get("warmup"):
            tr.fit(xtr, ytr, **fit_kw)
            tr.reset(seed=0)
        t0 = time.perf_counter()
        stats = tr.fit(xtr, ytr, **fit_kw)
        out["fit"] = {"wall": time.perf_counter() - t0, "stats": stats,
                      "snapshot": snapshot(tr.state),
                      "acc": tr.evaluate(xte, yte, batch=job["batch"])}
    if job.get("kill_dir"):
        chunks = {"n": 0}

        def fault_hook(cursor):
            chunks["n"] += 1
            if chunks["n"] == job["kill_at"]:
                raise WorkerLost(f"simulated device loss at chunk "
                                 f"{chunks['n']} (cursor {cursor})")

        t0 = time.perf_counter()
        tr = Trainer(job["spec"], seed=0, mesh=mesh, device=device)
        try:
            tr.fit(xtr, ytr, **fit_kw, ckpt_dir=job["kill_dir"],
                   ckpt_every_batches=job["ckpt_every"],
                   on_chunk=fault_hook)
            out["killed"] = None
        except WorkerLost as e:
            out["killed"] = {"wall": time.perf_counter() - t0,
                             "message": str(e)}
    if job.get("resume_dir"):
        t0 = time.perf_counter()
        tr = Trainer(job["spec"], seed=0, mesh=mesh, device=device)
        stats = tr.fit(xtr, ytr, **fit_kw, ckpt_dir=job["resume_dir"],
                       ckpt_every_batches=job["ckpt_every"], resume=True)
        out["resumed"] = {"wall": time.perf_counter() - t0,
                          "stats": stats, "snapshot": snapshot(tr.state),
                          "acc": tr.evaluate(xte, yte, batch=job["batch"]),
                          "straggler_events": list(tr.timer.events)}
    return out


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"[train-dp] {msg}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..configs.bcpnn_models import deep_synth_spec
    from ..core import Trainer
    from ..data.synthetic import encode_images, make_synthetic
    from ..distributed import (RankGroup, describe_failure_domains,
                               elastic_mesh, rank_devices)

    spec = deep_synth_spec(side=args.side, depth=args.depth,
                           n_classes=args.classes, backend="torch")
    ds = make_synthetic(args.train_n, args.test_n, args.side, args.classes,
                        seed=0)
    xtr, xte = encode_images(ds.x_train), encode_images(ds.x_test)
    ytr, yte = ds.y_train, ds.y_test
    n_img = len(xtr) * args.epochs * spec.depth
    out = {"devices": args.devices, "train_n": len(xtr),
           "batch": args.batch, "epochs": args.epochs,
           "depth": spec.depth}
    job = {"spec": spec, "data": (xtr, ytr, xte, yte),
           "epochs": args.epochs, "batch": args.batch,
           "ckpt_every": args.ckpt_every, "kill_at": args.kill_at_chunk}

    with tempfile.TemporaryDirectory() as ckpt_dir:
        # ---- phases 2 and 3's kill: one group, started first ----------
        group = RankGroup(
            _dp_rank, args.devices, backend=args.backend,
            device=args.device, args=(dict(
                job, n_ranks=args.devices, fit=True, warmup=args.warmup,
                kill_dir=None if args.no_kill else ckpt_dir),))

        # ---- phase 1: single-device reference --------------------------
        t_single = ref = None
        if not args.no_single:
            tr1 = Trainer(spec, seed=0, device=args.device)
            if args.warmup:
                tr1.fit(xtr, ytr, epochs=args.epochs, batch=args.batch)
                tr1.reset(seed=0)
            t0 = time.perf_counter()
            tr1.fit(xtr, ytr, epochs=args.epochs, batch=args.batch)
            t_single = time.perf_counter() - t0
            ref = snapshot(tr1.state)
            acc1 = tr1.evaluate(xte, yte, batch=args.batch)
            out["single_s"] = t_single
            out["single_images_per_s"] = n_img / t_single
            out["single_acc"] = float(acc1)
            print(f"[train-dp] single-device on {args.device}: "
                  f"{t_single:.2f}s ({n_img / t_single:.0f} img/s), "
                  f"acc {acc1:.3f}", flush=True)

        # ---- phase 2: data-parallel fit on the full mesh ---------------
        ranks = group.join()
        mesh = elastic_mesh((args.devices,), ("data",),
                            devices=rank_devices(args.devices))
        print(f"[train-dp] mesh: {describe_failure_domains(mesh)}")
        fits = [r["fit"] for r in ranks]
        t_dp = max(f["wall"] for f in fits)
        comm = max(f["stats"]["comm_s"] for f in fits)
        acc2 = fits[0]["acc"]
        dp = fits[0]["snapshot"]
        out["dp_s"] = t_dp
        out["dp_images_per_s"] = n_img / t_dp
        out["dp_acc"] = float(acc2)
        if t_single is not None:
            out["scaling_x"] = t_single / t_dp
        replicated = all(snapshots_equal(f["snapshot"], dp) for f in fits)
        print(f"[train-dp] {args.devices}-way DP over {args.backend} on "
              f"{args.device}: {t_dp:.2f}s ({n_img / t_dp:.0f} img/s; "
              f"collectives {comm:.2f}s), acc {acc2:.3f}"
              + (f", scaling {t_single / t_dp:.2f}x" if t_single else "")
              + f"; ranks equal: {replicated}", flush=True)
        _require(replicated, "the ranks' states differ")
        if ref is not None:
            same = snapshots_equal(dp, ref)
            print(f"[train-dp] DP state bit-identical to single-device: "
                  f"{same}")
            if args.smoke:
                _require(same, "DP fit diverged from the single-device fit")
                _require(acc1 == acc2, f"DP accuracy {acc2} != {acc1}")

        # ---- phase 3: kill-resume via elastic_mesh ---------------------
        if not args.no_kill:
            killed = [r["killed"] for r in ranks]
            _require(all(k is not None for k in killed),
                     "fault hook never fired — lower --kill-at-chunk")
            t_killed = max(k["wall"] for k in killed)
            print(f"[train-dp] {killed[0]['message']} after "
                  f"{t_killed:.2f}s")
            # Recovery ladder: largest mesh from the survivors, restore
            # the latest checkpoint, resume from its cursor.
            devs = rank_devices(args.devices)
            survivors = devs[:-1] if args.devices > 1 else devs
            mesh_r = elastic_mesh((args.devices,), ("data",),
                                  devices=survivors)
            print(f"[train-dp] rebuilt mesh from {len(survivors)} "
                  f"survivors: {describe_failure_domains(mesh_r)}")
            resumed = [r["resumed"] for r in RankGroup(
                _dp_rank, mesh_r.size, backend=args.backend,
                device=args.device, args=(dict(
                    job, n_ranks=mesh_r.size,
                    resume_dir=ckpt_dir),)).join()]
            t_resume = max(r["wall"] for r in resumed)
            acc_r = resumed[0]["acc"]
            overhead = t_killed + t_resume - t_dp
            out["kill_resume_s"] = t_killed + t_resume
            out["recovery_overhead_s"] = overhead
            out["resumed_acc"] = float(acc_r)
            same_r = all(snapshots_equal(r["snapshot"], dp)
                         for r in resumed)
            out["resumed_bit_identical"] = bool(same_r)
            print(f"[train-dp] kill-resume on {len(survivors)} device(s): "
                  f"{t_killed + t_resume:.2f}s total "
                  f"({overhead:+.2f}s vs uninterrupted), acc {acc_r:.3f}, "
                  f"bit-identical {same_r}", flush=True)
            if args.smoke:
                _require(same_r, "resumed fit diverged from the "
                                 "uninterrupted run")
                _require(float(acc_r) == float(acc2),
                         f"resumed accuracy {acc_r} != {acc2}")
            events = resumed[0]["straggler_events"]
            if events:
                print(f"[train-dp] straggler events: {len(events)} "
                      f"(last: {events[-1]})")

    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
        print(f"[train-dp] wrote {args.json}")
    print("[train-dp] smoke OK" if args.smoke else "[train-dp] done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
