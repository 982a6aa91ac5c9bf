"""BCPNN serving driver (mirrors ``repro/launch/serve_bcpnn.py``):
train-or-load checkpointed deep networks, serve
an open-loop synthetic request stream through the microbatched multi-model
engine, and report latency/throughput — optionally with the
online-learning mode folding a label stream into the deployed network
(readout-only, or full stack plasticity with in-deployment rewiring)
while traffic flows.

    PYTHONPATH=src python -m repro_torch.launch.serve_bcpnn --smoke \
        [--device cpu]

Everything runs on ``--device`` (default ``cuda``: the card); served
batches replay one CUDA graph per (model, bucket) there.

Phases:
  1. obtain a network — restore from --ckpt-dir when a checkpoint exists
     (the spec rides in the manifest), else train on the synthetic task
     and checkpoint it;
  2. inference-only serving: open-loop Poisson load, p50/p99 + images/s;
  3. online learning (unless --no-online): the readout is re-initialized
     (cold), then RELEARNED from the feedback stream between inference
     microbatches — served accuracy recovers toward the trained baseline
     while requests keep completing (the runtime analogue of switching
     the paper's training bitstream in, without un-deploying inference);
  4. multi-model + structural plasticity (--smoke, or --ckpt given): two
     checkpointed models behind ONE admission front under a 10:1 skewed
     Poisson mix — per-model fairness — with stack-projection learning
     and the struct_every rewire cold path running on the deployed
     patchy model (receptive fields keep refining in deployment);
  5. router failover: not ported yet (ROADMAP.md queue A item 6-rest).
     ``--router`` asks for it and raises ``NotImplementedError``;
     ``--smoke`` implies ``--no-router`` until then, and says so.

Passing ``--ckpt DIR`` (repeatable) instead serves the given checkpoint
directories as a multi-model deployment directly (names = dir basenames).
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import tempfile

import numpy as np

from ..checkpoint import CheckpointManager, load_model, load_models
from ..configs.bcpnn_models import deep_synth_spec
from ..core import Trainer, evaluate_padded, init_projection
from ..data.synthetic import encode_images, make_synthetic
from ..device import make_generator, resolve_device
from ..serve import (
    BCPNNService, StreamSpec, run_multi_open_loop, run_open_loop,
)

ROUTER_NOT_PORTED = ("phase 5 (the BCPNNRouter failover) is not ported yet "
                     "(ROADMAP.md queue A item 6-rest)")


def _report(tag: str, snap: dict, extra: str = "") -> None:
    robust = ""
    if snap.get("rejected") or snap.get("shed") or snap.get("failed"):
        robust = (f", {snap['rejected']:.0f} rejected / "
                  f"{snap['shed']:.0f} shed / {snap['failed']:.0f} failed")
    print(f"[serve-bcpnn] {tag}: {snap['completed']:.0f}/"
          f"{snap['submitted']:.0f} served, {snap['images_per_s']:.1f} img/s, "
          f"p50 {snap['p50_ms']:.1f}ms p99 {snap['p99_ms']:.1f}ms, "
          f"batch occupancy {snap['batch_occupancy']*100:.0f}%, "
          f"{snap['learn_steps']:.0f} learn steps{robust}{extra}")


def _accounted(snap: dict) -> bool:
    """Robustness-aware availability check: every admitted request must
    have RESOLVED (served, shed on deadline, or failed typed) — nothing
    silently dropped."""
    return (snap["completed"] + snap["shed"] + snap["failed"]
            == snap["submitted"])


def _pool_for(spec, n: int, seed: int):
    """(x_pool, y_pool) matching one model's input geometry: the synthetic
    task when the input is a square complement-pair image encoding, else
    a random rate pool (latency-only traffic)."""
    h = spec.input_geom.H
    side = int(round(math.sqrt(h)))
    if side * side == h and spec.input_geom.M == 2:
        ds = make_synthetic(n, n, side, spec.n_classes, seed=seed,
                            max_shift=1)
        return encode_images(ds.x_test), ds.y_test
    rng = np.random.default_rng(seed)
    hc = rng.random((n, spec.input_geom.H,
                     spec.input_geom.M)).astype(np.float32)
    hc /= hc.sum(axis=-1, keepdims=True)   # per-HC rate distributions
    x = hc.reshape(n, spec.input_geom.N)
    y = rng.integers(0, spec.n_classes, size=n).astype(np.int64)
    return x, y


def _deadline_s(args):
    return args.deadline_ms * 1e-3 if args.deadline_ms is not None else None


def serve_checkpoints(args) -> None:
    """--ckpt mode: host every given checkpoint dir in one engine and
    drive a uniform-rate multi-model mix."""
    models = load_models(args.ckpt, seed=args.seed, device=args.device)
    svc = BCPNNService.multi(
        models, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        online_learning=not args.no_online, learn_stack=args.learn_stack,
        feedback_batch=args.feedback_batch,
        infer_dtype=args.infer_dtype, max_queue=args.max_queue,
        default_deadline_s=_deadline_s(args)).start()
    streams = {}
    for i, (name, (_, spec)) in enumerate(models.items()):
        x, y = _pool_for(spec, max(64, args.requests), args.seed + i)
        streams[name] = StreamSpec(x_pool=x, y_pool=y,
                                   rate_hz=args.rate / len(models))
    reports = run_multi_open_loop(svc, streams,
                                  n_requests=args.requests, seed=args.seed)
    svc.stop()
    snap = svc.snapshot()
    per = snap.get("per_model", {list(models)[0]: snap})
    for name, rep in reports.items():
        _report(f"model {name!r}", per[name],
                extra=f", served accuracy {rep.accuracy()*100:.1f}%")
    _report("aggregate", snap)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="small config + assertions; what CI runs")
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore from here if a checkpoint exists, else "
                         "train and save here (default: temp dir)")
    ap.add_argument("--ckpt", action="append", default=None,
                    help="serve this pre-trained checkpoint directory as "
                         "one model of a multi-model deployment "
                         "(repeatable; model name = dir basename); "
                         "skips the train/eval phases")
    ap.add_argument("--learn-stack", action="store_true",
                    help="with online learning: deterministic plasticity "
                         "on the stack projections (+ struct_every "
                         "rewiring) in deployment, not just the readout")
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--backend", choices=["torch", "cuda"], default="cuda")
    ap.add_argument("--device", default="cuda",
                    help="where the networks live and serve (default: "
                         "cuda, the card; cpu runs the plain versions)")
    ap.add_argument("--nact", type=int, default=None,
                    help="patchy connectivity budget for the input "
                         "projection: with backend=cuda the serving "
                         "infer path reads only the live pre-blocks "
                         "(kernels/patchy.py)")
    ap.add_argument("--compact", action="store_true",
                    help="with --nact: train and serve the input "
                         "projection in the compact-resident (Hj, K, Mj) "
                         "state layout (scatter-free patchy plasticity, "
                         "DESIGN.md §7)")
    ap.add_argument("--side", type=int, default=8)
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--hidden-hc", type=int, default=8)
    ap.add_argument("--hidden-mc", type=int, default=16)
    ap.add_argument("--train-n", type=int, default=768)
    ap.add_argument("--test-n", type=int, default=256)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--requests", type=int, default=128)
    ap.add_argument("--rate", type=float, default=200.0,
                    help="offered open-loop arrival rate (req/s)")
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request queueing deadline: requests still "
                         "queued past it are shed (DeadlineExceeded) "
                         "before any compute; default = no deadline")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="per-model admission-queue bound: submits past "
                         "it are rejected with a typed Overloaded "
                         "instead of queueing unboundedly; default = "
                         "unbounded")
    ap.add_argument("--no-online", action="store_true",
                    help="skip the online-learning phase")
    ap.add_argument("--no-multi", action="store_true",
                    help="skip the multi-model + rewire phase in --smoke")
    ap.add_argument("--no-router", action="store_true",
                    help="skip the replicated-router failover phase "
                         "(implied by --smoke until the router is ported)")
    ap.add_argument("--router", action="store_true",
                    help="run the replicated-router failover phase: not "
                         "ported yet, raises NotImplementedError")
    ap.add_argument("--feedback-frac", type=float, default=0.8)
    ap.add_argument("--feedback-batch", type=int, default=16)
    ap.add_argument("--infer-dtype", choices=["fp32", "bf16", "int8"],
                    default=None,
                    help="serving precision override for every hosted "
                         "model: weights are cast (bf16) or per-HC "
                         "quantized (int8) from the fp32 state at fold "
                         "boundaries; default honors each checkpoint "
                         "manifest's own infer_dtype tag")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    args.device = str(resolve_device(args.device))
    if args.router and not args.no_router:
        raise NotImplementedError(ROUTER_NOT_PORTED)
    if args.smoke and not args.no_router:
        print(f"[serve-bcpnn] --smoke implies --no-router: "
              f"{ROUTER_NOT_PORTED}")
        args.no_router = True

    if args.ckpt:
        serve_checkpoints(args)
        return
    if args.compact and not args.nact:
        raise SystemExit("--compact requires --nact (only nact-budgeted "
                         "projections have a compact form)")
    ds = make_synthetic(args.train_n, args.test_n, args.side, args.classes,
                        seed=3, max_shift=1)
    xt, xe = encode_images(ds.x_train), encode_images(ds.x_test)
    ckpt_dir = args.ckpt_dir or os.path.join(
        tempfile.mkdtemp(prefix="bcpnn_serve_"), "ckpt")

    # ---- phase 1: obtain a checkpointed network -------------------------
    mgr = CheckpointManager(ckpt_dir)
    step = mgr.latest_step()
    if step is None:
        nact = ([args.nact] + [None] * (args.depth - 1)
                if args.nact else None)
        spec = deep_synth_spec(side=args.side, depth=args.depth,
                               n_classes=args.classes,
                               hidden_hc=args.hidden_hc,
                               hidden_mc=args.hidden_mc,
                               nact=nact,
                               patchy_traces=args.compact,
                               compact=args.compact,
                               # patchy receptive fields must refine toward
                               # high-MI inputs or they stay random init
                               struct_every=25 if args.nact else 0,
                               backend=args.backend)
        print(f"[serve-bcpnn] no checkpoint under {ckpt_dir}; training "
              f"depth-{spec.depth} {args.backend} network "
              f"({args.epochs} epochs x {args.train_n} images)")
        tr = Trainer(spec, seed=args.seed, device=args.device)
        tr.fit(xt, ds.y_train, epochs=args.epochs, batch=args.batch)
        tr.save(ckpt_dir)
        step = mgr.latest_step()
    try:
        state, spec, step = load_model(ckpt_dir, seed=args.seed,
                                       device=args.device)
    except ValueError as e:
        raise SystemExit(str(e))
    if args.compact and not any(p.compact for p in spec.projs):
        # The spec comes from the checkpoint manifest, not the CLI flags:
        # serving a pre-existing dense checkpoint with --compact would
        # silently run the dense layout.
        raise SystemExit(
            f"--compact: checkpoint under {ckpt_dir} stores a dense-layout "
            f"network; migrate it first (python -m "
            f"repro_torch.checkpoint.migrate) or point "
            f"--ckpt-dir at an empty directory to train a compact one")
    print(f"[serve-bcpnn] restored step {step} from {ckpt_dir} "
          f"(depth {spec.depth}, backends "
          f"{[p.backend for p in spec.projs] + [spec.readout.backend]})")
    acc_base = evaluate_padded(state, spec, xe, ds.y_test, args.batch)
    print(f"[serve-bcpnn] checkpoint eval accuracy: {acc_base*100:.1f}%")

    # ---- phase 2: inference-only serving --------------------------------
    svc = BCPNNService(state, spec, max_batch=args.max_batch,
                       max_wait_ms=args.max_wait_ms,
                       infer_dtype=args.infer_dtype,
                       max_queue=args.max_queue,
                       default_deadline_s=_deadline_s(args)).start()
    rep = run_open_loop(svc, xe, ds.y_test, n_requests=args.requests,
                        rate_hz=args.rate, seed=args.seed)
    svc.stop()
    snap = svc.snapshot()
    _report("inference", snap,
            extra=f", served accuracy {rep.accuracy()*100:.1f}%")
    if args.smoke:
        assert _accounted(snap), f"requests silently dropped: {snap}"
        if args.deadline_ms is None and args.max_queue is None:
            assert snap["completed"] == snap["submitted"], "dropped requests"
        assert snap["p99_ms"] > 0, "no latency recorded"

    # ---- phase 3: online learning under live traffic --------------------
    if not args.no_online:
        cold = dataclasses.replace(
            state, readout=init_projection(
                spec.readout, make_generator(args.seed + 99, state.device)))
        acc_cold = evaluate_padded(cold, spec, xe, ds.y_test, args.batch)
        svc2 = BCPNNService(cold, spec, max_batch=args.max_batch,
                            max_wait_ms=args.max_wait_ms,
                            online_learning=True,
                            feedback_batch=args.feedback_batch,
                            infer_dtype=args.infer_dtype,
                            max_queue=args.max_queue,
                            default_deadline_s=_deadline_s(args)).start()
        rep2 = run_open_loop(svc2, xe, ds.y_test, n_requests=args.requests,
                             rate_hz=args.rate, seed=args.seed + 1,
                             feedback_frac=args.feedback_frac,
                             fb_x=xt, fb_y=ds.y_train)
        svc2.stop()
        snap2 = svc2.snapshot()
        acc_online = evaluate_padded(svc2.state, spec, xe, ds.y_test,
                                     args.batch)
        early, late = rep2.accuracy(0, 0.3), rep2.accuracy(0.7, 1.0)
        _report("online-learning", snap2,
                extra=f", served accuracy {early*100:.1f}% (early) -> "
                      f"{late*100:.1f}% (late)")
        print(f"[serve-bcpnn] readout eval accuracy: cold {acc_cold*100:.1f}% "
              f"-> after feedback {acc_online*100:.1f}% "
              f"(trained baseline {acc_base*100:.1f}%)")

        if args.smoke:
            assert _accounted(snap2), f"requests silently dropped: {snap2}"
            if args.deadline_ms is None and args.max_queue is None:
                assert snap2["completed"] == snap2["submitted"], \
                    "online learning degraded availability (dropped requests)"
            assert snap2["learn_steps"] > 0, "no learn steps folded"
            # Recovery is bounded by what the frozen representation
            # supports: require the online readout to close a third of the
            # gap between the cold readout and the trained baseline (a
            # fixed +10pt bar is unreachable for configs whose baseline
            # sits near the cold accuracy, e.g. tightly nact-budgeted
            # smoke stacks).
            floor = acc_cold + 0.3 * max(0.0, acc_base - acc_cold)
            assert acc_online > floor, (
                f"online learning did not measurably improve the readout "
                f"({acc_cold:.3f} -> {acc_online:.3f}, needed > {floor:.3f} "
                f"toward the {acc_base:.3f} baseline)")

    # ---- phase 4: multi-model serving + in-deployment rewiring ----------
    if args.smoke and not args.no_multi:
        # Second tenant: a quickly-trained patchy compact network with a
        # SHORT rewire period, so structural plasticity demonstrably runs
        # while the engine serves both models from one admission front.
        spec_p = deep_synth_spec(side=args.side, depth=1,
                                 n_classes=args.classes, hidden_hc=4,
                                 hidden_mc=8,
                                 nact=[max(2, args.side * args.side // 2)],
                                 patchy_traces=True, compact=True,
                                 struct_every=5, backend=args.backend)
        tr_p = Trainer(spec_p, seed=args.seed + 5, device=args.device)
        tr_p.fit(xt, ds.y_train, epochs=2, batch=args.batch)
        t_before = tr_p.state.projs[0].traces.t_host
        msvc = BCPNNService.multi(
            {"dense": (state, spec), "patchy": (tr_p.state, spec_p)},
            max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
            online_learning=True, learn_stack=True,
            feedback_batch=8, infer_dtype=args.infer_dtype,
            max_queue=args.max_queue,
            default_deadline_s=_deadline_s(args)).start()
        reports = run_multi_open_loop(
            msvc,
            {"dense": StreamSpec(xe, ds.y_test, rate_hz=args.rate),
             "patchy": StreamSpec(xe, ds.y_test, rate_hz=args.rate / 10)},
            n_requests=args.requests, seed=args.seed + 2)
        # A deterministic feedback burst large enough to cross several
        # struct_every boundaries on the patchy model's trace clock.
        for i in range(6 * 8):
            j = i % len(xt)
            msvc.feedback(xt[j], int(ds.y_train[j]), model="patchy")
        msvc.stop()
        msnap = msvc.snapshot()
        for name in ("dense", "patchy"):
            _report(f"multi-model {name!r}", msnap["per_model"][name])
        served_p = msvc.model_state("patchy")
        t_after = served_p.projs[0].traces.t_host
        msvc.revalidate()  # mask/table invariants hold after rewires
        assert _accounted(msnap), f"requests silently dropped: {msnap}"
        if args.deadline_ms is None and args.max_queue is None:
            assert msnap["completed"] == msnap["submitted"], \
                "multi-model serving dropped requests"
        for name, rep_m in reports.items():
            assert len(rep_m.results) > 0, f"model {name!r} starved"
        assert msnap["per_model"]["patchy"]["learn_steps"] >= 6, msnap
        assert t_after > t_before, "stack plasticity did not advance"
        assert t_after // 5 > t_before // 5, \
            "no struct_every boundary crossed: rewire cannot have run"
        print("[serve-bcpnn] multi-model + rewire phase OK")

    if args.smoke:
        print("[serve-bcpnn] smoke OK")


if __name__ == "__main__":
    main()
