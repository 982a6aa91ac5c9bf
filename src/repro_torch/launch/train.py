"""End-to-end training driver of the LM zoo with checkpoint/restart and
straggler logs (mirrors ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        [--smoke] [--steps 50] [--batch 8] [--seq 256] \\
        [--ckpt-dir DIR] [--ckpt-every 25] [--compress-grads] \\
        [--device cuda|cpu]

    torchrun --nproc-per-node N -m repro_torch.launch.train \\
        --mesh single --mesh-shape DxM [...]

It runs on the card unless ``--device cpu`` is given, at the config's
dtype.  ``--mesh local`` (the default) is this process alone;
``--mesh single|multi`` lays the ranks ``torchrun`` starts out as the
production mesh (``launch/mesh.py``), on the axes of the JAX package's
16x16 or 2x16x16 mesh, with ``--mesh-shape`` naming the layout of a group
smaller than a pod.  On a split mesh the parameters, moments and
gradients are DTensors split by the rules (FSDP over ``data``, tensor and
expert parallelism over ``model``) and the tokens split over ``batch``;
rank 0 alone prints and writes the checkpoints, which hold the JAX
on-disk format whatever the mesh.  A restart resumes from the latest
checkpoint in ``--ckpt-dir`` (on any mesh: each rank takes its blocks of
the saved arrays), and the data pipeline reproduces the exact batch
sequence from the step id, so a resumed run takes the uninterrupted run's
steps.
"""
from __future__ import annotations

import argparse
import functools
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config, smoke
from ..convert import lm_leaf_groups
from ..data.pipeline import Prefetcher, TokenStream
from ..distributed.fault import StepTimer, describe_failure_domains
from ..distributed.group import join_torchrun
from ..distributed.sharding import (_rank, make_rules, place_like,
                                    sharding_context)
from ..models import lm
from ..models.params import param_shardings
from ..optim import AdamWConfig, init_error_state, init_opt_state
from .mesh import make_local_mesh, make_production_mesh, parse_mesh_shape
from .steps import make_train_step


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--mesh", choices=["local", "single", "multi"],
                    default="local")
    ap.add_argument("--mesh-shape", default=None,
                    help="DxM (single) or PxDxM (multi): the layout of the "
                         "ranks on the production mesh's axes (default: the "
                         "JAX mesh's 16x16 or 2x16x16)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap.parse_args(argv)


def make_batch_fn(cfg, batch: int, seq: int, seed: int):
    """Host batch of step ``step``: ``TokenStream`` tokens, and patches or
    frames drawn as the JAX driver draws them (``default_rng(step)`` and
    ``default_rng(step + 1)``, float32)."""
    stream = TokenStream(cfg.vocab, seed=seed)

    def make_batch(step):
        b = {"tokens": stream.batch(step, batch, seq)}
        if cfg.vision_patches:
            rng = np.random.default_rng(step)
            b["patches"] = rng.normal(0, 1, (batch, cfg.vision_patches,
                                             cfg.d_model)).astype(np.float32)
        if cfg.enc_layers:
            rng = np.random.default_rng(step + 1)
            b["frames"] = rng.normal(0, 1, (batch, cfg.enc_seq,
                                            cfg.d_model)).astype(np.float32)
        return b

    return make_batch


def production_or_local(mesh: str, shape: Optional[str]):
    """The launchers' ``--mesh``/``--mesh-shape``: the local mesh, or the
    production mesh over the default group's ranks."""
    if mesh == "local":
        if shape is not None:
            raise ValueError("--mesh-shape goes with --mesh single|multi")
        return make_local_mesh()
    return make_production_mesh(multi_pod=(mesh == "multi"),
                                shape=parse_mesh_shape(shape))


def batch_dims(key: str) -> tuple:
    """Logical dims of a batch entry: tokens (B, S); patches and frames
    (B, P, d) split along d as the JAX ``batch_shardings`` say."""
    return ("batch", None) if key == "tokens" else ("batch", None, "embed")


def place_batch(batch: Dict[str, np.ndarray], dev: torch.device
                ) -> Dict[str, torch.Tensor]:
    """A host batch on ``dev``, split over ``batch`` on a split mesh
    (``batch_dims``)."""
    return {k: place_like(torch.from_numpy(v).to(dev), batch_dims(k))
            for k, v in batch.items()}


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke(cfg)
    dev = join_torchrun(args.device)
    mesh = production_or_local(args.mesh, args.mesh_shape)
    lead = _rank() == 0
    say = functools.partial(print, flush=True) if lead else (
        lambda *a, **k: None)
    say(f"[train] arch={cfg.name} mesh={describe_failure_domains(mesh)} "
        f"device={dev}")

    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(1, args.steps // 20))
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    with sharding_context(mesh, make_rules(mesh)):
        params = lm.init_params(cfg, args.seed, dev, train=True)
        groups = lm_leaf_groups(params)
        opt_state = init_opt_state(groups)
        if args.compress_grads:
            opt_state["err"] = init_error_state(groups)
        start_step = 0
        if mgr is not None and mgr.latest_step() is not None:
            start_step = mgr.latest_step()
            mgr.restore(start_step, {"params": params, "opt": opt_state},
                        {"params": param_shardings(params), "opt": None})
            say(f"[train] resumed from step {start_step}")

        step_fn = make_train_step(cfg, opt_cfg,
                                  compress=args.compress_grads)
        make_batch = make_batch_fn(cfg, args.batch, args.seq, args.seed)

        prefetch = Prefetcher(make_batch, start_step)
        timer = StepTimer()
        losses = []
        try:
            for _ in range(start_step, args.steps):
                step_id, batch = prefetch.next()
                batch = place_batch(batch, dev)
                timer.start()
                loss, params, opt_state = step_fn(params, opt_state, batch)
                loss = float(loss)
                dt = timer.stop(step_id)
                losses.append(loss)
                if step_id % args.log_every == 0 or step_id == args.steps - 1:
                    tps = args.batch * args.seq / dt
                    say(f"[train] step {step_id} loss={loss:.4f} "
                        f"{dt*1e3:.0f}ms ({tps:.0f} tok/s)")
                if mgr is not None and (step_id + 1) % args.ckpt_every == 0:
                    mgr.save(step_id + 1, {"params": params,
                                           "opt": opt_state})
        finally:
            prefetch.close()
        if not losses:  # resumed at or past --steps: nothing left to run,
            # and saving here would mislabel step-`start_step` params as
            # a step-`args.steps` checkpoint
            say(f"[train] checkpoint already at step {start_step}; "
                f"no steps to run")
            return
        if mgr is not None:
            mgr.save(args.steps, {"params": params, "opt": opt_state},
                     blocking=True)
        if timer.events:
            say(f"[train] straggler events: {timer.events}")
        say(f"[train] median step {timer.median*1e3:.0f}ms; "
            f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
        # Progress check on windowed means: single-step losses are noisy,
        # and a resumed run may only execute a handful of steps, so the
        # comparison applies only to runs long enough to average over.
        if len(losses) >= 8:
            w = max(1, len(losses) // 4)
            head_loss = float(np.mean(losses[:w]))
            tail_loss = float(np.mean(losses[-w:]))
            if not tail_loss < head_loss:
                raise RuntimeError(f"loss did not decrease ({head_loss:.4f}"
                                   f" -> {tail_loss:.4f})")


if __name__ == "__main__":
    main()
