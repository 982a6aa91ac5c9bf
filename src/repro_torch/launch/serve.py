"""Batched serving launcher of the LM zoo: prefill a batch of prompts,
decode greedily (mirrors ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        [--smoke] [--batch 4] [--prompt-len 32] [--gen 16] \\
        [--device cuda|cpu]

    torchrun --nproc-per-node N -m repro_torch.launch.serve \\
        --mesh single --mesh-shape DxM [...]

It runs on the card unless ``--device cpu`` is given, at the config's
dtype.  The trunk is plain PyTorch.  ``--mesh single|multi`` (with
``--mesh-shape``, as ``launch/train.py`` takes them) splits the model
over the ranks ``torchrun`` starts: parameters and caches are DTensors,
the prompts split over ``batch``, and rank 0 alone prints.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..configs import get_config, smoke
from ..data.pipeline import TokenStream
from ..distributed.group import join_torchrun
from ..distributed.sharding import (_rank, full_value, make_rules,
                                    sharding_context)
from ..models import lm
from .steps import make_prefill_step, make_serve_step
from .train import place_batch, production_or_local


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--mesh", choices=["local", "single", "multi"],
                    default="local")
    ap.add_argument("--mesh-shape", default=None,
                    help="DxM (single) or PxDxM (multi)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke(cfg)
    dev = join_torchrun(args.device)
    mesh = production_or_local(args.mesh, args.mesh_shape)
    seq_len = args.prompt_len + args.gen
    say = print if _rank() == 0 else (lambda *a, **k: None)

    with sharding_context(mesh, make_rules(mesh)), torch.no_grad():
        params = lm.init_params(cfg, args.seed, dev)
        stream = TokenStream(cfg.vocab, seed=args.seed)
        host = {"tokens": stream.batch(0, args.batch, args.prompt_len)}
        if cfg.enc_layers:
            host["frames"] = np.random.default_rng(0).normal(
                0, 1, (args.batch, cfg.enc_seq, cfg.d_model)).astype(
                    np.float32)
        if cfg.vision_patches:
            host["patches"] = np.random.default_rng(1).normal(
                0, 1, (args.batch, cfg.vision_patches, cfg.d_model)).astype(
                    np.float32)
        placed = place_batch(host, dev)
        prompts = placed["tokens"]
        frames, patches = placed.get("frames"), placed.get("patches")

        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = make_prefill_step(cfg, seq_len)(
            params, {"tokens": prompts, "patches": patches, "frames": frames})
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        step_fn = make_serve_step(cfg)
        tokens = torch.argmax(logits, -1)
        out = [tokens]
        t0 = time.perf_counter()
        for _ in range(args.gen - 1):
            logits, cache = step_fn(params, cache, tokens)
            tokens = torch.argmax(logits, -1)
            out.append(tokens)
        _sync(dev)
        t_decode = time.perf_counter() - t0
        gen = full_value(torch.stack(out, 1)).cpu().numpy()
        say(f"[serve] prefill {args.batch}x{args.prompt_len} in "
              f"{t_prefill*1e3:.1f}ms; decode {args.gen - 1} steps in "
              f"{t_decode*1e3:.1f}ms "
              f"({(args.gen - 1) * args.batch / max(t_decode, 1e-9):.1f} tok/s)"
              f" on {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}",
              flush=True)
        say(f"[serve] sample continuation: {gen[0][:12].tolist()}",
            flush=True)
        # gen holds integer token ids; the health check is on the final
        # decode step's logits
        if not bool(torch.isfinite(full_value(logits)).all()):
            raise RuntimeError("non-finite logits")


if __name__ == "__main__":
    main()
