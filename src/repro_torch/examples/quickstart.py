"""Quickstart: train a BCPNN (MNIST-shaped) end to end, at any depth
(mirrors ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--small] [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.quickstart --depth 2 --backend torch

Runs the full protocol of the paper's §5, generalized to stacks of any
depth: layerwise unsupervised epochs on each stack projection, one
supervised pass on the readout, then inference; reports the per-image
training latency and the accuracy.  ``--backend cuda`` (the default) routes
every projection through the hand-written kernels on the card (their plain
versions on the CPU); ``torch`` runs the plain PyTorch path everywhere.
The data is a class-structured synthetic surrogate with MNIST's shapes
(drop a real mnist.npz under data/ to use actual MNIST).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence

from ..configs.bcpnn_models import MODEL1_MNIST, deep_mnist_spec
from ..core import Trainer
from ..data.synthetic import encode_images, load_or_synthesize
from ..device import resolve_device


def main(argv: Optional[Sequence[str]] = None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="subset + fewer epochs (CI-speed)")
    ap.add_argument("--depth", type=int, default=1,
                    help="number of hidden layers (1 = the paper's Model 1)")
    ap.add_argument("--backend", choices=["torch", "cuda"], default="cuda",
                    help="execution backend for every projection")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ds = load_or_synthesize("mnist")
    n_train = 4096 if args.small else 16384
    epochs = 3 if args.small else 5

    if args.depth == 1:
        cfg = MODEL1_MNIST
        if args.small:
            cfg = dataclasses.replace(cfg, hidden_mc=64, noise_steps=60)
        spec = dataclasses.replace(cfg, backend=args.backend).network_spec()
        desc = f"input 784x2, hidden {cfg.hidden_hc}x{cfg.hidden_mc}"
    else:
        spec = deep_mnist_spec(
            depth=args.depth, backend=args.backend,
            hidden_mc=32 if args.small else 64)
        desc = " -> ".join(f"{p.post.H}x{p.post.M}" for p in spec.projs)
        desc = f"input 784x2, hidden {desc}"

    xt = encode_images(ds.x_train[:n_train])
    yt = ds.y_train[:n_train]
    xe = encode_images(ds.x_test[:2048])
    ye = ds.y_test[:2048]

    print(f"[quickstart] depth={args.depth} backend={args.backend}: {desc}, "
          f"{epochs} unsupervised epochs/layer", flush=True)
    tr = Trainer(spec, seed=0, device=dev)
    t0 = time.time()
    stats = tr.fit(xt, yt, epochs=epochs, batch=128, log=True)
    acc_train = tr.evaluate(xt, yt)
    acc_test = tr.evaluate(xe, ye)
    print(f"[quickstart] total time {time.time()-t0:.1f}s; "
          f"train latency {stats['train_ms_per_img']:.3f} ms/img")
    print(f"[quickstart] train acc {acc_train*100:.1f}%  "
          f"test acc {acc_test*100:.1f}%", flush=True)
    # The 0.85 bar is calibrated to the paper's depth-1 Model 1; greedy
    # deep stacks trade accuracy on this small surrogate for the layered
    # representation, so deeper runs only have to beat chance clearly.
    floor = 0.85 if args.depth == 1 else 0.5
    if not acc_test > floor:
        raise SystemExit(f"[quickstart] test accuracy {acc_test:.4f} is not "
                         f"above {floor}")
    return acc_test


if __name__ == "__main__":
    main()
