"""The paper's medical use-cases: Pneumonia and Breast (MedMNIST-shaped),
Table-1 Models 2 and 3 (mirrors ``examples/medical.py``).

    PYTHONPATH=src python -m repro_torch.examples.medical [--device cpu]

Offline surrogates with the exact Table-1 configurations (drop real
pneumonia.npz / breast.npz under data/ to use MedMNIST); on the card every
step runs the kernels.  ``--train-rows``, ``--test-rows`` and the epoch
options cut the run to size (CPU tests); the defaults are the reference
example's protocol: batch 64, 20 epochs for pneumonia and 30 for breast,
evaluation batch 64 (52 for breast).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

from ..configs.bcpnn_models import BCPNN_MODELS
from ..core import Trainer
from ..data.synthetic import encode_images, load_or_synthesize
from ..device import resolve_device

# the reference example's accuracy floors (the paper reports 85.3 % and
# 80.1 % on the real MedMNIST sets)
FLOORS = {"model2-pneumonia": 0.8, "model3-breast": 0.7}


def run(model_name: str, epochs: int, device, train_rows: Optional[int] = None,
        test_rows: Optional[int] = None) -> float:
    """Fit one preset on its dataset and return its test accuracy."""
    cfg, dataset, paper_epochs = BCPNN_MODELS[model_name]
    ds = load_or_synthesize(dataset)
    xt = encode_images(ds.x_train[:train_rows])
    yt = ds.y_train[:train_rows]
    xe = encode_images(ds.x_test[:test_rows])
    ye = ds.y_test[:test_rows]
    print(f"[medical] {model_name}: {len(xt)} train / {len(xe)} test, "
          f"{epochs} epochs (paper: {paper_epochs})", flush=True)
    tr = Trainer(cfg, seed=0, device=device)
    t0 = time.time()
    stats = tr.fit(xt, yt, epochs=epochs, batch=64)
    acc = tr.evaluate(xe, ye, batch=52 if dataset == "breast" else 64)
    print(f"[medical] {model_name}: test acc {acc*100:.1f}% "
          f"({time.time()-t0:.1f}s, {stats['train_ms_per_img']:.3f} ms/img)",
          flush=True)
    return acc


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--epochs-pneumonia", type=int, default=20)
    ap.add_argument("--epochs-breast", type=int, default=30)
    ap.add_argument("--train-rows", type=int, default=None,
                    help="fit on the first N training rows of each set")
    ap.add_argument("--test-rows", type=int, default=None,
                    help="evaluate on the first N test rows of each set")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rows = dict(train_rows=args.train_rows, test_rows=args.test_rows)
    accs = {"model2-pneumonia": run("model2-pneumonia",
                                    args.epochs_pneumonia, dev, **rows),
            "model3-breast": run("model3-breast", args.epochs_breast, dev,
                                 **rows)}
    low = {k: a for k, a in accs.items() if not a > FLOORS[k]}
    if low:
        raise SystemExit("[medical] test accuracy not above the floor: "
                         + ", ".join(f"{k} {a:.4f} <= {FLOORS[k]}"
                                     for k, a in low.items()))
    return accs


if __name__ == "__main__":
    main()
