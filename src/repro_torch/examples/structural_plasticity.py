"""Fig. 5 analogue: watch a hypercolumn's receptive field refine itself
(mirrors ``examples/structural_plasticity.py``).

    PYTHONPATH=src python -m repro_torch.examples.structural_plasticity [--device cpu]

Trains Model-1-shaped layers with structural plasticity enabled and prints
an ASCII rendering of one hidden HC's receptive field (active input
pixels) as it evolves from random to information-driven, plus the
captured-MI curve.  ``--steps`` cuts the run (CPU tests); the default is
the reference example's 192 steps of 128 rows.
"""
from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core import (BCPNNConfig, init_deep, mutual_information,
                    unsupervised_layer_step)
from ..data.synthetic import encode_images, load_or_synthesize
from ..device import resolve_device

ROWS, BATCH, EVERY = 8192, 128, 48  # data rows, batch, steps a snapshot


def render_rf(mask_col: np.ndarray, side: int) -> str:
    rf = mask_col.reshape(side, side)
    return "\n".join("".join("#" if v else "." for v in row) for row in rf)


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--steps", type=int, default=3 * ROWS // BATCH,
                    help="unsupervised steps of 128 rows")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ds = load_or_synthesize("mnist")
    side = 28
    cfg = BCPNNConfig(input_hc=side * side, input_mc=2, hidden_hc=16,
                      hidden_mc=32, n_classes=10, nact_hi=196, alpha=5e-3,
                      support_noise=3.0, noise_steps=200, struct_every=16)
    x = torch.from_numpy(encode_images(ds.x_train[:ROWS])).to(dev)
    spec = cfg.network_spec()
    state = init_deep(spec, 0, dev)

    snapshots, mi_curve = [], []
    with torch.no_grad():
        for k in range(args.steps):
            i = (k * BATCH) % ROWS
            state = unsupervised_layer_step(state, spec, x[i:i + BATCH], 0,
                                            donate=True)
            if k % EVERY == 0:
                proj = state.projs[0]
                mi = mutual_information(proj.traces, side * side, 2,
                                        cfg.hidden_hc, cfg.hidden_mc)
                mi_curve.append(float((mi * proj.mask).sum()))
                snapshots.append(proj.mask[:, 0].cpu().numpy().copy())

    print("[struct] receptive field of hidden HC 0, early vs late:")
    print(render_rf(snapshots[0], side))
    print("   ...   ")
    print(render_rf(snapshots[-1], side))
    print(f"[struct] captured MI over time: "
          f"{[f'{v:.2f}' for v in mi_curve]}")
    changed = int(np.sum(snapshots[0] != snapshots[-1]))
    print(f"[struct] rewired {changed} connections for HC 0", flush=True)
    if not mi_curve[-1] >= mi_curve[0]:
        raise SystemExit(f"[struct] rewiring lost MI: {mi_curve[0]:.4f} -> "
                         f"{mi_curve[-1]:.4f}")
    return mi_curve


if __name__ == "__main__":
    main()
