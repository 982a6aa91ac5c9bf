"""BCPNNHead on an LM trunk: the paper's technique as a framework feature
(mirrors ``examples/bcpnn_head_on_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.bcpnn_head_on_lm [--device cpu]

A small gemma2-family trunk embeds token sequences; a BCPNN head learns —
online, with the local Hebbian-Bayesian rule, no backprop through the
head — to classify which synthetic 'dialect' generated each sequence.
The trunk is plain PyTorch; on the card the head's steps run the kernels.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from ..configs import get_config, smoke
from ..core.head import (BCPNNHeadConfig, head_predict, head_supervised,
                         head_unsupervised, init_head)
from ..device import resolve_device
from ..models import lm


def make_dialect_batches(vocab, n_classes=4, batch=64, seq=32, steps=30,
                         seed=0):
    """Each 'dialect' draws tokens from its own narrow vocabulary band."""
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        y = rng.integers(0, n_classes, batch)
        lo = (y * (vocab // n_classes))[:, None]
        toks = lo + rng.integers(0, vocab // (2 * n_classes), (batch, seq))
        yield toks.astype(np.int32), y.astype(np.int32)


def main(argv: Optional[Sequence[str]] = None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = smoke(get_config("gemma2-2b")).with_(dtype="float32")
    params = lm.init_params(cfg, 0, dev)

    def features(toks):
        h = lm.forward(params, cfg, torch.from_numpy(toks).to(dev))
        return h.mean(dim=1)  # pooled trunk features (B, d)

    hcfg = BCPNNHeadConfig(feature_dim=cfg.d_model, hidden_hc=16,
                           hidden_mc=16, n_classes=4, alpha=5e-2,
                           noise_steps=30)
    state = init_head(hcfg, 1, dev)

    with torch.no_grad():
        # online semi-supervised stream: unsupervised on every batch,
        # supervised on every fourth (sparse labels)
        for i, (toks, y) in enumerate(make_dialect_batches(cfg.vocab,
                                                           steps=120)):
            f = features(toks)
            state = head_unsupervised(state, hcfg, f)
            if i % 4 == 0:
                state = head_supervised(state, hcfg, f,
                                        torch.from_numpy(y).to(dev))

        correct = total = 0
        for toks, y in make_dialect_batches(cfg.vocab, steps=10, seed=777):
            p = head_predict(state, hcfg, features(toks))[1].cpu().numpy()
            correct += int((p == y).sum())
            total += len(y)
    acc = correct / total
    print(f"[bcpnn-head] online semi-supervised accuracy on LM features: "
          f"{acc*100:.1f}%", flush=True)
    if not acc > 0.7:
        raise SystemExit(f"[bcpnn-head] accuracy {acc:.4f} is not above 0.7")
    return acc


if __name__ == "__main__":
    main()
