"""Streaming trainer for deep BCPNN, single device (mirrors
``repro/core/trainer.py``).

The paper's semi-unsupervised protocol, at any depth: for each stack
projection in turn, N epochs of unsupervised learning (lower layers frozen
while a layer trains), then ONE supervised pass on the readout, then
inference.  Epochs are Python loops over batches that stay on the device;
nothing here reads a value back to the host inside a loop.

The constructor and ``fit`` take the JAX trainer's arguments in its order;
``device`` is a keyword of the port's own.  Not ported yet: the
data-parallel fit (``mesh=``, ``data_axis=``) and mid-fit checkpoints,
resume and the per-chunk callback (``ckpt_dir=``, ``ckpt_every_batches=``,
``resume=``, ``on_chunk=``); any value other than the default raises
``NotImplementedError`` (ROADMAP.md queue A items 7 and 3).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .bcpnn_layer import forward
from .network import (
    DeepState,
    as_spec,
    infer,
    init_deep,
    supervised_readout_step,
    train_projection_step,
)


def _batchify_padded(x: np.ndarray, batch: int):
    """Zero-pad to a whole number of batches; also return the (nb, B)
    validity mask marking genuine rows."""
    n = x.shape[0]
    nb = max(1, -(-n // batch))
    pad = nb * batch - n
    if pad:
        x = np.concatenate(
            [x, np.zeros((pad, *x.shape[1:]), x.dtype)], axis=0)
    valid = (np.arange(nb * batch) < n).astype(np.float32)
    return (x.reshape(nb, batch, *x.shape[1:]),
            valid.reshape(nb, batch))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def evaluate_padded(state: DeepState, spec_or_cfg, x: np.ndarray,
                    y: np.ndarray, batch: int = 128) -> float:
    """Accuracy of ``state`` over the FULL eval set: the tail is
    zero-padded to a whole batch and masked out of the mean, not dropped."""
    if len(x) != len(y):
        raise ValueError(f"x has {len(x)} samples but y has {len(y)} labels")
    spec = as_spec(spec_or_cfg)
    dev = state.device
    xs_np, valid_np = _batchify_padded(np.asarray(x, np.float32), batch)
    ys_np, _ = _batchify_padded(np.asarray(y, np.int32), batch)
    xs = torch.from_numpy(xs_np).to(dev)
    ys = torch.from_numpy(ys_np).to(dev)
    valid = torch.from_numpy(valid_np).to(dev)
    correct = torch.zeros((), dtype=torch.float32, device=dev)
    for b in range(xs.shape[0]):
        _, pred = infer(state, spec, xs[b], valid=valid[b])
        correct += ((pred == ys[b]).to(torch.float32) * valid[b]).sum()
    total = max(float(valid_np.sum()), 1.0)
    return float(correct.item()) / total


class Trainer:
    """End-to-end trainer mirroring the paper's experimental protocol.

    Accepts a ``BCPNNConfig`` (the paper's depth-1 network) or a
    ``NetworkSpec`` of any depth; ``epochs`` in ``fit`` applies per stack
    projection.  The state lives on ``device`` (keyword only): the card
    unless the caller passes ``device="cpu"``; with no card visible and no
    explicit CPU it raises.
    """

    def __init__(self, cfg, seed: int = 0, mesh=None,
                 data_axis: str = "data", *, device: DeviceLike = None):
        if mesh is not None or data_axis != "data":
            raise NotImplementedError(
                "Trainer(mesh=..., data_axis=...): the data-parallel fit is "
                "not ported yet (ROADMAP.md queue A item 7)")
        self.cfg = cfg
        self.spec = as_spec(cfg)
        self.device = resolve_device(device)
        self.state = init_deep(self.spec, seed, self.device)

    def fit(
        self,
        x_train: np.ndarray,
        y_train: np.ndarray,
        epochs: int,
        batch: int = 128,
        log: bool = False,
        ckpt_dir: Optional[str] = None,
        ckpt_every_batches: int = 0,
        resume: bool = False,
        on_chunk: Optional[Callable] = None,
    ) -> Dict[str, float]:
        """Layerwise unsupervised epochs + one supervised pass.

        The tail batch is zero-padded and masked, never dropped: it alone
        takes the masked step, which divides its stats by the genuine row
        count; every whole batch takes the plain step.  (The JAX trainer's
        scanned epoch needs one program, so it masks every batch of such a
        fit; the numbers differ only by fp32 rounding.)  Returns the JAX
        trainer's timing keys; ``straggler_events`` is always 0 (the
        per-chunk step timer belongs to the unported checkpointed fit).
        """
        if ckpt_dir is not None or ckpt_every_batches or resume \
                or on_chunk is not None:
            raise NotImplementedError(
                "Trainer.fit(ckpt_dir=, ckpt_every_batches=, resume=, "
                "on_chunk=): mid-fit checkpoints, resume and the per-chunk "
                "callback are not ported yet (ROADMAP.md queue A item 3)")
        dev = self.device
        xs_np, valid_np = _batchify_padded(np.asarray(x_train, np.float32),
                                           batch)
        ys_np, _ = _batchify_padded(np.asarray(y_train, np.int32), batch)
        # only the last batch can hold pad rows
        tail = xs_np.shape[0] - 1 if float(valid_np.min()) < 1.0 else -1
        xs = torch.from_numpy(xs_np).to(dev)
        ys = torch.from_numpy(ys_np).to(dev)
        valid = torch.from_numpy(valid_np).to(dev)
        nb = xs.shape[0]

        t0 = time.perf_counter()
        # ``cur`` holds the dataset's rates at the current layer's input,
        # computed once per greedy phase (the layers below are frozen).
        cur = xs
        for layer in range(self.spec.depth):
            for e in range(epochs):
                for b in range(nb):
                    self.state = train_projection_step(
                        self.state, self.spec, cur[b], layer,
                        valid=valid[b] if b == tail else None)
                if log:
                    print(f"  layer {layer + 1}/{self.spec.depth} "
                          f"unsupervised epoch {e + 1}/{epochs} done")
            if layer + 1 < self.spec.depth:
                proj, pspec = self.state.projs[layer], self.spec.projs[layer]
                cur = torch.stack([forward(proj, pspec, cur[b])
                                   for b in range(nb)])
        _sync(dev)
        t1 = time.perf_counter()
        for b in range(nb):
            self.state = supervised_readout_step(
                self.state, self.spec, xs[b], ys[b],
                valid=valid[b] if b == tail else None)
        _sync(dev)
        t2 = time.perf_counter()
        n_img = int(valid_np.sum())
        return {
            "unsup_s": t1 - t0,
            "sup_s": t2 - t1,
            "train_ms_per_img": 1e3 * (t1 - t0)
            / max(1, n_img * epochs * self.spec.depth),
            "straggler_events": 0.0,
        }

    def evaluate(self, x: np.ndarray, y: np.ndarray,
                 batch: int = 128) -> float:
        """Accuracy over the FULL eval set (padded, masked tail)."""
        return evaluate_padded(self.state, self.spec, x, y, batch)

    def predict(self, x: np.ndarray) -> np.ndarray:
        xt = torch.from_numpy(np.asarray(x, np.float32)).to(self.device)
        _, pred = infer(self.state, self.spec, xt)
        return pred.cpu().numpy()
