"""Surrogate images of the paper's shapes, made on the device from a seed.

A torch copy of the program's ``make_synthetic``: each class is a smooth
random prototype image, contrast-stretched; a sample is its class's
prototype, shifted by up to ``max_shift`` pixels each way (cyclically),
plus Gaussian pixel noise of standard deviation ``noise``, clipped to
[0, 1].  Every split shares the prototypes.  Images are encoded as the
program's input populations: pixel p becomes the hypercolumn
(x_p, 1 - x_p).  The draws come from one ``torch.Generator`` on the
device, in a few large calls, so every seed makes the same sizes.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def _smooth(img: torch.Tensor, iters: int) -> torch.Tensor:
    for _ in range(iters):
        img = (img + torch.roll(img, 1, 1) + torch.roll(img, -1, 1)
               + torch.roll(img, 1, 2) + torch.roll(img, -1, 2)) / 5.0
    return img


def encode(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W) images -> (N, 2·H·W) complement-pair rates."""
    flat = x.reshape(x.shape[0], -1)
    return torch.stack([flat, 1.0 - flat], dim=-1).reshape(x.shape[0], -1)


def surrogate(splits: Sequence[int], side: int, n_classes: int, noise: float,
              max_shift: int, gen: torch.Generator
              ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(encoded rows, int32 labels) of each split, on ``gen``'s device."""
    dev = gen.device
    protos = _smooth(torch.rand((n_classes, side, side), generator=gen,
                                device=dev), 3)
    mu = protos.mean(dim=(1, 2), keepdim=True)
    sd = protos.std(dim=(1, 2), correction=0, keepdim=True) + 1e-9
    protos = torch.clamp(0.5 + 0.35 * (protos - mu) / sd, 0.0, 1.0)
    grid = torch.arange(side, device=dev)
    out = []
    for n in splits:
        y = torch.randint(0, n_classes, (n,), generator=gen, device=dev)
        shift = torch.randint(-max_shift, max_shift + 1, (n, 2),
                              generator=gen, device=dev)
        rows = (grid[None, :] - shift[:, 0:1]) % side
        cols = (grid[None, :] - shift[:, 1:2]) % side
        x = protos[y[:, None, None], rows[:, :, None], cols[:, None, :]]
        x = x + noise * torch.randn((n, side, side), generator=gen,
                                    device=dev)
        out.append((encode(torch.clamp(x, 0.0, 1.0)), y.to(torch.int32)))
    return out
