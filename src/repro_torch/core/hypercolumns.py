"""Hypercolumn/minicolumn geometry and divisive normalization
(mirrors ``repro/core/hypercolumns.py``).

A BCPNN layer is a population of H hypercolumns (HCs), each containing M
minicolumns (MCs).  Unit activity lives in a flat vector of N = H*M rates;
divisive normalization is a softmax *within* each hypercolumn, so the M
minicolumns of one HC always form a probability distribution.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class LayerGeom:
    """Geometry of one BCPNN population layer."""

    H: int  # hypercolumns
    M: int  # minicolumns per hypercolumn

    @property
    def N(self) -> int:
        return self.H * self.M

    def blocked(self, x: torch.Tensor) -> torch.Tensor:
        """(..., N) -> (..., H, M)."""
        return x.reshape(*x.shape[:-1], self.H, self.M)

    def flat(self, x: torch.Tensor) -> torch.Tensor:
        """(..., H, M) -> (..., N)."""
        return x.reshape(*x.shape[:-2], self.H * self.M)


def hc_softmax(support: torch.Tensor, geom: LayerGeom,
               gain: float = 1.0) -> torch.Tensor:
    """Softmax within each hypercolumn: gain first, then max-subtract, exp,
    divide (the order of the JAX function).  support: (..., N)."""
    s = geom.blocked(support) * gain
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    out = e / e.sum(dim=-1, keepdim=True)
    return geom.flat(out)


def hc_hardmax(support: torch.Tensor, geom: LayerGeom) -> torch.Tensor:
    """One-hot winner per hypercolumn (hard-WTA), first maximum wins."""
    idx = geom.blocked(support).argmax(dim=-1)
    out = torch.nn.functional.one_hot(idx, geom.M).to(support.dtype)
    return geom.flat(out)


def encode_scalar_hcs(x: torch.Tensor) -> torch.Tensor:
    """Encode scalar features in [0,1] as complementary-pair hypercolumns:
    (..., F) -> (..., 2F), feature f becoming the HC (x_f, 1 - x_f)."""
    x = torch.clamp(x, 0.0, 1.0)
    pair = torch.stack([x, 1.0 - x], dim=-1)  # (..., F, 2)
    return pair.reshape(*x.shape[:-1], x.shape[-1] * 2)
