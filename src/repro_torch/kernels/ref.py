"""Plain PyTorch versions of the three CUDA kernels.

Each repeats its kernel's arithmetic with stock tensor ops (mirroring
``repro/kernels/ref.py``).  A kernel wrapper calls its plain version for
tensors that lie on the CPU; the CPU tests hold the port against the JAX
package through them, and ``chip_smoke.py`` holds each kernel against its
plain version on the card.  Nothing on the main path calls them when the
tensors are on the card.
"""
from __future__ import annotations

import torch


def ref_hc_softmax(support: torch.Tensor, n_hc: int, n_mc: int,
                   gain: float = 1.0) -> torch.Tensor:
    """Per-hypercolumn softmax.  support: (B, n_hc * n_mc)."""
    b = support.shape[0]
    s = support.reshape(b, n_hc, n_mc).to(torch.float32) * gain
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    out = e / e.sum(dim=-1, keepdim=True)
    return out.reshape(b, n_hc * n_mc).to(support.dtype)


def ref_bcpnn_fwd(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                  n_hc: int, n_mc: int, gain: float = 1.0) -> torch.Tensor:
    """Activation stage: support matmul + bias + per-HC softmax.

    x: (B, Ni), w: (Ni, Nj), bias: (Nj,)  ->  rates (B, Nj).
    """
    support = x.to(torch.float32) @ w.to(torch.float32) + bias.to(torch.float32)
    return ref_hc_softmax(support, n_hc, n_mc, gain).to(x.dtype)


def ref_bcpnn_update(pij: torch.Tensor, log_pi: torch.Tensor,
                     log_pj: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                     mask: torch.Tensor, alpha, eps: float = 1e-4,
                     count=None):
    """Plasticity stage: trace EMA + Bayesian log-weight recompute.

    pij (Ni, Nj); log_pi (Ni,); log_pj (Nj,); x (B, Ni); y (B, Nj); alpha a
    scalar; ``count`` (optional) divides XᵀY in place of B.  ``mask`` is the (Hi, Hj) hypercolumn-level mask, as the CUDA
    kernel takes it; the minicolumn counts follow from the shapes.  (The
    JAX oracle takes the mask expanded to (Ni, Nj); the product is the
    same.)  Returns (new_pij, new_w).
    """
    ni, nj = pij.shape
    hi, hj = mask.shape
    n = x.shape[0] if count is None else count
    co = (x.to(torch.float32).T @ y.to(torch.float32)) / n
    new_pij = (1.0 - alpha) * pij + alpha * co
    w = torch.log(torch.clamp(new_pij, eps * eps, 1.0)) \
        - (log_pi[:, None] + log_pj[None, :])
    w = w.reshape(hi, ni // hi, hj, nj // hj) * mask[:, None, :, None]
    return new_pij, w.reshape(ni, nj)
