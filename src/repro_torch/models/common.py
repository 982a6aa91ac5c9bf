"""Shared building blocks of the LM zoo (mirrors ``repro/models/common.py``).

Parameters live in ``nn.Module``s whose attribute names are the JAX
package's parameter-tree keys, so ``convert.lm_params_from_numpy`` maps a
JAX tree onto a module leaf by leaf.  A module allocates its parameters
empty; ``reset_parameters(gen)`` draws them from a ``torch.Generator``
with the JAX initialisers' distributions (the draws differ: threefry is
not reproduced).  The serving path takes no gradient, so parameters are
made with ``requires_grad=False``.

The dtype choices are the JAX functions', op for op: statistics and rotary
angles in fp32, everything else in the compute dtype.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def param(shape: Sequence[int], dtype: torch.dtype,
          device: Optional[torch.device]) -> nn.Parameter:
    """An uninitialised parameter (filled by ``reset_parameters`` or by a
    conversion)."""
    return nn.Parameter(torch.empty(tuple(shape), dtype=dtype, device=device),
                        requires_grad=False)


@torch.no_grad()
def dense_init_(p: torch.Tensor, gen: torch.Generator,
                in_axis: int = 0) -> torch.Tensor:
    """Truncated-normal fan-in init at +-2 sigma, sigma = 1/sqrt(fan_in),
    drawn in fp32 and cast to the parameter's dtype."""
    std = 1.0 / math.sqrt(p.shape[in_axis])
    t = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
    return p.copy_(t)


@torch.no_grad()
def embed_init_(p: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    t = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    nn.init.trunc_normal_(t, 0.0, 0.02, -0.04, 0.04, generator=gen)
    return p.copy_(t)


# ----------------------------------------------------------------- norms --

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm: the (..., 1) statistic in fp32, ``inv`` cast to the compute
    dtype, the products in the compute dtype (``common.py:28``)."""
    d = x.shape[-1]
    xf = x.float()
    var = torch.einsum("...d,...d->...", xf, xf)[..., None] / d
    inv = torch.rsqrt(var + eps).to(x.dtype)
    s = (1.0 + scale.float()) if plus_one else scale.float()
    return x * inv * s.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    d = x.shape[-1]
    xf = x.float()
    mu = xf.sum(dim=-1, keepdim=True) / d
    e2 = torch.einsum("...d,...d->...", xf, xf)[..., None] / d
    var = e2 - mu * mu
    inv = torch.rsqrt(var + eps).to(x.dtype)
    mu = mu.to(x.dtype)
    return (x - mu) * inv * scale.to(x.dtype) + bias.to(x.dtype)


class Norm(nn.Module):
    """The zoo's norm: LayerNorm (``scale``, ``bias``) for the audio family,
    else RMSNorm (``scale``; gemma-style ``1 + scale`` when the config has
    post-norms or a scaled embedding)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype,
                 device: Optional[torch.device]):
        super().__init__()
        self.layer = cfg.family == "audio"
        self.plus_one = cfg.post_norms or cfg.embed_scale
        self.eps = cfg.norm_eps
        self.scale = param((cfg.d_model,), dtype, device)
        if self.layer:
            self.bias = param((cfg.d_model,), dtype, device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        if self.layer:
            self.scale.fill_(1.0)
            self.bias.zero_()
        else:
            self.scale.fill_(0.0 if self.plus_one else 1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.layer:
            return layer_norm(x, self.scale, self.bias, self.eps)
        return rms_norm(x, self.scale, self.eps, plus_one=self.plus_one)


# ------------------------------------------------------------------ rope --

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding, half-split rotation, angles in fp32.
    x: (..., S, H, D), positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq                 # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                         # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------- mlp --

def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)``."""
    return F.gelu(x, approximate="tanh")


class MLP(nn.Module):
    """``wi``, ``wo`` and, for the gated kinds (swiglu, geglu), ``wg``."""

    def __init__(self, d_model: int, d_ff: int, kind: str,
                 dtype: torch.dtype, device: Optional[torch.device]):
        super().__init__()
        self.kind = kind
        self.wi = param((d_model, d_ff), dtype, device)
        if kind in ("swiglu", "geglu"):
            self.wg = param((d_model, d_ff), dtype, device)
        self.wo = param((d_ff, d_model), dtype, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for p in self.parameters():
            dense_init_(p, gen)


def mlp(p: MLP, x: torch.Tensor, kind: str) -> torch.Tensor:
    """x: (B, S, d)."""
    h = x @ p.wi
    if kind == "swiglu":
        h = F.silu(x @ p.wg) * h
    elif kind == "geglu":
        h = gelu(x @ p.wg) * h
    else:
        h = gelu(h)
    return h @ p.wo
