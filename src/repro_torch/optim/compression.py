"""Int8 gradient compression with error feedback (mirrors
``repro/optim/compression.py``).

Each gradient is quantized to int8 with one scale per JAX leaf: the scale
is ``max|g| / 127`` over the whole leaf, across every repeat of a leaf the
JAX package stacks over its scanned layers (a tree is ``{JAX tree path:
[tensor, ...]}``, ``convert.lm_leaf_groups``).  The codes round half to
even; the quantization error is carried to the next step per element, in
fp32.  ``compress_grads`` returns the dequantized gradients the optimizer
sees and the new error.

The arithmetic is the JAX function's as XLA compiles it, bit for bit:

* XLA turns the division by the constant 127 into a product with its fp32
  reciprocal;
* the division by the scale stays a division (the scale is a tensor on
  the device, never a host scalar, which PyTorch's CUDA division would
  turn into a product with a reciprocal);
* XLA contracts the error ``gf - q * scale`` into one fused multiply-add,
  rounded once.  The port forms it in fp64, where the product (8 by 24
  bits) and the difference (of two numbers within a few binades of each
  other, or one of them 0) are exact, and rounds once to fp32.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

Tree = Dict[str, List[torch.Tensor]]

# 1/127 rounded to fp32, the constant XLA multiplies by for ``x / 127.0``
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def quantize(parts: List[torch.Tensor]
             ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """int8 codes of each part of one JAX leaf and the leaf's 0-d fp32
    scale."""
    amax = torch.stack([torch.amax(torch.abs(g)) for g in parts]).amax()
    scale = torch.clamp_min(amax, 1e-12) * _INV_127
    q = [torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
         for g in parts]
    return q, scale


def dequantize(q: List[torch.Tensor], scale: torch.Tensor
               ) -> List[torch.Tensor]:
    return [c.float() * scale for c in q]


def init_error_state(params: Tree) -> Tree:
    return {k: [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in g] for k, g in params.items()}


@torch.no_grad()
def compress_grads(grads: Tree, err: Tree) -> Tuple[Tree, Tree]:
    """Returns (dequantized grads as seen by the optimizer, new error)."""
    deq: Tree = {}
    new_err: Tree = {}
    for path, group in grads.items():
        gf = [g.float() + e for g, e in zip(group, err[path])]
        q, s = quantize(gf)
        deq[path] = dequantize(q, s)
        new_err[path] = [(a.double() - c.double() * s.double()).float()
                         for a, c in zip(gf, q)]
    return deq, new_err
