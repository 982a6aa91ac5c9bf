"""Plain PyTorch versions of the CUDA kernels.

Each repeats its kernel's arithmetic with stock tensor ops (mirroring
``repro/kernels/ref.py``).  A kernel wrapper calls its plain version for
tensors that lie on the CPU; the CPU tests hold the port against the JAX
package through them, and ``chip_smoke.py`` holds each kernel against its
plain version on the card.  Nothing on the main path calls them when the
tensors are on the card.
"""
from __future__ import annotations

import torch

from ..core.compact import (compact_co_stats, fold_weights_compact,
                            gather_dense, gather_pre, scatter_dense,
                            unit_indices)
from .quant import dequant_factor, quantize_acts


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

    x: (B, Ni), w: (Ni, Nj), bias: (Nj,)  ->  rates (B, Nj).  bf16 weights
    and bias (a bf16 serving pack) are widened to fp32 first.
    """
    support = x.to(torch.float32) @ w.to(torch.float32) + bias.to(torch.float32)
    return ref_hc_softmax(support, n_hc, n_mc, gain).to(x.dtype)


def _into(out, new_pij: torch.Tensor, w: torch.Tensor):
    """An update's results, written into the caller's (pij', w) when it
    names them (``out``), as the kernels write theirs."""
    if out is None:
        return new_pij, w
    out[0].copy_(new_pij)
    out[1].copy_(w)
    return out[0], out[1]


def ref_bcpnn_update(pij: torch.Tensor, log_pi: torch.Tensor,
                     log_pj: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                     mask: torch.Tensor, alpha, eps: float = 1e-4,
                     count=None, out=None):
    """Plasticity stage: trace EMA + Bayesian log-weight recompute.

    pij (Ni, Nj); log_pi (Ni,); log_pj (Nj,); x (B, Ni); y (B, Nj); alpha a
    scalar; ``count`` (optional) divides XᵀY in place of B.  ``mask`` is
    the (Hi, Hj) hypercolumn-level mask, as the CUDA kernel takes it; the
    minicolumn counts follow from the shapes.  (The JAX oracle takes the
    mask expanded to (Ni, Nj); the product is the same.)  Returns
    (new_pij, new_w): fresh, or ``out`` written (pij' may be pij).
    """
    ni, nj = pij.shape
    hi, hj = mask.shape
    n = x.shape[0] if count is None else count
    co = (x.to(torch.float32).T @ y.to(torch.float32)) / n
    new_pij = (1.0 - alpha) * pij + alpha * co
    w = torch.log(torch.clamp(new_pij, eps * eps, 1.0)) \
        - (log_pi[:, None] + log_pj[None, :])
    w = w.reshape(hi, ni // hi, hj, nj // hj) * mask[:, None, :, None]
    return _into(out, new_pij, w.reshape(ni, nj))


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32``: on the int32 view, add half of the 13
    dropped bits to the magnitude and clear them.  Infinities come out
    unchanged and a NaN stays a NaN (its carry would reach the sign bit)."""
    v = v.to(torch.float32).contiguous()
    rounded = ((v.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isnan(v), v, rounded)


def tf32_truncate(v: torch.Tensor) -> torch.Tensor:
    """fp32 truncated to TF32 (the 13 low mantissa bits cleared), as the
    tensor cores read an fp32 word handed to them as a TF32 operand."""
    v = v.to(torch.float32).contiguous()
    return (v.view(torch.int32) & ~0x1FFF).view(torch.float32)


def split_tf32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the tensor-core kernels form it in 3xTF32: each operand
    split as v = hi + lo with hi = tf32(v) (``csrc/common.cuh::
    split_tf32``) and lo = v − hi, which the tensor cores read truncated
    to TF32, and lo·hi + hi·lo + hi·hi summed in fp32 (lo·lo dropped).
    The resident-trace update's co is ``split_tf32_mm(x.T, y) / n``; the
    dense forward's support is ``split_tf32_mm(x, w) + bias``, where a
    bf16 weight has lo = 0 (it is exact in TF32) and the kernel skips
    that product.  A NaN in a or b makes its lo a NaN, so it reaches the
    product.  Not on the main path: it documents and pins the kernels'
    arithmetic (tests/test_torch_kernels.py)."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    ah, bh = tf32_round(a), tf32_round(b)
    al, bl = tf32_truncate(a - ah), tf32_truncate(b - bh)
    return al @ bh + ah @ bl + ah @ bh


# ------------------------------------------------- patchy / compact ----
#
# These follow the semantics of the JAX wrappers in
# ``repro/kernels/patchy.py``, not their pad plans: K = nact*Mi live
# pre-units per post-HC, named by the (Hj, nact) index table.

def _patchy_rates(xg: torch.Tensor, wg: torch.Tensor, bias: torch.Tensor,
                  gain: float) -> torch.Tensor:
    """(Hj, B, K) gathered rates x (Hj, K, Mj) weights -> rates (B, Nj).
    bf16 weights and bias are widened to fp32 first."""
    hj, b, _ = xg.shape
    mj = wg.shape[2]
    s = torch.einsum("jbk,jkm->bjm", xg, wg.to(torch.float32))
    s = s.reshape(b, hj * mj) + bias.to(torch.float32)
    return ref_hc_softmax(s, hj, mj, gain)


def ref_patchy_forward(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                       table: torch.Tensor, mi: int, hj: int, mj: int,
                       gain: float = 1.0) -> torch.Tensor:
    """Patchy activation over dense-resident weights: each post-HC's live
    pre-units of x and rows of w (Ni, Hj*Mj), matmul, bias, softmax."""
    ui = unit_indices(table, mi, sentinel=x.shape[1])
    return _patchy_rates(gather_pre(x, ui), gather_dense(w, ui, hj, mj),
                         bias, gain)


def ref_compact_forward(x: torch.Tensor, w_c: torch.Tensor,
                        bias: torch.Tensor, table: torch.Tensor, mi: int,
                        gain: float = 1.0) -> torch.Tensor:
    """Patchy activation over compact-resident (Hj, K, Mj) weights."""
    ui = unit_indices(table, mi, sentinel=x.shape[1])
    return _patchy_rates(gather_pre(x, ui), w_c, bias, gain)


def _compact_step(pij_c, log_pi, log_pj, x, y, table, alpha, mi, eps,
                  count):
    """EMA of the compact joint trace and its log-odds fold."""
    co = compact_co_stats(x, y, table, mi, pij_c.shape[2], n_valid=count)
    new_c = (1.0 - alpha) * pij_c + alpha * co
    return new_c, fold_weights_compact(new_c, log_pi, log_pj, table, mi, eps)


def ref_patchy_update(pij: torch.Tensor, log_pi: torch.Tensor,
                      log_pj: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                      table: torch.Tensor, alpha, mi: int, hj: int, mj: int,
                      eps: float = 1e-4, count=None, out=None):
    """Patchy-held plasticity on dense-resident (Ni, Hj*Mj) traces: live
    entries take the EMA and the fold; silent pij entries hold their
    value and silent w entries are 0.  Returns (new_pij, new_w), fresh or
    ``out``."""
    ni = pij.shape[0]
    ui = unit_indices(table, mi, sentinel=ni)
    new_c, w_c = _compact_step(gather_dense(pij, ui, hj, mj), log_pi, log_pj,
                               x, y, table, alpha, mi, eps, count)
    new_pij = scatter_dense(pij.reshape(ni, hj, mj), ui, new_c)
    w = scatter_dense(pij.new_zeros((ni, hj, mj)), ui, w_c)
    return _into(out, new_pij.reshape(ni, hj * mj), w.reshape(ni, hj * mj))


def ref_compact_update(pij_c: torch.Tensor, log_pi: torch.Tensor,
                       log_pj: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                       table: torch.Tensor, alpha, mi: int,
                       eps: float = 1e-4, count=None, out=None):
    """Compact plasticity on resident (Hj, K, Mj) traces.  Returns
    (new_pij_c, new_w_c), fresh or ``out``."""
    return _into(out, *_compact_step(pij_c, log_pi, log_pj, x, y, table,
                                     alpha, mi, eps, count))


# ------------------------------------------------------------- int8 ----
#
# The int8 forwards of ``repro/kernels/quant.py``.  The accumulator is
# computed exactly, as a float64 product of the integer codes (|acc| <=
# K * 127**2 is far below 2**53, so every summation order gives the same
# integer), then cast to fp32 as the kernel casts its int32 sum; the
# epilogue rounds each operation on its own, as the kernel does.

def _quant_rates(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 hj: int, mj: int, gain: float) -> torch.Tensor:
    """Exact (B, Hj, Mj) float64 accumulators -> rates (B, Hj*Mj)."""
    b = acc.shape[0]
    s = acc.to(torch.float32) * dequant_factor(scale)[None, :, None]
    s = s.reshape(b, hj * mj) + bias.to(torch.float32)
    return ref_hc_softmax(s, hj, mj, gain)


def quant_acc_dense(x: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact int8 accumulators of the dense layout: Q0.7 codes of x (B, Ni)
    times codes w_q (Ni, Nj), as a (B, Nj) float64 tensor."""
    return quantize_acts(x).to(torch.float64) @ w_q.to(torch.float64)


def quant_acc_compact(x: torch.Tensor, w_q: torch.Tensor, table: torch.Tensor,
                      mi: int) -> torch.Tensor:
    """Exact int8 accumulators over each post-HC's live pre-units against
    (Hj, K, Mj) codes, as a (B, Hj, Mj) float64 tensor."""
    ui = unit_indices(table, mi, sentinel=x.shape[1])
    xg = gather_pre(quantize_acts(x).to(torch.float64), ui)  # (Hj, B, K)
    return torch.einsum("jbk,jkm->bjm", xg, w_q.to(torch.float64))


def ref_quant_fwd(x: torch.Tensor, w_q: torch.Tensor, bias: torch.Tensor,
                  scale: torch.Tensor, n_hc: int, n_mc: int,
                  gain: float = 1.0) -> torch.Tensor:
    """Dense int8 forward: Q0.7 activation codes x int8 weight codes
    (Ni, Nj), exact accumulator, per-HC dequant + bias, softmax."""
    acc = quant_acc_dense(x, w_q).reshape(x.shape[0], n_hc, n_mc)
    return _quant_rates(acc, scale, bias, n_hc, n_mc, gain)


def ref_quant_compact_forward(x: torch.Tensor, w_q: torch.Tensor,
                              bias: torch.Tensor, scale: torch.Tensor,
                              table: torch.Tensor, mi: int,
                              gain: float = 1.0) -> torch.Tensor:
    """int8 forward over compact-resident (Hj, K, Mj) codes."""
    hj, _, mj = w_q.shape
    return _quant_rates(quant_acc_compact(x, w_q, table, mi), scale, bias,
                        hj, mj, gain)


def ref_quant_patchy_forward(x: torch.Tensor, w_q: torch.Tensor,
                             bias: torch.Tensor, scale: torch.Tensor,
                             table: torch.Tensor, mi: int, hj: int, mj: int,
                             gain: float = 1.0) -> torch.Tensor:
    """int8 forward over dense-resident (Ni, Hj*Mj) codes: each post-HC's
    live rows, gathered."""
    ui = unit_indices(table, mi, sentinel=x.shape[1])
    return ref_quant_compact_forward(x, gather_dense(w_q, ui, hj, mj), bias,
                                     scale, table, mi, gain)
