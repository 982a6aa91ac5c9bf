"""Low-precision serving, int8 tier: per-post-hypercolumn quantization and
the int8 forward kernels on Hopper (mirrors ``repro/kernels/quant.py``).

Learning state is fp32, always (DESIGN.md §8); precision enters only
through the derived serving pack.  This module is its int8 tier:

* **Fold-time half.**  ``quantize_dense``/``quantize_compact`` turn fp32
  weights into int8 codes with one symmetric scale per post-HC,
  ``scale[j] = max(absmax_j, 1e-12) / 127`` and ``w ~ w_q * scale[j]``;
  ``quantize_acts`` maps rates in [0, 1] to the fixed Q0.7 grid
  ``round(clip(x, 0, 1) * 127)``.  Codes and scales equal the JAX
  package's bit for bit: ``torch.round`` rounds half to even as
  ``jnp.round`` does, and the dequant factor is ``scale * fp32(1/127)``
  (``scale / 127`` differs in the last bit).
* **Plain supports.**  ``quant_support_dense_torch`` and
  ``quant_support_compact_torch`` (the JAX package's ``*_jnp`` oracles)
  accumulate the int8 products in fp32, as the reference does; they are
  what the ``"torch"`` backend and the int8 readout run.  The accumulator
  is exact while every partial sum stays below 2**24, which holds at
  Model 1 (a complement-coded input row's codes sum to at most 784 * 128,
  so |acc| <= 1.3e7) but not for every input at Ni = 8192; the kernels'
  plain versions in ``ref.py`` are exact always.
* **Kernels.**  ``quant_fwd`` (dense codes), ``quant_patchy_forward``
  (patchy, dense-resident codes, each post-HC's live rows gathered) and
  ``quant_compact_forward`` (compact-resident codes) are the three layouts
  of one body on the s8 tensor cores,
  ``csrc/quant.cu::quant_fwd_tc_kernel``: wgmma on K-major code tiles laid
  out at staging, the contraction split over a thread-block cluster per
  post-HC, every shape and alignment taken (TMA where rows allow it,
  cp.async pieces or plain loads elsewhere; HCs past 128 columns in
  column chunks).  ``quant_fwd_plan`` says which tile height and cluster
  size a shape takes by the launcher's rule; a caller's plan, or the
  autotune cache's (``tuning.py``), takes the place of the rule, and the
  rates are the same bit for bit under every plan (integer sums).  The
  body makes the activation codes in the tile load, accumulates exactly
  in int32, and ends in the fp32 epilogue ``(acc *
  scale[j] * fp32(1/127) + b) * gain`` and the HC's softmax.  A CPU tensor
  takes the plain version; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..core.compact import gather_pre, unit_indices
from . import tuning
from ._build import (check_launch, check_table, library, require,
                     require_current_device, stream_ptr)

INT8_MAX = 127          # symmetric: code -128 is never emitted
ACT_SCALE = 1.0 / 127   # fixed Q0.7 step for rates in [0, 1]
# Largest contraction whose int32 accumulator cannot overflow.
MAX_EXACT_K = (2 ** 31 - 1) // (INT8_MAX * INT8_MAX)
MAX_CLUSTER = 8  # blocks a thread-block cluster at most (csrc/quant.cu)

# Kernel launches in this process, per entry point (only where a kernel is
# launched).
LAUNCHES = {"quant_fwd": 0, "quant_compact_forward": 0,
            "quant_patchy_forward": 0}
# The device kernels one call of each launches, as patterns (``re.search``)
# of the profiler's names for them, each starting with its ``__global__``:
# the one body's instantiation at its ``Layout`` (the second template
# argument; csrc/common.cuh).
DEVICE_KERNELS = {
    "quant_fwd": (r"quant_fwd_tc_kernel<\d+, 0,",),
    "quant_patchy_forward": (r"quant_fwd_tc_kernel<\d+, 1,",),
    "quant_compact_forward": (r"quant_fwd_tc_kernel<\d+, 2,",)}
# The (rows, cluster) each entry point last passed to the C entry point
# (0: the launcher's rule).
LAST_PLAN = {name: (0, 0) for name in LAUNCHES}

_DENSE, _PATCHY, _COMPACT = 0, 1, 2  # csrc/common.cuh Layout


# ------------------------------------------------- fold-time quantize ----

def quantize_acts(x: torch.Tensor) -> torch.Tensor:
    """Rates (values in [0, 1]) -> int8 codes on the fixed Q0.7 grid."""
    return torch.round(torch.clamp(x, 0.0, 1.0) * INT8_MAX).to(torch.int8)


def _scales_from_absmax(absmax: torch.Tensor) -> torch.Tensor:
    # An all-zero group (a silent HC) gets a harmless nonzero scale: its
    # codes are all 0 either way.
    return torch.clamp(absmax, min=1e-12) / INT8_MAX


def quantize_dense(w: torch.Tensor, n_hc: int, n_mc: int):
    """Dense (Ni, Nj=n_hc*n_mc) fp32 weights -> (w_q int8, scale (Hj,))
    with per-post-HC symmetric scales: ``w ~ w_q * scale[j]``."""
    ni, nj = w.shape
    w3 = w.reshape(ni, n_hc, n_mc)
    scale = _scales_from_absmax(w3.abs().amax(dim=(0, 2)))
    codes = torch.round(w3 / scale[None, :, None])
    w_q = torch.clamp(codes, -INT8_MAX, INT8_MAX).to(torch.int8)
    return w_q.reshape(ni, nj), scale


def quantize_compact(w_c: torch.Tensor):
    """Compact-resident (Hj, K, Mj) fp32 weights -> (w_q int8, scale
    (Hj,)); the same per-post-HC scheme on the compact layout."""
    scale = _scales_from_absmax(w_c.abs().amax(dim=(1, 2)))
    codes = torch.round(w_c / scale[:, None, None])
    w_q = torch.clamp(codes, -INT8_MAX, INT8_MAX).to(torch.int8)
    return w_q, scale


def dequantize_dense(w_q: torch.Tensor, scale: torch.Tensor, n_hc: int,
                     n_mc: int) -> torch.Tensor:
    ni, nj = w_q.shape
    w3 = w_q.to(torch.float32).reshape(ni, n_hc, n_mc)
    return (w3 * scale[None, :, None]).reshape(ni, nj)


def dequantize_compact(w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return w_q.to(torch.float32) * scale[:, None, None]


def dequant_factor(scale: torch.Tensor) -> torch.Tensor:
    """Per-post-HC factor from an int8 accumulator to support units,
    ``scale * fp32(1/127)`` (the scalar is rounded to fp32 first, as the
    reference's weakly typed ``scale * ACT_SCALE``)."""
    return scale * ACT_SCALE


# ------------------------------------------------------ plain supports ----

def quant_support_dense_torch(x, w_q, scale, b, n_hc: int, n_mc: int):
    """Fixed-point support on the dense layout, fp32 accumulation (the
    reference's ``quant_support_dense_jnp``): quantized activations, an
    integer-valued product, the scale-folded dequant."""
    xq = quantize_acts(x).to(torch.float32)
    acc = xq @ w_q.to(torch.float32)
    su = dequant_factor(scale)[:, None].expand(n_hc, n_mc).reshape(-1)
    return b.to(torch.float32)[None, :] + acc * su[None, :]


def quant_support_compact_torch(x, w_q, scale, b, table, mi: int):
    """Fixed-point support on the compact (Hj, K, Mj) layout, fp32
    accumulation (the reference's ``quant_support_compact_jnp``)."""
    hj, _, mj = w_q.shape
    ui = unit_indices(table, mi, sentinel=x.shape[1])
    xq = gather_pre(quantize_acts(x).to(torch.float32), ui)   # (Hj, B, K)
    acc = torch.einsum("jbk,jkm->bjm", xq, w_q.to(torch.float32))
    s3 = acc * dequant_factor(scale)[None, :, None]
    return s3.reshape(x.shape[0], hj * mj) + b.to(torch.float32)[None, :]


# -------------------------------------------------------------- kernels ----

def _launch(name: str, x: torch.Tensor, w_q: torch.Tensor, bias: torch.Tensor,
            scale: torch.Tensor, table: Optional[torch.Tensor], mi: int,
            hj: int, mj: int, layout: int, gain: float, rows: int,
            cluster: int) -> torch.Tensor:
    require_current_device(x)
    dev = x.device
    b, ni = x.shape
    if layout == _DENSE:
        nact, k = 0, ni
        dims = {}
    else:
        nact = check_table(table, hj, ni, mi, dev)
        k = nact * mi
        dims = {"nact": nact, "mi": mi}
    plan = tuning.plan(name, {"rows": rows, "cluster": cluster}, b=b, ni=ni,
                       n_hc=hj, n_mc=mj, **dims)
    rows, cluster = plan["rows"], plan["cluster"]
    if k > MAX_EXACT_K:
        raise ValueError(f"{name}: a {k}-term int8 contraction can overflow "
                         f"the int32 accumulator (at most {MAX_EXACT_K})")
    if not 0 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"{name}: cluster {cluster} is not in "
                         f"[0, {MAX_CLUSTER}]")
    if rows not in (0, 64, 128):
        raise ValueError(f"{name}: tiles of {rows} rows (64, 128 or 0)")
    require(x, "x", (b, ni), dev)
    require(w_q, "w_q", (hj, k, mj) if layout == _COMPACT else (ni, hj * mj),
            dev, torch.int8)
    require(bias, "bias", (hj * mj,), dev)
    require(scale, "scale", (hj,), dev)
    out = torch.empty((b, hj * mj), dtype=torch.float32, device=dev)
    rc = library().bcpnn_quant_fwd(
        x.data_ptr(), w_q.data_ptr(), bias.data_ptr(), scale.data_ptr(),
        None if table is None else table.data_ptr(), out.data_ptr(), b, ni,
        hj, mj, mi, nact, layout, rows, cluster, ctypes.c_float(gain),
        stream_ptr(x))
    check_launch(rc, name)
    LAUNCHES[name] += 1
    LAST_PLAN[name] = (rows, cluster)
    return out


def quant_fwd(x: torch.Tensor, w_q: torch.Tensor, bias: torch.Tensor,
              scale: torch.Tensor, n_hc: int, n_mc: int,
              gain: float = 1.0, *, rows: int = 0,
              cluster: int = 0) -> torch.Tensor:
    """x (B, Ni) fp32 rates, w_q (Ni, n_hc*n_mc) int8, bias (Nj,) and
    scale (n_hc,) fp32 -> rates (B, Nj): the int8 ``bcpnn_fwd``.
    ``rows`` and ``cluster`` (CUDA only): a block's tile height (64 or 128
    rows) and the thread-block cluster size (1 to MAX_CLUSTER); both 0
    take the autotune cache's plan for the shape (``tuning.py``), and a 0
    the cache leaves is the launcher's (``quant_fwd_plan``)."""
    if x.device.type == "cpu":
        from .ref import ref_quant_fwd
        return ref_quant_fwd(x, w_q, bias, scale, n_hc, n_mc, gain)
    return _launch("quant_fwd", x, w_q, bias, scale, None, 1, n_hc, n_mc,
                   _DENSE, gain, rows, cluster)


def quant_fwd_plan(x: torch.Tensor, w_q: torch.Tensor, n_hc: int,
                   n_mc: int, table: Optional[torch.Tensor] = None,
                   mi: int = 1) -> Tuple[int, int]:
    """(tile rows, cluster size): the plan the int8 forward takes for these
    operands (CUDA tensors) by the launcher's rule, dense without a table;
    with one, patchy for (Ni, Nj) codes and compact for (Hj, K, Mj) ones.
    Every shape runs on the one tensor-core body, so its plan is all there
    is to report.  Launches nothing."""
    b, ni = x.shape
    if table is None:
        layout, k = _DENSE, ni
    else:
        layout = _COMPACT if w_q.dim() == 3 else _PATCHY
        k = table.shape[1] * mi
    plan = (ctypes.c_int * 2)()
    check_launch(library().bcpnn_quant_fwd_plan(
        x.data_ptr(), w_q.data_ptr(), b, ni, k, n_hc, n_mc, mi, layout, plan),
        "quant_fwd_plan")
    return plan[0], plan[1]


def quant_compact_forward(x: torch.Tensor, w_q: torch.Tensor,
                          bias: torch.Tensor, scale: torch.Tensor,
                          table: torch.Tensor, mi: int,
                          gain: float = 1.0, *, rows: int = 0,
                          cluster: int = 0) -> torch.Tensor:
    """x (B, Ni), compact-resident codes w_q (Hj, K, Mj) int8, bias
    (Hj*Mj,), scale (Hj,), table (Hj, nact) -> rates (B, Hj*Mj).
    ``rows`` and ``cluster`` as for ``quant_fwd``."""
    if x.device.type == "cpu":
        from .ref import ref_quant_compact_forward
        return ref_quant_compact_forward(x, w_q, bias, scale, table, mi, gain)
    if w_q.dim() != 3:
        raise ValueError(f"w_q has shape {tuple(w_q.shape)}, expected "
                         f"(Hj, K, Mj)")
    hj, _, mj = w_q.shape
    return _launch("quant_compact_forward", x, w_q, bias, scale, table, mi,
                   hj, mj, _COMPACT, gain, rows, cluster)


def quant_patchy_forward(x: torch.Tensor, w_q: torch.Tensor,
                         bias: torch.Tensor, scale: torch.Tensor,
                         table: torch.Tensor, mi: int, hj: int, mj: int,
                         gain: float = 1.0, *, rows: int = 0,
                         cluster: int = 0) -> torch.Tensor:
    """x (B, Ni), dense-resident masked codes w_q (Ni, Hj*Mj) int8 (silent
    synapses are exactly code 0), bias, scale, table (Hj, nact) -> rates
    (B, Hj*Mj), reading only each post-HC's live rows.  ``rows`` and
    ``cluster`` as for ``quant_fwd``."""
    if x.device.type == "cpu":
        from .ref import ref_quant_patchy_forward
        return ref_quant_patchy_forward(x, w_q, bias, scale, table, mi, hj,
                                        mj, gain)
    return _launch("quant_patchy_forward", x, w_q, bias, scale, table, mi,
                   hj, mj, _PATCHY, gain, rows, cluster)
