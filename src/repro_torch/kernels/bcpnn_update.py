"""Fused BCPNN plasticity stage on Hopper:

    co   = XᵀY / n          (n = B, or the genuine rows of a padded batch)
    pij' = (1 - a)·pij + a·co
    w    = (log clip(pij', eps², 1) − log_pi − log_pj) · mask

Replaces the Pallas TPU kernel ``repro/kernels/bcpnn_update.py::
bcpnn_update_pallas``.  CUDA source: ``csrc/bcpnn.cu::trace_update_kernel``
(dense layout; the patchy-held update is the same body): one pass over the
(Ni, Nj) trace in 64 x 128 tiles, by persistent blocks of two teams of
warps that take turns at the tensor cores.  Each tile's pij is requested
by bulk async copies (TMA) while the team's previous tile is still in its
epilogue; the XᵀY tile runs on the tensor cores in 3xTF32 (both operands
split into TF32 hi and lo halves, three products summed in fp32: fp32
accuracy, never a single TF32 pass) over batch slices staged with
``cp.async``; then the EMA and the log fold, with pij' and w written as
16-byte coalesced stores.  ``a`` stays on the device (a 0-d tensor, no
host sync), and the (Hi, Hj) hypercolumn mask is indexed in the kernel
instead of streaming an expanded (Ni, Nj) unit mask.  A zero-padded tail
batch passes ``count``, its genuine row count as a 0-d device tensor,
which the kernel divides by instead of B.  Outputs are fresh tensors, the
old trace left as it was, unless the caller names them (``out``): a
donated step writes pij' over pij and w over the old w.  Each block reads
only the pij tile it writes, and reads it before it writes it, so in
place is safe.  ``ref.split_tf32_mm`` models the product's arithmetic on
the CPU.

Bound: bytes.  At Model 1's hidden projection (B=128, Ni=1568, Nj=4096)
the 77 MB of traffic (read pij, write pij' and w) take ~23 us at 3.35
TB/s, ~24 us with the inputs; the 3 x 1.64 GFLOP of the split product
take ~10 us at the tensor cores' 495 TFLOP/s TF32 rate.  The body does not
reach the bound: ``mma.sync`` with the operands split in every step runs
at about a third of that rate (``chip_smoke.py``'s ``mma.sync``
yardstick), so its product lasts about as long as the bytes, and the two
overlap only in part.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ._build import (check_launch, library, require, require_current_device,
                     require_outputs, stream_ptr)
from .ref import ref_bcpnn_update

# Kernel launches in this process (only where the kernel is launched).
LAUNCHES = 0
# The device kernels one call launches, as patterns (``re.search``) of the
# profiler's names for them, each starting with its ``__global__``: the
# update body's dense instantiation (``Layout`` 0, csrc/common.cuh);
# ``patchy.py``'s updates launch the same body at layouts 1 and 2.
DEVICE_KERNELS = (r"trace_update_kernel<0,",)


def bcpnn_update_cuda(pij: torch.Tensor, log_pi: torch.Tensor,
                      log_pj: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                      mask: torch.Tensor, alpha, eps: float = 1e-4,
                      count: Optional[torch.Tensor] = None,
                      out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Returns (new_pij, new_w), both (Ni, Nj) float32: fresh tensors, or
    ``out`` = (pij_out, w_out) written and returned (pij_out may be pij
    itself).

    pij (Ni, Nj); log_pi (Ni,); log_pj (Nj,); x (B, Ni); y (B, Nj); mask
    the (Hi, Hj) hypercolumn mask (Hi divides Ni, Hj divides Nj); alpha a
    scalar (a 0-d tensor on the card avoids a host copy); ``count`` (0-d
    float32, optional) the divisor of XᵀY in place of B, for a batch whose
    pad rows are zero.  CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    global LAUNCHES
    if pij.device.type == "cpu":
        return ref_bcpnn_update(pij, log_pi, log_pj, x, y, mask, alpha, eps,
                                count, out)
    require_current_device(pij)
    dev = pij.device
    ni, nj = pij.shape
    b = x.shape[0]
    hi, hj = mask.shape
    if b <= 0:
        raise ValueError("bcpnn_update needs a non-empty batch")
    if hi <= 0 or hj <= 0 or ni % hi or nj % hj:
        raise ValueError(f"mask shape {(hi, hj)} does not tile pij {(ni, nj)}")
    a = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    for t, name, shape in ((pij, "pij", (ni, nj)), (log_pi, "log_pi", (ni,)),
                           (log_pj, "log_pj", (nj,)), (x, "x", (b, ni)),
                           (y, "y", (b, nj)), (mask, "mask", (hi, hj)),
                           (a, "alpha", ())):
        require(t, name, shape, dev)
    if count is not None:
        require(count, "count", (), dev)
    new_pij, w = require_outputs(out, pij, dev)
    rc = library().bcpnn_update(
        pij.data_ptr(), log_pi.data_ptr(), log_pj.data_ptr(), x.data_ptr(),
        y.data_ptr(), mask.data_ptr(), a.data_ptr(),
        None if count is None else count.data_ptr(), new_pij.data_ptr(),
        w.data_ptr(), b, ni, nj, hi, hj, ctypes.c_float(eps * eps),
        stream_ptr(pij))
    check_launch(rc, "bcpnn_update")
    LAUNCHES += 1
    return new_pij, w
