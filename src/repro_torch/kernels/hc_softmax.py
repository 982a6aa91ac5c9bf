"""Per-hypercolumn softmax (divisive normalization) on Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/hc_softmax.py::
hc_softmax_pallas``.  CUDA source: ``csrc/bcpnn.cu::hc_softmax_kernel``:
one warp per (row, HC) segment, the segment's minicolumns held in
registers, max and sum by warp shuffles.

Bound: bytes (one read and one write of the support).  At Model 1 (B=128,
H=32, M=128) that is 4.2 MB, ~1.3 us at 3.35 TB/s, below a launch's own
cost; the readout call (B=128, H=1, M=10) is launch-bound.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import (check_launch, library, require, require_current_device,
                     stream_ptr)
from .ref import ref_hc_softmax

# Kernel launches in this process (only where the kernel is launched).
LAUNCHES = 0


def hc_softmax_cuda(support: torch.Tensor, n_hc: int, n_mc: int,
                    gain: float = 1.0) -> torch.Tensor:
    """support: (B, n_hc*n_mc) -> rates, softmax within each HC.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (float32, contiguous) or raises."""
    global LAUNCHES
    if support.device.type == "cpu":
        return ref_hc_softmax(support, n_hc, n_mc, gain)
    require_current_device(support)
    b = support.shape[0]
    require(support, "support", (b, n_hc * n_mc), support.device)
    out = torch.empty_like(support)
    rc = library().bcpnn_hc_softmax(
        support.data_ptr(), out.data_ptr(), b * n_hc, n_mc,
        ctypes.c_float(gain), stream_ptr(support))
    check_launch(rc, "hc_softmax")
    LAUNCHES += 1
    return out
