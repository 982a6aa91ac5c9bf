"""Per-hypercolumn softmax (divisive normalization) on Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/hc_softmax.py::
hc_softmax_pallas``.  CUDA source: ``csrc/bcpnn.cu::hc_softmax_kernel``: a
sub-warp of L lanes per (row, HC) segment, L the next power of two of
ceil(M / V) (at most 32) for V = 4, 2 or 1 floats a load (the widest M and
the alignment allow), so a warp holds 32 / L segments; segments of up to
256 minicolumns stay in registers, max and sum by log2(L) shuffles; longer
ones take ``hc_softmax_long_kernel``'s three passes.  ``softmax_plan``
says which a shape takes.

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
# The device kernels one call launches, as patterns (``re.search``) of the
# profiler's names for them, each starting with its ``__global__``: one of
# the two, as ``softmax_plan`` says.
DEVICE_KERNELS = (r"hc_softmax_kernel<", r"hc_softmax_long_kernel<")


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


def softmax_plan(support: torch.Tensor, out: torch.Tensor, n_mc: int):
    """How the kernel takes segments of ``n_mc`` values from ``support``
    into ``out`` (CUDA tensors): (floats a load, lanes a segment, loads a
    lane; 0 loads: the three-pass loop past 256 values).  Launches
    nothing."""
    plan = (ctypes.c_int * 3)()
    check_launch(library().bcpnn_hc_softmax_plan(
        support.data_ptr(), out.data_ptr(), n_mc, plan), "hc_softmax_plan")
    return tuple(plan)
