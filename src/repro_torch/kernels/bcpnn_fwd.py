"""Fused BCPNN activation stage on Hopper:
``rates = hc_softmax(gain * (bias + x @ w))`` in one kernel, the support
never written to device memory.

Replaces the Pallas TPU kernel ``repro/kernels/bcpnn_fwd.py::
bcpnn_fwd_pallas``.  CUDA source: ``csrc/bcpnn.cu::bcpnn_fwd_tc_kernel``:
one thread-block cluster per (128-row batch tile, post-HC) splits the
contraction between its blocks; in each, staging warps bring 16-deep
slices of x and w in by TMA, split them once into TF32 hi and lo halves
laid out as the tensor cores read them, and two warpgroups multiply them
with ``wgmma`` in 3xTF32 (lo·hi + hi·lo + hi·hi; fp32 accuracy, no
single TF32 pass; ``ref.split_tf32_mm`` models it), each slice's products
in a fresh tensor-core accumulator added into the sum in fp32 (the tensor
cores' own accumulator truncates at the running sum's magnitude, which
biases long contractions of large supports).  The cluster sums
its partial supports in distributed shared memory and the HC softmax is
the epilogue.

Bound: operations.  At Model 1 (B=128, Ni=1568, Nj=4096) the 3 x 1.64
GFLOP take ~10 us at the H100's 495 TFLOP/s TF32 rate; its 28.6 MB of
traffic take ~8.5 us.

A bf16 serving pack's weights and bias are read as bf16 and widened to
fp32 (the TPU kernel casts its operands the same way): half the weight
bytes, and a bf16 weight is exact in TF32, so two products suffice.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import (check_launch, library, require, require_current_device,
                     stream_ptr, weight_dtype)
from .ref import ref_bcpnn_fwd

# Kernel launches in this process (only where the kernel is launched).
LAUNCHES = 0


def bcpnn_fwd_cuda(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   n_hc: int, n_mc: int, gain: float = 1.0) -> torch.Tensor:
    """x: (B, Ni), w: (Ni, n_hc*n_mc), bias: (n_hc*n_mc,) -> rates (B, Nj).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (x float32; w and bias both float32 or both bfloat16; contiguous, one
    device) or raise."""
    global LAUNCHES
    if x.device.type == "cpu":
        return ref_bcpnn_fwd(x, w, bias, n_hc, n_mc, gain)
    require_current_device(x)
    b, ni = x.shape
    nj = n_hc * n_mc
    require(x, "x", (b, ni), x.device)
    wt = weight_dtype(w)
    require(w, "w", (ni, nj), x.device, wt)
    require(bias, "bias", (nj,), x.device, wt)
    out = torch.empty((b, nj), dtype=torch.float32, device=x.device)
    rc = library().bcpnn_fwd(
        x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
        b, ni, n_hc, n_mc, int(wt == torch.bfloat16), ctypes.c_float(gain),
        stream_ptr(x))
    check_launch(rc, "bcpnn_fwd")
    LAUNCHES += 1
    return out


# Weight layouts of the forward body (csrc/common.cuh, Layout).
LAYOUTS = {"dense": 0, "patchy": 1, "compact": 2}


def cluster_size(b: int, k: int, n_hc: int, n_mc: int, bf16: bool = False,
                 layout: str = "dense") -> int:
    """The thread-block cluster size (blocks splitting the contraction)
    that the forward of ``layout`` (``bcpnn_fwd_cuda``, or
    ``patchy.patchy_forward``/``compact_forward``) launches for this shape
    on the current CUDA device; ``k`` is the contraction's depth (Ni dense,
    nact*Mi patchy and compact).  Launches nothing."""
    ks = ctypes.c_int(0)
    rc = library().bcpnn_fwd_cluster(b, k, n_hc, n_mc, LAYOUTS[layout],
                                     int(bf16), ctypes.byref(ks))
    check_launch(rc, "bcpnn_fwd_cluster")
    return ks.value
