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

The cluster size is the launcher's search (``cluster_size``) unless the
caller names one (``cluster=``) or the autotune cache holds one for the
shape (``tuning.py``); a named size outside ``cluster_range`` raises.  A
cluster splits the contraction, so another size sums in another fp32
order: rates agree within the forward's tolerance, not bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from . import tuning
from ._build import (check_launch, library, require, require_current_device,
                     stream_ptr, weight_dtype)
from .ref import ref_bcpnn_fwd

# Kernel launches in this process (only where the kernel is launched).
LAUNCHES = 0
# The device kernels one call launches, as patterns (``re.search``) of the
# profiler's names for them, each starting with its ``__global__``: the
# forward body's dense instantiation (``FwdTile<BN, T, L>`` at ``Layout``
# 0, csrc/common.cuh); ``patchy.py``'s forwards launch it at 1 and 2.
DEVICE_KERNELS = (r"bcpnn_fwd_tc_kernel<.*FwdTile<\d+, \w+, 0>",)
# The cluster size each forward (this one, ``patchy_forward``,
# ``compact_forward``) last passed to its C entry point (0: the search's).
LAST_CLUSTER = {"bcpnn_fwd": 0, "patchy_forward": 0, "compact_forward": 0}


def bcpnn_fwd_cuda(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   n_hc: int, n_mc: int, gain: float = 1.0, *,
                   cluster: int = 0) -> torch.Tensor:
    """x: (B, Ni), w: (Ni, n_hc*n_mc), bias: (n_hc*n_mc,) -> rates (B, Nj).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (x float32; w and bias both float32 or both bfloat16; contiguous, one
    device) or raise.  ``cluster`` (CUDA only): the thread-block cluster
    size, within ``cluster_range``; 0 takes the autotune cache's for the
    shape, else the launcher's search (``cluster_size``)."""
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
    bf16 = wt == torch.bfloat16
    cluster = tuning.plan("bcpnn_fwd", {"cluster": cluster}, b=b, ni=ni,
                          n_hc=n_hc, n_mc=n_mc)["cluster"]
    check_cluster("bcpnn_fwd", cluster, b, ni, n_hc, n_mc, bf16, "dense")
    out = torch.empty((b, nj), dtype=torch.float32, device=x.device)
    rc = library().bcpnn_fwd(
        x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
        b, ni, n_hc, n_mc, int(bf16), cluster, ctypes.c_float(gain),
        stream_ptr(x))
    check_launch(rc, "bcpnn_fwd")
    LAUNCHES += 1
    LAST_CLUSTER["bcpnn_fwd"] = cluster
    return out


# Weight layouts of the forward body (csrc/common.cuh, Layout).
LAYOUTS = {"dense": 0, "patchy": 1, "compact": 2}


def _clusters(b: int, k: int, n_hc: int, n_mc: int, bf16: bool,
              layout: str):
    ks = (ctypes.c_int * 3)()
    rc = library().bcpnn_fwd_cluster(b, k, n_hc, n_mc, LAYOUTS[layout],
                                     int(bf16), ks)
    check_launch(rc, "bcpnn_fwd_cluster")
    return ks[0], ks[1], ks[2]


def cluster_size(b: int, k: int, n_hc: int, n_mc: int, bf16: bool = False,
                 layout: str = "dense") -> int:
    """The thread-block cluster size (blocks splitting the contraction)
    that the launcher's search picks for the forward of ``layout``
    (``bcpnn_fwd_cuda``, or ``patchy.patchy_forward``/``compact_forward``)
    at this shape on the current CUDA device; ``k`` is the contraction's
    depth (Ni dense, nact*Mi patchy and compact).  Launches nothing."""
    return _clusters(b, k, n_hc, n_mc, bf16, layout)[0]


def cluster_range(b: int, k: int, n_hc: int, n_mc: int, bf16: bool = False,
                  layout: str = "dense"):
    """(least, most): the cluster sizes a caller may name for this shape
    (``cluster_size``'s arguments): from the smallest whose shared memory
    fits to 8, and no more than the contraction's 16-deep slices unless
    the smallest is.  Launches nothing."""
    return _clusters(b, k, n_hc, n_mc, bf16, layout)[1:]


def check_cluster(name: str, cluster: int, b: int, k: int, n_hc: int,
                  n_mc: int, bf16: bool, layout: str) -> None:
    """Raise ``ValueError`` unless ``cluster`` is 0 (the search's) or
    within ``cluster_range`` (a named size is never clamped)."""
    if cluster == 0:
        return
    lo, hi = cluster_range(b, k, n_hc, n_mc, bf16, layout)
    if not lo <= cluster <= hi:
        raise ValueError(f"{name}: cluster {cluster} is not in [{lo}, {hi}] "
                         f"for this shape (0: the launcher's search)")
