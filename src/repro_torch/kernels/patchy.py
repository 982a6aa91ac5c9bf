"""Patchy-sparse activation and plasticity on Hopper: the four entry points
of structural plasticity, under the JAX package's names.

Replace the Pallas TPU kernels of ``repro/kernels/patchy.py``:

  * ``patchy_forward`` / ``compact_forward`` -> ``csrc/bcpnn.cu::
    bcpnn_fwd_tc_kernel`` with the patchy or compact layout, the dense
    forward's body: one thread-block cluster per (128-row batch tile,
    post-HC) splits the HC's K = nact*Mi live pre-units between its
    blocks in 16-deep slices.  Each block reads its row of the (Hj, nact)
    index table once; its staging warps gather x's live columns by
    cp.async (runs of Mi units, 8-byte pieces at Mi = 2) and the patchy
    layout's live rows of the dense-resident (Ni, Hj*Mj) w in 16-byte
    pieces, while the compact layout's (Hj, K, Mj) w comes by TMA, one box
    a slice.  They split each slice once into TF32 hi and lo halves, and
    two warpgroups multiply them with ``wgmma`` in 3xTF32 (fp32 accuracy;
    ``ref.split_tf32_mm`` models it), each slice's products added into
    the block's sum in fp32 (``bcpnn_fwd``).  The cluster sums its partial
    supports in distributed shared memory, in rank order, and the HC
    softmax is the epilogue, in registers.  The JAX wrappers gather x into
    an (Hj, B, K) array first; here it never exists.
  * ``patchy_update`` -> ``csrc/bcpnn.cu::trace_update_kernel`` with the
    patchy layout, the body of the dense update, in one launch writing
    every (Ni, Nj) entry once.  Gathered tiles hold a post-HC's K live
    rows (through its table row) and run the 3xTF32 product, the EMA and
    the fold on them only; copy tiles cover the (Ni, Nj) grid and write
    the silent entries back as read (pij held bit for bit, w 0), building
    their live predicate from the table rows of the post-HCs they cover.
    Fresh outputs, no copy or memset beforehand, or the caller's (``out``):
    written over pij in place, silent entries are stored as they were read
    and live entries only by the gathered tile that read them.
  * ``compact_update`` -> ``csrc/bcpnn.cu::trace_update_kernel`` with the
    compact layout, the same body: gathered tiles of a post-HC's K live
    rows (x gathered through its table row), the 3xTF32 product, the EMA
    and the fold, over the resident (Hj, K, Mj) arrays (a tile's rows are
    one contiguous run).

Bounds at Model 1-struct (B=128, Ni=1568, Hj=32, Mj=128, nact=128, K=256):
the forwards move ~7.1 MB (x, the live weights once, bias, rates), ~2.1
us at 3.35 TB/s, above their 3 x 268 MFLOP at the TF32 rate (~1.6 us);
``compact_update`` moves 15.5 MB, ~4.6 us (its 3 x 268 MFLOP ~1.6 us);
``patchy_update`` reads pij and writes full (Ni, Nj) pij' and w, 77 MB,
~23 us, as the dense update (its copy tiles also read the 16 % of live
rows that the gathered tiles read: 4.1 MB more).

``alpha`` and ``count`` (the genuine rows of a zero-padded batch, which
divide XᵀY in place of B) are 0-d device tensors: no host sync.  A CPU
tensor takes the plain version in ``ref.py``; a CUDA tensor launches the
kernel or raises.  The forwards also read the bf16 weights and bias of a
bf16 serving pack, widened to fp32 when a slice is split (exact in TF32,
so two products).  The table must hold
pre-HC indices in [0, Ni/Mi): it is
built by ``core.compact.build_table`` and checked at the deployment
boundary (``validate_patchy_state``), not per launch.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import tuning
from ._build import (check_launch, check_table, library, require,
                     require_current_device, require_outputs, stream_ptr,
                     weight_dtype)
from .bcpnn_fwd import LAST_CLUSTER, check_cluster
from .ref import (ref_compact_forward, ref_compact_update, ref_patchy_forward,
                  ref_patchy_update)

# Kernel launches in this process, per entry point (only where a kernel is
# launched).
LAUNCHES = {"patchy_forward": 0, "compact_forward": 0, "patchy_update": 0,
            "compact_update": 0}
# The device kernels one call of each launches, as patterns (``re.search``)
# of the profiler's names for them, each starting with its ``__global__``:
# the dense bodies' instantiations at ``Layout`` 1 (patchy) and 2
# (compact), csrc/common.cuh.
DEVICE_KERNELS = {
    "patchy_forward": (r"bcpnn_fwd_tc_kernel<.*FwdTile<\d+, \w+, 1>",),
    "compact_forward": (r"bcpnn_fwd_tc_kernel<.*FwdTile<\d+, \w+, 2>",),
    "patchy_update": (r"trace_update_kernel<1,",),
    "compact_update": (r"trace_update_kernel<2,",)}


def _forward(name: str, x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
             table: torch.Tensor, mi: int, hj: int, mj: int, gain: float,
             compact: bool, cluster: int) -> torch.Tensor:
    require_current_device(x)
    dev = x.device
    b, ni = x.shape
    nact = check_table(table, hj, ni, mi, dev)
    wt = weight_dtype(w)
    require(x, "x", (b, ni), dev)
    require(w, "w", (hj, nact * mi, mj) if compact else (ni, hj * mj), dev,
            wt)
    require(bias, "bias", (hj * mj,), dev, wt)
    bf16 = wt == torch.bfloat16
    cluster = tuning.plan(name, {"cluster": cluster}, b=b, ni=ni, n_hc=hj,
                          n_mc=mj, nact=nact, mi=mi)["cluster"]
    check_cluster(name, cluster, b, nact * mi, hj, mj, bf16,
                  "compact" if compact else "patchy")
    out = torch.empty((b, hj * mj), dtype=torch.float32, device=dev)
    rc = library().bcpnn_patchy_fwd(
        x.data_ptr(), w.data_ptr(), bias.data_ptr(), table.data_ptr(),
        out.data_ptr(), b, ni, hj, mj, mi, nact, int(compact), int(bf16),
        cluster, ctypes.c_float(gain), stream_ptr(x))
    check_launch(rc, name)
    LAUNCHES[name] += 1
    LAST_CLUSTER[name] = cluster
    return out


def patchy_forward(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   table: torch.Tensor, mi: int, hj: int, mj: int,
                   gain: float = 1.0, *, cluster: int = 0) -> torch.Tensor:
    """x (B, Ni), dense-resident masked w (Ni, Hj*Mj), bias (Hj*Mj,),
    table (Hj, nact) -> rates (B, Hj*Mj).  ``cluster`` as for
    ``bcpnn_fwd.bcpnn_fwd_cuda``."""
    if x.device.type == "cpu":
        return ref_patchy_forward(x, w, bias, table, mi, hj, mj, gain)
    return _forward("patchy_forward", x, w, bias, table, mi, hj, mj, gain,
                    compact=False, cluster=cluster)


def compact_forward(x: torch.Tensor, w_c: torch.Tensor, bias: torch.Tensor,
                    table: torch.Tensor, mi: int,
                    gain: float = 1.0, *, cluster: int = 0) -> torch.Tensor:
    """x (B, Ni), compact-resident w_c (Hj, K, Mj), bias (Hj*Mj,), table
    (Hj, nact) -> rates (B, Hj*Mj).  ``cluster`` as for
    ``bcpnn_fwd.bcpnn_fwd_cuda``."""
    if x.device.type == "cpu":
        return ref_compact_forward(x, w_c, bias, table, mi, gain)
    if w_c.dim() != 3:
        raise ValueError(f"w_c has shape {tuple(w_c.shape)}, expected "
                         f"(Hj, K, Mj)")
    hj, _, mj = w_c.shape
    return _forward("compact_forward", x, w_c, bias, table, mi, hj, mj, gain,
                    compact=True, cluster=cluster)


def _update(name: str, pij: torch.Tensor, log_pi: torch.Tensor,
            log_pj: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
            table: torch.Tensor, alpha, mi: int, hj: int, mj: int, eps: float,
            count: Optional[torch.Tensor], compact: bool,
            out: Optional[Tuple[torch.Tensor, torch.Tensor]]):
    require_current_device(pij)
    dev = pij.device
    b, ni = x.shape
    if b <= 0:
        raise ValueError(f"{name} needs a non-empty batch")
    nact = check_table(table, hj, ni, mi, dev)
    a = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    shape = (hj, nact * mi, mj) if compact else (ni, hj * mj)
    for t, what, want in ((pij, "pij", shape), (log_pi, "log_pi", (ni,)),
                          (log_pj, "log_pj", (hj * mj,)), (x, "x", (b, ni)),
                          (y, "y", (b, hj * mj)), (a, "alpha", ())):
        require(t, what, want, dev)
    if count is not None:
        require(count, "count", (), dev)
    new_pij, w = require_outputs(out, pij, dev)
    rc = library().bcpnn_patchy_update(
        pij.data_ptr(), log_pi.data_ptr(), log_pj.data_ptr(), x.data_ptr(),
        y.data_ptr(), table.data_ptr(), a.data_ptr(),
        None if count is None else count.data_ptr(), new_pij.data_ptr(),
        w.data_ptr(), b, ni, hj, mj, mi, nact, int(compact),
        ctypes.c_float(eps * eps), stream_ptr(pij))
    check_launch(rc, name)
    LAUNCHES[name] += 1
    return new_pij, w


def patchy_update(pij: torch.Tensor, log_pi: torch.Tensor,
                  log_pj: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                  table: torch.Tensor, alpha, mi: int, hj: int, mj: int,
                  eps: float = 1e-4, count: Optional[torch.Tensor] = None,
                  out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Patchy-held plasticity on dense-resident traces.  pij (Ni, Hj*Mj);
    log_pi (Ni,); log_pj (Hj*Mj,); x (B, Ni); y (B, Hj*Mj); table
    (Hj, nact).  Returns (new_pij, new_w), (Ni, Hj*Mj), fresh or ``out``:
    live entries the EMA and the fold, silent pij held, silent w 0."""
    if pij.device.type == "cpu":
        return ref_patchy_update(pij, log_pi, log_pj, x, y, table, alpha, mi,
                                 hj, mj, eps, count, out)
    return _update("patchy_update", pij, log_pi, log_pj, x, y, table, alpha,
                   mi, hj, mj, eps, count, False, out)


def compact_update(pij_c: torch.Tensor, log_pi: torch.Tensor,
                   log_pj: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                   table: torch.Tensor, alpha, mi: int, eps: float = 1e-4,
                   count: Optional[torch.Tensor] = None,
                   out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Scatter-free compact plasticity on the resident (Hj, K, Mj) trace.
    Returns (new_pij_c, new_w_c), both (Hj, K, Mj), fresh or ``out``."""
    if pij_c.device.type == "cpu":
        return ref_compact_update(pij_c, log_pi, log_pj, x, y, table, alpha,
                                  mi, eps, count, out)
    if pij_c.dim() != 3:
        raise ValueError(f"pij_c has shape {tuple(pij_c.shape)}, expected "
                         f"(Hj, K, Mj)")
    hj, _, mj = pij_c.shape
    return _update("compact_update", pij_c, log_pi, log_pj, x, y, table,
                   alpha, mi, hj, mj, eps, count, True, out)
