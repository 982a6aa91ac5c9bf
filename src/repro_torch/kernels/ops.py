"""Kernel entry points and the fused core stages behind
``ProjSpec(backend="cuda")`` (mirrors ``repro/kernels/ops.py``).

``fused_forward`` and ``fused_learn`` are what the dispatch point in
``core/bcpnn_layer.py`` calls for a cuda-tagged projection.  This slice
ports the dense layout; the patchy, compact and int8 branches of the JAX
module raise ``NotImplementedError`` until their kernels are ported
(ROADMAP.md queue B, items 4-10).
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from ..core.bcpnn_layer import (InferPack, Projection, ProjSpec,
                                require_dense_fp32)
from ..core.traces import Traces, smoothing
from . import bcpnn_fwd as _fwd_module
from . import bcpnn_update as _update_module
from . import hc_softmax as _softmax_module
# The kernel entry points under the JAX package's names.  Note: the
# update kernel takes the (Hi, Hj) hypercolumn mask where the JAX entry
# point takes it expanded to (Ni, Nj).
from .bcpnn_fwd import bcpnn_fwd_cuda as bcpnn_fwd
from .bcpnn_update import bcpnn_update_cuda as bcpnn_update
from .hc_softmax import hc_softmax_cuda as hc_softmax

_KERNEL_MODULES = {"bcpnn_fwd": _fwd_module, "bcpnn_update": _update_module,
                   "hc_softmax": _softmax_module}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last reset (CPU calls, which
    run the plain versions, do not count)."""
    return {name: m.LAUNCHES for name, m in _KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for m in _KERNEL_MODULES.values():
        m.LAUNCHES = 0


# ------------------------------------------------- fused core stages ----

def fused_forward(proj: Union[Projection, InferPack], spec: ProjSpec,
                  x: torch.Tensor) -> torch.Tensor:
    """Kernel-fused equivalent of core.bcpnn_layer.forward (dense), from a
    projection or its fp32 ``InferPack`` (both carry ``w`` and ``b``)."""
    require_dense_fp32(spec, "fused_forward")
    return bcpnn_fwd(x, proj.w, proj.b, spec.post.H, spec.post.M, spec.gain)


def fused_learn(proj: Projection, spec: ProjSpec, x: torch.Tensor,
                y: torch.Tensor,
                count: Optional[torch.Tensor] = None) -> Projection:
    """Kernel-fused equivalent of core.bcpnn_layer.learn (dense).

    The cheap vector traces (p_i, p_j) and the smoothing ``a`` update in
    plain torch on the device (``a`` stays a 0-d tensor, so there is no
    host sync); the O(Ni·Nj) joint-trace EMA and weight fold run in the
    update kernel.  ``count`` (0-d, optional) is the number of genuine rows
    of a batch whose pad rows are zero: every batch statistic divides by it
    instead of B (``learn_masked``)."""
    require_dense_fp32(spec, "fused_learn")
    tr = proj.traces
    a = smoothing(tr, spec.alpha)
    if count is None:
        xm, ym = x.mean(dim=0), y.mean(dim=0)
    else:
        xm, ym = x.sum(dim=0) / count, y.sum(dim=0) / count
    pi = (1.0 - a) * tr.pi + a * xm
    pj = (1.0 - a) * tr.pj + a * ym
    log_pi = torch.log(torch.clamp(pi, spec.eps, 1.0))
    log_pj = torch.log(torch.clamp(pj, spec.eps, 1.0))
    new_pij, w = bcpnn_update(tr.pij, log_pi, log_pj, x, y, proj.mask, a,
                              eps=spec.eps, count=count)
    return Projection(
        traces=Traces(pi=pi, pj=pj, pij=new_pij, t=tr.t + 1),
        w=w, b=log_pj, mask=proj.mask,
    )
