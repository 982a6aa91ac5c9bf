"""Kernel entry points and the fused core stages behind
``ProjSpec(backend="cuda")`` (mirrors ``repro/kernels/ops.py``).

``fused_forward``, ``fused_packed_forward`` and ``fused_learn`` are what
the dispatch point in ``core/bcpnn_layer.py`` calls for a cuda-tagged
projection.  Per projection they pick the kernels from the layout: dense,
patchy dense-resident (a binding ``nact``; the update is patchy only with
``patchy_traces``, else the dense update with the HC mask) or
compact-resident; a serving pack's int8 codes go to the int8 kernels of
``quant.py``, its fp32 or bf16 weights to the forward kernels.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from ..core.bcpnn_layer import (InferPack, Projection, ProjSpec, is_compact,
                                is_patchy)
from ..core.compact import cached_table
from ..core.traces import Traces, smoothing
from . import bcpnn_fwd as _fwd_module
from . import bcpnn_update as _update_module
from . import hc_softmax as _softmax_module
from . import patchy as _patchy_module
from . import quant as _quant_module
# The kernel entry points under the JAX package's names.  Note: the
# update kernel takes the (Hi, Hj) hypercolumn mask where the JAX entry
# point takes it expanded to (Ni, Nj).
from .bcpnn_fwd import bcpnn_fwd_cuda as bcpnn_fwd
from .bcpnn_update import bcpnn_update_cuda as bcpnn_update
from .hc_softmax import hc_softmax_cuda as hc_softmax
from .patchy import (compact_forward, compact_update, patchy_forward,
                     patchy_update)
from .quant import quant_compact_forward, quant_fwd, quant_patchy_forward

_KERNEL_MODULES = {"bcpnn_fwd": _fwd_module, "bcpnn_update": _update_module,
                   "hc_softmax": _softmax_module}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last reset (CPU calls, which
    run the plain versions, do not count)."""
    counts = {name: m.LAUNCHES for name, m in _KERNEL_MODULES.items()}
    counts.update(_patchy_module.LAUNCHES)
    counts.update(_quant_module.LAUNCHES)
    return counts


def device_kernels() -> Dict[str, Tuple[str, ...]]:
    """Under ``launch_counts()``'s keys, the device kernels one call of
    each entry point launches: patterns (``re.search``) of the profiler's
    kernel names, each starting with a ``__global__`` of ``csrc/*.cu``.
    Entries that share a body (the forwards; the updates) name its
    instantiation at their layout, so no kernel matches two entries."""
    kernels = {name: m.DEVICE_KERNELS for name, m in _KERNEL_MODULES.items()}
    kernels.update(_patchy_module.DEVICE_KERNELS)
    kernels.update(_quant_module.DEVICE_KERNELS)
    return kernels


def set_launch_counts(counts: Dict[str, int]) -> None:
    """Set the counts of the kernels named in ``counts``."""
    for name, n in counts.items():
        if name in _KERNEL_MODULES:
            _KERNEL_MODULES[name].LAUNCHES = n
        elif name in _patchy_module.LAUNCHES:
            _patchy_module.LAUNCHES[name] = n
        else:
            _quant_module.LAUNCHES[name] = n


def reset_launch_counts() -> None:
    set_launch_counts({name: 0 for name in launch_counts()})


def add_launch_counts(delta: Dict[str, int]) -> None:
    """Add ``delta`` to the counts: what one replay of a captured step
    launched, since a replay runs none of the wrappers that count."""
    now = launch_counts()
    set_launch_counts({name: now[name] + n for name, n in delta.items()})


def _table(proj: Union[Projection, InferPack], spec: ProjSpec) -> torch.Tensor:
    """The patchy index table: the state's or pack's leaf, else the
    mask-identity memo (dense-resident state)."""
    if proj.table is not None:
        return proj.table
    return cached_table(proj.mask, spec.nact)


# ------------------------------------------------- fused core stages ----

def fused_forward(proj: Union[Projection, InferPack], spec: ProjSpec,
                  x: torch.Tensor) -> torch.Tensor:
    """Kernel-fused equivalent of core.bcpnn_layer.forward, from a
    projection or its fp32 or bf16 ``InferPack``.  Patchy projections
    stream only their live pre-units (exact: masked-out weights are zero);
    compact-resident ones read their (Hj, K, Mj) weights as they are."""
    if proj.w.dim() == 3:
        return compact_forward(x, proj.w, proj.b, proj.table, spec.pre.M,
                               spec.gain)
    if is_patchy(spec):
        return patchy_forward(x, proj.w, proj.b, _table(proj, spec),
                              spec.pre.M, spec.post.H, spec.post.M, spec.gain)
    return bcpnn_fwd(x, proj.w, proj.b, spec.post.H, spec.post.M, spec.gain)


def fused_packed_forward(pack: InferPack, spec: ProjSpec,
                         x: torch.Tensor) -> torch.Tensor:
    """Kernel-fused forward from an ``InferPack`` (DESIGN.md §8).  int8
    packs run the int8 kernels with the pack's per-HC scales folded into
    the softmax epilogue: compact-resident codes ``quant_compact_forward``,
    patchy dense-resident ones ``quant_patchy_forward``, dense ones
    ``quant_fwd``.  fp32 and bf16 packs run the forward kernels of
    ``fused_forward``, which widen bf16 weights to fp32 in their tile
    loads.  The patchy index table comes from the pack, never from the
    mask."""
    if pack.w.dtype != torch.int8:
        return fused_forward(pack, spec, x)
    if pack.w.dim() == 3:
        return quant_compact_forward(x, pack.w, pack.b, pack.scale,
                                     pack.table, spec.pre.M, spec.gain)
    if is_patchy(spec) and pack.table is not None:
        return quant_patchy_forward(x, pack.w, pack.b, pack.scale, pack.table,
                                    spec.pre.M, spec.post.H, spec.post.M,
                                    spec.gain)
    return quant_fwd(x, pack.w, pack.b, pack.scale, spec.post.H, spec.post.M,
                     spec.gain)


def fused_learn(proj: Projection, spec: ProjSpec, x: torch.Tensor,
                y: torch.Tensor, count: Optional[torch.Tensor] = None, *,
                donate: bool = False) -> Projection:
    """Kernel-fused equivalent of core.bcpnn_layer.learn.

    The cheap vector traces (p_i, p_j) and the smoothing ``a`` update in
    plain torch on the device (``a`` stays a 0-d tensor, so there is no
    host sync); the joint-trace EMA and weight fold run in the update
    kernel of the projection's layout.  ``count`` (0-d, optional) is the
    number of genuine rows of a batch whose pad rows are zero: every batch
    statistic divides by it instead of B (``learn_masked``).

    ``donate=True`` writes the new state over ``proj``'s own tensors (the
    update kernel's pij' over pij and w over w, the vectors and the clock
    in place) and returns a Projection of those same tensors: what a
    captured step needs, whose every operand keeps its address.  The
    arithmetic is the same, so the result is the same bit for bit."""
    if is_compact(spec) and proj.table is None:
        raise ValueError(
            "fused_learn: ProjSpec.compact projection carries a dense-layout "
            "state (no index-table leaf); convert it with "
            "core.compact.compactify_state — the dense-compute reference of "
            "the compact semantics lives on the torch backend only")
    tr = proj.traces
    a = smoothing(tr, spec.alpha)
    if count is None:
        xm, ym = x.mean(dim=0), y.mean(dim=0)
    else:
        xm, ym = x.sum(dim=0) / count, y.sum(dim=0) / count
    # In place, each result goes to its own tensor once the old value has
    # been read: pi and pj after their EMA, b (= log p_j) before the
    # update kernel reads it, the clock after ``a``.
    pi = torch.add((1.0 - a) * tr.pi, a * xm,
                   out=tr.pi if donate else None)
    pj = torch.add((1.0 - a) * tr.pj, a * ym,
                   out=tr.pj if donate else None)
    log_pi = torch.log(torch.clamp(pi, spec.eps, 1.0))
    log_pj = torch.log(torch.clamp(pj, spec.eps, 1.0),
                       out=proj.b if donate else None)
    out = (tr.pij, proj.w) if donate else None
    if is_compact(spec):
        new_pij, w = compact_update(tr.pij, log_pi, log_pj, x, y, proj.table,
                                    a, spec.pre.M, eps=spec.eps, count=count,
                                    out=out)
    elif is_patchy(spec) and spec.patchy_traces:
        new_pij, w = patchy_update(tr.pij, log_pi, log_pj, x, y,
                                   _table(proj, spec), a, spec.pre.M,
                                   spec.post.H, spec.post.M, eps=spec.eps,
                                   count=count, out=out)
    else:
        new_pij, w = bcpnn_update(tr.pij, log_pi, log_pj, x, y, proj.mask, a,
                                  eps=spec.eps, count=count, out=out)
    t = tr.t.add_(1) if donate else tr.t + 1
    return Projection(
        traces=Traces(pi=pi, pj=pj, pij=new_pij, t=t, t_host=tr.t_host + 1),
        w=w, b=log_pj, mask=proj.mask, table=proj.table,
    )
