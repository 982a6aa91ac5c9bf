"""BCPNN projection: a plastic weight matrix between two hypercolumnar
populations, plus its probability traces (mirrors
``repro/core/bcpnn_layer.py``).

Each projection carries a ``backend`` tag in its spec:

  * ``"torch"`` — plain PyTorch ops in this module (the JAX package's
                  ``"jnp"`` reference);
  * ``"cuda"``  — the hand-written Hopper kernels in ``kernels/`` (the JAX
                  package's ``"pallas"``).  A kernel wrapper handed CPU
                  tensors runs its plain version, so ``"cuda"`` specs also
                  run on a CPU-resident state.

``forward`` / ``support`` / ``normalize`` / ``learn`` are the single
dispatch point.  This slice ports the dense layout: a binding ``nact``
budget (patchy), ``compact`` and ``infer_dtype != "fp32"`` are accepted by
``ProjSpec`` (so specs round-trip) and raise ``NotImplementedError`` when
used.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .hypercolumns import LayerGeom, hc_softmax
from .traces import (Traces, init_traces, update_traces_from_stats,
                     weights_from_traces)

BACKENDS = ("torch", "cuda")

# Serving dtypes of the JAX package's dtype-polymorphic inference path;
# only fp32 is ported.
INFER_DTYPES = ("fp32", "bf16", "int8")


@dataclasses.dataclass(frozen=True)
class ProjSpec:
    """Static configuration of a projection (every field of the JAX spec,
    so specs round-trip through ``spec_to_dict``/``spec_from_dict``)."""

    pre: LayerGeom
    post: LayerGeom
    alpha: float = 1e-3        # trace smoothing = dt / tau_p
    eps: float = 1e-4          # probability floor
    gain: float = 1.0          # softmax gain on support
    nact: Optional[int] = None  # active pre-HCs per post-HC (None = dense)
    backend: str = "cuda"      # "torch" plain ops | "cuda" hand kernels
    support_noise: float = 0.0  # exploration noise amplitude (unsup. only)
    noise_steps: int = 0       # anneal horizon in trace updates
    struct_every: int = 0      # rewire period in trace updates (0 = off)
    patchy_traces: bool = False
    compact: bool = False
    infer_dtype: str = "fp32"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"expected one of {BACKENDS}")
        if self.infer_dtype not in INFER_DTYPES:
            raise ValueError(f"unknown infer_dtype {self.infer_dtype!r}; "
                             f"expected one of {INFER_DTYPES}")
        if self.compact and not (self.patchy_traces and is_patchy(self)):
            raise ValueError(
                "ProjSpec.compact requires patchy_traces=True and a binding "
                f"nact budget (got nact={self.nact}, pre.H={self.pre.H}, "
                f"patchy_traces={self.patchy_traces})")

    def with_backend(self, backend: str) -> "ProjSpec":
        return dataclasses.replace(self, backend=backend)


@dataclasses.dataclass
class Projection:
    """Learnable state of a dense projection."""

    traces: Traces
    w: torch.Tensor     # (Ni, Nj) masked log-odds weights
    b: torch.Tensor     # (Nj,)    log-prior biases
    mask: torch.Tensor  # (Hi, Hj) float {0,1} structural connectivity


@dataclasses.dataclass
class InferPack:
    """Forward-only view of one projection in its serving dtype; fp32 packs
    (the only ones ported) alias the projection's own tensors."""

    w: torch.Tensor
    b: torch.Tensor


def is_patchy(spec: ProjSpec) -> bool:
    """True when the projection has a binding connectivity budget."""
    return spec.nact is not None and spec.nact < spec.pre.H


def require_dense_fp32(spec: ProjSpec, what: str) -> None:
    """Refuse the layouts and serving dtypes this slice has not ported."""
    if is_patchy(spec) or spec.compact:
        raise NotImplementedError(
            f"{what}: patchy/compact projections (nact={spec.nact} < "
            f"pre.H={spec.pre.H}, compact={spec.compact}) are not ported "
            f"yet (ROADMAP.md queue A item 4, queue B items 4-7)")
    if spec.infer_dtype != "fp32":
        raise NotImplementedError(
            f"{what}: infer_dtype={spec.infer_dtype!r} is not ported yet "
            f"(ROADMAP.md queue A item 5, queue B items 8-10)")


def apply_hc_mask(w: torch.Tensor, mask: torch.Tensor,
                  spec: ProjSpec) -> torch.Tensor:
    """Mask a (Ni, Nj) unit matrix with the (Hi, Hj) HC-level mask through
    the (Hi, Mi, Hj, Mj) view (no materialized unit mask)."""
    hi, mi, hj, mj = spec.pre.H, spec.pre.M, spec.post.H, spec.post.M
    w4 = w.reshape(hi, mi, hj, mj) * mask[:, None, :, None]
    return w4.reshape(spec.pre.N, spec.post.N)


def expand_hc_mask(mask: torch.Tensor, spec: ProjSpec) -> torch.Tensor:
    """(Hi, Hj) HC-level mask -> materialized (Ni, Nj) unit-level mask."""
    hi, mi, hj, mj = spec.pre.H, spec.pre.M, spec.post.H, spec.post.M
    m4 = mask[:, None, :, None].expand(hi, mi, hj, mj)
    return m4.reshape(spec.pre.N, spec.post.N)


def topk_mask(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Exactly-k column mask: scores (Hi, Hj) -> float {0,1} mask with
    exactly ``k`` ones per post-HC column.  Ties break toward the lower
    pre-HC index, as ``lax.top_k`` does: a stable descending sort keeps
    equal scores in index order (bare ``torch.topk`` promises no order)."""
    idx = torch.sort(scores.T, dim=-1, descending=True, stable=True).indices
    hot = torch.zeros(scores.T.shape, dtype=torch.float32,
                      device=scores.device)
    hot.scatter_(1, idx[:, :k], 1.0)
    return hot.T.contiguous()


def init_projection(spec: ProjSpec, generator: torch.Generator) -> Projection:
    """Uniform-prior traces with a log-normal joint-trace perturbation
    drawn from ``generator``, full connectivity, and the weights folded
    from those traces.  The state lives on the generator's device."""
    require_dense_fp32(spec, "init_projection")
    tr = init_traces(spec.pre.N, spec.post.N, spec.pre.M, spec.post.M,
                     generator=generator)
    mask = torch.ones((spec.pre.H, spec.post.H), dtype=torch.float32,
                      device=generator.device)
    w, b = weights_from_traces(tr, spec.eps)
    w = apply_hc_mask(w, mask, spec)
    return Projection(traces=tr, w=w, b=b, mask=mask)


# ------------------------------------------------------------- dispatch --

def _kernel_ops():
    # Imported lazily: kernels.ops imports this module for the state types.
    from ..kernels import ops
    return ops


def forward(proj: Projection, spec: ProjSpec, x: torch.Tensor) -> torch.Tensor:
    """Activation stage: rates -> post-synaptic rates.   x: (B, Ni)."""
    require_dense_fp32(spec, "forward")
    if spec.backend == "cuda":
        return _kernel_ops().fused_forward(proj, spec, x)
    return hc_softmax(support(proj, spec, x), spec.post, spec.gain)


def support(proj: Projection, spec: ProjSpec, x: torch.Tensor) -> torch.Tensor:
    """Log-domain support ``b + x @ w`` (both backends: a bare matmul has
    no epilogue to fuse, and the JAX package also leaves it to its
    compiler).  fp32 matmuls on the card stay fp32 unless TF32 is enabled
    globally, which the port never does."""
    require_dense_fp32(spec, "support")
    return proj.b[None, :] + x @ proj.w


def normalize(support_vals: torch.Tensor, spec: ProjSpec) -> torch.Tensor:
    """Divisive normalization of a post-population support matrix."""
    if spec.backend == "cuda":
        return _kernel_ops().hc_softmax(support_vals, spec.post.H,
                                        spec.post.M, spec.gain)
    return hc_softmax(support_vals, spec.post, spec.gain)


def learn(proj: Projection, spec: ProjSpec, x: torch.Tensor,
          y: torch.Tensor) -> Projection:
    """Plasticity stage: one streaming batch update of traces + weights."""
    require_dense_fp32(spec, "learn")
    if spec.backend == "cuda":
        return _kernel_ops().fused_learn(proj, spec, x, y)
    return _learn_torch(proj, spec, x, y)


# ------------------------------------------- packed (serving) dispatch ----

def pack_projection(proj: Projection, spec: ProjSpec) -> InferPack:
    """The forward-only ``InferPack`` of one projection; fp32 packs alias
    the state's tensors (packing is free)."""
    require_dense_fp32(spec, "pack_projection")
    return InferPack(w=proj.w, b=proj.b)


def packed_forward(pack: InferPack, spec: ProjSpec,
                   x: torch.Tensor) -> torch.Tensor:
    """Activation stage from an ``InferPack``."""
    if spec.backend == "cuda":
        return _kernel_ops().fused_forward(pack, spec, x)
    return hc_softmax(packed_support(pack, spec, x), spec.post, spec.gain)


def packed_support(pack: InferPack, spec: ProjSpec,
                   x: torch.Tensor) -> torch.Tensor:
    """Log-domain support from an fp32 ``InferPack``."""
    require_dense_fp32(spec, "packed_support")
    return pack.b[None, :] + x @ pack.w


# ------------------------------------------------------ torch reference ----

def apply_dense_stats(proj: Projection, spec: ProjSpec, xm: torch.Tensor,
                      ym: torch.Tensor, co: torch.Tensor) -> Projection:
    """EMA + weight fold on dense-layout state from precomputed batch
    statistics — the one implementation behind ``_learn_torch`` and
    ``learn_masked``."""
    require_dense_fp32(spec, "apply_dense_stats")
    tr = update_traces_from_stats(proj.traces, xm, ym, co, spec.alpha)
    w, b = weights_from_traces(tr, spec.eps)
    w = apply_hc_mask(w, proj.mask, spec)
    return Projection(traces=tr, w=w, b=b, mask=proj.mask)


def _learn_torch(proj: Projection, spec: ProjSpec, x: torch.Tensor,
                 y: torch.Tensor) -> Projection:
    """Dense-layout reference of the plasticity stage."""
    b = x.shape[0]
    return apply_dense_stats(proj, spec, x.mean(dim=0), y.mean(dim=0),
                             (x.T @ y) / b)


def masked_inputs(x: torch.Tensor, y: torch.Tensor, valid: torch.Tensor):
    """Zero the pad rows of a masked batch: returns ``(xv, yv, n)`` where
    rows with ``valid == 0`` are zeroed and ``n`` is the REAL row count
    (clamped to 1 so an all-pad batch stays finite)."""
    v = valid.to(x.dtype)
    n = torch.clamp_min(v.sum(), 1.0)
    return x * v[:, None], y * v[:, None], n


def learn_masked(proj: Projection, spec: ProjSpec, x: torch.Tensor,
                 y: torch.Tensor, valid: torch.Tensor) -> Projection:
    """Plasticity step over a zero-padded tail batch: batch stats divide
    by the number of GENUINE rows (``valid`` 0/1 per row), so pad slots are
    inert.  On ``"cuda"`` the update kernel takes the zeroed rows with that
    count, read on the device, as its divisor.  (The JAX package runs this
    step plain on both backends: its Pallas kernel bakes in a static batch
    divisor.)"""
    require_dense_fp32(spec, "learn_masked")
    xv, yv, n = masked_inputs(x, y, valid)
    if spec.backend == "cuda":
        return _kernel_ops().fused_learn(proj, spec, xv, yv, count=n)
    xm = xv.sum(dim=0) / n
    ym = yv.sum(dim=0) / n
    co = (xv.T @ yv) / n
    return apply_dense_stats(proj, spec, xm, ym, co)
