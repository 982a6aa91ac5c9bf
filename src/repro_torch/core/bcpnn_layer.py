"""BCPNN projection: a plastic, patchily connected weight matrix between
two hypercolumnar populations, plus its probability traces (mirrors
``repro/core/bcpnn_layer.py``).

Each projection carries a ``backend`` tag in its spec:

  * ``"torch"`` — plain PyTorch ops in this module (the JAX package's
                  ``"jnp"`` reference);
  * ``"cuda"``  — the hand-written Hopper kernels in ``kernels/`` (the JAX
                  package's ``"pallas"``).  A kernel wrapper handed CPU
                  tensors runs its plain version, so ``"cuda"`` specs also
                  run on a CPU-resident state.

``forward`` / ``support`` / ``normalize`` / ``learn`` are the single
dispatch point.  Three layouts share ``Projection``: dense (no ``nact``
budget), patchy dense-resident (a binding ``nact``; with
``patchy_traces`` silent synapses hold their joint trace), and
compact-resident (``compact``: ``pij``/``w`` are (Hj, K, Mj) and
``table`` holds the (Hj, nact) active pre-HCs).

Learning state is fp32 whatever ``infer_dtype`` says (DESIGN.md §8): the
serving dtype enters only through the derived ``InferPack`` of
``pack_projection`` (bf16 casts, int8 per-post-HC codes and scales), read
by ``packed_forward``/``packed_support``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .hypercolumns import LayerGeom, hc_softmax
from .traces import (Traces, init_traces, mutual_information,
                     update_traces_from_stats, weights_from_traces)

BACKENDS = ("torch", "cuda")

# Serving dtypes of the dtype-polymorphic inference path.
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

    def with_infer_dtype(self, infer_dtype: str) -> "ProjSpec":
        return dataclasses.replace(self, infer_dtype=infer_dtype)


@dataclasses.dataclass
class Projection:
    """Learnable state of a projection: the dense layout (``w`` and
    ``traces.pij`` (Ni, Nj), ``table`` None) or the compact-resident one
    (``w`` and ``traces.pij`` (Hj, K, Mj) with K = nact*Mi, ``table`` the
    (Hj, nact) active pre-HCs, rebuilt only by ``rewire``)."""

    traces: Traces
    w: torch.Tensor     # (Ni, Nj) masked | (Hj, K, Mj) compact log-odds
    b: torch.Tensor     # (Nj,)    log-prior biases
    mask: torch.Tensor  # (Hi, Hj) float {0,1} structural connectivity
    table: Optional[torch.Tensor] = None  # (Hj, nact) int32, compact only


@dataclasses.dataclass
class InferPack:
    """Forward-only view of one projection in its serving dtype (DESIGN.md
    §8), built by ``pack_projection`` from the fp32 state at fold
    boundaries: ``w`` is cast (bf16) or per-post-HC quantized (int8, with
    ``scale``), in the dense (Ni, Nj) or compact (Hj, K, Mj) layout of its
    projection; fp32 packs alias the projection's own tensors.  Patchy
    packs carry their index table as data."""

    w: torch.Tensor                       # weights in the serving dtype
    b: torch.Tensor                       # (Nj,) log-prior bias
    scale: Optional[torch.Tensor] = None  # (Hj,) per-post-HC scales, int8
    table: Optional[torch.Tensor] = None  # (Hj, nact), patchy only


def is_patchy(spec: ProjSpec) -> bool:
    """True when the projection has a binding connectivity budget."""
    return spec.nact is not None and spec.nact < spec.pre.H


def is_compact(spec: ProjSpec) -> bool:
    """True when the projection keeps its state compact-resident."""
    return spec.compact


def _compact_ops():
    # Lazy: core.compact imports this module for the Projection type.
    from . import compact
    return compact


def _quant_ops():
    # Lazy: the kernels package imports this module for the state types.
    from ..kernels import quant
    return quant


def validate_patchy_mask(mask: torch.Tensor, spec: ProjSpec,
                         where: str = "projection") -> None:
    """Host-side deployment guard (reads the mask back; never per step):
    the patchy kernels assume at most ``nact`` live pre-HCs per column; a
    column with more would be truncated by the index table."""
    if not is_patchy(spec):
        return
    per_col = mask.detach().cpu().numpy().sum(axis=0)
    if (per_col > spec.nact).any():
        raise ValueError(
            f"{where}: patchy mask has a column with {int(per_col.max())} "
            f"active pre-HCs, exceeding nact={spec.nact}; the compact "
            f"kernels would drop connections. Rebuild the mask with "
            f"topk_mask (e.g. rewire) before serving.")


def validate_patchy_state(proj: Projection, spec: ProjSpec,
                          where: str = "projection") -> None:
    """Host-side deployment guard over the whole projection: the mask
    invariant of ``validate_patchy_mask`` plus, for compact-resident
    projections, an index table of the compact shapes that agrees with
    the mask."""
    validate_patchy_mask(proj.mask, spec, where=where)
    if not is_compact(spec):
        return
    hj, mj = spec.post.H, spec.post.M
    k = spec.nact * spec.pre.M
    if proj.table is None:
        raise ValueError(
            f"{where}: compact-resident projection has no index table "
            f"leaf; was this state built dense? Convert it with "
            f"core.compact.compactify_state.")
    for name, leaf, want in (("pij", proj.traces.pij, (hj, k, mj)),
                             ("w", proj.w, (hj, k, mj)),
                             ("table", proj.table, (hj, spec.nact))):
        if tuple(leaf.shape) != want:
            raise ValueError(
                f"{where}: compact leaf {name} has shape "
                f"{tuple(leaf.shape)}, expected {want}")
    if not _compact_ops().table_matches_mask(proj.mask, proj.table,
                                             spec.nact):
        mask = proj.mask.detach().cpu().numpy()
        table = proj.table.detach().cpu().numpy()
        for j in range(hj):
            live = np.flatnonzero(mask[:, j])
            if not np.array_equal(np.sort(table[j]), live):
                raise ValueError(
                    f"{where}: compact index table disagrees with the mask "
                    f"at post-HC {j} (table {np.sort(table[j]).tolist()} vs "
                    f"mask {live.tolist()}); rebuild the table from the "
                    f"mask (core.compact.build_table) before serving.")
        raise ValueError(
            f"{where}: compact index table disagrees with the mask; "
            f"rebuild it from the mask (core.compact.build_table) before "
            f"serving.")


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
    drawn from ``generator``, and the weights folded from those traces.
    With a binding ``nact`` each post-HC starts from a random exactly-nact
    set of pre-HCs (scores drawn from ``generator`` after the traces);
    compact specs are then gathered into the (Hj, K, Mj) layout.  The
    state lives on the generator's device."""
    tr = init_traces(spec.pre.N, spec.post.N, spec.pre.M, spec.post.M,
                     generator=generator)
    dev = generator.device
    if is_patchy(spec):
        scores = torch.rand((spec.pre.H, spec.post.H), generator=generator,
                            device=dev)
        mask = topk_mask(scores, spec.nact)
    else:
        mask = torch.ones((spec.pre.H, spec.post.H), dtype=torch.float32,
                          device=dev)
    w, b = weights_from_traces(tr, spec.eps)
    proj = Projection(traces=tr, w=apply_hc_mask(w, mask, spec), b=b,
                      mask=mask)
    if is_compact(spec):
        proj = _compact_ops().compactify_projection(proj, spec)
    return proj


# ------------------------------------------------------------- dispatch --

def _kernel_ops():
    # Imported lazily: kernels.ops imports this module for the state types.
    from ..kernels import ops
    return ops


def forward(proj: Projection, spec: ProjSpec, x: torch.Tensor) -> torch.Tensor:
    """Activation stage: rates -> post-synaptic rates.   x: (B, Ni)."""
    if spec.backend == "cuda":
        return _kernel_ops().fused_forward(proj, spec, x)
    return hc_softmax(support(proj, spec, x), spec.post, spec.gain)


def support(proj: Projection, spec: ProjSpec, x: torch.Tensor) -> torch.Tensor:
    """Log-domain support (both backends: a bare matmul has no epilogue to
    fuse, and the JAX package also leaves it to its compiler): ``b + x @
    w``, or for compact-resident state the gather of live pre-rates
    contracted against the (Hj, K, Mj) weights.  fp32 matmuls on the card
    stay fp32 unless TF32 is enabled globally, which the port never
    does."""
    if proj.w.ndim == 3:
        return _compact_ops().compact_support(x, proj.w, proj.b, proj.table,
                                              spec.pre.M)
    return proj.b[None, :] + x @ proj.w


def normalize(support_vals: torch.Tensor, spec: ProjSpec) -> torch.Tensor:
    """Divisive normalization of a post-population support matrix."""
    if spec.backend == "cuda":
        return _kernel_ops().hc_softmax(support_vals, spec.post.H,
                                        spec.post.M, spec.gain)
    return hc_softmax(support_vals, spec.post, spec.gain)


def learn(proj: Projection, spec: ProjSpec, x: torch.Tensor,
          y: torch.Tensor, *, donate: bool = False) -> Projection:
    """Plasticity stage: one streaming batch update of traces + weights.
    ``donate=True`` writes the result over ``proj``'s own tensors (see
    ``write_back``); by default ``proj`` is left as it was."""
    if spec.backend == "cuda":
        return _kernel_ops().fused_learn(proj, spec, x, y, donate=donate)
    if is_compact(spec) and proj.table is not None:
        new = _compact_ops().learn_compact_torch(proj, spec, x, y)
    else:
        new = _learn_torch(proj, spec, x, y)
    return write_back(proj, new) if donate else new


def write_back(old: Projection, new: Projection) -> Projection:
    """``new``'s values copied into ``old``'s tensors, returned as a
    Projection of those tensors with ``new``'s host clock: a donated step
    keeps every tensor of its state at its address, which a captured step
    reads and writes.  The kernel path writes its results in place and
    needs no copy; this serves the plain backend and the rewire."""
    pairs = [(old.traces.pi, new.traces.pi), (old.traces.pj, new.traces.pj),
             (old.traces.pij, new.traces.pij), (old.traces.t, new.traces.t),
             (old.w, new.w), (old.b, new.b), (old.mask, new.mask)]
    if old.table is not None:
        pairs.append((old.table, new.table))
    for dst, src in pairs:
        if dst is not src:
            dst.copy_(src)
    return Projection(
        traces=Traces(pi=old.traces.pi, pj=old.traces.pj,
                      pij=old.traces.pij, t=old.traces.t,
                      t_host=new.traces.t_host),
        w=old.w, b=old.b, mask=old.mask, table=old.table)


# ------------------------------------------- packed (serving) dispatch ----

def pack_projection(proj: Projection, spec: ProjSpec) -> InferPack:
    """The forward-only ``InferPack`` of one projection in
    ``spec.infer_dtype``, derived from the fp32 state: the fold-boundary
    half of the precision contract (DESIGN.md §8).  fp32 packs alias the
    state's tensors (packing is free); bf16 casts ``w`` and ``b``; int8
    quantizes ``w`` per post-HC.  Patchy packs get their index table: the
    compact state's leaf, or the mask-identity memo's."""
    table = proj.table
    if table is None and is_patchy(spec):
        table = _compact_ops().cached_table(proj.mask, spec.nact)
    if spec.infer_dtype == "bf16":
        return InferPack(w=proj.w.to(torch.bfloat16),
                         b=proj.b.to(torch.bfloat16), table=table)
    if spec.infer_dtype == "int8":
        q = _quant_ops()
        if proj.w.ndim == 3:
            w_q, scale = q.quantize_compact(proj.w)
        else:
            w_q, scale = q.quantize_dense(proj.w, spec.post.H, spec.post.M)
        return InferPack(w=w_q, b=proj.b, scale=scale, table=table)
    return InferPack(w=proj.w, b=proj.b, table=table)


def packed_forward(pack: InferPack, spec: ProjSpec,
                   x: torch.Tensor) -> torch.Tensor:
    """Activation stage from an ``InferPack`` (same dispatch contract as
    ``forward``, over the serving-dtype weights)."""
    if spec.backend == "cuda":
        return _kernel_ops().fused_packed_forward(pack, spec, x)
    return hc_softmax(packed_support(pack, spec, x), spec.post, spec.gain)


def packed_support(pack: InferPack, spec: ProjSpec,
                   x: torch.Tensor) -> torch.Tensor:
    """Log-domain support from an ``InferPack``, always fp32: fp32 and bf16
    packs contract in fp32; int8 runs the fixed-point plain arithmetic
    (quantized activations, scale-folded dequant).  Plain torch on both
    backends, as the JAX package leaves it to its compiler."""
    if pack.w.dtype == torch.int8:
        q = _quant_ops()
        if pack.w.ndim == 3:
            return q.quant_support_compact_torch(x, pack.w, pack.scale,
                                                 pack.b, pack.table,
                                                 spec.pre.M)
        return q.quant_support_dense_torch(x, pack.w, pack.scale, pack.b,
                                           spec.post.H, spec.post.M)
    w = pack.w.to(torch.float32)
    b = pack.b.to(torch.float32)
    if pack.w.ndim == 3:
        return _compact_ops().compact_support(x, w, b, pack.table,
                                              spec.pre.M)
    return b[None, :] + x @ w


# ------------------------------------------------------ torch reference ----

def apply_dense_stats(proj: Projection, spec: ProjSpec, xm: torch.Tensor,
                      ym: torch.Tensor, co: torch.Tensor) -> Projection:
    """EMA + plasticity semantics + weight fold on dense-layout state from
    precomputed batch statistics — the one implementation behind
    ``_learn_torch`` and ``learn_masked``.  With ``patchy_traces`` silent
    synapses hold their joint trace (patchy-held), or, for a compact spec
    on a dense-layout state, sit at the independence product p_i*p_j (the
    dense-compute oracle of the compact semantics)."""
    tr = update_traces_from_stats(proj.traces, xm, ym, co, spec.alpha)
    if is_patchy(spec) and spec.patchy_traces:
        hi, mi, hj, mj = spec.pre.H, spec.pre.M, spec.post.H, spec.post.M
        keep = proj.mask[:, None, :, None] > 0
        if is_compact(spec):
            off = torch.outer(tr.pi, tr.pj).reshape(hi, mi, hj, mj)
        else:
            off = proj.traces.pij.reshape(hi, mi, hj, mj)
        pij = torch.where(keep, tr.pij.reshape(hi, mi, hj, mj), off)
        tr = Traces(pi=tr.pi, pj=tr.pj,
                    pij=pij.reshape(spec.pre.N, spec.post.N), t=tr.t,
                    t_host=tr.t_host)
    w, b = weights_from_traces(tr, spec.eps)
    w = apply_hc_mask(w, proj.mask, spec)
    return Projection(traces=tr, w=w, b=b, mask=proj.mask, table=proj.table)


def _learn_torch(proj: Projection, spec: ProjSpec, x: torch.Tensor,
                 y: torch.Tensor) -> Projection:
    """Dense-layout reference of all three plasticity semantics."""
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
                 y: torch.Tensor, valid: torch.Tensor, *,
                 donate: bool = False) -> Projection:
    """Plasticity step over a zero-padded tail batch: batch stats divide
    by the number of GENUINE rows (``valid`` 0/1 per row), so pad slots are
    inert.  On ``"cuda"`` the update kernel takes the zeroed rows with that
    count, read on the device, as its divisor.  (The JAX package runs this
    step plain on both backends: its Pallas kernels bake in a static batch
    divisor.)  ``donate`` as in ``learn``."""
    xv, yv, n = masked_inputs(x, y, valid)
    if spec.backend == "cuda":
        return _kernel_ops().fused_learn(proj, spec, xv, yv, count=n,
                                         donate=donate)
    xm = xv.sum(dim=0) / n
    ym = yv.sum(dim=0) / n
    if is_compact(spec) and proj.table is not None:
        c = _compact_ops()
        co_c = c.compact_co_stats(xv, yv, proj.table, spec.pre.M,
                                  spec.post.M, n_valid=n)
        new = c.apply_compact_stats(proj, spec, xm, ym, co_c)
    else:
        new = apply_dense_stats(proj, spec, xm, ym, (xv.T @ yv) / n)
    return write_back(proj, new) if donate else new


# ------------------------------------------------ structural plasticity ----

def maybe_rewire(proj: Projection, spec: ProjSpec, *,
                 donate: bool = False) -> Projection:
    """Rewire when the projection's trace clock is a ``struct_every``
    multiple, else pass through.  The decision reads the clock's host
    mirror (``Traces.t_host``), so it costs no read from the card.  The
    one rewire entry of the unsupervised step and the online fold.
    ``donate=True`` writes the new mask, weights, bias (and, compact, the
    re-gathered pij and the table) over ``proj``'s own tensors."""
    if spec.struct_every <= 0 or proj.traces.t_host % spec.struct_every:
        return proj
    new = rewire(proj, spec)
    return write_back(proj, new) if donate else new


def rewire(proj: Projection, spec: ProjSpec) -> Projection:
    """Structural plasticity: keep the top-nact highest-MI pre-HCs per
    post-HC, on the device.  Cold path (every ``struct_every`` steps), so
    plain torch on both backends.  It makes a NEW mask tensor, which
    misses the identity memo of dense-resident tables
    (``core.compact.cached_table``); compact-resident state rebuilds its
    table leaf in ``rewire_compact``."""
    if not is_patchy(spec):
        return proj
    if is_compact(spec) and proj.table is not None:
        return _compact_ops().rewire_compact(proj, spec)
    mi = mutual_information(proj.traces, spec.pre.H, spec.pre.M, spec.post.H,
                            spec.post.M, spec.eps)
    mask = topk_mask(mi, spec.nact)
    w, b = weights_from_traces(proj.traces, spec.eps)
    w = apply_hc_mask(w, mask, spec)
    return Projection(traces=proj.traces, w=w, b=b, mask=mask)
