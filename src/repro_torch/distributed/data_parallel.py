"""Data-parallel train steps and epochs with an EXACT trace all-reduce
(mirrors ``repro/distributed/data_parallel.py``; DESIGN.md §7, §12).

Batch-mean co-activation traces are linear, so per-rank partial traces sum
to the global trace; but a batch-SPLIT decomposition (each rank contracting
its own rows, then a sum) reassociates the fp32 reduction.  As in the JAX
module the decomposition is over POST COLUMNS instead: every rank gathers
the full batch of activations and contracts it against its own block of
post-HC columns, so each element of every trace product is computed by
exactly one rank.  The trace all-reduce then adds one real value and
zeros per element; the port all-gathers the column blocks instead, which
gives the same bits (x + 0 = x for the non-negative co-activations) and
moves less.  The forward is sharded by columns too, but its dense support
is not computed by columns: every rank forms the whole ``b + x @ w`` by
the very call the single-device step makes (the state is replicated) and
keeps its own columns, because cuBLAS sums a column block of a product in
another order than the same columns of the whole product.  The per-HC
softmax is block-local, and the exploration noise is drawn from the
replicated generator at the full (B, Nj) shape and column-sliced, so a
step reproduces the port's single-device ``unsupervised_layer_step`` /
``supervised_readout_step`` bit for bit, provided each trace product's
column block equals the same columns of the whole product.

Each rank runs these programs on its own process with the state
replicated (every rank holds the same state and generator) and its block
of each batch's rows (B / n_ranks, in mesh order); the collectives run over
the mesh's data axis (``Mesh.axis``: ``distributed/group.py``).  As in
JAX, the programs compute in plain torch whatever ``ProjSpec.backend``
says (the kernels tile their contractions in ways that reassociate them),
and the readout, one output HC, learns replicated.  They run eagerly: a
collective of gloo cannot run inside a captured CUDA graph.  The port's
masked-tail convention holds: a masked epoch masks only its last batch,
the one zero-padded batch of a fit, as the single-device epoch does.

Compact-resident projections shard along the leading post-HC axis of their
(Hj, K, Mj) leaves, which shrinks the gathered partials by the nact/Hi
factor of the resident state.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core.bcpnn_layer import (Projection, ProjSpec, apply_dense_stats,
                                is_compact, learn, learn_masked,
                                masked_inputs, maybe_rewire, support)
from ..core.compact import (apply_compact_stats, compact_co_stats,
                            compact_support)
from ..core.hypercolumns import LayerGeom, hc_softmax
from ..core.network import DeepState, NetworkSpec, _one_hot, _with_proj
from .group import DataAxis


def _check_geometry(spec: NetworkSpec, layer: int, n_shards: int) -> None:
    """The column decomposition needs whole HCs per shard on every
    projection the step touches (readout excluded: it replicates)."""
    for l in range(layer + 1):
        h = spec.projs[l].post.H
        if h % n_shards != 0:
            raise ValueError(
                f"data-parallel step: stack projection {l} has {h} post-HCs,"
                f" not divisible by the {n_shards}-way data axis — the "
                f"column-sharded decomposition needs whole HCs per shard")


def _cols(t: torch.Tensor, ax: DataAxis, width: int, dim: int
          ) -> torch.Tensor:
    """This rank's block of ``width`` along ``dim``."""
    return t.narrow(dim, ax.index * width, width)


def _support_cols(proj: Projection, pspec: ProjSpec, xf: torch.Tensor,
                  ax: DataAxis) -> torch.Tensor:
    """This rank's post-column block of the log-domain support, from the
    FULL batch: the single-device support's columns, bit for bit.  Dense:
    the whole ``b + x @ w`` (every rank holds the whole ``w``), narrowed.
    Compact: the block's own gather and product, which are
    column-invariant."""
    if is_compact(pspec) and proj.table is not None:
        hj_l = pspec.post.H // ax.n
        return compact_support(
            xf, _cols(proj.w, ax, hj_l, 0),
            _cols(proj.b, ax, hj_l * pspec.post.M, 0),
            _cols(proj.table, ax, hj_l, 0), pspec.pre.M)
    # The whole support by the single-device call, then this rank's
    # columns: cuBLAS sums a column block of a product in another order
    # than the same columns of the whole product.
    return _cols(support(proj, pspec, xf), ax, pspec.post.N // ax.n, 1)


def _softmax_cols(s_l: torch.Tensor, pspec: ProjSpec,
                  n_shards: int) -> torch.Tensor:
    """Per-HC softmax on a whole-HC column block: block-local, so equal to
    the same columns of the full softmax."""
    geom_l = LayerGeom(pspec.post.H // n_shards, pspec.post.M)
    return hc_softmax(s_l, geom_l, pspec.gain)


def _gather_cols(y_l: torch.Tensor, ax: DataAxis) -> torch.Tensor:
    return ax.gather(y_l, dim=1)


def _forward_cols(proj: Projection, pspec: ProjSpec, xf: torch.Tensor,
                  ax: DataAxis) -> torch.Tensor:
    """Full post rates via the column-sharded forward and a gather."""
    return _gather_cols(_softmax_cols(_support_cols(proj, pspec, xf, ax),
                                      pspec, ax.n), ax)


def _co_allreduce_dense(xf: torch.Tensor, y_l: torch.Tensor,
                        ax: DataAxis) -> torch.Tensor:
    """The disjoint-support trace all-reduce, dense layout: this rank's
    full-batch column product (Ni, Nj/n), every rank's gathered into the
    (Ni, Nj) co-activation sum."""
    return ax.gather(xf.T @ y_l, dim=1)


def _co_allreduce_compact(xf: torch.Tensor, y_l: torch.Tensor,
                          proj: Projection, pspec: ProjSpec, ax: DataAxis,
                          n_valid=None) -> torch.Tensor:
    """The disjoint-support trace all-reduce, compact layout: partials are
    (Hj/n, K, Mj), the canonical ``compact_co_stats`` on this rank's table
    rows and post columns (batch-mean, or real-row-mean with ``n_valid``),
    gathered along the post-HC axis."""
    hj_l = proj.traces.pij.shape[0] // ax.n
    part = compact_co_stats(xf, y_l, _cols(proj.table, ax, hj_l, 0),
                            pspec.pre.M, pspec.post.M, n_valid=n_valid)
    return ax.gather(part, dim=0)


def _learn_sharded(proj: Projection, pspec: ProjSpec, xf: torch.Tensor,
                   yf: torch.Tensor, y_l: torch.Tensor, ax: DataAxis,
                   valid: Optional[torch.Tensor] = None) -> Projection:
    """One plasticity step from all-reduced stats; the replicated EMA and
    fold are the single-device plain learn's own ops.  ``valid`` ((B,)
    0/1, replicated) is the zero-padded tail batch's mask, as
    ``learn_masked``: pad rows are zeroed before any stat and every divisor
    is the real row count; the column block of the masked rates is the
    masked column block, so the gather stays exact."""
    compact = is_compact(pspec) and proj.table is not None
    if valid is None:
        xm = xf.mean(dim=0)
        ym = yf.mean(dim=0)
        if compact:
            co_c = _co_allreduce_compact(xf, y_l, proj, pspec, ax)
            return apply_compact_stats(proj, pspec, xm, ym, co_c)
        co = _co_allreduce_dense(xf, y_l, ax) / xf.shape[0]
        return apply_dense_stats(proj, pspec, xm, ym, co)
    xv, yv, n = masked_inputs(xf, yf, valid)
    yv_l = y_l * valid.to(y_l.dtype)[:, None]
    xm = xv.sum(dim=0) / n
    ym = yv.sum(dim=0) / n
    if compact:
        co_c = _co_allreduce_compact(xv, yv_l, proj, pspec, ax, n_valid=n)
        return apply_compact_stats(proj, pspec, xm, ym, co_c)
    co = _co_allreduce_dense(xv, yv_l, ax) / n
    return apply_dense_stats(proj, pspec, xm, ym, co)


def _learn_replicated(proj: Projection, pspec: ProjSpec, xf: torch.Tensor,
                      yf: torch.Tensor, valid=None) -> Projection:
    """Tiny projections (the single-HC readout) learn replicated: every
    rank runs the identical plain learn."""
    plain = pspec.with_backend("torch")
    if valid is not None:
        return learn_masked(proj, plain, xf, yf, valid)
    return learn(proj, plain, xf, yf)


def _train_projection_body(state: DeepState, spec: NetworkSpec, layer: int,
                           h: torch.Tensor, ax: DataAxis, valid=None,
                           noise: Optional[torch.Tensor] = None
                           ) -> DeepState:
    """The column-sharded ``core.network.train_projection_step`` on the
    layer's DIRECT input rates ``h`` (full batch, replicated), shared by
    the step and the epoch makers.  ``noise`` (optional, (B, Nj), full
    width) replaces the generator's draw, which is otherwise made at the
    full shape, as the single-device step makes it, and column-sliced."""
    pspec = spec.projs[layer]
    proj = state.projs[layer]
    s_l = _support_cols(proj, pspec, h, ax)
    t = proj.traces.t.to(torch.float32)
    amp = pspec.support_noise * torch.clamp_min(
        1.0 - t / max(1, pspec.noise_steps), 0.0)
    if noise is None:
        noise = torch.randn((h.shape[0], pspec.post.N),
                            generator=state.generator, dtype=s_l.dtype,
                            device=s_l.device)
    noise_l = _cols(noise, ax, pspec.post.N // ax.n, 1)
    y_l = _softmax_cols(s_l + amp * noise_l, pspec, ax.n)
    yf = _gather_cols(y_l, ax)
    proj = _learn_sharded(proj, pspec, h, yf, y_l, ax, valid=valid)
    proj = maybe_rewire(proj, pspec)
    return _with_proj(state, layer, proj, state.step + 1)


def _supervised_body(state: DeepState, spec: NetworkSpec, xf: torch.Tensor,
                     labels: torch.Tensor, ax: DataAxis,
                     valid=None) -> DeepState:
    """Column-sharded frozen stack forward + replicated readout learn on
    full-batch inputs, shared by the supervised step and epoch."""
    h = xf
    for l in range(spec.depth):
        h = _forward_cols(state.projs[l], spec.projs[l], h, ax)
    y = _one_hot(labels, spec.n_classes, h)
    ro = _learn_replicated(state.readout, spec.readout, h, y, valid=valid)
    return DeepState(projs=state.projs, readout=ro, step=state.step + 1,
                     generator=state.generator)


def _data_axis(spec: NetworkSpec, mesh, axis: str, layer: int) -> DataAxis:
    _check_geometry(spec, layer, mesh.shape[axis])
    return mesh.axis(axis)


def make_data_parallel_unsupervised_step(spec: NetworkSpec, mesh,
                                         layer: int = 0,
                                         axis: str = "data") -> Callable:
    """The data-parallel ``core.network.unsupervised_layer_step``:
    ``step(state, x_l, *, noise=None)`` with ``state`` replicated and
    ``x_l`` this rank's (B/n, Ni) block of the batch's rows; returns the
    replicated next state, equal to the single-device step's."""
    ax = _data_axis(spec, mesh, axis, layer)

    def step(state: DeepState, x_l: torch.Tensor, *,
             noise: Optional[torch.Tensor] = None) -> DeepState:
        h = ax.gather(x_l, dim=0)
        for l in range(layer):
            h = _forward_cols(state.projs[l], spec.projs[l], h, ax)
        return _train_projection_body(state, spec, layer, h, ax,
                                      noise=noise)

    step.axis = ax
    return step


def make_data_parallel_supervised_step(spec: NetworkSpec, mesh,
                                       axis: str = "data") -> Callable:
    """The data-parallel ``core.network.supervised_readout_step``:
    ``step(state, x_l, labels_l)``, rows and labels in this rank's block;
    column-sharded frozen stack forward, replicated readout learn."""
    ax = _data_axis(spec, mesh, axis, spec.depth - 1)

    def step(state: DeepState, x_l: torch.Tensor,
             labels_l: torch.Tensor) -> DeepState:
        return _supervised_body(state, spec, ax.gather(x_l, dim=0),
                                ax.gather(labels_l, dim=0), ax)

    step.axis = ax
    return step


# ------------------------------------------------------------ epochs ----

def make_data_parallel_projection_epoch(spec: NetworkSpec, mesh,
                                        layer: int = 0, axis: str = "data",
                                        masked: bool = False) -> Callable:
    """The data-parallel ``core.trainer._train_projection_epoch``:
    ``epoch(state, hs_l, *, noise=None)`` over PRECOMPUTED layer-input
    rates, ``hs_l`` (nb, B/n, N_layer) this rank's rows of each batch.
    With ``masked=True`` it is ``epoch(state, hs_l, valid, *, noise=None)``
    with ``valid`` (nb, B) replicated, and the epoch's last batch takes
    the masked learn (the port's tail convention).  ``noise`` (optional,
    (nb, B, Nj)) replaces the generator's draws."""
    ax = _data_axis(spec, mesh, axis, layer)

    def run(state, hs_l, valid, noise):
        nb = hs_l.shape[0]
        for b in range(nb):
            state = _train_projection_body(
                state, spec, layer, ax.gather(hs_l[b], dim=0), ax,
                valid=valid[b] if valid is not None and b == nb - 1 else None,
                noise=None if noise is None else noise[b])
        return state

    if masked:
        def epoch(state: DeepState, hs_l: torch.Tensor, valid: torch.Tensor,
                  *, noise: Optional[torch.Tensor] = None) -> DeepState:
            return run(state, hs_l, valid, noise)
    else:
        def epoch(state: DeepState, hs_l: torch.Tensor, *,
                  noise: Optional[torch.Tensor] = None) -> DeepState:
            return run(state, hs_l, None, noise)

    epoch.axis = ax
    return epoch


def make_data_parallel_supervised_epoch(spec: NetworkSpec, mesh,
                                        axis: str = "data",
                                        masked: bool = False) -> Callable:
    """The data-parallel ``core.trainer._supervised_epoch``:
    ``epoch(state, xs_l, ys_l)`` (this rank's rows of each batch), plus a
    replicated ``valid`` (nb, B) operand when ``masked``, whose last batch
    takes the masked readout learn."""
    ax = _data_axis(spec, mesh, axis, spec.depth - 1)

    def run(state, xs_l, ys_l, valid):
        nb = xs_l.shape[0]
        for b in range(nb):
            state = _supervised_body(
                state, spec, ax.gather(xs_l[b], dim=0),
                ax.gather(ys_l[b], dim=0), ax,
                valid=valid[b] if valid is not None and b == nb - 1 else None)
        return state

    if masked:
        def epoch(state: DeepState, xs_l: torch.Tensor, ys_l: torch.Tensor,
                  valid: torch.Tensor) -> DeepState:
            return run(state, xs_l, ys_l, valid)
    else:
        def epoch(state: DeepState, xs_l: torch.Tensor,
                  ys_l: torch.Tensor) -> DeepState:
            return run(state, xs_l, ys_l, None)

    epoch.axis = ax
    return epoch
