"""Compact-resident patchy state: the (Hj, K, Mj) layout and its plain
PyTorch path (mirrors ``repro/core/compact.py``).

A patchy projection with an ``nact`` connectivity budget has only
``K = nact * Mi`` live pre-synaptic units per post-HC.  With
``ProjSpec.compact`` the joint trace and the weights are stored as
``(Hj, K, Mj)`` and the ``(Hj, nact)`` active-pre-HC index table is a leaf
of the projection state, rebuilt only by ``rewire``; the learn path never
touches an (Ni, Nj) array.

A silent synapse carries no evidence: its joint probability is defined as
the independence product ``p_i * p_j`` (weight 0), so the dense
equivalent of a compact state is a pure function of the stored leaves
(``densify_pij``), which is what the ``struct_every`` cold path ranks by
mutual information.  A silent pair's MI is 0 up to fp32 rounding of the
logs, and that rounding differs between PyTorch and XLA: a rewire that
picks among silent pairs is a near-tie.

Layout conventions shared with ``kernels/patchy.py``:

    table : (Hj, nact) int32, ascending pre-HC indices per post-HC
    x_g   : (Hj, B, K)   gathered pre-rates (x duplicated per post-HC)
    pij/w : (Hj, K, Mj)  resident compact matrices

``jnp.take(mode="fill")`` and ``.at[].set(mode="drop")`` have no torch
twin: gathers and scatters append a zero column (or row) and point
out-of-range indices at it.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Tuple

import numpy as np
import torch

from .traces import Traces, mutual_information


# ------------------------------------------------------- index tables ----

def build_table(mask: torch.Tensor, nact: int) -> torch.Tensor:
    """(Hi, Hj) exactly-nact HC mask -> (Hj, nact) int32 table of active
    pre-HC indices per post-HC, ascending.  A stable descending sort picks
    the same nact rows as ``lax.top_k`` (ties toward the lower index);
    ``torch.topk`` promises no order.  Runs on the mask's device."""
    idx = torch.sort(mask.T, dim=-1, descending=True, stable=True).indices
    # sort may keep the slice's strides; the kernels take a contiguous table
    return torch.sort(idx[:, :nact], dim=1).values.to(torch.int32).contiguous()


# Mask identity -> table.  The port's steps hand one mask tensor from step
# to step until a rewire makes a new one, so the identity memo hits on the
# hot path.  The JAX package adds a content digest for folds that copy the
# mask; that costs a device->host copy of the mask per call, and nothing in
# the port copies a mask, so there is no second level.  The key holds the
# tensor's version counter, so an in-place edit misses; the mask itself is
# held weakly, so a dropped state cannot be pinned by the memo.
_TABLE_CACHE: dict = {}
_TABLE_CACHE_MAX = 64


def cached_table(mask: torch.Tensor, nact: int) -> torch.Tensor:
    """``build_table`` memoized on the identity (and version) of ``mask``.
    A hit reads nothing back from the card."""
    key = (id(mask), mask._version, nact)
    hit = _TABLE_CACHE.get(key)
    if hit is not None:
        ref, table = hit
        if ref() is mask:
            return table
        del _TABLE_CACHE[key]
    table = build_table(mask, nact)
    if len(_TABLE_CACHE) >= _TABLE_CACHE_MAX:
        for k in [k for k, (r, _) in _TABLE_CACHE.items() if r() is None]:
            del _TABLE_CACHE[k]
        while len(_TABLE_CACHE) >= _TABLE_CACHE_MAX:
            del _TABLE_CACHE[next(iter(_TABLE_CACHE))]
    _TABLE_CACHE[key] = (weakref.ref(mask), table)
    return table


def table_matches_mask(mask: torch.Tensor, table: torch.Tensor,
                       nact: int) -> bool:
    """Host-side check (deployment boundary, never per step) that a
    (Hj, nact) table routes exactly the live pre-HCs of an exactly-nact
    (Hi, Hj) mask.  Duplicate or out-of-range entries never match."""
    m = mask.detach().cpu().numpy()
    t = table.detach().cpu().numpy()
    hi, hj = m.shape
    if t.shape != (hj, nact) or (t < 0).any() or (t >= hi).any():
        return False
    ts = np.sort(t, axis=1)
    if nact > 1 and (np.diff(ts, axis=1) <= 0).any():
        return False
    want = np.zeros((hi, hj), m.dtype)
    want[t, np.arange(hj)[:, None]] = 1
    return bool(np.array_equal(want, m))


def unit_indices(table: torch.Tensor, mi: int, k_pad: int = 0,
                 sentinel: int = -1) -> torch.Tensor:
    """Expand the HC table to unit-level gather indices (Hj, nact*Mi+k_pad).
    Pad slots carry ``sentinel`` (out of range): gathers fill zeros there
    and scatters drop them."""
    hj, nact = table.shape
    ui = (table[:, :, None] * mi
          + torch.arange(mi, dtype=torch.int32,
                         device=table.device)[None, None, :]
          ).reshape(hj, nact * mi).to(torch.int32)
    if k_pad:
        ui = torch.cat([ui, torch.full((hj, k_pad), sentinel,
                                       dtype=torch.int32,
                                       device=table.device)], dim=1)
    return ui


# --------------------------------------------------- gather / scatter ----

def _fill_index(ui: torch.Tensor, n: int) -> torch.Tensor:
    """Indices into an axis of ``n`` with one zero slot appended: every
    out-of-range index points at the slot ``n``."""
    ui = ui.long()
    return torch.where((ui < 0) | (ui >= n), n, ui)


def gather_pre(x: torch.Tensor, ui: torch.Tensor) -> torch.Tensor:
    """x (B, Ni) -> compact (Hj, B, K): per-post-HC gather of live rates
    (zeros at out-of-range indices)."""
    b, ni = x.shape
    xz = torch.cat([x, x.new_zeros((b, 1))], dim=1)
    return xz[:, _fill_index(ui, ni)].transpose(0, 1)


def gather_dense(dense: torch.Tensor, ui: torch.Tensor, hj: int,
                 mj: int) -> torch.Tensor:
    """dense (Ni, Hj*Mj) -> compact (Hj, K, Mj): each post-HC's column
    block restricted to its live pre-unit rows (zero rows at out-of-range
    indices)."""
    ni = dense.shape[0]
    d3 = torch.cat([dense.reshape(ni, hj, mj),
                    dense.new_zeros((1, hj, mj))], dim=0)
    cols = torch.arange(hj, device=dense.device)[:, None]
    return d3[_fill_index(ui, ni), cols, :]


def scatter_dense(base3: torch.Tensor, ui: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """Compact (Hj, K, Mj) values written into a copy of a (Ni, Hj, Mj)
    base; out-of-range rows drop (they land in an appended row that is cut
    off: filtering them with a boolean index would read the card back).
    Cold path only (densify, rewire)."""
    ni, hj = base3.shape[0], base3.shape[1]
    out = torch.cat([base3, base3.new_zeros((1,) + tuple(base3.shape[1:]))])
    cols = torch.arange(hj, device=base3.device)[:, None]
    out[_fill_index(ui, ni), cols] = vals
    return out[:ni]


def densify_pij(pij_c: torch.Tensor, pi: torch.Tensor, pj: torch.Tensor,
                table: torch.Tensor, mi: int) -> torch.Tensor:
    """Dense (Ni, Nj) view of a compact joint trace: active entries from
    storage, silent entries at the independence product p_i*p_j (weight
    0, MI contribution 0 up to rounding).  O(Ni*Nj): cold path only."""
    hj, _, mj = pij_c.shape
    ni = pi.shape[0]
    ui = unit_indices(table, mi, sentinel=ni)
    base = torch.outer(pi, pj).reshape(ni, hj, mj)
    return scatter_dense(base, ui, pij_c).reshape(ni, hj * mj)


# ----------------------------------------------------- compact compute ----

def compact_support(x: torch.Tensor, w_c: torch.Tensor, b: torch.Tensor,
                    table: torch.Tensor, mi: int) -> torch.Tensor:
    """Log-domain support from compact weights: gather live pre-rates per
    post-HC and contract against the resident (Hj, K, Mj) weights (plain
    torch on both backends, as the JAX package leaves it to XLA)."""
    hj, _, mj = w_c.shape
    ui = unit_indices(table, mi, sentinel=x.shape[1])
    s3 = torch.einsum("jbk,jkm->bjm", gather_pre(x, ui), w_c)
    return s3.reshape(x.shape[0], hj * mj) + b[None, :]


def compact_co_stats(x: torch.Tensor, y: torch.Tensor, table: torch.Tensor,
                     mi: int, mj: int, n_valid=None) -> torch.Tensor:
    """Batch-mean compact co-activation <x⊗y> restricted to live pairs:
    (Hj, K, Mj).  ``n_valid`` (optional 0-d tensor) replaces the batch
    size as divisor, for pad-zeroed rows of a masked tail batch."""
    b = x.shape[0]
    hj = table.shape[0]
    ui = unit_indices(table, mi, sentinel=x.shape[1])
    y3 = y.reshape(b, hj, mj).transpose(0, 1)
    co = torch.einsum("jbk,jbm->jkm", gather_pre(x, ui), y3)
    return co / (b if n_valid is None else n_valid)


def fold_weights_compact(pij_c: torch.Tensor, log_pi: torch.Tensor,
                         log_pj: torch.Tensor, table: torch.Tensor, mi: int,
                         eps: float) -> torch.Tensor:
    """Bayesian log-odds fold on the compact layout:
    w = log p_ij - (log p_i + log p_j), all compact-sized."""
    hj, _, mj = pij_c.shape
    ni = log_pi.shape[0]
    ui = unit_indices(table, mi, sentinel=ni)
    lpi = torch.cat([log_pi, log_pi.new_zeros(1)])[_fill_index(ui, ni)]
    logp = torch.log(torch.clamp(pij_c, eps * eps, 1.0))
    return logp - (lpi[:, :, None] + log_pj.reshape(hj, 1, mj))


# ------------------------------------------------------- compact learn ----

def apply_compact_stats(proj, spec, xm: torch.Tensor, ym: torch.Tensor,
                        co_c: torch.Tensor):
    """EMA + weight fold on compact state from precomputed batch stats."""
    from .bcpnn_layer import Projection
    from .traces import update_traces_from_stats

    tr = update_traces_from_stats(proj.traces, xm, ym, co_c, spec.alpha)
    log_pi = torch.log(torch.clamp(tr.pi, spec.eps, 1.0))
    log_pj = torch.log(torch.clamp(tr.pj, spec.eps, 1.0))
    w_c = fold_weights_compact(tr.pij, log_pi, log_pj, proj.table,
                               spec.pre.M, spec.eps)
    return Projection(traces=tr, w=w_c, b=log_pj, mask=proj.mask,
                      table=proj.table)


def learn_compact_torch(proj, spec, x: torch.Tensor, y: torch.Tensor):
    """One plasticity step on compact-resident state, plain torch: the
    co-activation, EMA and fold are all (Hj, K, Mj)-sized."""
    co_c = compact_co_stats(x, y, proj.table, spec.pre.M, spec.post.M)
    return apply_compact_stats(proj, spec, x.mean(dim=0), y.mean(dim=0),
                               co_c)


# ------------------------------------------------- layout conversions ----

def compactify_projection(proj, spec):
    """Dense-layout projection -> compact-resident (cold path): active
    entries of pij/w are gathered, silent pij values are dropped (under
    the compact semantics they are the independence product)."""
    from .bcpnn_layer import Projection
    table = cached_table(proj.mask, spec.nact)
    ui = unit_indices(table, spec.pre.M, sentinel=spec.pre.N)
    tr = proj.traces
    hj, mj = spec.post.H, spec.post.M
    return Projection(
        traces=Traces(pi=tr.pi, pj=tr.pj, pij=gather_dense(tr.pij, ui, hj, mj),
                      t=tr.t, t_host=tr.t_host),
        w=gather_dense(proj.w, ui, hj, mj), b=proj.b, mask=proj.mask,
        table=table)


def densify_projection(proj, spec):
    """Compact-resident projection -> dense layout (cold path): silent pij
    at independence, silent w at 0 (their values under the compact
    semantics)."""
    from .bcpnn_layer import Projection
    hj, mj, ni = spec.post.H, spec.post.M, spec.pre.N
    tr = proj.traces
    ui = unit_indices(proj.table, spec.pre.M, sentinel=ni)
    pij = densify_pij(tr.pij, tr.pi, tr.pj, proj.table, spec.pre.M)
    w = scatter_dense(proj.w.new_zeros((ni, hj, mj)), ui,
                      proj.w).reshape(ni, hj * mj)
    return Projection(traces=Traces(pi=tr.pi, pj=tr.pj, pij=pij, t=tr.t,
                                    t_host=tr.t_host),
                      w=w, b=proj.b, mask=proj.mask, table=None)


def rewire_compact(proj, spec):
    """Structural plasticity on compact state, the one O(Ni*Nj) touch of
    the layout: densify the joint trace (silent pairs at ~0 MI),
    rank pre-HCs by mutual information, rebuild mask and table, re-gather.
    Newly activated pairs start at the independence product (weight 0)."""
    from .bcpnn_layer import Projection, topk_mask
    hi, mi = spec.pre.H, spec.pre.M
    hj, mj = spec.post.H, spec.post.M
    tr = proj.traces
    pij_dense = densify_pij(tr.pij, tr.pi, tr.pj, proj.table, mi)
    dense_tr = Traces(pi=tr.pi, pj=tr.pj, pij=pij_dense, t=tr.t,
                      t_host=tr.t_host)
    mask = topk_mask(mutual_information(dense_tr, hi, mi, hj, mj, spec.eps),
                     spec.nact)
    table = build_table(mask, spec.nact)
    ui = unit_indices(table, mi, sentinel=spec.pre.N)
    pij_c = gather_dense(pij_dense, ui, hj, mj)
    log_pi = torch.log(torch.clamp(tr.pi, spec.eps, 1.0))
    log_pj = torch.log(torch.clamp(tr.pj, spec.eps, 1.0))
    w_c = fold_weights_compact(pij_c, log_pi, log_pj, table, mi, spec.eps)
    return Projection(traces=Traces(pi=tr.pi, pj=tr.pj, pij=pij_c, t=tr.t,
                                    t_host=tr.t_host),
                      w=w_c, b=log_pj, mask=mask, table=table)


# --------------------------------------------------- state conversions ----

def compact_network_spec(spec):
    """NetworkSpec with ``compact=True`` on every projection eligible for
    the compact-resident layout (patchy_traces + a binding nact budget)."""
    from .bcpnn_layer import is_patchy
    from .network import NetworkSpec

    def flip(p):
        if p.patchy_traces and is_patchy(p) and not p.compact:
            return dataclasses.replace(p, compact=True)
        return p

    return NetworkSpec(projs=tuple(flip(p) for p in spec.projs),
                       readout=flip(spec.readout))


def compactify_state(state, spec) -> Tuple[object, object]:
    """(DeepState, NetworkSpec) with every eligible projection converted
    to the compact-resident layout; inference over the converted state
    equals the original's."""
    from .network import DeepState, as_spec

    spec = as_spec(spec)
    new_spec = compact_network_spec(spec)

    def conv(p, ps):
        return compactify_projection(p, ps) if ps.compact else p

    return DeepState(
        projs=tuple(conv(p, ps) for p, ps in zip(state.projs, new_spec.projs)),
        readout=conv(state.readout, new_spec.readout),
        step=state.step, generator=state.generator), new_spec
