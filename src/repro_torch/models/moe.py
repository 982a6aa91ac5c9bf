"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch
(mirrors ``repro/models/moe.py``).

Tokens are viewed as (G groups, T/G tokens), G the data shards
(``distributed.sharding.data_shards``: 1 on one card), and ranked within
each expert first come, first served.  Top-k choices beyond an expert's
capacity C = k*T_g/E * capacity_factor are dropped to an overflow row;
the residual connection carries dropped tokens through unchanged.  Decode
(one token a row) is dropless.

On a split mesh the tensors are DTensors: the groups split over the batch
axes, each rank's rows whole groups, as JAX's dispatch is group-local.
The routing (softmax, top-k, ranks, slots, the dispatch and combine
buffers) runs on each rank's own groups (``per_rank(..., keep=(0,))``:
DTensor has no sharding rule for ``searchsorted``); the expert buffers
split E over the model axis (expert parallelism), and each rank runs its
groups through its experts; the combine gathers the experts' outputs of its groups,
which is where the tokens cross ranks.

``jax.lax.top_k`` takes the lower index on a tie; ``torch.topk`` makes no
such promise, so the top k come from a stable descending sort.  The
combine is a scatter-add, which on the card sums in an order of its own.

Training differentiates through the dispatch as JAX does: the gates (the
top-k probabilities, renormalised, through the router's softmax) and the
experts get gradients; the ranks, slots and kept flags are integers.  The
backward of the dispatch's gather scatter-adds into token rows that k
choices share, with atomics on the card, so an MoE step there may sum in
another order from run to run (not measured; PERF.md section 7).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate

from ..configs.base import ModelConfig
from ..distributed.sharding import (data_shards, linear, local_operand,
                                    per_rank, shard)
from .common import dense_init_, param


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype,
                 device: Optional[torch.device]):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = param((d, e), torch.float32, device)
        self.wi_e = param((e, d, f), dtype, device)
        self.wg_e = param((e, d, f), dtype, device)
        self.wo_e = param((e, f, d), dtype, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        dense_init_(self.router, gen, 0)
        for p in (self.wi_e, self.wg_e, self.wo_e):
            dense_init_(p, gen, 1)


class Routing(NamedTuple):
    """One dispatch: (G, Tg, k) gates (renormalised over the k) and expert
    ids; (G, Tg*k) first-come-first-served ranks within the expert, kept
    flags and buffer slots (``E*cap`` for a dropped choice)."""

    gates: torch.Tensor
    expert_ids: torch.Tensor
    rank: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor


def dispatch_shape(cfg: ModelConfig, b: int, s: int):
    """(groups, tokens a group, capacity) of a (B, S) batch."""
    e, k = cfg.n_experts, cfg.n_experts_active
    groups = cfg.moe_groups or data_shards()
    t = b * s
    if t % groups != 0:
        groups = 1
    tg = t // groups
    if s == 1:  # decode: tiny token count — dropless (cap covers worst case)
        cap = tg
    else:
        cap = max(1, int(k * tg / e * cfg.capacity_factor))
        cap = min(cap, tg)
    return groups, tg, cap


def top_k(probs: torch.Tensor, k: int):
    """The k largest along the last axis, the lower index first on a tie
    (``jax.lax.top_k``)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router: torch.Tensor, cfg: ModelConfig, xt: torch.Tensor,
          cap: int) -> Routing:
    """xt: (G, Tg, d) -> the dispatch of its top-k choices (each rank's
    groups on a split mesh)."""
    logits = linear(xt.float(), router)                          # (G, Tg, E)
    return Routing(*per_rank(lambda l: _route_logits(l, cfg, cap), logits,
                              keep=(0,)))


def _route_logits(logits: torch.Tensor, cfg: ModelConfig, cap: int):
    groups, tg, e = logits.shape
    k = cfg.n_experts_active
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = top_k(probs, k)                      # (G, Tg, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    flat_ids = expert_ids.reshape(groups, tg * k)                # (G, Tk)
    rank, keep, slot = _slots(flat_ids, e, cap)
    return gate_vals, expert_ids, rank, keep, slot


def _slots(flat_ids: torch.Tensor, e: int, cap: int):
    """(rank within expert, kept, buffer slot) of (G, Tk) expert ids:
    group-local, sort-based, first come first served."""
    groups, tk = flat_ids.shape
    sort_idx = torch.argsort(flat_ids, dim=1, stable=True)
    sorted_ids = torch.gather(flat_ids, 1, sort_idx)
    experts = torch.arange(e, dtype=sorted_ids.dtype, device=flat_ids.device)
    first = torch.searchsorted(sorted_ids,
                               experts.expand(groups, e).contiguous())
    pos = torch.arange(tk, device=flat_ids.device)[None]
    rank_sorted = pos - torch.gather(first, 1, sorted_ids)
    rank = torch.empty_like(rank_sorted).scatter_(1, sort_idx, rank_sorted)
    keep = rank < cap
    # flat slot in the (E*C [+1 overflow]) buffer; dropped -> overflow row
    slot = torch.where(keep, flat_ids * cap + rank,
                       torch.full_like(rank, e * cap))
    return rank, keep, slot


def _to_groups(x: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, d) -> (G, T/G, d).  A batch-split DTensor is reshaped on
    each rank's rows, which are whole groups when the batch shards divide
    ``groups`` (rank r's rows are groups r*G/n .. (r+1)*G/n - 1, the
    groups of the global reshape); otherwise the batch is gathered first
    and the groups replicate."""
    b, s, d = x.shape
    if not isinstance(x, DTensor):
        return x.reshape(groups, b * s // groups, d)
    mesh = x.device_mesh
    n = 1
    for i, p in enumerate(x.placements):
        if p.is_shard() and p.dim == 0:
            n *= mesh.size(i)
    if groups % n != 0:
        x = x.redistribute(mesh, [Replicate() if p.is_shard() and p.dim == 0
                                  else p for p in x.placements])
        n = 1
    local = x.to_local()
    return DTensor.from_local(
        local.reshape(groups // n, b * s // groups, local.shape[-1]), mesh,
        x.placements, run_check=False)


def _from_groups(y: torch.Tensor, b: int, s: int) -> torch.Tensor:
    """(G, T/G, d) -> (B, S, d), the inverse of ``_to_groups``."""
    if not isinstance(y, DTensor):
        return y.reshape(b, s, y.shape[-1])
    local = y.to_local()
    n = y.shape[0] // local.shape[0]
    return DTensor.from_local(local.reshape(b // n, s, local.shape[-1]),
                              y.device_mesh, y.placements, run_check=False)


def moe_ffn(p: MoE, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_active
    groups, tg, cap = dispatch_shape(cfg, b, s)
    xt = _to_groups(x, groups)
    xt = shard(xt, "batch", None, "embed")
    r = route(p.router, cfg, xt, cap)

    # index-based dispatch: slot -> token index; unused slots point at the
    # zero pad row tg, which the (bias-free) experts map to zero
    def buffers(slot, gates, keep):
        g_ = slot.shape[0]
        tok_src = (torch.arange(tg * k, device=slot.device) // k)[None]
        idx_buf = torch.full((g_, e * cap + 1), tg, dtype=torch.long,
                             device=slot.device).scatter_(
                                 1, slot, tok_src.expand(g_, tg * k))
        gates_flat = (gates * keep.reshape(g_, tg, k)).reshape(
            g_, tg * k).float()
        gate_buf = torch.zeros((g_, e * cap + 1), dtype=torch.float32,
                               device=slot.device).scatter_(1, slot,
                                                            gates_flat)
        return idx_buf[:, :e * cap], gate_buf[:, :e * cap]

    idx_buf, gate_buf = per_rank(buffers, r.slot, r.gates, r.keep,
                                 keep=(0,))

    def gather_tokens(xt_, idx):
        xt_pad = torch.cat([xt_, xt_.new_zeros((xt_.shape[0], 1, d))], 1)
        buf_ = torch.gather(xt_pad, 1, idx[..., None].expand(-1, -1, d))
        return buf_.reshape(xt_.shape[0], e, cap, d)

    buf = per_rank(gather_tokens, xt, idx_buf, keep=(0,))
    buf = shard(buf, "batch", "expert", None, None)

    # expert computation, batched over E; on a split mesh each rank's
    # groups against its experts, each expert's weights gathered whole over
    # the fsdp axis first, as FSDP gathers a layer's parameters
    def experts(eq, a, w):
        if not isinstance(a, DTensor):
            return torch.einsum(eq, a, w)
        w_l = local_operand(w, a, {1: 0})
        return per_rank(lambda a_: torch.einsum(eq, a_, w_l), a)

    h = experts("gecd,edf->gecf", buf, p.wi_e)
    g_ = experts("gecd,edf->gecf", buf, p.wg_e)
    h = F.silu(g_) * h
    out = experts("gecf,efd->gecd", h, p.wo_e)                  # (G, E, C, d)
    out = shard(out, "batch", "expert", None, None)

    # combine: gate-weighted scatter-add back to tokens
    def combine(out_, gate, idx):
        w = out_.reshape(out_.shape[0], e * cap, d) * gate[..., None].to(
            out_.dtype)
        y = torch.zeros((w.shape[0], tg + 1, d), dtype=w.dtype,
                        device=w.device)
        return y.scatter_add_(1, idx[..., None].expand(-1, -1, d),
                              w)[:, :tg]

    y = per_rank(combine, out, gate_buf, idx_buf, keep=(0,))
    return shard(_from_groups(y, b, s), "batch", "seq", "embed")


def aux_load_balance_loss(p: MoE, cfg: ModelConfig,
                          x: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (fraction * prob) of
    x: (B, S, d) (``moe.py:125-132``)."""
    logits = x.float() @ p.router
    probs = torch.softmax(logits, dim=-1)
    _, ids = top_k(probs, cfg.n_experts_active)
    frac = F.one_hot(ids, cfg.n_experts).float().mean(dim=(0, 1, 2))
    return cfg.n_experts * (frac * probs.mean(dim=(0, 1))).sum()
