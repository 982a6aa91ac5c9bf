"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch
(mirrors ``repro/models/moe.py``).

Tokens are viewed as (G groups, T/G tokens), G the data shards
(``distributed.sharding.data_shards``: 1 on one card), and ranked within
each expert first come, first served.  Top-k choices beyond an expert's
capacity C = k*T_g/E * capacity_factor are dropped to an overflow row;
the residual connection carries dropped tokens through unchanged.  Decode
(one token a row) is dropless.

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

from ..configs.base import ModelConfig
from ..distributed.sharding import data_shards, shard
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
    """xt: (G, Tg, d) -> the dispatch of its top-k choices."""
    groups, tg, _ = xt.shape
    e, k = cfg.n_experts, cfg.n_experts_active
    logits = xt.float() @ router                                 # (G, Tg, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = top_k(probs, k)                      # (G, Tg, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    # rank within expert (group-local, sort-based)
    flat_ids = expert_ids.reshape(groups, tg * k)                # (G, Tk)
    sort_idx = torch.argsort(flat_ids, dim=1, stable=True)
    sorted_ids = torch.gather(flat_ids, 1, sort_idx)
    experts = torch.arange(e, dtype=sorted_ids.dtype, device=xt.device)
    first = torch.searchsorted(sorted_ids,
                               experts.expand(groups, e).contiguous())
    pos = torch.arange(tg * k, device=xt.device)[None]
    rank_sorted = pos - torch.gather(first, 1, sorted_ids)
    rank = torch.empty_like(rank_sorted).scatter_(1, sort_idx, rank_sorted)
    keep = rank < cap
    # flat slot in the (E*C [+1 overflow]) buffer; dropped -> overflow row
    slot = torch.where(keep, flat_ids * cap + rank,
                       torch.full_like(rank, e * cap))
    return Routing(gate_vals, expert_ids, rank, keep, slot)


def moe_ffn(p: MoE, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_active
    groups, tg, cap = dispatch_shape(cfg, b, s)
    xt = x.reshape(groups, tg, d)
    xt = shard(xt, "batch", None, "embed")
    r = route(p.router, cfg, xt, cap)

    # index-based dispatch: slot -> token index; unused slots point at the
    # zero pad row tg, which the (bias-free) experts map to zero
    tok_src = (torch.arange(tg * k, device=x.device) // k)[None].expand(
        groups, tg * k)
    idx_buf = torch.full((groups, e * cap + 1), tg, dtype=torch.long,
                         device=x.device).scatter_(1, r.slot, tok_src)
    idx_buf = idx_buf[:, :e * cap]
    gates_flat = (r.gates * r.keep.reshape(groups, tg, k)).reshape(
        groups, tg * k).float()
    gate_buf = torch.zeros((groups, e * cap + 1), dtype=torch.float32,
                           device=x.device).scatter_(1, r.slot, gates_flat)
    gate_buf = gate_buf[:, :e * cap]

    xt_pad = torch.cat([xt, xt.new_zeros((groups, 1, d))], dim=1)
    buf = torch.gather(xt_pad, 1, idx_buf[..., None].expand(-1, -1, d))
    buf = buf.reshape(groups, e, cap, d)
    buf = shard(buf, "batch", "expert", None, None)

    # expert computation, batched over E
    h = torch.einsum("gecd,edf->gecf", buf, p.wi_e)
    g_ = torch.einsum("gecd,edf->gecf", buf, p.wg_e)
    h = F.silu(g_) * h
    out = torch.einsum("gecf,efd->gecd", h, p.wo_e)              # (G, E, C, d)
    out = shard(out, "batch", "expert", None, None)
    out = out.reshape(groups, e * cap, d)

    # combine: gate-weighted scatter-add back to tokens
    weighted = out * gate_buf[..., None].to(out.dtype)
    y = torch.zeros((groups, tg + 1, d), dtype=weighted.dtype,
                    device=x.device)
    y.scatter_add_(1, idx_buf[..., None].expand(-1, -1, d), weighted)
    return shard(y[:, :tg].reshape(b, s, d), "batch", "seq", "embed")


def aux_load_balance_loss(p: MoE, cfg: ModelConfig,
                          x: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (fraction * prob) of
    x: (B, S, d) (``moe.py:125-132``)."""
    logits = x.float() @ p.router
    probs = torch.softmax(logits, dim=-1)
    _, ids = top_k(probs, cfg.n_experts_active)
    frac = F.one_hot(ids, cfg.n_experts).float().mean(dim=(0, 1, 2))
    return cfg.n_experts * (frac * probs.mean(dim=(0, 1))).sum()
