"""Recurrent sequence mixers: Mamba-1 selective SSM and RG-LRU (Griffin /
RecurrentGemma), mirroring ``repro/models/recurrent.py``.  Both expose a
full-sequence path (prefill) and a single-step decode path carrying
(conv window, recurrent state).

The JAX package runs the selective scan and the RG-LRU recurrence as
``lax.scan``s; here they are plain loops over the sequence with an fp32
carry, differentiated by autograd.  ``ssm_chunk > 1`` (dividing the
sequence) changes only what training saves for its backward pass: as JAX
rematerialises each chunk of its scan, a step that takes gradients runs
each chunk under ``torch.utils.checkpoint`` and keeps only the carries at
chunk boundaries.  The forward's arithmetic, element for element, is the
plain scan's, and so are the gradients but ``A_log``'s: every step shares
it, and its gradient sums chunk by chunk.  Decode updates its cache in
place.

On a split mesh the products go through ``distributed.sharding.linear``,
and the convs, scans, gates and cache writes run on each rank's channels
(``per_rank``; the channels split over the tensor-parallel axis), the
per-step B and C of the SSM whole on every rank.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from torch.distributed.tensor import DTensor

from ..distributed.sharding import (assign_, gather_dims, linear,
                                    local_operand, per_rank, shard)
from .common import add_bias, dense_init_, gelu, param


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: (B, S, C), w: (K, C) -> (B, S, C)."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):  # K is 4: the taps, unrolled as in JAX
        out = out + pad[:, i:i + x.shape[1]] * w[i]
    return out + b


def _conv_step(state: torch.Tensor, x_t: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """state: (B, K-1, C) previous inputs; x_t: (B, C)."""
    window = torch.cat([state, x_t[:, None]], dim=1)  # (B, K, C)
    y = torch.einsum("bkc,kc->bc", window, w) + b
    return window[:, 1:], y


def _conv_state(x: torch.Tensor, k: int) -> torch.Tensor:
    """The last ``k`` inputs of (B, S, C), zero-padded on the left when the
    prompt is shorter (``recurrent.py:128-131``)."""
    s = x.shape[1]
    if s >= k:
        return x[:, -k:].contiguous()
    return F.pad(x, (0, 0, k - s, 0))


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``_causal_conv``; on a split mesh on each rank's channels."""
    if not isinstance(x, DTensor):
        return _causal_conv(x, w, b)
    c = x.dim() - 1
    w_l, b_l = local_operand(w, x, {c: 1}), local_operand(b, x, {c: 0})
    return per_rank(lambda x_: _causal_conv(x_, w_l, b_l), x)


def _conv_decode(x: torch.Tensor, window: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """One step of the causal conv: x (B, 1, C) against the cache's window
    (B, K-1, C), which is moved on in place; (B, 1, C).  On a split mesh
    each rank's channels, its block of the window written locally."""
    if isinstance(x, DTensor):
        w, b = local_operand(w, x, {2: 1}), local_operand(b, x, {2: 0})

    def step(x_, win):
        new, y = _conv_step(win, x_[:, 0], w, b)
        win.copy_(new)
        return y[:, None]

    return per_rank(step, x, window)


def _halves(t: torch.Tensor, *dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """``torch.chunk(t, 2, -1)``.  On a split mesh the rows of a split
    last dimension do not fall on the halves: it is gathered whole, cut,
    and each half placed by logical ``dims`` again."""
    if not isinstance(t, DTensor):
        return torch.chunk(t, 2, dim=-1)
    t = gather_dims(t, -1)
    first, second = per_rank(lambda t_: tuple(torch.chunk(t_, 2, dim=-1)), t)
    return shard(first, *dims), shard(second, *dims)


def _state_of(t: torch.Tensor) -> torch.Tensor:
    """A cache leaf's block on this rank (the leaf itself when whole)."""
    return t.to_local() if isinstance(t, DTensor) else t


# ------------------------------------------------------------- mamba-1 --

class Mamba(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype,
                 device: Optional[torch.device]):
        super().__init__()
        d, di = cfg.d_model, cfg.d_inner
        n, k, r = cfg.ssm_state, cfg.d_conv, cfg.dt_rank_eff
        self.in_proj = param((d, 2 * di), dtype, device)
        self.conv_w = param((k, di), dtype, device)
        self.conv_b = param((di,), dtype, device)
        self.x_proj = param((di, r + 2 * n), dtype, device)
        self.dt_w = param((r, di), dtype, device)
        self.dt_bias = param((di,), dtype, device)
        self.A_log = param((di, n), torch.float32, device)
        self.D = param((di,), torch.float32, device)
        self.out_proj = param((di, d), dtype, device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for p in (self.in_proj, self.conv_w, self.x_proj, self.dt_w,
                  self.out_proj):
            dense_init_(p, gen)
        self.conv_b.zero_()
        self.dt_bias.fill_(-4.6)  # softplus^-1(0.01)
        n = self.A_log.shape[1]
        # S4D-real A initialization: A_n = -(n+1)
        assign_(self.A_log, torch.log(torch.arange(
            1, n + 1, dtype=torch.float32, device=self.A_log.device)
        )[None].expand(self.A_log.shape))
        self.D.fill_(1.0)


def _mamba_coeffs(p: Mamba, cfg: ModelConfig, xc: torch.Tensor):
    """xc: (..., di) post-conv activations -> per-step SSM coefficients."""
    n, r = cfg.ssm_state, cfg.dt_rank_eff
    # (..., R+2N), whole on every rank: a split contraction is summed
    proj = gather_dims(linear(xc, p.x_proj), -1)
    dt_low, b_in, c_out = per_rank(
        lambda t: (t[..., :r], t[..., r:r + n], t[..., r + n:]), proj)
    dt = F.softplus(add_bias(linear(dt_low, p.dt_w), p.dt_bias))
    return dt.float(), b_in.float(), c_out.float()


def _ssm_operands(p: Mamba, xc: torch.Tensor, b_in: torch.Tensor,
                  c_out: torch.Tensor):
    """(A, B, C, D) as they meet xc's block: A and D by channel, B and C
    (shared by every channel) whole on each rank's rows."""
    a = -torch.exp(p.A_log)                            # (di, N)
    if not isinstance(xc, DTensor):
        return a, b_in, c_out, p.D
    c = xc.dim() - 1
    return (local_operand(a, xc, {c: 0}),
            local_operand(b_in, xc, {0: 0, 1: 1}),
            local_operand(c_out, xc, {0: 0, 1: 1}),
            local_operand(p.D, xc, {c: 0}))


def _mamba_scan(h: torch.Tensor, a: torch.Tensor, xc: torch.Tensor,
                dt: torch.Tensor, b_in: torch.Tensor, c_out: torch.Tensor):
    """The selective scan over a run of steps from carry ``h`` (B, di, N):
    (last carry, y (B, S, di) fp32)."""
    da = torch.exp(dt[..., None] * a)                  # (B, S, di, N)
    dbx = (dt * xc.float())[..., None] * b_in[:, :, None, :]
    ys = []
    # the steps as views (``unbind``): an indexed step's backward would
    # write a whole (B, S, di, N) gradient for each step; y is contracted
    # step by step, so no (B, S, di, N) stack of carries forms
    for da_t, dbx_t, c_t in zip(da.unbind(1), dbx.unbind(1),
                                c_out.unbind(1)):
        h = da_t * h + dbx_t
        ys.append((h * c_t[:, None, :]).sum(-1))
    return h, torch.stack(ys, dim=1)


def mamba_mixer(p: Mamba, cfg: ModelConfig, x: torch.Tensor,
                return_state: bool = False):
    """Full-sequence selective scan.  x: (B, S, d) -> (B, S, d).  On a
    split mesh the conv, the scan and the gates run on each rank's
    channels."""
    xz = linear(x, p.in_proj)
    xz = shard(xz, "batch", "act_seq", "tp")
    x_br, z = _halves(xz, "batch", "act_seq", "tp")
    xc = F.silu(_conv(x_br, p.conv_w, p.conv_b))
    dt, b_in, c_out = _mamba_coeffs(p, cfg, xc)
    a, b_in, c_out, d_skip = _ssm_operands(p, xc, b_in, c_out)
    # the carry (B, di, N) holds the channels in dimension 1
    y, h = per_rank(
        lambda xc_, dt_, z_: _mamba_channels(a, xc_, dt_, b_in, c_out,
                                             d_skip, z_, cfg.ssm_chunk,
                                             x.dtype), xc, dt, z,
        remap={1: {2: 1}})
    out = shard(linear(y, p.out_proj), "batch", "seq", "embed")
    if return_state:
        k = cfg.d_conv - 1
        return out, {"conv": per_rank(lambda t: _conv_state(t, k), x_br),
                     "ssm": h}
    return out


def _mamba_channels(a, xc, dt, b_in, c_out, d_skip, z, ck: int,
                    dtype: torch.dtype):
    """The scan from a zero carry, the D skip and the z gate over a block
    of channels: (y (B, S, di') in ``dtype``, last carry (B, di', N))."""
    b, s, di = xc.shape
    h = torch.zeros((b, di, a.shape[1]), dtype=torch.float32,
                    device=xc.device)
    if ck > 1 and s % ck == 0 and torch.is_grad_enabled():
        ys = []
        for c0 in range(0, s, ck):  # one rematerialised chunk at a time
            part = slice(c0, c0 + ck)
            h, y_c = checkpoint(_mamba_scan, h, a, xc[:, part], dt[:, part],
                                b_in[:, part], c_out[:, part],
                                use_reentrant=False)
            ys.append(y_c)
        y = torch.cat(ys, dim=1)
    else:
        h, y = _mamba_scan(h, a, xc, dt, b_in, c_out)
    y = y.to(dtype)                                    # (B, S, di)
    y = y + xc * d_skip.to(dtype)
    y = y * F.silu(z)
    return y, h


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device: Optional[torch.device]) -> Dict[str, torch.Tensor]:
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                           dtype=torch.float32, device=device),
    }


def mamba_decode(p: Mamba, cfg: ModelConfig, x: torch.Tensor,
                 cache: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, 1, d) -> (B, 1, d); the cache is updated in place (on a split
    mesh each rank's block)."""
    xz = linear(x, p.in_proj)
    x_br, z = _halves(xz, "batch", "act_seq", "tp")
    xc = F.silu(_conv_decode(x_br, cache["conv"], p.conv_w, p.conv_b))
    dt, b_in, c_out = _mamba_coeffs(p, cfg, xc)
    a, b_in, c_out, d_skip = _ssm_operands(p, xc, b_in, c_out)
    ssm = _state_of(cache["ssm"])

    def step(xc_, dt_, z_):
        x1, d1 = xc_[:, 0], dt_[:, 0]
        da = torch.exp(d1[..., None] * a)
        dbx = (d1 * x1.float())[..., None] * b_in[:, 0, None, :]
        h = da * ssm + dbx
        y = torch.einsum("bdn,bn->bd", h, c_out[:, 0]).to(x.dtype)
        y = y + x1 * d_skip.to(x.dtype)
        y = y * F.silu(z_[:, 0])
        ssm.copy_(h)
        return y[:, None]

    return linear(per_rank(step, xc, dt, z), p.out_proj), cache


# -------------------------------------------------------------- rg-lru --

_LRU_C = 8.0  # Griffin's fixed gate sharpness


class RGLRU(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype,
                 device: Optional[torch.device]):
        super().__init__()
        d, w = cfg.d_model, cfg.lru_width_eff
        self.w_in = param((d, w), dtype, device)
        self.w_gate = param((d, w), dtype, device)
        self.conv_w = param((cfg.d_conv, w), dtype, device)
        self.conv_b = param((w,), dtype, device)
        self.w_r = param((w, w), dtype, device)
        self.w_i = param((w, w), dtype, device)
        self.b_r = param((w,), torch.float32, device)
        self.b_i = param((w,), torch.float32, device)
        self.Lambda = param((w,), torch.float32, device)
        self.w_out = param((w, d), dtype, device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for p in (self.w_in, self.w_gate, self.conv_w, self.w_r, self.w_i,
                  self.w_out):
            dense_init_(p, gen)
        for p in (self.conv_b, self.b_r, self.b_i):
            p.zero_()
        # Lambda init so a ~ U(0.9, 0.999)^c (Griffin appendix)
        u = torch.empty(self.Lambda.shape, dtype=torch.float32,
                        device=self.Lambda.device)
        u.uniform_(0.9, 0.999, generator=gen)
        assign_(self.Lambda, torch.log(torch.expm1(-torch.log(u) / _LRU_C)))


def _rglru_gates(p: RGLRU, xc: torch.Tensor):
    """(a, beta, i) of the recurrence at xc (..., W); on a split mesh on
    each rank's channels."""
    r_lin, i_lin = linear(xc, p.w_r), linear(xc, p.w_i)
    b_r, b_i, lam = p.b_r, p.b_i, p.Lambda
    if isinstance(r_lin, DTensor):
        c = r_lin.dim() - 1
        b_r, b_i, lam = (local_operand(t, r_lin, {c: 0})
                         for t in (b_r, b_i, lam))

    def gates(r_, i_):
        r = torch.sigmoid(r_.float() + b_r)
        i = torch.sigmoid(i_.float() + b_i)
        log_a = -_LRU_C * F.softplus(lam) * r
        a = torch.exp(log_a)
        beta = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-9))
        return a, beta, i

    return per_rank(gates, r_lin, i_lin)


def _rglru_scan(a: torch.Tensor, beta: torch.Tensor, i: torch.Tensor,
                xc: torch.Tensor, dtype: torch.dtype):
    """The recurrence from a zero carry over (B, S, W'): (the carries in
    ``dtype``, the last carry (B, W') fp32)."""
    drive = beta * i * xc.float()
    b, _, w = xc.shape
    h = torch.zeros((b, w), dtype=torch.float32, device=xc.device)
    hs = []
    for a_t, drive_t in zip(a.unbind(1), drive.unbind(1)):  # views, as
        h = a_t * h + drive_t                               # the mamba scan
        hs.append(h)
    return torch.stack(hs, dim=1).to(dtype), h          # (B, S, W)


def rglru_mixer(p: RGLRU, cfg: ModelConfig, x: torch.Tensor,
                return_state: bool = False):
    """Full-sequence RG-LRU block.  x: (B, S, d) -> (B, S, d)."""
    gate = gelu(linear(x, p.w_gate))
    xr = shard(linear(x, p.w_in), "batch", "act_seq", "tp")
    xc = _conv(xr, p.conv_w, p.conv_b)
    a, beta, i = _rglru_gates(p, xc)
    # the carry (B, W) holds the channels in dimension 1
    hseq, h = per_rank(lambda a_, b_, i_, x_: _rglru_scan(a_, b_, i_, x_,
                                                          x.dtype),
                       a, beta, i, xc, remap={1: {2: 1}})
    out = shard(linear(hseq * gate, p.w_out), "batch", "seq", "embed")
    if return_state:
        k = cfg.d_conv - 1
        return out, {"conv": per_rank(lambda t: _conv_state(t, k), xr),
                     "state": h}
    return out


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device: Optional[torch.device]) -> Dict[str, torch.Tensor]:
    w = cfg.lru_width_eff
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, w), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, w), dtype=torch.float32, device=device),
    }


def rglru_decode(p: RGLRU, cfg: ModelConfig, x: torch.Tensor,
                 cache: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, 1, d) -> (B, 1, d); the cache is updated in place (on a split
    mesh each rank's block)."""
    gate = gelu(linear(x, p.w_gate))
    xc = _conv_decode(linear(x, p.w_in), cache["conv"], p.conv_w, p.conv_b)
    a, beta, i = _rglru_gates(p, xc)
    state = _state_of(cache["state"])

    def step(a_, b_, i_, x_):
        h = a_[:, 0] * state + b_[:, 0] * i_[:, 0] * x_[:, 0].float()
        state.copy_(h)
        return h.to(x.dtype)[:, None]

    h = per_rank(step, a, beta, i, xc)
    return linear(h * gate, p.w_out), cache
