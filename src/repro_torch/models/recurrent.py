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
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..distributed.sharding import shard
from .common import dense_init_, gelu, param


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
        self.A_log.copy_(torch.log(torch.arange(
            1, n + 1, dtype=torch.float32, device=self.A_log.device)
        )[None].expand_as(self.A_log))
        self.D.fill_(1.0)


def _mamba_coeffs(p: Mamba, cfg: ModelConfig, xc: torch.Tensor):
    """xc: (..., di) post-conv activations -> per-step SSM coefficients."""
    n, r = cfg.ssm_state, cfg.dt_rank_eff
    proj = xc @ p.x_proj                               # (..., R+2N)
    dt_low, bc = proj[..., :r], proj[..., r:]
    b_in, c_out = bc[..., :n], bc[..., n:]
    dt = F.softplus(dt_low @ p.dt_w + p.dt_bias)
    return dt.float(), b_in.float(), c_out.float()


def _mamba_scan(h: torch.Tensor, a: torch.Tensor, xc: torch.Tensor,
                dt: torch.Tensor, b_in: torch.Tensor, c_out: torch.Tensor):
    """The selective scan over a run of steps from carry ``h`` (B, di, N):
    (last carry, y (B, S, di) fp32)."""
    da = torch.exp(dt[..., None] * a)                  # (B, S, di, N)
    dbx = (dt * xc.float())[..., None] * b_in[:, :, None, :]
    ys = []
    for t in range(xc.shape[1]):
        h = da[:, t] * h + dbx[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, c_out[:, t]))
    return h, torch.stack(ys, dim=1)


def mamba_mixer(p: Mamba, cfg: ModelConfig, x: torch.Tensor,
                return_state: bool = False):
    """Full-sequence selective scan.  x: (B, S, d) -> (B, S, d)."""
    b, s, _ = x.shape
    di, n = cfg.d_inner, cfg.ssm_state
    xz = x @ p.in_proj
    xz = shard(xz, "batch", "act_seq", "tp")
    x_br, z = torch.chunk(xz, 2, dim=-1)
    xc = F.silu(_causal_conv(x_br, p.conv_w, p.conv_b))
    a = -torch.exp(p.A_log)                            # (di, N)
    dt, b_in, c_out = _mamba_coeffs(p, cfg, xc)
    h = torch.zeros((b, di, n), dtype=torch.float32, device=x.device)
    ck = cfg.ssm_chunk
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
    y = y.to(x.dtype)                                  # (B, S, di)
    y = y + xc * p.D.to(x.dtype)
    y = y * F.silu(z)
    out = shard(y @ p.out_proj, "batch", "seq", "embed")
    if return_state:
        return out, {"conv": _conv_state(x_br, cfg.d_conv - 1), "ssm": h}
    return out


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
    """x: (B, 1, d) -> (B, 1, d); the cache is updated in place."""
    xz = x[:, 0] @ p.in_proj
    x_br, z = torch.chunk(xz, 2, dim=-1)
    conv_state, xc = _conv_step(cache["conv"], x_br, p.conv_w, p.conv_b)
    xc = F.silu(xc)
    dt, b_in, c_out = _mamba_coeffs(p, cfg, xc)
    a = -torch.exp(p.A_log)
    da = torch.exp(dt[..., None] * a)
    dbx = (dt * xc.float())[..., None] * b_in[:, None, :]
    h = da * cache["ssm"] + dbx
    y = torch.einsum("bdn,bn->bd", h, c_out).to(x.dtype)
    y = y + xc * p.D.to(x.dtype)
    y = y * F.silu(z)
    out = (y @ p.out_proj)[:, None]
    cache["conv"].copy_(conv_state)
    cache["ssm"].copy_(h)
    return out, cache


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
        self.Lambda.copy_(torch.log(torch.expm1(-torch.log(u) / _LRU_C)))


def _rglru_gates(p: RGLRU, xc: torch.Tensor):
    r = torch.sigmoid((xc @ p.w_r).float() + p.b_r)
    i = torch.sigmoid((xc @ p.w_i).float() + p.b_i)
    log_a = -_LRU_C * F.softplus(p.Lambda) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-9))
    return a, beta, i


def rglru_mixer(p: RGLRU, cfg: ModelConfig, x: torch.Tensor,
                return_state: bool = False):
    """Full-sequence RG-LRU block.  x: (B, S, d) -> (B, S, d)."""
    gate = gelu(x @ p.w_gate)
    xr = shard(x @ p.w_in, "batch", "act_seq", "tp")
    xc = _causal_conv(xr, p.conv_w, p.conv_b)
    a, beta, i = _rglru_gates(p, xc)
    drive = beta * i * xc.float()
    b, s, w = xc.shape
    h = torch.zeros((b, w), dtype=torch.float32, device=x.device)
    hs = []
    for t in range(s):
        h = a[:, t] * h + drive[:, t]
        hs.append(h)
    hseq = torch.stack(hs, dim=1).to(x.dtype)          # (B, S, W)
    out = shard((hseq * gate) @ p.w_out, "batch", "seq", "embed")
    if return_state:
        return out, {"conv": _conv_state(xr, cfg.d_conv - 1), "state": h}
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
    gate = gelu(x[:, 0] @ p.w_gate)
    xr = x[:, 0] @ p.w_in
    conv_state, xc = _conv_step(cache["conv"], xr, p.conv_w, p.conv_b)
    a, beta, i = _rglru_gates(p, xc)
    h = a * cache["state"] + beta * i * xc.float()
    out = ((h.to(x.dtype) * gate) @ p.w_out)[:, None]
    cache["conv"].copy_(conv_state)
    cache["state"].copy_(h)
    return out, cache
