"""Grouped-query attention with every variant the zoo needs (mirrors
``repro/models/attention.py``):

  * GQA / MQA / MHA (n_kv_heads <= n_heads), grouped by a reshape of the
    query heads to (B, S, Hk, G, D)
  * causal, sliding-window (local) or bidirectional (encoder) masking,
    an additive ``NEG`` mask as in JAX
  * query chunks of 512: scores never materialize for the full (S, S)
    square
  * gemma2 tanh logit soft-capping, qwen3 per-head qk RMSNorm, qwen1.5
    QKV biases, cross-attention (whisper decoder)
  * ring-buffer KV cache decode for local layers, flat cache for global

Scores, soft-cap, mask and softmax are fp32 (JAX forms the scores with
``preferred_element_type=float32``); the probabilities are cast to the
compute dtype before the product with V.  Decode writes its cache in place
at a slot computed on the device, so a step needs no host sync.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..distributed.sharding import shard
from .common import dense_init_, param, rms_norm, rope

# The canonical softmax-lane fill (the JAX package's ``kernels/tiling.py``):
# exp(NEG - max) underflows to exactly 0.0.
NEG = -1e30  # repro: suppress[pad-fill-literal] — the port's own canonical fill


def neg_fill(dtype: torch.dtype) -> float:
    """``NEG`` clamped to the dtype's range (DESIGN.md §7's pad rule)."""
    return max(NEG, torch.finfo(dtype).min)


class Attention(nn.Module):
    """``wq``, ``wk``, ``wv``, ``wo``; ``bq``/``bk``/``bv`` with QKV bias
    (not on cross-attention); ``q_norm``/``k_norm`` with qk-norm."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype,
                 device: Optional[torch.device], cross: bool = False):
        super().__init__()
        d, hq, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = param((d, hq * hd), dtype, device)
        self.wk = param((d, hk * hd), dtype, device)
        self.wv = param((d, hk * hd), dtype, device)
        self.wo = param((hq * hd, d), dtype, device)
        self.bias = cfg.qkv_bias and not cross
        if self.bias:
            self.bq = param((hq * hd,), dtype, device)
            self.bk = param((hk * hd,), dtype, device)
            self.bv = param((hk * hd,), dtype, device)
        self.qk_norm = cfg.qk_norm
        if cfg.qk_norm:
            self.q_norm = param((hd,), dtype, device)
            self.k_norm = param((hd,), dtype, device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for name in ("wq", "wk", "wv", "wo"):
            dense_init_(getattr(self, name), gen)
        if self.bias:
            for p in (self.bq, self.bk, self.bv):
                p.zero_()
        if self.qk_norm:
            self.q_norm.zero_()
            self.k_norm.zero_()


def _project_qkv(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                 kv_x: Optional[torch.Tensor] = None):
    """x: (B, S, d) -> q (B,S,Hq,D), k/v (B,Skv,Hk,D)."""
    b, s, _ = x.shape
    kv_x = x if kv_x is None else kv_x
    skv = kv_x.shape[1]
    hq, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p.wq
    k = kv_x @ p.wk
    v = kv_x @ p.wv
    if p.bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, skv, hk, hd)
    v = v.reshape(b, skv, hk, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps, plus_one=True)
        k = rms_norm(k, p.k_norm, cfg.norm_eps, plus_one=True)
    q = shard(q, "batch", "act_seq", "heads", "head_dim")
    k = shard(k, "batch", "act_seq", "kv_heads", "head_dim")
    v = shard(v, "batch", "act_seq", "kv_heads", "head_dim")
    return q, k, v


def _softcap(scores: torch.Tensor, cap: float) -> torch.Tensor:
    if cap > 0.0:
        return cap * torch.tanh(scores / cap)
    return scores


def _chunk_attend(q_chunk: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos: torch.Tensor, k_pos: torch.Tensor,
                  cfg: ModelConfig, causal: bool) -> torch.Tensor:
    """q_chunk: (B,C,Hk,G,D); k,v: (B,S,Hk,D); positions: (C,), (S,)."""
    scale = cfg.head_dim ** -0.5
    scores = torch.einsum("bchgd,bshd->bhgcs", q_chunk.float(),
                          k.float()) * scale
    scores = _softcap(scores, cfg.attn_softcap)
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=scores.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if cfg.window > 0 and causal:
        mask &= k_pos[None, :] > q_pos[:, None] - cfg.window
    add = torch.where(mask, 0.0, neg_fill(scores.dtype))
    scores = scores + add[None, None, None]
    probs = torch.softmax(scores, dim=-1).to(q_chunk.dtype)
    return torch.einsum("bhgcs,bshd->bchgd", probs, v)


def fill_cache(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor,
               local: bool, cache_size: int) -> Dict[str, torch.Tensor]:
    """Lay prompt K/V (B,S,Hk,D) out in decode-cache format (flat or ring;
    the ring holds position p at slot p mod its size)."""
    b, s, hk, hd = k.shape
    use_ring = local and cfg.window > 0 and cache_size <= cfg.window
    if not use_ring:
        pad = cache_size - s
        if pad > 0:
            zeros = k.new_zeros((b, pad, hk, hd))
            return {"k": torch.cat([k, zeros], 1),
                    "v": torch.cat([v, zeros], 1)}
        return {"k": k[:, -cache_size:].contiguous(),
                "v": v[:, -cache_size:].contiguous()}
    w = cache_size
    kw, vw = k[:, -w:], v[:, -w:]
    start = max(0, s - w)
    slots = (start + torch.arange(kw.shape[1], device=k.device)) % w
    buf_k = k.new_zeros((b, w, hk, hd)).index_copy_(1, slots, kw)
    buf_v = v.new_zeros((b, w, hk, hd)).index_copy_(1, slots, vw)
    return {"k": buf_k, "v": buf_v}


def attend(p: Attention, cfg: ModelConfig, x: torch.Tensor,
           positions: torch.Tensor, causal: bool = True, local: bool = False,
           kv_x: Optional[torch.Tensor] = None, q_chunk: int = 512,
           return_kv: bool = False):
    """Full-sequence attention (prefill, encoder), query-chunked.

    x: (B, S, d); positions: (S,) int32.  Returns (B, S, d)
    (plus the roped (k, v) when return_kv, to prime the decode cache).
    """
    cfg_l = cfg if local else cfg.with_(window=0)
    b, s, _ = x.shape
    hq, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = hq // hk
    q, k, v = _project_qkv(p, cfg_l, x, kv_x)
    q = q.reshape(b, s, hk, g, hd)
    skv = k.shape[1]
    kv_pos = positions if kv_x is None else torch.arange(
        skv, dtype=torch.int32, device=x.device)
    if cfg.rope_theta > 0 and kv_x is None:  # no rope on cross-attention
        q = rope(q.reshape(b, s, hk * g, hd), positions[None],
                 cfg.rope_theta).reshape(b, s, hk, g, hd)
        k = rope(k, kv_pos[None], cfg.rope_theta)

    nchunk = max(1, s // q_chunk)
    if s % q_chunk != 0:
        nchunk = 1
    if nchunk == 1:
        out = _chunk_attend(q, k, v, positions, kv_pos, cfg_l, causal)
    else:
        c = s // nchunk
        out = torch.cat([
            _chunk_attend(q[:, i * c:(i + 1) * c], k, v,
                          positions[i * c:(i + 1) * c], kv_pos, cfg_l, causal)
            for i in range(nchunk)], dim=1)
    out = out.reshape(b, s, hq * hd) @ p.wo
    out = shard(out, "batch", "seq", "embed")
    if return_kv:
        return out, (k, v)
    return out


# ------------------------------------------------------------- decoding --

def init_kv_cache(cfg: ModelConfig, batch: int, seq_len: int, local: bool,
                  dtype: torch.dtype,
                  device: Optional[torch.device]) -> Dict[str, torch.Tensor]:
    hk, hd = cfg.n_kv_heads, cfg.head_dim
    size = min(seq_len, cfg.window) if (local and cfg.window > 0) else seq_len
    return {"k": torch.zeros((batch, size, hk, hd), dtype=dtype, device=device),
            "v": torch.zeros((batch, size, hk, hd), dtype=dtype, device=device)}


def _attend_one(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                cfg: ModelConfig, dtype: torch.dtype,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, Hk, G, D) against k, v (B, S, Hk, D) -> (B, 1, Hq*D)."""
    b = q.shape[0]
    scores = torch.einsum("bhgd,bshd->bhgs", q.float(),
                          k.float()) * cfg.head_dim ** -0.5
    scores = _softcap(scores, cfg.attn_softcap)
    if valid is not None:
        scores = scores + torch.where(valid, 0.0, neg_fill(scores.dtype))
    probs = torch.softmax(scores, dim=-1).to(dtype)
    out = torch.einsum("bhgs,bshd->bhgd", probs, v)
    return out.reshape(b, 1, cfg.n_heads * cfg.head_dim)


def decode_attend(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                  cache: Dict[str, torch.Tensor], pos: torch.Tensor,
                  local: bool = False,
                  cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode.  x: (B, 1, d); pos: 0-d int32 (current index).

    Global layers write a flat cache at ``pos`` (clamped to its end, as
    ``dynamic_update_slice`` clamps); local layers a ring buffer of size
    ``window`` at ``pos mod size``.  The write is in place.
    Cross-attention reads precomputed encoder K/V and writes nothing.
    """
    b = x.shape[0]
    hq, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = hq // hk

    if cross_kv is not None:
        k, v = cross_kv
        q = (x @ p.wq).reshape(b, 1, hk, g, hd)
        if cfg.qk_norm:
            q = rms_norm(q, p.q_norm, cfg.norm_eps, plus_one=True)
        return _attend_one(q[:, 0], k, v, cfg, x.dtype) @ p.wo, cache

    q, k_new, v_new = _project_qkv(p, cfg, x)
    if cfg.rope_theta > 0:
        posv = pos.reshape(1, 1).expand(b, 1)
        q = rope(q, posv, cfg.rope_theta)
        k_new = rope(k_new, posv, cfg.rope_theta)

    size = cache["k"].shape[1]
    ring = local and cfg.window > 0
    slot = torch.remainder(pos, size) if ring else torch.clamp(pos, 0,
                                                               size - 1)
    slot = slot.reshape(1).long()
    cache["k"].index_copy_(1, slot, k_new.to(cache["k"].dtype))
    cache["v"].index_copy_(1, slot, v_new.to(cache["v"].dtype))
    shard(cache["k"], "batch", "cache_seq", "kv_heads", "head_dim")
    shard(cache["v"], "batch", "cache_seq", "kv_heads", "head_dim")

    idx = torch.arange(size, dtype=torch.int32, device=x.device)
    if ring:
        # slot i holds absolute position p_i = pos - ((pos - i) mod size)
        p_i = pos - torch.remainder(pos - idx, size)
        valid = (p_i >= 0) & (p_i <= pos) & (p_i > pos - cfg.window)
    else:
        valid = idx <= pos

    out = _attend_one(q.reshape(b, hk, g, hd), cache["k"], cache["v"], cfg,
                      x.dtype, valid)
    return out @ p.wo, cache
