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
at a slot computed on the device, so a step needs no host sync; on a split
mesh the cache is a DTensor split over batch and kv_heads and each rank
writes its own block (``write_``); a cache split along its sequence (the
dry run's ``cache_seq`` rule) is attended block by block and the
blocks' softmax statistics combined (``_decode_seq_split``).  The products go through
``distributed.sharding.linear``, and the attention itself runs on each
rank's block of whole K/V groups (``per_rank``): its batch rows and heads.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from ..configs.base import ModelConfig
from ..distributed.sharding import gather_dims, linear, per_rank, shard, write_
from .common import add_bias, dense_init_, param, rms_norm, rope

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
    q = linear(x, p.wq)
    k = linear(kv_x, p.wk)
    v = linear(kv_x, p.wv)
    if p.bias:
        q, k, v = (add_bias(t, bias) for t, bias in ((q, p.bq), (k, p.bk),
                                                    (v, p.bv)))
    q = _heads(q, hq, hd)
    k = _heads(k, hk, hd)
    v = _heads(v, hk, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps, plus_one=True)
        k = rms_norm(k, p.k_norm, cfg.norm_eps, plus_one=True)
    q = shard(q, "batch", "act_seq", "heads", "head_dim")
    k = shard(k, "batch", "act_seq", "kv_heads", "head_dim")
    v = shard(v, "batch", "act_seq", "kv_heads", "head_dim")
    return q, k, v


def _heads(t: torch.Tensor, h: int, hd: int) -> torch.Tensor:
    """(..., h * hd) -> (..., h, hd).  On a split mesh each rank reshapes
    its block of whole heads (the split of the last dimension becomes the
    split of the heads); a split that does not fall on whole heads is
    gathered first."""
    if not isinstance(t, DTensor):
        return t.reshape(*t.shape[:-1], h, hd)
    n = 1
    for i, q in enumerate(t.placements):
        if q.is_shard() and q.dim == t.dim() - 1:
            n *= t.device_mesh.size(i)
    if h % n:
        t = gather_dims(t, -1)
    return per_rank(lambda l: l.reshape(*l.shape[:-1], l.shape[-1] // hd,
                                        hd), t)


def _head_aligned(q: torch.Tensor, *kv: torch.Tensor):
    """q and the K/V on one placement for a rank-local attention: where
    the K/V heads stay whole (their count does not divide the axis), the
    query heads are gathered whole too."""
    if not isinstance(q, DTensor) or all(
            tuple(t.placements) == tuple(q.placements) for t in kv):
        return (q,) + kv
    return (gather_dims(q, 2),) + kv


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
    the ring holds position p at slot p mod its size); on a split mesh on
    each rank's block (only the sequence moves)."""
    return per_rank(lambda k_, v_: _fill_cache(cfg, k_, v_, local,
                                               cache_size), k, v)


def _fill_cache(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor,
                local: bool, cache_size: int) -> Dict[str, torch.Tensor]:
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
    q, k, v = _project_qkv(p, cfg_l, x, kv_x)
    q, k, v = _head_aligned(q, k, v)
    out, k, v = per_rank(
        lambda q_, k_, v_: _attend_heads(q_, k_, v_, cfg, cfg_l, positions,
                                         causal, kv_x is None, q_chunk),
        q, k, v)
    out = shard(linear(out, p.wo), "batch", "seq", "embed")
    if return_kv:
        return out, (k, v)
    return out


def _attend_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  cfg: ModelConfig, cfg_l: ModelConfig,
                  positions: torch.Tensor, causal: bool, self_attn: bool,
                  q_chunk: int):
    """Attention of q (B, S, Hq', D) over k, v (B, Skv, Hk', D), the heads
    a whole number of K/V groups (all of them on one rank, or a rank's
    block): (out (B, S, Hq' * D), roped k, v)."""
    b, s, hq, hd = q.shape
    hk = k.shape[2]
    g = hq // hk
    q = q.reshape(b, s, hk, g, hd)
    skv = k.shape[1]
    kv_pos = positions if self_attn else torch.arange(
        skv, dtype=torch.int32, device=q.device)
    if cfg.rope_theta > 0 and self_attn:  # no rope on cross-attention
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
    return out.reshape(b, s, hq * hd), k, v


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
    """q (B, Hk, G, D) against k, v (B, S, Hk, D) -> (B, 1, Hk*G*D)."""
    b, hk, g, hd = q.shape
    scores = torch.einsum("bhgd,bshd->bhgs", q.float(),
                          k.float()) * cfg.head_dim ** -0.5
    scores = _softcap(scores, cfg.attn_softcap)
    if valid is not None:
        scores = scores + torch.where(valid, 0.0, neg_fill(scores.dtype))
    probs = torch.softmax(scores, dim=-1).to(dtype)
    out = torch.einsum("bhgs,bshd->bhgd", probs, v)
    return out.reshape(b, 1, hk * g * hd)


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
    hq, hd = cfg.n_heads, cfg.head_dim
    if cross_kv is not None:
        # on each rank's block of whole K/V groups, as the training
        # forward's cross-attention (``lm._cross_attend``)
        k, v = cross_kv
        q = _heads(linear(x, p.wq), hq, hd)
        if cfg.qk_norm:
            q = rms_norm(q, p.q_norm, cfg.norm_eps, plus_one=True)
        q, k, v = _head_aligned(q, k, v)
        out = per_rank(lambda q_, k_, v_: _attend_one(
            q_[:, 0].reshape(q_.shape[0], k_.shape[2],
                             q_.shape[2] // k_.shape[2], hd),
            k_, v_, cfg, x.dtype), q, k, v)
        return linear(out, p.wo), cache

    q, k_new, v_new = _project_qkv(p, cfg, x)
    q, k_new, v_new = _head_aligned(q, k_new, v_new)
    ring = local and cfg.window > 0
    if _seq_axes(cache["k"]):
        out = _decode_seq_split(q, k_new, v_new, cache["k"], cache["v"], cfg,
                                pos, ring, x.dtype)
        return linear(out, p.wo), cache
    if isinstance(cache["k"], DTensor) and (
            tuple(cache["k"].placements) != tuple(k_new.placements)):
        raise ValueError(f"the decode cache is placed "
                         f"{cache['k'].placements}, the new K/V "
                         f"{k_new.placements}: the write would not be local")
    out = per_rank(
        lambda q_, k_, v_, ck, cv: _decode_heads(q_, k_, v_, ck, cv, cfg,
                                                 pos, ring, x.dtype),
        q, k_new, v_new, cache["k"], cache["v"])
    shard(cache["k"], "batch", "cache_seq", "kv_heads", "head_dim")
    shard(cache["v"], "batch", "cache_seq", "kv_heads", "head_dim")
    return linear(out, p.wo), cache


def _decode_heads(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                  cache_k: torch.Tensor, cache_v: torch.Tensor,
                  cfg: ModelConfig, pos: torch.Tensor, ring: bool,
                  dtype: torch.dtype) -> torch.Tensor:
    """One token's attention on a block of whole K/V groups: the new K/V
    written (``_write_token``), then q against the cache."""
    b, _, hq, hd = q.shape
    hk = k_new.shape[2]
    q, valid = _write_token(q, k_new, v_new, cache_k, cache_v, cfg, pos,
                            ring, cache_k.shape[1])
    return _attend_one(q.reshape(b, hk, hq // hk, hd), cache_k, cache_v,
                       cfg, dtype, valid)


def _write_token(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                 cache_k: torch.Tensor, cache_v: torch.Tensor,
                 cfg: ModelConfig, pos: torch.Tensor, ring: bool, size: int,
                 lo: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rope q and the new K at ``pos`` and write the new K/V in place into
    a cache block of slots ``lo ..`` of ``size`` (at ``pos mod size`` on a
    ring, else ``pos`` clamped to the end, as ``dynamic_update_slice``
    clamps); a block that does not hold that slot rewrites one of its own
    slots with its own value, so the write stays local and reads nothing
    back.  Returns (the roped q, which of the block's slots the token
    attends to)."""
    b = q.shape[0]
    if cfg.rope_theta > 0:
        posv = pos.reshape(1, 1).expand(b, 1)
        q = rope(q, posv, cfg.rope_theta)
        k_new = rope(k_new, posv, cfg.rope_theta)
    n = cache_k.shape[1]
    slot = torch.remainder(pos, size) if ring else torch.clamp(pos, 0,
                                                               size - 1)
    if n < size:  # a block of a cache split along its sequence
        here = slot - lo
        inside = (here >= 0) & (here < n)
        at = torch.clamp(here, 0, n - 1).reshape(1).long()
        k_new, v_new = (torch.where(inside, t.to(c.dtype),
                                    c.index_select(1, at))
                        for t, c in ((k_new, cache_k), (v_new, cache_v)))
    else:
        at = slot.reshape(1).long()
    write_(cache_k, k_new, at, dim=1)
    write_(cache_v, v_new, at, dim=1)
    idx = torch.arange(n, dtype=torch.int32, device=q.device)
    if lo:
        idx = idx + lo
    if ring:
        # slot i holds absolute position p_i = pos - ((pos - i) mod size)
        p_i = pos - torch.remainder(pos - idx, size)
        return q, (p_i >= 0) & (p_i <= pos) & (p_i > pos - cfg.window)
    return q, idx <= pos


def _seq_axes(cache_t: torch.Tensor) -> Tuple[int, ...]:
    """The mesh axes that split a DTensor cache along its sequence."""
    if not isinstance(cache_t, DTensor):
        return ()
    return tuple(i for i, p in enumerate(cache_t.placements)
                 if p.is_shard() and p.dim == 1)


def _decode_seq_split(q: torch.Tensor, k_new: torch.Tensor,
                      v_new: torch.Tensor, cache_k: torch.Tensor,
                      cache_v: torch.Tensor, cfg: ModelConfig,
                      pos: torch.Tensor, ring: bool,
                      dtype: torch.dtype) -> torch.Tensor:
    """One token's attention on a cache split along its sequence (the JAX
    dry run's ``cache_seq`` rule, where the K/V heads do not divide the
    model axis): the rank whose block holds the slot writes the new K/V
    there (``_write_token``: every write local, nothing read back); each
    rank takes the
    softmax statistics of its block (the largest score, the sum of the
    exponentials and their product with V, in fp32), and the blocks are
    combined across the axes that split the sequence, a max and two sums,
    as ``logsumexp_and_gold`` combines vocabulary blocks.  The whole
    cache never forms on one rank.  q, k_new, v_new are split as the
    cache's batch and heads (``_head_aligned``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from ..distributed.sharding import block_range
    mesh = cache_k.device_mesh
    seq = _seq_axes(cache_k)
    size = cache_k.shape[1]
    lo, _ = block_range(cache_k, 1)
    ql, kl, vl = (t.to_local() if isinstance(t, DTensor) else t
                  for t in (q, k_new, v_new))
    ck, cv = cache_k.to_local(), cache_v.to_local()
    b, _, hq, hd = ql.shape
    hk = kl.shape[2]
    g = hq // hk
    ql, valid = _write_token(ql, kl, vl, ck, cv, cfg, pos, ring, size, lo)
    scores = torch.einsum("bhgd,bshd->bhgs",
                          ql.reshape(b, hk, g, hd).float(),
                          ck.float()) * cfg.head_dim ** -0.5
    scores = _softcap(scores, cfg.attn_softcap)
    scores = scores + torch.where(valid, 0.0, neg_fill(scores.dtype))
    m = scores.amax(-1)
    e = torch.exp(scores - m[..., None])
    # the statistics (B, Hk, G[, D]): batch and heads split as the cache's
    base = [Shard(0) if p.is_shard() and p.dim == 0 else
            Shard(1) if p.is_shard() and p.dim == 2 else Replicate()
            for p in cache_k.placements]

    def combine(local: torch.Tensor, op: str) -> torch.Tensor:
        parts = [Partial(op) if i in seq else p for i, p in enumerate(base)]
        return DTensor.from_local(local, mesh, parts, run_check=False
                                  ).redistribute(mesh, base).to_local()

    top = combine(m, "max")
    w = torch.exp(m - top)
    total = combine(e.sum(-1) * w, "sum")
    acc = combine(torch.einsum("bhgs,bshd->bhgd", e, cv.float())
                  * w[..., None], "sum")
    out = (acc / total[..., None]).to(dtype).reshape(b, 1, hk * g * hd)
    out_pl = [Shard(0) if p.is_shard() and p.dim == 0 else
              Shard(2) if p.is_shard() and p.dim == 2 else Replicate()
              for p in cache_k.placements]
    return DTensor.from_local(out, mesh, out_pl, run_check=False)
