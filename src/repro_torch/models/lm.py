"""Generic decoder LM assembling the zoo's sequence mixers (mirrors
``repro/models/lm.py``).

One model covers all ten architectures through ``ModelConfig``:
  * layer_pattern — a repeating unit over {g: global attn, l: local attn,
    r: RG-LRU, m: mamba}.  The JAX package scans ``n_layers //
    len(pattern)`` repeats over stacked parameters; here the layers are a
    ``ModuleList`` in execution order (repeat r, pattern position i is
    layer ``r * len(pattern) + i``), then the tail layers.
  * enc_layers > 0 — adds a whisper-style bidirectional encoder and
    cross-attention in every decoder block.
  * vision_patches > 0 — the first P sequence positions take precomputed
    patch embeddings (stub ViT frontend).

Exposes: init_params, embed_tokens, encode, cross_kv_from_encoder,
forward, logits_for, lm_loss, init_cache, prefill, decode_step.
``decode_step`` writes the cache in place (JAX donates it) and keeps
``pos`` a 0-d int32 tensor on the device, so a step reads nothing back to
the host.

Training differentiates ``lm_loss`` with autograd.  With ``cfg.remat`` a
forward that takes gradients runs each pattern repeat under
``torch.utils.checkpoint`` (non-reentrant), the boundary of the JAX
package's ``jax.checkpoint(nothing_saveable)`` around its scan body; the
tail layers are outside it.  Recomputation repeats the forward's
operations, so the gradients are the same bits with remat on and off.
The embedding is ``F.embedding``, whose backward sums a token's rows in a
fixed order (an ``index_select``'s backward adds them with atomics on the
card).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..device import DeviceLike, make_generator, resolve_device
from ..distributed.sharding import (current_mesh, embedding, linear,
                                    local_block, logsumexp_and_gold,
                                    per_rank, place_like, reduce_over_splits,
                                    shard, split_mesh)
from .attention import (Attention, _head_aligned, _heads, attend,
                        decode_attend, fill_cache, init_kv_cache)
from .common import (MLP, Norm, compute_dtype, dense_init_, embed_init_,
                     mlp, param, rms_norm)
from .moe import MoE, moe_ffn
from .params import CACHE_DIMS, distribute_params
from .recurrent import (RGLRU, Mamba, init_mamba_cache, init_rglru_cache,
                        mamba_decode, mamba_mixer, rglru_decode, rglru_mixer)

Cache = Dict[str, torch.Tensor]


# ---------------------------------------------------------------- layout --

def layer_chars(cfg: ModelConfig) -> List[str]:
    """The mixer of every decoder layer, in execution order."""
    n_blocks, n_tail = cfg.pattern_blocks
    p = cfg.layer_pattern
    return list(p) * n_blocks + [p[i % len(p)] for i in range(n_tail)]


# --------------------------------------------------------------- modules --

class Block(nn.Module):
    """One residual block; children named as the JAX block's keys."""

    def __init__(self, cfg: ModelConfig, char: str, dtype: torch.dtype,
                 device: Optional[torch.device], with_cross: bool):
        super().__init__()
        self.char = char
        self.norm1 = Norm(cfg, dtype, device)
        if char in ("g", "l"):
            self.attn = Attention(cfg, dtype, device)
        elif char == "r":
            self.rglru = RGLRU(cfg, dtype, device)
        elif char == "m":
            self.mamba = Mamba(cfg, dtype, device)
        else:
            raise ValueError(char)
        if cfg.post_norms:
            self.norm1_post = Norm(cfg, dtype, device)
        if with_cross:
            self.norm_cross = Norm(cfg, dtype, device)
            self.cross = Attention(cfg, dtype, device, cross=True)
        if cfg.d_ff > 0 or cfg.n_experts > 0:
            self.norm2 = Norm(cfg, dtype, device)
            if cfg.n_experts > 0:
                self.moe = MoE(cfg, dtype, device)
            else:
                self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp, dtype, device)
            if cfg.post_norms:
                self.norm2_post = Norm(cfg, dtype, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for child in self.children():
            child.reset_parameters(gen)


class Encoder(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype,
                 device: Optional[torch.device]):
        super().__init__()
        self.pos_embed = param((cfg.enc_seq, cfg.d_model), dtype, device)
        self.layers = nn.ModuleList(
            Block(cfg, "g", dtype, device, False)
            for _ in range(cfg.enc_layers))
        self.final_norm = Norm(cfg, dtype, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        embed_init_(self.pos_embed, gen)
        for layer in self.layers:
            layer.reset_parameters(gen)
        self.final_norm.reset_parameters(gen)


class LM(nn.Module):
    """Every parameter of one architecture: ``tok_embed``, ``final_norm``,
    ``layers`` (execution order), ``lm_head`` unless tied, ``pos_embed``
    for learned positions (whisper), ``encoder`` for enc-dec."""

    def __init__(self, cfg: ModelConfig, device: Optional[torch.device],
                 train: bool = False):
        super().__init__()
        self.cfg = cfg
        dtype = compute_dtype(cfg)
        self.tok_embed = param((cfg.vocab_padded, cfg.d_model), dtype, device)
        self.final_norm = Norm(cfg, dtype, device)
        with_cross = cfg.enc_layers > 0
        self.layers = nn.ModuleList(
            Block(cfg, c, dtype, device, with_cross) for c in layer_chars(cfg))
        if not cfg.tie_embeddings:
            self.lm_head = param((cfg.d_model, cfg.vocab_padded), dtype,
                                 device)
        if cfg.rope_theta == 0:  # learned positional embeddings (whisper)
            self.pos_embed = param((32768, cfg.d_model), dtype, device)
        if cfg.enc_layers > 0:
            self.encoder = Encoder(cfg, dtype, device)
        self.requires_grad_(train)

    def reset_parameters(self, gen: torch.Generator) -> None:
        embed_init_(self.tok_embed, gen)
        self.final_norm.reset_parameters(gen)
        for layer in self.layers:
            layer.reset_parameters(gen)
        if hasattr(self, "lm_head"):
            dense_init_(self.lm_head, gen)
        if hasattr(self, "pos_embed"):
            embed_init_(self.pos_embed, gen)
        if hasattr(self, "encoder"):
            self.encoder.reset_parameters(gen)


def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None, train: bool = False) -> LM:
    """Fresh parameters on ``device`` (the card unless ``"cpu"`` is asked
    for), every draw from one generator on that device seeded with
    ``seed``; they require gradients only when built to ``train``.  On a
    split mesh each parameter is a ``DTensor`` of this rank's block
    (``params.distribute_params``), drawn whole leaf by leaf in the
    one-rank order, so it holds the one-rank model's numbers."""
    dev = resolve_device(device)
    if split_mesh(current_mesh()):
        params = LM(cfg, torch.device("meta"), train=train)
        distribute_params(params, dev)
    else:
        params = LM(cfg, dev, train=train)
    params.reset_parameters(make_generator(seed, dev))
    return params


# ----------------------------------------------------------- block apply --

def _apply_block(p: Block, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, causal: bool,
                 cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]],
                 cache_size: int = 0):
    """One residual block.  cache_size > 0 -> also return a primed cache."""
    char = p.char
    collect = cache_size > 0
    entry = None
    h = p.norm1(x)
    if char in ("g", "l"):
        out = attend(p.attn, cfg, h, positions, causal=causal,
                     local=(char == "l"), return_kv=collect)
        if collect:
            h, (k, v) = out
            size = (cache_size if char != "l" or cfg.window == 0
                    else min(cache_size, cfg.window))
            entry = fill_cache(cfg, k, v, char == "l", size)
        else:
            h = out
    elif char == "r":
        out = rglru_mixer(p.rglru, cfg, h, return_state=collect)
        h, entry = out if collect else (out, None)
    else:
        out = mamba_mixer(p.mamba, cfg, h, return_state=collect)
        h, entry = out if collect else (out, None)
    if cfg.post_norms:
        h = p.norm1_post(h)
    x = x + h
    if cross_kv is not None and hasattr(p, "cross"):
        h = p.norm_cross(x)
        h = _cross_attend(p.cross, cfg, h, cross_kv)
        x = x + h
    if hasattr(p, "norm2"):
        h = p.norm2(x)
        if hasattr(p, "moe"):
            h = moe_ffn(p.moe, cfg, h)
        else:
            h = mlp(p.mlp, h, cfg.mlp)
        if cfg.post_norms:
            h = p.norm2_post(h)
        x = x + h
    x = shard(x, "batch", "seq", "embed")
    if collect:
        return x, entry
    return x


def _cross_attend(p: Attention, cfg: ModelConfig, h: torch.Tensor,
                  cross_kv: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Cross-attention against precomputed encoder K/V (B, Senc, Hk, D)."""
    b, s, _ = h.shape
    hq, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = hq // hk
    k, v = cross_kv
    q = _heads(linear(h, p.wq), hq, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps, plus_one=True)
    q, k, v = _head_aligned(q, k, v)

    def attend(q_, k_, v_):
        b_, s_, hq_, _ = q_.shape
        q5 = q_.reshape(b_, s_, k_.shape[2], hq_ // k_.shape[2], hd)
        scores = torch.einsum("bchgd,bshd->bhgcs", q5.float(),
                              k_.float()) * hd ** -0.5
        probs = torch.softmax(scores, dim=-1).to(q_.dtype)
        return torch.einsum("bhgcs,bshd->bchgd", probs, v_).reshape(
            b_, s_, hq_ * hd)

    return linear(per_rank(attend, q, k, v), p.wo)


# ----------------------------------------------------------- embeddings --

def _bf_scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` on the host (``jnp.asarray(v,
    dtype)``), so a product with it reads no scalar from the card."""
    return float(torch.tensor(value, dtype=dtype))


def embed_tokens(params: LM, cfg: ModelConfig, tokens: torch.Tensor,
                 patches: Optional[torch.Tensor]) -> torch.Tensor:
    x = embedding(tokens, params.tok_embed).to(compute_dtype(cfg))
    if cfg.embed_scale:
        x = x * _bf_scalar(cfg.d_model ** 0.5, x.dtype)
    if patches is not None and cfg.vision_patches > 0:
        x = torch.cat([patches.to(x.dtype), x[:, cfg.vision_patches:]], dim=1)
    return shard(x, "batch", "seq", "embed")


# -------------------------------------------------------------- encoder --

def encode(params: LM, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """Whisper encoder over stub frame embeddings (B, Senc, d)."""
    enc = params.encoder
    x = frames.to(compute_dtype(cfg)) + enc.pos_embed[None, :frames.shape[1]]
    pos = torch.arange(frames.shape[1], dtype=torch.int32,
                       device=frames.device)
    for layer in enc.layers:
        x = _apply_block(layer, cfg, x, pos, causal=False, cross_kv=None)
    return enc.final_norm(x)


def cross_kv_from_encoder(cfg: ModelConfig, enc_out: torch.Tensor,
                          block: Block) -> Tuple[torch.Tensor, torch.Tensor]:
    hk, hd = cfg.n_kv_heads, cfg.head_dim
    k = _heads(linear(enc_out, block.cross.wk), hk, hd)
    v = _heads(linear(enc_out, block.cross.wv), hk, hd)
    return k, v


# -------------------------------------------------------------- forward --

def _run_layers(layers: List[Block], cfg: ModelConfig,
                positions: torch.Tensor, enc_out: Optional[torch.Tensor],
                x: torch.Tensor) -> torch.Tensor:
    """``layers`` in turn over ``x`` (the training forward's unit)."""
    for layer in layers:
        ckv = (cross_kv_from_encoder(cfg, enc_out, layer)
               if enc_out is not None else None)
        x = _apply_block(layer, cfg, x, positions, causal=True, cross_kv=ckv)
    return x


def forward(params: LM, cfg: ModelConfig, tokens: torch.Tensor,
            patches: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None,
            cache_size: int = 0):
    """Training/prefill forward.  tokens: (B, S) -> hidden (B, S, d).

    cache_size > 0 also returns the primed decode cache of every layer (in
    execution order) and the encoder's output (None without an encoder).
    With ``cfg.remat``, a forward that takes gradients rematerialises each
    pattern repeat in its backward pass.
    """
    x = embed_tokens(params, cfg, tokens, patches)
    s = tokens.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    if cfg.rope_theta == 0 and hasattr(params, "pos_embed"):
        x = x + params.pos_embed[None, :s]
    enc_out = encode(params, cfg, frames) if cfg.enc_layers > 0 else None
    if cache_size > 0:
        caches: List[Cache] = []
        for layer in params.layers:
            ckv = (cross_kv_from_encoder(cfg, enc_out, layer)
                   if enc_out is not None else None)
            x, entry = _apply_block(layer, cfg, x, positions, causal=True,
                                    cross_kv=ckv, cache_size=cache_size)
            caches.append(entry)
        return params.final_norm(x), caches, enc_out
    n_blocks, _ = cfg.pattern_blocks
    per = len(cfg.layer_pattern)
    layers = list(params.layers)
    remat = cfg.remat and torch.is_grad_enabled()
    for r in range(n_blocks):
        body = functools.partial(_run_layers, layers[r * per:(r + 1) * per],
                                 cfg, positions, enc_out)
        x = checkpoint(body, x, use_reentrant=False) if remat else body(x)
    x = _run_layers(layers[n_blocks * per:], cfg, positions, enc_out, x)
    return params.final_norm(x)


def logits_for(params: LM, cfg: ModelConfig,
               hidden: torch.Tensor) -> torch.Tensor:
    head = params.lm_head if hasattr(params, "lm_head") else params.tok_embed.T
    logits = linear(hidden, head.to(hidden.dtype))
    if cfg.final_softcap > 0:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def lm_loss(params: LM, cfg: ModelConfig, tokens: torch.Tensor,
            patches: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token cross-entropy (``lm.py:304-333``): targets shifted left,
    the last position masked; the sequence in chunks of
    ``min(lmhead_chunk, s)`` (the whole of it when that does not divide
    it), each chunk's logits over the padded vocabulary in fp32 after the
    compute-dtype product, softcap included; the loss is
    ``sum((logz - gold) * mask) / max(sum(mask), 1)``, a 0-d fp32 tensor.
    """
    hidden = forward(params, cfg, tokens, patches, frames)
    b, s, _ = hidden.shape
    targets = per_rank(lambda t: torch.cat(
        [t[:, 1:], t.new_zeros((t.shape[0], 1))], dim=1), tokens)
    mask = torch.cat([torch.ones((b, s - 1), dtype=torch.float32,
                                 device=tokens.device),
                      torch.zeros((b, 1), dtype=torch.float32,
                                  device=tokens.device)], dim=1)
    chunk = min(cfg.lmhead_chunk, s)
    if s % chunk != 0:
        chunk = s
    # each rank's batch rows: vocab-parallel on a split mesh, the masked
    # losses summed over the batch's ranks
    mask_l = local_block(place_like(mask, ("batch", None)))
    losses = []
    for c0 in range(0, s, chunk):
        part = slice(c0, c0 + chunk)
        logits = shard(logits_for(params, cfg, hidden[:, part]).float(),
                       "batch", None, "vocab")
        logz, gold = logsumexp_and_gold(logits, targets[:, part])
        losses.append(((logz - gold) * mask_l[:, part]).sum())
    total = reduce_over_splits(torch.stack(losses).sum(), targets)
    return total / torch.clamp_min(mask.sum(), 1.0)


# --------------------------------------------------------------- decode --

@dataclasses.dataclass
class LMCache:
    """Decode state: one cache a layer (execution order; attention ``k``,
    ``v``; RG-LRU ``conv``, ``state``; mamba ``conv``, ``ssm``), the 0-d
    int32 position of the next token, and the encoder's output for
    enc-dec models."""

    layers: List[Cache]
    pos: torch.Tensor
    enc_out: Optional[torch.Tensor] = None


def init_cache(params: LM, cfg: ModelConfig, batch: int, seq_len: int,
               frames: Optional[torch.Tensor] = None) -> LMCache:
    """Decode cache for every layer (+ the encoder's output for enc-dec)."""
    dtype = compute_dtype(cfg)
    dev = params.tok_embed.device

    def cache_for(char: str) -> Cache:
        if char in ("g", "l"):
            return init_kv_cache(cfg, batch, seq_len, char == "l", dtype, dev)
        if char == "r":
            return init_rglru_cache(cfg, batch, dtype, dev)
        return init_mamba_cache(cfg, batch, dtype, dev)

    enc_out = None
    if cfg.enc_layers > 0:
        enc_out = (encode(params, cfg, frames) if frames is not None else
                   torch.zeros((batch, cfg.enc_seq, cfg.d_model), dtype=dtype,
                               device=dev))
    return _placed_cache(LMCache(
        layers=[cache_for(c) for c in layer_chars(cfg)],
        pos=torch.zeros((), dtype=torch.int32, device=dev), enc_out=enc_out))


def _placed_cache(cache: LMCache) -> LMCache:
    """On a split mesh every cache leaf a DTensor placed by its
    ``CACHE_DIMS`` (batch over the batch axes, heads and features over
    ``model``), so decode's in-place writes are each rank's own; ``pos``
    stays a plain 0-d tensor, the same on every rank."""
    if not split_mesh(current_mesh()):
        return cache

    def put(name: str, t: torch.Tensor) -> torch.Tensor:
        dims = CACHE_DIMS[name]
        if isinstance(t, DTensor):
            return shard(t, *dims)
        return place_like(t, dims)

    layers = [{k: put(k, t) for k, t in c.items()} for c in cache.layers]
    enc = None if cache.enc_out is None else put("enc_out", cache.enc_out)
    return LMCache(layers=layers, pos=cache.pos, enc_out=enc)


def _decode_block(p: Block, cfg: ModelConfig, x: torch.Tensor, c: Cache,
                  pos: torch.Tensor, enc_out: Optional[torch.Tensor]):
    char = p.char
    h = p.norm1(x)
    if char in ("g", "l"):
        h, c = decode_attend(p.attn, cfg, h, c, pos, local=(char == "l"))
    elif char == "r":
        h, c = rglru_decode(p.rglru, cfg, h, c)
    else:
        h, c = mamba_decode(p.mamba, cfg, h, c)
    if cfg.post_norms:
        h = p.norm1_post(h)
    x = x + h
    if enc_out is not None and hasattr(p, "cross"):
        h = p.norm_cross(x)
        ckv = cross_kv_from_encoder(cfg, enc_out, p)
        h, _ = decode_attend(p.cross, cfg, h, c, pos, cross_kv=ckv)
        x = x + h
    if hasattr(p, "norm2"):
        h = p.norm2(x)
        if hasattr(p, "moe"):
            h = moe_ffn(p.moe, cfg, h)
        else:
            h = mlp(p.mlp, h, cfg.mlp)
        if cfg.post_norms:
            h = p.norm2_post(h)
        x = x + h
    return x, c


def decode_step(params: LM, cfg: ModelConfig, cache: LMCache,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, LMCache]:
    """One serving step: tokens (B,) -> logits (B, V); ``cache`` is updated
    in place (its tensors and ``pos``) and returned."""
    pos = cache.pos
    x = embed_tokens(params, cfg, tokens[:, None], None)
    if cfg.rope_theta == 0 and hasattr(params, "pos_embed"):
        x = x + params.pos_embed.index_select(0, pos.reshape(1))[None]
    for layer, c in zip(params.layers, cache.layers):
        x, _ = _decode_block(layer, cfg, x, c, pos, cache.enc_out)
    x = params.final_norm(x)
    logits = logits_for(params, cfg, x)[:, 0]
    pos.add_(1)
    return logits, cache


def prefill(params: LM, cfg: ModelConfig, tokens: torch.Tensor,
            seq_len: int, patches: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, LMCache]:
    """Prompt processing: last-position logits + a fully primed cache."""
    hidden, caches, enc_out = forward(params, cfg, tokens, patches, frames,
                                      cache_size=seq_len)
    logits = logits_for(params, cfg, hidden[:, -1:])[:, 0]
    pos = torch.full((), tokens.shape[1], dtype=torch.int32,
                     device=tokens.device)
    return logits, _placed_cache(LMCache(layers=caches, pos=pos,
                                         enc_out=enc_out))
