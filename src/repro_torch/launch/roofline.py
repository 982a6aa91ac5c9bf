"""Model FLOPs of a cell (the model half of ``repro/launch/roofline.py``).

``model_flops`` is the useful work of one step of an (architecture, shape)
cell, ``6·N·D`` to train and ``2·N·D`` to prefill or decode, with ``N``
the active parameters a token (``param_count_active``: an MoE counts its
top-k experts and the router) and ``D`` the step's tokens.  The dry run
(``launch/dryrun.py``) divides it by the ranks and by the FLOPs a rank
runs to give ``useful_ratio``.

The JAX module's other half reads FLOPs, bytes and collective bytes out of
compiled HLO text and prices them with a TPU's peak rates; neither has a
counterpart here.  The port counts a step's FLOPs and collective bytes by
running it under fake tensors (``launch/dryrun.py``), and the card's
rates are measured, not assumed (``chip_smoke.py``).
"""
from __future__ import annotations

from ..configs.base import ModelConfig, ShapeConfig


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE); decode: D = batch
    tokens; train: x3 is already in the 6 (fwd+bwd)."""
    n = param_count_active(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # one token per sequence


def param_count_active(cfg: ModelConfig) -> float:
    """Active parameters per token (MoE counts top-k experts + router)."""
    d, v = cfg.d_model, cfg.vocab_padded
    emb = v * d * (1 if cfg.tie_embeddings else 2)
    attn = (d * cfg.n_heads * cfg.head_dim * 2
            + d * cfg.n_kv_heads * cfg.head_dim * 2)
    glu = 3 if cfg.mlp in ("swiglu", "geglu") else 2
    mlp_p = glu * d * cfg.d_ff
    total = emb
    for i, ch in enumerate(cfg.layer_pattern):
        n_of_this = cfg.n_layers // len(cfg.layer_pattern) + (
            1 if i < cfg.n_layers % len(cfg.layer_pattern) else 0)
        if ch in ("g", "l"):
            layer = attn + (cfg.n_experts_active * mlp_p + d * cfg.n_experts
                            if cfg.n_experts else mlp_p)
        elif ch == "m":
            di = cfg.d_inner
            layer = (d * 2 * di + di * d + cfg.d_conv * di
                     + di * (cfg.dt_rank_eff + 2 * cfg.ssm_state)
                     + cfg.dt_rank_eff * di + di * cfg.ssm_state)
        else:  # rg-lru
            w = cfg.lru_width_eff
            layer = d * w * 2 + w * d + w * w * 2 + cfg.d_conv * w + mlp_p
        total += n_of_this * layer
    if cfg.enc_layers:
        total += cfg.enc_layers * (attn + mlp_p)
    return float(total)
