"""The ten architectures of the LM zoo at their published widths (a copy of
``repro/configs/archs.py``, same values).

Each is selectable via --arch <id> in the launchers.  smoke() returns the
reduced same-family config used by per-arch CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from .base import ModelConfig

ARCHS: Dict[str, ModelConfig] = {}


def _register(cfg: ModelConfig) -> ModelConfig:
    ARCHS[cfg.name] = cfg
    return cfg


# --- InternVL2-26B: InternViT stub frontend + InternLM2-20B backbone ----
internvl2_26b = _register(ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=92553, head_dim=128, rope_theta=1e6,
    vision_patches=256,
))

# --- Gemma2-2B: local/global alternating, softcaps, post-norms ----------
gemma2_2b = _register(ModelConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, d_ff=9216,
    vocab=256000, head_dim=256, layer_pattern="lg", window=4096,
    attn_softcap=50.0, final_softcap=30.0, post_norms=True,
    embed_scale=True, mlp="geglu", tie_embeddings=True,
))

# --- Mistral-Nemo-12B: 128k ctx ------------------------------------------
mistral_nemo_12b = _register(ModelConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=131072, head_dim=128, rope_theta=1e6,
))

# --- Qwen3-32B: qk-norm, GQA ---------------------------------------------
qwen3_32b = _register(ModelConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, d_ff=25600,
    vocab=151936, head_dim=128, qk_norm=True, rope_theta=1e6,
))

# --- Qwen1.5-0.5B: QKV bias ----------------------------------------------
qwen15_05b = _register(ModelConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=2816,
    vocab=151936, head_dim=64, qkv_bias=True, tie_embeddings=True,
))

# --- Moonlight-16B-A3B: 64 experts top-6 ----------------------------------
moonshot_v1_16b_a3b = _register(ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=163840, head_dim=128,
    n_experts=64, n_experts_active=6,
))

# --- Qwen3-MoE-30B-A3B: 128 experts top-8 ---------------------------------
qwen3_moe_30b_a3b = _register(ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_ff=768,
    vocab=151936, head_dim=128, qk_norm=True, rope_theta=1e6,
    n_experts=128, n_experts_active=8,
))

# --- Falcon-Mamba-7B: pure mamba1 ------------------------------------------
falcon_mamba_7b = _register(ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=65024, layer_pattern="m", ssm_state=16, d_conv=4, expand=2,
    subquadratic=True,
))

# --- RecurrentGemma-2B: RG-LRU + local attention, 1:2 ----------------------
recurrentgemma_2b = _register(ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab=256000, head_dim=256, layer_pattern="rrl", window=2048,
    lru_width=2560, embed_scale=True, mlp="geglu", tie_embeddings=True,
    subquadratic=True,
))

# --- Whisper-tiny: enc-dec, conv frontend stub ------------------------------
whisper_tiny = _register(ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536,
    vocab=51865, head_dim=64, rope_theta=0.0, mlp="gelu",
    enc_layers=4, enc_seq=1500, tie_embeddings=True,
))


def get_config(name: str) -> ModelConfig:
    return ARCHS[name]


def smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    kw = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.n_layers % 2 == 0 else 3),
        d_model=128, d_ff=min(cfg.d_ff, 256) if cfg.d_ff else 0,
        vocab=512, head_dim=32,
        n_heads=min(cfg.n_heads, 4) if cfg.n_heads else 0,
        lmhead_chunk=64, dtype="float32", remat=False,
    )
    if cfg.n_kv_heads:
        kw["n_kv_heads"] = min(cfg.n_kv_heads, kw["n_heads"])
    if cfg.n_experts:
        kw["n_experts"] = 8
        kw["n_experts_active"] = min(cfg.n_experts_active, 2)
        kw["capacity_factor"] = 8.0
    if cfg.window:
        kw["window"] = 8
    if cfg.lru_width:
        kw["lru_width"] = 128
    if cfg.enc_layers:
        kw["enc_layers"] = 2
        kw["enc_seq"] = 16
    if cfg.vision_patches:
        kw["vision_patches"] = 8
    if cfg.layer_pattern == "rrl":
        kw["n_layers"] = 5  # 1 full pattern + 2 tail -> exercises both paths
    if cfg.layer_pattern == "lg":
        kw["n_layers"] = 4
    return cfg.with_(**kw)
