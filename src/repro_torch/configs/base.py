"""Model configuration schema shared by every architecture in the LM zoo
(a copy of ``repro/configs/base.py``: the port imports nothing of the JAX
package).  ``scan_layers`` and ``remat`` shape the JAX programs only; the
port's serving path reads neither."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    # --- attention variants -------------------------------------------
    qk_norm: bool = False          # qwen3: RMSNorm on q/k heads
    qkv_bias: bool = False         # qwen1.5
    attn_softcap: float = 0.0      # gemma2: tanh logit soft-capping
    final_softcap: float = 0.0     # gemma2: final-logit soft-capping
    window: int = 0                # sliding window for local layers
    layer_pattern: str = "g"       # repeating unit: g=global l=local r=RG-LRU m=mamba
    post_norms: bool = False       # gemma2: post-attn/post-ffn RMSNorm
    embed_scale: bool = False      # gemma2: scale embeddings by sqrt(d)
    mlp: str = "swiglu"            # swiglu | geglu | gelu
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # --- MoE -----------------------------------------------------------
    n_experts: int = 0
    n_experts_active: int = 0
    capacity_factor: float = 1.25
    moe_groups: int = 0            # dispatch groups (0 -> data shards at runtime)
    # --- SSM / recurrent -------------------------------------------------
    ssm_state: int = 16
    ssm_chunk: int = 0             # >1: chunked scan w/ remat (see §Perf)
    d_conv: int = 4
    expand: int = 2                # mamba d_inner = expand * d_model
    dt_rank: int = 0               # 0 -> ceil(d_model / 16)
    lru_width: int = 0             # 0 -> d_model
    # --- encoder-decoder (whisper) / vlm --------------------------------
    enc_layers: int = 0
    enc_seq: int = 1504            # stub conv-frontend output frames (pre-padded)
    vision_patches: int = 0        # vlm: patch embeddings prepended to sequence
    # --- execution -------------------------------------------------------
    subquadratic: bool = False     # eligible for long_500k decode
    remat: bool = True
    scan_layers: bool = True
    dtype: str = "bfloat16"
    lmhead_chunk: int = 512        # seq chunking of the softmax-xent loss

    @property
    def vocab_padded(self) -> int:
        return ((self.vocab + 255) // 256) * 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank_eff(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def lru_width_eff(self) -> int:
        return self.lru_width or self.d_model

    @property
    def pattern_blocks(self) -> Tuple[int, int]:
        """(#scanned pattern repeats, #tail layers)."""
        p = len(self.layer_pattern)
        return self.n_layers // p, self.n_layers % p

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell from the assignment."""

    name: str          # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
