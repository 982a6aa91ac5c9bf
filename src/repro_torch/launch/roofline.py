"""Roofline of a step on the H100: the card's peak rates, the paper's
first-principles traffic of a fused BCPNN forward, and the three time
terms of a step's counts (mirrors ``repro/launch/roofline.py``).

* ``model_flops`` is the useful work of one step of an (architecture,
  shape) cell, ``6·N·D`` to train and ``2·N·D`` to prefill or decode, with
  ``N`` the active parameters a token (``param_count_active``: an MoE
  counts its top-k experts and the router) and ``D`` the step's tokens.
* ``dtype_bytes`` and ``bcpnn_fwd_traffic`` are the JAX module's, name for
  name: the paper's Eq. 2-5 traffic of one inference forward with the
  serving dtype as a free variable.
* ``analyze`` prices a step's counts with the card's peaks: FLOPs by the
  dtype of their operands, HBM bytes and collective bytes, all of one
  rank.  The JAX module reads those counts out of compiled HLO text and
  prices every FLOP at one TPU peak; the port has no HLO, so the dry run
  (``launch/dryrun.py``) counts them on fake tensors, and an fp32 product
  (TF32 stays off in the port) runs at the CUDA cores' rate, 15x below
  bf16's.

The peaks are NVIDIA's data sheet for the card the port runs on, an
NVIDIA H100 80GB HBM3 (SXM5) at its 700 W power limit; a card set below
that limit runs slower under load.  ``chip_smoke.py`` prices its kernels'
``bound_ms`` with the same constants and measures a device copy and the
tensor cores' rate beside them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

from ..configs.base import ModelConfig, ShapeConfig

# NVIDIA H100 80GB HBM3 (SXM5), 700 W, data sheet: HBM3 bytes/s.
PEAK_BYTES_S = 3.35e12
# The same card and limit: fp32 FLOP/s outside the tensor cores.
PEAK_FP32_FLOP_S = 67e12
# The same card and limit: dense TF32 FLOP/s of the tensor cores.
PEAK_TF32_FLOP_S = 495e12
# The same card and limit: dense bf16 (and fp16) FLOP/s of the tensor cores.
PEAK_BF16_FLOP_S = 989e12
# The same card and limit: dense int8 OP/s of the tensor cores.
PEAK_INT8_OPS_S = 1979e12
# The same card and limit: NVLink 4 to the host's other cards, 900 GB/s in
# all, 450 GB/s each way.
LINK_BYTES_S = 450e9

# The peak a product runs at, by the torch dtype name of its operands.
PEAK_BY_DTYPE = {"float32": PEAK_FP32_FLOP_S, "bfloat16": PEAK_BF16_FLOP_S,
                 "float16": PEAK_BF16_FLOP_S, "int8": PEAK_INT8_OPS_S}

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1,
}

# Serving-dtype aliases (the repo's ProjSpec.infer_dtype vocabulary and
# numpy-style names) onto the HLO dtype table above.
_DTYPE_ALIASES = {
    "fp32": "f32", "float32": "f32", "int8": "s8", "bfloat16": "bf16",
    "float16": "f16",
}


def dtype_bytes(dtype: str) -> int:
    """Bytes per element for an HLO dtype name OR a serving-dtype alias
    (fp32/bf16/int8...)."""
    key = _DTYPE_ALIASES.get(dtype, dtype)
    try:
        return _DTYPE_BYTES[key]
    except KeyError:
        raise ValueError(f"unknown dtype {dtype!r}; known: "
                         f"{sorted(_DTYPE_BYTES)} + aliases "
                         f"{sorted(_DTYPE_ALIASES)}") from None


def bcpnn_fwd_traffic(batch: int, n_in: int, n_out: int,
                      weight_dtype: str = "fp32",
                      act_dtype: str = "fp32",
                      n_hc: int = 1) -> Dict[str, float]:
    """First-principles HBM traffic/FLOPs of one inference-only fused
    BCPNN forward (support matmul + bias + per-HC softmax), parameterized
    by the serving dtype: the paper's Eq. 2-5 methodology with
    bytes-per-element as a free variable.

    Model (weights stream once, activations once, output written f32):
      FLOPs = 2·B·Ni·Nj (support) + ~6·B·Nj (bias + softmax epilogue)
      Bytes = act·B·Ni (x) + w·(Ni·Nj + Nj) (weights + bias)
              + 4·n_hc (int8 per-HC scale vector, else 0) + 4·B·Nj (out)

    The bias is counted at the weight's width; the port's int8 pack keeps
    an fp32 bias (``chip_smoke.py`` phase 1 prints both counts).  Trace
    state is always fp32 (DESIGN.md §8): only the inference path changes
    dtype.
    """
    wb = dtype_bytes(weight_dtype)
    ab = dtype_bytes(act_dtype)
    flops = 2.0 * batch * n_in * n_out + 6.0 * batch * n_out
    bytes_ = (ab * batch * n_in + wb * (n_in * n_out + n_out)
              + (4.0 * n_hc if wb == 1 else 0.0) + 4.0 * batch * n_out)
    return {"flops": flops, "bytes": bytes_,
            "intensity": flops / bytes_}


@dataclasses.dataclass
class Roofline:
    flops: float
    bytes: float
    coll_bytes: float
    coll_detail: Dict[str, float]
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops_per_chip: float = 0.0
    useful_ratio: float = 0.0
    flops_by_dtype: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    def to_dict(self):
        return dataclasses.asdict(self)


def analyze(flops_by_dtype: Mapping[str, float], result_bytes: float,
            coll_bytes: float = 0.0,
            coll_detail: Mapping[str, float] = (),
            model_flops_global: float = 0.0, n_chips: int = 1) -> Roofline:
    """The least time one rank's step could take on the card, term by term,
    from the step's counts on that rank:

    * ``compute_s``: the sum over operand dtypes of that dtype's FLOPs
      over its peak (``PEAK_BY_DTYPE``; a dtype without one raises);
    * ``memory_s``: HBM bytes over ``PEAK_BYTES_S``, the bytes being the
      operations' results (``result_bytes``) times 2 for their reads, the
      JAX module's rule;
    * ``collective_s``: collective bytes over one NVLink direction,
      ``LINK_BYTES_S``.  A collective that crosses nodes runs over
      InfiniBand and takes longer; that is not measured.

    ``bottleneck`` names the largest term.  Each term is a bound, not a
    prediction: the step takes at least the largest of them.
    """
    compute_s = 0.0
    for dtype, n in flops_by_dtype.items():
        if dtype not in PEAK_BY_DTYPE:
            raise ValueError(f"no peak rate for products in {dtype!r}; "
                             f"known: {sorted(PEAK_BY_DTYPE)}")
        compute_s += n / PEAK_BY_DTYPE[dtype]
    flops = float(sum(flops_by_dtype.values()))
    hbm_bytes = 2.0 * result_bytes
    memory_s = hbm_bytes / PEAK_BYTES_S
    coll_s = coll_bytes / LINK_BYTES_S
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops_global / max(1, n_chips)
    return Roofline(
        flops=flops, bytes=hbm_bytes, coll_bytes=float(coll_bytes),
        coll_detail=dict(coll_detail), compute_s=compute_s,
        memory_s=memory_s, collective_s=coll_s, bottleneck=bottleneck,
        model_flops_per_chip=mf, useful_ratio=(mf / flops) if flops else 0.0,
        flops_by_dtype={k: float(v) for k, v in flops_by_dtype.items()})


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
