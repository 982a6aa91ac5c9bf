"""Serve and prefill step factories (mirrors ``repro/launch/steps.py``,
serving half).

The JAX factories return functions to ``jit``; these return the plain
functions the serve launcher calls.  The train step and the abstract input
and sharding specs wait for the training and dry-run slices (ROADMAP.md
queue A items 10b, 10c).
"""
from __future__ import annotations

from ..configs.base import ModelConfig
from ..models import lm


def make_serve_step(cfg: ModelConfig):
    """Returns serve_step(params, cache, tokens) -> (logits, cache); the
    cache is written in place (JAX donates it)."""

    def serve_step(params, cache, tokens):
        return lm.decode_step(params, cfg, cache, tokens)

    return serve_step


def make_prefill_step(cfg: ModelConfig, seq_len: int):
    """Returns prefill_step(params, batch) -> (logits, cache) for a cache
    of ``seq_len`` positions; ``batch`` holds ``tokens`` and, where the
    architecture takes them, ``patches`` or ``frames``."""

    def prefill_step(params, batch):
        return lm.prefill(params, cfg, batch["tokens"], seq_len,
                          patches=batch.get("patches"),
                          frames=batch.get("frames"))
    return prefill_step
