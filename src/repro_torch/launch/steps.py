"""Train, serve and prefill step factories and the abstract input specs
(mirrors ``repro/launch/steps.py``).

The JAX factories return functions to ``jit``; these return the plain
functions the launchers call.  The train step differentiates
``lm.lm_loss`` with autograd (the counterpart of ``jax.value_and_grad``)
and updates the parameters and the optimizer state in place (JAX donates
them).

The abstract specs are the port's ``jax.eval_shape``: ``abstract_params``
is the LM built on the ``meta`` device, and every other spec is a flat
dict ``{JAX tree path: convert.ShapeDtype}`` in the JAX layout (stacked
repeats included), so its shapes and dtypes compare with JAX's leaf for
leaf.  The shardings are the port's ``NamedSharding`` records, or None
outside a sharding context.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..convert import (ShapeDtype, leaf_spec, lm_cache_groups,
                       lm_leaf_groups, lm_leaf_specs)
from ..distributed.sharding import named_sharding
from ..models import lm
from ..models.params import cache_shardings, param_shardings
from ..optim import AdamWConfig, apply_updates, compress_grads

# ------------------------------------------------------------- factories --

def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    compress: bool = False):
    """Returns train_step(params, opt_state, batch) -> (loss, params,
    opt_state): ``params`` an ``LM`` built to train, ``opt_state`` the
    ``optim.init_opt_state`` of its leaf groups (plus ``"err"``, the
    ``init_error_state``, with ``compress``), ``batch`` holding ``tokens``
    and, where the architecture takes them, ``patches`` or ``frames``.  The
    parameters and moments are written in place; ``loss`` is a 0-d fp32
    tensor (reading it is the caller's one sync)."""

    def train_step(params, opt_state, batch):
        groups = lm_leaf_groups(params)
        flat = [t for g in groups.values() for t in g]
        loss = lm.lm_loss(params, cfg, batch["tokens"],
                          patches=batch.get("patches"),
                          frames=batch.get("frames"))
        got = iter(torch.autograd.grad(loss, flat))
        grads = {k: [next(got) for _ in g] for k, g in groups.items()}
        if compress:
            grads, opt_state["err"] = compress_grads(grads, opt_state["err"])
        _, new_opt = apply_updates(
            opt_cfg, groups, grads,
            {k: v for k, v in opt_state.items() if k != "err"})
        opt_state["step"] = new_opt["step"]
        return loss.detach(), params, opt_state

    return train_step


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


# ----------------------------------------------------------- input specs --

def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Abstract specs for one host batch (training / prefill)."""
    b, s = shape.global_batch, shape.seq_len
    specs = {"tokens": ShapeDtype((b, s), torch.int32)}
    if cfg.vision_patches > 0:
        specs["patches"] = ShapeDtype((b, cfg.vision_patches, cfg.d_model),
                                      torch.bfloat16)
    if cfg.enc_layers > 0:
        specs["frames"] = ShapeDtype((b, cfg.enc_seq, cfg.d_model),
                                     torch.bfloat16)
    return specs


def batch_shardings(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    out = {"tokens": named_sharding(("batch", None),
                                    (shape.global_batch, shape.seq_len))}
    if cfg.vision_patches > 0:
        out["patches"] = named_sharding(
            ("batch", None, "embed"),
            (shape.global_batch, cfg.vision_patches, cfg.d_model))
    if cfg.enc_layers > 0:
        out["frames"] = named_sharding(
            ("batch", None, "embed"),
            (shape.global_batch, cfg.enc_seq, cfg.d_model))
    return out


def abstract_params(cfg: ModelConfig) -> lm.LM:
    """The LM on the ``meta`` device: shapes and dtypes, no storage."""
    return lm.LM(cfg, torch.device("meta"))


def abstract_opt_state(aparams) -> Dict[str, Any]:
    """``{"mu", "nu": {path: ShapeDtype fp32}, "step": int32 scalar}`` of
    an abstract LM (or of its flat leaf specs)."""
    specs = aparams if isinstance(aparams, dict) else lm_leaf_specs(aparams)
    moments = {k: ShapeDtype(v.shape, torch.float32)
               for k, v in specs.items()}
    return {"mu": moments, "nu": dict(moments),
            "step": ShapeDtype((), torch.int32)}


def abstract_cache(cfg: ModelConfig, batch: int,
                   seq_len: int) -> Dict[str, ShapeDtype]:
    """``{path: ShapeDtype}`` of the decode cache in the JAX layout."""
    cache = lm.init_cache(abstract_params(cfg), cfg, batch, seq_len)
    return {path: leaf_spec(g)
            for path, g in lm_cache_groups(cache, cfg).items()}


def opt_shardings(aopt, pshardings) -> Dict[str, Any]:
    """Optimizer moments inherit the param shardings; step is replicated."""
    return {"mu": pshardings, "nu": pshardings,
            "step": named_sharding((), ())}


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Everything the step consumes, as flat dicts of ``ShapeDtype``
    (``params`` keyed by JAX tree path)."""
    aparams = lm_leaf_specs(abstract_params(cfg))
    if shape.kind == "train":
        return {"params": aparams,
                "opt_state": abstract_opt_state(aparams),
                "batch": batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        return {"params": aparams, "batch": batch_specs(cfg, shape)}
    # decode: one new token against a seq_len cache
    return {"params": aparams,
            "cache": abstract_cache(cfg, shape.global_batch, shape.seq_len),
            "tokens": ShapeDtype((shape.global_batch,), torch.int32)}


def input_shardings(cfg: ModelConfig, shape: ShapeConfig,
                    specs: Dict[str, Any]) -> Dict[str, Any]:
    ps = param_shardings(specs["params"])
    if shape.kind == "train":
        return {"params": ps,
                "opt_state": opt_shardings(specs["opt_state"], ps),
                "batch": batch_shardings(cfg, shape)}
    if shape.kind == "prefill":
        return {"params": ps, "batch": batch_shardings(cfg, shape)}
    return {"params": ps, "cache": cache_shardings(specs["cache"]),
            "tokens": named_sharding(("batch",), (shape.global_batch,))}
