"""AdamW with decoupled weight decay, global-norm clipping and schedules
(mirrors ``repro/optim/adamw.py``), as plain functions on tensors.

A tree here is ``{JAX tree path: [tensor, ...]}`` in the JAX package's
flatten order (``convert.lm_leaf_groups``): one tensor for a leaf the JAX
tree holds whole, one a repeat for a leaf stacked over scanned repeats.
The optimizer state is grouped the same way, so every per-leaf rule sees
the JAX leaf: weight decay goes to leaves of JAX rank >= 2, which takes in
the norm scales and biases of stacked repeats (2-D there) and leaves out
the same leaves of the tail (1-D).

The arithmetic is the JAX function's, op for op, in fp32 on the device
(not ``torch.optim.AdamW``, which decays before the step, divides by
``sqrt(nu)/sqrt(bc2) + eps`` and neither clips nor schedules): ``step`` is
a 0-d int32 tensor; the bias corrections are fp32 powers; the schedule is
fp32; each update is made in fp32 and cast back to the parameter's dtype
(bf16 rounds to nearest even); the moments are fp32.  ``apply_updates``
writes the parameters and the moments in place (JAX donates them) and
reads nothing back to the host.

On a split mesh parameters, gradients and moments are DTensors of one
placement a leaf (the gradients brought to their parameters' placements by
the train step), so every update is local to each rank's block; only the
global norm crosses ranks.  Decay still follows the JAX leaf's rank
(``_jax_ndim``: a DTensor's ``dim()`` is the whole tensor's).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import torch

from ..distributed.sharding import reduce_over_splits, settled

Tree = Dict[str, List[torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac, in fp32."""
    s = step.float()
    warm = s / max(1.0, cfg.warmup_steps)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(1.0, cfg.total_steps - cfg.warmup_steps), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.clamp(warm, max=1.0) * torch.where(
        s < cfg.warmup_steps, 1.0, cos)


def init_opt_state(params: Tree) -> dict:
    """fp32 zero moments shaped and placed as ``params`` (a DTensor
    parameter's moments are DTensors of its placements: the ZeRO
    partitioning of the optimizer state), and ``step`` 0 (int32)."""
    def zeros(group):
        return [torch.zeros_like(p, dtype=torch.float32,
                                 memory_format=torch.contiguous_format)
                for p in group]

    dev = next(iter(params.values()))[0].device
    return {"mu": {k: zeros(g) for k, g in params.items()},
            "nu": {k: zeros(g) for k, g in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32, leaf by leaf in
    the tree's order (a stacked leaf's repeats summed in turn).  DTensor
    leaves (a ``Partial`` one, an autograd gradient, reduced first) add
    their local blocks' squares per placement (each class of
    leaves a ``Partial`` over the axes that split it), and each class is
    reduced to one replicated scalar, the classes summed in the order
    they first appear: the norm of the whole tree on every rank."""
    from torch.distributed.tensor import DTensor
    total = None
    partial: Dict[tuple, list] = {}
    for group in tree.values():
        for x in group:
            if isinstance(x, DTensor):
                x = settled(x)
                sq = torch.sum(torch.square(x.to_local().float()))
                key = tuple(x.placements)
                if key in partial:
                    partial[key][0] = partial[key][0] + sq
                else:
                    partial[key] = [sq, x]
                continue
            sq = torch.sum(torch.square(x.float()))
            total = sq if total is None else total + sq
    for local, ref in partial.values():
        sq = reduce_over_splits(local, ref)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _jax_ndim(group: List[torch.Tensor]) -> int:
    """The rank of the JAX leaf a group holds (stacked: one more)."""
    return group[0].dim() + (len(group) > 1)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: Tree, grads: Tree,
                  state: dict) -> Tuple[Tree, dict]:
    """One AdamW step, in place.  Gradients may arrive in bf16; moments are
    fp32.  Returns ``(params, state)``, the same tensors, and ``state``'s
    ``step`` a new 0-d tensor one further."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1c = 1.0 - torch.pow(cfg.b1, step.float())
    b2c = 1.0 - torch.pow(cfg.b2, step.float())
    for path, group in params.items():
        decay = _jax_ndim(group) >= 2  # decay matrices only
        for p, g, mu, nu in zip(group, grads[path], state["mu"][path],
                                state["nu"][path]):
            g = g.float() * scale
            mu.copy_(cfg.b1 * mu + (1 - cfg.b1) * g)
            nu.copy_(cfg.b2 * nu + (1 - cfg.b2) * g * g)
            mhat = mu / b1c
            nhat = nu / b2c
            delta = mhat / (torch.sqrt(nhat) + cfg.eps)
            if decay:
                delta = delta + cfg.weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))
    state["step"] = step
    return params, state
