"""Replica state reconciliation (mirrors ``repro/serve/reconcile.py``): the
bit-exact disjoint-support merge, lifted from the data-parallel trace
all-reduce to whole model states.

Why replicas agree in the first place (the protocol, DESIGN.md §11):
the router BROADCASTS every labeled feedback sample of a replicated
online-learning model to all live replicas in one admission order, and
replicas run ``feedback_eager=False`` — folds fire only on FULL
feedback batches, so the fold compositions are a pure function of the
feedback stream prefix, never of worker timing.  Two replicas that have
folded the same prefix (both feedback buffers empty = quiescent) are
therefore bit-identical by construction.

Reconciliation VERIFIES that invariant (and repairs drift): each of the
K replicas contributes one contiguous chunk of every raveled state
leaf, each chunk is scattered into zeros at its own offset, and the K
zero-padded partials are summed (no divisibility constraint).  Every
element of the merged leaf is one real value plus zeros, so IF the
replicas agree the merge is bit-identical to every one of them (a -0.0
comes out +0.0, as in the reference); if they diverged, the merged state
differs from at least one replica and the router repairs the laggards
from the authoritative replica (max folded samples, finite).

The leaves of a port ``DeepState`` are the JAX ``DeepState``'s, in its
``tree_leaves`` order and under the checkpoint's names
(``checkpoint/ckpt.py::_flatten_with_names``): the tensors, then ``step``
and ``key`` (the generator's seed words).  Everything here is host-side
numpy on settled states, on host copies of the leaves — reconciliation
runs at fold boundaries (``EngineHandle.model_state_sync``), never on the
per-request path.  ``copy_state`` gives a state tensors and a generator of
its own on a device: the port's states are mutable, so no two replicas,
and no replica and the router's checkpoint, share storage.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..checkpoint.ckpt import _flatten_with_names, _host_array
from ..core.bcpnn_layer import Projection
from ..core.graphs import card_lock
from ..core.network import DeepState
from ..core.traces import Traces


def chunk_bounds(n: int, k: int) -> List[Tuple[int, int]]:
    """K contiguous [start, stop) chunks covering range(n) — first
    ``n % k`` chunks one element longer (numpy array_split convention),
    so any leaf size shards over any replica count, empty chunks
    included."""
    if k < 1:
        raise ValueError(f"need k >= 1 chunks, got {k}")
    base, extra = divmod(n, k)
    out, start = [], 0
    for i in range(k):
        size = base + (1 if i < extra else 0)
        out.append((start, start + size))
        start += size
    return out


def _named_leaves(state: DeepState) -> Tuple[List[str], List[np.ndarray]]:
    """(names, host arrays) of a state's leaves, in the JAX leaf order."""
    names, leaves = _flatten_with_names(state)
    with card_lock:
        return names, [a if isinstance(a, np.ndarray) else _host_array(a)
                       for a in leaves]


def _keystr(name: str) -> str:
    """A leaf name as ``jax.tree_util.keystr`` prints the JAX path:
    ``projs/0/traces/pi`` -> ``.projs[0].traces.pi``."""
    return "".join(f"[{p}]" if p.isdigit() else f".{p}"
                   for p in name.split("/"))


def _copy_generator(gen: torch.Generator,
                   device: torch.device) -> torch.Generator:
    """A new generator on ``device`` at ``gen``'s state; on another device
    type (whose state has another form) re-seeded with ``gen``'s seed, the
    checkpoint's rule (``checkpoint/ckpt.py``)."""
    out = torch.Generator(device=device)
    if torch.device(device).type == gen.device.type:
        out.set_state(gen.get_state())
    else:
        out.manual_seed(gen.initial_seed())
    return out


def copy_state(state: DeepState, device=None) -> DeepState:
    """``state`` in tensors of its own on ``device`` (its own device by
    default), with a generator of its own at the same state.  A host copy
    (``device="cpu"`` of a card state) keeps a generator of the card's
    kind, a host object, so the copy returns to the card at the same
    position."""
    dev = state.device if device is None else torch.device(device)
    gen_dev = state.generator.device if dev.type == "cpu" else dev

    def own(t):
        return None if t is None else t.detach().to(dev, copy=True)

    def proj(p: Projection) -> Projection:
        tr = p.traces
        return Projection(
            traces=Traces(pi=own(tr.pi), pj=own(tr.pj), pij=own(tr.pij),
                          t=own(tr.t), t_host=tr.t_host),
            w=own(p.w), b=own(p.b), mask=own(p.mask), table=own(p.table))

    with card_lock:
        return DeepState(projs=tuple(proj(p) for p in state.projs),
                         readout=proj(state.readout), step=own(state.step),
                         generator=_copy_generator(state.generator, gen_dev))


def merge_replica_states(states: Sequence[DeepState]) -> DeepState:
    """Disjoint-support merge of K replica states (same structure) into
    one: replica i contributes chunk i of every raveled leaf, scattered
    into zeros and summed.  Bit-identical to each input iff the replicas
    agree (see module docstring).  Returns a host state (CPU tensors)
    whose generator is a new one at the first replica's state."""
    states = list(states)
    if not states:
        raise ValueError("merge_replica_states needs >= 1 replica state")
    k = len(states)
    named = [_named_leaves(s) for s in states]
    names, flats = named[0][0], [leaves for _, leaves in named]
    n_leaves = len(flats[0])
    for i, f in enumerate(flats[1:], 1):
        if len(f) != n_leaves:
            raise ValueError(f"replica {i} has {len(f)} leaves, replica 0 "
                             f"has {n_leaves} — states are not congruent")
    merged = {}
    for leaf_idx in range(n_leaves):
        ref = flats[0][leaf_idx]
        bounds = chunk_bounds(ref.size, k)
        # zero-padded disjoint partials + sum: each element is one real
        # value plus zeros (the reference's arithmetic, np.add for psum)
        acc = np.zeros(ref.size, dtype=ref.dtype)
        for r, (a, b) in enumerate(bounds):
            part = np.zeros(ref.size, dtype=ref.dtype)
            part[a:b] = flats[r][leaf_idx].reshape(-1)[a:b]
            acc = np.add(acc, part)
        merged[names[leaf_idx]] = torch.from_numpy(acc.reshape(ref.shape))
    first = states[0]

    def proj(prefix: str) -> Projection:
        return Projection(
            traces=Traces(pi=merged[f"{prefix}/traces/pi"],
                          pj=merged[f"{prefix}/traces/pj"],
                          pij=merged[f"{prefix}/traces/pij"],
                          t=merged[f"{prefix}/traces/t"]),
            w=merged[f"{prefix}/w"], b=merged[f"{prefix}/b"],
            mask=merged[f"{prefix}/mask"],
            table=merged.get(f"{prefix}/table"))

    return DeepState(
        projs=tuple(proj(f"projs/{l}") for l in range(len(first.projs))),
        readout=proj("readout"), step=merged["step"],
        generator=_copy_generator(first.generator, first.generator.device))


def states_bitwise_equal(a: DeepState, b: DeepState) -> bool:
    """True iff two states agree leaf-for-leaf, bit-for-bit (dtype and
    content; NaNs compared by bit pattern, not by IEEE semantics — a
    reconciler must treat two identical NaN payloads as 'same state', not
    'diverged')."""
    fa, fb = _named_leaves(a)[1], _named_leaves(b)[1]
    if len(fa) != len(fb):
        return False
    for la, lb in zip(fa, fb):
        if la.dtype != lb.dtype or la.shape != lb.shape:
            return False
        if la.tobytes() != lb.tobytes():
            return False
    return True


def state_divergence(a: DeepState, b: DeepState) -> List[str]:
    """Human-readable description of where two states diverge (empty if
    bit-identical), each leaf named as the JAX report names it."""
    out: List[str] = []
    names, fa = _named_leaves(a)
    fb = _named_leaves(b)[1]
    if len(fa) != len(fb):
        return [f"leaf count differs: {len(fa)} vs {len(fb)}"]
    for name, la, lb in zip(names, fa, fb):
        where = _keystr(name)
        if la.dtype != lb.dtype or la.shape != lb.shape:
            out.append(f"{where}: {la.dtype}{la.shape} vs "
                       f"{lb.dtype}{lb.shape}")
        elif la.tobytes() != lb.tobytes():
            # byte-level count works for every leaf, 0-d scalars included
            ba = np.frombuffer(la.tobytes(), np.uint8)
            bb = np.frombuffer(lb.tobytes(), np.uint8)
            out.append(f"{where}: {int(np.sum(ba != bb))} differing byte(s)")
    return out


def state_finite(state: DeepState) -> bool:
    """Host-side finiteness probe over every float leaf (the reconciler
    must never crown a diverged/NaN replica authoritative)."""
    for leaf in _named_leaves(state)[1]:
        if np.issubdtype(leaf.dtype, np.floating) and \
                not np.all(np.isfinite(leaf)):
            return False
    return True
