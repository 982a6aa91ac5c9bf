"""One-shot dense -> compact-resident checkpoint migration (the port's
counterpart of ``scripts/migrate_ckpt.py``, with its arguments and
refusals).

Rewrites a checkpoint whose patchy-trace projections store dense (Ni, Nj)
joint traces/weights into the compact-resident (Hj, K, Mj) layout
(``ProjSpec.compact``), updating the spec stored in the manifest so servers
and trainers rebuild the compact network from the migrated directory
alone.  Inference over the migrated state equals the dense-resident
patchy path's; silent synapses' held trace values are dropped (under the
compact semantics they are the independence product).

    PYTHONPATH=src python -m repro_torch.checkpoint.migrate \\
        --ckpt runs/model1 --out runs/model1_compact [--step N] \\
        [--device cpu]

The source checkpoint (of either package) must carry its NetworkSpec in
the manifest (``Trainer.save`` writes it).
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Tuple

from ..device import DeviceLike


class MigrationRefused(ValueError):
    """The checkpoint cannot be migrated (the message says why)."""


def _state_bytes(state) -> int:
    from ..core.graphs import state_tensors
    return sum(t.numel() * t.element_size() for t in state_tensors(state))


def migrate_checkpoint(ckpt: str, out: str, step: Optional[int] = None,
                       device: DeviceLike = None) -> Tuple[int, list]:
    """Migrate ``step`` (default: the latest) of ``ckpt`` into ``out``;
    returns ``(step, lines)``, the lines the command prints.  Raises
    ``MigrationRefused`` as the JAX script refuses: no directory, no
    checkpoint, no spec in the manifest, or no dense-resident patchy-trace
    projection to migrate."""
    from ..core.bcpnn_layer import validate_patchy_state
    from ..core.compact import compactify_state
    from ..core.network import init_deep, spec_from_dict
    from .ckpt import CheckpointManager, spec_manifest

    if not os.path.isdir(ckpt):
        raise MigrationRefused(f"checkpoint directory {ckpt!r} does not "
                               f"exist")
    src = CheckpointManager(ckpt)
    step = step if step is not None else src.latest_step()
    if step is None:
        raise MigrationRefused(f"no checkpoints under {ckpt}")
    extra = src.read_extra(step) or {}
    if "spec" not in extra:
        raise MigrationRefused(
            f"step_{step} has no NetworkSpec in its manifest "
            f"(extra['spec']); re-save it with Trainer.save before "
            f"migrating")
    spec = spec_from_dict(extra["spec"])
    eligible = [i for i, p in enumerate(spec.projs)
                if p.patchy_traces and not p.compact
                and p.nact is not None and p.nact < p.pre.H]
    if not eligible:
        raise MigrationRefused(
            "no dense-resident patchy-trace projections to migrate (need "
            "patchy_traces=True, a binding nact, and compact=False)")
    state = src.restore(step, init_deep(spec, 0, device))
    before = _state_bytes(state)
    new_state, new_spec = compactify_state(state, spec)
    for l in eligible:
        validate_patchy_state(new_state.projs[l], new_spec.projs[l],
                              where=f"migrated stack proj {l}")
    after = _state_bytes(new_state)
    CheckpointManager(out).save(
        step, new_state, blocking=True,
        extra={**extra, "spec": spec_manifest(new_spec)})
    lines = []
    for l in eligible:
        p = new_spec.projs[l]
        lines.append(f"proj {l}: (Ni={p.pre.N}, Nj={p.post.N}) dense -> "
                     f"(Hj={p.post.H}, K={p.nact * p.pre.M}, Mj={p.post.M})"
                     f" compact")
    lines.append(f"step_{step} {ckpt} -> {out}; state bytes {before} -> "
                 f"{after} ({100.0 * (before - after) / max(1, before):.1f}%"
                 f" smaller)")
    return step, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", required=True,
                    help="source checkpoint directory (CheckpointManager "
                         "layout, spec in the manifest)")
    ap.add_argument("--out", required=True,
                    help="destination directory for the migrated checkpoint")
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step to migrate (default: latest)")
    ap.add_argument("--device", default="cuda",
                    help="where the state is converted (default: cuda)")
    args = ap.parse_args(argv)
    try:
        _, lines = migrate_checkpoint(args.ckpt, args.out, args.step,
                                      args.device)
    except MigrationRefused as e:
        print(f"migrate: {e}", file=sys.stderr)
        return 2
    for line in lines:
        print(f"migrate: {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
