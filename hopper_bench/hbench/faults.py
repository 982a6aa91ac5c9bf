"""Faults planted under the timed path, to read what the comparison that
decides ``correct`` gives when the program is wrong in a known way: a
step that returns its state unchanged, half of the batch left out with
the mean taken over the rest, and an answer altered where it is produced.
The CPU tests plant them in small runs; ``calibrate.py --fault`` at a
cell's own size on the card.  A benchmark run plants none."""
from __future__ import annotations

import contextlib
from typing import Iterator

FIT = ("unchanged", "half", "altered")


def _learn_fault(kind: str, orig):
    def fault(proj, spec, x, y, count=None, *, donate=False):
        if kind == "unchanged":
            return proj
        if kind == "half":
            h = x.shape[0] // 2
            return orig(proj, spec, x[:h], y[:h], None, donate=donate)
        new = orig(proj, spec, x, y, count, donate=donate)
        new.traces.pij[0].mul_(1.01)
        return new
    return fault


@contextlib.contextmanager
def planted(kind: str, fault: str) -> Iterator[None]:
    """Plant ``fault`` for traffic of ``kind`` (only "fit" has faults) in
    the program's kernel wrappers, and take it out again on leaving."""
    from repro_torch.kernels import ops
    if kind != "fit" or fault not in FIT:
        raise ValueError(f"no fault {fault!r} for traffic kind {kind!r}")
    orig = ops.fused_learn
    ops.fused_learn = _learn_fault(fault, orig)
    try:
        yield
    finally:
        ops.fused_learn = orig
