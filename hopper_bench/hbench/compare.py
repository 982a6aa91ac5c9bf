"""The numbers that decide ``correct``, and their limits.

A learning step is judged by what it changed.  For each leaf of the state
(traces, clock, weights and bias of both projections) the gap between the
program's change and the reference's, at its largest element, is taken
against the reference's largest change of that leaf:

    max |(P - S) - (R - S)| / max |R - S|

with S the state both started from, P the program's result and R the
reference's.  A step's number is its worst leaf.  A step changes every
leaf of this network, so no leaf is left out.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch


def leaf_gaps(start: Mapping[str, torch.Tensor],
              prog: Mapping[str, torch.Tensor],
              ref: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's relative gap between the program's change and the
    reference's (inf where the program moved a leaf the reference left)."""
    out = {}
    for name, s in start.items():
        s = s.to(torch.float32)
        d_ref = ref[name].to(torch.float32) - s
        d_prog = prog[name].to(s.device, torch.float32) - s
        scale = float(d_ref.abs().max())
        gap = float((d_prog - d_ref).abs().max())
        if not math.isfinite(gap):
            out[name] = math.inf
        elif scale == 0.0:
            out[name] = 0.0 if gap == 0.0 else math.inf
        else:
            out[name] = gap / scale
    return out


def worst(gaps: Mapping[str, float]) -> float:
    return max(gaps.values())


def judge(numbers: Mapping[str, float], limits: Mapping[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number with no limit, or a limit with no number, fails."""
    checks = {}
    ok = set(numbers) == set(limits)
    for name in sorted(set(numbers) | set(limits)):
        value = numbers.get(name, math.nan)
        limit = limits.get(name, math.nan)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, checks
