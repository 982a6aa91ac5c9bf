"""Autotuned launch-plan cache consulted by the kernel wrappers (mirrors
``repro/kernels/tuning.py``).

A sweep of launch plans per (kernel, geometry, backend) persists the
winners as a small JSON cache; the CUDA branch of each forward wrapper
consults it when its caller names no plan, so a tuned geometry launches
its measured plan instead of the launcher's rule.  An explicit plan
keyword always wins over the cache, and a CPU tensor never reads it.

Cache format (the JAX package's, DESIGN.md §7):

    {"version": 1,
     "entries": {"<backend>|<kernel>|k1=v1,k2=v2": {"cluster": 2, ...}}}

where the dims are the wrapper's shape-defining integers in sorted-key
order and the backend is the tensor's device type, ``"cuda"`` here (the
JAX package writes its own backend's name), so one file holds both
packages' entries side by side and each reads the other's file.
Location: ``$REPRO_AUTOTUNE_CACHE`` if set, else
``~/.cache/repro_bcpnn/autotune.json``.  Lookups are memoized per file
mtime, so a fresh sweep is picked up without restarting; a missing,
corrupt or other-version file gives the launcher's rule.

The plans (``_KERNEL_PLANS``): the three int8 forwards take ``rows`` (a
block's tile of 64 or 128 rows) and ``cluster`` (the thread-block
cluster splitting the contraction); the three float forwards take
``cluster``.  The updates and ``hc_softmax`` take none: their launchers
have one plan a shape (a fixed tile, and the softmax's sub-warp width
from the segment length).
"""
from __future__ import annotations

import functools
import json
import os
from typing import Dict, Optional

ENV_CACHE = "REPRO_AUTOTUNE_CACHE"
VERSION = 1

# The plan keywords each wrapper accepts: guards against stale entries.
_KERNEL_PLANS = {
    "quant_fwd": ("rows", "cluster"),
    "quant_patchy_forward": ("rows", "cluster"),
    "quant_compact_forward": ("rows", "cluster"),
    "bcpnn_fwd": ("cluster",),
    "patchy_forward": ("cluster",),
    "compact_forward": ("cluster",),
    "bcpnn_update": (),
    "patchy_update": (),
    "compact_update": (),
    "hc_softmax": (),
}
_PLAN_KEYS = ("rows", "cluster")


def cache_path() -> str:
    return os.environ.get(ENV_CACHE) or os.path.join(
        os.path.expanduser("~"), ".cache", "repro_bcpnn", "autotune.json")


def entry_key(kernel: str, backend: str = "cuda", **dims: int) -> str:
    flat = ",".join(f"{k}={dims[k]}" for k in sorted(dims))
    return f"{backend}|{kernel}|{flat}"


@functools.lru_cache(maxsize=8)
def _load(path: str, mtime: float) -> Dict[str, dict]:
    del mtime  # part of the key only: invalidates on rewrite
    try:
        with open(path) as f:
            data = json.load(f)
        if data.get("version") != VERSION:
            return {}
        return dict(data.get("entries", {}))
    except (OSError, ValueError):
        return {}


def load_cache() -> Dict[str, dict]:
    path = cache_path()
    try:
        mtime = os.stat(path).st_mtime
    except OSError:
        return {}
    return _load(path, mtime)


def lookup(kernel: str, backend: str = "cuda", **dims: int) -> Dict[str, int]:
    """Tuned plan keywords for this call site, or {} if untuned."""
    entry = load_cache().get(entry_key(kernel, backend, **dims), {})
    return {k: int(v) for k, v in entry.items() if k in _PLAN_KEYS}


def plan(kernel: str, given: Dict[str, int], **dims: int) -> Dict[str, int]:
    """The plan keywords a CUDA launch of ``kernel`` takes: ``given`` as it
    is if any of them is nonzero (the caller named a plan), else the
    cache's entry for ``dims`` over ``given``'s zeros, keys the kernel does
    not take dropped (0 leaves a keyword to the launcher's rule)."""
    if any(given.values()):
        return given
    allowed = _KERNEL_PLANS[kernel]
    if not allowed:
        return given
    tuned = lookup(kernel, **dims)
    return {**given, **{k: v for k, v in tuned.items() if k in allowed}}


def save_entries(entries: Dict[str, dict], path: Optional[str] = None) -> str:
    """Merge ``entries`` into the cache file (used by a sweep)."""
    path = path or cache_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    merged = {}
    try:
        with open(path) as f:
            data = json.load(f)
        if data.get("version") == VERSION:
            merged.update(data.get("entries", {}))
    except (OSError, ValueError):
        pass
    merged.update(entries)
    with open(path, "w") as f:
        json.dump({"version": VERSION, "entries": merged}, f, indent=2,
                  sort_keys=True)
    return path
