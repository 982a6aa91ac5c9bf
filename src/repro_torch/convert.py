"""Carry a network's state between the JAX package and the port as plain
numpy arrays.

The tree is a nested dict that mirrors the JAX ``DeepState`` fields::

    {"projs": [proj, ...], "readout": proj, "step": int}
    proj = {"traces": {"pi", "pj", "pij", "t"}, "w", "b", "mask", "table"}

(``table`` is None for the dense layout; compact-resident projections carry
``pij``/``w`` as (Hj, K, Mj) and ``table`` as (Hj, nact) int32).  The JAX
PRNG key is not carried over: the port's generator is seeded instead, so
noisy unsupervised steps draw other numbers than JAX would.

Serving packs (the JAX ``InferParams``) cross the same way::

    {"projs": [pack, ...], "readout": pack}
    pack = {"w", "b", "scale", "table"}

with ``w``/``b`` in the serving dtype (float32; bfloat16 as the
``ml_dtypes`` arrays JAX hands to numpy; int8 codes with float32 ``b``),
``scale`` (Hj,) float32 for int8 packs and ``table`` (Hj, nact) int32 for
patchy ones, else None.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .core.bcpnn_layer import InferPack, Projection, ProjSpec, is_patchy
from .core.network import DeepState, InferParams, NetworkSpec, as_spec
from .core.traces import Traces
from .device import DeviceLike, make_generator, resolve_device


def _projection_from_numpy(d: Dict[str, Any], dev: torch.device) -> Projection:
    def f32(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    tr = d["traces"]
    t = int(tr["t"])
    table = d.get("table")
    return Projection(
        traces=Traces(pi=f32(tr["pi"]), pj=f32(tr["pj"]), pij=f32(tr["pij"]),
                      t=torch.tensor(t, dtype=torch.int32, device=dev),
                      t_host=t),
        w=f32(d["w"]), b=f32(d["b"]), mask=f32(d["mask"]),
        table=None if table is None else torch.from_numpy(
            np.array(table, dtype=np.int32)).to(dev))


def state_from_numpy(tree: Dict[str, Any], spec_or_cfg,
                     device: DeviceLike = None, seed: int = 0) -> DeepState:
    """Build a port ``DeepState`` on ``device`` from a numpy tree, checking
    every array's shape against ``spec_or_cfg``."""
    spec: NetworkSpec = as_spec(spec_or_cfg)
    dev = resolve_device(device)
    if len(tree["projs"]) != spec.depth:
        raise ValueError(f"tree has {len(tree['projs'])} stack projections, "
                         f"spec has {spec.depth}")
    state = DeepState(
        projs=tuple(_projection_from_numpy(p, dev) for p in tree["projs"]),
        readout=_projection_from_numpy(tree["readout"], dev),
        step=torch.tensor(int(tree["step"]), dtype=torch.int32, device=dev),
        generator=make_generator(seed, dev),
    )
    for where, proj, ps in zip(
            [f"projs[{l}]" for l in range(spec.depth)] + ["readout"],
            state.projs + (state.readout,), spec.projs + (spec.readout,)):
        if ps.compact:
            k = ps.nact * ps.pre.M
            weights = (ps.post.H, k, ps.post.M)
            table = (ps.post.H, ps.nact)
        else:
            weights, table = (ps.pre.N, ps.post.N), None
        want = {"pi": (ps.pre.N,), "pj": (ps.post.N,), "pij": weights,
                "w": weights, "b": (ps.post.N,),
                "mask": (ps.pre.H, ps.post.H), "table": table}
        got = {"pi": proj.traces.pi, "pj": proj.traces.pj,
               "pij": proj.traces.pij, "w": proj.w, "b": proj.b,
               "mask": proj.mask, "table": proj.table}
        for name, shape in want.items():
            have = None if got[name] is None else tuple(got[name].shape)
            if have != shape:
                raise ValueError(f"{where}.{name} has shape {have}, spec "
                                 f"wants {shape}")
    return state


def _projection_to_numpy(p: Projection) -> Dict[str, Any]:
    def arr(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy()

    return {
        "traces": {"pi": arr(p.traces.pi), "pj": arr(p.traces.pj),
                   "pij": arr(p.traces.pij), "t": int(p.traces.t)},
        "w": arr(p.w), "b": arr(p.b), "mask": arr(p.mask),
        "table": None if p.table is None else arr(p.table),
    }


def state_to_numpy(state: DeepState) -> Dict[str, Any]:
    """The numpy tree of a port ``DeepState`` (inverse of
    ``state_from_numpy``, generator aside)."""
    return {
        "projs": [_projection_to_numpy(p) for p in state.projs],
        "readout": _projection_to_numpy(state.readout),
        "step": int(state.step),
    }


# infer_dtype -> numpy dtype name of a pack's weights
_PACK_DTYPES = {"fp32": "float32", "bf16": "bfloat16", "int8": "int8"}


def _pack_tensor(a, dev: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":  # numpy has no bfloat16: move the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def _pack_from_numpy(d: Dict[str, Any], ps: ProjSpec, dev: torch.device,
                     where: str) -> InferPack:
    name = _PACK_DTYPES[ps.infer_dtype]
    if ps.compact:
        weights = (ps.post.H, ps.nact * ps.pre.M, ps.post.M)
    else:
        weights = (ps.pre.N, ps.post.N)
    want = {"w": (weights, name),
            "b": ((ps.post.N,), "float32" if name == "int8" else name),
            "scale": (((ps.post.H,), "float32")
                      if ps.infer_dtype == "int8" else None),
            "table": (((ps.post.H, ps.nact), "int32")
                      if is_patchy(ps) else None)}
    got = {}
    for key, spec in want.items():
        a = d.get(key)
        have = None if a is None else (tuple(np.shape(a)),
                                       np.asarray(a).dtype.name)
        if have != spec:
            raise ValueError(f"{where}.{key} is {have}, a {ps.infer_dtype} "
                             f"pack of this spec needs {spec}")
        got[key] = None if a is None else _pack_tensor(a, dev)
    # The JAX package's pack_projection built this pack at a fold boundary:
    # repro: suppress[infer-pack-mutation] — only its arrays move here
    return InferPack(**got)


def params_from_numpy(tree: Dict[str, Any], spec_or_cfg,
                      device: DeviceLike = None) -> InferParams:
    """Build the port's ``InferParams`` on ``device`` from a numpy tree of
    serving packs (a JAX ``pack_state`` result), checking every array's
    shape and dtype against ``spec_or_cfg`` and its ``infer_dtype``s."""
    spec: NetworkSpec = as_spec(spec_or_cfg)
    dev = resolve_device(device)
    if len(tree["projs"]) != spec.depth:
        raise ValueError(f"tree has {len(tree['projs'])} stack packs, spec "
                         f"has {spec.depth}")
    return InferParams(
        projs=tuple(_pack_from_numpy(p, ps, dev, f"projs[{l}]")
                    for l, (p, ps) in enumerate(zip(tree["projs"],
                                                    spec.projs))),
        readout=_pack_from_numpy(tree["readout"], spec.readout, dev,
                                 "readout"))
