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

LM zoo parameters and decode caches cross in the JAX layout (numpy leaves,
as ``jax.tree.map(np.asarray, tree)`` gives them): the scanned
``blocks/pos{i}_{c}`` leaves carry a leading axis of ``n_blocks`` repeats
when there is more than one, ``tail/tail{i}_{c}`` leaves none.  The port
holds one module (one cache) a layer in execution order, so the
conversion unstacks and restacks; a round trip is bitwise.

Training state is grouped by JAX leaf: ``lm_leaf_groups`` maps each JAX
tree path ("blocks/pos0_g/attn/wq", in the JAX package's flatten order) to
the port tensors that hold it, one a repeat for a stacked leaf.  The
optimizer's moments and the compression error are such groups of fp32
tensors; ``opt_state_{to,from}_numpy`` and ``error_state_{to,from}_numpy``
carry them in the JAX layout (moments stacked as the parameters are,
``step`` int32), bitwise both ways.

Under a sharding context on a split mesh the ``from_numpy`` functions of
the LM zoo place what they make: parameters as ``DTensor``s of this rank's
blocks by the rules (``models.params.distribute_params``), moments and
errors as their parameters are; the ``to_numpy`` functions gather each
DTensor whole (every rank of the mesh calls them together).
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .configs.base import ModelConfig
from .core.bcpnn_layer import InferPack, Projection, ProjSpec, is_patchy
from .core.network import DeepState, InferParams, NetworkSpec, as_spec
from .core.traces import Traces
from .device import DeviceLike, make_generator, resolve_device
from .distributed.sharding import (assign_, current_mesh, distribute_like,
                                   full_value, split_mesh)
from .models.lm import LM, LMCache
from .models.params import distribute_params


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
    """``a`` on ``dev``.  On the CPU it shares a writeable array's memory,
    as ``torch.from_numpy`` does; a read-only one (JAX hands those out, and
    a decode cache is written in place) is copied.  Toward the card,
    ``.to`` makes the copy."""
    a = np.ascontiguousarray(a)
    if dev.type == "cpu" and not a.flags.writeable:
        a = a.copy()
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


# ---------------------------------------------------------------- LM zoo --

def _layer_slots(cfg: ModelConfig) -> List[Tuple[str, str, Optional[int]]]:
    """(group, key, repeat index or None) of each decoder layer of the JAX
    tree, in the port's execution order."""
    n_blocks, n_tail = cfg.pattern_blocks
    pattern = cfg.layer_pattern
    if n_blocks == 0 or (n_blocks > 1 and not cfg.scan_layers):
        raise ValueError(f"{cfg.name}: the JAX tree of {n_blocks} pattern "
                         f"repeats with scan_layers={cfg.scan_layers} does "
                         f"not hold one block a layer")
    stacked = n_blocks > 1
    slots = [("blocks", f"pos{i}_{c}", r if stacked else None)
             for r in range(n_blocks) for i, c in enumerate(pattern)]
    slots += [("tail", f"tail{i}_{pattern[i % len(pattern)]}", None)
              for i in range(n_tail)]
    return slots


def _to_numpy(t: torch.Tensor, bf16_as: str = "ml_dtypes") -> np.ndarray:
    """A copy (decode writes its cache in place).  bf16 goes out as
    ``ml_dtypes.bfloat16`` (the arrays JAX hands to numpy; ``ml_dtypes``
    is imported only here, for a caller that asks for them) or, with
    ``bf16_as="float32"``, widened to float32 exactly, as the checkpoint
    format writes it."""
    t = full_value(t.detach()).cpu()
    if t.dtype == torch.bfloat16:
        if bf16_as == "float32":
            return t.float().numpy()
        import ml_dtypes  # numpy has no bfloat16: move the bits
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16).copy()
    return t.numpy().copy()


def _take(tree: Dict[str, Any], r: Optional[int]) -> Dict[str, Any]:
    """Repeat ``r`` of a stacked subtree (the subtree itself for None)."""
    if r is None:
        return tree
    return {k: _take(v, r) if isinstance(v, dict) else np.asarray(v)[r]
            for k, v in tree.items()}


_PER_LAYER = ("layers", "encoder")  # LM children converted on their own


@torch.no_grad()
def _load_module(module: torch.nn.Module, tree: Dict[str, Any],
                 where: str) -> None:
    """Copy a JAX subtree into ``module``'s parameters, key for key (the
    per-layer lists and the encoder aside); every parameter must be in it,
    at its shape and dtype."""
    own = dict(module.named_parameters(recurse=False))
    children = {n: c for n, c in module.named_children()
                if n not in _PER_LAYER}
    tree = {k: v for k, v in tree.items() if k not in ("blocks", "tail")
            and k not in _PER_LAYER}
    if set(tree) != set(own) | set(children):
        raise ValueError(f"{where}: the tree holds {sorted(tree)}, the port "
                         f"module {sorted(set(own) | set(children))}")
    for key, val in tree.items():
        if key in children:
            _load_module(children[key], val, f"{where}/{key}")
            continue
        t = _pack_tensor(val, own[key].device)
        if t.shape != own[key].shape or t.dtype != own[key].dtype:
            raise ValueError(f"{where}/{key} is {tuple(t.shape)} {t.dtype}, "
                             f"the port wants {tuple(own[key].shape)} "
                             f"{own[key].dtype}")
        assign_(own[key], t)


def lm_params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                         device: DeviceLike = None, train: bool = False) -> LM:
    """The port's ``models.lm.LM`` on ``device`` from a JAX
    ``lm.init_params`` tree of numpy leaves (checked key by key, shape and
    dtype); its parameters require gradients when built to ``train``."""
    dev = resolve_device(device)
    if split_mesh(current_mesh()):
        params = LM(cfg, torch.device("meta"), train=train)
        distribute_params(params, dev)
    else:
        params = LM(cfg, dev, train=train)
    _load_module(params, tree, "params")
    for layer, (group, key, r) in zip(params.layers, _layer_slots(cfg)):
        _load_module(layer, _take(tree[group][key], r), f"{group}/{key}")
    if hasattr(params, "encoder") != ("encoder" in tree):
        raise ValueError(f"{cfg.name}: encoder in the tree "
                         f"{'encoder' in tree}, in the port "
                         f"{hasattr(params, 'encoder')}")
    if hasattr(params, "encoder"):
        enc = tree["encoder"]
        _load_module(params.encoder, enc, "encoder")
        names = sorted(enc["layers"])
        if len(names) != len(params.encoder.layers):
            raise ValueError(f"encoder: {len(names)} layers in the tree, "
                             f"{len(params.encoder.layers)} in the port")
        for layer, name in zip(params.encoder.layers, names):
            _load_module(layer, enc["layers"][name], f"encoder/{name}")
    return params


def lm_params_to_numpy(params: LM, cfg: ModelConfig,
                       bf16_as: str = "ml_dtypes") -> Dict[str, Any]:
    """The JAX ``lm.init_params`` tree of a port ``LM``, numpy leaves (bf16
    as ``ml_dtypes.bfloat16``, or as float32 with ``bf16_as="float32"``,
    which needs no ``ml_dtypes``)."""
    return _layered(_nest({path: stack_leaf(group, bf16_as)
                           for path, group in lm_leaf_groups(params).items()}))


def lm_cache_to_numpy(cache: LMCache, cfg: ModelConfig) -> Dict[str, Any]:
    """The JAX decode-cache tree (``lm.init_cache``/``prefill`` layout) of
    a port ``LMCache``: ``blocks``, ``tail``, ``pos`` (0-d int32) and, for
    enc-dec models, ``enc_out``."""
    return _layered(_nest({path: stack_leaf(g, "ml_dtypes")
                           for path, g in lm_cache_groups(cache,
                                                          cfg).items()}))


def lm_cache_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                        device: DeviceLike = None) -> LMCache:
    """A port ``LMCache`` on ``device`` from a JAX decode-cache tree."""
    dev = resolve_device(device)
    layers = [{k: _pack_tensor(np.asarray(v), dev)
               for k, v in _take(tree[group][key], r).items()}
              for group, key, r in _layer_slots(cfg)]
    enc = tree.get("enc_out")
    return LMCache(layers=layers,
                   pos=_pack_tensor(np.asarray(tree["pos"], np.int32), dev),
                   enc_out=None if enc is None else _pack_tensor(enc, dev))


# ------------------------------------------------------- training state --

class ShapeDtype(NamedTuple):
    """A leaf's shape and torch dtype (``jax.ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


Groups = Dict[str, List[torch.Tensor]]


def _path_order(groups: Dict[str, Any]) -> Dict[str, Any]:
    """``groups`` in the JAX package's flatten order (dict keys sorted at
    every level)."""
    return dict(sorted(groups.items(), key=lambda kv: kv[0].split("/")))


def lm_leaf_groups(params: LM) -> Groups:
    """``{JAX tree path: [tensor, ...]}`` of every parameter of ``params``,
    in the JAX flatten order: one tensor for a leaf the JAX tree holds
    unstacked, one a repeat (in repeat order) for a leaf stacked over the
    scanned repeats.  The JAX leaf's rank is the tensor's plus one exactly
    when its group holds more than one tensor."""
    groups: Groups = {}

    def add(prefix: str, module: torch.nn.Module) -> None:
        for n, p in module.named_parameters(recurse=False):
            groups.setdefault(prefix + n, []).append(p)
        for n, child in module.named_children():
            if n not in _PER_LAYER:
                add(f"{prefix}{n}/", child)

    add("", params)
    for layer, (group, key, _) in zip(params.layers,
                                      _layer_slots(params.cfg)):
        add(f"{group}/{key}/", layer)
    if hasattr(params, "encoder"):
        add("encoder/", params.encoder)
        # JAX applies the encoder layers in sorted-name order (enc0, enc1,
        # enc10, ...), as lm_params_from_numpy loads them
        names = sorted(f"enc{i}" for i in range(len(params.encoder.layers)))
        for name, layer in zip(names, params.encoder.layers):
            add(f"encoder/layers/{name}/", layer)
    return _path_order(groups)


def leaf_spec(group: List[torch.Tensor]) -> ShapeDtype:
    """The shape and dtype of the JAX leaf a group holds."""
    shape = tuple(group[0].shape)
    if len(group) > 1:
        shape = (len(group),) + shape
    return ShapeDtype(shape, group[0].dtype)


def lm_leaf_specs(params: LM) -> Dict[str, ShapeDtype]:
    """``{JAX tree path: ShapeDtype}`` of every parameter leaf of
    ``params`` in the JAX layout (works on the ``meta`` device)."""
    return {path: leaf_spec(g)
            for path, g in lm_leaf_groups(params).items()}


def lm_cache_groups(cache: LMCache, cfg: ModelConfig) -> Groups:
    """``{JAX tree path: [tensor, ...]}`` of a decode cache, grouped as
    ``lm_leaf_groups`` groups parameters (``pos`` and ``enc_out``
    included)."""
    groups: Groups = {}
    for c, (group, key, _) in zip(cache.layers, _layer_slots(cfg)):
        for name, t in c.items():
            groups.setdefault(f"{group}/{key}/{name}", []).append(t)
    groups["pos"] = [cache.pos]
    if cache.enc_out is not None:
        groups["enc_out"] = [cache.enc_out]
    return _path_order(groups)


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    """A nested dict from ``{"a/b/c": leaf}``."""
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        *outer, last = path.split("/")
        node = tree
        for k in outer:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def _layered(tree: Dict[str, Any]) -> Dict[str, Any]:
    """``tree`` with the JAX tree's ``blocks`` and ``tail`` groups, empty
    where no layer is in one."""
    tree.setdefault("blocks", {})
    tree.setdefault("tail", {})
    return tree


def _flat(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def stack_leaf(group: List[torch.Tensor],
               bf16_as: str = "float32") -> np.ndarray:
    """The JAX-layout numpy array of a group, a copy (bf16 per
    ``_to_numpy``'s ``bf16_as``)."""
    if len(group) == 1:
        return _to_numpy(group[0], bf16_as)
    return np.stack([_to_numpy(t, bf16_as) for t in group])


def groups_to_numpy(groups: Groups) -> Dict[str, Any]:
    """The nested JAX-layout tree of fp32 (or integer) groups."""
    return _nest({path: stack_leaf(g, "float32")
                  for path, g in groups.items()})


def groups_from_numpy(tree: Dict[str, Any], like: Groups,
                      dtype: torch.dtype = torch.float32) -> Groups:
    """Groups shaped as ``like`` (on its tensors' devices) from a nested
    JAX-layout tree, every leaf checked against the layout and cast to
    ``dtype`` (the moments and the error are fp32)."""
    flat = _flat(tree)
    if set(flat) != set(like):
        raise ValueError(f"the tree's leaves {sorted(set(flat) ^ set(like))}"
                         f" are on one side only")
    out: Groups = {}
    for path, group in like.items():
        a = np.asarray(flat[path])
        want = leaf_spec(group).shape
        if tuple(a.shape) != want:
            raise ValueError(f"{path} has shape {tuple(a.shape)}, the port "
                             f"wants {want}")
        parts = [a] if len(group) == 1 else list(a)
        out[path] = [distribute_like(
            _pack_tensor(part, t.device).to(dtype).clone(), t)
            for part, t in zip(parts, group)]
    return out


def opt_state_to_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX ``optim.init_opt_state`` tree of a port optimizer state:
    ``mu``, ``nu`` (fp32, stacked as the parameters) and ``step`` (0-d
    int32)."""
    return {"mu": groups_to_numpy(state["mu"]),
            "nu": groups_to_numpy(state["nu"]),
            "step": state["step"].detach().cpu().numpy().astype(np.int32)}


def opt_state_from_numpy(tree: Dict[str, Any], params: LM) -> Dict[str, Any]:
    """A port optimizer state for ``params`` (on its device) from a JAX
    optimizer-state tree."""
    groups = lm_leaf_groups(params)
    dev = next(iter(groups.values()))[0].device
    return {"mu": groups_from_numpy(tree["mu"], groups),
            "nu": groups_from_numpy(tree["nu"], groups),
            "step": torch.tensor(int(np.asarray(tree["step"])),
                                 dtype=torch.int32, device=dev)}


def error_state_to_numpy(err: Groups) -> Dict[str, Any]:
    """The JAX ``optim.init_error_state`` tree of a port error state."""
    return groups_to_numpy(err)


def error_state_from_numpy(tree: Dict[str, Any], params: LM) -> Groups:
    """A port compression-error state for ``params`` from a JAX tree."""
    return groups_from_numpy(tree, lm_leaf_groups(params))
