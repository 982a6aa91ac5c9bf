"""Meshes and logical-axis sharding (mirrors ``repro/distributed/sharding.py``).

JAX is single-controller: a ``jax.sharding.Mesh`` lays devices out on named
axes and one program drives them all.  The port runs one process per rank
(``distributed/group.py``), and each rank holds its own ``Mesh``: the ranks
laid out on named axes, each a ``RankDevice`` record carrying
``process_index`` (its host) and ``id`` (its rank in the default process
group), so ``distributed/fault.py`` orders and shrinks meshes as the JAX
functions do; and the ``torch.distributed`` process group behind it
(``group``, None for the default group).

Models annotate tensors with *logical* axis names and the rules bind them
to mesh axes.  ``spec_for``, ``named_sharding`` and ``projection_shardings``
build the port's ``PartitionSpec`` / ``NamedSharding`` records, which
``checkpoint/ckpt.py`` reads to place restored leaves: a leaf split over a
mesh axis longer than 1 becomes a ``torch.distributed.tensor.DTensor``
(``place``).  Nothing of the BCPNN path splits a model axis.  ``shard`` is
the JAX constraint on LM tensors, placed at the JAX package's call sites in
``models/``: a one-rank mesh satisfies it as it stands, and a dimension
split over an axis longer than 1 raises (ROADMAP.md queue A item
10b-rest).
"""
from __future__ import annotations

import collections
import dataclasses
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Axis = Union[str, Tuple[str, ...], None]

_CTX: dict = {"mesh": None, "rules": {}}

# Default logical -> physical bindings, the JAX package's.
DEFAULT_RULES: Dict[str, Axis] = {
    "batch": ("pod", "data"),   # pod axis absent on single-pod meshes
    "seq": None,
    "act_seq": None,
    "embed": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ffn": "model",
    "tp": "model",
    "row_in": "model",
    "row_out": "data",
    "vocab": "model",
    "expert": "model",
    "fsdp": "data",
    "conv": None,
    "state": None,
    "cache_seq": None,
    # BCPNN projections: dense (Ni, Nj) traces and weights split along the
    # pre-synaptic rows, the post axis stays whole (HC softmax and trace
    # EMA local); compact (Hj, K, Mj) leaves and the (Hj, nact) table split
    # along the post-HC axis, each device owning whole post-HCs.
    "proj_pre": "model",
    "proj_post": None,
    "proj_hj": "model",
}


@dataclasses.dataclass(frozen=True)
class RankDevice:
    """One rank as a mesh holds it: ``id`` is its rank in the default
    process group, ``process_index`` the host it runs on (the JAX device
    attributes that ``fault.order_devices_host_major`` sorts by)."""

    id: int
    process_index: int = 0


def rank_devices(n: Optional[int] = None,
                 per_host: Optional[int] = None) -> List[RankDevice]:
    """The ranks 0..n-1 as ``RankDevice`` records, ``per_host`` consecutive
    ranks a host (all on one host by default).  ``n`` defaults to the
    default group's world size, or 1 when ``torch.distributed`` is not
    initialized (this process alone)."""
    if n is None:
        n = _world_size()
    per_host = per_host or n
    return [RankDevice(id=r, process_index=r // per_host) for r in range(n)]


def _initialized() -> bool:
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def _world_size() -> int:
    return torch.distributed.get_world_size() if _initialized() else 1


def _rank() -> int:
    return torch.distributed.get_rank() if _initialized() else 0


class Mesh:
    """Ranks on named axes: the port's ``jax.sharding.Mesh``.

    ``devices`` is an object ndarray of ``RankDevice`` records, one axis per
    name; ``shape`` maps each axis name to its size, as ``mesh.shape[axis]``
    does in JAX; ``group`` is the process group whose ranks the mesh holds
    (None: the default group).  ``axis(name)`` gives this rank's view of one
    axis (its position, the collectives: ``group.DataAxis``), made once per
    mesh, so the collectives of every program on the mesh count into one
    place."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 group=None):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {devices.shape} needs "
                             f"{devices.ndim} axis names, got {axis_names}")
        self.devices = devices
        self.axis_names = axis_names
        self.group = group
        self._axes: dict = {}
        self._device_meshes: dict = {}

    @property
    def shape(self) -> "collections.OrderedDict[str, int]":
        return collections.OrderedDict(zip(self.axis_names,
                                           self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def with_group(self, group) -> "Mesh":
        """The same ranks on the same axes over ``group`` (a group of
        exactly these ranks, e.g. from ``torch.distributed.new_group``)."""
        return Mesh(self.devices, self.axis_names, group)

    def coordinates(self) -> Tuple[int, ...]:
        """This rank's index in ``devices`` (rank 0 of no process group
        when ``torch.distributed`` is not initialized)."""
        rank = _rank()
        for idx, d in np.ndenumerate(self.devices):
            if d.id == rank:
                return idx
        raise ValueError(f"rank {rank} is not in {self!r}")

    def axis(self, name: str):
        """This rank's ``DataAxis`` of axis ``name`` (made at first use)."""
        if name not in self._axes:
            from .group import DataAxis
            self._axes[name] = DataAxis(self, name)
        return self._axes[name]

    def device_mesh(self, device_type: str):
        """The ``torch.distributed.device_mesh.DeviceMesh`` of these ranks
        (made once per device type; making one is collective over the
        default group, so every rank of it calls this together)."""
        if device_type not in self._device_meshes:
            from torch.distributed.device_mesh import DeviceMesh
            ids = np.vectorize(lambda d: d.id, otypes=[np.int64])(
                self.devices)
            self._device_meshes[device_type] = DeviceMesh(
                device_type, torch.from_numpy(ids),
                mesh_dim_names=self.axis_names)
        return self._device_meshes[device_type]

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, ranks "
                f"{[d.id for d in self.devices.flat]})")


class PartitionSpec(tuple):
    """One entry per tensor dimension: the mesh axis (or tuple of axes) it
    is split over, or None (the JAX ``PartitionSpec``)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A ``PartitionSpec`` on a mesh (the JAX ``NamedSharding``)."""

    mesh: Mesh
    spec: PartitionSpec


def set_context(mesh: Optional[Mesh],
                rules: Optional[Dict[str, Axis]] = None):
    _CTX["mesh"] = mesh
    _CTX["rules"] = dict(rules or {})


@contextmanager
def sharding_context(mesh: Optional[Mesh],
                     rules: Optional[Dict[str, Axis]] = None):
    old = (_CTX["mesh"], _CTX["rules"])
    set_context(mesh, rules)
    try:
        yield
    finally:
        _CTX["mesh"], _CTX["rules"] = old


def make_rules(mesh: Mesh,
               overrides: Optional[Dict[str, Axis]] = None
               ) -> Dict[str, Axis]:
    """Resolve DEFAULT_RULES against the mesh's actual axis names."""
    names = set(mesh.axis_names)
    rules: Dict[str, Axis] = {}
    for k, v in {**DEFAULT_RULES, **(overrides or {})}.items():
        if isinstance(v, tuple):
            kept = tuple(a for a in v if a in names)
            rules[k] = kept if kept else None
        else:
            rules[k] = v if (v is None or v in names) else None
    return rules


def _axis_size(mesh: Mesh, axis: Axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axis]


def spec_for(dims: Sequence[Axis],
             shape: Sequence[int]) -> Optional[PartitionSpec]:
    """Build a PartitionSpec, dropping axes that don't divide the dim (a
    tuple of one axis is that axis, as JAX's ``PartitionSpec`` writes
    it)."""
    mesh = _CTX["mesh"]
    if mesh is None:
        return None
    rules = _CTX["rules"]
    parts = []
    for logical, size in zip(dims, shape):
        phys = rules.get(logical) if isinstance(logical, str) else None
        if phys is not None and size % _axis_size(mesh, phys) != 0:
            phys = None
        if isinstance(phys, tuple) and len(phys) == 1:
            phys = phys[0]
        parts.append(phys)
    return P(*parts)


def shard(x: torch.Tensor, *dims: Axis) -> torch.Tensor:
    """The logical sharding constraint of the JAX package's ``shard``:
    ``x`` itself, at once, without a context.  Under one the rank must
    match (JAX's assert), and ``x`` is returned where every mesh axis that
    ``dims`` bind has size 1.  A dimension that would be split over an axis
    longer than 1 raises: splitting LM tensors across ranks is ROADMAP.md
    queue A item 10b-rest."""
    mesh = _CTX["mesh"]
    if mesh is None:
        return x
    if len(dims) != x.dim():
        raise AssertionError((dims, tuple(x.shape)))
    spec = spec_for(dims, x.shape)
    split = [(d, ax) for d, ax in zip(dims, spec)
             if ax is not None and _axis_size(mesh, ax) > 1]
    if split:
        raise NotImplementedError(
            f"shard{tuple(dims)} of a {tuple(x.shape)} tensor splits "
            f"{', '.join(f'{d!r} over {ax!r}' for d, ax in split)} on "
            f"{mesh!r}: LM tensors split across ranks are ROADMAP.md queue A "
            f"item 10b-rest")
    return x


def named_sharding(dims: Sequence[Axis],
                   shape: Sequence[int]) -> Optional[NamedSharding]:
    mesh = _CTX["mesh"]
    if mesh is None:
        return None
    return NamedSharding(mesh, spec_for(dims, shape))


def _is_integer(x) -> bool:
    if isinstance(x, torch.Tensor):
        return not (x.dtype.is_floating_point or x.dtype.is_complex)
    return bool(np.issubdtype(np.asarray(x).dtype, np.integer))


def projection_shardings(state) -> Optional[Dict[str, NamedSharding]]:
    """NamedShardings of a port ``DeepState``'s leaves, keyed by checkpoint
    leaf name in the order ``checkpoint/ckpt.py`` writes them (the JAX
    pytree order): dense 2-D leaves (w, pij, the HC mask) split along the
    pre-synaptic axis ("proj_pre"); compact 3-D (Hj, K, Mj) leaves and the
    integer (Hj, nact) table along the post-HC axis ("proj_hj"); vectors,
    scalars and the key replicate.  Feed it to
    ``CheckpointManager.restore(shardings=...)``.  None outside a sharding
    context."""
    mesh = _CTX["mesh"]
    if mesh is None:
        return None
    from ..checkpoint.ckpt import _flatten_with_names

    def leaf_sharding(x) -> NamedSharding:
        ndim = len(x.shape)
        if ndim == 3:
            return named_sharding(("proj_hj", None, None), x.shape)
        if ndim == 2:
            if _is_integer(x):
                return named_sharding(("proj_hj", None), x.shape)
            return named_sharding(("proj_pre", "proj_post"), x.shape)
        return NamedSharding(mesh, P())

    names, leaves = _flatten_with_names(state)
    return {n: leaf_sharding(x) for n, x in zip(names, leaves)}


def place(full: torch.Tensor, sharding: Optional[NamedSharding]
          ) -> torch.Tensor:
    """``full`` placed by ``sharding`` on this rank: as it is when no
    dimension is split over a mesh axis longer than 1 (replicated), else a
    ``DTensor`` of this rank's block, ``Shard(dim)`` on each splitting
    axis.  Splits over several axes at once (tuple entries) are the LM
    zoo's and raise (ROADMAP.md queue A item 10b-rest)."""
    if sharding is None:
        return full
    mesh, spec = sharding.mesh, sharding.spec
    split = [(dim, ax) for dim, ax in enumerate(spec)
             if ax is not None and _axis_size(mesh, ax) > 1]
    if not split:
        return full
    if any(isinstance(ax, tuple) for _, ax in split):
        raise NotImplementedError(
            f"placing a leaf split over several mesh axes at once ({spec}) "
            f"belongs to the LM zoo (ROADMAP.md queue A item 10b-rest)")
    from torch.distributed.tensor import DTensor, Replicate, Shard
    coords = mesh.coordinates()
    placements = [Replicate() for _ in mesh.axis_names]
    local = full
    for dim, ax in split:
        i = mesh.axis_names.index(ax)
        placements[i] = Shard(dim)
        local = torch.tensor_split(local, mesh.shape[ax], dim)[coords[i]]
    return DTensor.from_local(local.contiguous(),
                              mesh.device_mesh(full.device.type),
                              placements, run_check=False)


def current_mesh() -> Optional[Mesh]:
    return _CTX["mesh"]


def data_shards() -> int:
    """Number of data-parallel shards (the product of the pod and data
    axes of the context's mesh; 1 without one)."""
    mesh = _CTX["mesh"]
    if mesh is None:
        return 1
    n = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            n *= mesh.shape[a]
    return n
