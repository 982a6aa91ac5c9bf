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
build the port's ``PartitionSpec`` / ``NamedSharding`` records, and
``placements`` turns a spec into ``torch.distributed.tensor`` (DTensor)
placements on ``Mesh.device_mesh``: DTensor is PyTorch's counterpart of
GSPMD.  ``place`` puts a whole tensor on a mesh (a ``DTensor`` of this
rank's block where an axis longer than 1 splits it; ``checkpoint/ckpt.py``
restores the BCPNN state with it, whose model axis never splits), and
``place_like`` places the LM's inputs.  ``shard`` is the JAX constraint at
the JAX package's call sites in ``models/``: the identity without a
context or on one rank, a DTensor redistribution on a split mesh.

On a split mesh the LM runs on DTensors, but its products (``linear``),
norms, attention and MoE dispatch run on each rank's blocks (``per_rank``,
``local_operand``) under placements chosen here: DTensor's own sharding
propagation picks other layouts in other torch releases (a row-parallel
product's output ``Partial`` here, ``Shard`` there) and refuses some ops
(``searchsorted``; a flatten of a split dimension inside ``einsum``).
The vocab-parallel embedding and loss terms (``embedding``,
``logsumexp_and_gold``) and the block arithmetic (``block_range``,
``block_of``) live here too.
Collectives that DTensor issues on card tensors over gloo go through the
host (``HostStagedCollectives``); ``CollectiveMeter`` counts and times
them.
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
    """``mesh`` and ``rules`` for the code inside.  On a split mesh plain
    tensors that meet DTensors inside (positions, masks, scalars made in
    the step) count as replicated: ``implicit_replication``, the port's
    counterpart of JAX treating a constant as replicated."""
    old = (_CTX["mesh"], _CTX["rules"])
    set_context(mesh, rules)
    try:
        if split_mesh(mesh):
            from torch.distributed.tensor.experimental import (
                implicit_replication)
            with implicit_replication(), _staging(mesh):
                yield
        else:
            yield
    finally:
        _CTX["mesh"], _CTX["rules"] = old


@contextmanager
def _staging(mesh: Mesh):
    """``HostStagedCollectives`` where the mesh's ranks run on cards over
    gloo, nothing otherwise."""
    dist = torch.distributed
    if (torch.cuda.is_available() and _initialized()
            and dist.get_backend(mesh.group) == "gloo"):
        with HostStagedCollectives():
            yield
    else:
        yield


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


def split_mesh(mesh: Optional[Mesh]) -> bool:
    """True when ``mesh`` holds more than one rank (tensors under it are
    ``DTensor``s)."""
    return mesh is not None and mesh.size > 1


def placements(mesh: Mesh, spec: PartitionSpec) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh.device_mesh``: one per
    mesh axis, ``Shard(dim)`` on every axis longer than 1 that splits
    tensor dimension ``dim`` (a tuple entry such as ``("pod", "data")``
    shards its dimension over each of its axes, the mesh's major axis
    first, JAX's major-to-minor order), ``Replicate()`` on the rest."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in mesh.axis_names]
    for dim, ax in enumerate(spec):
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None and mesh.shape[a] > 1:
                out[mesh.axis_names.index(a)] = Shard(dim)
    return tuple(out)


def _low_precision(t: torch.Tensor) -> bool:
    return t.dtype in (torch.bfloat16, torch.float16)


def shard(x: torch.Tensor, *dims: Axis) -> torch.Tensor:
    """The logical sharding constraint of the JAX package's ``shard``:
    ``x`` itself, at once, without a context or on a one-rank mesh.  On a
    split mesh ``x`` is a ``DTensor`` and is redistributed to the
    placements ``dims`` give under the rules (``spec_for``, then
    ``placements``); the rank must match (JAX's assert), and a plain
    tensor that the rules would split raises (one they leave whole is
    returned as it is).  A ``Partial`` sum in a 16-bit dtype (a row-parallel
    product's output) is reduced in fp32 and rounded back once, as XLA
    reduces such partials."""
    mesh = _CTX["mesh"]
    if mesh is None:
        return x
    if len(dims) != x.dim():
        raise AssertionError((dims, tuple(x.shape)))
    if not split_mesh(mesh):
        return x
    from torch.distributed.tensor import DTensor
    want = placements(mesh, spec_for(dims, x.shape))
    if not isinstance(x, DTensor):
        if not any(p.is_shard() for p in want):
            return x  # nothing to split: whole on every rank
        raise TypeError(
            f"shard{tuple(dims)} of a plain {tuple(x.shape)} tensor on "
            f"{mesh!r}: tensors under a split mesh are DTensors (place the "
            f"inputs with distributed.sharding.place)")
    if tuple(x.placements) == want:
        return x
    if _low_precision(x) and any(p.is_partial() for p in x.placements):
        return x.float().redistribute(x.device_mesh, want).to(x.dtype)
    return x.redistribute(x.device_mesh, want)


def placed_as(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """DTensor ``t`` redistributed to ``ref``'s placements (a gradient to
    its parameter's), a ``Partial`` in a 16-bit dtype reduced in fp32 as
    ``shard`` does; a plain ``t`` as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor) or tuple(t.placements) == tuple(
            ref.placements):
        return t
    if _low_precision(t) and any(p.is_partial() for p in t.placements):
        return t.float().redistribute(ref.device_mesh, ref.placements).to(
            t.dtype)
    return t.redistribute(ref.device_mesh, ref.placements)


def settled(t: torch.Tensor) -> torch.Tensor:
    """DTensor ``t`` with its ``Partial`` placements reduced (``Replicate``
    there; a 16-bit sum in fp32, as ``shard`` does), so its local block
    holds final values; any other ``t`` as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor) or not any(p.is_partial()
                                             for p in t.placements):
        return t
    want = tuple(Replicate() if p.is_partial() else p for p in t.placements)
    if _low_precision(t):
        return t.float().redistribute(t.device_mesh, want).to(t.dtype)
    return t.redistribute(t.device_mesh, want)


def per_rank(fn, *ts: torch.Tensor, remap: Optional[Dict[int, Dict[int, int]]]
             = None, keep: Optional[Sequence[int]] = None):
    """``fn`` on each rank's blocks: plain tensors go straight in; when the
    first is a DTensor every DTensor argument goes in as its block under
    the first's placements (a ``Partial`` one reduced; with ``keep``, only
    the splits of dimensions in ``keep``, every other dimension gathered
    whole), and each tensor ``fn`` returns (alone, in a tuple or as dict
    values) comes back a DTensor of those placements; ``remap[i]`` moves
    the split dimensions of tuple output ``i`` whose layout differs
    (``{2: 1}``: what splits dimension 2 of the inputs splits its
    dimension 1).
    Right where ``fn`` works along dimensions no rank splits (a cache's
    sequence, a buffer's slots, the MoE's groups with ``keep=(0,)``): each
    rank's result is then its block of the whole result, and a write into
    a block stays a local write."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(ts[0], DTensor):
        return fn(*ts)
    mesh = ts[0].device_mesh
    # a partial sum is reduced first: fn sees each rank's values
    pl = tuple(Replicate() if p.is_partial() or (
        keep is not None and not (p.is_shard() and p.dim in keep)) else p
        for p in ts[0].placements)
    outs = fn(*((t if tuple(t.placements) == tuple(pl) else
                 t.redistribute(mesh, pl)).to_local()
                if isinstance(t, DTensor) else t for t in ts))

    def wrap(o, moved=None):
        out_pl = [type(p)(moved[p.dim]) if moved and p.is_shard()
                  and p.dim in moved else p for p in pl]
        return DTensor.from_local(o, mesh, out_pl, run_check=False)

    if isinstance(outs, dict):
        return {k: wrap(v) for k, v in outs.items()}
    if isinstance(outs, tuple):
        return tuple(wrap(o, (remap or {}).get(i))
                     for i, o in enumerate(outs))
    return wrap(outs)


def gather_dims(x: torch.Tensor, *dims: int) -> torch.Tensor:
    """DTensor ``x`` with dimensions ``dims`` made whole on every rank
    (their ``Shard`` placements turned ``Replicate``: an all-gather; a
    ``Partial`` sum reduced); a plain ``x`` as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    dims = {d % x.dim() for d in dims}
    want = [Replicate() if (p.is_shard() and p.dim in dims)
            or p.is_partial() else p for p in x.placements]
    if want == list(x.placements):
        return x
    return placed_as(x, _Ref(x.device_mesh, want))


class _Ref:
    """A target of ``placed_as``: a mesh and placements."""

    def __init__(self, device_mesh, placements_):
        self.device_mesh, self.placements = device_mesh, tuple(placements_)


def local_operand(w: torch.Tensor, x: torch.Tensor,
                  dim_map: Optional[Dict[int, int]] = None) -> torch.Tensor:
    """DTensor ``w``'s block that meets DTensor ``x``'s block, as a local
    tensor: on each mesh axis where ``x`` is split along dimension ``d``
    and ``dim_map`` maps ``d`` to a dimension of ``w``, ``w`` is split
    along that dimension; elsewhere ``w`` is whole (gathered: FSDP's
    all-gather of a parameter for its compute).  Its gradient on a rank is
    a partial sum over the axes that split ``x`` along a dimension ``w``
    does not have (the batch), which ``to_local`` is told.  A plain ``w``
    as it is."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(w, DTensor):
        return w
    dim_map = dim_map or {}
    want, grad = [], []
    for p in x.placements:
        d = p.dim % x.dim() if p.is_shard() else None
        if d is not None and d in dim_map:
            want.append(Shard(dim_map[d]))
            grad.append(Shard(dim_map[d]))
        else:
            want.append(Replicate())
            grad.append(Partial() if d is not None else Replicate())
    return placed_as(w, _Ref(w.device_mesh, want)).to_local(
        grad_placements=grad)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for ``x`` (..., K) and a 2-D weight ``w`` (K, N); on a
    split mesh with the placements chosen here, not by DTensor's
    propagation (which differs between torch releases): on every mesh
    axis that splits ``x``'s batch, ``w`` is gathered whole (FSDP) and the
    output keeps the batch split; otherwise a ``w`` split along N
    (tensor-parallel columns) meets a whole ``x`` and the output splits
    along N; a ``w`` split along K (row-parallel) meets ``x`` split along
    K and the output is a ``Partial`` sum, which the caller's ``shard``
    reduces (in fp32 for 16-bit dtypes).  Each local product is one
    matmul; the gradients' partial sums are declared to ``to_local``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(x, DTensor) and not isinstance(w, DTensor):
        return x @ w
    if not (isinstance(x, DTensor) and isinstance(w, DTensor)):
        raise TypeError("linear on a split mesh takes two DTensors")
    nd = x.dim()
    tx, tw, out, gx, gw = [], [], [], [], []
    for a, b in zip(x.placements, w.placements):
        if a.is_shard() and a.dim % nd != nd - 1:  # the batch
            tx.append(a), tw.append(Replicate()), out.append(a)
            gx.append(a), gw.append(Partial())
        elif b.is_shard() and b.dim == 1:  # columns
            tx.append(Replicate()), tw.append(b), out.append(Shard(nd - 1))
            gx.append(Partial()), gw.append(b)
        elif b.is_shard() and b.dim == 0:  # the contraction
            tx.append(Shard(nd - 1)), tw.append(b), out.append(Partial())
            gx.append(Shard(nd - 1)), gw.append(b)
        else:
            for lst in (tx, tw, out, gx, gw):
                lst.append(Replicate())
    mesh = w.device_mesh
    xl = placed_as(x, _Ref(mesh, tx)).to_local(grad_placements=gx)
    wl = placed_as(w, _Ref(mesh, tw)).to_local(grad_placements=gw)
    return DTensor.from_local(xl @ wl, mesh, out, run_check=False)


@torch.no_grad()
def write_(dst: torch.Tensor, src: torch.Tensor, index=None,
           dim: int = 0) -> torch.Tensor:
    """``dst.copy_(src)``, or with ``index`` ``dst.index_copy_(dim, index,
    src)``, in place; for a DTensor ``dst`` on each rank's own block
    (``src`` brought to ``dst``'s placements first; ``dim`` must be one no
    rank splits), so a cache written in place stays a local write."""
    from torch.distributed.tensor import DTensor
    src = src.to(dst.dtype)
    if isinstance(dst, DTensor):
        if any(p.is_shard() and p.dim == dim for p in dst.placements) and (
                index is not None):
            raise ValueError(f"an indexed write along dimension {dim}, "
                             f"which {dst.placements} split")
        src = placed_as(src, dst).to_local()
        dst_l = dst.to_local()
    else:
        dst_l = dst
    if index is None:
        dst_l.copy_(src)
    else:
        dst_l.index_copy_(dim, index, src)
    return dst


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


def _range(size: int, device_mesh, placements_, dim: int
           ) -> Tuple[int, int]:
    """(first index, length) of this rank's block of a dimension of
    ``size`` under ``placements_`` on ``device_mesh``: equal blocks (the
    rules split only what divides), nested in mesh order, the major axis
    first."""
    coords = device_mesh.get_coordinate()
    lo, n = 0, size
    for i, p in enumerate(placements_):
        if p.is_shard() and p.dim == dim:
            n //= device_mesh.size(i)
            lo += coords[i] * n
    return lo, n


def block_range(t: torch.Tensor, dim: int) -> Tuple[int, int]:
    """(first index, length) of this rank's block of DTensor ``t`` along
    ``dim``."""
    return _range(t.shape[dim], t.device_mesh, t.placements, dim)


def block_of(full: torch.Tensor, device_mesh, placements_
             ) -> torch.Tensor:
    """This rank's block of ``full`` under DTensor ``placements_`` on
    ``device_mesh`` (a view), each split dimension cut as ``_range``
    cuts it."""
    local = full
    for dim in sorted({p.dim for p in placements_ if p.is_shard()}):
        lo, n = _range(full.shape[dim], device_mesh, placements_, dim)
        local = local.narrow(dim, lo, n)
    return local


def local_block(t: torch.Tensor) -> torch.Tensor:
    """This rank's block of a DTensor, a plain tensor itself."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def embedding(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``F.embedding(tokens, table)``; on a split mesh (DTensor ``tokens``
    split over the batch, ``table`` rows split over some mesh axes and
    columns over others) vocab-parallel: the columns are gathered, each
    rank looks up the tokens of its batch block that fall in its rows
    (zeros elsewhere), and the result is a ``Partial`` sum over the axes
    that split the rows (one nonzero term an element, so the sum is
    exact).  DTensor's own rule for this layout mis-shapes its mask."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    import torch.nn.functional as F
    if not isinstance(table, DTensor):
        return F.embedding(tokens, table)
    mesh = table.device_mesh
    rows = [i for i, p in enumerate(table.placements)
            if p.is_shard() and p.dim == 0]
    table_p = [p if i in rows else Replicate()
               for i, p in enumerate(table.placements)]
    table = table.redistribute(mesh, table_p)
    # each rank's gradient of its rows holds its own tokens' rows only: a
    # partial sum over the axes that split the tokens
    grad_p = [Partial() if tp.is_shard() else p
              for p, tp in zip(table_p, tokens.placements)]
    local = table.to_local(grad_placements=grad_p)
    lo, n = block_range(table, 0)
    tok = tokens.to_local().long() - lo
    inside = (tok >= 0) & (tok < n)
    out = F.embedding(torch.where(inside, tok, 0), local)
    out = out * inside[..., None].to(out.dtype)
    placements_ = [Partial() if i in rows else p
                   for i, p in enumerate(tokens.placements)]
    return DTensor.from_local(out, mesh, placements_, run_check=False)


def logsumexp_and_gold(logits: torch.Tensor, targets: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logsumexp over the last dimension, the logit at ``targets``) of
    ``logits`` (B, C, V), for this rank's batch rows (plain tensors).  A
    DTensor ``logits`` split over the vocabulary is reduced vocab-parallel:
    each rank takes its block's max, its sum of exponentials and the
    targets that fall in its vocabulary rows, each combined across the
    axes that split the vocabulary (a max, sums), so the whole (B, C, V)
    never forms on one rank; ``targets`` (a DTensor) goes to the logits'
    rows."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(logits, DTensor):
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
        return logz, gold
    mesh = logits.device_mesh
    vocab = {i for i, p in enumerate(logits.placements)
             if p.is_shard() and p.dim == logits.dim() - 1}
    rows = [Replicate() if i in vocab else p
            for i, p in enumerate(logits.placements)]

    def over_vocab(local: torch.Tensor, op: str) -> torch.Tensor:
        parts = [Partial(op) if i in vocab else p
                 for i, p in enumerate(rows)]
        return DTensor.from_local(local, mesh, parts, run_check=False
                                  ).redistribute(mesh, rows).to_local()

    loc = logits.to_local()
    m = over_vocab(loc.detach().amax(-1), "max")
    logz = torch.log(over_vocab(torch.exp(loc - m[..., None]).sum(-1),
                                "sum")) + m
    lo, n = block_range(logits, logits.dim() - 1)
    tgt = targets.redistribute(mesh, rows).to_local().long() - lo
    inside = (tgt >= 0) & (tgt < n)
    picked = torch.gather(loc, -1, torch.where(inside, tgt, 0)[..., None])
    return logz, over_vocab(picked[..., 0] * inside.to(loc.dtype), "sum")


def _own(block: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
    """``block`` (a view of ``full``) as a contiguous tensor of its own
    when it is a proper part, so the full tensor's storage can go."""
    if block.numel() < full.numel():
        return block.clone(memory_format=torch.contiguous_format)
    return block.contiguous()


def distribute_like(full: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``full`` (the same on every rank) placed as ``ref`` is: a DTensor
    of this rank's block on ``ref``'s mesh and placements when ``ref`` is
    one, else ``full`` itself."""
    from torch.distributed.tensor import DTensor
    if not isinstance(ref, DTensor):
        return full
    mesh, pl = ref.device_mesh, ref.placements
    return DTensor.from_local(_own(block_of(full, mesh, pl), full), mesh,
                              pl, run_check=False)


@torch.no_grad()
def assign_(dst: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
    """Write ``full`` (the whole value, the same on every rank) into
    ``dst`` in place: into this rank's block when ``dst`` is a DTensor.
    Returns ``dst``."""
    from torch.distributed.tensor import DTensor
    if isinstance(dst, DTensor):
        local = dst.to_local()
        local.copy_(block_of(full, dst.device_mesh, dst.placements).to(
            device=local.device, dtype=local.dtype))
    else:
        dst.copy_(full)
    return dst


def full_value(t: torch.Tensor) -> torch.Tensor:
    """The whole value of ``t``: a DTensor gathered (collective: every
    rank of its mesh calls it), a plain tensor itself."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def reduce_over_splits(local: torch.Tensor, ref: torch.Tensor,
                       op: str = "sum") -> torch.Tensor:
    """The ``op`` ("sum" or "max") of every rank's ``local`` over the mesh
    axes that split ``ref`` (a DTensor), replicated on each rank: a
    ``Partial`` reduced to one value.  ``local`` itself for a plain
    ``ref``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(ref, DTensor):
        return local
    pl = [Partial(op) if p.is_shard() else Replicate()
          for p in ref.placements]
    if not any(p.is_partial() for p in pl):
        return local
    return DTensor.from_local(local, ref.device_mesh, pl,
                              run_check=False).full_tensor()


def place(full: torch.Tensor, sharding: Optional[NamedSharding]
          ) -> torch.Tensor:
    """``full`` placed by ``sharding`` on this rank: as it is on a one-rank
    mesh, without a sharding, or where no mesh axis longer than 1 splits
    it (whole on every rank); else a ``DTensor`` on ``mesh.device_mesh``
    holding this rank's block (``placements``)."""
    if sharding is None or not split_mesh(sharding.mesh):
        return full
    mesh, spec = sharding.mesh, sharding.spec
    if spec is None or not any(p.is_shard() for p in placements(mesh,
                                                                spec)):
        return full
    return _placed(full, mesh, spec)


def _placed(full: torch.Tensor, mesh: Mesh,
            spec: PartitionSpec) -> torch.Tensor:
    """A DTensor of this rank's block of ``full`` under ``spec``."""
    from torch.distributed.tensor import DTensor
    dmesh, pl = mesh.device_mesh(full.device.type), placements(mesh, spec)
    return DTensor.from_local(_own(block_of(full, dmesh, pl), full), dmesh,
                              pl, run_check=False)


def place_like(full: torch.Tensor, dims: Sequence[Axis]) -> torch.Tensor:
    """``full`` (the same on every rank) placed on the context's split mesh
    as logical ``dims`` say: a DTensor of this rank's block, replicated
    where the rules split nothing (the LM's inputs are DTensors on a split
    mesh); itself without a context or on one rank."""
    mesh = _CTX["mesh"]
    if not split_mesh(mesh):
        return full
    return _placed(full, mesh, spec_for(dims, full.shape))


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


try:  # the dispatch-mode base class (present in every torch the port runs)
    from torch.utils._python_dispatch import TorchDispatchMode as _Mode
except ImportError:  # pragma: no cover
    _Mode = object

_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional")


def _is_collective(func) -> bool:
    """A functional collective (not ``wait_tensor`` or the autograd
    wrapper that share its namespace)."""
    name = func._overloadpacket.__name__
    return func.namespace in _COLLECTIVE_NS and name.startswith(
        ("all_", "reduce_scatter", "broadcast"))


class CollectiveMeter(_Mode):
    """Counts and times the collectives that DTensor issues inside it:
    ``counts`` maps each functional collective's name to its calls,
    ``seconds`` is their host time.  Each collective is waited for at
    once, the card synchronized before and after, so the time is the
    collective's alone; that serializes the step it measures, which is
    why only measured steps run under it.  (DTensor's ``CommDebugMode``
    counts the same ops, but its module tracker leaves global forward
    hooks registered when it exits, which break the next forward.)"""

    def __init__(self):
        super().__init__()
        self.counts: Dict[str, int] = collections.Counter()
        self.seconds = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        import time
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor desugars it into local ops
        if not _is_collective(func):
            return func(*args, **kwargs)
        name = func._overloadpacket.__name__
        flat = [a for a in args if isinstance(a, torch.Tensor)]
        cuda = bool(flat) and flat[0].is_cuda
        if cuda:
            torch.cuda.synchronize(flat[0].device)
        t0 = time.perf_counter()
        out = func(*args, **kwargs)
        out = (torch.ops._c10d_functional.wait_tensor(out)
               if isinstance(out, torch.Tensor) else
               [torch.ops._c10d_functional.wait_tensor(o) for o in out])
        if cuda:
            torch.cuda.synchronize(flat[0].device)
        self.seconds += time.perf_counter() - t0
        self.counts[name] += 1
        return out


class HostStagedCollectives(_Mode):
    """The functional collectives that DTensor issues, on card tensors
    over gloo, run on host copies: the input copied off the card, the same
    collective run on the copy over the same group (gloo's host path), the
    result copied back.  gloo takes card tensors itself for its blocking
    collectives, but on ranks sharing one H100 under torch 2.11 the
    asynchronous all-gather that DTensor issues on a mesh dimension's
    group ends the process (SIGSEGV); staged, it runs.  Only the transfer
    changes: the collective's arithmetic is gloo's either way, and no
    computation of the model leaves the card.  ``sharding_context`` enters
    it for a split mesh on the card whose group runs gloo."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if not _is_collective(func) or not args or not _on_card(args[0]):
            return func(*args, **kwargs)
        wait = torch.ops._c10d_functional.wait_tensor
        dev = _first_tensor(args[0]).device
        host = [a.cpu() if isinstance(a, torch.Tensor) else
                [t.cpu() for t in a] if _on_card(a) else a for a in args]
        out = func(*host, **kwargs)
        if isinstance(out, torch.Tensor):
            return wait(out).to(dev)
        return [wait(o).to(dev) for o in out]


def _first_tensor(a):
    return a if isinstance(a, torch.Tensor) else a[0]


def _on_card(a) -> bool:
    if isinstance(a, torch.Tensor):
        return a.is_cuda
    return (isinstance(a, (list, tuple)) and bool(a)
            and isinstance(a[0], torch.Tensor) and a[0].is_cuda)
