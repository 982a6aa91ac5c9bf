"""Meshes for the LM launchers (mirrors ``repro/launch/mesh.py``).

``make_production_mesh`` lays the default process group's ranks out as the
JAX package's production meshes: ``(16, 16)`` on ``("data", "model")`` for
one pod, ``(2, 16, 16)`` on ``("pod", "data", "model")`` for two.  JAX
builds them over 256 or 512 devices that one program drives (the dry run
fakes them on host devices); the port's ranks are processes, one a card,
so a group smaller than a pod names its own layout with ``shape=`` (the
launchers' ``--mesh-shape``), on the same axis names.  Ranks come from
``torchrun`` (``launch/train.py``, ``launch/serve.py``) or from
``distributed/group.py::RankGroup``.  ``make_local_mesh`` is this process
alone.

``fake=True`` builds the production mesh with no ranks behind it: this
process joins a default group of all the mesh's ranks as rank 0 through
torch's ``fake`` backend (``init_fake_group``: every collective returns at
once and moves nothing), and the mesh's CPU ``DeviceMesh`` is made at
once, outside any fake tensor mode (its rank ids are a real tensor).  The dry run (``launch/dryrun.py``) runs a step of the cell on
that mesh under fake tensors, the counterpart of JAX's 512 fake host
devices.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from ..distributed.sharding import Mesh, _world_size, rank_devices

POD_SHAPE = (16, 16)
MULTI_POD_SHAPE = (2, 16, 16)


def init_fake_group(world_size: int) -> None:
    """Make this process rank 0 of a default process group of
    ``world_size`` ranks on torch's ``fake`` backend (no other process,
    no communication).  A fake group of another size is replaced; a real
    group raises."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a fake group cannot replace the process "
                               f"group of backend {dist.get_backend()!r}")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False,
                         shape: Optional[Sequence[int]] = None,
                         fake: bool = False) -> Mesh:
    """The default group's ranks on the production mesh's axes, in rank
    order (row-major over ``shape``): ``shape`` defaults to the JAX mesh's
    (16, 16), or (2, 16, 16) with ``multi_pod``, and must hold exactly the
    group's ranks.  Each host holds ``LOCAL_WORLD_SIZE`` consecutive ranks
    (``torchrun`` exports it; every rank on one host where it is unset), so
    ``distributed/fault.py`` sees the hosts.  With ``fake`` the default
    group is a fake group of the mesh's ranks (``init_fake_group``), and
    the mesh's CPU ``DeviceMesh`` is made here."""
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    shape = tuple(shape) if shape is not None else (
        MULTI_POD_SHAPE if multi_pod else POD_SHAPE)
    if len(shape) != len(axes):
        raise ValueError(f"a {'multi' if multi_pod else 'single'}-pod mesh "
                         f"has axes {axes}; shape {shape} names "
                         f"{len(shape)}")
    if fake:
        init_fake_group(int(np.prod(shape)))
    n = _world_size()
    if int(np.prod(shape)) != n:
        raise ValueError(
            f"the {'multi' if multi_pod else 'single'}-pod mesh {shape} "
            f"holds {int(np.prod(shape))} ranks; the process group has {n} "
            f"(name the layout of these ranks with shape=, --mesh-shape)")
    devices = np.empty(n, dtype=object)
    devices[:] = rank_devices(n, int(os.environ.get("LOCAL_WORLD_SIZE", n)))
    mesh = Mesh(devices.reshape(shape), axes)
    if fake and mesh.size > 1:
        mesh.device_mesh("cpu")
    return mesh


def make_local_mesh() -> Mesh:
    """This process alone: one rank on ("data", "model")."""
    devices = np.empty((1, 1), dtype=object)
    devices[0, 0] = rank_devices(1)[0]
    return Mesh(devices, ("data", "model"))


def parse_mesh_shape(text: Optional[str]) -> Optional[tuple]:
    """``"DxM"`` or ``"PxDxM"`` -> a tuple of ints (None for None)."""
    if text is None:
        return None
    try:
        return tuple(int(v) for v in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh-shape {text!r}: expected DxM or PxDxM, "
                         f"e.g. 2x2") from None
