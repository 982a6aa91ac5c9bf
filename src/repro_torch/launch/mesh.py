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
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from ..distributed.sharding import Mesh, _world_size, rank_devices

POD_SHAPE = (16, 16)
MULTI_POD_SHAPE = (2, 16, 16)


def make_production_mesh(*, multi_pod: bool = False,
                         shape: Optional[Sequence[int]] = None) -> Mesh:
    """The default group's ranks on the production mesh's axes, in rank
    order (row-major over ``shape``): ``shape`` defaults to the JAX mesh's
    (16, 16), or (2, 16, 16) with ``multi_pod``, and must hold exactly the
    group's ranks.  Each host holds ``LOCAL_WORLD_SIZE`` consecutive ranks
    (``torchrun`` exports it; every rank on one host where it is unset), so
    ``distributed/fault.py`` sees the hosts."""
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    shape = tuple(shape) if shape is not None else (
        MULTI_POD_SHAPE if multi_pod else POD_SHAPE)
    if len(shape) != len(axes):
        raise ValueError(f"a {'multi' if multi_pod else 'single'}-pod mesh "
                         f"has axes {axes}; shape {shape} names "
                         f"{len(shape)}")
    n = _world_size()
    if int(np.prod(shape)) != n:
        raise ValueError(
            f"the {'multi' if multi_pod else 'single'}-pod mesh {shape} "
            f"holds {int(np.prod(shape))} ranks; the process group has {n} "
            f"(name the layout of these ranks with shape=, --mesh-shape)")
    devices = np.empty(n, dtype=object)
    devices[:] = rank_devices(n, int(os.environ.get("LOCAL_WORLD_SIZE", n)))
    return Mesh(devices.reshape(shape), axes)


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
