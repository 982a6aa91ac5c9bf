"""Meshes for the LM launchers (mirrors ``repro/launch/mesh.py``)."""
from __future__ import annotations

import numpy as np

from ..distributed.sharding import Mesh, rank_devices


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The JAX package's 16x16 (or 2x16x16) pod mesh.  The port's LM path
    trains and serves on one rank so far: a mesh that splits the model axis
    across ranks is ROADMAP.md queue A item 10b-rest."""
    raise NotImplementedError(
        f"the {'multi' if multi_pod else 'single'}-pod production mesh "
        f"splits the LM over a model axis, which the port does not do yet "
        f"(ROADMAP.md queue A item 10b-rest); use the local mesh")


def make_local_mesh() -> Mesh:
    """This process alone: one rank on ("data", "model")."""
    devices = np.empty((1, 1), dtype=object)
    devices[0, 0] = rank_devices(1)[0]
    return Mesh(devices, ("data", "model"))
