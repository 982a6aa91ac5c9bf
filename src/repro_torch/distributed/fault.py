"""Fault-tolerance utilities (mirrors ``repro/distributed/fault.py``):
the worker-loss signal, the straggler detector and elastic meshes.

Straggler mitigation is observability first: per-step wall times are
tracked online (median + MAD), and outlier steps are attributed and
logged so a scheduler can drain or replace slow hosts.  Elastic restart is
a mesh rebuilt from the ranks that remain (``elastic_mesh``) and a fit
resumed from its checkpoint cursor on it (``core/trainer.py``); in the
port the survivors form a new process group (``distributed/group.py``),
over which the rebuilt mesh runs.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from .sharding import Mesh, rank_devices


class WorkerLost(RuntimeError):
    """A data-parallel worker (rank or host) dropped out of the mesh.

    Raised by fault-injection hooks (``Trainer.fit(on_chunk=...)``) and by
    real loss detectors; the recovery ladder is: rebuild the largest
    fitting mesh with ``elastic_mesh`` from the survivors, restore the
    latest checkpoint, and resume the fit from its stored cursor."""


@dataclasses.dataclass
class StepTimer:
    """Online step-time tracker with robust outlier detection.

    ``_times`` is trimmed to the last ``window`` entries on every
    ``stop``, so the tracker is O(window) memory however long the serving
    engine or fit runs; ``median`` is the median of that window, the
    statistic the outlier test uses."""

    window: int = 50
    threshold: float = 3.0  # MADs above median = straggler event
    _times: List[float] = dataclasses.field(default_factory=list)
    _t0: Optional[float] = None
    events: List[dict] = dataclasses.field(default_factory=list)

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, step: int, tag: Optional[str] = None) -> float:
        """Close the started window; ``tag`` attributes the step to an
        owner (the serving engine passes the model name).  A ``stop()``
        with no open window is a caller bug and raises."""
        if self._t0 is None:
            raise RuntimeError(
                f"StepTimer.stop(step={step}, tag={tag!r}) called without "
                f"a prior start() — every timed window must be opened "
                f"with start() before it is closed")
        dt = time.perf_counter() - self._t0
        self._t0 = None
        hist = self._times  # already at most `window` entries
        if len(hist) >= 8:
            med = float(np.median(hist))
            mad = float(np.median(np.abs(np.asarray(hist) - med))) + 1e-9
            if dt > med + self.threshold * 1.4826 * mad:
                ev = {"step": step, "time": dt, "median": med}
                if tag is not None:
                    ev["tag"] = tag
                self.events.append(ev)
        self._times.append(dt)
        if len(self._times) > self.window:
            del self._times[: -self.window]
        return dt

    @property
    def median(self) -> float:
        """Median over the retained window (the last ``window`` steps)."""
        return float(np.median(self._times)) if self._times else 0.0


def order_devices_host_major(devices) -> list:
    """Stable host-major device order: group by ``process_index``, then by
    device id within a host.  A mesh built over this order keeps each
    host's ranks contiguous along the leading (data) axis, so losing a
    host removes WHOLE data-axis rows."""
    return sorted(devices, key=lambda d: (getattr(d, "process_index", 0),
                                          getattr(d, "id", 0)))


def fit_mesh_shape(preferred_shape, n_devices: int) -> list:
    """Shrink the data axis (axis 0) of ``preferred_shape`` until the mesh
    fits ``n_devices``; raises when even a single data row does not."""
    shape = list(preferred_shape)
    total = int(np.prod(shape))
    while total > n_devices and shape[0] > 1:
        shape[0] -= 1
        total = int(np.prod(shape))
    if total > n_devices:
        raise RuntimeError(
            f"cannot build mesh {tuple(preferred_shape)} from "
            f"{n_devices} devices")
    return shape


def elastic_mesh(preferred_shape, axis_names, devices=None) -> Mesh:
    """Build the largest mesh of ``preferred_shape``'s aspect that fits the
    available ranks (drop data-parallel rows for lost hosts).  ``devices``
    defaults to every rank of the default process group
    (``sharding.rank_devices``; this process alone without one).  Devices
    are ordered host-major before the prefix is taken, so a shrink drops
    whole trailing hosts.  The mesh runs over the default group; a mesh of
    fewer ranks than the group needs a group of its own
    (``Mesh.with_group``)."""
    devices = order_devices_host_major(
        list(devices if devices is not None else rank_devices()))
    shape = fit_mesh_shape(preferred_shape, len(devices))
    total = int(np.prod(shape))
    use = np.empty(total, dtype=object)
    use[:] = devices[:total]
    return Mesh(use.reshape(shape), axis_names)


def describe_failure_domains(mesh: Mesh) -> dict:
    """Summarize how mesh axes map to failure domains (host/pod)."""
    hosts: dict = {}
    for d in mesh.devices.flat:
        hosts.setdefault(getattr(d, "process_index", 0), []).append(d.id)
    return {"n_devices": mesh.devices.size, "n_hosts": len(hosts),
            "axis_names": list(mesh.axis_names),
            "axis_sizes": list(mesh.devices.shape)}
