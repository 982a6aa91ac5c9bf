"""EngineHandle — the process-boundary-shaped seam between the router
and its engines (mirrors ``repro/serve/handle.py``).

``BCPNNRouter`` never touches a ``BCPNNService`` directly; it talks to
``EngineHandle``s.  The interface is deliberately shaped like an RPC
surface so a multiprocess/multihost transport can slot in later without
touching the router:

* every argument and return value is data — numpy arrays, plain
  scalars, ``DeepState``s (what a checkpoint codec would serialize),
  never futures or engine-internal objects;
* requests are identified by plain integer ids scoped to the engine;
* liveness is an explicit probe (``alive``), not an exception side
  channel — a remote handle would back it with a heartbeat;
* state reads for reconciliation go through ``model_state_sync`` (a
  fold-boundary-consistent snapshot), because "read the live object"
  does not exist across a process boundary.

``LocalEngineHandle`` is the in-process implementation: a thin
delegation wrapper over one ``BCPNNService``.  It adds no behavior —
which is the point: everything the router needs must already be
expressible through this surface.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from .engine import BCPNNService


class EngineHandle:
    """Abstract router-facing engine surface (see module docstring).

    Implementations must guarantee: ``submit`` either returns an
    engine-scoped request id or raises a typed admission error
    (``Overloaded``/``WorkerDied``); ``result`` resolves every admitted
    id exactly once (success or typed error, never a hang on a dead
    engine); ``kill`` is abrupt (pending futures complete
    ``WorkerDied``)."""

    name: str

    # -- placement / lifecycle
    def models(self) -> Tuple[str, ...]:
        raise NotImplementedError

    def add_model(self, model: str, state: Any, spec: Any,
                  weight: float = 1.0, live: bool = False) -> None:
        raise NotImplementedError

    def start(self, warmup: bool = True) -> None:
        raise NotImplementedError

    def stop(self, timeout_s: float = 60.0) -> None:
        raise NotImplementedError

    def kill(self, reason: str = "killed") -> None:
        raise NotImplementedError

    def alive(self) -> bool:
        raise NotImplementedError

    # -- data plane
    def submit(self, x: np.ndarray, model: str,
               deadline_t: Optional[float] = None) -> int:
        raise NotImplementedError

    def result(self, request_id: int, timeout: Optional[float] = None) -> Any:
        raise NotImplementedError

    def feedback(self, x: np.ndarray, label: int, model: str) -> None:
        raise NotImplementedError

    # -- telemetry / control plane
    def queue_depth(self, model: Optional[str] = None) -> int:
        raise NotImplementedError

    def feedback_depth(self, model: Optional[str] = None) -> int:
        raise NotImplementedError

    def quarantined(self, model: str) -> bool:
        raise NotImplementedError

    def snapshot(self, model: Optional[str] = None) -> Dict[str, Any]:
        raise NotImplementedError

    def model_state_sync(self, model: str, timeout_s: float = 60.0) -> Any:
        raise NotImplementedError

    def model_spec(self, model: str) -> Any:
        raise NotImplementedError

    def set_model_state(self, model: str, state: Any,
                        timeout_s: float = 60.0) -> None:
        raise NotImplementedError

    def revalidate(self) -> None:
        raise NotImplementedError


class LocalEngineHandle(EngineHandle):
    """In-process ``EngineHandle`` over one ``BCPNNService``."""

    def __init__(self, service: BCPNNService, name: Optional[str] = None):
        self.service = service
        self.name = name if name is not None else f"engine@{id(service):x}"

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"LocalEngineHandle({self.name!r})"

    # -- placement / lifecycle
    def models(self) -> Tuple[str, ...]:
        return self.service.models()

    def add_model(self, model: str, state: Any, spec: Any,
                  weight: float = 1.0, live: bool = False) -> None:
        self.service.add_model(model, state, spec, weight=weight, live=live)

    def start(self, warmup: bool = True) -> None:
        self.service.start(warmup=warmup)

    def stop(self, timeout_s: float = 60.0) -> None:
        self.service.stop(timeout_s=timeout_s)

    def kill(self, reason: str = "killed") -> None:
        self.service.kill(reason)

    def alive(self) -> bool:
        return self.service.alive()

    # -- data plane
    def submit(self, x: np.ndarray, model: str,
               deadline_t: Optional[float] = None) -> int:
        return self.service.submit(x, model=model, deadline_t=deadline_t)

    def result(self, request_id: int, timeout: Optional[float] = None) -> Any:
        return self.service.result(request_id, timeout=timeout)

    def feedback(self, x: np.ndarray, label: int, model: str) -> None:
        self.service.feedback(x, label, model=model)

    # -- telemetry / control plane
    def queue_depth(self, model: Optional[str] = None) -> int:
        return self.service.queue_depth(model)

    def feedback_depth(self, model: Optional[str] = None) -> int:
        return self.service.feedback_depth(model)

    def quarantined(self, model: str) -> bool:
        return self.service.quarantined(model)

    def snapshot(self, model: Optional[str] = None) -> Dict[str, Any]:
        return self.service.snapshot(model=model)

    def model_state_sync(self, model: str, timeout_s: float = 60.0) -> Any:
        return self.service.model_state_sync(model, timeout_s=timeout_s)

    def model_spec(self, model: str) -> Any:
        return self.service.model_spec(model)

    def set_model_state(self, model: str, state: Any,
                        timeout_s: float = 60.0) -> None:
        self.service.set_model_state(model, state, timeout_s=timeout_s)

    def revalidate(self) -> None:
        self.service.revalidate()
