"""Serving subsystem of the port (mirrors ``repro.serve``): multi-model
microbatched streaming inference, one CUDA graph per (model, bucket) on the
card, and in-deployment online learning, with the typed robustness ladder
(admission control, deadlines, worker supervision, learning-state
quarantine) and the deterministic fault-injection harness.  Not ported
yet: the multi-engine router (``EngineHandle``, ``BCPNNRouter``,
``reconcile``; ROADMAP.md queue A item 6-rest)."""
from .batching import MicroBatcher, Request, default_buckets, pad_group, pick_bucket
from .engine import BCPNNService, ServeResult, cycle_batch
from .errors import (
    DeadlineExceeded, EngineKilled, FaultInjected, NoHealthyReplica,
    Overloaded, Quarantined, ServeError, WorkerDied,
)
from .faultinject import POINTS, Fault, FaultInjector
from .loadgen import LoadReport, StreamSpec, run_multi_open_loop, run_open_loop
from .metrics import RouterMetrics, ServeMetrics

__all__ = [
    "MicroBatcher", "Request", "default_buckets", "pad_group", "pick_bucket",
    "BCPNNService", "ServeResult", "cycle_batch",
    "ServeError", "Overloaded", "DeadlineExceeded", "WorkerDied",
    "Quarantined", "FaultInjected", "NoHealthyReplica", "EngineKilled",
    "POINTS", "Fault", "FaultInjector",
    "LoadReport", "StreamSpec", "run_multi_open_loop", "run_open_loop",
    "ServeMetrics", "RouterMetrics",
]
