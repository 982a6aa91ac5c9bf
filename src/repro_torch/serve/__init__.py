"""Serving subsystem of the port (mirrors ``repro.serve``): multi-model
microbatched streaming inference, one CUDA graph per (model, bucket) on the
card, and in-deployment online learning, with the typed robustness ladder
(admission control, deadlines, worker supervision, learning-state
quarantine), the deterministic fault-injection harness, and the
fault-tolerant multi-engine router (replica failover, bounded
reroute-on-overload, engine-loss recovery, replica reconciliation;
DESIGN.md §11)."""
from .batching import MicroBatcher, Request, default_buckets, pad_group, pick_bucket
from .engine import BCPNNService, ServeResult, cycle_batch
from .errors import (
    DeadlineExceeded, EngineKilled, FaultInjected, NoHealthyReplica,
    Overloaded, Quarantined, ServeError, WorkerDied,
)
from .faultinject import POINTS, Fault, FaultInjector
from .handle import EngineHandle, LocalEngineHandle
from .loadgen import LoadReport, StreamSpec, run_multi_open_loop, run_open_loop
from .metrics import RouterMetrics, ServeMetrics
from .reconcile import (
    chunk_bounds, merge_replica_states, state_divergence, state_finite,
    states_bitwise_equal,
)
from .router import BCPNNRouter

__all__ = [
    "MicroBatcher", "Request", "default_buckets", "pad_group", "pick_bucket",
    "BCPNNService", "ServeResult", "cycle_batch",
    "ServeError", "Overloaded", "DeadlineExceeded", "WorkerDied",
    "Quarantined", "FaultInjected", "NoHealthyReplica", "EngineKilled",
    "POINTS", "Fault", "FaultInjector",
    "EngineHandle", "LocalEngineHandle", "BCPNNRouter",
    "chunk_bounds", "merge_replica_states", "states_bitwise_equal",
    "state_divergence", "state_finite",
    "LoadReport", "StreamSpec", "run_multi_open_loop", "run_open_loop",
    "ServeMetrics", "RouterMetrics",
]
