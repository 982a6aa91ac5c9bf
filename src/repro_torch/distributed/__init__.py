"""Fault tolerance of the port (the data-parallel fit waits for ROADMAP.md
queue A item 7)."""
from .fault import StepTimer, WorkerLost

__all__ = ["StepTimer", "WorkerLost"]
