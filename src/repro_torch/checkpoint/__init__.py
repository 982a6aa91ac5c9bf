"""Checkpoints in the JAX package's on-disk format (``ckpt.py``) and the
dense -> compact migration (``migrate.py``)."""
from .ckpt import CheckpointManager, load_model, load_models, spec_manifest

__all__ = ["CheckpointManager", "load_model", "load_models", "spec_manifest"]
