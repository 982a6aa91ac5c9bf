"""The optimizer of LM trunk training (mirrors ``repro.optim``): AdamW with
the JAX package's arithmetic, and int8 gradient compression with error
feedback, as plain functions on tensors grouped by JAX leaf."""
from .adamw import (AdamWConfig, apply_updates, global_norm, init_opt_state,
                    schedule)
from .compression import (compress_grads, dequantize, init_error_state,
                          quantize)

__all__ = ["AdamWConfig", "apply_updates", "global_norm", "init_opt_state",
           "schedule", "compress_grads", "dequantize", "init_error_state",
           "quantize"]
