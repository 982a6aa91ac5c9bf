"""The LM zoo of the port (mirrors ``repro/models``): ten architectures
through one ``ModelConfig``-driven decoder, serving half (prefill and
decode)."""
from . import attention, common, lm, moe, recurrent

__all__ = ["attention", "common", "lm", "moe", "recurrent"]
