"""Hand-written Hopper kernels for the BCPNN hot spots (+ plain PyTorch
versions).  The CUDA sources live in ``csrc/`` and are built at first use
by ``_build.py``; nothing is compiled at import time."""
from .ops import (bcpnn_fwd, bcpnn_update, compact_forward, compact_update,
                  fused_forward, fused_learn, hc_softmax, patchy_forward,
                  patchy_update)
from .ref import (ref_bcpnn_fwd, ref_bcpnn_update, ref_compact_forward,
                  ref_compact_update, ref_hc_softmax, ref_patchy_forward,
                  ref_patchy_update)

__all__ = [
    "bcpnn_fwd", "bcpnn_update", "compact_forward", "compact_update",
    "fused_forward", "fused_learn", "hc_softmax", "patchy_forward",
    "patchy_update",
    "ref_bcpnn_fwd", "ref_bcpnn_update", "ref_compact_forward",
    "ref_compact_update", "ref_hc_softmax", "ref_patchy_forward",
    "ref_patchy_update",
]
