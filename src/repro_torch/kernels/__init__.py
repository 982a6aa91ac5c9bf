"""Hand-written Hopper kernels for the BCPNN hot spots (+ plain PyTorch
versions).  The CUDA sources live in ``csrc/`` and are built at first use
by ``_build.py``; nothing is compiled at import time."""
from .ops import (bcpnn_fwd, bcpnn_update, fused_forward, fused_learn,
                  hc_softmax)
from .ref import ref_bcpnn_fwd, ref_bcpnn_update, ref_hc_softmax

__all__ = [
    "bcpnn_fwd", "bcpnn_update", "fused_forward", "fused_learn", "hc_softmax",
    "ref_bcpnn_fwd", "ref_bcpnn_update", "ref_hc_softmax",
]
