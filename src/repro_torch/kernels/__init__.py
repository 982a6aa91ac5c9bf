"""Hand-written Hopper kernels for the BCPNN hot spots (+ plain PyTorch
versions).  The CUDA sources live in ``csrc/`` and are built at first use
by ``_build.py``; nothing is compiled at import time."""
from .ops import (bcpnn_fwd, bcpnn_update, compact_forward, compact_update,
                  fused_forward, fused_learn, fused_packed_forward,
                  hc_softmax, patchy_forward, patchy_update,
                  quant_compact_forward, quant_fwd, quant_patchy_forward)
from .quant import (dequantize_compact, dequantize_dense, quantize_acts,
                    quantize_compact, quantize_dense)
from .ref import (ref_bcpnn_fwd, ref_bcpnn_update, ref_compact_forward,
                  ref_compact_update, ref_hc_softmax, ref_patchy_forward,
                  ref_patchy_update, ref_quant_compact_forward,
                  ref_quant_fwd, ref_quant_patchy_forward)

__all__ = [
    "bcpnn_fwd", "bcpnn_update", "compact_forward", "compact_update",
    "fused_forward", "fused_learn", "fused_packed_forward", "hc_softmax",
    "patchy_forward", "patchy_update",
    "quant_compact_forward", "quant_fwd", "quant_patchy_forward",
    "dequantize_compact", "dequantize_dense", "quantize_acts",
    "quantize_compact", "quantize_dense",
    "ref_bcpnn_fwd", "ref_bcpnn_update", "ref_compact_forward",
    "ref_compact_update", "ref_hc_softmax", "ref_patchy_forward",
    "ref_patchy_update", "ref_quant_compact_forward", "ref_quant_fwd",
    "ref_quant_patchy_forward",
]
