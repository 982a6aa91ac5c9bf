"""Operations and bytes of the dense BCPNN's work, from its shapes, fp32.

``update_traffic`` is the trace update of one batch as the plain
reference holds its state: p_ij read and written, w written, each byte
once, and the batch's rows and the vectors once.  The FLOPs that
``*_flops`` count are those of the products of a step, 2 per
multiply-add; the ``mfu`` metrics divide them by the TF32 peak.
"""
from __future__ import annotations

from typing import Dict

from . import peaks


def update_traffic(batch: int, n_in: int, n_out: int, n_pre_hc: int,
                   n_post_hc: int) -> Dict[str, float]:
    """One trace update of a dense projection, fp32: FLOPs = 2·B·Ni·Nj
    (x^T y) + 6·Ni·Nj (EMA and the log fold); bytes = 12·Ni·Nj (p_ij in
    and out, w out) + 4·B·(Ni + Nj) (the batch) + 4·(Ni + Nj) (log p_i,
    log p_j) + 4·Hi·Hj (the hypercolumn mask)."""
    flops = 2.0 * batch * n_in * n_out + 6.0 * n_in * n_out
    bytes_ = (12.0 * n_in * n_out + 4.0 * batch * (n_in + n_out)
              + 4.0 * (n_in + n_out) + 4.0 * n_pre_hc * n_post_hc)
    return {"flops": flops, "bytes": bytes_, "intensity": flops / bytes_}


def bound_s(traffic: Dict[str, float]) -> float:
    """The least time the card could take: the larger of the FLOPs at the
    TF32 peak and the bytes at the HBM peak."""
    return max(traffic["flops"] / peaks.PEAK_TF32_FLOP_S,
               traffic["bytes"] / peaks.PEAK_BYTES_S)


def unsupervised_step_flops(rows: int, ni: int, nj: int) -> float:
    """Products of an unsupervised step over ``rows`` genuine rows: the
    support x·w and the trace product x^T y."""
    return 4.0 * rows * ni * nj


def readout_step_flops(rows: int, ni: int, nj: int, n_classes: int) -> float:
    """Products of a readout step: the hidden forward and the readout's
    trace product."""
    return 2.0 * rows * ni * nj + 2.0 * rows * nj * n_classes


def fit_flops(rows: int, epochs: int, ni: int, nj: int,
              n_classes: int) -> float:
    """Products of one fit of a depth-1 network: ``epochs`` unsupervised
    epochs and the supervised pass over ``rows`` genuine rows."""
    return (epochs * unsupervised_step_flops(rows, ni, nj)
            + readout_step_flops(rows, ni, nj, n_classes))
