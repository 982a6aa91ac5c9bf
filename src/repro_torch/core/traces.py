"""Exponential probability traces — the memory of a BCPNN projection
(mirrors ``repro/core/traces.py``).

Three traces are kept per projection: the marginal activation
probabilities of the pre-synaptic units (p_i), of the post-synaptic units
(p_j), and their joint probability (p_ij), all exponential moving averages
of batch-mean rates.  Learning state is fp32 throughout: the increments
``a·x`` are too small for narrower types.

The JAX module pins its statistics with ``optimization_barrier`` so two
XLA programs round alike; PyTorch runs eagerly, so there is no
counterpart.

The clock ``t`` lives on the device, where the smoothing and the noise
anneal read it.  ``t_host`` mirrors it as a Python int, advanced wherever
``t`` advances, so the host can take decisions on the clock (the rewire
period of structural plasticity) without reading the card back.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass
class Traces:
    """Probability traces of one projection (pre: Ni units, post: Nj units)."""

    pi: torch.Tensor   # (Ni,)  pre-synaptic marginal
    pj: torch.Tensor   # (Nj,)  post-synaptic marginal
    pij: torch.Tensor  # (Ni, Nj) joint, or (Hj, K, Mj) compact-resident
    t: torch.Tensor    # 0-d int32 update counter (for bias correction)
    t_host: Optional[int] = None  # host mirror of ``t``

    def __post_init__(self):
        if self.t_host is None:
            if self.t.device.type != "cpu":
                raise ValueError(
                    "Traces on the card need t_host, the host mirror of the "
                    "clock t: reading t back would stall every step")
            self.t_host = int(self.t)


def init_traces(ni: int, nj: int, mi: int, mj: int,
                generator: Optional[torch.Generator] = None,
                init_noise: float = 0.1,
                device: Optional[torch.device] = None) -> Traces:
    """Uniform-prior initialization: every MC equally likely within its HC,
    with a small multiplicative log-normal perturbation of the joint trace
    drawn from ``generator`` (which fixes the device when given).  Without
    it the network is perfectly symmetric and unsupervised learning can
    never differentiate the minicolumns."""
    if generator is not None:
        device = generator.device
    f32 = torch.float32
    pi0 = 1.0 / mi
    pj0 = 1.0 / mj
    pij = torch.full((ni, nj), pi0 * pj0, dtype=f32, device=device)
    if generator is not None and init_noise > 0:
        noise = torch.randn((ni, nj), generator=generator, dtype=f32,
                            device=device)
        pij = pij * torch.exp(init_noise * noise)
    return Traces(
        pi=torch.full((ni,), pi0, dtype=f32, device=device),
        pj=torch.full((nj,), pj0, dtype=f32, device=device),
        pij=pij,
        t=torch.zeros((), dtype=torch.int32, device=device),
        t_host=0,
    )


def smoothing(tr: Traces, alpha: float) -> torch.Tensor:
    """Effective smoothing ``a = max(1/(t+1), alpha)`` in fp32, a 0-d
    tensor on the traces' device: a running mean while young (bias
    correction away from the uniform prior), then the fixed-alpha EMA."""
    return torch.clamp_min(1.0 / (tr.t.to(torch.float32) + 1.0), alpha)


def update_traces_from_stats(tr: Traces, xm: torch.Tensor, ym: torch.Tensor,
                             co: torch.Tensor, alpha: float) -> Traces:
    """EMA step from precomputed batch statistics (means + batch-mean
    co-activation).  ``co`` is dense (Ni, Nj) or compact (Hj, K, Mj), the
    shape of ``tr.pij``."""
    a = smoothing(tr, alpha)
    one = 1.0 - a
    return Traces(
        pi=one * tr.pi + a * xm,
        pj=one * tr.pj + a * ym,
        pij=one * tr.pij + a * co,
        t=tr.t + 1,
        t_host=tr.t_host + 1,
    )


def update_traces(tr: Traces, x: torch.Tensor, y: torch.Tensor,
                  alpha: float) -> Traces:
    """One streaming step of the Hebbian-Bayesian trace update.
    x: (B, Ni) pre-synaptic rates; y: (B, Nj) post-synaptic rates."""
    b = x.shape[0]
    return update_traces_from_stats(tr, x.mean(dim=0), y.mean(dim=0),
                                    (x.T @ y) / b, alpha)


def weights_from_traces(tr: Traces, eps: float = 1e-4
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bayesian weight/bias readout:  b_j = log p_j,
    w_ij = log p_ij/(p_i p_j), with eps floors keeping the logs finite."""
    pi = torch.clamp(tr.pi, eps, 1.0)
    pj = torch.clamp(tr.pj, eps, 1.0)
    pij = torch.clamp(tr.pij, eps * eps, 1.0)
    w = torch.log(pij) - (torch.log(pi)[:, None] + torch.log(pj)[None, :])
    b = torch.log(pj)
    return w, b


def mutual_information(tr: Traces, hi: int, mi: int, hj: int, mj: int,
                       eps: float = 1e-4) -> torch.Tensor:
    """Mutual information between input HC i and output HC j, (Hi, Hj):
    MI_ij = Σ_{m∈i, n∈j} p_mn log(p_mn / (p_m p_n))."""
    w, _ = weights_from_traces(tr, eps)
    pij = torch.clamp(tr.pij, eps * eps, 1.0)
    contrib = pij * w  # (Ni, Nj)
    return contrib.reshape(hi, mi, hj, mj).sum(dim=(1, 3))
