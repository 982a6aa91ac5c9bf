"""Plain PyTorch reference of the dense depth-1 BCPNN of Table 1.

A network of three populations, input (Hi x Mi) -> hidden (Hj x Mj) ->
classes (1 x C), all-to-all, in float32 with TF32 off, written from the
paper's equations (arXiv 2503.01561, section 3) and the configuration's
numbers alone.  Nothing here reads the program's modules: what the
benchmark compares is worked out again from the inputs and, where a check
starts from the program's state, from that state's tensors.

One projection holds the probability traces p_i, p_j, p_ij, the clock t,
and the weights and bias folded from them:

    a     = max(1 / (t + 1), alpha)
    p_i'  = (1 - a) p_i + a mean(x)          p_j' likewise with y
    p_ij' = (1 - a) p_ij + a x^T y / n       n = the batch's genuine rows
    w     = log clip(p_ij', eps^2, 1) - log clip(p_i', eps, 1)
            - log clip(p_j', eps, 1)
    b     = log clip(p_j', eps, 1)

The unsupervised step drives the hidden population with its own noisy
rates, softmax within each hypercolumn of ``b + x w + amp * noise``, amp
falling from ``support_noise`` to 0 over ``noise_steps`` updates; the
readout step drives the class population with the one-hot labels, from the
hidden rates of the noiseless forward.  ``tf32=True`` rounds every
product's operands to TF32 (10 mantissa bits, to nearest even) and keeps
the fp32 sum: the control that the comparison must fail.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, Optional, Tuple

import torch

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Net:
    """The numbers of a configuration that the arithmetic reads."""

    hi: int
    mi: int
    hj: int
    mj: int
    n_classes: int
    alpha: float
    eps: float
    gain: float
    support_noise: float
    noise_steps: int

    @classmethod
    def from_config(cls, network: dict) -> "Net":
        return cls(hi=network["input_hc"], mi=network["input_mc"],
                   hj=network["hidden_hc"], mj=network["hidden_mc"],
                   n_classes=network["n_classes"], alpha=network["alpha"],
                   eps=network["eps"], gain=network["gain"],
                   support_noise=network["support_noise"],
                   noise_steps=network["noise_steps"])

    @property
    def ni(self) -> int:
        return self.hi * self.mi

    @property
    def nj(self) -> int:
        return self.hj * self.mj


@dataclasses.dataclass
class Proj:
    pi: torch.Tensor
    pj: torch.Tensor
    pij: torch.Tensor
    t: torch.Tensor  # 0-d float32 clock
    w: torch.Tensor
    b: torch.Tensor

    def leaves(self) -> dict:
        return {"pi": self.pi, "pj": self.pj, "pij": self.pij, "t": self.t,
                "w": self.w, "b": self.b}


@dataclasses.dataclass
class State:
    hidden: Proj
    readout: Proj

    def leaves(self) -> dict:
        out = {f"hidden.{k}": v for k, v in self.hidden.leaves().items()}
        out.update({f"readout.{k}": v
                    for k, v in self.readout.leaves().items()})
        return out


@contextlib.contextmanager
def exact_fp32() -> Iterator[None]:
    """TF32 off for every product inside, whatever the process had."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10 mantissa bits, to nearest even, as float32."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & -0x2000
    return bits.view(F32)


def matmul(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    if tf32:
        a, b = round_tf32(a), round_tf32(b)
    with exact_fp32():
        return a @ b


def hc_softmax(s: torch.Tensor, n_hc: int, n_mc: int,
               gain: float) -> torch.Tensor:
    z = s.reshape(s.shape[0], n_hc, n_mc) * gain
    z = z - z.amax(dim=-1, keepdim=True)
    e = torch.exp(z)
    return (e / e.sum(dim=-1, keepdim=True)).reshape(s.shape)


def fold(pi, pj, pij, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    log_pi = torch.log(torch.clamp(pi, eps, 1.0))
    log_pj = torch.log(torch.clamp(pj, eps, 1.0))
    w = torch.log(torch.clamp(pij, eps * eps, 1.0)) - log_pi[:, None] \
        - log_pj[None, :]
    return w, log_pj


def _init_proj(n_pre: int, m_pre: int, n_post: int, m_post: int, eps: float,
               gen: torch.Generator) -> Proj:
    dev = gen.device
    p0 = (1.0 / m_pre) * (1.0 / m_post)
    pij = torch.full((n_pre, n_post), p0, dtype=F32, device=dev)
    pij = pij * torch.exp(0.1 * torch.randn((n_pre, n_post), generator=gen,
                                            dtype=F32, device=dev))
    pi = torch.full((n_pre,), 1.0 / m_pre, dtype=F32, device=dev)
    pj = torch.full((n_post,), 1.0 / m_post, dtype=F32, device=dev)
    w, b = fold(pi, pj, pij, eps)
    return Proj(pi=pi, pj=pj, pij=pij,
                t=torch.zeros((), dtype=F32, device=dev), w=w, b=b)


def init_state(net: Net, gen: torch.Generator) -> State:
    """The configuration's starting state: uniform priors, the joint trace
    perturbed by exp(0.1 N(0, 1)), drawn from ``gen`` (hidden, then
    readout)."""
    return State(
        hidden=_init_proj(net.ni, net.mi, net.nj, net.mj, net.eps, gen),
        readout=_init_proj(net.nj, net.mj, net.n_classes, net.n_classes,
                           net.eps, gen))


def update(p: Proj, x: torch.Tensor, y: torch.Tensor, n: torch.Tensor,
           net: Net, tf32: bool) -> Proj:
    """One trace step on rows whose pad rows are zero; ``n`` counts the
    genuine ones."""
    a = torch.clamp_min(1.0 / (p.t + 1.0), net.alpha)
    pi = (1.0 - a) * p.pi + a * (x.sum(dim=0) / n)
    pj = (1.0 - a) * p.pj + a * (y.sum(dim=0) / n)
    pij = (1.0 - a) * p.pij + a * (matmul(x.T, y, tf32) / n)
    w, b = fold(pi, pj, pij, net.eps)
    return Proj(pi=pi, pj=pj, pij=pij, t=p.t + 1.0, w=w, b=b)


def _rows(x: torch.Tensor, valid: Optional[torch.Tensor]):
    if valid is None:
        return x, torch.tensor(float(x.shape[0]), dtype=F32,
                               device=x.device)
    v = valid.to(F32)
    return x * v[:, None], torch.clamp_min(v.sum(), 1.0)


def hidden_rates(state: State, net: Net, x: torch.Tensor,
                 tf32: bool = False) -> torch.Tensor:
    s = state.hidden.b + matmul(x, state.hidden.w, tf32)
    return hc_softmax(s, net.hj, net.mj, net.gain)


def unsupervised_step(state: State, net: Net, x: torch.Tensor,
                      gen: Optional[torch.Generator],
                      valid: Optional[torch.Tensor] = None,
                      tf32: bool = False) -> State:
    """One unsupervised batch on the hidden projection.  The noise is drawn
    from ``gen`` (as the configuration's stream does, even once its
    amplitude is 0); with no generator the amplitude must be 0."""
    h = state.hidden
    s = h.b + matmul(x, h.w, tf32)
    amp = net.support_noise * torch.clamp_min(
        1.0 - h.t / max(1, net.noise_steps), 0.0)
    if gen is not None:
        s = s + amp * torch.randn(s.shape, generator=gen, dtype=F32,
                                  device=s.device)
    elif float(amp) != 0.0:
        raise ValueError("the noise is still on: a generator is needed")
    y = hc_softmax(s, net.hj, net.mj, net.gain)
    xv, n = _rows(x, valid)
    yv, _ = _rows(y, valid)
    return State(hidden=update(h, xv, yv, n, net, tf32),
                 readout=state.readout)


def readout_step(state: State, net: Net, x: torch.Tensor,
                 labels: torch.Tensor, valid: Optional[torch.Tensor] = None,
                 tf32: bool = False) -> State:
    """One supervised batch on the readout, the hidden layer frozen."""
    h = hidden_rates(state, net, x, tf32)
    y = (labels.long()[:, None]
         == torch.arange(net.n_classes, device=x.device)).to(F32)
    hv, n = _rows(h, valid)
    yv, _ = _rows(y, valid)
    return State(hidden=state.hidden,
                 readout=update(state.readout, hv, yv, n, net, tf32))


def batches(n: int, batch: int):
    """(start, stop, padded) of each batch of a fit over n rows: whole
    batches, then the tail, which a fit pads with zero rows."""
    for b0 in range(0, n, batch):
        yield b0, min(n, b0 + batch), b0 + batch > n


def fit_epoch_steps(state: State, net: Net, x: torch.Tensor,
                    labels: torch.Tensor, batch: int,
                    gen: Optional[torch.Generator], tf32: bool = False
                    ) -> State:
    """One unsupervised epoch then the supervised pass over rows (x,
    labels), the tail batch zero-padded to ``batch`` rows and masked."""
    def padded(t, b0, b1):
        if b1 - b0 == batch:
            return t[b0:b1], None
        pad = torch.zeros((batch - (b1 - b0), *t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        valid = (torch.arange(batch, device=t.device) < b1 - b0).to(F32)
        return torch.cat([t[b0:b1], pad]), valid

    for b0, b1, _ in batches(x.shape[0], batch):
        xb, valid = padded(x, b0, b1)
        state = unsupervised_step(state, net, xb, gen, valid, tf32)
    for b0, b1, _ in batches(x.shape[0], batch):
        xb, valid = padded(x, b0, b1)
        yb, _ = padded(labels, b0, b1)
        state = readout_step(state, net, xb, yb, valid, tf32)
    return state
