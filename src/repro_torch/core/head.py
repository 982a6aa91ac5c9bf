"""BCPNNHead — the paper's technique on the pooled features of any LM
trunk (mirrors ``repro/core/head.py``).

Pooled hidden states from a (frozen) LM trunk are rate-encoded into input
hypercolumns and fed to a depth-1 BCPNN network for online unsupervised /
semi-supervised readout (DESIGN.md §4).  The trunk is plain PyTorch; the
head learns with the local Hebbian-Bayesian rule, no backprop through it,
and on the card its steps run the kernels (``BCPNNConfig``'s default
backend, ``"cuda"``; a CPU tensor takes the plain versions).

The trunk's features may be bf16, and the kernels take fp32: the sigmoid
is computed in the feature dtype, as in JAX, and the encoded rates are
cast to fp32 before the network (JAX's promotion at the first product,
made explicit).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..device import DeviceLike
from .hypercolumns import encode_scalar_hcs
from .network import (BCPNNConfig, DeepState, infer, init_network,
                      supervised_step, unsupervised_step)


@dataclasses.dataclass(frozen=True)
class BCPNNHeadConfig:
    feature_dim: int          # trunk hidden size (pooled)
    hidden_hc: int = 16
    hidden_mc: int = 64
    n_classes: int = 10
    nact_hi: int = 0          # 0 = dense connectivity
    alpha: float = 1e-2
    struct_every: int = 0
    support_noise: float = 3.0
    noise_steps: int = 50     # anneal fast: heads see few online batches
    encode_gain: float = 4.0  # rate-encoding sharpness (sigmoid temp)

    def network_config(self) -> BCPNNConfig:
        return BCPNNConfig(
            input_hc=self.feature_dim,
            input_mc=2,
            hidden_hc=self.hidden_hc,
            hidden_mc=self.hidden_mc,
            n_classes=self.n_classes,
            nact_hi=self.nact_hi if self.nact_hi > 0 else self.feature_dim,
            alpha=self.alpha,
            struct_every=self.struct_every,
            support_noise=self.support_noise,
            noise_steps=self.noise_steps,
        )


def init_head(cfg: BCPNNHeadConfig, seed: int = 0,
              device: DeviceLike = None) -> DeepState:
    return init_network(cfg.network_config(), seed, device)


def encode_features(feats: torch.Tensor, gain: float = 4.0) -> torch.Tensor:
    """(B, F) trunk features -> (B, 2F) rate-coded input hypercolumns.

    Features are squashed to [0,1] with a sharpened logistic before
    complement-pair encoding.  The gain matters: near-0.5 rates make
    p_ij ~ p_i p_j (no extractable information); gain ~4 pushes encodings
    toward confident (0/1) rates, which is what the Bayesian rule needs.
    """
    return encode_scalar_hcs(torch.sigmoid(gain * feats))


def _rates(cfg: BCPNNHeadConfig, feats: torch.Tensor) -> torch.Tensor:
    return encode_features(feats, cfg.encode_gain).to(torch.float32)


def head_unsupervised(state: DeepState, cfg: BCPNNHeadConfig,
                      feats: torch.Tensor, *,
                      noise: Optional[torch.Tensor] = None) -> DeepState:
    """``noise`` (optional, (B, hidden_hc*hidden_mc)) replaces the draw
    from the state's generator (tests inject the JAX draw)."""
    return unsupervised_step(state, cfg.network_config(), _rates(cfg, feats),
                             noise=noise)


def head_supervised(state: DeepState, cfg: BCPNNHeadConfig,
                    feats: torch.Tensor, labels: torch.Tensor) -> DeepState:
    return supervised_step(state, cfg.network_config(), _rates(cfg, feats),
                           labels)


def head_predict(state: DeepState, cfg: BCPNNHeadConfig, feats: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    return infer(state, cfg.network_config(), _rates(cfg, feats))
