"""BCPNN model zoo: the paper's three Table-1 configurations (thin
depth-1 presets) plus deep presets (mirrors
``repro/configs/bcpnn_models.py``).  Every preset defaults to the
``"cuda"`` backend, so the normal entry points reach the kernels."""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from ..core.hypercolumns import LayerGeom
from ..core.network import BCPNNConfig, NetworkSpec, make_network_spec

# The non-struct variants run densely connected (nact_hi = input_hc); the
# struct variants carry the paper's nactHi=128 sparsity + periodic rewiring
# on the patchy path (patchy_traces / compact select its plasticity layout).

# Model 1: MNIST — 28x28 input, hidden 32x128, 10 classes, 5 epochs
MODEL1_MNIST = BCPNNConfig(
    input_hc=28 * 28, input_mc=2, hidden_hc=32, hidden_mc=128,
    n_classes=10, nact_hi=28 * 28, alpha=2e-3, support_noise=3.0,
    noise_steps=1500, struct_every=0,
)

# Model 2: Pneumonia — 28x28 input, hidden 32x256, 2 classes, 20 epochs
MODEL2_PNEUMONIA = BCPNNConfig(
    input_hc=28 * 28, input_mc=2, hidden_hc=32, hidden_mc=256,
    n_classes=2, nact_hi=28 * 28, alpha=2e-3, support_noise=3.0,
    noise_steps=500, struct_every=0,
)

# Model 3: Breast — 64x64 input, hidden 32x128, 2 classes, 100 epochs
MODEL3_BREAST = BCPNNConfig(
    input_hc=64 * 64, input_mc=2, hidden_hc=32, hidden_mc=128,
    n_classes=2, nact_hi=64 * 64, alpha=2e-3, support_noise=3.0,
    noise_steps=300, struct_every=0,
)

# Structural-plasticity variants (paper's "struct" rows): nactHi=128
MODEL1_MNIST_STRUCT = dataclasses.replace(
    MODEL1_MNIST, struct_every=64, nact_hi=128)
MODEL2_PNEUMONIA_STRUCT = dataclasses.replace(
    MODEL2_PNEUMONIA, struct_every=16, nact_hi=128)
MODEL3_BREAST_STRUCT = dataclasses.replace(
    MODEL3_BREAST, struct_every=8, nact_hi=128)

BCPNN_MODELS = {
    "model1-mnist": (MODEL1_MNIST, "mnist", 5),
    "model2-pneumonia": (MODEL2_PNEUMONIA, "pneumonia", 20),
    "model3-breast": (MODEL3_BREAST, "breast", 100),
    "model1-mnist-struct": (MODEL1_MNIST_STRUCT, "mnist", 5),
    "model2-pneumonia-struct": (MODEL2_PNEUMONIA_STRUCT, "pneumonia", 20),
    "model3-breast-struct": (MODEL3_BREAST_STRUCT, "breast", 100),
}


# ----------------------------------------------------------- deep presets --

def deep_mnist_spec(depth: int = 2, backend: str = "cuda",
                    hidden_hc: int = 32, hidden_mc: int = 64) -> NetworkSpec:
    """MNIST-shaped deep stack: 784x2 input, ``depth`` hidden layers of
    hidden_hc x hidden_mc, 10-way readout; upper layers get a shorter noise
    anneal."""
    hidden = [LayerGeom(hidden_hc, hidden_mc)] * depth
    spec = make_network_spec(
        LayerGeom(28 * 28, 2), hidden, n_classes=10, alpha=2e-3,
        backend=backend, support_noise=3.0, noise_steps=1500,
    )
    projs = tuple(
        p if l == 0 else dataclasses.replace(p, noise_steps=500)
        for l, p in enumerate(spec.projs)
    )
    return NetworkSpec(projs=projs, readout=spec.readout)


def deep_synth_spec(side: int = 12, depth: int = 2, n_classes: int = 5,
                    backend: str = "cuda", hidden_hc: int = 16,
                    hidden_mc: int = 32,
                    nact: Optional[Sequence[Optional[int]]] = None,
                    alpha: float = 1e-2, patchy_traces: bool = False,
                    compact: bool = False,
                    struct_every: int = 0) -> NetworkSpec:
    """Deep stack sized for the synthetic surrogate datasets (tests,
    smoke runs): side*side*2 input, ``depth`` hidden layers."""
    hidden = [LayerGeom(hidden_hc, hidden_mc)] * depth
    return make_network_spec(
        LayerGeom(side * side, 2), hidden, n_classes=n_classes, alpha=alpha,
        nact=nact, backend=backend, support_noise=3.0, noise_steps=200,
        patchy_traces=patchy_traces, compact=compact,
        struct_every=struct_every,
    )
