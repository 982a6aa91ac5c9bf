"""Synthetic datasets with the paper's shapes (offline surrogate for
MNIST / MedMNIST-Pneumonia / MedMNIST-Breast — see DESIGN.md §5 data note).

Each class is a smooth random prototype image; samples are prototypes +
pixel noise + random translation, giving a class-structured, linearly
non-trivial task that BCPNN must actually learn.  Loaders accept real
``.npz`` files (keys: x_train, y_train, x_test, y_test) when present.
"""
from __future__ import annotations

import dataclasses
import os
import zlib
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Dataset:
    x_train: np.ndarray  # (N, H, W) float32 in [0,1]
    y_train: np.ndarray  # (N,) int32
    x_test: np.ndarray
    y_test: np.ndarray

    @property
    def image_shape(self) -> Tuple[int, int]:
        return self.x_train.shape[1:]


def _smooth(img: np.ndarray, iters: int = 2) -> np.ndarray:
    for _ in range(iters):
        img = (
            img
            + np.roll(img, 1, 0) + np.roll(img, -1, 0)
            + np.roll(img, 1, 1) + np.roll(img, -1, 1)
        ) / 5.0
    return img


def make_synthetic(
    n_train: int,
    n_test: int,
    side: int,
    n_classes: int,
    seed: int = 0,
    noise: float = 0.15,
    max_shift: int = 2,
) -> Dataset:
    rng = np.random.default_rng(seed)
    protos = _smooth(rng.random((n_classes, side, side)).astype(np.float32), 3)
    # contrast-stretch each prototype so classes are well separated even
    # after smoothing (smoothing alone can leave near-identical fields)
    mu = protos.mean(axis=(1, 2), keepdims=True)
    sd = protos.std(axis=(1, 2), keepdims=True) + 1e-9
    protos = np.clip(0.5 + 0.35 * (protos - mu) / sd, 0.0, 1.0)

    def sample(n: int) -> Tuple[np.ndarray, np.ndarray]:
        y = rng.integers(0, n_classes, size=n).astype(np.int32)
        x = protos[y].copy()
        if max_shift > 0:
            sh = rng.integers(-max_shift, max_shift + 1, size=(n, 2))
            for i in range(n):  # small n; fine on host
                x[i] = np.roll(x[i], sh[i], axis=(0, 1))
        x += rng.normal(0, noise, x.shape).astype(np.float32)
        return np.clip(x, 0, 1), y

    xtr, ytr = sample(n_train)
    xte, yte = sample(n_test)
    return Dataset(xtr, ytr, xte, yte)


def surrogate_seed(name: str) -> int:
    """The surrogate's seed, the same in every process: a CRC-32 of the
    name.  The reference seeds with ``hash(name)``, which
    ``PYTHONHASHSEED`` randomises per process, so its surrogate, and every
    accuracy measured on it, changes from run to run."""
    return zlib.crc32(name.encode()) % 2**31


def load_or_synthesize(name: str, path_hint: str = "data") -> Dataset:
    """Load real data if an .npz is present, else synthesize paper shapes
    (seeded by ``surrogate_seed``, unlike the reference)."""
    spec = {
        # name: (train, test, side, classes)  — paper Table 1
        "mnist": (60000, 10000, 28, 10),
        "pneumonia": (4708, 624, 28, 2),
        "breast": (546, 156, 64, 2),
    }[name]
    fp = os.path.join(path_hint, f"{name}.npz")
    if os.path.exists(fp):
        z = np.load(fp)
        return Dataset(
            z["x_train"].astype(np.float32), z["y_train"].astype(np.int32),
            z["x_test"].astype(np.float32), z["y_test"].astype(np.int32),
        )
    n_train, n_test, side, ncls = spec
    return make_synthetic(n_train, n_test, side, ncls,
                          seed=surrogate_seed(name))


def encode_images(x: np.ndarray) -> np.ndarray:
    """(N, H, W) images -> (N, 2*H*W) complement-pair HC rates (host side)."""
    flat = x.reshape(x.shape[0], -1)
    return np.stack([flat, 1.0 - flat], axis=-1).reshape(x.shape[0], -1)
