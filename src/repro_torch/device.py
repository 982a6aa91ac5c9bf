"""Where the port runs: the card unless the caller asks for the CPU."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA device with no card visible
    raises: the port never carries on quietly on the CPU; pass
    ``device="cpu"`` to run the plain PyTorch versions there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the card by default, but no CUDA device is "
            "visible; pass device='cpu' to run the plain PyTorch versions "
            "on the CPU")
    return dev


def make_generator(seed: int, device: Optional[torch.device]) -> torch.Generator:
    """A seeded ``torch.Generator`` on ``device`` (no global RNG state)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g
