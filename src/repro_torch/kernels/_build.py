"""Build, load and launch helpers for the hand-written CUDA kernels.

``csrc/bcpnn.cu`` is compiled at first use with ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so the build takes seconds).  The library lands in
``build/repro_torch/`` at the root of the checkout, named by a hash of
the source and the flags, so an edited source rebuilds and an unchanged
one loads at once.  Nothing here runs at import time: the CPU tests import
every module of the port on a machine without ``nvcc``.

No ``--use_fast_math``: ``expf``/``logf`` and division stay IEEE, or the
``log(pij)`` weight fold drifts beyond the 1e-4 parity tolerance.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "bcpnn.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry point -> argument types (every pointer and the stream are void*).
_SIGNATURES = {
    "bcpnn_hc_softmax": (_P, _P, ctypes.c_longlong, _I, _F, _P),
    "bcpnn_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    "bcpnn_update": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _I, _I, _F, _P),
    "bcpnn_patchy_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                         _P),
    "bcpnn_patchy_update": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _I, _F, _P),
}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda); "
                       "the CUDA kernels are built on the machine with the card")


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libbcpnn_{digest}.so"


def build() -> Path:
    """Compile the kernels if this source has no library yet; return its
    path.  The compile writes to a temporary name and renames, so two
    processes building at once never load a half-written file."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.bcpnn_error_string.argtypes = (_I,)
        lib.bcpnn_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_launch(rc: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if rc != 0:
        msg = library().bcpnn_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc} "
                           f"({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, shape: tuple,
            device: torch.device, dtype: torch.dtype = torch.float32) -> None:
    """Validate one kernel operand: on ``device``, of ``dtype`` (float32
    unless said), contiguous and of exactly ``shape``.  Raises
    ``ValueError`` on anything else."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}; the CUDA kernels "
                         f"take {dtype} here")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def require_current_device(t: torch.Tensor) -> None:
    """The C entry points launch on the current device: refuse a tensor
    that lives on another one."""
    if t.device.type != "cuda":
        raise ValueError(f"expected a CUDA or CPU tensor, got {t.device}")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"tensor on {t.device} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
