"""Build, load and launch helpers for the hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled at first use with ``nvcc``, one process
per source, all started together, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so the build takes seconds).  The library lands in
``build/repro_torch/`` at the root of the checkout, named by a hash of
every file in ``csrc/`` and the flags, so an edit to any of them rebuilds
and an unchanged tree loads at once.  Nothing here runs at import time:
the CPU tests import every module of the port on a machine without
``nvcc``.

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
from typing import List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry point -> argument types (every pointer and the stream are void*).
_SIGNATURES = {
    "bcpnn_hc_softmax": (_P, _P, ctypes.c_longlong, _I, _F, _P),
    "bcpnn_hc_softmax_plan": (_P, _P, _I, _P),
    "bcpnn_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    "bcpnn_fwd_cluster": (_I, _I, _I, _I, _I, _I, _P),
    "bcpnn_update": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _I, _I, _F, _P),
    "bcpnn_patchy_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _I, _F, _P),
    "bcpnn_patchy_update": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _I, _F, _P),
    "bcpnn_quant_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                        _I, _I, _F, _P),
    "bcpnn_quant_fwd_plan": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "bcpnn_mma_tf32_rate": (_P, _I, _I, _I, _P),
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


def sources() -> List[Path]:
    """The kernel sources, each compiled on its own."""
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"libbcpnn_{h.hexdigest()[:16]}.so"


def _check(proc: subprocess.CompletedProcess, cmd: List[str]) -> None:
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")


def build() -> Path:
    """Compile the kernels if these sources have no library yet; return its
    path.  The sources compile in parallel into a temporary directory; the
    link writes to a temporary name and renames, so two processes building
    at once never load a half-written file."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmpdir:
        objs, jobs = [], []
        for src in sources():
            obj = str(Path(tmpdir, src.stem + ".o"))
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.PIPE,
                                               text=True)))
            objs.append(obj)
        outputs = [job.communicate() for _, job in jobs]  # all end first
        for (cmd, job), (stdout, stderr) in zip(jobs, outputs):
            _check(subprocess.CompletedProcess(cmd, job.returncode, stdout,
                                               stderr), cmd)
        tmp = str(Path(tmpdir, out.name))
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        _check(subprocess.run(cmd, capture_output=True, text=True), cmd)
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


def _span(t: torch.Tensor):
    return t.data_ptr(), t.data_ptr() + t.numel() * t.element_size()


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    (a0, a1), (b0, b1) = _span(a), _span(b)
    return a0 < b1 and b0 < a1


def require_outputs(out, pij: torch.Tensor, device: torch.device):
    """The (pij', w) destinations of an update kernel: fresh tensors when
    ``out`` is None, else the caller's pair, each float32, contiguous and
    of pij's shape on ``device``.  pij' may be pij itself (in place) but no
    other view of its memory; w shares memory with neither.  Raises
    ``ValueError`` on anything else."""
    if out is None:
        return torch.empty_like(pij), torch.empty_like(pij)
    pij_out, w_out = out
    for t, name in ((pij_out, "pij_out"), (w_out, "w_out")):
        require(t, name, tuple(pij.shape), device)
    if _overlap(pij_out, pij) and pij_out.data_ptr() != pij.data_ptr():
        raise ValueError("pij_out overlaps pij without being pij itself")
    if _overlap(w_out, pij) or _overlap(w_out, pij_out):
        raise ValueError("w_out shares memory with pij or pij_out")
    return pij_out, w_out


def weight_dtype(w: torch.Tensor) -> torch.dtype:
    """The element type of a forward kernel's weights and bias: float32, or
    the bfloat16 of a bf16 serving pack.  Raises on anything else."""
    if w.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"w has dtype {w.dtype}; the forward kernels take "
                         f"float32 or bfloat16 weights")
    return w.dtype


def check_table(table: torch.Tensor, hj: int, ni: int, mi: int,
                dev: torch.device) -> int:
    """Validate a patchy kernel's (Hj, nact) int32 index table against the
    geometry; return nact."""
    if table.dim() != 2 or table.shape[0] != hj:
        raise ValueError(f"table has shape {tuple(table.shape)}, expected "
                         f"({hj}, nact)")
    nact = table.shape[1]
    if mi <= 0 or ni % mi or not 0 < nact <= ni // mi:
        raise ValueError(f"table of {nact} pre-HCs does not fit Ni={ni} "
                         f"with Mi={mi}")
    require(table, "table", (hj, nact), dev, torch.int32)
    return nact
