"""A small copy of the benchmark for the CPU tests: the real harness,
kinds, metrics and reference, under a manifest of small cells whose
configurations keep the Table-1 networks' structure at CPU sizes."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
for p in (str(BENCH), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def small_network(ihc: int, n_classes: int) -> dict:
    return {"input_hc": ihc, "input_mc": 2, "hidden_hc": 4, "hidden_mc": 16,
            "n_classes": n_classes, "nact_hi": ihc, "alpha": 0.02,
            "eps": 0.0001, "gain": 1.0, "struct_every": 0,
            "support_noise": 3.0, "noise_steps": 20, "backend": "cuda",
            "patchy_traces": False, "compact": False, "infer_dtype": "fp32"}


def make(tmp: Path, limits_fit=None) -> Path:
    """A repo root under ``tmp`` with BENCHMARK.json and a copy of the
    benchmark's folder, its cell ``s-fit`` on a 12x12
    surrogate (288 inputs, 4 x 16 hidden, 3 classes, 150 rows)."""
    root = tmp / "repo"
    bench = root / "hopper_bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    cfg = {"name": "small", "network": small_network(144, 3),
           "data": {"n_train": 150, "n_test": 50, "side": 12,
                    "n_classes": 3, "noise": 0.3, "max_shift": 2},
           "protocol": {"epochs": 2, "batch": 32}}
    (bench / "configs" / "small.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "fit-small.json").write_text(json.dumps(
        {"kind": "fit", "epochs": 2, "batch": 32}))
    (bench / "workloads" / "s-fit.json").write_text(json.dumps(
        {"limits": limits_fit or {"start": 1e-3, "end": 1e-3},
         "trace_units": 1}))
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    manifest["configs"].append(
        {"name": "small", "source": "https://arxiv.org/abs/2503.01561",
         "file": "hopper_bench/configs/small.json", "reduced": [],
         "why": "CPU tests"})
    manifest["workloads"].append(
        {"name": "s-fit", "config": "small", "traffic": "fit-small",
         "chips": 1, "why": "CPU tests"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("s-fit")
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root


def run(root: Path, cell: str, seed: int = 5, seconds: float = 0.5,
        trace: bool = False, control: bool = False) -> dict:
    """One CPU run of a small cell, on one thread: the test workers share
    the machine with timing-sensitive tests."""
    import time

    import torch
    from hbench.bench import Bench, run_cell
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return run_cell(Bench(root, root / "hopper_bench"), cell, seed,
                        seconds, trace, t_start=time.perf_counter(),
                        device="cpu", control=control)
    finally:
        torch.set_num_threads(threads)
