#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card, and print its result.

    python3 hopper_bench/run.py --workload m3-fit --seed 7 --seconds 50 \\
        --trace 0

from the root of a checkout.  The cell, its configuration, traffic mix and
metrics are found by name (``BENCHMARK.json``, then the files under
``hopper_bench/``); ``hbench/bench.py`` says which file holds what.  The
system under test is ``repro_torch`` from ``src/``; nothing here imports
JAX or the JAX package, and a run that finds either loaded once its window
has closed prints no result.

The last line of standard output is the result: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer ones with ``--trace 1``), ``device``, with
``--trace 1`` also ``breakdown``, then ``card`` (name and power limit)
and ``checks``, each compared number beside its limit, which the last
lines of standard error repeat.  Exit codes: 0 with a result; 2 without a
card (or fewer cards than the cell asks for); 3 when JAX or the JAX
package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names that must not be loaded: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def cache_env(root: Path) -> None:
    """Every build and kernel cache under the checkout, at fixed paths, and
    no autotune file from outside it (the path is never written, so the
    kernels launch their default plans)."""
    build = root / "build" / "hopper_bench"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(build / "no-autotune.json")


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env(ROOT)
    sys.path[:0] = [str(ROOT / "src"), str(HERE)]
    import torch
    from hbench.bench import Bench, run_cell

    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=T_START)
    found = forbidden_loaded()
    if found:
        print(f"loaded in this process: {', '.join(found)}; the benchmark "
              f"measures repro_torch alone", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    result["card"] = card_line()
    result["checks"] = checks
    print(json.dumps(result))
    sys.stdout.flush()
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
