#!/usr/bin/env python3
"""A cell's idle gaps on the card, named by the program's own spans.

    python3 hopper_bench/program_gaps.py --workload m3-fit --seed 7 \\
        [--traced 2] [--after 3]

from the root of a checkout.  Runs the cell's set-up, then ``--traced``
units under the profiler, each in an ``hb.unit`` range as a traced run
has them, then ``--after`` units without it, and prints one JSON line:
each unit's host seconds (traced, then not); the traced units' busy time;
their idle gaps, each named by the innermost span holding its middle (the
program's ``repro_torch.*`` spans where it has them, else the
benchmark's: ``hbench/program.py::read``), the ten longest and the sums
by name; and those sums inside the program's ``repro_torch.fit.unsup``
and ``.sup`` spans, the loop.  A program without spans gives the
benchmark's names and an empty loop.  The cell's check is not run.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

HERE = Path(__file__).resolve().parent
LOOP = ("repro_torch.fit.unsup", "repro_torch.fit.sup")


def gaps(bench, name: str, seed: int, traced: int, after: int,
         device: str = "cuda") -> dict:
    import torch
    from hbench import program
    from hbench.bench import Run
    from hbench.trace import UNIT_RANGE, start_profiler

    cell = bench.cell(name)
    run = Run(cell=cell, seed=seed, device=torch.device(device))
    state = cell.kind.setup(run)
    run.sync()
    units = []

    def unit(scope):
        u0 = time.perf_counter()
        with scope:
            rec = cell.kind.unit(run, state)
        units.append(dict(rec, t0=u0, t1=time.perf_counter()))

    prof = start_profiler()
    for _ in range(traced):
        unit(torch.profiler.record_function(UNIT_RANGE))
    prof.stop()
    for _ in range(after):
        unit(contextlib.nullcontext())
    tr = program.read(prof, [(u["t0"], u["t1"]) for u in units[:traced]],
                      [u["spans"] for u in units[:traced]])
    loop = [sp for sp in tr.spans if sp.label in LOOP]
    idle, in_loop, found = defaultdict(float), defaultdict(float), []
    at = tr.window[0]
    for s, e in tr.busy_intervals() + [(tr.window[1], tr.window[1])]:
        if s > at:
            mid, sec = (at + s) / 2, (s - at) * 1e-6
            label = tr.label_at(mid)
            found.append([label, sec])
            idle[label] += sec
            if any(sp.start <= mid < sp.end for sp in loop):
                in_loop[label] += sec
        at = max(at, e)
    return {
        "workload": name, "seed": seed,
        "fit_s": [u["t1"] - u["t0"] for u in units[:traced]],
        "fit_s_untraced": [u["t1"] - u["t0"] for u in units[traced:]],
        "busy_s": tr.busy_s, "window_s": tr.window_s,
        "loop_s": sum(sp.end - sp.start for sp in loop) * 1e-6,
        "loop_idle_s": dict(in_loop), "idle_s": dict(idle),
        "longest_gaps": sorted(found, key=lambda g: -g[1])[:10],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--traced", type=int, default=2)
    ap.add_argument("--after", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE.parent / "src"), str(HERE)]
    from run import cache_env, card_line
    cache_env(HERE.parent)
    import torch
    from hbench.bench import Bench

    if not torch.cuda.is_available():
        print("no CUDA device: the gaps are the card's", file=sys.stderr)
        return 2
    out = gaps(Bench(HERE.parent), args.workload, args.seed, args.traced,
               args.after)
    out["card"] = card_line()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
