#!/usr/bin/env python3
"""Read the numbers that decide ``correct`` on many seeds in one process:
the program's (the lower readings of the limits) and the control's, the
reference in TF32 put in the program's place (the upper readings).

    python3 hopper_bench/calibrate.py --workload m3-fit --seeds 101-112 \\
        --seconds 3 [--fault half] [--out chiprun_out/calib_m3-fit.jsonl]

Each seed is a run of the cell with a short window (``--seconds``; its
units go through the cell's own traffic, so the check sees the state the
window's calls produced), then the check on both sides.  One JSON line a
seed; the last line gives, for each number, the largest program reading
and the smallest control reading, beside the cell's limit.  The
benchmark's runs never run the control.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def seeds(spec: str):
    out = []
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        out += range(int(lo), int(hi or lo) + 1)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="e.g. 101-112,7")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--fault", default=None,
                    help="plant a fault (hbench/faults.py) in the program: "
                         "its readings are the program's numbers")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(HERE)]
    from run import cache_env
    cache_env(ROOT)
    from hbench import faults
    from hbench.bench import Bench, run_cell
    bench = Bench(ROOT)
    limits = bench.cell(args.workload).workload["limits"]
    prog, ctrl = {}, {}
    out = open(args.out, "w") if args.out else None
    kind = bench.cell(args.workload).traffic["kind"]
    for seed in seeds(args.seeds):
        with (faults.planted(kind, args.fault) if args.fault
              else contextlib.nullcontext()):
            r = run_cell(bench, args.workload, seed, args.seconds, False,
                         t_start=time.perf_counter(), device=args.device,
                         control=True)
        line = {"seed": seed, "correct": r["correct"],
                "attempted": r["attempted"], "failed": r["failed"],
                "program": {k: v["value"] for k, v in r["checks"].items()},
                "control": r["control"]["numbers"],
                "control_correct": r["control"]["correct"]}
        for k, v in line["program"].items():
            prog[k] = max(prog.get(k, 0.0), v if v is not None else
                          float("inf"))
        for k, v in line["control"].items():
            ctrl[k] = min(ctrl.get(k, float("inf")), v)
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
    summary = {"workload": args.workload, "fault": args.fault,
               "program_max": prog,
               "control_min": ctrl, "limits": limits,
               "seconds_total": time.perf_counter() - T_START}
    print(json.dumps(summary), flush=True)
    if out:
        out.write(json.dumps(summary) + "\n")
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
