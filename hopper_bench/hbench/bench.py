"""One run of one cell: set-up, the measured window, the check that
decides ``correct``, and the result line.

Everything that belongs to one cell, configuration, traffic mix or metric
is a file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the network, the surrogate data and the
  training protocol, as the manifest's ``file`` names it;
* ``traffic/<traffic>.json``: the mix's parameters, with ``kind`` naming
  the generator in ``kinds/<kind>.py`` that reads them;
* ``workloads/<cell>.json``: the cell's limits for ``correct`` and how
  many units its traced run traces;
* ``metrics/<metric>.py``: a reader, ``read(readings)``, returning the
  metric's value or None where its run holds nothing to read.

A kind module gives ``setup(run)``, ``unit(run, state)`` (one timed unit
of traffic, returning its record) and ``check(run, state, control)`` (the
numbers compared against the reference once the window has closed).
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import re
import sys
import time
import traceback
from pathlib import Path
from types import ModuleType
from typing import Callable, List, Optional

import torch

from . import compare
from .trace import UNIT_RANGE, Trace, read, start_profiler

BENCH_DIR = Path(__file__).resolve().parents[1]


def _load_module(path: Path, prefix: str) -> ModuleType:
    name = prefix + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # a dataclass looks its module up there
    spec.loader.exec_module(mod)
    return mod


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict     # the configuration's file
    traffic: dict    # the traffic mix's file
    workload: dict   # workloads/<name>.json
    kind: ModuleType
    chips: int


class Bench:
    """The manifest at ``root/BENCHMARK.json`` and the benchmark's files
    under ``bench_dir``."""

    def __init__(self, root: Path, bench_dir: Path = BENCH_DIR):
        self.root = Path(root)
        self.dir = Path(bench_dir)
        self.manifest = _read_json(self.root / "BENCHMARK.json")

    def _entry(self, section: str, name: str) -> dict:
        for e in self.manifest[section]:
            if e["name"] == name:
                return e
        raise KeyError(f"BENCHMARK.json has no {section} entry {name!r}")

    def cell(self, name: str) -> Cell:
        entry = self._entry("workloads", name)
        cfg_entry = self._entry("configs", entry["config"])
        traffic = _read_json(self.dir / "traffic" / f"{entry['traffic']}.json")
        return Cell(
            name=name,
            config=_read_json(self.root / cfg_entry["file"]),
            traffic=traffic,
            workload=_read_json(self.dir / "workloads" / f"{name}.json"),
            kind=_load_module(self.dir / "kinds" / f"{traffic['kind']}.py",
                              "hb_kind_"),
            chips=int(entry["chips"]))

    def metrics(self, cell: str, trace: bool) -> List[dict]:
        """The metrics a run of ``cell`` reports: its end-to-end ones with
        ``--trace 0``, its per-layer ones with ``--trace 1``."""
        section = "per_layer" if trace else "end_to_end"
        return [m for m in self.manifest[section]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str) -> Callable[["Readings"], Optional[float]]:
        return _load_module(self.dir / "metrics" / f"{metric}.py",
                            "hb_metric_").read


@dataclasses.dataclass
class Run:
    """What a kind's functions are given."""

    cell: Cell
    seed: int
    device: torch.device
    # per-leaf or per-number readings behind the check's numbers
    details: dict = dataclasses.field(default_factory=dict)
    # the control's numbers, where the check was asked for them
    control: dict = dataclasses.field(default_factory=dict)

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def generator(self) -> torch.Generator:
        """The inputs' generator on the device, from the seed (the
        program's own generator takes the seed itself)."""
        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed * 8 + 1) % 2**63)
        return g

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@dataclasses.dataclass
class Readings:
    """What a metric's reader is given."""

    cell: Cell
    setup_s: float
    window: tuple                 # (start, end), host clock, seconds
    units: List[dict]             # every unit of the window
    traced: List[dict]            # the units under the profiler
    trace: Optional[Trace]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def _finite(x) -> Optional[float]:
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def run_cell(bench: Bench, name: str, seed: int, seconds: float, trace: bool,
             *, t_start: float, device: str = "cuda", control: bool = False,
             log=sys.stderr) -> dict:
    """One run; returns the result object (the last line's keys, then
    ``checks``).  ``control`` also reads the control's numbers, the
    reference in TF32 put in the program's place, into ``control`` (the
    calibration's; never in a run of the benchmark)."""
    cell = bench.cell(name)
    run = Run(cell=cell, seed=seed, device=torch.device(device))
    k0 = time.perf_counter()
    state = cell.kind.setup(run)
    run.sync()
    print(f"set-up: {k0 - t_start:.3f} s to the cell's own, which took "
          f"{time.perf_counter() - k0:.3f} s", file=log)
    n_trace = int(cell.workload["trace_units"])
    prof = start_profiler() if trace else None
    units: List[dict] = []
    failed = 0
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    deadline = t0 + seconds
    while True:
        tracing = prof is not None and len(units) < n_trace
        scope = (torch.profiler.record_function(UNIT_RANGE) if tracing
                 else contextlib.nullcontext())
        u0 = time.perf_counter()
        try:
            with scope:
                rec = cell.kind.unit(run, state)
        except Exception:  # a unit that raises is a failed unit
            traceback.print_exc(file=log)
            rec = {"ok": False, "spans": []}
        u1 = time.perf_counter()
        rec.update(t0=u0, t1=u1)
        units.append(rec)
        failed += not rec["ok"]
        if tracing and len(units) == n_trace:
            prof.stop()
        if u1 >= deadline or not rec["ok"]:
            break
    if prof is not None and len(units) < n_trace:
        prof.stop()
    window = (t0, units[-1]["t1"])
    peak = (torch.cuda.max_memory_allocated(run.device)
            if run.device.type == "cuda" else 0)

    try:
        numbers = cell.kind.check(run, state, control)
    except Exception:  # no reading is a failed comparison
        traceback.print_exc(file=log)
        numbers = {}
    del state
    if run.details:
        print("details " + json.dumps(run.details, default=str), file=log)
    correct, checks = compare.judge(numbers, cell.workload["limits"])
    correct = correct and failed == 0

    traced = units[:n_trace] if trace else []
    tr = (read(prof, [(u["t0"], u["t1"]) for u in traced],
               [u["spans"] for u in traced]) if trace else None)
    readings = Readings(cell=cell, setup_s=setup_s, window=window,
                        units=units, traced=traced, trace=tr)
    metrics = {}
    for m in bench.metrics(name, trace):
        value = _finite(bench.reader(m["name"])(readings))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(run.device)
                    if run.device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(units),
              "failed": failed, "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.longest_gaps()}
    if control:
        ok, _ = compare.judge(run.control, cell.workload["limits"])
        result["control"] = {"correct": ok, "numbers": run.control}
    result["checks"] = {k: {"value": _finite(v["value"]),
                            "limit": _finite(v["limit"])}
                        for k, v in checks.items()}
    return result
