"""The readers of what the program reports of itself (``hbench/program.py``
and the metrics on it): a traced small run holds the program's spans
inside the benchmark's unit ranges and reads its fit reports; the trace
with the program's ranges, from fake profiler events; the device-trace
readers on fake trace data; nothing read, and nothing raised, for a
program without its reports."""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import io
import sys
import time

import hb_small
import pytest
from torch.autograd import DeviceType

from hbench import bench as hbench_bench
from hbench import program, trace
from hbench.bench import Bench, Readings, run_cell

PROGRAM_SPANS = ("repro_torch.fit.pad", "repro_torch.fit.h2d",
                 "repro_torch.fit.unsup", "repro_torch.fit.sup",
                 "repro_torch.fit.epoch")


def _reader(name):
    path = hb_small.BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "t_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class _Keeping(Bench):
    """The harness, keeping each unit's record."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.units = []

    def cell(self, name):
        c = super().cell(name)
        kind, units = c.kind, self.units

        def unit(run, st):
            rec = kind.unit(run, st)
            units.append(rec)
            return rec

        c.kind = type("Kind", (), {"setup": staticmethod(kind.setup),
                                   "unit": staticmethod(unit),
                                   "check": staticmethod(kind.check)})
        return c


def test_a_traced_small_run_holds_the_program_spans_and_reports(
        tmp_path, monkeypatch):
    import torch
    root = hb_small.make(tmp_path)
    profs = []

    def keep_profiler():
        profs.append(trace.start_profiler())
        return profs[-1]

    monkeypatch.setattr(hbench_bench, "start_profiler", keep_profiler)
    b = _Keeping(root, root / "hopper_bench")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stderr(io.StringIO()):
            r = run_cell(b, "s-fit", 5, 0.3, True,
                         t_start=time.perf_counter(), device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert r["correct"] is True
    events = profs[0].events()
    for name in PROGRAM_SPANS:
        found = [e for e in events if e.name == name]
        assert found, name
        for e in found:
            up, p = [], e.cpu_parent
            while p is not None:
                up.append(p.name)
                p = p.cpu_parent
            assert up[-1] == trace.UNIT_RANGE, (name, up)
    reports = program.fit_reports(b.units)
    assert reports is not None and len(reports) == r["attempted"]
    for u, f in zip(b.units, reports):
        pad_s, h2d_s = f.pad[1] - f.pad[0], f.h2d[1] - f.h2d[0]
        assert pad_s + h2d_s <= u["fit_s"] and f.captures == 0
        assert f.unsup[1] - f.unsup[0] == u["unsup_s"]
    m = r["metrics"]
    assert m["captures.fit"]["value"] == 0
    assert 0 < m["pad_ms.fit"]["value"] + m["h2d_ms.fit"]["value"] <= (
        m["prep_ms.fit"]["value"])


@dataclasses.dataclass
class _Range:
    start: float
    end: float


@dataclasses.dataclass
class _Event:
    name: str
    device_type: DeviceType
    time_range: _Range


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _ev(name, dev, s, e):
    return _Event(name, DeviceType.CUDA if dev else DeviceType.CPU,
                  _Range(s, e))


# One unit, 0-100 us on the profiler's clock: kernels at 0-10 and 60-100;
# the program's epoch span 5-100 holds a sync span 40-55; the card's copy
# of the epoch range covers 10-95.
BASE = [_ev(trace.UNIT_RANGE, False, 0.0, 100.0),
        _ev("k1", True, 0.0, 10.0), _ev("k2", True, 60.0, 100.0)]
PROGRAM = [_ev("repro_torch.fit.epoch", False, 5.0, 100.0),
           _ev("repro_torch.fit.sync", False, 40.0, 55.0),
           _ev("repro_torch.fit.epoch", True, 10.0, 95.0)]
UNIT_HOST = [(1.0, 1.0001)]
SPANS = [[trace.Span("fit.unsup", 1.0, 1.0001)]]


def test_the_program_trace_drops_its_annotations_and_names_gaps():
    tr = program.read(_Prof(BASE + PROGRAM), UNIT_HOST, SPANS)
    assert [d[0] for d in tr.device] == ["k1", "k2"]
    assert tr.busy_s == pytest.approx(50e-6)
    gaps = tr.idle_gaps()
    assert [g[0] for g in gaps] == ["repro_torch.fit.epoch"]
    # the gap 10-60 has its middle, 35, in the epoch but not the sync
    tr2 = program.read(_Prof(BASE + [_ev("repro_torch.fit.sync", False,
                                         30.0, 40.0)] + PROGRAM[:1]),
                       UNIT_HOST, SPANS)
    assert [g[0] for g in tr2.idle_gaps()] == ["repro_torch.fit.sync"]
    # the program's phase takes the place of the benchmark's part, which
    # is shorter here (10-90 us against 1-99)
    tr3 = program.read(_Prof(BASE + [_ev("repro_torch.fit.unsup", False,
                                         1.0, 99.0)]),
                       UNIT_HOST, [[trace.Span("fit.unsup", 1.00001,
                                               1.00009)]])
    assert [g[0] for g in tr3.idle_gaps()] == ["repro_torch.fit.unsup"]
    assert [sp.label for sp in tr3.spans] == ["unit",
                                              "repro_torch.fit.unsup"]
    # read as the harness reads it, the annotation fills the gap as work
    assert trace.read(_Prof(BASE + PROGRAM), UNIT_HOST,
                      SPANS).idle_gaps() == []


def test_without_program_ranges_the_program_trace_is_the_harness_trace():
    a = program.read(_Prof(BASE), UNIT_HOST, SPANS)
    b = trace.read(_Prof(BASE), UNIT_HOST, SPANS)
    assert a == b


def _readings(units, tr):
    return Readings(cell=None, setup_s=1.0, window=(units[0]["t0"],
                                                     units[-1]["t1"]),
                    units=units, traced=units[:2], trace=tr)


@pytest.fixture
def fits(monkeypatch):
    """Three fake fits in the program's report ring, in units 1 s apart;
    the first two traced, their profiler ranges at 0 and 1e6 us.  Each
    loop (unsup, then sup) lasts 70 us, the untraced one's 100."""
    from repro_torch import obs
    ring = type(obs.FITS)(maxlen=obs.FITS.maxlen)
    monkeypatch.setattr(obs, "FITS", ring)
    units = []
    for i in range(3):
        t, end = 100.0 + i, (8e-5 if i < 2 else 1.1e-4)
        ring.append(obs.FitReport(
            t0=t + 1e-6, t1=t + end + 1e-5, pad=(t + 1e-6, t + 3e-6),
            h2d=(t + 3e-6, t + 4e-6), unsup=(t + 1e-5, t + 6e-5),
            sup=(t + 6e-5, t + end), captures=0,
            launches={"bcpnn_update": 2, "hc_softmax": 3}))
        units.append({"t0": t, "t1": t + 2e-4, "spans": []})
    # traced kernels: the update at 20-30 and 40-50 us of each unit, and
    # another at 50-80; the card's copy of the unsup range is no work
    device = []
    for i in range(2):
        o = i * 1e6
        device += [
            ("void (anonymous namespace)::trace_update_kernel<0, "
             "(anonymous namespace)::TraceTile<64, 128, 32, 4> >(float "
             "const*)", o + 20, o + 30),
            ("void (anonymous namespace)::trace_update_kernel<0, "
             "(anonymous namespace)::TraceTile<64, 128, 32, 4> >(float "
             "const*)", o + 40, o + 50),
            ("repro_torch.fit.unsup", o + 10, o + 80),
            ("k", o + 50, o + 80)]
    tr = trace.Trace(device=device,
                     units=[(i * 1e6, i * 1e6 + 200) for i in range(2)],
                     spans=[])
    return units, tr


def test_the_device_trace_readers_on_fake_fits(fits):
    units, tr = fits
    r = _readings(units, tr)
    # busy 50 us of each traced loop (10-80 us), against the untraced
    # loop's 100 us
    assert _reader("loop_idle_pct.fit")(r) == pytest.approx(50.0)
    assert _reader("bcpnn_update_us.fit")(r) == pytest.approx(10.0)
    assert _reader("pad_ms.fit")(r) == pytest.approx(2e-3)
    assert _reader("h2d_ms.fit")(r) == pytest.approx(1e-3)
    assert _reader("captures.fit")(r) == 0
    from repro_torch import obs
    obs.FITS[0] = dataclasses.replace(obs.FITS[0], launches={})
    assert _reader("bcpnn_update_us.fit")(r) is None  # 4 kernels, 2 counted


@pytest.mark.parametrize("name", ["pad_ms.fit", "h2d_ms.fit",
                                  "captures.fit", "loop_idle_pct.fit",
                                  "bcpnn_update_us.fit"])
def test_a_program_without_its_reports_reads_nothing(fits, monkeypatch,
                                                     name):
    import repro_torch
    units, tr = fits
    monkeypatch.delattr(repro_torch, "obs")
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    assert _reader(name)(_readings(units, tr)) is None


def test_a_unit_without_its_fit_report_reads_nothing(fits):
    units, tr = fits
    late = dict(units[1], t0=units[1]["t0"] + 5e-5)
    assert program.fit_reports([units[0], late]) is None
    assert _reader("pad_ms.fit")(_readings([units[0], late, units[2]],
                                           tr)) is None
    assert _reader("loop_idle_pct.fit")(_readings(units[:2], tr)) is None


def test_the_gaps_tool_runs_a_small_cell(tmp_path):
    import program_gaps
    import torch
    root = hb_small.make(tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = program_gaps.gaps(Bench(root, root / "hopper_bench"), "s-fit",
                                5, 2, 1, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert len(out["fit_s"]) == 2 and len(out["fit_s_untraced"]) == 1
    assert out["busy_s"] == 0.0 and out["loop_s"] > 0  # no card here
    assert sum(out["idle_s"].values()) == pytest.approx(out["window_s"])
