"""The yardstick's counts against sums done by hand, and the metric
readers against hand-made traces and spans."""
from __future__ import annotations

import json

import hb_small  # noqa: F401  (puts the benchmark on the path)
import pytest
from counts import bcpnn, peaks
from hbench.bench import BENCH_DIR, Bench, Cell, Readings, _load_module
from hbench.trace import Span, Trace


def test_peaks_are_the_data_sheet_and_the_port_agrees():
    from repro_torch.launch import roofline
    assert peaks.PEAK_BYTES_S == 3.35e12 == roofline.PEAK_BYTES_S
    assert peaks.PEAK_TF32_FLOP_S == 495e12 == roofline.PEAK_TF32_FLOP_S
    assert peaks.PEAK_FP32_FLOP_S == 67e12 == roofline.PEAK_FP32_FLOP_S
    assert peaks.PEAK_BF16_FLOP_S == 989e12 == roofline.PEAK_BF16_FLOP_S
    assert peaks.PEAK_INT8_OPS_S == 1979e12 == roofline.PEAK_INT8_OPS_S


def test_update_traffic_at_both_shapes_by_hand():
    t = bcpnn.update_traffic(64, 8192, 4096, 4096, 32)
    assert t["bytes"] == (12 * 8192 * 4096 + 4 * 64 * (8192 + 4096)
                          + 4 * (8192 + 4096) + 4 * 4096 * 32)
    assert t["flops"] == 2 * 64 * 8192 * 4096 + 6 * 8192 * 4096
    assert bcpnn.bound_s(t) == pytest.approx(121.31e-6, rel=1e-3)
    t1 = bcpnn.update_traffic(128, 1568, 4096, 784, 32)
    assert bcpnn.bound_s(t1) == pytest.approx(23.91e-6, rel=1e-3)


def test_fit_flops_by_hand():
    assert bcpnn.fit_flops(546, 100, 8192, 4096, 2) == (
        100 * 4 * 546 * 8192 * 4096 + 2 * 546 * 8192 * 4096
        + 2 * 546 * 4096 * 2)


def _cell(name):
    return Bench(hb_small.REPO).cell(name)


def _reader(name):
    return _load_module(BENCH_DIR / "metrics" / f"{name}.py", "t_").read


def _trace(events, units, spans=()):
    return Trace(device=list(events), units=list(units), spans=list(spans))


def test_update_roofline_reads_its_kernels_and_refuses_a_short_count():
    cell = _cell("m3-fit")
    unit = {"unsup_steps": 3, "sup_steps": 1}
    ev = [("void trace_update_kernel<0, 1>(float*)", 100.0 * i,
           100.0 * i + 200.0) for i in range(4)]
    ev.append(("ampere_sgemm_128x64_nn", 900.0, 950.0))
    r = Readings(cell=cell, setup_s=1.0, window=(0.0, 1.0), units=[unit],
                 traced=[unit], trace=_trace(ev, [(0.0, 1000.0)]))
    hidden = bcpnn.bound_s(bcpnn.update_traffic(64, 8192, 4096, 4096, 32))
    readout = bcpnn.bound_s(bcpnn.update_traffic(64, 4096, 2, 32, 1))
    want = 100.0 * (3 * hidden + readout) / 800e-6
    assert _reader("bcpnn_update_roofline.fit")(r) == pytest.approx(want)
    r.trace = _trace(ev[1:], [(0.0, 1000.0)])
    assert _reader("bcpnn_update_roofline.fit")(r) is None
    r.trace = None
    assert _reader("bcpnn_update_roofline.fit")(r) is None


def test_mfu_and_idle_readers_by_hand():
    """mfu: the window's FLOPs over its host time; idle: a traced fit's
    device busy time against the untraced fits' host time a fit."""
    cell = _cell("m3-fit")
    traced = {"flops": 4.95e9, "t0": 0.0, "t1": 0.02}
    rest = [{"flops": 4.95e9, "t0": 0.02 + 0.01 * i, "t1": 0.03 + 0.01 * i}
            for i in range(3)]
    ev = [("void trace_update_kernel<0, 1>(float*)", 0.0, 4000.0),
          ("ampere_sgemm_128x64_nn", 3000.0, 6000.0),
          ("Memcpy HtoD (Pageable -> Device)", 15000.0, 16000.0)]
    r = Readings(cell=cell, setup_s=2.0, window=(0.0, 0.05),
                 units=[traced] + rest, traced=[traced],
                 trace=_trace(ev, [(0.0, 20000.0)]))
    assert _reader("mfu_pct.fit")(r) == pytest.approx(
        100.0 * 4 * 4.95e9 / 0.05 / 495e12)
    # 7 ms busy in the traced fit, 10 ms a fit untraced
    assert _reader("idle_pct.fit")(r) == pytest.approx(30.0)
    assert _reader("setup_s")(r) == 2.0
    r.units = [traced]
    assert _reader("idle_pct.fit")(r) is None
    r.units, r.trace = [traced] + rest, _trace([], [(0.0, 20000.0)])
    assert _reader("idle_pct.fit")(r) is None


def test_fit_span_readers_by_hand():
    cell = _cell("m1-fit")
    units = [{"fit_s": 0.7, "unsup_s": 0.5, "sup_s": 0.05, "images": 360000,
              "unsup_steps": 2345, "t0": 0.0, "t1": 0.7},
             {"fit_s": 0.6, "unsup_s": 0.45, "sup_s": 0.05, "images": 360000,
              "unsup_steps": 2345, "t0": 0.7, "t1": 1.3}]
    r = Readings(cell=cell, setup_s=1.0, window=(0.0, 1.5), units=units,
                 traced=[], trace=None)
    assert _reader("prep_ms.fit")(r) == pytest.approx(125.0)
    assert _reader("unsup_step_us.fit")(r) == pytest.approx(
        1e6 * 0.95 / 4690)
    assert _reader("train_img_per_s")(r) == pytest.approx(720000 / 1.5)
    assert _reader("idle_pct.fit")(r) is None


def test_trace_busy_gaps_and_labels():
    spans = [Span("unit", 0.0, 100.0), Span("fit.prep", 0.0, 30.0),
             Span("fit.unsup", 30.0, 90.0)]
    ev = [("k", 10.0, 20.0), ("k", 15.0, 25.0), ("copy", 40.0, 80.0),
          ("k", 95.0, 120.0)]
    tr = _trace(ev, [(0.0, 100.0)], spans)
    assert tr.busy_intervals() == [(10.0, 25.0), (40.0, 80.0), (95.0, 100.0)]
    assert tr.busy_s == pytest.approx(60e-6)
    assert tr.window_s == pytest.approx(100e-6)
    gaps = tr.idle_gaps()
    assert [g[0] for g in gaps] == ["fit.prep", "fit.unsup", "fit.unsup"]
    assert [round(g[1] * 1e6, 6) for g in gaps] == [10.0, 15.0, 15.0]
    assert tr.longest_gaps(2)[0][1] == pytest.approx(15e-6)
    assert tr.top_ops(1) == [["k", pytest.approx(45e-6)]]
    assert tr.label_at(150.0) == "between"


def test_workload_files_hold_limits_for_every_number():
    for w in json.loads((hb_small.REPO / "BENCHMARK.json").read_text())[
            "workloads"]:
        wl = json.loads((BENCH_DIR / "workloads" / f"{w['name']}.json")
                        .read_text())
        assert wl["trace_units"] >= 1
        kind = _cell(w["name"]).traffic["kind"]
        assert kind == "fit" and set(wl["limits"]) == {"start", "end"}
        assert isinstance(_cell(w["name"]), Cell)
