"""The manifest against the benchmark's contract, and the harness finding
cells, configurations and metrics by name from files alone."""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import re

import hb_small
import pytest

REPO = hb_small.REPO
BENCH = hb_small.BENCH
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_manifest_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["hopper_bench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = [e["name"] for sec in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in MANIFEST[sec]]
    for n in names:
        assert NAME.match(n), n
    for sec in ("configs", "workloads"):
        assert len({e["name"] for e in MANIFEST[sec]}) == len(MANIFEST[sec])
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for e in MANIFEST["configs"] + MANIFEST["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]


def test_every_metric_is_well_formed_and_has_a_reader():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in {"host_clock", "device_trace"}
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in SOURCES
        moved = e2e[m["moves"]].get("workloads", sorted(cells))
        assert set(m["workloads"]) <= set(moved), m["name"]
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in {"lower", "higher"}
        assert set(m.get("workloads", cells)) <= cells
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in MANIFEST["workloads"]:
        e2e = [m["name"] for m in MANIFEST["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        layer = [m for m in MANIFEST["per_layer"]
                 if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer, w["name"]


def test_every_cell_config_and_traffic_has_its_files():
    used = set()
    for w in MANIFEST["workloads"]:
        assert w["chips"] == 1
        assert (BENCH / "workloads" / f"{w['name']}.json").is_file()
        traffic = json.loads(
            (BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "kinds" / f"{traffic['kind']}.py").is_file()
        used.add(w["config"])
    for c in MANIFEST["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("hopper_bench/configs/")
        assert (REPO / c["file"]).is_file() and c["reduced"] == []


@pytest.mark.parametrize("name,preset", [("model1-mnist", "MODEL1_MNIST"),
                                         ("model3-breast", "MODEL3_BREAST")])
def test_configs_are_the_table1_presets_at_published_widths(name, preset):
    from repro_torch.configs import bcpnn_models
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    assert cfg["network"] == dataclasses.asdict(getattr(bcpnn_models,
                                                        preset))
    n_train, n_test, side, classes = {
        "model1-mnist": (60000, 10000, 28, 10),
        "model3-breast": (546, 156, 64, 2)}[name]
    d = cfg["data"]
    assert (d["n_train"], d["n_test"], d["side"], d["n_classes"]) == (
        n_train, n_test, side, classes)
    assert d["side"] ** 2 == cfg["network"]["input_hc"]


def test_a_cell_config_and_metric_added_as_files_are_found(tmp_path):
    """A later change adds a cell, a configuration and a per-layer metric
    by adding files and manifest entries only."""
    root = hb_small.make(tmp_path)
    bench = root / "hopper_bench"
    cfg = json.loads((bench / "configs" / "small.json").read_text())
    cfg["network"]["hidden_mc"] = 8
    (bench / "configs" / "small-b.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "fit-small-b.json").write_text(json.dumps(
        {"kind": "fit", "epochs": 1, "batch": 16}))
    (bench / "workloads" / "sb-fit.json").write_text(json.dumps(
        {"limits": {"start": 1e-3, "end": 1e-3}, "trace_units": 1}))
    (bench / "metrics" / "fits_seen.fit.py").write_text(
        "def read(r):\n    return float(len(r.units))\n")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({
        "name": "small-b", "source": "https://arxiv.org/abs/2503.01561",
        "file": "hopper_bench/configs/small-b.json", "reduced": [],
        "why": "test"})
    manifest["workloads"].append({"name": "sb-fit", "config": "small-b",
                                  "traffic": "fit-small-b", "chips": 1,
                                  "why": "test"})
    manifest["per_layer"].append({
        "name": "fits_seen.fit", "unit": "fits", "better": "higher",
        "source": "program_counter", "layer": "trainer (core/trainer.py)",
        "moves": "train_img_per_s", "workloads": ["sb-fit"]})
    for m in manifest["end_to_end"]:
        if m["name"] == "train_img_per_s":
            m["workloads"].append("sb-fit")
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    with contextlib.redirect_stderr(io.StringIO()):
        traced = hb_small.run(root, "sb-fit", trace=True, seconds=0.2)
        plain = hb_small.run(root, "sb-fit", seconds=0.2)
    assert traced["correct"] and plain["correct"]
    assert traced["metrics"]["fits_seen.fit"]["value"] == traced["attempted"]
    assert set(plain["metrics"]) == {"train_img_per_s", "setup_s"}
