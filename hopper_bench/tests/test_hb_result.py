"""The result a run prints: its keys, its metrics, the checks last, and no
result without a card."""
from __future__ import annotations

import contextlib
import io
import json
import shutil
import subprocess
import sys

import hb_small
import pytest

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
def test_the_result_has_the_five_keys_and_checks_last(tmp_path, trace):
    cell = "s-fit"
    root = hb_small.make(tmp_path)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        r = hb_small.run(root, cell, trace=trace, seconds=0.3)
    assert list(r)[:5] == KEYS and list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    section = manifest["per_layer" if trace else "end_to_end"]
    want = {m["name"] for m in section
            if cell in m.get("workloads", [cell])}
    # a CPU run has no device trace: those metrics are left out
    assert set(r["metrics"]) <= want
    if not trace:
        assert set(r["metrics"]) == want
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        r["device"])
    assert ("breakdown" in r) == trace
    json.loads(json.dumps(r, allow_nan=False))
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]


def test_run_py_prints_no_result_without_a_card(tmp_path):
    """Here there is no card: exit 2, nothing on stdout.  The same holds
    in a directory that holds only the manifest and the benchmark."""
    for root in (hb_small.REPO, tmp_path):
        if root == tmp_path:
            shutil.copy(hb_small.REPO / "BENCHMARK.json", tmp_path)
            shutil.copytree(hb_small.BENCH, tmp_path / "hopper_bench",
                            ignore=shutil.ignore_patterns("__pycache__"))
        out = subprocess.run(
            [sys.executable, "hopper_bench/run.py", "--workload", "m3-fit",
             "--seed", "2147483700", "--seconds", "1", "--trace", "0"],
            cwd=root, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0 and out.stdout == ""
