"""On the card, at each cell's own size: a short run of the cell is
correct and its control (the reference in TF32 put in the program's
place) is not.  Marked ``gpu``: without a card every test skips.

    PYTHONPATH=src python -m pytest -q -m gpu \\
        hopper_bench/tests/test_hb_card.py
"""
from __future__ import annotations

import contextlib
import io
import json
import time

import hb_small
import pytest

pytestmark = pytest.mark.gpu

CELLS = [w["name"] for w in json.loads(
    (hb_small.REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cells run on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_and_its_control_is_not(card, cell):
    from hbench.bench import Bench, run_cell
    with contextlib.redirect_stderr(io.StringIO()):
        r = run_cell(Bench(hb_small.REPO), cell, 2**31 + 77, 2.0, False,
                     t_start=time.perf_counter(), device="cuda",
                     control=True)
    assert r["correct"] is True, r["checks"]
    assert r["control"]["correct"] is False, r["control"]
