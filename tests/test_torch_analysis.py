"""Tests for ``repro_torch.analysis``: the port's invariant linter, its CUDA
kernel audit and its runtime contracts (mirrors ``tests/test_analysis.py``).

* Rules: each port rule fires on a seeded bad snippet, at its ``# BUG``
  line and nowhere else, and stays quiet on the good idiom beside it; the
  CLI exits 1 on the bad snippet with its file:line anchor.
* Engine: suppressions need a reason and cover their line and the next;
  the baseline is line-free; the reasoned suppression of
  ``infer-pack-mutation`` in ``core/graphs.py::_own_pack`` is honoured.
* ``python -m repro_torch.analysis --strict`` is clean over the port.
* The CUDA audit passes on the committed sources and fails on mutated
  copies under ``tmp_path``: a 16-bit tensor-core accumulator, an
  unguarded TMA path; the kernel wrappers keep their logical shapes on
  the hostile geometry (plain versions, on the CPU).
* The three runtime contracts hold on the CPU.
"""
from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis import plans
from repro_torch.analysis.findings import (Finding, load_baseline,
                                           parse_suppressions, save_baseline,
                                           split_baselined)
from repro_torch.analysis.lint import all_rules, lint_paths

ROOT = Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.lint

# rule -> (directory the snippet lives in, bad snippet, good snippet); the
# bad snippet's offending line carries "# BUG"
CASES = {
    "pad-fill-literal": ("", """\
import torch
def masked(scores, mask):
    return scores.masked_fill(~mask, float("-inf"))  # BUG
""", """\
import torch
from repro_torch.models.attention import neg_fill
def masked(scores, mask):
    return scores.masked_fill(~mask, neg_fill(scores.dtype))
"""),
    "serve-lock": ("", """\
import threading
class Meter:
    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0
    def bump(self):
        with self._lock:
            self._n += 1
    def reset(self):
        self._n = 0  # BUG
""", """\
import threading
class Meter:
    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0
    def bump(self):
        with self._lock:
            self._n += 1
    def reset(self):
        with self._lock:
            self._n = 0
"""),
    "serve-except": ("serve", """\
class Engine:
    def run(self, group, infer):
        try:
            infer(group)
        except Exception:  # BUG
            pass
""", """\
class Engine:
    def run(self, group, infer):
        try:
            infer(group)
        except Exception as e:
            for r in group:
                r.error = e
                r.done.set()
"""),
    "learning-dtype": ("core", """\
import torch
def learn(proj):
    return proj.pij.to(torch.bfloat16)  # BUG
""", """\
import torch
def pack_projection(proj, spec):
    return proj.w.to(torch.bfloat16)
def learn(proj):
    return proj.pij.to(torch.float32)
"""),
    "infer-pack-mutation": ("", """\
def fold(state, spec, w):
    pack = pack_projection(state, spec)
    pack.w = w  # BUG
    return pack
""", """\
def fold(state, spec, w):
    return pack_projection(state.replace(w=w), spec)
"""),
}

# more spellings each rule must catch, one offending line each
MORE_BAD = {
    "pad-fill-literal": ["x = -torch.inf", "x = -1e30", "x = -math.inf",
                         "x = -float('inf')"],
    "learning-dtype": ["y = x.half()", "y = x.bfloat16()",
                       "y = torch.zeros(3, dtype=torch.int8)",
                       "y = x.to(torch.float16)"],
}


def _write(tmp_path: Path, sub: str, text: str) -> Path:
    d = tmp_path / sub if sub else tmp_path
    d.mkdir(parents=True, exist_ok=True)
    p = d / "snippet.py"
    p.write_text(text)
    return p


def _bug_line(text: str) -> int:
    return next(i for i, line in enumerate(text.splitlines(), start=1)
                if "# BUG" in line)


def test_cases_cover_every_rule():
    assert sorted(CASES) == sorted(all_rules())


@pytest.mark.parametrize("rule", sorted(CASES))
def test_rule_fires_on_bad_snippet_only(tmp_path, rule):
    sub, bad, good = CASES[rule]
    path = _write(tmp_path / "bad", sub, bad)
    found = lint_paths([path], tmp_path)
    assert [(f.rule, f.line) for f in found] == [(rule, _bug_line(bad))], \
        [f.format() for f in found]
    assert found[0].severity == "error"
    path = _write(tmp_path / "good", sub, good)
    assert lint_paths([path], tmp_path) == []


@pytest.mark.parametrize("rule,line", [(r, x) for r, xs in MORE_BAD.items()
                                       for x in xs])
def test_rule_catches_other_spellings(tmp_path, rule, line):
    sub = CASES[rule][0]
    path = _write(tmp_path, sub, "import math\nimport torch\n" + line + "\n")
    assert [(f.rule, f.line) for f in lint_paths([path], tmp_path)] == [
        (rule, 3)]


def test_scoped_rules_stay_out_of_other_directories(tmp_path):
    for rule in ("serve-except", "learning-dtype"):
        path = _write(tmp_path / rule, "other", CASES[rule][1])
        assert lint_paths([path], tmp_path) == []


@pytest.mark.parametrize("rule", sorted(CASES))
def test_cli_exits_nonzero_with_file_line_anchor(tmp_path, rule):
    sub, bad, _ = CASES[rule]
    path = _write(tmp_path, sub, bad)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--strict",
         "--no-baseline", str(path)],
        capture_output=True, text=True, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert f":{_bug_line(bad)}: error[{rule}]" in proc.stdout


def test_port_scan_is_strict_clean():
    from repro_torch.analysis.__main__ import default_paths, main
    paths = default_paths(ROOT)
    assert ROOT / "src" / "repro_torch" in paths
    assert ROOT / "chip_smoke.py" in paths
    assert any(p.name.startswith("test_torch_") for p in paths)
    assert main(["--strict"]) == 0


def test_suppression_needs_a_reason(tmp_path):
    # the marker is built by concatenation, so no line of this file reads
    # as a reasonless suppression
    path = _write(tmp_path, "", "FILL = -1e30  # repro" +
                  ": suppress[pad-fill-literal]\n")
    assert sorted(f.rule for f in lint_paths([path], tmp_path)) == [
        "pad-fill-literal", "suppress-needs-reason"]
    path.write_text("A = -1e30  # repro" + ": suppress[pad-fill-literal] "
                    "— the canonical fill\n# repro" +
                    ": suppress[pad-fill-literal] — the line below\n"
                    "B = -1e30\nC = -1e30  # repro" +
                    ": suppress[serve-lock] — another rule\n")
    assert [(f.rule, f.line) for f in lint_paths([path], tmp_path)] == [
        ("pad-fill-literal", 4)]
    (s,) = parse_suppressions(["x = 1  # repro" + ": suppress[a-rule] -- why"])
    assert s.rules == ("a-rule",) and s.reason == "why"


def test_baseline_is_line_free_and_absorbs_one_instance(tmp_path):
    f1 = Finding("r", "a.py", 10, "m", snippet="x = -1e30")
    bl = tmp_path / "bl.json"
    save_baseline(bl, [f1])
    shifted = Finding("r", "a.py", 15, "m", snippet="x = -1e30")
    twin = Finding("r", "a.py", 30, "m", snippet="x = -1e30")
    new, old = split_baselined([shifted, twin], load_baseline(bl))
    assert old == [shifted] and new == [twin]


def test_own_pack_suppression_is_honoured():
    """``core/graphs.py::_own_pack`` builds an ``InferPack`` outside
    ``pack_projection`` (a copy of a pack made at a fold boundary), under
    a reasoned suppression: raw, the rule finds it; honoured, nothing."""
    graphs = ROOT / "src" / "repro_torch" / "core" / "graphs.py"
    raw = lint_paths([graphs], ROOT, rule_ids=["infer-pack-mutation"],
                     honor_suppressions=False)
    assert len(raw) == 1 and raw[0].rule == "infer-pack-mutation"
    assert "return InferPack(" in raw[0].snippet
    assert lint_paths([graphs], ROOT, rule_ids=["infer-pack-mutation"]) == []


# ------------------------------------------------------------- CUDA audit --

def test_cuda_audit_passes_on_the_committed_sources():
    assert plans.check_accumulators() == []
    assert plans.check_tma_guards() == []


def _csrc_copy(tmp_path: Path) -> Path:
    dst = tmp_path / "csrc"
    shutil.copytree(plans.CSRC, dst)
    return dst


def _mutate(path: Path, old: str, new: str) -> None:
    text = path.read_text()
    assert text.count(old) == 1, old
    path.write_text(text.replace(old, new))


def test_cuda_audit_catches_a_16_bit_accumulator(tmp_path):
    csrc = _csrc_copy(tmp_path)
    _mutate(csrc / "bcpnn.cu", "m64n32k8.f32.tf32.tf32", "m64n32k8.f16.tf32"
            ".tf32")
    problems = plans.check_accumulators(csrc)
    assert len(problems) == 1 and "accumulates in f16" in problems[0]
    assert problems[0].startswith("bcpnn.cu:")
    csrc = _csrc_copy(tmp_path / "b")
    _mutate(csrc / "quant.cu", "m64n8k32.s32.s8.s8", "m64n8k32.f32.s8.s8")
    assert len(plans.check_accumulators(csrc)) == 1


@pytest.mark.parametrize("source,old,new,operand", [
    # the dense forward's guard loses its weight half
    ("bcpnn.cu", "if (x16 && w16) {", "if (x16) {", "w"),
    # the compact forward's weight TMA without any guard
    ("bcpnn.cu", "if (L == kCompact && w16) wcopy = kCopyTma;",
     "if (L == kCompact) wcopy = kCopyTma;", "w"),
    # the int8 forward's x by TMA whatever its address
    ("quant.cu", "sh.Ni % 4 == 0 && xa % 16 == 0 ? kCopyTma",
     "sh.Ni % 4 == 0 ? kCopyTma", "x"),
    # the update's bulk pij copies on any address
    ("bcpnn.cu", "if (cols4 && aligned16(pij) && aligned16(pij_out) && "
     "aligned16(w_out)) vec |= kVecP;", "vec |= kVecP;", "pij"),
])
def test_cuda_audit_catches_an_unguarded_tma_path(tmp_path, source, old,
                                                  new, operand):
    csrc = _csrc_copy(tmp_path)
    _mutate(csrc / source, old, new)
    problems = plans.check_tma_guards(csrc)
    assert len(problems) == 1, problems
    assert problems[0].startswith(f"{source}:")
    assert f"guard of {operand}" in problems[0] or "its rows" in problems[0]


def test_cuda_audit_reads_through_comments(tmp_path):
    csrc = _csrc_copy(tmp_path)
    with open(csrc / "common.cuh", "a") as f:
        f.write("\n// asm(\"mma.sync.aligned.m16n8k8.row.col.f16.f16.f16.f16\")"
                "\n/* xcopy = kCopyTma; */\n")
    assert plans.check_accumulators(csrc) == []
    assert plans.check_tma_guards(csrc) == []


def test_wrappers_keep_logical_shapes_on_the_hostile_geometry():
    assert plans.check_output_shapes("cpu") == []


# -------------------------------------------------------------- contracts --

@pytest.mark.parametrize("name", ["quarantine-rollback",
                                  "router-exactly-once", "replica-merge",
                                  "cuda-plans"])
def test_contract_holds(name):
    from repro_torch.analysis.contracts import run_contracts
    assert run_contracts([name]) == {name: []}


def test_cli_runs_the_contracts():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--strict",
         "--contracts", "replica-merge,cuda-plans"],
        capture_output=True, text=True, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "analysis clean (lint + contracts)" in proc.stdout
    bad = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--contracts",
         "no-such-check"], capture_output=True, text=True, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        timeout=300)
    assert bad.returncode == 2
