"""What the benchmark may import: neither JAX nor the JAX package anywhere
(top-level names compared whole: ``repro_torch`` is not ``repro``), and
nothing of the program in the reference."""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import hb_small
import pytest

BENCH = hb_small.BENCH
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(p for p in BENCH.rglob("*.py")
                 if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not set(_top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    names = set(_top_level_imports(path))
    assert names <= {"__future__", "contextlib", "dataclasses", "typing",
                     "torch"}, names


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    """A small cell run end to end in a fresh process, then the same look
    at ``sys.modules`` that ``run.py`` makes once its window has closed."""
    root = hb_small.make(tmp_path)
    code = (
        "import sys, time, contextlib, io\n"
        f"sys.path[:0] = [{str(BENCH)!r}, {str(hb_small.REPO / 'src')!r}]\n"
        "from hbench.bench import Bench, run_cell\n"
        "from run import forbidden_loaded\n"
        "with contextlib.redirect_stderr(io.StringIO()):\n"
        f"    r = run_cell(Bench({str(root)!r},"
        f" {str(root / 'hopper_bench')!r}),"
        " 's-fit', 3, 0.2, False, t_start=time.perf_counter(), device='cpu')\n"
        "print(r['correct'], forbidden_loaded())\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[-2] == "True []"


def test_forbidden_loaded_compares_whole_top_level_names(monkeypatch):
    import run
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    monkeypatch.setattr(sys, "modules", {k: v for k, v in sys.modules.items()
                                         if k.split(".")[0] not in FORBIDDEN})
    assert run.forbidden_loaded() == []
    sys.modules["repro.core"] = sys
    assert run.forbidden_loaded() == ["repro"]
