"""The port's dry run in fake mode: ``python -m repro_torch.launch.dryrun``
in processes of its own (each rank 0 of a fake default group of 256 or 512
ranks, every step on fake tensors), at smoke size with a batch of 32 and 32
tokens: the train step of all ten architectures on (16, 16); every shape
of a dense, an MoE and an SSM architecture on (16, 16), and of the SSM
architecture on (2, 16, 16).
Each cell is ``ok`` (``long_500k`` skipped with JAX's reason where the
architecture is full-attention), its arguments the bytes its placements
give (``holdings``, checked inside the cell), its peak at least its
arguments, and it counts FLOPs and collective bytes and prices them
(``bytes``, the three time terms, ``bottleneck`` the largest); each
record lists the one JAX key it lacks, the compiled code's size.
``scripts/make_tables.py``, the JAX package's table tool, renders the
records.  The (data, model)-split decode of a sequence-split
cache that the production decode cells take is held against one rank in
``test_torch_dryrun_c.py``."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.configs import ARCHS

ROOT = Path(__file__).resolve().parent.parent
ARCH_IDS = sorted(ARCHS)
ALL_SHAPES = ("dense", "qwen1.5-0.5b"), ("moe", "qwen3-moe-30b-a3b"), (
    "ssm", "falcon-mamba-7b")
MULTI_POD = "falcon-mamba-7b"  # every shape of it on the 512-rank group


def _dryrun(out: Path, *args: str) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--smoke",
         "--batch", "32", "--seq", "32", "--out", str(out), *args],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                        "CUDA_VISIBLE_DEVICES": ""})


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    half = len(ARCH_IDS) // 2
    procs = [_dryrun(out, "--arch", ",".join(ARCH_IDS[:half]), "--shape",
                     "train_4k"),
             _dryrun(out, "--arch", ",".join(ARCH_IDS[half:]), "--shape",
                     "train_4k"),
             # every shape: --arch without --shape (--all is every arch)
             _dryrun(out, "--arch", ",".join(a for _, a in ALL_SHAPES)),
             _dryrun(out, "--multi-pod", "--arch", MULTI_POD)]
    for p in procs:
        log = p.communicate(timeout=600)[0]
        assert p.returncode == 0, log[-3000:]
    return {f.stem: json.loads(f.read_text()) for f in out.glob("*.json")}


def _check_ok(rec):
    assert rec["status"] == "ok", rec.get("error")
    mem, roof = rec["memory"], rec["roofline"]
    assert mem["argument_size_in_bytes"] == sum(rec["arguments"].values())
    assert mem["peak_memory_in_bytes"] >= mem["argument_size_in_bytes"] > 0
    assert mem["temp_size_in_bytes"] == (mem["peak_memory_in_bytes"]
                                         - mem["argument_size_in_bytes"])
    assert roof["flops"] > 0 and roof["coll_bytes"] > 0
    assert roof["coll_bytes"] == pytest.approx(sum(
        roof["coll_detail"].values()))
    assert rec["model_flops_global"] > 0
    assert roof["useful_ratio"] == pytest.approx(
        rec["model_flops_global"] / rec["n_chips"] / roof["flops"])
    assert rec["fits_80GB"] == (mem["peak_memory_in_bytes"] <= 80 * 2**30)
    assert "H100 80GB HBM3" in rec["fits_on"]
    assert set(rec["lacks"]) == {"memory.generated_code_size_in_bytes"}
    for key in rec["lacks"]:
        section, name = key.split(".")
        assert name not in rec.get(section, {})
    terms = {"compute": roof["compute_s"], "memory": roof["memory_s"],
             "collective": roof["collective_s"]}
    assert roof["bytes"] > 0 and all(t > 0 for t in terms.values())
    assert terms[roof["bottleneck"]] == max(terms.values())
    assert sum(roof["flops_by_dtype"].values()) == roof["flops"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_cell_of_every_architecture(records, arch):
    rec = records[f"{arch}_train_4k_16x16_b32_s32_smoke"]
    _check_ok(rec)
    assert rec["n_chips"] == 256 and rec["kind"] == "train"
    assert set(rec["arguments"]) == {"params", "mu", "nu", "step", "batch"}
    assert rec["arguments"]["mu"] == rec["arguments"]["nu"]


@pytest.mark.parametrize("kind,arch,mesh,chips", [
    (k, a, "16x16", 256) for k, a in ALL_SHAPES] + [
    ("ssm", MULTI_POD, "2x16x16", 512)])
def test_every_shape_of_a_dense_moe_and_ssm_arch(records, kind, arch, mesh,
                                                 chips):
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        rec = records[f"{arch}_{shape}_{mesh}_b32_s32_smoke"]
        if kind != "ssm" and shape == "long_500k":
            assert rec["status"] == "skipped"
            assert rec["reason"].startswith("full-attention arch")
            continue
        _check_ok(rec)
        assert rec["n_chips"] == chips
        want = {"train_4k": {"params", "mu", "nu", "step", "batch"},
                "prefill_32k": {"params", "batch"}}.get(
            shape, {"params", "cache", "tokens"})
        assert set(rec["arguments"]) == want, shape


def test_make_tables_renders_the_records(records, tmp_path):
    """The JAX package's ``scripts/make_tables.py``, imported by path and
    unedited, renders one row per record of the port's dry run."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_tables", ROOT / "scripts" / "make_tables.py")
    tables = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tables)
    for name, rec in records.items():
        (tmp_path / f"{name}.json").write_text(json.dumps(rec))
    rows = tables.fmt(str(tmp_path)).splitlines()
    assert len(rows) == len(records)
    ok = [r for r in records.values() if r["status"] == "ok"]
    assert sum(" | FAILED | " in row for row in rows) == 0
    assert sum(" | skipped | " in row for row in rows) == len(records) - len(ok)
    for r in ok:
        rf = r["roofline"]
        row = (f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
               f"{rf['bottleneck']} | {rf['compute_s'] * 1e3:.1f} | ")
        assert any(line.startswith(row) for line in rows), row
