"""The port's autotune cache (``repro_torch.kernels.tuning``) held against
the JAX package's (``repro/kernels/tuning.py``) on the CPU, and the plan
merge the CUDA branches of the forward wrappers run.

* ``entry_key`` with the backend ``"cuda"`` equals JAX's string; a file
  written by either package's ``save_entries`` loads in the other's
  ``load_cache``, entries of both backends side by side, each package's
  ``lookup`` seeing its own backend's only.
* ``save_entries`` merges; a file of another version, a corrupt one and a
  missing one load as empty (the launcher's rule); a rewrite is read again
  (the memo is keyed by the file's mtime).
* ``plan`` consults the cache only when every plan keyword is 0, an
  explicit keyword wins, and keys a kernel does not take are dropped.
* A CPU tensor never reads the cache: the wrappers take the plain
  versions with the cache made unreadable.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.kernels import tuning as jtuning
from repro_torch.kernels import tuning

DIMS = dict(b=64, ni=8192, n_hc=32, n_mc=128)
GATHERED = dict(b=128, ni=1568, n_hc=32, n_mc=128, nact=128, mi=2)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv(tuning.ENV_CACHE, str(path))
    assert jtuning.ENV_CACHE == tuning.ENV_CACHE
    return path


def test_constants_and_default_path_equal_jax(monkeypatch):
    assert tuning.VERSION == jtuning.VERSION == 1
    monkeypatch.delenv(tuning.ENV_CACHE, raising=False)
    assert tuning.cache_path() == jtuning.cache_path()
    assert tuning.cache_path().endswith(
        os.path.join(".cache", "repro_bcpnn", "autotune.json"))


@pytest.mark.parametrize("kernel,dims", [
    ("bcpnn_fwd", DIMS), ("quant_fwd", DIMS),
    ("patchy_forward", GATHERED), ("quant_compact_forward", GATHERED),
    ("hc_softmax", dict(b=128, n_hc=32, n_mc=128))])
def test_entry_key_equals_jax(kernel, dims):
    want = jtuning.entry_key(kernel, backend="cuda", **dims)
    assert tuning.entry_key(kernel, backend="cuda", **dims) == want
    assert tuning.entry_key(kernel, **dims) == want  # "cuda" by default
    assert want.startswith(f"cuda|{kernel}|b=")


def test_a_file_of_either_package_loads_in_the_other(cache):
    jkey = jtuning.entry_key("bcpnn_fwd", backend="cpu", **DIMS)
    tkey = tuning.entry_key("bcpnn_fwd", **DIMS)
    jtuning.save_entries({jkey: {"block_b": 16, "block_j": 128}})
    tuning.save_entries({tkey: {"cluster": 2}})
    want = {jkey: {"block_b": 16, "block_j": 128}, tkey: {"cluster": 2}}
    assert tuning.load_cache() == want
    assert jtuning.load_cache() == want
    data = json.loads(cache.read_text())
    assert data == {"version": 1, "entries": want}
    # each package's lookup sees its own backend's entries only
    assert tuning.lookup("bcpnn_fwd", **DIMS) == {"cluster": 2}
    assert jtuning.lookup("bcpnn_fwd", backend="cpu", **DIMS) == {
        "block_b": 16, "block_j": 128}
    assert tuning.lookup("bcpnn_fwd", backend="cpu", **DIMS) == {}
    # and the other way: the port writes first, JAX merges into it
    os.remove(cache)
    tuning.save_entries({tkey: {"cluster": 3}})
    jtuning.save_entries({jkey: {"block_b": 8}})
    os.utime(cache, (3e9, 3e9))  # another mtime, whatever the clock's grain
    assert tuning.load_cache() == jtuning.load_cache() == {
        tkey: {"cluster": 3}, jkey: {"block_b": 8}}


def test_save_entries_merges_and_a_rewrite_is_read_again(cache):
    k1 = tuning.entry_key("quant_fwd", **DIMS)
    k2 = tuning.entry_key("quant_patchy_forward", **GATHERED)
    tuning.save_entries({k1: {"rows": 64, "cluster": 2}})
    assert tuning.lookup("quant_fwd", **DIMS) == {"rows": 64, "cluster": 2}
    tuning.save_entries({k2: {"rows": 128, "cluster": 4}})
    os.utime(cache, (1e9, 1e9))  # another mtime, whatever the clock's grain
    assert tuning.load_cache() == {k1: {"rows": 64, "cluster": 2},
                                   k2: {"rows": 128, "cluster": 4}}
    tuning.save_entries({k1: {"rows": 128, "cluster": 1}})
    os.utime(cache, (2e9, 2e9))
    assert tuning.lookup("quant_fwd", **DIMS) == {"rows": 128, "cluster": 1}
    assert tuning.lookup("quant_patchy_forward", **GATHERED) == {
        "rows": 128, "cluster": 4}


@pytest.mark.parametrize("content", [
    json.dumps({"version": 2, "entries": {
        "cuda|bcpnn_fwd|b=64,n_hc=32,n_mc=128,ni=8192": {"cluster": 2}}}),
    "{not json", ""])
def test_another_version_or_a_corrupt_file_gives_the_rule(cache, content):
    cache.write_text(content)
    assert tuning.load_cache() == {} == jtuning.load_cache()
    assert tuning.lookup("bcpnn_fwd", **DIMS) == {}
    assert tuning.plan("bcpnn_fwd", {"cluster": 0}, **DIMS) == {"cluster": 0}
    key = tuning.entry_key("bcpnn_fwd", **DIMS)
    tuning.save_entries({key: {"cluster": 4}})  # replaces what was there
    assert json.loads(cache.read_text()) == {
        "version": 1, "entries": {key: {"cluster": 4}}}


def test_a_missing_file_gives_the_rule(cache):
    assert not cache.exists()
    assert tuning.load_cache() == {}
    assert tuning.plan("quant_fwd", {"rows": 0, "cluster": 0}, **DIMS) == {
        "rows": 0, "cluster": 0}


def test_plan_merge(cache):
    tuning.save_entries({
        tuning.entry_key("quant_fwd", **DIMS): {"rows": 64, "cluster": 3,
                                                "block_b": 16},
        tuning.entry_key("bcpnn_fwd", **DIMS): {"rows": 64, "cluster": 2},
        tuning.entry_key("bcpnn_update", b=64, ni=8192, nj=4096): {
            "cluster": 2}})
    zero = {"rows": 0, "cluster": 0}
    # every keyword 0: the cache's plan, unknown keys dropped
    assert tuning.plan("quant_fwd", zero, **DIMS) == {"rows": 64,
                                                      "cluster": 3}
    # a float forward takes a cluster only: the stale "rows" is dropped
    assert tuning.plan("bcpnn_fwd", {"cluster": 0}, **DIMS) == {"cluster": 2}
    # an explicit keyword wins, and the cache is not consulted at all
    assert tuning.plan("quant_fwd", {"rows": 128, "cluster": 0},
                       **DIMS) == {"rows": 128, "cluster": 0}
    assert tuning.plan("bcpnn_fwd", {"cluster": 1}, **DIMS) == {"cluster": 1}
    # another shape has no entry: the rule
    assert tuning.plan("quant_fwd", zero, **{**DIMS, "b": 128}) == zero
    # kernels without plans take nothing from the cache
    assert tuning.plan("bcpnn_update", {}, b=64, ni=8192, nj=4096) == {}
    assert set(tuning._KERNEL_PLANS) == {
        "quant_fwd", "quant_patchy_forward", "quant_compact_forward",
        "bcpnn_fwd", "patchy_forward", "compact_forward", "bcpnn_update",
        "patchy_update", "compact_update", "hc_softmax"}


def test_cpu_tensors_never_read_the_cache(monkeypatch):
    from repro_torch.core.compact import build_table
    from repro_torch.kernels import ops, ref

    def unreadable():
        raise AssertionError("a CPU call read the autotune cache")

    monkeypatch.setattr(tuning, "load_cache", unreadable)
    rng = np.random.default_rng(0)
    b, hi, mi, hj, mj, nact = 5, 7, 3, 3, 10, 2
    ni, nj = hi * mi, hj * mj
    x = torch.from_numpy(rng.random((b, ni), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((ni, nj)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(nj).astype(np.float32))
    mask = torch.zeros((hi, hj))
    mask[:nact] = 1.0
    table = build_table(mask, nact)
    w_q = torch.from_numpy(rng.integers(-127, 128, (ni, nj), dtype=np.int8))
    scale = torch.full((hj,), 0.01)
    got = ops.bcpnn_fwd(x, w, bias, hj, mj)
    assert torch.equal(got, ref.ref_bcpnn_fwd(x, w, bias, hj, mj))
    ops.patchy_forward(x, w, bias, table, mi, hj, mj)
    got = ops.quant_fwd(x, w_q, bias, scale, hj, mj)
    assert torch.equal(got, ref.ref_quant_fwd(x, w_q, bias, scale, hj, mj))
    ops.quant_patchy_forward(x, w_q, bias, scale, table, mi, hj, mj)
