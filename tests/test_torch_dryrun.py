"""The port's dry run (``repro_torch.launch.dryrun``) held against the JAX
package's (``repro/launch/dryrun.py``), on the CPU.

* Holdings: each cell's bytes a rank holds (``holdings``: parameters,
  ``mu``, ``nu``, ``step`` and the batch to train; parameters and the
  batch to prefill; parameters, cache and tokens to decode) equal the sum
  of ``NamedSharding(AbstractMesh(shape, axes), spec).shard_shape(leaf)``
  times the itemsize over JAX's ``input_specs`` under its
  ``input_shardings`` and JAX's ``rules_for``: exactly, for the ten
  architectures at their published widths, the four shapes, both
  production meshes and every variant.
* ``cell_skip_reason``, ``rules_for``, ``VARIANTS`` and ``CFG_VARIANTS``
  equal JAX's.  The JAX module sets a 512-device ``XLA_FLAGS`` when it is
  imported, so it is read in a subprocess of its own (``_jax_dryrun``).
* ``model_flops`` and ``param_count_active`` equal JAX's
  (``repro/launch/roofline.py``) exactly for every architecture and
  shape.
* The fake-mode cells (train, prefill and decode at smoke size) are in
  ``test_torch_dryrun_b.py``.
"""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import ARCHS, SHAPES, get_config
from repro.distributed import sharding as jsh
from repro.launch import roofline as jroof
from repro.launch import steps as jsteps
from repro_torch.configs import SHAPES as T_SHAPES
from repro_torch.configs import get_config as t_get_config
from repro_torch.distributed.sharding import Mesh, rank_devices
from repro_torch.launch import dryrun
from repro_torch.launch import roofline

ROOT = Path(__file__).resolve().parent.parent
ARCH_IDS = sorted(ARCHS)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
VARIANT_IDS = ["", "sp", "replicated", "colshard", "ssmchunk"]

# Read in a fresh interpreter: the JAX dry run's tables and rules for
# every (arch, shape, mesh, variant), on AbstractMeshes (no devices).
_PROBE = r"""
import json, sys
from jax.sharding import AbstractMesh
from repro.configs import ARCHS, SHAPES, get_config
from repro.launch import dryrun as d
meshes = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
def enc(v):
    return list(v) if isinstance(v, tuple) else v
out = {"VARIANTS": d.VARIANTS, "CFG_VARIANTS": sorted(d.CFG_VARIANTS),
       "ssm_chunk": {a: d.CFG_VARIANTS["ssmchunk"](get_config(a)).ssm_chunk
                     for a in ARCHS},
       "skip": {}, "rules": {}}
for a in ARCHS:
    for s in SHAPES:
        out["skip"][f"{a}/{s}"] = d.cell_skip_reason(get_config(a), SHAPES[s])
        for m, (shape, axes) in meshes.items():
            for v in ["", "sp", "replicated", "colshard", "ssmchunk"]:
                r = d.rules_for(get_config(a), SHAPES[s],
                                AbstractMesh(shape, axes), v)
                out["rules"][f"{a}/{s}/{m}/{v}"] = {k: enc(x)
                                                    for k, x in r.items()}
json.dump(out, sys.stdout)
"""


@functools.lru_cache(maxsize=None)
def _jax_dryrun():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout)


def _rules(enc):
    return {k: tuple(v) if isinstance(v, list) else v for k, v in enc.items()}


def _port_mesh(shape, axes):
    devs = np.empty(int(np.prod(shape)), dtype=object)
    devs[:] = rank_devices(int(np.prod(shape)))
    return Mesh(devs.reshape(shape), axes)


def _jax_cfg(arch, variant):
    cfg = get_config(arch)
    return cfg.with_(ssm_chunk=16) if variant == "ssmchunk" else cfg


@functools.lru_cache(maxsize=None)
def _jax_specs(arch, shape_name, variant):
    """JAX's ``input_specs`` (abstract: they hold no mesh)."""
    return jsteps.input_specs(_jax_cfg(arch, variant), SHAPES[shape_name])


def _jax_holdings(arch, shape_name, mesh_name, variant, rules):
    """Bytes a device holds of each input under JAX's specs and
    shardings on an AbstractMesh: ``shard_shape`` of every leaf."""
    cfg = _jax_cfg(arch, variant)
    shape = SHAPES[shape_name]
    mesh = AbstractMesh(*MESHES[mesh_name])
    specs = _jax_specs(arch, shape_name, variant)
    with jsh.sharding_context(mesh, rules):
        shardings = jsteps.input_shardings(cfg, shape, specs)

    def nbytes(spec_tree, sh_tree):
        leaves = jax.tree_util.tree_leaves(spec_tree)
        shs = jax.tree_util.tree_leaves(
            sh_tree, is_leaf=lambda x: isinstance(x, NamedSharding))
        assert len(leaves) == len(shs)
        return sum(int(np.prod(s.shard_shape(leaf.shape)))
                   * leaf.dtype.itemsize for leaf, s in zip(leaves, shs))

    out = {"params": nbytes(specs["params"], shardings["params"])}
    if shape.kind == "train":
        for k in ("mu", "nu", "step"):
            out[k] = nbytes(specs["opt_state"][k],
                            shardings["opt_state"][k])
    if shape.kind in ("train", "prefill"):
        out["batch"] = nbytes(specs["batch"], shardings["batch"])
    else:
        out["cache"] = nbytes(specs["cache"], shardings["cache"])
        out["tokens"] = nbytes(specs["tokens"], shardings["tokens"])
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_holdings_equal_jax_shard_shapes(arch):
    """Every shape, mesh and variant of the architecture at its published
    width: the port's bytes a rank holds, input by input, equal JAX's."""
    probe = _jax_dryrun()
    for shape_name in SHAPES:
        for mesh_name, (shape, axes) in MESHES.items():
            mesh = _port_mesh(shape, axes)
            for variant in VARIANT_IDS:
                cfg = t_get_config(arch)
                if variant in dryrun.CFG_VARIANTS:
                    cfg = dryrun.CFG_VARIANTS[variant](cfg)
                tshape = T_SHAPES[shape_name]
                rules = dryrun.rules_for(cfg, tshape, mesh, variant)
                jrules = _rules(probe["rules"][
                    f"{arch}/{shape_name}/{mesh_name}/{variant}"])
                assert rules == jrules, (arch, shape_name, mesh_name,
                                         variant)
                got = dryrun.holdings(cfg, tshape, mesh, rules)
                want = _jax_holdings(arch, shape_name, mesh_name, variant,
                                     jrules)
                assert got == want, (arch, shape_name, mesh_name, variant,
                                     got, want)


def test_tables_and_skip_reasons_equal_jax():
    probe = _jax_dryrun()
    assert dryrun.VARIANTS == {k: dict(v)
                               for k, v in probe["VARIANTS"].items()}
    assert sorted(dryrun.CFG_VARIANTS) == probe["CFG_VARIANTS"]
    for arch in ARCH_IDS:
        cfg = dryrun.CFG_VARIANTS["ssmchunk"](t_get_config(arch))
        assert cfg.ssm_chunk == probe["ssm_chunk"][arch]
        for s in SHAPES:
            assert dryrun.cell_skip_reason(t_get_config(arch), T_SHAPES[s]) \
                == probe["skip"][f"{arch}/{s}"], (arch, s)
    # long_500k is skipped for exactly the full-attention architectures
    assert {a for a in ARCH_IDS if probe["skip"][f"{a}/long_500k"]} == {
        a for a in ARCH_IDS if not get_config(a).subquadratic}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_jax(arch):
    assert roofline.param_count_active(t_get_config(arch)) == \
        jroof.param_count_active(get_config(arch))
    for s in SHAPES:
        assert roofline.model_flops(t_get_config(arch), T_SHAPES[s]) == \
            jroof.model_flops(get_config(arch), SHAPES[s]), (arch, s)


def test_holdings_need_no_process_group():
    """``holdings`` reads specs and placements only: a (2, 2) layout of
    qwen1.5-0.5b's train step at batch 8 x 256 (the card's split step),
    parameters a quarter of one rank's and the moments twice them."""
    import dataclasses
    cfg = t_get_config("qwen1.5-0.5b")
    shape = dataclasses.replace(T_SHAPES["train_4k"], global_batch=8,
                                seq_len=256)
    one = dryrun.holdings(cfg, shape, _port_mesh((1, 1), ("data", "model")),
                          dryrun.rules_for(cfg, shape, _port_mesh(
                              (1, 1), ("data", "model"))))
    mesh = _port_mesh((2, 2), ("data", "model"))
    four = dryrun.holdings(cfg, shape, mesh,
                           dryrun.rules_for(cfg, shape, mesh))
    assert one["params"] == 2 * sum(
        int(np.prod(s.shape)) for s in
        jax.tree_util.tree_leaves(jsteps.abstract_params(get_config(
            "qwen1.5-0.5b"))))
    # a quarter, and the leaves no rule splits (norms, biases) whole
    assert 0.25 <= four["params"] / one["params"] <= 0.2502
    assert four["mu"] == four["nu"] == 2 * four["params"]
    assert four["step"] == one["step"] == 4
    assert four["batch"] == one["batch"] // 2 == 8 * 256 * 4 // 2
