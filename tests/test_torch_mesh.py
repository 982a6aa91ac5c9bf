"""The port's production meshes, held against the JAX package's on the CPU
with no process group: every leaf's ``PartitionSpec`` of the ten
architectures (at their published widths and at smoke size) and of their
decode caches on the (16, 16) and (2, 16, 16) meshes, the port's
placements of those specs, ``make_production_mesh``'s shapes and refusals,
and the one-rank MoE step with ``moe_groups`` set, which a split MoE step
is held against, against JAX's.

The JAX side uses ``jax.sharding.AbstractMesh`` (no devices) under the JAX
``sharding_context``; the port side a ``Mesh`` of ``RankDevice`` records
of the same shape.  Specs compare exactly, a one-axis tuple written as
that axis on both sides.  The MoE comparison holds loss and gradients at
``tests/test_torch_train.py``'s tolerances (loss 1e-5 absolute, each
gradient 5e-5 of its leaf's largest magnitude).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCHS, get_config, smoke
from repro.distributed import sharding as jsh
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.models import params as jparams
from repro_torch import convert
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke as t_smoke
from repro_torch.distributed.sharding import (P, make_rules, placements,
                                              rank_devices, sharding_context,
                                              spec_for)
from repro_torch.distributed.sharding import Mesh as TMesh
from repro_torch.distributed.fault import describe_failure_domains
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh, parse_mesh_shape
from repro_torch.models import lm
from repro_torch.models import params as tparams
from repro_torch.models.params import tensor_dims

ARCH_IDS = sorted(ARCHS)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
LOSS_TOL, GRAD_REL = 1e-5, 5e-5


def _norm(spec):
    """A spec as a tuple, one-axis tuples written as the axis."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


def _port_mesh(shape, axes):
    devs = np.empty(int(np.prod(shape)), dtype=object)
    devs[:] = rank_devices(int(np.prod(shape)), per_host=16)
    return TMesh(devs.reshape(shape), axes)


def _jax_flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in p): s
            for p, s in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _specs(arch, small, mesh_name):
    """(JAX, port) ``{path: spec}`` of the parameters and of a 4 x 64
    decode cache."""
    cfg, tcfg = get_config(arch), t_get_config(arch)
    if small:
        cfg, tcfg = smoke(cfg), t_smoke(tcfg)
    shape, axes = MESHES[mesh_name]
    jmesh = jax.sharding.AbstractMesh(shape, axes)
    with jsh.sharding_context(jmesh, jsh.make_rules(jmesh)):
        jp = jparams.param_shardings(jsteps.abstract_params(cfg))
        jc = jparams.cache_shardings(jsteps.abstract_cache(cfg, 4, 64))
    mesh = _port_mesh(shape, axes)
    with sharding_context(mesh, make_rules(mesh)):
        tp = tparams.param_shardings(steps.abstract_params(tcfg))
        tc = tparams.cache_shardings(steps.abstract_cache(tcfg, 4, 64))
    want = {**{f"p/{k}": _norm(v.spec) for k, v in _jax_flat(jp).items()},
            **{f"c/{k}": _norm(v.spec) for k, v in _jax_flat(jc).items()}}
    got = {**{f"p/{k}": _norm(v.spec) for k, v in tp.items()},
           **{f"c/{k}": _norm(v.spec) for k, v in tc.items()}}
    return want, got


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("small", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_leaf_specs_match_jax_on_the_production_meshes(arch, small,
                                                       mesh_name):
    want, got = _specs(arch, small, mesh_name)
    assert set(got) == set(want)
    for name, spec in want.items():
        assert got[name] == spec, (name, got[name], spec)
    if not small:  # at full width the rules split most of the model
        assert sum(any(a is not None for a in s)
                   for k, s in got.items() if k.startswith("p/")) > 0


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_activation_specs_match_jax(mesh_name):
    """``spec_for`` of the activations the models constrain, at a shape
    where some dims divide the axes and some do not."""
    shape, axes = MESHES[mesh_name]
    jmesh = jax.sharding.AbstractMesh(shape, axes)
    mesh = _port_mesh(shape, axes)
    cases = [(("batch", "seq", "embed"), (64, 128, 4096)),
             (("batch", "act_seq", "heads", "head_dim"), (64, 128, 8, 128)),
             (("batch", "expert", None, None), (32, 64, 16, 2048)),
             (("batch", None, "vocab"), (2, 8, 152064)),
             (("batch",), (3,))]
    with jsh.sharding_context(jmesh, jsh.make_rules(jmesh)):
        want = [_norm(jsh.spec_for(d, s)) for d, s in cases]
    with sharding_context(mesh, make_rules(mesh)):
        got = [_norm(spec_for(d, s)) for d, s in cases]
    assert got == want


def test_placements_of_specs():
    """Each splitting axis longer than 1 shards its dimension; a tuple
    entry shards one dimension over several axes, major first; axes of
    size 1 and unsplit axes replicate."""
    mesh = _port_mesh((2, 4, 2), ("pod", "data", "model"))
    assert placements(mesh, P(("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert placements(mesh, P(None, "data")) == (
        Replicate(), Shard(1), Replicate())
    one = _port_mesh((1, 4), ("data", "model"))
    assert placements(one, P("data", "model")) == (Replicate(), Shard(1))


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen3-moe-30b-a3b"])
def test_tensor_dims_drop_the_stacking_dim(arch):
    """A port tensor of a stacked JAX leaf takes the leaf's dims without
    the leading stacking dimension (the rule on the same sizes)."""
    tcfg = t_smoke(t_get_config(arch))
    groups = convert.lm_leaf_groups(steps.abstract_params(tcfg))
    for path, group in groups.items():
        leaf = convert.leaf_spec(group)
        dims = tparams.leaf_dims(path, leaf)
        for t in group:
            assert tensor_dims(path, t) == dims[len(dims) - t.dim():]
            if len(group) > 1:
                assert dims[0] is None


def test_production_mesh_shapes_and_refusals():
    """The JAX shapes by default; ``shape=`` names a smaller group's
    layout on the same axes; a group of another size raises, naming both
    numbers."""
    with pytest.raises(ValueError, match="holds 256 ranks; the process "
                                         "group has 1"):
        make_production_mesh()
    with pytest.raises(ValueError, match="holds 512 ranks"):
        make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="holds 4 ranks"):
        make_production_mesh(shape=(2, 2))
    with pytest.raises(ValueError, match="names 2"):
        make_production_mesh(multi_pod=True, shape=(1, 1))
    mesh = make_production_mesh(shape=(1, 1))
    assert mesh.axis_names == ("data", "model")
    mesh = make_production_mesh(multi_pod=True, shape=(1, 1, 1))
    assert mesh.axis_names == ("pod", "data", "model")
    assert parse_mesh_shape("2x2") == (2, 2)
    assert parse_mesh_shape("2X1x4") == (2, 1, 4)
    with pytest.raises(ValueError, match="DxM"):
        parse_mesh_shape("2by2")


def test_production_mesh_puts_local_world_size_ranks_on_a_host(
        monkeypatch):
    """Four ranks, two a host (``torchrun``'s ``LOCAL_WORLD_SIZE``), on a
    2 x 2 mesh: the hosts are the data rows, and the failure domains count
    two hosts; unset, every rank is on one host."""
    monkeypatch.setattr(launch_mesh, "_world_size", lambda: 4)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    mesh = make_production_mesh(shape=(2, 2))
    assert [[d.process_index for d in row] for row in mesh.devices] == [
        [0, 0], [1, 1]]
    assert describe_failure_domains(mesh)["n_hosts"] == 2
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    mesh = make_production_mesh(shape=(2, 2))
    assert describe_failure_domains(mesh)["n_hosts"] == 1


@pytest.mark.parametrize("groups", [2, 4])
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "qwen3-moe-30b-a3b"])
def test_one_rank_moe_with_groups_matches_jax(arch, groups):
    """The one-rank step a split MoE step is held against: ``moe_groups``
    equal to the split's data shards, against JAX's ``lm_loss`` with the
    same groups (B = 4, 16 tokens, two loss chunks)."""
    kw = dict(lmhead_chunk=8, moe_groups=groups)
    cfg = smoke(get_config(arch)).with_(**kw)
    tcfg = t_smoke(t_get_config(arch)).with_(**kw)
    tree = jax.tree.map(np.asarray, jlm.init_params(cfg,
                                                    jax.random.PRNGKey(0)))
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (4, 16)).astype(
        np.int32)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p, t: jlm.lm_loss(p, cfg, t)))(tree, jnp.asarray(toks))
    params = convert.lm_params_from_numpy(tree, tcfg, "cpu", train=True)
    loss = lm.lm_loss(params, tcfg, torch.from_numpy(toks))
    groups_ = convert.lm_leaf_groups(params)
    flat = [t for g in groups_.values() for t in g]
    got = iter(torch.autograd.grad(loss, flat))
    grads = convert._flat(convert.groups_to_numpy(
        {k: [next(got) for _ in g] for k, g in groups_.items()}))
    assert abs(float(loss) - float(want_loss)) <= LOSS_TOL
    for path, w in _jax_flat(want).items():
        w = np.asarray(w)
        np.testing.assert_allclose(grads[path], w, rtol=0,
                                   atol=GRAD_REL * max(float(np.abs(w).max()),
                                                       1e-30), err_msg=path)
