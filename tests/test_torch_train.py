"""Trunk training of the port's LM zoo (``repro_torch.models.lm.lm_loss``,
``repro_torch.optim``, ``launch.steps``' train half and specs,
``models.params``, ``distributed.sharding.shard``, the train-state
checkpoint) held against the JAX package on the CPU, for each of the ten
architectures at its ``smoke`` size in fp32 unless a test names some.

Parameters come from JAX's ``lm.init_params`` and cross by
``convert.lm_params_from_numpy``; tokens, patches, frames and injected
gradients are numpy draws handed to both.  JAX runs jitted, outside a mesh
context (its train driver dies in ``sharding.py:116`` under this JAX).
The sequence is 16 tokens with ``lmhead_chunk`` 8, so the loss takes two
chunks.

Tolerances:
  * ``lm_loss``: 1e-5 absolute (a loss near 6.3; measured <= 1e-6).
  * gradients, leaf by leaf in the JAX layout: 5e-5 of the leaf's largest
    |gradient| (two fp32 summation orders through a few layers; measured
    <= 6.2e-6).
  * remat on against off within the port: bitwise (recomputation repeats
    the forward's operations); the port's remat=True against JAX's
    remat=True: the gradient tolerance above.  Mamba's chunk remat: bitwise
    but for ``A_log``'s gradient (summed chunk by chunk), which is held to
    the gradient tolerance.
  * ``aux_load_balance_loss``: 1e-6 absolute (a value near 1).
  * ``apply_updates`` fed JAX's own gradients, 3 steps across the end of
    warmup: parameters 2e-6 absolute; ``mu`` 1e-5 of the leaf's largest
    |mu|, ``nu`` 2e-5 of its largest |nu|.  The clipping scale divides by
    the global norm, a sum of every gradient's square that XLA and the
    port add in other orders, and XLA contracts ``b * m + c * g`` into
    fused multiply-adds where the port rounds each product (measured over
    the eleven configurations: 4.8e-7, 2.5e-6, 4.9e-6); ``step`` bitwise.  With zero gradients, the decay of a stacked norm scale and
    the non-decay of a tail one are held bitwise.
  * ``compress_grads`` fed the same gradients and error, 3 steps: bitwise.
  * ``make_train_step``, 3 steps from one state: losses 1e-5 absolute;
    parameters within 2 * lr * (1 + wd * max|p|) a step, 6 * lr * (1 +
    wd * max|p|) after 3.  Adam divides each moment by the root of the
    second one, so an element whose gradient is near zero can move by up
    to lr in either direction on the two sides (its sign is a rounding's);
    two runs part by at most both steps' sum.  One bf16 step: the loss at
    4 % (PR 23's bf16 tolerance), each parameter leaf at 4 % of its
    largest magnitude plus that one-step bound (a zero-initialised bias
    moves by lr either way on the sign of a bf16 gradient near 0).
  * specs and dims: exact.
  * checkpoints: bitwise, and the port's step after a JAX checkpoint
    within one step's bound above.
  * the driver on the CPU: a resumed run bitwise the uninterrupted one.
"""
import functools
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import ARCHS, SHAPES, ShapeConfig, get_config, smoke
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models import params as jparams
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke as t_smoke
from repro_torch.distributed.sharding import (Mesh, make_rules, rank_devices,
                                              shard, sharding_context)
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import lm, moe
from repro_torch.models import params as tparams
from repro_torch.optim import (AdamWConfig, apply_updates, compress_grads,
                               init_error_state, init_opt_state)

ROOT = Path(__file__).resolve().parents[1]
ARCH_IDS = sorted(ARCHS)
B, S, CHUNK = 2, 16, 8
LOSS_TOL = 1e-5
GRAD_REL = 5e-5
AUX_TOL = 1e-6
OPT_P_TOL, OPT_MU_REL, OPT_NU_REL = 2e-6, 1e-5, 2e-5
BF16_REL = 0.04
LR, WD = 1e-3, 0.1
OPT = dict(lr=LR, warmup_steps=2, total_steps=10, weight_decay=WD)
# the rrl pattern at 7 layers: 2 stacked repeats and a tail layer
RRL7 = "recurrentgemma-2b@7"
OPT_IDS = ARCH_IDS + [RRL7]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    name, _, layers = arch.partition("@")
    if layers:
        kw["n_layers"] = int(layers)
    kw.setdefault("lmhead_chunk", CHUNK)
    return (smoke(get_config(name)).with_(**kw),
            t_smoke(t_get_config(name)).with_(**kw))


def _inputs(cfg, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    extra = {}
    if cfg.vision_patches:
        extra["patches"] = rng.normal(
            size=(b, cfg.vision_patches, cfg.d_model)).astype(np.float32)
    if cfg.enc_layers:
        extra["frames"] = rng.normal(
            size=(b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return toks, extra


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree):
    """``{"a/b/c": numpy leaf}`` of a nested JAX tree, in JAX's order."""
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _perturbed(tree, seed=1):
    """Every float leaf moved by a small normal draw (norm scales and
    biases off their 0/1 inits, so decay shows)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(a.dtype)
        if np.issubdtype(a.dtype, np.floating) else a, tree)


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(arch, remat):
    cfg, _ = _cfgs(arch, remat=remat)
    return jax.jit(jax.value_and_grad(
        lambda p, t, kw: jlm.lm_loss(p, cfg, t, **kw)))


def _jax_loss_grads(arch, tree, remat=False):
    cfg, _ = _cfgs(arch, remat=remat)
    toks, extra = _inputs(cfg)
    loss, g = _jax_value_and_grad(arch, remat)(
        tree, toks, {k: jnp.asarray(v) for k, v in extra.items()})
    return float(loss), _flat(g)


@functools.lru_cache(maxsize=None)
def _jax_tree(arch):
    cfg, _ = _cfgs(arch)
    return jax.tree.map(np.asarray, jlm.init_params(cfg, jax.random.PRNGKey(0)))


def _port_loss_grads(arch, tree, remat=False, **kw):
    _, tcfg = _cfgs(arch, remat=remat, **kw)
    toks, extra = _inputs(tcfg)
    params = convert.lm_params_from_numpy(tree, tcfg, "cpu", train=True)
    loss = lm.lm_loss(params, tcfg, _t(toks),
                      **{k: _t(v) for k, v in extra.items()})
    groups = convert.lm_leaf_groups(params)
    flat = [t for g in groups.values() for t in g]
    got = iter(torch.autograd.grad(loss, flat))
    grads = {k: [next(got) for _ in g] for k, g in groups.items()}
    return loss.detach(), grads


def _assert_grads_close(grads, want, what):
    got = convert._flat(convert.groups_to_numpy(grads))
    assert list(got) == list(want), what
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, (what, path, g.shape, w.shape)
        tol = GRAD_REL * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol,
                                   err_msg=f"{what} {path}")


# -------------------------------------------------------- loss and grads --

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_loss_and_grads_match_jax(arch):
    tree = _jax_tree(arch)
    want_loss, want = _jax_loss_grads(arch, tree)
    loss, grads = _port_loss_grads(arch, tree)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(loss.item() - want_loss) <= LOSS_TOL, (loss.item(), want_loss)
    _assert_grads_close(grads, want, f"{arch} grads")


@pytest.mark.parametrize("chunk", [6, 64])
def test_lm_loss_chunk_edges_match_jax(chunk):
    """A chunk that does not divide the sequence takes it whole, one longer
    than the sequence takes the sequence."""
    arch = "qwen1.5-0.5b"
    cfg, tcfg = _cfgs(arch, lmhead_chunk=chunk)
    tree = _jax_tree(arch)
    toks, _ = _inputs(cfg)
    want = float(jax.jit(lambda p, t: jlm.lm_loss(p, cfg, t))(tree, toks))
    params = convert.lm_params_from_numpy(tree, tcfg, "cpu")
    got = float(lm.lm_loss(params, tcfg, _t(toks)))
    assert abs(got - want) <= LOSS_TOL, (got, want)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_is_bitwise_and_matches_jax_remat(arch):
    tree = _jax_tree(arch)
    loss0, g0 = _port_loss_grads(arch, tree, remat=False)
    loss1, g1 = _port_loss_grads(arch, tree, remat=True)
    assert torch.equal(loss0, loss1)
    for path in g0:
        for a, b in zip(g0[path], g1[path]):
            assert torch.equal(a, b), f"{arch} {path}: remat changed bits"
    want_loss, want = _jax_loss_grads(arch, tree, remat=True)
    assert abs(float(loss1) - want_loss) <= LOSS_TOL
    _assert_grads_close(g1, want, f"{arch} remat grads")


def test_mamba_chunk_remat_keeps_the_plain_scan_bits():
    """``ssm_chunk`` 4 (dividing the 16 steps) rematerialises each chunk of
    the selective scan: the same loss and gradients bit for bit, except
    ``A_log``'s, which every step shares, so its gradient sums chunk by
    chunk (within the gradient tolerance); and JAX's chunked scan's within
    the gradient tolerance."""
    arch = "falcon-mamba-7b"
    tree = _jax_tree(arch)
    loss0, g0 = _port_loss_grads(arch, tree)
    loss1, g1 = _port_loss_grads(arch, tree, ssm_chunk=4)
    assert torch.equal(loss0, loss1)
    for path in g0:
        for a, b in zip(g0[path], g1[path]):
            if path.endswith("A_log"):
                tol = GRAD_REL * float(a.abs().max())
                assert float((a - b).abs().max()) <= tol, path
            else:
                assert torch.equal(a, b), path
    cfg, _ = _cfgs(arch, ssm_chunk=4)
    toks, _ = _inputs(cfg)
    _, g = jax.jit(jax.value_and_grad(
        lambda p, t: jlm.lm_loss(p, cfg, t)))(tree, toks)
    _assert_grads_close(g1, _flat(g), "mamba chunked")


@pytest.mark.parametrize("arch,local", [("qwen1.5-0.5b", False),
                                        ("gemma2-2b", True),
                                        ("qwen3-32b", False)])
def test_chunked_attention_grads_match_jax(arch, local):
    """Query chunks of 4 over 16 positions (the zoo's 512 over longer
    sequences): the gradients of a random projection of ``attend``'s
    output for every weight and the input, against JAX's chunked scan
    (gemma2's local layer: window 8, soft-capped scores)."""
    from repro.models import attention as jatt
    from repro_torch.models import attention as tatt
    cfg, tcfg = _cfgs(arch)
    jp = jatt.init_attention(jax.random.PRNGKey(4), cfg, jnp.float32)
    rng = np.random.default_rng(8)
    jp = {k: (v + 0.05 * rng.normal(size=v.shape)).astype(np.float32)
          for k, v in jax.tree.map(np.asarray, jp).items()}
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    r = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)

    def jloss(p, x):
        out = jatt.attend(p, cfg, x, pos, causal=True, local=local,
                          q_chunk=4)
        return jnp.sum(out * r)

    jg, jx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, x)
    tp = tatt.Attention(tcfg, torch.float32, torch.device("cpu"))
    with torch.no_grad():
        for name, p in tp.named_parameters():
            p.copy_(_t(jp[name]))
    tp.requires_grad_(True)
    tx = _t(x).requires_grad_(True)
    out = tatt.attend(tp, tcfg, tx, _t(pos), causal=True, local=local,
                      q_chunk=4)
    (out * _t(r)).sum().backward()
    for name, p in tp.named_parameters():
        want = np.asarray(jg[name])
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=GRAD_REL * np.abs(want).max(),
                                   err_msg=name)
    want = np.asarray(jx)
    np.testing.assert_allclose(tx.grad.numpy(), want, rtol=0,
                               atol=GRAD_REL * np.abs(want).max())


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "qwen3-moe-30b-a3b"])
def test_aux_load_balance_loss_matches_jax(arch):
    cfg, tcfg = _cfgs(arch)
    jp = jmoe.init_moe(jax.random.PRNGKey(3), cfg, jnp.float32)
    tp = moe.MoE(tcfg, torch.float32, torch.device("cpu"))
    with torch.no_grad():
        for name, p in tp.named_parameters():
            p.copy_(_t(jp[name]))
    tp.requires_grad_(True)
    x = np.random.default_rng(7).normal(
        size=(2, 16, cfg.d_model)).astype(np.float32)
    want, jg = jax.value_and_grad(jmoe.aux_load_balance_loss)(
        jp, cfg, jnp.asarray(x))
    got = moe.aux_load_balance_loss(tp, tcfg, _t(x))
    assert abs(float(got) - float(want)) <= AUX_TOL
    got.backward()
    want_g = np.asarray(jg["router"])
    np.testing.assert_allclose(
        tp.router.grad.numpy(), want_g, rtol=0,
        atol=GRAD_REL * np.abs(want_g).max())


# ------------------------------------------------------------ optimizer --

def _port_state(arch, tree):
    _, tcfg = _cfgs(arch)
    params = convert.lm_params_from_numpy(tree, tcfg, "cpu", train=True)
    return params, convert.lm_leaf_groups(params)


def _groups_from(flat_np, like):
    return convert.groups_from_numpy(convert._nest(flat_np), like)


@pytest.mark.parametrize("arch", OPT_IDS)
def test_apply_updates_on_jax_gradients_matches_jax(arch):
    """Three steps across the end of warmup (2), the port fed JAX's own
    gradients (so a near-zero gradient's sign is not in the comparison)."""
    cfg, tcfg = _cfgs(arch)
    tree = _perturbed(jax.tree.map(
        np.asarray, jlm.init_params(cfg, jax.random.PRNGKey(0))))
    opt_cfg = jadamw.AdamWConfig(**OPT)
    jp, jopt = tree, jadamw.init_opt_state(tree)
    params, groups = _port_state(arch, tree)
    opt = init_opt_state(groups)
    upd = jax.jit(functools.partial(jadamw.apply_updates, opt_cfg))
    for i in range(3):
        _, g = _jax_loss_grads(arch, jp)
        jp, jopt = upd(jp, jax.tree.map(jnp.asarray, convert._nest(g)), jopt)
        apply_updates(AdamWConfig(**OPT), groups, _groups_from(g, groups),
                      opt)
        assert opt["step"].dtype == torch.int32
        assert int(opt["step"]) == int(jopt["step"]) == i + 1
        got_p = convert._flat(convert.lm_params_to_numpy(params, tcfg))
        for path, w in _flat(jp).items():
            np.testing.assert_allclose(got_p[path], w, rtol=0,
                                       atol=OPT_P_TOL,
                                       err_msg=f"{arch} step {i} {path}")
        got = convert.opt_state_to_numpy(opt)
        for key, rel in (("mu", OPT_MU_REL), ("nu", OPT_NU_REL)):
            mine = convert._flat(got[key])
            for path, w in _flat(jopt[key]).items():
                np.testing.assert_allclose(
                    mine[path], w, rtol=0,
                    atol=rel * max(float(np.abs(w).max()), 1e-30),
                    err_msg=f"{arch} step {i} {key} {path}")


def test_decay_follows_the_jax_leaf_rank():
    """rrl at 7 layers: a norm scale of a stacked repeat is 2-D in the JAX
    tree and decays; the same leaf of the tail is 1-D and does not.  With
    zero gradients a step is the decay alone."""
    arch = RRL7
    cfg, tcfg = _cfgs(arch)
    assert tcfg.pattern_blocks == (2, 1)
    tree = _perturbed(jax.tree.map(
        np.asarray, jlm.init_params(cfg, jax.random.PRNGKey(0))))
    zeros = jax.tree.map(np.zeros_like, tree)
    opt_cfg = jadamw.AdamWConfig(**OPT)
    jp, _ = jax.jit(functools.partial(jadamw.apply_updates, opt_cfg))(
        tree, zeros, jadamw.init_opt_state(tree))
    params, groups = _port_state(arch, tree)
    apply_updates(AdamWConfig(**OPT), groups,
                  _groups_from(_flat(zeros), groups), init_opt_state(groups))
    got = convert._flat(convert.lm_params_to_numpy(params, tcfg))
    want, before = _flat(jp), _flat(tree)
    stacked, tail = "blocks/pos0_r/norm1/scale", "tail/tail0_r/norm1/scale"
    assert before[stacked].ndim == 2 and before[tail].ndim == 1
    assert not np.array_equal(got[stacked], before[stacked])
    np.testing.assert_array_equal(got[tail], before[tail])
    for path in (stacked, tail, "blocks/pos0_r/rglru/b_r",
                 "tail/tail0_r/rglru/b_r"):
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)


@pytest.mark.parametrize("arch", OPT_IDS)
def test_compress_grads_is_bitwise_jax(arch):
    """Three steps of the same gradients and carried error, each leaf's
    repeats at different magnitudes, so one scale a stacked leaf and one a
    layer would give other codes."""
    cfg, _ = _cfgs(arch)
    tree = jax.tree.map(np.asarray,
                        jlm.init_params(cfg, jax.random.PRNGKey(0)))
    _, groups = _port_state(arch, tree)
    rng = np.random.default_rng(5)
    jerr = jcomp.init_error_state(tree)
    err = init_error_state(groups)
    comp = jax.jit(jcomp.compress_grads)
    stacked = 0
    for i in range(3):
        g = {}
        for path, grp in groups.items():
            shape = convert.leaf_spec(grp).shape
            mag = 10.0 ** rng.uniform(-4, 1, size=(len(grp),) + (1,) * (
                len(shape) - (len(grp) > 1)))
            if len(grp) == 1:
                mag = mag[0]
            g[path] = (rng.normal(size=shape) * mag).astype(np.float32)
            stacked += len(grp) > 1
        jd, jerr = comp(jax.tree.map(jnp.asarray, convert._nest(g)), jerr)
        deq, err = compress_grads(_groups_from(g, groups), err)
        for mine, want, what in ((deq, jd, "grads"), (err, jerr, "error")):
            mine = convert._flat(convert.groups_to_numpy(mine))
            for path, w in _flat(want).items():
                assert mine[path].tobytes() == w.tobytes(), \
                    f"{arch} step {i} {what} {path}"
    assert (stacked > 0) == (_cfgs(arch)[1].pattern_blocks[0] > 1)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", RRL7, "whisper-tiny"])
def test_opt_and_error_state_round_trip_bitwise(arch):
    """JAX's optimizer and error states after two JAX steps (stacked
    repeats, a tail, an encoder) cross into the port and back bit for
    bit; ``step`` stays int32."""
    cfg, tcfg = _cfgs(arch)
    tree = _perturbed(jax.tree.map(
        np.asarray, jlm.init_params(cfg, jax.random.PRNGKey(0))))
    upd = jax.jit(functools.partial(jadamw.apply_updates,
                                    jadamw.AdamWConfig(**OPT)))
    jp, jopt = tree, jadamw.init_opt_state(tree)
    jerr = jcomp.init_error_state(tree)
    for _ in range(2):
        g = convert._nest(_jax_loss_grads(arch, jp)[1])
        g, jerr = jax.jit(jcomp.compress_grads)(g, jerr)
        jp, jopt = upd(jp, g, jopt)
    params = convert.lm_params_from_numpy(tree, tcfg, "cpu", train=True)
    opt = convert.opt_state_from_numpy(jax.tree.map(np.asarray, jopt),
                                       params)
    err = convert.error_state_from_numpy(jax.tree.map(np.asarray, jerr),
                                         params)
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 2
    back = convert.opt_state_to_numpy(opt)
    back_err = convert.error_state_to_numpy(err)
    for mine, want in ((back, jopt), (back_err, jerr)):
        mine, want = _flat(mine), _flat(want)
        assert list(mine) == list(want)
        for path, w in want.items():
            assert mine[path].dtype == w.dtype, path
            assert mine[path].tobytes() == w.tobytes(), path


# ------------------------------------------------------------ train step --

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_matches_jax(arch):
    cfg, tcfg = _cfgs(arch)
    tree = _jax_tree(arch)
    opt_cfg = jadamw.AdamWConfig(**OPT)
    jstep = jax.jit(jsteps.make_train_step(cfg, opt_cfg))
    params = convert.lm_params_from_numpy(tree, tcfg, "cpu", train=True)
    opt = init_opt_state(convert.lm_leaf_groups(params))
    step = steps.make_train_step(tcfg, AdamWConfig(**OPT))
    jp, jopt = jax.tree.map(jnp.asarray, tree), jadamw.init_opt_state(tree)
    pmax = max(float(np.abs(a).max()) for a in jax.tree.leaves(tree))
    for i in range(3):
        toks, extra = _inputs(cfg, seed=10 + i)
        jloss, jp, jopt = jstep(jp, jopt, {"tokens": toks, **extra})
        loss, params, opt = step(params, opt, {
            "tokens": _t(toks), **{k: _t(v) for k, v in extra.items()}})
        assert abs(float(loss) - float(jloss)) <= LOSS_TOL, (i, float(loss),
                                                             float(jloss))
        bound = 2 * LR * (1 + WD * pmax) * (i + 1)
        got = convert._flat(convert.lm_params_to_numpy(params, tcfg))
        for path, w in _flat(jp).items():
            np.testing.assert_allclose(got[path], w, rtol=0, atol=bound,
                                       err_msg=f"{arch} step {i} {path}")
    assert int(opt["step"]) == 3


def test_bf16_train_step_matches_jax():
    arch = "qwen1.5-0.5b"
    cfg, tcfg = _cfgs(arch, dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jlm.init_params(cfg, jax.random.PRNGKey(0)))
    opt_cfg = jadamw.AdamWConfig(**OPT)
    toks, _ = _inputs(cfg)
    jloss, jp, _ = jax.jit(jsteps.make_train_step(cfg, opt_cfg))(
        tree, jadamw.init_opt_state(tree), {"tokens": toks})
    params = convert.lm_params_from_numpy(tree, tcfg, "cpu", train=True)
    assert params.tok_embed.dtype == torch.bfloat16
    opt = init_opt_state(convert.lm_leaf_groups(params))
    loss, params, opt = steps.make_train_step(tcfg, AdamWConfig(**OPT))(
        params, opt, {"tokens": _t(toks)})
    assert abs(float(loss) - float(jloss)) <= BF16_REL * abs(float(jloss))
    got = convert._flat(convert.lm_params_to_numpy(params, tcfg))
    pmax = max(float(np.abs(np.asarray(a, np.float32)).max())
               for a in jax.tree.leaves(tree))
    step_bound = 2 * LR * (1 + WD * pmax)
    for path, w in _flat(jp).items():
        assert got[path].dtype == w.dtype, path
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(
            np.asarray(got[path], np.float32), w, rtol=0,
            atol=BF16_REL * np.abs(w).max() + step_bound, err_msg=path)


def test_serving_after_training_builds_no_graph():
    """A model built to serve has no trainable parameter; one built to
    train takes gradients, and its forward under ``no_grad`` builds no
    graph."""
    _, tcfg = _cfgs("qwen1.5-0.5b")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    served = lm.init_params(tcfg, 0, "cpu")
    assert not any(p.requires_grad for p in served.parameters())
    assert lm.forward(served, tcfg, toks).grad_fn is None
    trained = lm.init_params(tcfg, 0, "cpu", train=True)
    assert all(p.requires_grad for p in trained.parameters())
    with torch.no_grad():
        assert lm.forward(trained, tcfg, toks).grad_fn is None


# ------------------------------------------------------- specs and dims --

def _dtype_name(dt):
    return str(dt).replace("torch.", "")


def _jax_specs(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            (tuple(x.shape), str(x.dtype))
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree, prefix=""):
    """``{"a/b/c": leaf}`` of the port's nested dicts of specs or
    shardings."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_port_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _port_specs(tree):
    return {k: (tuple(v.shape), _dtype_name(v.dtype))
            for k, v in _port_leaves(tree).items()}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_jax_eval_shape(arch, kind):
    """At the published configs (abstract: nothing is allocated)."""
    cfg, tcfg = get_config(arch), t_get_config(arch)
    shape = ShapeConfig(f"{kind}_t", 64, 4, kind)
    want = _jax_specs(jsteps.input_specs(cfg, shape))
    got = _port_specs(steps.input_specs(tcfg, shape))
    assert got == want
    assert _port_specs(steps.batch_specs(tcfg, shape)) == _jax_specs(
        jsteps.batch_specs(cfg, shape))
    aparams = steps.abstract_params(tcfg)
    assert all(p.device.type == "meta" for p in aparams.parameters())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_leaf_and_cache_dims_match_jax(arch):
    cfg, tcfg = get_config(arch), t_get_config(arch)
    aparams = jsteps.abstract_params(cfg)
    flat = jax.tree_util.tree_flatten_with_path(aparams)[0]
    specs = convert.lm_leaf_specs(steps.abstract_params(tcfg))
    assert len(flat) == len(specs)
    for path, leaf in flat:
        name = "/".join(str(k.key) for k in path)
        assert tparams.leaf_dims(name, specs[name]) == \
            jparams.leaf_dims(path, leaf), name
    acache = jsteps.abstract_cache(cfg, 4, 64)
    cspecs = steps.abstract_cache(tcfg, 4, 64)
    cflat = jax.tree_util.tree_flatten_with_path(acache)[0]
    assert len(cflat) == len(cspecs)
    for path, leaf in cflat:
        name = "/".join(str(k.key) for k in path)
        assert tparams.cache_dims(name, cspecs[name]) == \
            jparams.cache_dims(path, leaf), name


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen3-moe-30b-a3b",
                                  "whisper-tiny"])
def test_shardings_match_jax_on_a_one_rank_mesh(arch):
    from repro.distributed import sharding as jsh
    cfg, tcfg = get_config(arch), t_get_config(arch)
    shape = SHAPES["train_4k"]
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    with jsh.sharding_context(jmesh, jsh.make_rules(jmesh)):
        jspecs = jsteps.input_specs(cfg, shape)
        want = jsteps.input_shardings(cfg, shape, jspecs)
    mesh = make_local_mesh()
    with sharding_context(mesh, make_rules(mesh)):
        got = steps.input_shardings(tcfg, shape,
                                    steps.input_specs(tcfg, shape))
    assert steps.input_shardings(tcfg, shape, steps.input_specs(
        tcfg, shape))["batch"]["tokens"] is None  # outside a context
    wflat = {"/".join(str(getattr(k, "key", k)) for k in p): s
             for p, s in jax.tree_util.tree_flatten_with_path(want)[0]}
    gflat = _port_leaves(got)
    assert set(gflat) == set(wflat)
    for name, s in wflat.items():
        assert tuple(gflat[name].spec) == tuple(s.spec), name


# ----------------------------------------------------------------- shard --

def test_shard_is_the_identity_without_a_context_and_on_one_rank():
    x = torch.zeros((2, 3, 8))
    assert shard(x, "batch", "seq", "embed") is x
    mesh = make_local_mesh()
    with sharding_context(mesh, make_rules(mesh)):
        assert shard(x, "batch", "seq", "embed") is x
        with pytest.raises(AssertionError):
            shard(x, "batch", "embed")


def test_shard_raises_for_an_axis_longer_than_one():
    devices = np.empty((1, 2), dtype=object)
    devices[0, 0], devices[0, 1] = rank_devices(2)
    mesh = Mesh(devices, ("data", "model"))
    with sharding_context(mesh, make_rules(mesh)):
        # 3 does not divide over 2: the rule drops the axis, nothing splits
        x = torch.zeros((2, 3, 3))
        assert shard(x, "batch", "seq", "embed") is x
        # 8 splits over 2: a tensor split across ranks is a DTensor, and
        # a plain one under a split mesh raises
        with pytest.raises(TypeError, match="plain"):
            shard(torch.zeros((2, 3, 8)), "batch", "seq", "embed")


# ----------------------------------------------------------- checkpoints --

def test_jax_train_checkpoint_restores_and_steps_in_the_port(tmp_path):
    """JAX writes ``{"params", "opt"}`` after two JAX steps; the port
    restores it bitwise and takes the third step, which equals JAX's within
    one step's bound."""
    arch = "qwen1.5-0.5b"
    cfg, tcfg = _cfgs(arch)
    tree = _jax_tree(arch)
    opt_cfg = jadamw.AdamWConfig(**OPT)
    jstep = jax.jit(jsteps.make_train_step(cfg, opt_cfg))
    jp, jopt = jax.tree.map(jnp.asarray, tree), jadamw.init_opt_state(tree)
    batches = [_inputs(cfg, seed=20 + i)[0] for i in range(3)]
    for toks in batches[:2]:
        _, jp, jopt = jstep(jp, jopt, {"tokens": toks})
    JCheckpointManager(str(tmp_path)).save(2, {"params": jp, "opt": jopt},
                                           blocking=True)
    jloss, jp3, _ = jstep(jp, jopt, {"tokens": batches[2]})

    params = lm.init_params(tcfg, 9, "cpu", train=True)
    opt = init_opt_state(convert.lm_leaf_groups(params))
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 2
    assert mgr.restore(2, {"params": params, "opt": opt}) is not None
    got = convert._flat(convert.lm_params_to_numpy(params, tcfg))
    for path, w in _flat(jp).items():
        assert got[path].tobytes() == w.tobytes(), path
    mine = convert.opt_state_to_numpy(opt)
    for key in ("mu", "nu"):
        mk = convert._flat(mine[key])
        for path, w in _flat(jopt[key]).items():
            assert mk[path].tobytes() == w.tobytes(), (key, path)
    assert int(opt["step"]) == 2 and opt["step"].dtype == torch.int32
    loss, params, opt = steps.make_train_step(tcfg, AdamWConfig(**OPT))(
        params, opt, {"tokens": _t(batches[2])})
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL
    pmax = max(float(np.abs(a).max()) for a in jax.tree.leaves(jp))
    got = convert._flat(convert.lm_params_to_numpy(params, tcfg))
    for path, w in _flat(jp3).items():
        np.testing.assert_allclose(got[path], w, rtol=0,
                                   atol=2 * LR * (1 + WD * pmax),
                                   err_msg=path)


_PORT_WRITER = r"""
import sys
sys.modules['jax'] = None
sys.modules['repro'] = None
sys.modules['ml_dtypes'] = None
import numpy as np, torch
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, smoke
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig, init_error_state, init_opt_state
out = sys.argv[1]
cfg = smoke(get_config('qwen1.5-0.5b')).with_(dtype='bfloat16')
params = lm.init_params(cfg, 3, 'cpu', train=True)
groups = convert.lm_leaf_groups(params)
opt = init_opt_state(groups)
opt['err'] = init_error_state(groups)
toks = torch.from_numpy(np.random.default_rng(0).integers(
    0, cfg.vocab, (2, 16)).astype(np.int32))
_, params, opt = make_train_step(cfg, AdamWConfig(), compress=True)(
    params, opt, {'tokens': toks})
CheckpointManager(out + '/ckpt').save(1, {'params': params, 'opt': opt},
                                     blocking=True)
flat = {'params/' + k: v for k, v in convert._flat(
    convert.lm_params_to_numpy(params, cfg, bf16_as='float32')).items()}
state = convert.opt_state_to_numpy(opt)
state['err'] = convert.error_state_to_numpy(opt['err'])
flat.update({'opt/' + k: v for k, v in convert._flat(state).items()})
np.savez(out + '/values.npz', **flat)
print('ok', params.tok_embed.dtype)
"""


def test_port_bf16_train_checkpoint_restores_in_jax_without_ml_dtypes(
        tmp_path):
    """The port writes a bf16 train state (compression error included) in
    a process where ``ml_dtypes``, ``jax`` and ``repro`` cannot be
    imported; JAX's manager restores it into its own train state bitwise."""
    proc = subprocess.run(
        [sys.executable, "-c", _PORT_WRITER, str(tmp_path)], cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "torch.bfloat16" in proc.stdout
    cfg, _ = _cfgs("qwen1.5-0.5b", dtype="bfloat16")
    aparams = jlm.init_params(cfg, jax.random.PRNGKey(0))
    aopt = jadamw.init_opt_state(aparams)
    aopt["err"] = jcomp.init_error_state(aparams)
    state = JCheckpointManager(str(tmp_path / "ckpt")).restore(
        1, {"params": aparams, "opt": aopt})
    values = np.load(tmp_path / "values.npz")
    flat = _flat(state)
    assert set(flat) == set(values.files)
    for name, a in flat.items():
        want = values[name]
        if name.startswith("params/"):
            assert str(a.dtype) == "bfloat16", name
        assert np.asarray(a, want.dtype).tobytes() == want.tobytes(), name
    assert int(flat["opt/step"]) == 1


# ------------------------------------------------------------- the driver --

def _driver(*args, ckpt=None):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "qwen1.5-0.5b", "--smoke", "--device", "cpu", "--batch", "2",
           "--seq", "16", *args]
    if ckpt is not None:
        cmd += ["--ckpt-dir", str(ckpt)]
    return subprocess.Popen(cmd, cwd=ROOT, env={
        "PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
        "OMP_NUM_THREADS": "1"}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _finish(proc):
    out, err = proc.communicate(timeout=300)
    return proc.returncode, out, err


def test_driver_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    """A 12-step run with ``--ckpt-every 4``, and the same run killed after
    its step-8 checkpoint (its directory as the kill leaves it: steps 4
    and 8) and restarted: the restart's step-12 checkpoint is the
    uninterrupted one's bit for bit.  As in the JAX driver, the schedule's
    length is ``--steps``, so the restart takes the killed run's
    arguments."""
    whole, killed = tmp_path / "whole", tmp_path / "killed"
    rc, out, err = _finish(_driver("--steps", "12", "--ckpt-every", "4",
                                   ckpt=whole))
    assert rc == 0, err
    assert CheckpointManager(str(whole)).all_steps() == [4, 8, 12]
    killed.mkdir()
    for step in (4, 8):
        shutil.copytree(whole / f"step_{step}", killed / f"step_{step}")
    rc, out, err = _finish(_driver("--steps", "12", "--ckpt-every", "4",
                                   ckpt=killed))
    assert rc == 0, err
    assert "resumed from step 8" in out
    a = np.load(whole / "step_12" / "arrays.npz")
    b = np.load(killed / "step_12" / "arrays.npz")
    assert sorted(a.files) == sorted(b.files)
    assert "opt/step" in a.files and int(a["opt/step"]) == 12
    for name in a.files:
        assert a[name].tobytes() == b[name].tobytes(), name


def test_driver_stops_resumes_compresses_and_refuses_split_meshes(tmp_path):
    """The JAX system test's sequence: 8 steps with ``--ckpt-every 4``, a
    resume to 12, the resume again at 12 with no steps to run; then
    ``--compress-grads``, and ``--mesh single``, which raises: the 16x16
    mesh needs a group of 256 ranks."""
    part = tmp_path / "part"
    procs = [_driver("--steps", "8", "--ckpt-every", "4", ckpt=part),
             _driver("--steps", "4", "--compress-grads", "--log-every", "1"),
             _driver("--steps", "2", "--mesh", "single")]
    (rc_p, _, err_p), (rc_c, out_c, err_c), (rc_m, _, err_m) = [
        _finish(p) for p in procs]
    assert rc_p == 0, err_p
    assert rc_c == 0, err_c
    assert "step 3 loss=" in out_c
    assert rc_m != 0 and "256 ranks" in err_m, err_m
    rc, out, err = _finish(_driver("--steps", "12", "--ckpt-every", "4",
                                   ckpt=part))
    assert rc == 0, err
    assert "resumed from step 8" in out
    assert CheckpointManager(str(part)).latest_step() == 12
    rc, out, err = _finish(_driver("--steps", "12", ckpt=part))
    assert rc == 0, err
    assert "no steps to run" in out
