"""Split train steps of the port's LM zoo on a 2 x 2 (data, model) mesh of
four CPU rank processes over gloo (``tests/torch_mesh_ranks.py``), for each
of the ten architectures at smoke size (fp32, B = 4, 16 tokens, two loss
chunks), against the one-rank port step and against JAX's step from the
same JAX parameter tree on the same batch; and ``compress_grads`` on split
gradients against one rank.

Tolerances are ``tests/test_torch_train.py``'s, the split held against
each reference in turn:

* the loss within 1e-5;
* each gradient leaf within 5e-5 of its largest magnitude, and the
  global norm of the gradients within 5e-5 of itself (the split sums its
  products, norms, loss and the norm's squares in other orders);
* after one AdamW step, ``mu`` within 5e-5 of its leaf's largest |mu| and
  ``nu`` within 1e-4 of its largest |nu| (``mu`` is the clipped gradient
  scaled, ``nu`` its square, so twice the relative error);
* each parameter's change within 2 * lr * (1 + wd * max|p|) everywhere
  (an element whose gradient is near zero can move by lr either way on
  the sign of a rounding), and within 2e-3 * lr + 1e-6 * max(1, max|p|)
  of the reference's change wherever the reference's gradient exceeds
  four times the gradient tolerance and its clipped gradient 1e3 * eps:
  there both sides take the same sign and Adam's first step moves by lr
  times a ratio within 1e-3 of one (a step that moved nothing, or moved
  by another rate, fails there).

The split model drawn by ``lm.init_params`` equals the one-rank model bit
for bit (each leaf drawn whole in the one-rank order, then cut).  The MoE
pair runs ``moe_groups`` = the data shards on the one-rank and JAX sides.
``compress_grads`` is bitwise.  The group starts once for the module.
"""
import functools

import jax
import numpy as np
import pytest

import torch_mesh_ranks as ranks
from repro.configs import get_config, smoke
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro_torch.configs import ARCHS
from repro_torch.distributed import run_group

ARCH_IDS = sorted(ARCHS)
GRAD_REL = 5e-5


def jax_config(arch, data):
    """JAX's smoke config as ``ranks.config`` builds the port's, with
    ``moe_groups`` = ``data`` for an MoE."""
    cfg = smoke(get_config(arch)).with_(lmhead_chunk=ranks.CHUNK)
    return cfg.with_(moe_groups=data) if cfg.n_experts else cfg


@functools.lru_cache(maxsize=None)
def jax_tree(arch):
    """JAX's seed-0 parameters (numpy leaves)."""
    return jax.tree.map(np.asarray, jlm.init_params(
        jax_config(arch, 0), jax.random.PRNGKey(0)))


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def jax_step(arch, data):
    """JAX's loss, gradients, their global norm and one AdamW step from
    ``jax_tree(arch)`` on the batch the rank job draws (jitted, one
    device: GSPMD's result on any mesh)."""
    cfg = jax_config(arch, data)
    tree = jax_tree(arch)
    batch = ranks.inputs(cfg, seed=10)
    toks = batch.pop("tokens")
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t, kw: jlm.lm_loss(p, cfg, t, **kw)))(tree, toks, batch)
    opt_cfg = jadamw.AdamWConfig(**ranks.OPT)
    params, opt = jax.jit(functools.partial(jadamw.apply_updates, opt_cfg))(
        tree, grads, jadamw.init_opt_state(tree))
    return {"loss": float(loss), "gnorm": float(jadamw.global_norm(grads)),
            "grads": _flat(grads), "before": _flat(tree),
            "params": _flat(params), "mu": _flat(opt["mu"]),
            "nu": _flat(opt["nu"])}


def split_results(shape, extra_jobs=()):
    """Every smoke architecture's split train step on ``shape`` (and
    ``extra_jobs``), each beside JAX's step: ``{arch: (rank 0's record,
    JAX's)}`` and the extra jobs' results in order."""
    jobs = [("train_step", shape, {"arch": a, "tree": jax_tree(a)})
            for a in ARCH_IDS] + list(extra_jobs)
    out = run_group(ranks.run, 4, backend="gloo", device="cpu",
                    args=(jobs,), timeout_s=600)[0]
    data = shape[0]
    steps = {a: (r, jax_step(a, data)) for a, r in zip(ARCH_IDS, out)}
    return steps, out[len(ARCH_IDS):]


@pytest.fixture(scope="module")
def results():
    return split_results((2, 2), [("compress", (2, 2), {})])


def check_train_step(r, what):
    """A split step (rank 0's record and JAX's) against the one-rank port
    step and against JAX's."""
    r, want = r
    ranks.check_split_step(r, what, GRAD_REL)
    ranks.hold_step(r["split"], want, f"{what} against JAX", GRAD_REL)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_split_train_step_matches_one_rank_2x2(results, arch):
    check_train_step(results[0][arch], f"{arch} 2x2")


def test_compress_grads_on_split_gradients_is_bitwise(results):
    assert results[1][0]["bitwise"]
