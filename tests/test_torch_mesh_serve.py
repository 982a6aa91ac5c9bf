"""Split serving and split checkpoints of the port's LM zoo on four CPU
rank processes over gloo (``tests/torch_mesh_ranks.py``).

* Prefill (B = 4, 16 tokens) and 3 greedy decode steps of each of the ten
  smoke architectures on the 2 x 2 mesh, from JAX's seed-0 parameters,
  against one rank and against JAX's jitted ``prefill`` and
  ``decode_step`` on the same parameters and tokens, the one-rank greedy
  tokens driving all three: each step's logits within 1e-5 of the largest
  |logit| of the one-rank step (fp32; the split sums its products in
  other orders) and within 1e-4 of JAX's (``tests/test_torch_lm.py``'s
  tolerance), the split's own greedy tokens equal, every cache leaf after
  the last step within 1e-5 of the one-rank leaf's, the caches split
  across the ranks.
* JAX's parameters, optimizer state and compression error (the smoke
  MoE) converted onto the 2 x 2 mesh and back: bit for bit.
* A split train state (qwen1.5-0.5b smoke, compressed gradients, 2 x 2)
  saved after its 2nd of 4 steps: the files read back by the JAX
  ``CheckpointManager`` and by one port rank equal the split state bit
  for bit; the run killed there and resumed on the same mesh equals the
  uninterrupted run bit for bit; the same checkpoint restored on the
  1 x 4 and 4 x 1 layouts of the ranks holds the saved arrays bit for
  bit.
"""
import jax
import numpy as np
import pytest

import torch_mesh_ranks as ranks
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import ARCHS, get_config, smoke
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.distributed import run_group
from repro_torch.models import lm
from repro_torch.optim import init_error_state, init_opt_state
from test_torch_mesh_train import jax_config, jax_tree

ARCH_IDS = sorted(ARCHS)
REL = 1e-5
JAX_TOL = 1e-4


def _jax_trees(arch="qwen3-moe-30b-a3b"):
    """A JAX parameter tree, an optimizer state with moments off zero and
    a compression error, numpy leaves (the JAX layout, stacked)."""
    cfg = smoke(get_config(arch))
    tree = jax.tree.map(np.asarray, jlm.init_params(cfg,
                                                    jax.random.PRNGKey(0)))
    rng = np.random.default_rng(4)
    noise = lambda a: (rng.normal(size=a.shape) * 1e-2).astype(np.float32)
    opt = jax.tree.map(np.asarray, jadamw.init_opt_state(tree))
    opt = {"mu": jax.tree.map(noise, opt["mu"]),
           "nu": jax.tree.map(lambda a: np.abs(noise(a)), opt["nu"]),
           "step": np.asarray(3, np.int32)}
    err = jax.tree.map(noise, jax.tree.map(np.asarray,
                                           jcomp.init_error_state(tree)))
    return arch, tree, opt, err


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh_ckpt"))
    arch, tree, opt, err = _jax_trees()
    jobs = ([("serve", (2, 2), {"arch": a, "tree": jax_tree(a)})
             for a in ARCH_IDS]
            + [("checkpoint", (2, 2), {"root": root}),
               ("restore_on", (1, 4), {"root": root}),
               ("restore_on", (4, 1), {"root": root}),
               ("convert_onto", (2, 2), {"arch": arch, "tree": tree,
                                         "opt_tree": opt, "err_tree": err})])
    out = run_group(ranks.run, 4, backend="gloo", device="cpu",
                    args=(jobs,), timeout_s=600)[0]
    n = len(ARCH_IDS)
    return {"serve": dict(zip(ARCH_IDS, out[:n])), "ckpt": out[n],
            "1x4": out[n + 1], "4x1": out[n + 2], "root": root,
            "convert": (out[n + 3], (tree, opt, err))}


def _jax_serve(arch, driving):
    """JAX's prefill logits and its decode logits driven by ``driving``,
    from ``jax_tree(arch)`` on the rank job's batch (jitted)."""
    cfg = jax_config(arch, 0)
    batch = ranks.inputs(cfg, seed=20)
    toks = batch.pop("tokens")
    tree = jax_tree(arch)
    logits, cache = jax.jit(lambda p, t, kw: jlm.prefill(
        p, cfg, t, ranks.S + len(driving), **kw))(tree, toks, batch)
    out = [np.asarray(logits)]
    dec = jax.jit(lambda p, c, t: jlm.decode_step(p, cfg, c, t))
    for t in driving:
        logits, cache = dec(tree, cache, t)
        out.append(np.asarray(logits))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_split_prefill_and_decode_match_one_rank(results, arch):
    r = results["serve"][arch]
    want = _jax_serve(arch, r["tokens"][:-1])
    assert len(r["logits"]) == len(r["one_logits"]) == len(want) == 4
    for i, (a, b, w) in enumerate(zip(r["logits"], r["one_logits"], want)):
        assert a.shape == b.shape == w.shape, (arch, i)
        err, big = float(np.abs(a - b).max()), float(np.abs(b).max())
        assert err <= REL * big, (arch, i, err, big)
        err = float(np.abs(a - w).max())
        assert err <= JAX_TOL, (arch, i, "against JAX", err)
    for a, b in zip(r["split_tokens"], r["tokens"]):
        np.testing.assert_array_equal(a, b, err_msg=arch)
    assert r["pos"] == ranks.S + 3
    for path, err in r["cache"].items():
        assert err <= REL * max(1.0, err), (arch, path, err)
    assert r["split_cache"], arch


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_split_checkpoint_reads_back_in_jax_and_on_one_rank(results):
    saved = results["ckpt"]["saved"]
    path = f"{results['root']}/ckpt"
    cfg = smoke(get_config("qwen1.5-0.5b"))
    aparams = jlm.init_params(cfg, jax.random.PRNGKey(0))
    aopt = jadamw.init_opt_state(aparams)
    aopt["err"] = jcomp.init_error_state(aparams)
    state = _flat(JCheckpointManager(path).restore(
        2, {"params": aparams, "opt": aopt}))
    assert set(state) == set(saved)
    for name, a in state.items():
        assert a.astype(saved[name].dtype).tobytes() == \
            saved[name].tobytes(), name
    tcfg = ranks.config("qwen1.5-0.5b")
    params = lm.init_params(tcfg, 1, "cpu", train=True)
    groups = convert.lm_leaf_groups(params)
    opt = init_opt_state(groups)
    opt["err"] = init_error_state(groups)
    CheckpointManager(path).restore(2, {"params": params, "opt": opt})
    mine = {f"params/{k}": v for k, v in convert._flat(
        convert.lm_params_to_numpy(params, tcfg, "float32")).items()}
    for key in ("mu", "nu", "err"):
        mine.update({f"opt/{key}/{k}": v for k, v in convert._flat(
            convert.groups_to_numpy(opt[key])).items()})
    mine["opt/step"] = opt["step"].numpy()
    assert set(mine) == set(saved)
    for name, a in mine.items():
        assert np.asarray(a, saved[name].dtype).tobytes() == \
            saved[name].tobytes(), name


def test_split_kill_resume_is_bitwise_on_the_same_mesh(results):
    assert results["ckpt"]["restored_bitwise"]
    assert results["ckpt"]["resumed_bitwise"]


@pytest.mark.parametrize("layout", ["1x4", "4x1"])
def test_split_checkpoint_restores_on_other_layouts(results, layout):
    saved, got = results["ckpt"]["saved"], results[layout]
    assert set(got) == set(saved) - {"opt/step"}
    for name, a in got.items():
        assert a.tobytes() == saved[name].tobytes(), (layout, name)


def test_jax_trees_convert_onto_a_split_mesh_and_back_bitwise(results):
    """``convert``'s ``from_numpy`` functions under a 2 x 2 context give
    split DTensors (parameters, moments, error) whose whole values are the
    JAX arrays bit for bit (the MoE smoke model: expert leaves too)."""
    (back, split), want = results["convert"]
    assert split > 0
    for got_tree, want_tree in zip(back, want):
        got, exp = _flat(got_tree), _flat(want_tree)
        assert set(got) == set(exp)
        for name, a in exp.items():
            assert np.asarray(got[name], a.dtype).tobytes() == a.tobytes(), \
                name
