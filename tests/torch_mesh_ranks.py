"""Rank bodies of the port's split-mesh tests (``test_torch_mesh_*.py``).

Every rank process of a group (``repro_torch.distributed.run_group``) runs
``run``: a list of jobs, each a name in ``JOBS`` and its keyword
arguments, on a ``(data, model)`` mesh over the group's four ranks.  The
group's processes import this module, never the test files, which import
JAX.  Each job makes the split computation and the one-rank port
computation in the same process from the same seed or the same JAX
parameter tree (numpy, handed in), and returns numbers (arrays as numpy
in the JAX layout, bit-equality flags), so results travel back by pickle
and the tests hold them against each other and against JAX.
"""
import os

import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, smoke
from repro_torch.distributed.sharding import (Mesh, full_value, make_rules,
                                              place_like, rank_devices,
                                              sharding_context)
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm
from repro_torch.optim import (AdamWConfig, compress_grads, global_norm,
                               init_error_state, init_opt_state)

B, S, CHUNK = 4, 16, 8
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10, weight_decay=0.1)


def mesh_of(shape) -> Mesh:
    """The group's ranks, row-major, on ("data", "model")."""
    devs = np.empty(int(np.prod(shape)), dtype=object)
    devs[:] = rank_devices(int(np.prod(shape)))
    return Mesh(devs.reshape(shape), ("data", "model"))


def config(arch: str, moe_groups: int = 0, **kw):
    """The smoke config the tests run (``lmhead_chunk`` 8: two chunks)."""
    return smoke(get_config(arch)).with_(lmhead_chunk=CHUNK,
                                         moe_groups=moe_groups, **kw)


def inputs(cfg, seed: int = 0, b: int = B, s: int = S):
    """Host tokens and, where the architecture takes them, patches or
    frames (numpy draws from ``seed``)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.vision_patches:
        batch["patches"] = rng.normal(
            size=(b, cfg.vision_patches, cfg.d_model)).astype(np.float32)
    if cfg.enc_layers:
        batch["frames"] = rng.normal(
            size=(b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def _placed(batch, device):
    dims = {"tokens": ("batch", None)}
    return {k: place_like(torch.from_numpy(v).to(device),
                          dims.get(k, ("batch", None, "embed")))
            for k, v in batch.items()}


def _plain(batch, device):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _full_groups(groups):
    """``{path: [numpy, ...]}`` of whole values (DTensors gathered)."""
    return {k: [full_value(t.detach()).cpu().float().numpy().copy()
                for t in g] for k, g in groups.items()}


def _grads(params, cfg, batch):
    groups = convert.lm_leaf_groups(params)
    flat = [t for g in groups.values() for t in g]
    loss = lm.lm_loss(params, cfg, batch["tokens"],
                      patches=batch.get("patches"),
                      frames=batch.get("frames"))
    got = iter(torch.autograd.grad(loss, flat))
    return loss, {k: [next(got) for _ in g] for k, g in groups.items()}


def _lead() -> bool:
    """Rank 0, which alone makes the one-rank reference and compares."""
    return torch.distributed.get_rank() == 0


# ------------------------------------------------------------------ jobs --

def _flat_np(groups):
    """``{"a/b": numpy}`` in the JAX layout (DTensors gathered)."""
    return convert._flat(convert.groups_to_numpy(groups))


def _step_record(params, cfg, opt_cfg, batch):
    """Loss and gradients by autograd, their global norm, then one train
    step from the same state: every number in the JAX layout."""
    before = _flat_np(convert.lm_leaf_groups(params))
    loss, grads = _grads(params, cfg, batch)
    gnorm = float(full_value(global_norm(grads)))
    grads = _flat_np(grads)
    opt = init_opt_state(convert.lm_leaf_groups(params))
    step_loss, params, opt = make_train_step(cfg, opt_cfg)(params, opt,
                                                           batch)
    return {"loss": float(full_value(loss.detach())),
            "step_loss": float(step_loss), "gnorm": gnorm, "grads": grads,
            "before": before,
            "params": _flat_np(convert.lm_leaf_groups(params)),
            "mu": _flat_np(opt["mu"]), "nu": _flat_np(opt["nu"])}


def train_step(mesh, device, arch, tree, seed=0):
    """One split train step from the JAX parameter tree ``tree`` (numpy,
    converted onto the mesh) against the one-rank port step from the same
    tree, with ``moe_groups`` on the one-rank side equal to the split's
    data shards: for each side the loss, the gradients and their global
    norm, and the parameters, ``mu`` and ``nu`` after the step (JAX
    layout, whole).  Also whether the split model drawn from ``seed`` by
    ``lm.init_params`` holds the one-rank model's numbers."""
    data = mesh.shape["data"]
    cfg_split = config(arch)
    cfg_one = config(arch, moe_groups=data) if cfg_split.n_experts else (
        cfg_split)
    batch = inputs(cfg_split, seed=10 + seed)
    opt_cfg = AdamWConfig(**OPT)

    with sharding_context(mesh, make_rules(mesh)):
        drawn = _full_groups(convert.lm_leaf_groups(
            lm.init_params(cfg_split, seed, device, train=True)))
        params = convert.lm_params_from_numpy(tree, cfg_split, device,
                                              train=True)
        split_leaves = sum(
            isinstance(t, torch.distributed.tensor.DTensor)
            and any(p.is_shard() for p in t.placements)
            for g in convert.lm_leaf_groups(params).values() for t in g)
        split = _step_record(params, cfg_split, opt_cfg,
                             _placed(batch, device))
    if not _lead():
        return None
    one = _full_groups(convert.lm_leaf_groups(
        lm.init_params(cfg_one, seed, device, train=True)))
    init_same = all(np.array_equal(a, b) for k, v in one.items()
                    for a, b in zip(v, drawn[k]))
    params = convert.lm_params_from_numpy(tree, cfg_one, device, train=True)
    return {"split": split,
            "one": _step_record(params, cfg_one, opt_cfg,
                                _plain(batch, device)),
            "init_same": init_same, "split_leaves": split_leaves}


def compress(mesh, device, arch="qwen1.5-0.5b", steps=3):
    """``compress_grads`` on split gradients (the same full gradients,
    drawn from numpy and placed as the parameters are), 3 steps carrying
    the error, against the one-rank call: every dequantized gradient and
    every error bitwise."""
    cfg = config(arch)
    one = lm.init_params(cfg, 0, device)
    g_one = convert.lm_leaf_groups(one)
    err1 = init_error_state(g_one)
    rng = np.random.default_rng(3)
    draws = [{k: [rng.normal(size=tuple(t.shape)).astype(np.float32)
                  * 10.0 ** rng.integers(-3, 1) for t in g]
              for k, g in g_one.items()} for _ in range(steps)]
    ones = []
    for d in draws:
        deq, err1 = compress_grads(
            {k: [torch.from_numpy(a).to(device) for a in v]
             for k, v in d.items()}, err1)
        ones.append((_full_groups(deq), _full_groups(err1)))
    with sharding_context(mesh, make_rules(mesh)):
        params = lm.init_params(cfg, 0, device)
        groups = convert.lm_leaf_groups(params)
        err = init_error_state(groups)
        same = True
        for d, (want_deq, want_err) in zip(draws, ones):
            grads = {k: [convert.distribute_like(
                torch.from_numpy(a).to(device), t)
                for a, t in zip(d[k], groups[k])] for k in groups}
            deq, err = compress_grads(grads, err)
            got_deq, got_err = _full_groups(deq), _full_groups(err)
            for k in want_deq:
                for a, b in zip(got_deq[k] + got_err[k],
                                want_deq[k] + want_err[k]):
                    same &= a.tobytes() == b.tobytes()
    return {"bitwise": bool(same)}


def serve(mesh, device, arch, tree, seed=0, gen=3, overrides=None):
    """Prefill (B=4, 16 tokens) and ``gen`` greedy decode steps of the JAX
    parameter tree ``tree`` on the split model against one rank: each
    step's logits on both sides, the one-rank greedy tokens (which drive
    both, so the caches compare), the split side's own greedy tokens,
    every cache leaf's largest difference after the last step, and which
    cache leaves a rank holds split (``split_seq``: along the sequence).
    ``overrides`` go to ``make_rules`` (the dry run's decode rules)."""
    cfg = config(arch)
    batch = inputs(cfg, seed=20 + seed)
    seq_len = S + gen
    with torch.no_grad():
        one = convert.lm_params_from_numpy(tree, cfg, device)
        p1 = _plain(batch, device)
        logits1, cache1 = lm.prefill(one, cfg, p1["tokens"], seq_len,
                                     patches=p1.get("patches"),
                                     frames=p1.get("frames"))
        steps1 = [logits1.cpu().numpy()]
        tok = torch.argmax(logits1, -1)
        toks1 = [tok.cpu().numpy()]
        for _ in range(gen):
            logits1, cache1 = lm.decode_step(one, cfg, cache1, tok)
            steps1.append(logits1.cpu().numpy())
            tok = torch.argmax(logits1, -1)
            toks1.append(tok.cpu().numpy())
        c1 = convert.lm_cache_groups(cache1, cfg)
        with sharding_context(mesh, make_rules(mesh, overrides)):
            params = convert.lm_params_from_numpy(tree, cfg, device)
            p2 = _placed(batch, device)
            logits2, cache2 = lm.prefill(params, cfg, p2["tokens"], seq_len,
                                         patches=p2.get("patches"),
                                         frames=p2.get("frames"))
            steps2 = [full_value(logits2).cpu().numpy()]
            toks2 = [full_value(torch.argmax(logits2, -1)).cpu().numpy()]
            for t in toks1[:-1]:
                tok = place_like(torch.from_numpy(t).to(device), ("batch",))
                logits2, cache2 = lm.decode_step(params, cfg, cache2, tok)
                steps2.append(full_value(logits2).cpu().numpy())
                toks2.append(full_value(torch.argmax(logits2, -1)).cpu()
                             .numpy())
            c2 = convert.lm_cache_groups(cache2, cfg)
            cache_err = {k: max(float(np.abs(
                full_value(a).float().cpu().numpy()
                - b.float().cpu().numpy()).max()) for a, b in zip(c2[k],
                                                                  c1[k]))
                for k in c1 if k != "pos"}
            split_cache = [
                k for k, g in c2.items()
                if isinstance(g[0], torch.distributed.tensor.DTensor)
                and any(p.is_shard() for p in g[0].placements)]
            split_seq = [
                k for k, g in c2.items()
                if isinstance(g[0], torch.distributed.tensor.DTensor)
                and any(p.is_shard() and p.dim == 1
                        for p in g[0].placements)]
    return {"logits": steps2, "one_logits": steps1, "tokens": toks1,
            "split_tokens": toks2, "cache": cache_err, "pos": int(cache2.pos),
            "split_cache": split_cache, "split_seq": split_seq}


def checkpoint(mesh, device, root, arch="qwen1.5-0.5b", steps=4, kill=2):
    """A split run of ``steps`` train steps with a checkpoint after step
    ``kill`` (``root``/ckpt), and the same run killed there and resumed on
    the same mesh: each leaf of the resumed run against the uninterrupted
    one, bit for bit.  Rank 0 returns the split state at the checkpoint
    (numpy, whole) for the tests to hold the files against."""
    cfg = config(arch)
    opt_cfg = AdamWConfig(**OPT)
    batches = [inputs(cfg, seed=30 + i) for i in range(steps)]
    ckpt = os.path.join(root, "ckpt")
    with sharding_context(mesh, make_rules(mesh)):
        step = make_train_step(cfg, opt_cfg, compress=True)

        def fresh():
            params = lm.init_params(cfg, 0, device, train=True)
            groups = convert.lm_leaf_groups(params)
            opt = init_opt_state(groups)
            opt["err"] = init_error_state(groups)
            return params, opt

        def state_np(params, opt):
            out = {f"params/{k}": v for k, v in _full_groups(
                convert.lm_leaf_groups(params)).items()}
            for key in ("mu", "nu", "err"):
                out.update({f"opt/{key}/{k}": v
                            for k, v in _full_groups(opt[key]).items()})
            out["opt/step"] = [opt["step"].cpu().numpy()]
            return out

        params, opt = fresh()
        mgr = CheckpointManager(ckpt)
        saved = None
        for i, b in enumerate(batches):
            _, params, opt = step(params, opt, _placed(b, device))
            if i + 1 == kill:
                mgr.save(kill, {"params": params, "opt": opt})
                saved = state_np(params, opt)
        whole = state_np(params, opt)

        params, opt = fresh()
        CheckpointManager(ckpt).restore(kill, {"params": params,
                                               "opt": opt})
        restored = state_np(params, opt)
        for b in batches[kill:]:
            _, params, opt = step(params, opt, _placed(b, device))
        resumed = state_np(params, opt)
    same = lambda a, b: all(x.tobytes() == y.tobytes()
                            for k in b for x, y in zip(a[k], b[k]))
    out = {"restored_bitwise": same(restored, saved),
           "resumed_bitwise": same(resumed, whole)}
    if torch.distributed.get_rank() == 0:
        out["saved"] = {k: np.stack(v) if len(v) > 1 else v[0]
                        for k, v in saved.items()}
    return out


def restore_on(mesh, device, root, arch="qwen1.5-0.5b", kill=2):
    """The checkpoint ``checkpoint`` wrote, restored on this mesh (another
    layout of the same ranks): every leaf's whole value (numpy, rank 0)."""
    cfg = config(arch)
    with sharding_context(mesh, make_rules(mesh)):
        params = lm.init_params(cfg, 0, device, train=True)
        groups = convert.lm_leaf_groups(params)
        opt = init_opt_state(groups)
        opt["err"] = init_error_state(groups)
        CheckpointManager(os.path.join(root, "ckpt")).restore(
            kill, {"params": params, "opt": opt})
        out = {f"params/{k}": v for k, v in _full_groups(groups).items()}
        for key in ("mu", "nu", "err"):
            out.update({f"opt/{key}/{k}": v
                        for k, v in _full_groups(opt[key]).items()})
    if torch.distributed.get_rank() != 0:
        return None
    return {k: np.stack(v) if len(v) > 1 else v[0] for k, v in out.items()}


def convert_onto(mesh, device, arch, tree, opt_tree, err_tree):
    """JAX-layout numpy trees (parameters, optimizer state, compression
    error) converted onto the split mesh by ``convert``'s ``from_numpy``
    functions and back by their ``to_numpy`` ones: rank 0's round trip
    (numpy) and how many tensors came out split."""
    from repro_torch.distributed.sharding import split_mesh
    cfg = config(arch)
    with sharding_context(mesh, make_rules(mesh)):
        assert split_mesh(mesh)
        params = convert.lm_params_from_numpy(tree, cfg, device, train=True)
        opt = convert.opt_state_from_numpy(opt_tree, params)
        err = convert.error_state_from_numpy(err_tree, params)
        split = sum(isinstance(t, torch.distributed.tensor.DTensor)
                    and any(p.is_shard() for p in t.placements)
                    for g in (list(convert.lm_leaf_groups(params).values())
                              + list(opt["mu"].values())
                              + list(opt["nu"].values())
                              + list(err.values())) for t in g)
        back = (convert.lm_params_to_numpy(params, cfg, "float32"),
                convert.opt_state_to_numpy(opt),
                convert.error_state_to_numpy(err))
    return (back, split) if _lead() else None


# ------------------------------------------------------------ checks --
# The tolerances of ``test_torch_mesh_train.py``'s docstring, shared with
# the card's ``gpu`` test (``test_torch_cuda.py``), which imports no JAX.

LOSS_TOL = 1e-5


def _close_rel(got, want, rel, what):
    assert set(got) == set(want), what
    for path, w in want.items():
        g = np.asarray(got[path], np.float32)
        assert g.shape == w.shape, (what, path, g.shape, w.shape)
        tol = rel * max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= tol, (what, path, err, tol)


def hold_step(split, ref, what, grad_rel):
    """A split step's record against one reference's (one rank or JAX),
    at ``test_torch_mesh_train.py``'s tolerances with gradients within
    ``grad_rel`` of each leaf's largest: assertions."""
    assert abs(split["loss"] - ref["loss"]) <= LOSS_TOL, (
        what, split["loss"], ref["loss"])
    assert abs(split["gnorm"] - ref["gnorm"]) <= grad_rel * ref["gnorm"], (
        what, split["gnorm"], ref["gnorm"])
    _close_rel(split["grads"], ref["grads"], grad_rel, f"{what} grads")
    _close_rel(split["mu"], ref["mu"], grad_rel, f"{what} mu")
    _close_rel(split["nu"], ref["nu"], 2 * grad_rel, f"{what} nu")
    lr, wd = OPT["lr"], OPT["weight_decay"]
    b1, eps = AdamWConfig().b1, AdamWConfig().eps
    pmax = max(float(np.abs(a).max()) for a in ref["before"].values())
    bound = 2 * lr * (1 + wd * pmax)
    sure_tol = 2e-3 * lr + 1e-6 * max(1.0, pmax)
    sure = 0
    for path, before in ref["before"].items():
        assert np.array_equal(split["before"][path], before), (what, path)
        moved = split["params"][path] - before
        want = ref["params"][path] - before
        err = np.abs(moved - want)
        assert float(err.max()) <= bound, (what, path, float(err.max()))
        g = np.abs(ref["grads"][path])
        mask = ((g > 4 * grad_rel * max(float(g.max()), 1e-30))
                & (np.abs(ref["mu"][path]) / (1 - b1) > 1e3 * eps))
        sure += int(mask.sum())
        if mask.any():
            worst = float(err[mask].max())
            assert worst <= sure_tol, (what, path, worst, sure_tol)
    assert sure > 0, what


def check_split_step(r, what, grad_rel):
    """Rank 0's ``train_step`` record: the split model drawn as one rank's,
    some leaves split, the split step against the one-rank step."""
    assert r["init_same"], what
    assert r["split_leaves"] > 0, what
    split = r["split"]
    assert split["step_loss"] == split["loss"], what
    hold_step(split, r["one"], f"{what} against one rank", grad_rel)


def port_tree(arch):
    """The port's seed-0 parameters as a JAX-layout numpy tree (where no
    JAX is at hand)."""
    cfg = config(arch)
    return convert.lm_params_to_numpy(lm.init_params(cfg, 0, "cpu"), cfg,
                                      "float32")


JOBS = {"train_step": train_step, "convert_onto": convert_onto,
        "compress": compress, "serve": serve, "checkpoint": checkpoint,
        "restore_on": restore_on}


def run(rank, device, jobs):
    """Every job in turn: ``(name, mesh shape, kwargs)``; a list of their
    results.  One intra-op thread a rank (``RankGroup`` sets it)."""
    out = []
    for name, shape, kwargs in jobs:
        out.append(JOBS[name](mesh_of(shape), device, **kwargs))
    return out
