"""Rank bodies of the port's data-parallel tests (``test_torch_distributed.py``,
``test_torch_train_dp.py``).

``run`` is what every rank process of a group runs
(``repro_torch.distributed.run_group``): a list of jobs, each a name in
``JOBS`` and its keyword arguments, on the data axis of a mesh over the
group's ranks.  The group's processes import this module, never the test
files, which import JAX.  Results are numpy trees (``tree``), so they
travel back to the test process by pickle.
"""
import time

import numpy as np
import torch

from repro_torch import convert
from repro_torch.launch.train_dp import snapshot
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import Trainer, init_deep
from repro_torch.distributed import (Mesh, WorkerLost, elastic_mesh,
                                     make_data_parallel_supervised_step,
                                     make_data_parallel_unsupervised_step,
                                     make_rules, projection_shardings,
                                     rank_devices, sharding_context)


def tree(state) -> dict:
    """A state as numpy (``train_dp.snapshot``): every array, the clocks'
    host mirrors and the generator's state."""
    return snapshot(state)


def _rows(a: np.ndarray, mesh, device) -> torch.Tensor:
    """This rank's rows of a batch (B, ...)."""
    ax = mesh.axis("data")
    bl = a.shape[0] // ax.n
    return torch.from_numpy(
        np.ascontiguousarray(a[ax.index * bl:(ax.index + 1) * bl])).to(device)


def _start(spec, device, init=None, seed=0):
    if init is None:
        return init_deep(spec, seed, device)
    return convert.state_from_numpy(init, spec, device=device, seed=seed)


def unsup_steps(mesh, device, spec, xs, layer=0, noise=None, init=None):
    """DP unsupervised steps, one per (B, Ni) batch of ``xs``, from
    ``init`` (a numpy tree; seed 0's state without one); ``noise``
    (nsteps, B, Nj) replaces the generator's draws.  The tree after each
    step."""
    state = _start(spec, device, init)
    step = make_data_parallel_unsupervised_step(spec, mesh, layer=layer)
    out = []
    for i, x in enumerate(xs):
        nz = None if noise is None else torch.from_numpy(noise[i]).to(device)
        state = step(state, _rows(x, mesh, device), noise=nz)
        out.append(tree(state))
    return out


def sup_steps(mesh, device, spec, xs, ys):
    """DP supervised steps from seed 0's state; the tree after each."""
    state = _start(spec, device)
    step = make_data_parallel_supervised_step(spec, mesh)
    out = []
    for x, y in zip(xs, ys):
        state = step(state, _rows(x, mesh, device), _rows(y, mesh, device))
        out.append(tree(state))
    return out


def fit(mesh, device, spec, x, y, epochs=2, batch=16, seed=0,
        ckpt_dir=None, ckpt_every=0, kill_at=None, resume=False,
        catch=True, evaluate=False):
    """``Trainer(spec, seed, mesh).fit``; with ``kill_at`` the fit's
    ``on_chunk`` raises ``WorkerLost`` at that chunk, caught here (the
    result names the cursor) unless ``catch`` is False.  The tree of the
    fitted state, with ``acc`` (training-set accuracy) if ``evaluate``."""
    tr = Trainer(spec, seed, mesh, device=device)
    seen = []

    def on_chunk(cur):
        seen.append(cur)
        if len(seen) == kill_at:
            raise WorkerLost(f"simulated loss at {cur}")

    try:
        stats = tr.fit(x, y, epochs=epochs, batch=batch, ckpt_dir=ckpt_dir,
                       ckpt_every_batches=ckpt_every, resume=resume,
                       on_chunk=on_chunk if kill_at else None)
    except WorkerLost:
        if not catch:
            raise
        return {"killed": seen[-1].to_dict()}
    out = tree(tr.state)
    out["stats"] = stats
    if evaluate:
        out["acc"] = tr.evaluate(x, y, batch=batch)
    return out


def restore_sharded(mesh, device, spec, ckpt_dir):
    """Restore ``ckpt_dir``'s step 0 on a (data 1, model n) mesh of the
    group's ranks with ``projection_shardings``: per leaf, the placements
    of a DTensor (None for a plain tensor) and whether its full value
    equals the saved array."""
    n = mesh.size
    mesh2 = Mesh(np.array(rank_devices(n), dtype=object).reshape(1, n),
                 ("data", "model"))
    target = init_deep(spec, 1, device)
    with sharding_context(mesh2, make_rules(mesh2)):
        sh = projection_shardings(target)
    state = CheckpointManager(ckpt_dir).restore(0, target, shardings=sh)
    saved = np.load(f"{ckpt_dir}/step_0/arrays.npz")
    out = {}
    for name, leaf in (("projs/0/traces/pij", state.projs[0].traces.pij),
                       ("projs/0/w", state.projs[0].w),
                       ("projs/0/table", state.projs[0].table),
                       ("projs/0/b", state.projs[0].b)):
        full = leaf.full_tensor() if hasattr(leaf, "full_tensor") else leaf
        out[name] = (str(getattr(leaf, "placements", None)),
                     tuple(getattr(leaf, "to_local", lambda: leaf)().shape),
                     bool(np.array_equal(full.cpu().numpy(), saved[name])))
    return out


JOBS = {f.__name__: f for f in (unsup_steps, sup_steps, fit,
                                 restore_sharded)}


def run(rank, device, jobs):
    """Every job on the data axis of a mesh over the group's ranks."""
    mesh = elastic_mesh((torch.distributed.get_world_size(),), ("data",))
    return [JOBS[name](mesh, device, **kw) for name, kw in jobs]


def fail_or_wait(rank, device):
    """Rank 1 raises at once; the others wait for it in a collective that
    never completes."""
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    torch.distributed.barrier()


def sleep(rank, device, seconds):
    time.sleep(seconds)
