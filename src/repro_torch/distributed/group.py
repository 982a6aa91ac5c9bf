"""Rank groups and the collectives of a mesh axis: the port's own module.
JAX is single-controller, one program driving every device of a mesh; the
port runs one process per rank, joined by ``torch.distributed``.

``RankGroup`` / ``run_group`` start n rank processes (the ``spawn`` start
method: the parent may hold a CUDA context), join them into a process group
through a ``file://`` store in a temporary directory (no TCP port to clash
between concurrent groups), run ``fn(rank, device, *args)`` in each, and
return every rank's result.  A rank's exception is raised again in the
parent; a group that outlives its timeout, or a rank that dies without a
word, is stopped and raises, so a hung collective fails its caller instead
of hanging it.  Rank r runs on ``cuda:{r % device_count}``, or on the CPU
(one intra-op thread a rank) when the caller asks for it.  The collective
backend is the caller's (``"gloo"`` or ``"nccl"``); NCCL refuses two ranks
on one card, so more ranks than cards with ``"nccl"`` raises rather than
trading the backend for another.

``DataAxis`` is one mesh axis as a rank sees it (the port's counterpart of
the axis context of ``shard_map``): the rank's position on the axis, the
process group of the ranks along it, and ``gather``, the all-gather every
data-parallel program is built from, timed into ``comm_s``.  gloo takes
card tensors (it copies them through the host itself), so no path stages
them by hand.
"""
from __future__ import annotations

import datetime
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch

BACKENDS = ("gloo", "nccl")


class RankFailed(RuntimeError):
    """A rank of a group failed: its traceback, when its exception could
    not be carried to the parent (or as the cause of the one that was)."""


def _barrier(group=None) -> None:
    dist = torch.distributed
    if dist.get_backend(group) == "nccl":
        dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=group)


def _rank_main(fn: Callable, rank: int, n: int, backend: str,
               device_type: str, store_dir: str, timeout_s: float,
               results) -> None:
    """A rank process: join the group, run ``fn`` on the arguments the
    parent wrote to ``store_dir``, report to the parent."""
    dist = torch.distributed
    try:
        with open(os.path.join(store_dir, "args.pkl"), "rb") as f:
            args = pickle.load(f)
        if device_type == "cuda":
            index = rank % torch.cuda.device_count()
            torch.cuda.set_device(index)
            device = torch.device("cuda", index)
        else:
            torch.set_num_threads(1)
            device = torch.device("cpu")
        dist.init_process_group(
            backend, init_method=f"file://{store_dir}/store", world_size=n,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
        out = fn(rank, device, *args)
        # no rank leaves while another may still be reading from it
        _barrier()
        dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException as e:  # reported to the parent, which raises it
        tb = traceback.format_exc()
        try:
            payload = pickle.dumps(e)
        except Exception:  # an exception that does not pickle: its text
            payload = None
        results.put((rank, False, (payload, tb, repr(e))))
        # Written through before this process ends: only then do its
        # peers see their links close and fail in turn, so the parent
        # hears the cause first.
        results.close()
        results.join_thread()


class RankGroup:
    """``n`` rank processes running ``fn(rank, device, *args)`` in one
    process group, started here; ``join`` waits for them (at most
    ``timeout_s`` from the start) and returns their results in rank order.
    ``fn`` and ``args`` are pickled into each rank, so ``fn`` is a module
    function whose module imports cheaply; results travel back pickled
    (numpy arrays, not tensors)."""

    def __init__(self, fn: Callable, n: int, *, backend: str,
                 device: str = "cuda", args: Sequence[Any] = (),
                 timeout_s: float = 600.0):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected one of "
                             f"{BACKENDS}")
        device_type = torch.device(device).type
        if device_type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "rank group on the card, but no CUDA device is visible; "
                "pass device='cpu' to run the ranks on the CPU")
        if backend == "nccl":
            cards = torch.cuda.device_count() if device_type == "cuda" else 0
            if n > cards:
                raise ValueError(
                    f"backend 'nccl' with {n} ranks on {cards} card(s): NCCL "
                    f"refuses two ranks on one card (and runs on cards "
                    f"only); ask for 'gloo'")
        import multiprocessing
        ctx = multiprocessing.get_context("spawn")
        self.n = n
        self.timeout_s = timeout_s
        self._dir = tempfile.mkdtemp(prefix="rank_group_")
        # The arguments go by file: a process start writes its pickled
        # payload into a pipe that it keeps a read end of, so a payload
        # larger than the pipe hangs the start if the rank dies early.
        with open(os.path.join(self._dir, "args.pkl"), "wb") as f:
            pickle.dump(tuple(args), f)
        self._results = ctx.Queue()
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True, args=(
                fn, r, n, backend, device_type, self._dir, timeout_s,
                self._results))
            for r in range(n)]
        self._deadline = time.monotonic() + timeout_s
        self._stopped = False
        for p in self._procs:
            p.start()

    def join(self) -> List[Any]:
        out: List[Any] = [None] * self.n
        done: set = set()
        ok = False
        try:
            while len(done) < self.n:
                left = self._deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"rank group of {self.n} timed out after "
                        f"{self.timeout_s:.0f} s; ranks "
                        f"{sorted(set(range(self.n)) - done)} did not finish")
                try:
                    rank, good, payload = self._results.get(
                        timeout=min(left, 0.5))
                except queue_mod.Empty:
                    self._check_alive(done)
                    continue
                if not good:
                    raise _rank_error(rank, *payload)
                out[rank] = payload
                done.add(rank)
            ok = True
            return out
        finally:
            self._stop(graceful=ok)

    def close(self) -> None:
        """Stop the ranks now (``join`` does it when it returns)."""
        self._stop(graceful=False)

    def _check_alive(self, done: set) -> None:
        for r, p in enumerate(self._procs):
            if r not in done and p.exitcode not in (None, 0):
                raise RankFailed(f"rank {r} died (exit code {p.exitcode}) "
                                 f"without reporting")

    def _stop(self, graceful: bool) -> None:
        """Join the ranks (a short grace after success), terminate what is
        left, remove the store.  Once."""
        if self._stopped:
            return
        self._stopped = True
        for p in self._procs:
            p.join(timeout=30.0 if graceful else 0.5)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        self._results.close()
        shutil.rmtree(self._dir, ignore_errors=True)


def _rank_error(rank: int, payload, tb: str, text: str) -> BaseException:
    cause = RankFailed(f"rank {rank} raised:\n{tb}")
    if payload is None:
        return cause
    exc = pickle.loads(payload)
    exc.__cause__ = cause
    return exc


def run_group(fn: Callable, n: int, *, backend: str, device: str = "cuda",
              args: Sequence[Any] = (), timeout_s: float = 600.0) -> List[Any]:
    """Run ``fn(rank, device, *args)`` on ``n`` ranks and return their
    results in rank order (``RankGroup`` says how)."""
    return RankGroup(fn, n, backend=backend, device=device, args=args,
                     timeout_s=timeout_s).join()


class DataAxis:
    """One axis of a mesh as this rank sees it (``Mesh.axis``): ``n``
    ranks along it, this rank at ``index``, and the process group of those
    ranks (None when ``torch.distributed`` is not initialized, which only a
    mesh of one rank allows: every collective is then the identity).
    ``gather`` concatenates every rank's tensor in mesh order; the host
    time of each (the card synchronized before and after, so it is the
    collective's alone) adds into ``comm_s``, and ``comm_calls`` counts
    them."""

    def __init__(self, mesh, name: str):
        from .sharding import _initialized
        self.name = name
        self.n = int(mesh.shape[name])
        split = {a: s for a, s in mesh.shape.items() if a != name and s > 1}
        if split:
            raise NotImplementedError(
                f"a data axis beside split axes {split}: nothing of the "
                f"BCPNN path splits a model axis (ROADMAP.md queue A item "
                f"10)")
        self.index = mesh.coordinates()[mesh.axis_names.index(name)]
        ids = [d.id for d in mesh.devices.flat]
        self.comm_s = 0.0
        self.comm_calls = 0
        if not _initialized():
            if self.n > 1:
                raise RuntimeError(
                    f"a mesh of {self.n} ranks on axis {name!r} needs "
                    f"torch.distributed: run each rank in a process group "
                    f"(distributed.group.run_group)")
            self.group, self.order = None, [0]
            return
        dist = torch.distributed
        group = mesh.group if mesh.group is not None else dist.group.WORLD
        granks = dist.get_process_group_ranks(group)
        if sorted(granks) != sorted(ids):
            raise ValueError(f"the mesh's ranks {ids} are not the ranks "
                             f"{granks} of its process group")
        self.group = group
        self.order = [granks.index(i) for i in ids]  # group rank a position

    def gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` (same shape on each) concatenated along
        ``dim``, rank blocks in mesh order."""
        if self.group is None:
            return t
        cuda = t.is_cuda
        if cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.n)]
        torch.distributed.all_gather(parts, t, group=self.group)
        out = torch.cat([parts[g] for g in self.order], dim=dim)
        if cuda:
            torch.cuda.synchronize(t.device)
        self.comm_s += time.perf_counter() - t0
        self.comm_calls += 1
        return out

    def barrier(self) -> None:
        """Wait for every rank of the axis (nothing without a group)."""
        if self.group is not None:
            _barrier(self.group)


def join_torchrun(device: str = "cuda") -> torch.device:
    """Join the default process group from ``torchrun``'s environment
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``/``_PORT``)
    when the world holds more than one rank, and return this rank's
    device: ``cuda:{LOCAL_RANK % cards}`` (set as the current card), or
    the CPU when ``device`` is ``"cpu"``.  The backend is NCCL with one
    rank a card, gloo on the CPU or with ranks sharing a card (NCCL
    refuses those).  A world of one joins nothing."""
    from ..device import resolve_device
    dev = resolve_device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist = torch.distributed
    if world > 1 and not dist.is_initialized():
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
        nccl = dev.type == "cuda" and per_host <= torch.cuda.device_count()
        if dev.type == "cpu":
            torch.set_num_threads(max(1, torch.get_num_threads()
                                      // per_host))
        dist.init_process_group("nccl" if nccl else "gloo",
                                init_method="env://",
                                device_id=dev if nccl else None)
    return dev
