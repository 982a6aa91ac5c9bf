"""Captured steps: one training or evaluation step recorded once as a CUDA
graph and replayed per batch (``StepProgram``), and the served batch
recorded once per bucket (``ServeProgram``).  The port's own module: the
JAX trainer runs each epoch as one jitted, donated ``lax.scan`` and the JAX
serving engine jits one program per (model, bucket); XLA's jit has no
module to mirror.

A captured step reads its batch from static input buffers, copied into
before each replay, and updates the state it was captured on in place (the
steps' ``donate=True``), so every operand keeps the address the graph
recorded: the TMA tensor maps the kernels encode at launch hold those
addresses.  Whatever the step's Python does on the host runs once, at
capture; ``StepProgram`` keeps the rest true between replays:

* launch counts: the kernel wrappers count at capture, where nothing is
  launched, and a replay runs no wrapper.  What one capture counted is
  taken back, and added again on every replay;
* the random stream: a step that draws noise has the state's generator
  registered with its graph, so each replay draws what the next eager
  step would;
* the index tables of dense-resident patchy projections: the kernels read
  the tensor that the mask-identity memo returned at capture.  A rewire
  writes its new mask in place (bumping the mask's version), and the
  table is rebuilt into that tensor before the next replay;
* garbage: a graph destroyed while another is being captured (its owner
  collected by Python's cycle collector) invalidates that capture, so the
  collector is off during a capture;
* warm-up: before capture the step runs once eagerly, which builds the
  kernel library and fills the launchers' occupancy caches, cuBLAS's
  workspace and the table memo.  It runs on a scratch clone of the state
  and of the generator, so the state starts as it was, and its launches
  are not counted.

The clock's host mirror (``Traces.t_host``) and the rewire are the
caller's, after each replay (``core/trainer.py``).  Capture or replay
failures raise: nothing falls back to the eager step on the card.
"""
from __future__ import annotations

import gc
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .bcpnn_layer import InferPack, Projection, is_patchy
from .compact import build_table, cached_table
from .network import (DeepState, InferParams, NetworkSpec, infer_packed,
                      pack_state)
from .traces import Traces


def state_tensors(state: DeepState) -> List[torch.Tensor]:
    """Every tensor of a state, in a fixed order."""
    out = []
    for p in state.projs + (state.readout,):
        tr = p.traces
        out += [tr.pi, tr.pj, tr.pij, tr.t, p.w, p.b, p.mask]
        if p.table is not None:
            out.append(p.table)
    out.append(state.step)
    return out


def scratch_clone(state: DeepState) -> DeepState:
    """A copy to warm a step up on: every tensor a step writes is cloned;
    the mask and table, which only a rewire writes and no captured step
    holds, are shared, so the warm-up fills the table memo for the real
    mask.  The generator is a new one at the same position."""
    gen = torch.Generator(device=state.generator.device)
    gen.set_state(state.generator.get_state())

    def clone(p: Projection) -> Projection:
        tr = p.traces
        return Projection(
            traces=Traces(pi=tr.pi.clone(), pj=tr.pj.clone(),
                          pij=tr.pij.clone(), t=tr.t.clone(),
                          t_host=tr.t_host),
            w=p.w.clone(), b=p.b.clone(), mask=p.mask, table=p.table)

    return DeepState(projs=tuple(clone(p) for p in state.projs),
                     readout=clone(state.readout), step=state.step.clone(),
                     generator=gen)


def count_launches(fn: Callable[[], object]) -> dict:
    """Run ``fn`` and return the kernel launches its wrappers counted,
    leaving the counts as they were before it."""
    from ..kernels import ops
    before = ops.launch_counts()
    try:
        fn()
        after = ops.launch_counts()
    finally:
        ops.set_launch_counts(before)
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


class StepProgram:
    """A step run once per batch: ``step(state, *batch)``, a donated step
    over ``state``.  On the card it is captured as a CUDA graph at its
    first batch, on static copies of the batch's tensors, and replayed
    after (captured again if handed another state or batch shape); on the
    CPU it runs eagerly.  The step's return value is not used, so the
    host's share of a step (the clock mirror, the rewire) is the caller's
    on both."""

    def __init__(self, step: Callable, spec: NetworkSpec, *,
                 draws_noise: bool):
        self.step = step
        self.spec = spec
        self.draws_noise = draws_noise
        self.graph: Optional[torch.cuda.CUDAGraph] = None

    def _holds(self, state: DeepState,
               batch: Sequence[torch.Tensor]) -> bool:
        """Whether the graph steps ``state`` (the same tensors) over
        batches of ``batch``'s shapes."""
        now = state_tensors(state)
        return (self.graph is not None and len(now) == len(self._held)
                and all(a is b for a, b in zip(now, self._held))
                and all(a.shape == b.shape and a.dtype == b.dtype
                        for a, b in zip(batch, self.inputs)))

    def _capture(self, state: DeepState,
                 batch: Sequence[torch.Tensor]) -> None:
        self.graph = None  # free the old graph's pool first
        self._held = state_tensors(state)  # the graph reads and writes them
        self.inputs = tuple(t.clone() for t in batch)
        self._tables = [[p.mask, ps.nact, cached_table(p.mask, ps.nact),
                         p.mask._version]
                        for p, ps in zip(state.projs, self.spec.projs)
                        if is_patchy(ps) and p.table is None]
        scratch = scratch_clone(state)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())

        def warm_up():
            with torch.cuda.stream(side):
                self.step(scratch, *self.inputs)
            torch.cuda.current_stream().wait_stream(side)

        count_launches(warm_up)
        graph = torch.cuda.CUDAGraph()
        if self.draws_noise:
            graph.register_generator_state(state.generator)

        def capture():
            # A graph destroyed during a capture (its owner collected as
            # garbage) invalidates that capture: no collection inside it.
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph):
                    self.step(state, *self.inputs)
            finally:
                if collecting:
                    gc.enable()

        self.launches = count_launches(capture)
        self.graph = graph

    def prepare(self, state: DeepState, *batch: torch.Tensor) -> None:
        """Capture for ``state`` and batches like ``batch`` unless done
        (nothing on the CPU)."""
        if state.device.type == "cuda" and not self._holds(state, batch):
            self._capture(state, batch)

    def __call__(self, state: DeepState, *batch: torch.Tensor) -> None:
        if state.device.type != "cuda":
            self.step(state, *batch)
            return
        from ..kernels import ops
        self.prepare(state, *batch)
        for dst, src in zip(self.inputs, batch):
            dst.copy_(src)
        for entry in self._tables:
            mask, nact, table, version = entry
            if mask._version != version:  # a rewire wrote the mask
                table.copy_(build_table(mask, nact))
                entry[3] = mask._version
        self.graph.replay()
        ops.add_launch_counts(self.launches)


# ------------------------------------------------------- served batches --

def pack_tensors(params: InferParams) -> List[torch.Tensor]:
    """Every tensor of a serving pack, in a fixed order."""
    out = []
    for pk in params.projs + (params.readout,):
        out += [t for t in (pk.w, pk.b, pk.scale, pk.table) if t is not None]
    return out


def _own_pack(params: InferParams) -> InferParams:
    """A pack of tensors of its own (fp32 packs alias the state, and a
    patchy table may be the memo's)."""
    def own(pk: InferPack) -> InferPack:
        # A copy of the pack pack_state derived at this fold boundary:
        # repro: suppress[infer-pack-mutation] — only its tensors are copied
        return InferPack(*(None if t is None else t.clone()
                           for t in (pk.w, pk.b, pk.scale, pk.table)))

    return InferParams(projs=tuple(own(p) for p in params.projs),
                       readout=own(params.readout))


class _Bucket:
    """One bucket's graph: static inputs ``x``/``valid``, static outputs
    ``probs``/``pred``, pinned host copies of all four, and the launches
    one replay makes."""

    def __init__(self, graph, x, valid, probs, pred, launches):
        self.graph, self.x, self.valid = graph, x, valid
        self.probs, self.pred, self.launches = probs, pred, launches
        self.host = tuple(torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True)
                          for t in (x, valid, probs, pred))


class ServeProgram:
    """The served batch of one model: ``infer_packed(pack, spec, x,
    valid)`` at each bucket size.  On the card each bucket is captured
    once as a CUDA graph over a static pack (``pack``), static inputs and
    static outputs, and replayed per batch; on the CPU it runs eagerly
    over the pack of the last ``load``.

    ``load(state)`` is the fold boundary: it packs ``state`` and, on the
    card, writes the new pack INTO the static pack's tensors (``copy_``),
    never making new ones, so every graph and the TMA tensor maps its
    kernels encoded keep reading the addresses they recorded.  (A fp32 pack
    aliases the state, which an out-of-place fold replaces; ``pack_state``
    makes new tensors anyway.)  A rewire's new patchy table is written the
    same way.  Neither ``load`` nor a replay synchronises with the card;
    ``serve`` reads a batch's results back once.  Capture or replay
    failures raise: nothing falls back to the eager forward on the card.
    """

    def __init__(self, spec: NetworkSpec):
        self.spec = spec
        self.pack: Optional[InferParams] = None
        self.buckets: Dict[int, _Bucket] = {}

    def load(self, state: DeepState) -> InferParams:
        """Pack ``state`` into the pack the program serves from."""
        new = pack_state(state, self.spec)
        if state.device.type != "cuda":
            self.pack = new
        elif self.pack is None:
            self.pack = _own_pack(new)
        else:
            for dst, src in zip(pack_tensors(self.pack), pack_tensors(new)):
                if dst.shape != src.shape or dst.dtype != src.dtype:
                    raise ValueError(
                        f"repack changed a pack tensor from {dst.shape} "
                        f"{dst.dtype} to {src.shape} {src.dtype}")
                dst.copy_(src)
        return self.pack

    def capture(self, bucket: int) -> None:
        """Capture the served batch of ``bucket`` rows (the card only; the
        pack must be loaded).  The forward runs once on a side stream
        first, uncounted (building the kernel library and the launchers'
        caches); the collector is off during the capture; what the
        capture counted is taken back and added again per replay."""
        pack = self.pack
        dev = pack.readout.w.device
        x = torch.zeros((bucket, self.spec.input_geom.N),
                        dtype=torch.float32, device=dev)
        valid = torch.zeros((bucket,), dtype=torch.float32, device=dev)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())

        def warm_up():
            with torch.cuda.stream(side):
                infer_packed(pack, self.spec, x, valid)
            torch.cuda.current_stream().wait_stream(side)

        count_launches(warm_up)
        graph = torch.cuda.CUDAGraph()
        out: list = []

        def capture():
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph):
                    out.extend(infer_packed(pack, self.spec, x, valid))
            finally:
                if collecting:
                    gc.enable()

        launches = count_launches(capture)
        self.buckets[bucket] = _Bucket(graph, x, valid, out[0], out[1],
                                       launches)

    def __call__(self, x: torch.Tensor, valid: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(probs, pred) of a (bucket, N) batch on the pack's device.  On
        the card: ``x``/``valid`` are copied into the bucket's static
        inputs and its graph replayed; the static outputs are returned
        (the next replay of the bucket overwrites them)."""
        if x.device.type != "cuda":
            return infer_packed(self.pack, self.spec, x, valid)
        from ..kernels import ops
        b = self.buckets[x.shape[0]]
        b.x.copy_(x)
        b.valid.copy_(valid)
        b.graph.replay()
        ops.add_launch_counts(b.launches)
        return b.probs, b.pred

    def serve(self, x: np.ndarray, valid: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
        """A padded host batch in, its (probs, pred) on the host out: on
        the card, host -> pinned -> static input copies, the replay, the
        outputs copied back to pinned memory, and one wait for the stream,
        the batch's only synchronisation."""
        dev = self.pack.readout.w.device
        if dev.type != "cuda":
            probs, pred = self(torch.from_numpy(x).to(dev),
                               torch.from_numpy(valid).to(dev))
            return probs.numpy(), pred.numpy()
        from ..kernels import ops
        b = self.buckets[x.shape[0]]
        hx, hv, hp, hq = b.host
        hx.numpy()[...] = x
        hv.numpy()[...] = valid
        b.x.copy_(hx, non_blocking=True)
        b.valid.copy_(hv, non_blocking=True)
        b.graph.replay()
        ops.add_launch_counts(b.launches)
        hp.copy_(b.probs, non_blocking=True)
        hq.copy_(b.pred, non_blocking=True)
        torch.cuda.current_stream().synchronize()
        return hp.numpy().copy(), hq.numpy().copy()
