"""Captured steps: one training or evaluation step recorded once as a CUDA
graph and replayed per batch.  The port's own module: the JAX trainer runs
each epoch as one jitted, donated ``lax.scan``, and XLA's jit has no module
to mirror.

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
from typing import Callable, List, Optional, Sequence

import torch

from .bcpnn_layer import Projection, is_patchy
from .compact import build_table, cached_table
from .network import DeepState, NetworkSpec
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
