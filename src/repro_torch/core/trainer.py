"""Streaming trainer for deep BCPNN, single device (mirrors
``repro/core/trainer.py``).

The paper's semi-unsupervised protocol, at any depth: for each stack
projection in turn, N epochs of unsupervised learning (lower layers frozen
while a layer trains), then ONE supervised pass on the readout, then
inference.

The epoch programs carry the JAX names.  JAX runs an epoch as one jitted
``lax.scan`` with its state donated; here an epoch is a loop over batches
that stay on the device, and each step is a ``StepProgram``
(``core/graphs.py``): on the card, captured once as a CUDA graph that
updates the state in place and replayed per batch; on the CPU, the same
donated step run eagerly.  Either way the state handed to an epoch program
is donated: its tensors hold the result, and the returned state is a
state of those tensors.  Between replays the host does its share of each
step: the clock mirror ``Traces.t_host`` moves on and, every
``struct_every`` steps, the rewire runs eagerly and writes into the
tensors the graph reads.  A zero-padded tail batch alone takes the masked
step, eagerly.  Nothing here reads a value back to the host inside an
epoch program; ``fit`` waits for the card once a chunk, to time it.

The constructor and ``fit`` take the JAX trainer's arguments in its order;
``device`` is a keyword of the port's own.  ``fit(ckpt_dir=...,
ckpt_every_batches=k)`` checkpoints every k batches with a schedule cursor
(``FitCursor``) in the manifest, and ``resume=True`` continues from it, so
a fit interrupted by worker loss ends in the state the uninterrupted fit
reaches, bit for bit (the generator's state rides in the checkpoint:
``checkpoint/ckpt.py``).

The data-parallel fit (``Trainer(cfg, seed, mesh, data_axis)``): each rank
process runs the same ``fit`` on the same data, with the state replicated;
every epoch is the mesh's data-parallel program
(``distributed/data_parallel.py``), fed this rank's rows of each batch,
and ends in the single-device fit's state bit for bit, whatever the
number of ranks (each rank forms the whole dense support by the
single-device call and keeps its columns; the trace products it splits
are column-invariant).
Those programs run eagerly (a gloo collective cannot run inside a
captured graph) and in plain torch whatever the backend says, as in JAX.
The rank first on the data axis writes the checkpoints and every rank
waits for the write before ``on_chunk``; a fit resumes on a mesh of any
size, 1 included, which is what makes worker-loss recovery exact.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import obs
from ..checkpoint import CheckpointManager, spec_manifest
from ..device import DeviceLike, resolve_device
from ..distributed.fault import StepTimer
from .bcpnn_layer import forward
from .graphs import StepProgram
from .network import (
    DeepState,
    NetworkSpec,
    as_spec,
    infer,
    init_deep,
    learn_projection_step,
    rewire_layer,
    stack_rates,
    supervised_readout_step,
)


def _batchify_padded(x: np.ndarray, batch: int):
    """Zero-pad to a whole number of batches; also return the (nb, B)
    validity mask marking genuine rows.  The plain host version of what
    ``_stage_padded`` builds on the device."""
    n = x.shape[0]
    nb = max(1, -(-n // batch))
    pad = nb * batch - n
    if pad:
        x = np.concatenate(
            [x, np.zeros((pad, *x.shape[1:]), x.dtype)], axis=0)
    valid = (np.arange(nb * batch) < n).astype(np.float32)
    return (x.reshape(nb, batch, *x.shape[1:]),
            valid.reshape(nb, batch))


# Bytes of one slot of the pinned staging ring: big enough that a chunk's
# copy dwarfs its launch, small enough that the ring stays a fixed 32 MiB
# of pinned memory a trainer device whatever the dataset (a row wider
# than a slot widens both slots to the row).
STAGING_SLOT_BYTES = 16 << 20
# Staging rings allocated in this process: one a trainer device, so it
# stays flat over a run of fits.
STAGING_ALLOCS = 0


class _StagingRing:
    """Two host slots through which a fit's rows reach the card in chunks
    of whole rows: pinned, each with the event of the last copy out of
    it, which the host waits on before it fills the slot again, so the
    host fills one slot while the card drains the other.  On a CPU device
    (tests) the slots are plain memory and each copy is done when it
    returns."""

    def __init__(self, device: torch.device, row_bytes: int):
        global STAGING_ALLOCS
        cuda = device.type == "cuda"
        self.slot_bytes = max(STAGING_SLOT_BYTES, row_bytes)
        self.slots = [torch.empty(self.slot_bytes, dtype=torch.uint8,
                                  pin_memory=cuda) for _ in range(2)]
        self.events = [torch.cuda.Event() if cuda else None
                       for _ in range(2)]
        self.turn = 0
        STAGING_ALLOCS += 1

    def copy_rows(self, dst: torch.Tensor, src: np.ndarray) -> None:
        """``dst[:len(src)] = src`` in ``dst``'s dtype, chunk by chunk
        through the slots; the copies are queued on ``dst``'s stream."""
        row = dst[0].numel() * dst.element_size()
        step = self.slot_bytes // row
        stream = (torch.cuda.current_stream(dst.device)
                  if dst.is_cuda else None)
        for a in range(0, len(src), step):
            b = min(len(src), a + step)
            slot, event = self.slots[self.turn], self.events[self.turn]
            self.turn ^= 1
            if event is not None:
                event.synchronize()
            buf = slot[:(b - a) * row].view(dst.dtype).view(
                b - a, *dst.shape[1:])
            buf.copy_(_host_tensor(src[a:b]))
            dst[a:b].copy_(buf, non_blocking=True)
            if event is not None:
                event.record(stream)

    def wait(self) -> None:
        """Until every copy out of the slots has landed."""
        for event in self.events:
            if event is not None:
                event.synchronize()


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """``a`` as a CPU tensor, sharing its memory where its layout allows."""
    return torch.from_numpy(np.ascontiguousarray(a))


@dataclasses.dataclass
class _Staged:
    """A fit's batches on its device (``_stage_padded``)."""

    xs: torch.Tensor      # (nb, B, *row) float32, pad rows zero
    ys: torch.Tensor      # (nb, B) int32, pad rows zero
    valid: torch.Tensor   # (nb, B) float32, 1 on genuine rows
    masked: bool          # whether any pad row exists
    n_img: int            # genuine rows
    h2d_bytes: int        # bytes copied from the host
    padded: float         # perf_counter at the end of the padding


def _stage_padded(x, y, batch: int, device: torch.device,
                  ring: Optional[_StagingRing]) -> _Staged:
    """``_batchify_padded``'s arrays of ``x`` (as float32) and ``y`` (as
    int32), bit for bit, made on ``device`` with no padded host copy:
    the batches are allocated there and only their pad rows zeroed
    (span ``repro_torch.fit.pad``), then the genuine rows copied in
    (``repro_torch.fit.h2d``), through ``ring`` where one is given (the
    card's pinned staging), else straight into the device tensors; the
    span ends when the copies have landed."""
    x, y = np.asarray(x), np.asarray(y)
    n = len(x)
    if len(y) != n:
        raise ValueError(f"x has {n} samples but y has {len(y)} labels")
    nb = max(1, -(-n // batch))
    with obs.span("repro_torch.fit.pad"):
        xs = torch.empty((nb * batch, *x.shape[1:]), dtype=torch.float32,
                         device=device)
        ys = torch.empty((nb * batch,), dtype=torch.int32, device=device)
        xs[n:].zero_()
        ys[n:].zero_()
        valid = (torch.arange(nb * batch, device=device) < n).to(
            torch.float32).view(nb, batch)
        padded = time.perf_counter()
    with obs.span("repro_torch.fit.h2d"):
        for dst, src in ((xs, x), (ys, y)):
            if ring is None:
                dst[:n].copy_(_host_tensor(src))
            else:
                ring.copy_rows(dst, src)
        if ring is not None:
            ring.wait()
    return _Staged(xs.view(nb, batch, *x.shape[1:]), ys.view(nb, batch),
                   valid, nb * batch > n, n, xs[:n].nbytes + ys[:n].nbytes,
                   padded)


@dataclasses.dataclass(frozen=True)
class FitCursor:
    """Where a fit stopped in the layerwise-greedy schedule, stored in the
    checkpoint manifest ``extra`` next to the spec, so a resumed fit
    continues EXACTLY where the interrupted one left off.  ``batch`` counts
    batches of the current epoch already consumed; the cursor always names
    the NEXT work item.  ``to_dict`` matches the JAX ``FitCursor``'s."""

    phase: str = "unsupervised"   # "unsupervised" | "supervised" | "done"
    layer: int = 0
    epoch: int = 0
    batch: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FitCursor":
        return cls(phase=str(d["phase"]), layer=int(d["layer"]),
                   epoch=int(d["epoch"]), batch=int(d["batch"]))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _tick(state: DeepState, layer: Optional[int]) -> DeepState:
    """What a donated step does on the host, which a replay does not run:
    the clock mirror of the projection that learned (stack projection
    ``layer``, or the readout for None) moves on by one."""
    def tick(p):
        return dataclasses.replace(p, traces=dataclasses.replace(
            p.traces, t_host=p.traces.t_host + 1))

    if layer is None:
        return dataclasses.replace(state, readout=tick(state.readout))
    projs = list(state.projs)
    projs[layer] = tick(projs[layer])
    return dataclasses.replace(state, projs=tuple(projs))


# ------------------------------------------------------ epoch programs --

def _projection_program(spec: NetworkSpec, layer: int, frozen: bool,
                        noise: bool) -> StepProgram:
    """The device's share of an unsupervised step on projection ``layer``,
    from its input rates, or (``frozen``) from the network's input through
    the frozen projections below; with ``noise`` the batch carries the
    exploration noise in place of the generator's draw."""
    def step(st, x, *nz):
        h = stack_rates(st, spec, x, depth=layer) if frozen else x
        learn_projection_step(st, spec, h, layer, noise=nz[0] if nz else None,
                              donate=True)

    return StepProgram(step, spec, draws_noise=not noise)


def _projection_epoch(program: StepProgram, state: DeepState,
                      spec: NetworkSpec, hs: torch.Tensor, layer: int,
                      valid: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None) -> DeepState:
    nb = hs.shape[0]
    for b in range(nb):
        nz = () if noise is None else (noise[b],)
        if valid is not None and b == nb - 1:  # the padded tail
            with obs.span("repro_torch.step.eager"):
                state = learn_projection_step(state, spec, hs[b], layer,
                                              valid[b], *nz, donate=True)
        else:
            program(state, hs[b], *nz)
            state = _tick(state, layer)
        state = rewire_layer(state, spec, layer, donate=True)
    return state


def unsupervised_layer_epoch(state: DeepState, spec: NetworkSpec,
                             xs: torch.Tensor, layer: int, *,
                             noise: Optional[torch.Tensor] = None
                             ) -> DeepState:
    """xs: (nbatch, B, Ni): one unsupervised epoch on stack projection
    ``layer``, each batch through the frozen projections below it.
    ``noise`` (optional, (nbatch, B, Nj)) replaces the generator's draws
    (tests inject the JAX draws).  The state is donated."""
    program = _projection_program(spec, layer, frozen=True,
                                  noise=noise is not None)
    return _projection_epoch(program, state, spec, xs, layer, noise=noise)


def unsupervised_epoch(state: DeepState, spec_or_cfg, xs: torch.Tensor,
                       layer: int = 0, *,
                       noise: Optional[torch.Tensor] = None) -> DeepState:
    """Legacy entry point (depth-1 networks train their only projection)."""
    return unsupervised_layer_epoch(state, as_spec(spec_or_cfg), xs, layer,
                                    noise=noise)


def _train_projection_epoch(state: DeepState, spec: NetworkSpec,
                            hs: torch.Tensor, layer: int, *,
                            program: Optional[StepProgram] = None
                            ) -> DeepState:
    """One epoch over PRECOMPUTED layer-input rates hs: (nbatch, B, N_l)."""
    program = program or _projection_program(spec, layer, False, False)
    return _projection_epoch(program, state, spec, hs, layer)


def _train_projection_epoch_masked(state: DeepState, spec: NetworkSpec,
                                   hs: torch.Tensor, valid: torch.Tensor,
                                   layer: int, *,
                                   program: Optional[StepProgram] = None
                                   ) -> DeepState:
    """The masked twin of ``_train_projection_epoch``: ``valid`` (nb, B)
    marks genuine rows.  The last batch, the only one with pad rows, takes
    the masked step; the others the plain one."""
    program = program or _projection_program(spec, layer, False, False)
    return _projection_epoch(program, state, spec, hs, layer, valid=valid)


def _propagate_batches(state: DeepState, spec: NetworkSpec, xs: torch.Tensor,
                       layer: int) -> torch.Tensor:
    """Push batched rates through the (now frozen) projection ``layer``."""
    return torch.stack([forward(state.projs[layer], spec.projs[layer], x)
                        for x in xs])


def _readout_program(spec: NetworkSpec) -> StepProgram:
    def step(st, x, y):
        supervised_readout_step(st, spec, x, y, donate=True)

    return StepProgram(step, spec, draws_noise=False)


def _supervised_epoch(state: DeepState, spec: NetworkSpec, xs: torch.Tensor,
                      ys: torch.Tensor, valid: Optional[torch.Tensor] = None,
                      *, program: Optional[StepProgram] = None) -> DeepState:
    program = program or _readout_program(spec)
    nb = xs.shape[0]
    for b in range(nb):
        if valid is not None and b == nb - 1:  # the padded tail
            with obs.span("repro_torch.step.eager"):
                state = supervised_readout_step(state, spec, xs[b], ys[b],
                                                valid[b], donate=True)
        else:
            program(state, xs[b], ys[b])
            state = _tick(state, None)
    return state


def supervised_epoch(state: DeepState, spec_or_cfg, xs: torch.Tensor,
                     ys: torch.Tensor) -> DeepState:
    """One readout epoch; the state is donated."""
    return _supervised_epoch(state, as_spec(spec_or_cfg), xs, ys)


def _supervised_epoch_masked(state: DeepState, spec: NetworkSpec,
                             xs: torch.Tensor, ys: torch.Tensor,
                             valid: torch.Tensor, *,
                             program: Optional[StepProgram] = None
                             ) -> DeepState:
    return _supervised_epoch(state, spec, xs, ys, valid, program=program)


class _EvalProgram:
    """The eval step: ``infer`` on a batch, its correct and genuine rows
    added into (correct, total), two 0-d accumulators that the program
    owns (``acc``, made on the first state's device)."""

    def __init__(self, spec: NetworkSpec):
        acc = self.acc = []

        def step(st, x, y, v):
            _, pred = infer(st, spec, x, valid=v)
            acc[0].add_(((pred == y).to(torch.float32) * v).sum())
            acc[1].add_(v.sum())

        self.steps = StepProgram(step, spec, draws_noise=False)

    def __call__(self, state: DeepState, xs: torch.Tensor, ys: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
        if not self.acc:
            self.acc += [torch.zeros((), dtype=torch.float32,
                                     device=state.device) for _ in range(2)]
        self.steps.prepare(state, xs[0], ys[0], valid[0])  # its warm-up adds
        correct, total = self.acc
        correct.zero_()
        total.zero_()
        for b in range(xs.shape[0]):
            self.steps(state, xs[b], ys[b], valid[b])
        return correct / torch.clamp_min(total, 1.0)


def _eval_batches(state: DeepState, spec: NetworkSpec, xs: torch.Tensor,
                  ys: torch.Tensor, valid: torch.Tensor, *,
                  program: Optional[_EvalProgram] = None) -> torch.Tensor:
    """Accuracy over genuine samples only, a 0-d tensor on the device:
    correct and total accumulate under the validity mask, so a zero-padded
    tail batch neither skews the mean nor adds phantom predictions."""
    return (program or _EvalProgram(spec))(state, xs, ys, valid)


def eval_batches(state: DeepState, spec_or_cfg, xs: torch.Tensor,
                 ys: torch.Tensor,
                 valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean accuracy over (nbatch, B, ...) eval data; ``valid`` (optional,
    (nbatch, B) 0/1) masks padded rows out of the mean."""
    if valid is None:
        valid = torch.ones(ys.shape[:2], dtype=torch.float32,
                           device=ys.device)
    return _eval_batches(state, as_spec(spec_or_cfg), xs, ys, valid)


def _eval_data(x: np.ndarray, y: np.ndarray, batch: int,
               device: torch.device):
    """(xs, ys, valid) on ``device``: the eval set zero-padded to whole
    batches, with its validity mask."""
    if len(x) != len(y):
        raise ValueError(f"x has {len(x)} samples but y has {len(y)} labels")
    xs, valid = _batchify_padded(np.asarray(x, np.float32), batch)
    ys, _ = _batchify_padded(np.asarray(y, np.int32), batch)
    return tuple(torch.from_numpy(a).to(device) for a in (xs, ys, valid))


def evaluate_padded(state: DeepState, spec_or_cfg, x: np.ndarray,
                    y: np.ndarray, batch: int = 128) -> float:
    """Accuracy of ``state`` over the FULL eval set: the tail is
    zero-padded to a whole batch and masked out of the mean, not dropped.
    The one read back to the host is the result."""
    return float(eval_batches(state, spec_or_cfg,
                              *_eval_data(x, y, batch, state.device)))


class Trainer:
    """End-to-end trainer mirroring the paper's experimental protocol.

    Accepts a ``BCPNNConfig`` (the paper's depth-1 network) or a
    ``NetworkSpec`` of any depth; ``epochs`` in ``fit`` applies per stack
    projection.  The state lives on ``device`` (keyword only): the card
    unless the caller passes ``device="cpu"``; with no card visible and no
    explicit CPU it raises.

    ``mesh`` (optional ``distributed.Mesh`` with a ``data_axis`` axis,
    built in each rank process) turns every epoch into the data-parallel
    program: batches shard over rows, learning gathers disjoint-support
    trace partials, and the state is bit for bit what the single-device
    fit produces.  Checkpointing and cursor resume work in both modes and
    across mesh sizes.
    """

    def __init__(self, cfg, seed: int = 0, mesh=None,
                 data_axis: str = "data", *, device: DeviceLike = None):
        self.cfg = cfg
        self.spec = as_spec(cfg)
        self.device = resolve_device(device)
        self.state = init_deep(self.spec, seed, self.device)
        self.mesh = mesh
        self.data_axis = data_axis
        self.timer = None  # the last fit's StepTimer
        self._epoch_cache: Dict[tuple, Callable] = {}
        self._ring: Optional[_StagingRing] = None
        if mesh is not None:
            # Fail at construction, not mid-fit: every projection the DP
            # programs touch needs whole post-HCs per shard.
            from ..distributed.data_parallel import _check_geometry
            _check_geometry(self.spec, self.spec.depth - 1,
                            mesh.shape[data_axis])

    def reset(self, seed: int = 0) -> None:
        """Re-initialize the network state (a fresh generator from
        ``seed``) while keeping the epoch programs: a captured step is
        captured again for the new state at its next call."""
        self.state = init_deep(self.spec, seed, self.device)

    # -------------------------------------------------- epoch programs --
    def _program(self, key: tuple, make: Callable) -> StepProgram:
        """The captured step behind one greedy phase, shared by its plain
        and masked epoch programs."""
        if key not in self._epoch_cache:
            self._epoch_cache[key] = make()
        return self._epoch_cache[key]

    def _unsup_fn(self, layer: int, masked: bool) -> Callable:
        """Epoch program for one greedy phase, cached per (layer, masked):
        its step is captured once and replayed in every epoch."""
        key = ("unsup", layer, masked)
        if key not in self._epoch_cache and self.mesh is not None:
            from ..distributed.data_parallel import (
                make_data_parallel_projection_epoch)
            self._epoch_cache[key] = make_data_parallel_projection_epoch(
                self.spec, self.mesh, layer=layer, axis=self.data_axis,
                masked=masked)
        if key not in self._epoch_cache:
            program = self._program(
                ("unsup-step", layer), lambda: _projection_program(
                    self.spec, layer, frozen=False, noise=False))
            if masked:
                fn = lambda st, hs, v: _train_projection_epoch_masked(  # noqa: E731
                    st, self.spec, hs, v, layer, program=program)
            else:
                fn = lambda st, hs: _train_projection_epoch(  # noqa: E731
                    st, self.spec, hs, layer, program=program)
            self._epoch_cache[key] = fn
        return self._epoch_cache[key]

    def _sup_fn(self, masked: bool) -> Callable:
        key = ("sup", masked)
        if key not in self._epoch_cache and self.mesh is not None:
            from ..distributed.data_parallel import (
                make_data_parallel_supervised_epoch)
            self._epoch_cache[key] = make_data_parallel_supervised_epoch(
                self.spec, self.mesh, axis=self.data_axis, masked=masked)
        if key not in self._epoch_cache:
            program = self._program(("sup-step",),
                                    lambda: _readout_program(self.spec))
            if masked:
                fn = lambda st, xs, ys, v: _supervised_epoch_masked(  # noqa: E731
                    st, self.spec, xs, ys, v, program=program)
            else:
                fn = lambda st, xs, ys: _supervised_epoch(  # noqa: E731
                    st, self.spec, xs, ys, program=program)
            self._epoch_cache[key] = fn
        return self._epoch_cache[key]

    def _eval_fn(self) -> Callable:
        key = ("eval",)
        if key not in self._epoch_cache:
            program = _EvalProgram(self.spec)
            self._epoch_cache[key] = lambda st, xs, ys, v: _eval_batches(  # noqa: E731
                st, self.spec, xs, ys, v, program=program)
        return self._epoch_cache[key]

    def fit(
        self,
        x_train: np.ndarray,
        y_train: np.ndarray,
        epochs: int,
        batch: int = 128,
        log: bool = False,
        ckpt_dir: Optional[str] = None,
        ckpt_every_batches: int = 0,
        resume: bool = False,
        on_chunk: Optional[Callable[[FitCursor], None]] = None,
    ) -> Dict[str, float]:
        """Layerwise unsupervised epochs + one supervised pass, through
        the epoch programs (captured steps replayed per batch on the card).

        The tail batch is zero-padded and masked, never dropped: it alone
        takes the masked step, which divides its stats by the genuine row
        count; every whole batch takes the plain step.  (The JAX trainer's
        scanned epoch needs one program, so it masks every batch of such a
        fit; the numbers differ only by fp32 rounding.)

        Fault tolerance, as the JAX trainer: with ``ckpt_dir`` and
        ``ckpt_every_batches > 0`` the fit checkpoints every k batches
        (state, spec and schedule cursor, blocking) and ``resume=True``
        continues from the latest such checkpoint.  ``on_chunk(cursor)``
        fires after every chunk (after its checkpoint): raising
        ``WorkerLost`` from it aborts the fit with the checkpoint already
        on disk.  With ``ckpt_dir`` alone the fit writes one final
        resumable checkpoint.  Chunks cannot change the result: a chunk
        replays the same captured step on a slice of the same batches, and
        only the epoch's last batch of a padded fit takes the masked step.
        Each chunk is timed (``straggler_events``), so the host waits for
        the card at the end of every chunk.

        With a mesh every rank calls ``fit`` with the same data; the epochs
        take this rank's rows of each batch (``batch`` must divide by the
        data axis), only the first rank on the axis writes checkpoints, and
        every rank waits for each write before ``on_chunk``.

        Returns host-clock seconds and counts:

        * ``unsup_s`` and ``sup_s``, the JAX trainer's keys: the
          unsupervised epochs and the supervised pass, each ending in a
          wait for the card, the first fit's captures included;
        * ``train_ms_per_img``, the JAX key with its JAX meaning: ``unsup_s``
          over the unsupervised images (genuine rows x epochs x depth), the
          unsupervised time only, without the supervised pass or the
          preparation;
        * ``pad_s``, the padding to whole batches on the fit's device (the
          batches allocated there, their pad rows zeroed, the validity
          mask built), and ``h2d_s``, the copies of the genuine rows into
          them, on the card through the trainer's pinned staging ring
          (two slots of ``STAGING_SLOT_BYTES``, allocated at its first
          fit), until they have landed; ``h2d_bytes``, the bytes those
          copies moved (the rows as float32, the labels as int32);
        * ``captures``, the steps the fit's programs captured: 0 once they
          hold this state and batch shape;
        * ``straggler_events``; with a mesh also ``comm_s``, the host time
          of the fit's collectives (``group.DataAxis.gather``).

        The fit's phases are spans (``obs.span``): ``repro_torch.fit`` the
        whole call, ``.fit.pad``, ``.fit.h2d``, ``.fit.unsup`` and
        ``.fit.sup`` the phases timed above, ``.fit.epoch`` a chunk from
        its first launch to the end of its ``.fit.sync``, and
        ``repro_torch.step.eager`` the padded tail's masked step.  Its
        report (``obs.FitReport``) joins ``obs.FITS``.
        """
        with obs.span("repro_torch.fit"):
            return self._fit(x_train, y_train, epochs, batch, log, ckpt_dir,
                             ckpt_every_batches, resume, on_chunk)

    def _staging_ring(self, x) -> Optional[_StagingRing]:
        """The ring a fit of rows ``x`` stages through: on the card, this
        trainer's, made at its first fit (and again only for a row wider
        than its slots); none on the CPU."""
        if self.device.type != "cuda":
            return None
        row_bytes = 4 * int(np.prod(np.shape(x)[1:]))
        if self._ring is None or self._ring.slot_bytes < row_bytes:
            self._ring = _StagingRing(self.device, row_bytes)
        return self._ring

    def _captures(self) -> int:
        """Captures made so far by the step programs of the epoch
        programs."""
        return sum(p.captures for p in self._epoch_cache.values()
                   if isinstance(p, StepProgram))

    def _fit(self, x_train, y_train, epochs, batch, log, ckpt_dir,
             ckpt_every_batches, resume, on_chunk) -> Dict[str, float]:
        from ..kernels import ops
        dev = self.device
        captures0 = self._captures()
        launches0 = ops.launch_counts()
        fit0 = time.perf_counter()
        staged = _stage_padded(x_train, y_train, batch, dev,
                               self._staging_ring(x_train))
        h2d1 = time.perf_counter()
        pad1 = staged.padded
        xs, ys, valid = staged.xs, staged.ys, staged.valid
        masked = staged.masked
        nb = int(xs.shape[0])
        ax = None
        if self.mesh is not None:
            n_shards = int(self.mesh.shape[self.data_axis])
            if batch % n_shards:
                raise ValueError(
                    f"batch={batch} rows cannot shard over the "
                    f"{n_shards}-way '{self.data_axis}' mesh axis")
            ax = self.mesh.axis(self.data_axis)
            comm0 = ax.comm_s
            bl = batch // n_shards
            rows = slice(ax.index * bl, (ax.index + 1) * bl)

        def local(t: torch.Tensor) -> torch.Tensor:
            """This rank's rows of every batch (all of them without a
            mesh)."""
            return t if ax is None else t[:, rows]

        mgr = CheckpointManager(ckpt_dir) if ckpt_dir is not None else None
        if resume and mgr is None:
            raise ValueError("fit(resume=True) requires ckpt_dir")
        cursor = FitCursor()
        if resume and mgr.latest_step() is not None:
            step = mgr.latest_step()
            extra = mgr.read_extra(step) or {}
            if "cursor" not in extra:
                raise ValueError(
                    f"checkpoint step_{step} under {ckpt_dir} carries no "
                    f"fit cursor — it is a final artifact, not a mid-fit "
                    f"checkpoint (restore it with Trainer.restore)")
            self.state = mgr.restore(step, self.state)
            cursor = FitCursor.from_dict(extra["cursor"])
            if log:
                print(f"  resumed step_{step} at {cursor}")
        timer = StepTimer()
        self.timer = timer

        def save(cur: FitCursor, every: bool = True) -> None:
            if mgr is None or (ckpt_every_batches <= 0 and every):
                return
            if ax is None or ax.index == 0:
                mgr.save(int(self.state.step), self.state, blocking=True,
                         extra={"spec": spec_manifest(self.spec),
                                "cursor": cur.to_dict()})
            if ax is not None:
                ax.barrier()

        def run_epoch(plain: Callable, tail: Callable, operands: tuple,
                      start_b: int, tag: str,
                      cursor_at: Callable[[int], FitCursor]) -> None:
            """One epoch from batch ``start_b``, in checkpoint-delimited
            chunks (the whole epoch at once when not checkpointing).  The
            chunk holding a padded fit's last batch runs ``tail`` (the
            masked epoch program, with the validity rows as its last
            operand); every other chunk ``plain``."""
            b0 = start_b
            while b0 < nb:
                n = (nb - b0 if ckpt_every_batches <= 0
                     else min(ckpt_every_batches, nb - b0))
                end = b0 + n
                timer.start()
                with obs.span("repro_torch.fit.epoch"):
                    if masked and end == nb:
                        self.state = tail(self.state,
                                          *(op[b0:end] for op in operands),
                                          valid[b0:end])
                    else:
                        self.state = plain(self.state,
                                           *(op[b0:end] for op in operands))
                    with obs.span("repro_torch.fit.sync"):
                        _sync(dev)
                timer.stop(int(self.state.step), tag=tag)
                b0 = end
                cur = cursor_at(b0)
                save(cur)
                if on_chunk is not None:
                    on_chunk(cur)

        depth = self.spec.depth
        with obs.span("repro_torch.fit.unsup"):
            t0 = time.perf_counter()
            if cursor.phase == "unsupervised":
                # ``cur`` holds the dataset's rates at the current layer's
                # input, computed once per greedy phase (the layers below
                # are frozen), and recomputed up to the cursor on resume.
                cur = xs
                for l in range(cursor.layer):
                    cur = _propagate_batches(self.state, self.spec, cur,
                                             l)
                for layer in range(cursor.layer, depth):
                    first = layer == cursor.layer
                    plain = self._unsup_fn(layer, False)
                    tail = (self._unsup_fn(layer, True) if masked
                            else None)
                    for e in range(cursor.epoch if first else 0, epochs):
                        start_b = (cursor.batch
                                   if first and e == cursor.epoch else 0)

                        def cursor_at(b, layer=layer, e=e):
                            if b < nb:
                                return FitCursor("unsupervised", layer, e, b)
                            if e + 1 < epochs:
                                return FitCursor("unsupervised", layer,
                                                 e + 1, 0)
                            if layer + 1 < depth:
                                return FitCursor("unsupervised", layer + 1,
                                                 0, 0)
                            return FitCursor("supervised", depth, 0, 0)

                        run_epoch(plain, tail, (local(cur),), start_b,
                                  f"unsup/L{layer}/e{e}", cursor_at)
                        if log:
                            print(f"  layer {layer + 1}/{depth} "
                                  f"unsupervised epoch {e + 1}/{epochs} "
                                  f"done")
                    if layer + 1 < depth:
                        cur = _propagate_batches(self.state, self.spec, cur,
                                                 layer)
                cursor = FitCursor("supervised", depth, 0, 0)
            _sync(dev)
            t1 = time.perf_counter()
        with obs.span("repro_torch.fit.sup"):
            if cursor.phase == "supervised":
                def sup_cursor_at(b):
                    if b < nb:
                        return FitCursor("supervised", depth, 0, b)
                    return FitCursor("done", depth, 0, 0)

                run_epoch(self._sup_fn(False),
                          self._sup_fn(True) if masked else None,
                          (local(xs), local(ys)),
                          cursor.batch, "sup/readout", sup_cursor_at)
                cursor = FitCursor("done", depth, 0, 0)
            _sync(dev)
            t2 = time.perf_counter()
        save(cursor, every=False)
        n_img = staged.n_img
        captures = self._captures() - captures0
        stats = {
            "unsup_s": t1 - t0,
            "sup_s": t2 - t1,
            "train_ms_per_img": 1e3 * (t1 - t0)
            / max(1, n_img * epochs * depth),
            "pad_s": pad1 - fit0,
            "h2d_s": h2d1 - pad1,
            "h2d_bytes": float(staged.h2d_bytes),
            "captures": float(captures),
            "straggler_events": float(len(timer.events)),
        }
        if ax is not None:
            stats["comm_s"] = ax.comm_s - comm0
        launches = ops.launch_counts()
        obs.FITS.append(obs.FitReport(
            t0=fit0, t1=time.perf_counter(), pad=(fit0, pad1),
            h2d=(pad1, h2d1), unsup=(t0, t1), sup=(t1, t2),
            captures=captures,
            launches={k: n - launches0[k] for k, n in launches.items()
                      if n != launches0[k]},
            h2d_bytes=staged.h2d_bytes))
        return stats

    def evaluate(self, x: np.ndarray, y: np.ndarray,
                 batch: int = 128) -> float:
        """Accuracy over the FULL eval set (padded, masked tail), through
        the cached eval program."""
        return float(self._eval_fn()(self.state,
                                     *_eval_data(x, y, batch, self.device)))

    def predict(self, x: np.ndarray) -> np.ndarray:
        xt = torch.from_numpy(np.asarray(x, np.float32)).to(self.device)
        _, pred = infer(self.state, self.spec, xt)
        return pred.cpu().numpy()

    # ------------------------------------------------------ checkpoints --
    def save(self, directory: str, step: Optional[int] = None) -> None:
        """Blocking checkpoint of the full state, in the JAX package's
        format.  The spec is stored alongside (manifest ``extra``), so
        serving can rebuild the network from the checkpoint directory
        alone."""
        mgr = CheckpointManager(directory)
        mgr.save(step if step is not None else int(self.state.step),
                 self.state, blocking=True,
                 extra={"spec": spec_manifest(self.spec)})

    def restore(self, directory: str, step: Optional[int] = None) -> int:
        """Restore the latest (or a specific) checkpoint into this trainer:
        a state of new tensors and a new generator (``checkpoint/ckpt.py``
        says how the generator is set), so the captured steps are captured
        again on their next call.  The target structure comes from the
        current spec, so depth or geometry mismatches fail with a clear
        error."""
        mgr = CheckpointManager(directory)
        step = step if step is not None else mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
        self.state = mgr.restore(step, self.state)
        return step
