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
step, eagerly.  Nothing here reads a value back to the host inside a loop.

The constructor and ``fit`` take the JAX trainer's arguments in its order;
``device`` is a keyword of the port's own.  Not ported yet: the
data-parallel fit (``mesh=``, ``data_axis=``) and mid-fit checkpoints,
resume and the per-chunk callback (``ckpt_dir=``, ``ckpt_every_batches=``,
``resume=``, ``on_chunk=``); any value other than the default raises
``NotImplementedError`` (ROADMAP.md queue A items 7 and 3).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
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
    validity mask marking genuine rows."""
    n = x.shape[0]
    nb = max(1, -(-n // batch))
    pad = nb * batch - n
    if pad:
        x = np.concatenate(
            [x, np.zeros((pad, *x.shape[1:]), x.dtype)], axis=0)
    valid = (np.arange(nb * batch) < n).astype(np.float32)
    return (x.reshape(nb, batch, *x.shape[1:]),
            valid.reshape(nb, batch))


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
            state = learn_projection_step(state, spec, hs[b], layer, valid[b],
                                          *nz, donate=True)
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
    """

    def __init__(self, cfg, seed: int = 0, mesh=None,
                 data_axis: str = "data", *, device: DeviceLike = None):
        if mesh is not None or data_axis != "data":
            raise NotImplementedError(
                "Trainer(mesh=..., data_axis=...): the data-parallel fit is "
                "not ported yet (ROADMAP.md queue A item 7)")
        self.cfg = cfg
        self.spec = as_spec(cfg)
        self.device = resolve_device(device)
        self.state = init_deep(self.spec, seed, self.device)
        self._epoch_cache: Dict[tuple, Callable] = {}

    # -------------------------------------------------- epoch programs --
    def _unsup_fn(self, layer: int, masked: bool) -> Callable:
        """Epoch program for one greedy phase, cached per (layer, masked):
        its step is captured once and replayed in every epoch."""
        key = ("unsup", layer, masked)
        if key not in self._epoch_cache:
            program = _projection_program(self.spec, layer, frozen=False,
                                          noise=False)
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
        if key not in self._epoch_cache:
            program = _readout_program(self.spec)
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
        on_chunk: Optional[Callable] = None,
    ) -> Dict[str, float]:
        """Layerwise unsupervised epochs + one supervised pass, through
        the epoch programs (captured steps replayed per batch on the card).

        The tail batch is zero-padded and masked, never dropped: it alone
        takes the masked step, which divides its stats by the genuine row
        count; every whole batch takes the plain step.  (The JAX trainer's
        scanned epoch needs one program, so it masks every batch of such a
        fit; the numbers differ only by fp32 rounding.)  Returns the JAX
        trainer's timing keys, the first fit's capture included;
        ``straggler_events`` is always 0 (the per-chunk step timer belongs
        to the unported checkpointed fit).
        """
        if ckpt_dir is not None or ckpt_every_batches or resume \
                or on_chunk is not None:
            raise NotImplementedError(
                "Trainer.fit(ckpt_dir=, ckpt_every_batches=, resume=, "
                "on_chunk=): mid-fit checkpoints, resume and the per-chunk "
                "callback are not ported yet (ROADMAP.md queue A item 3)")
        dev = self.device
        xs_np, valid_np = _batchify_padded(np.asarray(x_train, np.float32),
                                           batch)
        ys_np, _ = _batchify_padded(np.asarray(y_train, np.int32), batch)
        masked = bool(float(valid_np.min()) < 1.0)
        xs = torch.from_numpy(xs_np).to(dev)
        ys = torch.from_numpy(ys_np).to(dev)
        valid = torch.from_numpy(valid_np).to(dev)

        t0 = time.perf_counter()
        # ``cur`` holds the dataset's rates at the current layer's input,
        # computed once per greedy phase (the layers below are frozen).
        cur = xs
        for layer in range(self.spec.depth):
            fn = self._unsup_fn(layer, masked)
            operands = (cur, valid) if masked else (cur,)
            for e in range(epochs):
                self.state = fn(self.state, *operands)
                if log:
                    print(f"  layer {layer + 1}/{self.spec.depth} "
                          f"unsupervised epoch {e + 1}/{epochs} done")
            if layer + 1 < self.spec.depth:
                cur = _propagate_batches(self.state, self.spec, cur, layer)
        _sync(dev)
        t1 = time.perf_counter()
        fn = self._sup_fn(masked)
        operands = (xs, ys, valid) if masked else (xs, ys)
        self.state = fn(self.state, *operands)
        _sync(dev)
        t2 = time.perf_counter()
        n_img = int(valid_np.sum())
        return {
            "unsup_s": t1 - t0,
            "sup_s": t2 - t1,
            "train_ms_per_img": 1e3 * (t1 - t0)
            / max(1, n_img * epochs * self.spec.depth),
            "straggler_events": 0.0,
        }

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
