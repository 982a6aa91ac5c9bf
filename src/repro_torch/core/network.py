"""Deep BCPNN: projection stacks and the execution engine (mirrors
``repro/core/network.py``).

A network is a chain of hypercolumnar populations

    input -> hidden_1 -> ... -> hidden_L -> output

with one plastic ``Projection`` per adjacent population pair plus the
supervised readout head.  ``NetworkSpec`` is the static description,
``DeepState`` the learnable state.  The three execution modes of the
paper run over any depth: layerwise-greedy unsupervised learning,
supervised readout learning, and inference.

Every step function returns a NEW ``DeepState`` and leaves its input's
tensors as they were; the one thing shared and advanced in place is the
state's ``torch.Generator``, which every draw of exploration noise
consumes.  With ``donate=True`` (keyword only) a learning step instead
writes its result over the input's tensors and returns a state of those
same tensors, bit for bit what the functional step gives: the port's
counterpart of the JAX epoch's ``donate_argnums``, and what a captured
step (``core/graphs.py``) needs.  Structural plasticity rides along after
each stack learn (``maybe_rewire``): the rewire decision reads the host
mirror of the trace clock, so no step reads the card back.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch

from ..device import DeviceLike, make_generator, resolve_device
from .bcpnn_layer import (
    InferPack,
    Projection,
    ProjSpec,
    forward,
    init_projection,
    learn,
    learn_masked,
    maybe_rewire,
    normalize,
    pack_projection,
    packed_forward,
    packed_support,
    support,
)
from .hypercolumns import LayerGeom

GeomLike = Union[LayerGeom, Tuple[int, int]]


# ---------------------------------------------------------------- spec --

@dataclasses.dataclass(frozen=True)
class NetworkSpec:
    """Static description of a deep BCPNN (hashable).

    ``projs[l]`` connects population l to population l+1; ``readout``
    connects the last hidden population to the output population (one WTA
    hypercolumn over the classes)."""

    projs: Tuple[ProjSpec, ...]
    readout: ProjSpec

    def __post_init__(self):
        if not self.projs:
            raise ValueError("NetworkSpec needs at least one stack projection")
        for a, b in zip(self.projs, self.projs[1:]):
            if a.post != b.pre:
                raise ValueError(f"population mismatch in stack: {a.post} "
                                 f"feeds {b.pre}")
        if self.projs[-1].post != self.readout.pre:
            raise ValueError("readout.pre must equal the last hidden geometry")

    @property
    def depth(self) -> int:
        return len(self.projs)

    @property
    def input_geom(self) -> LayerGeom:
        return self.projs[0].pre

    @property
    def output_geom(self) -> LayerGeom:
        return self.readout.post

    @property
    def n_classes(self) -> int:
        return self.output_geom.N

    def with_backend(self, backend: str) -> "NetworkSpec":
        """Same network, every projection on ``backend``."""
        return NetworkSpec(
            projs=tuple(p.with_backend(backend) for p in self.projs),
            readout=self.readout.with_backend(backend),
        )

    def with_infer_dtype(self, infer_dtype: str) -> "NetworkSpec":
        """Same network, every projection serving in ``infer_dtype``."""
        return NetworkSpec(
            projs=tuple(p.with_infer_dtype(infer_dtype) for p in self.projs),
            readout=self.readout.with_infer_dtype(infer_dtype),
        )

    @property
    def uses_low_precision(self) -> bool:
        return any(p.infer_dtype != "fp32"
                   for p in self.projs + (self.readout,))


def _as_geom(g: GeomLike) -> LayerGeom:
    return g if isinstance(g, LayerGeom) else LayerGeom(*g)


def make_network_spec(
    input_geom: GeomLike,
    hidden: Sequence[GeomLike],
    n_classes: int,
    alpha: float = 1e-3,
    eps: float = 1e-4,
    gain: float = 1.0,
    nact: Optional[Sequence[Optional[int]]] = None,
    backend: str = "cuda",
    support_noise: float = 3.0,
    noise_steps: int = 500,
    struct_every: int = 0,
    patchy_traces: bool = False,
    compact: bool = False,
    infer_dtype: str = "fp32",
) -> NetworkSpec:
    """Build a NetworkSpec for a stack of ``len(hidden)`` hidden layers
    (same arguments and validation as the JAX function)."""
    geoms = [_as_geom(input_geom)] + [_as_geom(h) for h in hidden]
    nacts = list(nact) if nact is not None else [None] * (len(geoms) - 1)
    if len(nacts) != len(geoms) - 1:
        raise ValueError(f"nact has {len(nacts)} entries for "
                         f"{len(geoms) - 1} projections")
    eligible = [na is not None and na < pre.H
                for pre, na in zip(geoms[:-1], nacts)]
    if compact and not (patchy_traces and any(eligible)):
        raise ValueError(
            "compact=True requires patchy_traces=True and at least one "
            f"projection with a binding nact budget (nact={nacts})")
    projs = tuple(
        ProjSpec(pre, post, alpha=alpha, eps=eps, gain=gain, nact=na,
                 backend=backend, support_noise=support_noise,
                 noise_steps=noise_steps, struct_every=struct_every,
                 patchy_traces=patchy_traces,
                 compact=compact and patchy_traces and ok,
                 infer_dtype=infer_dtype)
        for (pre, post, na), ok in zip(
            zip(geoms[:-1], geoms[1:], nacts), eligible)
    )
    readout = ProjSpec(geoms[-1], LayerGeom(1, n_classes), alpha=alpha,
                       eps=eps, gain=gain, nact=None, backend=backend,
                       infer_dtype=infer_dtype)
    return NetworkSpec(projs=projs, readout=readout)


# --------------------------------------------------------------- state --

@dataclasses.dataclass
class DeepState:
    """All learnable state, on one device.  ``generator`` (on that device)
    takes the place of the JAX PRNG key: it is advanced in place by every
    noisy unsupervised step."""

    projs: Tuple[Projection, ...]
    readout: Projection
    step: torch.Tensor  # 0-d int32 streaming-step counter
    generator: torch.Generator

    @property
    def device(self) -> torch.device:
        return self.readout.w.device


def init_deep(spec: NetworkSpec, seed: int = 0,
              device: DeviceLike = None) -> DeepState:
    """Fresh state on ``device`` (the card unless ``"cpu"`` is asked for),
    every random draw (traces, patchy masks) from one generator seeded
    with ``seed``."""
    dev = resolve_device(device)
    gen = make_generator(seed, dev)
    projs = tuple(init_projection(p, gen) for p in spec.projs)
    return DeepState(
        projs=projs,
        readout=init_projection(spec.readout, gen),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        generator=gen,
    )


# ---------------------------------------------------------------- modes --

def stack_rates(state: DeepState, spec: NetworkSpec, x: torch.Tensor,
                depth: Optional[int] = None) -> torch.Tensor:
    """Deterministic forward through the first ``depth`` stack projections
    (all of them by default).  x: (B, N_input)."""
    n = spec.depth if depth is None else depth
    h = x
    for l in range(n):
        h = forward(state.projs[l], spec.projs[l], h)
    return h


def _noisy_rates(proj: Projection, pspec: ProjSpec, h: torch.Tensor,
                 generator: torch.Generator,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Post rates with annealed exploration noise on the support:
    ``normalize(s + amp * noise)``, amp falling linearly to 0 over
    ``noise_steps`` updates of the projection's own trace clock.  The noise
    is drawn from ``generator`` unless the caller passes it (tests inject
    the JAX draw)."""
    s = support(proj, pspec, h)
    t = proj.traces.t.to(torch.float32)
    amp = pspec.support_noise * torch.clamp_min(
        1.0 - t / max(1, pspec.noise_steps), 0.0)
    if noise is None:
        noise = torch.randn(s.shape, generator=generator, dtype=s.dtype,
                            device=s.device)
    s = s + amp * noise
    return normalize(s, pspec)


def _with_proj(state: DeepState, layer: int, proj: Projection,
               step: torch.Tensor) -> DeepState:
    projs = state.projs[:layer] + (proj,) + state.projs[layer + 1:]
    return DeepState(projs=projs, readout=state.readout, step=step,
                     generator=state.generator)


def _next_step(state: DeepState, donate: bool) -> torch.Tensor:
    return state.step.add_(1) if donate else state.step + 1


def learn_projection_step(state: DeepState, spec: NetworkSpec,
                          h: torch.Tensor, layer: int,
                          valid: Optional[torch.Tensor] = None,
                          noise: Optional[torch.Tensor] = None, *,
                          donate: bool = False) -> DeepState:
    """``train_projection_step`` without its rewire: the device's share of
    the step, which a captured step replays (the rewire is decided on the
    host clock, between replays: ``rewire_layer``)."""
    pspec = spec.projs[layer]
    y = _noisy_rates(state.projs[layer], pspec, h, state.generator, noise)
    if valid is None:
        proj = learn(state.projs[layer], pspec, h, y, donate=donate)
    else:
        proj = learn_masked(state.projs[layer], pspec, h, y, valid,
                            donate=donate)
    return _with_proj(state, layer, proj, _next_step(state, donate))


def rewire_layer(state: DeepState, spec: NetworkSpec, layer: int, *,
                 donate: bool = False) -> DeepState:
    """``maybe_rewire`` on stack projection ``layer``."""
    proj = maybe_rewire(state.projs[layer], spec.projs[layer], donate=donate)
    if proj is state.projs[layer]:
        return state
    return _with_proj(state, layer, proj, state.step)


def train_projection_step(state: DeepState, spec: NetworkSpec,
                          h: torch.Tensor, layer: int,
                          valid: Optional[torch.Tensor] = None,
                          noise: Optional[torch.Tensor] = None, *,
                          donate: bool = False) -> DeepState:
    """Plasticity on stack projection ``layer`` given its DIRECT input
    rates ``h`` (the frozen lower layers already applied).  ``valid``
    (optional, (B,) 0/1) marks genuine rows of a zero-padded tail batch,
    whose stats then divide by the real row count (``learn_masked``).
    ``noise`` (optional, (B, Nj)) replaces the draw from the generator."""
    state = learn_projection_step(state, spec, h, layer, valid, noise,
                                  donate=donate)
    return rewire_layer(state, spec, layer, donate=donate)


def unsupervised_layer_step(state: DeepState, spec: NetworkSpec,
                            x: torch.Tensor, layer: int, *,
                            noise: Optional[torch.Tensor] = None,
                            donate: bool = False) -> DeepState:
    """One streaming batch of unsupervised learning on stack projection
    ``layer`` (projections below it are frozen feature extractors)."""
    h = stack_rates(state, spec, x, depth=layer)
    return train_projection_step(state, spec, h, layer, noise=noise,
                                 donate=donate)


def _one_hot(labels: torch.Tensor, n: int, like: torch.Tensor) -> torch.Tensor:
    """(B,) labels -> (B, n) one-hots, built by comparison: ``F.one_hot``
    checks the label range on the host, a read from the card per step."""
    classes = torch.arange(n, device=labels.device)
    return (labels.long()[:, None] == classes).to(like.dtype)


def supervised_readout_step(state: DeepState, spec: NetworkSpec,
                            x: torch.Tensor, labels: torch.Tensor,
                            valid: Optional[torch.Tensor] = None, *,
                            donate: bool = False) -> DeepState:
    """One streaming batch of the supervised readout (labels: (B,) int).
    The stack is frozen; only the readout projection learns."""
    h = stack_rates(state, spec, x)
    y = _one_hot(labels, spec.n_classes, h)
    if valid is None:
        ro = learn(state.readout, spec.readout, h, y, donate=donate)
    else:
        ro = learn_masked(state.readout, spec.readout, h, y, valid,
                          donate=donate)
    return DeepState(projs=state.projs, readout=ro,
                     step=_next_step(state, donate),
                     generator=state.generator)


def online_learn_step(state: DeepState, spec: NetworkSpec, x: torch.Tensor,
                      labels: torch.Tensor,
                      learn_stack: bool = True) -> DeepState:
    """One serving-mode learning step on a labelled batch.

    With ``learn_stack=True`` every stack projection learns from its own
    deterministic activations (post rates from the pre-update weights, no
    exploration noise), with the ``struct_every`` rewire riding along; the
    readout then takes the supervised update.
    With ``learn_stack=False`` this is exactly ``supervised_readout_step``.
    """
    h = x
    projs = []
    for proj, pspec in zip(state.projs, spec.projs):
        y = forward(proj, pspec, h)
        projs.append(maybe_rewire(learn(proj, pspec, h, y), pspec)
                     if learn_stack else proj)
        h = y
    ro = learn(state.readout, spec.readout, h,
               _one_hot(labels, spec.n_classes, h))
    return DeepState(projs=tuple(projs), readout=ro,
                     step=state.step + 1, generator=state.generator)


# ------------------------------------------------- packed inference ----

@dataclasses.dataclass
class InferParams:
    """Forward-only network view in the serving dtypes: one ``InferPack``
    per stack projection plus the readout, derived from the fp32
    ``DeepState`` by ``pack_state`` at fold boundaries (DESIGN.md §8)."""

    projs: Tuple[InferPack, ...]
    readout: InferPack


def pack_state(state: DeepState, spec_or_cfg) -> InferParams:
    """Every projection's inference weights in its spec'd ``infer_dtype``:
    fp32 packs alias the state's tensors, bf16 casts, int8 quantizes with
    per-post-HC scales.  A pack is a snapshot: after a fold, pack again."""
    spec = as_spec(spec_or_cfg)
    return InferParams(
        projs=tuple(pack_projection(p, ps)
                    for p, ps in zip(state.projs, spec.projs)),
        readout=pack_projection(state.readout, spec.readout),
    )


def _mask_invalid(probs: torch.Tensor, pred: torch.Tensor,
                  valid: Optional[torch.Tensor]):
    if valid is None:
        return probs, pred
    keep = valid.to(torch.bool)
    probs = probs * keep[:, None].to(probs.dtype)
    pred = torch.where(keep, pred, torch.full_like(pred, -1))
    return probs, pred


def infer_packed(params: InferParams, spec_or_cfg, x: torch.Tensor,
                 valid: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``infer`` over pre-derived ``InferParams``: the serving hot path.
    Equal to ``infer`` for all-fp32 specs (the packs alias the state);
    low-precision specs serve the weights packed at the last fold boundary,
    never requantized per request."""
    spec = as_spec(spec_or_cfg)
    h = x
    for pack, pspec in zip(params.projs, spec.projs):
        h = packed_forward(pack, pspec, h)
    s = packed_support(params.readout, spec.readout, h)
    probs = normalize(s, spec.readout)
    return _mask_invalid(probs, probs.argmax(dim=-1), valid)


def infer(state: DeepState, spec_or_cfg, x: torch.Tensor,
          valid: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference-only path: class probabilities + argmax predictions (the
    first maximum wins, as in JAX).  ``valid`` (optional, (B,) 0/1) marks
    genuine rows of a padded batch: pad rows get probs 0 and pred -1.
    Specs with a low-precision ``infer_dtype`` evaluate through the pack
    and packed forward the serving path uses (packing on every call), so
    offline accuracy is the serving dtype's; all-fp32 specs read the state
    directly."""
    spec = as_spec(spec_or_cfg)
    if spec.uses_low_precision:
        return infer_packed(pack_state(state, spec), spec, x, valid)
    h = stack_rates(state, spec, x)
    s = support(state.readout, spec.readout, h)
    probs = normalize(s, spec.readout)
    return _mask_invalid(probs, probs.argmax(dim=-1), valid)


# ------------------------------------------------- depth-1 preset ----

@dataclasses.dataclass(frozen=True)
class BCPNNConfig:
    """The paper's three-population network (Table 1 schema) — a thin
    preset over NetworkSpec with exactly one hidden layer."""

    input_hc: int
    input_mc: int = 2
    hidden_hc: int = 32
    hidden_mc: int = 128
    n_classes: int = 10
    nact_hi: int = 128
    alpha: float = 1e-3
    eps: float = 1e-4
    gain: float = 1.0
    struct_every: int = 0
    support_noise: float = 3.0
    noise_steps: int = 500
    backend: str = "cuda"
    patchy_traces: bool = False
    compact: bool = False
    infer_dtype: str = "fp32"

    @property
    def input_geom(self) -> LayerGeom:
        return LayerGeom(self.input_hc, self.input_mc)

    @property
    def hidden_geom(self) -> LayerGeom:
        return LayerGeom(self.hidden_hc, self.hidden_mc)

    @property
    def output_geom(self) -> LayerGeom:
        return LayerGeom(1, self.n_classes)

    def ih_spec(self) -> ProjSpec:
        if self.compact and not (self.patchy_traces
                                 and self.nact_hi < self.input_hc):
            raise ValueError(
                "BCPNNConfig.compact requires patchy_traces=True and "
                f"nact_hi < input_hc (got patchy_traces="
                f"{self.patchy_traces}, nact_hi={self.nact_hi}, "
                f"input_hc={self.input_hc})")
        return ProjSpec(self.input_geom, self.hidden_geom, alpha=self.alpha,
                        eps=self.eps, gain=self.gain, nact=self.nact_hi,
                        backend=self.backend,
                        support_noise=self.support_noise,
                        noise_steps=self.noise_steps,
                        struct_every=self.struct_every,
                        patchy_traces=self.patchy_traces,
                        compact=self.compact,
                        infer_dtype=self.infer_dtype)

    def ho_spec(self) -> ProjSpec:
        return ProjSpec(self.hidden_geom, self.output_geom, alpha=self.alpha,
                        eps=self.eps, gain=self.gain, nact=None,
                        backend=self.backend, infer_dtype=self.infer_dtype)

    def network_spec(self) -> NetworkSpec:
        return NetworkSpec(projs=(self.ih_spec(),), readout=self.ho_spec())


def as_spec(spec_or_cfg) -> NetworkSpec:
    """Normalize a BCPNNConfig or NetworkSpec to a NetworkSpec."""
    if isinstance(spec_or_cfg, NetworkSpec):
        return spec_or_cfg
    return spec_or_cfg.network_spec()


# ------------------------------------------------- depth-1 helpers ----

def init_network(spec_or_cfg, seed: int = 0,
                 device: DeviceLike = None) -> DeepState:
    """``init_deep`` from a BCPNNConfig or a NetworkSpec."""
    return init_deep(as_spec(spec_or_cfg), seed, device)


def hidden_rates(state: DeepState, spec_or_cfg,
                 x: torch.Tensor) -> torch.Tensor:
    """The deterministic rates of the last hidden population."""
    return stack_rates(state, as_spec(spec_or_cfg), x)


def unsupervised_step(state: DeepState, spec_or_cfg, x: torch.Tensor,
                      layer: int = 0, *,
                      noise: Optional[torch.Tensor] = None,
                      donate: bool = False) -> DeepState:
    """One streaming batch of unsupervised representation learning."""
    return unsupervised_layer_step(state, as_spec(spec_or_cfg), x, layer,
                                   noise=noise, donate=donate)


def supervised_step(state: DeepState, spec_or_cfg, x: torch.Tensor,
                    labels: torch.Tensor, *,
                    donate: bool = False) -> DeepState:
    """One streaming batch of the supervised readout (labels: (B,) int)."""
    return supervised_readout_step(state, as_spec(spec_or_cfg), x, labels,
                                   donate=donate)


# ------------------------------------------------- spec (de)serialization --

# A JAX manifest names the JAX package's backends; map them onto the port's.
_BACKEND_FROM_JAX = {"jnp": "torch", "pallas": "cuda"}


def _projspec_to_dict(p: ProjSpec) -> dict:
    d = dataclasses.asdict(p)
    d["pre"] = [p.pre.H, p.pre.M]
    d["post"] = [p.post.H, p.post.M]
    return d


def _projspec_from_dict(d: dict) -> ProjSpec:
    d = dict(d)
    d["pre"] = LayerGeom(*d["pre"])
    d["post"] = LayerGeom(*d["post"])
    d["backend"] = _BACKEND_FROM_JAX.get(d["backend"], d["backend"])
    return ProjSpec(**d)


def spec_to_dict(spec_or_cfg) -> dict:
    """JSON-serializable description of a NetworkSpec."""
    spec = as_spec(spec_or_cfg)
    return {
        "projs": [_projspec_to_dict(p) for p in spec.projs],
        "readout": _projspec_to_dict(spec.readout),
    }


def spec_from_dict(d: dict) -> NetworkSpec:
    """Inverse of ``spec_to_dict``; also reads a JAX package's manifest
    (backend ``"jnp"`` -> ``"torch"``, ``"pallas"`` -> ``"cuda"``)."""
    return NetworkSpec(
        projs=tuple(_projspec_from_dict(p) for p in d["projs"]),
        readout=_projspec_from_dict(d["readout"]),
    )
