"""Multi-pod dry run: every (arch x shape) cell's step on one rank of the
production meshes, under fake tensors, with no card (mirrors
``repro/launch/dryrun.py``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod|--both-meshes] [--out DIR]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
        --shape train_4k --mesh-shape 2x2 --batch 8 --seq 256

``--mesh-shape`` lays a smaller fake group out on the production axes and
``--batch``/``--seq`` replace the shape's batch and length (to hold an
estimate against a run on the card); ``--smoke`` takes the reduced
configs.  Records go to ``experiments/dryrun_torch/`` by default.

The JAX dry run lowers and compiles each cell for 512 fake host devices and
reads XLA's memory and cost analyses.  Here this process is rank 0 of a
fake default group of 256 or 512 ranks (``launch/mesh.py``,
``fake=True``), and it runs the cell's real step of the port on that
rank under ``FakeTensorMode``: the parameters are the ``meta`` LM placed by
the cell's rules (``params.distribute_params``: this rank's blocks, never
initialised), the inputs are ``steps.input_specs`` placed as the
launchers place them (their bytes a rank must equal what
``input_shardings`` give), and every operation runs on fake tensors, so nothing
is allocated and no kernel runs.  The fake tensors are CPU tensors
(autograd cannot take a card tensor in a torch built without CUDA); bytes
and FLOPs do not depend on the device type.

Each cell writes one JSON record:

* ``memory.argument_size_in_bytes``: what the placements give this rank of
  the step's inputs (parameters, ``mu``, ``nu``, ``step`` and the batch to
  train; parameters and the batch to prefill; parameters, the decode cache
  and the tokens to decode), by input under ``arguments``.  It is computed
  from the specs (``holdings``) and must equal the bytes of the fake
  tensors the step is given.
* ``memory.peak_memory_in_bytes``: the most bytes of fake storage alive at
  once during the step, the arguments included (``StepMeter``): gradients,
  activations, the optimizer's temporaries and the collectives' buffers.
  ``temp_size_in_bytes`` is the peak less the arguments;
  ``output_size_in_bytes`` the bytes of what the step returns (the port
  writes parameters, moments and the decode cache in place, so those
  outputs are the argument tensors themselves).
* ``roofline.flops``: the FLOPs this rank runs, by torch's FLOP formulas
  (``torch.utils.flop_counter``, the counter of ``FlopCounterMode``) over
  every operation on this rank's blocks, and ``flops_by_dtype`` by the
  dtype of each counted operation's operands; ``bytes``: the bytes of
  every operation's results on this rank times 2 for their reads, the JAX
  rule (a view writes nothing, an in-place or ``out=`` operation the
  bytes it writes); ``coll_bytes`` and ``coll_detail``: the bytes of the
  functional collectives DTensor issues, the larger of a collective's
  operand and result (an all-reduce counted twice), by the JAX names;
  ``compute_s``, ``memory_s``, ``collective_s`` and ``bottleneck``: those
  counts priced with the H100's peaks (``launch/roofline.py::analyze``);
  ``model_flops_per_chip`` and ``useful_ratio`` as JAX computes them.
* ``fits_80GB``: the peak is at most 80 GiB, the memory of one rank of an
  NVIDIA H100 80GB HBM3.
* ``lacks``: the key of the JAX record that has no counterpart here and is
  not written: the compiled code's size (nothing is compiled).

A cell that fails is recorded with its error and the sweep goes on; the
process exits 1 if any cell failed.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import time
import traceback
import weakref
from contextlib import contextmanager
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs import ARCHS, SHAPES, get_config
from ..configs.base import ModelConfig, ShapeConfig
from ..convert import lm_leaf_groups
from ..distributed.sharding import (_COLLECTIVE_NS, Mesh, _is_collective,
                                    make_rules, place_like, sharding_context,
                                    split_mesh)
from ..models import lm
from ..models.params import distribute_params
from ..optim import AdamWConfig, init_opt_state
from . import roofline as rf
from . import steps as st
from .mesh import make_production_mesh
from .train import batch_dims

# One rank's memory: an NVIDIA H100 80GB HBM3.
RANK_MEMORY_BYTES = 80 * 2**30
RANK_DEVICE = "NVIDIA H100 80GB HBM3"
# Keys of the JAX record this one cannot fill.
LACKS = ("memory.generated_code_size_in_bytes",)
DEFAULT_OUT = "experiments/dryrun_torch"
# The functional collectives by the JAX (HLO) names of the record.
_COLLECTIVE_NAMES = {"all_gather_into_tensor": "all-gather",
                     "all_gather_into_tensor_coalesced": "all-gather",
                     "all_reduce": "all-reduce",
                     "all_reduce_coalesced": "all-reduce",
                     "reduce_scatter_tensor": "reduce-scatter",
                     "reduce_scatter_tensor_coalesced": "reduce-scatter",
                     "all_to_all_single": "all-to-all",
                     "broadcast": "broadcast"}


# Cells skipped by design (see DESIGN.md §4): long_500k needs a
# sub-quadratic trunk; full-attention archs cannot represent a 524k-token
# KV pass without changing the architecture.
def cell_skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> str:
    if shape.name == "long_500k" and not cfg.subquadratic:
        return "full-attention arch: 524k-token cache is quadratic (skip per brief)"
    return ""


# variants that transform the model config instead of the sharding rules
CFG_VARIANTS = {
    "ssmchunk": lambda cfg: cfg.with_(ssm_chunk=16),
}

VARIANTS = {
    # Megatron-style sequence parallelism: residual stream sharded over
    # the model axis on SEQ (not d_model) — §Perf iteration.
    "sp": {"seq": "model", "embed": None},
    # activations fully replicated across model axis (ablation)
    "replicated": {"embed": None},
    # column-only weight sharding: model axis never holds a contraction
    # dim -> no partial-sum (f32-upcast) all-reduces, only bf16 gathers
    "colshard": {"row_in": "data", "row_out": "model"},
}


def rules_for(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
              variant: str = ""):
    """Per-cell logical->physical overrides."""
    overrides = {}
    if variant and variant in VARIANTS:
        overrides.update(VARIANTS[variant])
    if shape.kind == "decode":
        # shard the KV cache over the model axis: heads when divisible,
        # else the sequence dim (long-context sequence sharding)
        if cfg.n_kv_heads and cfg.n_kv_heads % mesh.shape["model"] != 0:
            overrides["cache_seq"] = "model"
            overrides["kv_heads"] = None
        else:
            overrides["cache_seq"] = None
    return make_rules(mesh, overrides)


# -------------------------------------------------------------- holdings --

def _local_bytes(spec, sharding, mesh: Mesh) -> int:
    """Bytes of a rank's block of a leaf of ``spec`` (a ``ShapeDtype``)
    placed by ``sharding``: each dimension divided by the sizes of the mesh
    axes its entry names."""
    n = 1
    parts = tuple(sharding.spec) if sharding is not None else ()
    for i, size in enumerate(spec.shape):
        ax = parts[i] if i < len(parts) else None
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None:
                size //= mesh.shape[a]
        n *= size
    return n * spec.dtype.itemsize


def _sum_bytes(specs: Dict[str, Any], shardings: Dict[str, Any],
               mesh: Mesh) -> int:
    return sum(_local_bytes(specs[k], shardings[k], mesh) for k in specs)


def holdings(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
             rules) -> Dict[str, int]:
    """Bytes of each input a rank of ``mesh`` holds for the cell's step,
    from ``steps.input_specs`` and ``input_shardings`` under ``rules``:
    ``params``, ``mu``, ``nu``, ``step`` and ``batch`` to train; ``params``
    and ``batch`` to prefill; ``params``, ``cache`` and ``tokens`` to
    decode.  Needs no process group and makes no tensor."""
    with sharding_context(mesh, rules):
        specs = st.input_specs(cfg, shape)
        sh = st.input_shardings(cfg, shape, specs)
    out = {"params": _sum_bytes(specs["params"], sh["params"], mesh)}
    if shape.kind == "train":
        opt, osh = specs["opt_state"], sh["opt_state"]
        for k in ("mu", "nu"):
            out[k] = _sum_bytes(opt[k], osh[k], mesh)
        out["step"] = _local_bytes(opt["step"], osh["step"], mesh)
    if shape.kind in ("train", "prefill"):
        out["batch"] = _sum_bytes(specs["batch"], sh["batch"], mesh)
    else:
        out["cache"] = _sum_bytes(specs["cache"], sh["cache"], mesh)
        out["tokens"] = _local_bytes(specs["tokens"], sh["tokens"], mesh)
    return out


# ----------------------------------------------------------------- meter --

def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif hasattr(tree, "__dataclass_fields__"):
        for f in tree.__dataclass_fields__:
            yield from _tensors(getattr(tree, f))


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _tree_bytes(tree) -> int:
    """Bytes of the distinct storages of a tree's tensors (a DTensor's
    local block)."""
    seen, n = [], 0
    for t in _tensors(tree):
        st_ = _local(t).untyped_storage()
        if not any(st_ is s for s in seen):
            seen.append(st_)
            n += st_.nbytes()
    return n


_EFFECTS: Dict[Any, Tuple[Tuple[Tuple[int, str], ...], Tuple[bool, ...]]] = {}
# Operators whose schema declares a fresh result that is a view of their
# argument all the same (autograd's reshape of a result it just made).
_UNANNOTATED_VIEWS = ("_unsafe_view",)


def _effects(func):
    """What an operator writes, from its schema's alias annotations (kept
    per operator): the (position, name) of each argument it writes (an
    in-place or ``out=`` operation), and for each return whether it is a
    fresh tensor (no annotation) rather than a view of an argument.
    ``wait_tensor`` and the other non-collectives of the collectives'
    namespaces return a collective's result, already counted; the
    ``_UNANNOTATED_VIEWS`` return views."""
    got = _EFFECTS.get(func)
    if got is None:
        schema = func._schema
        written = tuple((i, a.name) for i, a in enumerate(schema.arguments)
                        if a.alias_info is not None and a.alias_info.is_write)
        fresh = tuple(r.alias_info is None for r in schema.returns)
        if (func.namespace in _COLLECTIVE_NS and not _is_collective(func)
                or func._overloadpacket.__name__ in _UNANNOTATED_VIEWS):
            written, fresh = (), tuple(False for _ in fresh)
        got = _EFFECTS[func] = (written, fresh)
    return got


class StepMeter(TorchDispatchMode):
    """Meters a step run on fake tensors, on this rank's blocks only: the
    bytes of fake storage alive (``live``, its highest ``peak``), each
    storage counted from the operation that makes it until it is freed
    (``track``: arguments are tracked before the step starts); the FLOPs
    of every operation with a formula in ``torch.utils.flop_counter``, by
    the dtype of its first tensor operand (``flops_by_dtype``); the bytes the operations write (``result_bytes``: each fresh
    result whole, each argument an in-place or ``out=`` operation writes,
    a view nothing; ``_effects``); and the functional collectives
    (``coll_bytes``, ``coll_detail`` by JAX name, ``coll_counts``).
    DTensor operations pass through to DTensor, whose operations on the
    local blocks come back here; DTensor's sharding propagation runs on
    global-shape fake tensors outside every mode
    (``isolated_propagation``), so nothing of it is counted."""

    def __init__(self):
        super().__init__()
        from torch.utils.weak import WeakIdKeyDictionary
        self._seen = WeakIdKeyDictionary()
        self.live = self.peak = 0
        self.flops_by_dtype: Dict[str, int] = collections.Counter()
        self.result_bytes = 0
        self.coll_bytes = 0.0
        self.coll_detail: Dict[str, float] = collections.Counter()
        self.coll_counts: Dict[str, int] = collections.Counter()

    def track(self, t: torch.Tensor) -> None:
        if not isinstance(t, torch.Tensor) or t.device.type == "meta":
            return
        st_ = _local(t).untyped_storage()
        if st_ in self._seen:
            return
        n = st_.nbytes()

        def freed(_ref, n=n):
            self.live -= n

        self._seen[st_] = (n, weakref.ref(st_, freed))
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor desugars it into local ops
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            n = int(formula(*args, **kwargs, out_val=out))
            operand = next(_tensors(args), None)
            dtype = (operand if operand is not None
                     else next(_tensors(out))).dtype
            self.flops_by_dtype[str(dtype).replace("torch.", "")] += n
        written, fresh = _effects(func)
        for i, name in written:
            self.result_bytes += _tree_bytes_plain(
                args[i] if i < len(args) else kwargs.get(name))
        if fresh == (True,) and isinstance(out, torch.Tensor):
            self.result_bytes += out.numel() * out.element_size()
        else:
            outs = (out,) if len(fresh) == 1 else out if fresh else ()
            for o, new in zip(outs, fresh):
                if new:
                    self.result_bytes += _tree_bytes_plain(o)
        if _is_collective(func):
            name = func._overloadpacket.__name__
            nbytes = max(_tree_bytes_plain(args[0]), _tree_bytes_plain(out))
            factor = 2.0 if name.startswith("all_reduce") else 1.0
            key = _COLLECTIVE_NAMES.get(name, name.replace("_", "-"))
            self.coll_bytes += factor * nbytes
            self.coll_detail[key] += factor * nbytes
            self.coll_counts[key] += 1
        for t in _tensors(out):
            self.track(t)
        return out


def _tree_bytes_plain(tree) -> int:
    """Bytes of a tree's tensors as they are shaped (views counted whole)."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


@contextmanager
def isolated_propagation():
    """DTensor's sharding propagation, which runs the operation on fake
    tensors of the global shapes to learn the output's shape, run outside
    every dispatch mode (in a fake mode of its own), so a meter counts only
    the operations on this rank's blocks."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes
    name = "_propagate_tensor_meta_non_cached"
    if not hasattr(ShardingPropagator, name):
        raise RuntimeError(f"this torch ({torch.__version__}) has no "
                           f"ShardingPropagator.{name} to isolate")
    orig = getattr(ShardingPropagator, name)

    def isolated(self, op_schema):
        with _disable_current_modes():
            return orig(self, op_schema)

    setattr(ShardingPropagator, name, isolated)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


# ------------------------------------------------------------------ cells --

def _params(cfg: ModelConfig, dev: torch.device, train: bool):
    """The LM's parameters on ``dev`` as this rank holds them, never
    initialised: on a split mesh the ``meta`` LM's DTensor blocks."""
    from ..distributed.sharding import current_mesh
    if split_mesh(current_mesh()):
        params = lm.LM(cfg, torch.device("meta"), train=train)
        distribute_params(params, dev)
        return params
    return lm.LM(cfg, dev, train=train)


def _placed(specs: Dict[str, Any], dev: torch.device
            ) -> Dict[str, torch.Tensor]:
    """A batch of zeros placed as the launchers place one
    (``train.batch_dims``)."""
    return {k: place_like(torch.zeros(v.shape, dtype=v.dtype, device=dev),
                          batch_dims(k)) for k, v in specs.items()}


def _args_of(kind: str, cfg: ModelConfig, shape: ShapeConfig, dev):
    """(step function, its arguments, {input: the arguments' bytes}) for
    the cell, made on fake tensors under the sharding context."""
    specs = st.input_specs(cfg, shape)
    params = _params(cfg, dev, train=kind == "train")
    got = {"params": _tree_bytes(params)}
    if kind == "train":
        opt = init_opt_state(lm_leaf_groups(params))
        batch = _placed(specs["batch"], dev)
        got.update(mu=_tree_bytes(opt["mu"]), nu=_tree_bytes(opt["nu"]),
                   step=_tree_bytes(opt["step"]), batch=_tree_bytes(batch))
        return (st.make_train_step(cfg, AdamWConfig()),
                (params, opt, batch), got)
    if kind == "prefill":
        batch = _placed(specs["batch"], dev)
        got["batch"] = _tree_bytes(batch)
        return st.make_prefill_step(cfg, shape.seq_len), (params, batch), got
    cache = lm.init_cache(params, cfg, shape.global_batch, shape.seq_len)
    tokens = place_like(torch.zeros((shape.global_batch,),
                                    dtype=torch.int32, device=dev),
                        ("batch",))
    got.update(cache=_tree_bytes(cache), tokens=_tree_bytes(tokens))
    return st.make_serve_step(cfg), (params, cache, tokens), got


def fake_step(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
              rules) -> Dict[str, Any]:
    """Run the cell's step on this rank of ``mesh`` under fake tensors and
    meter it: {"arguments": bytes by input, "memory": {...},
    "flops_by_dtype", "result_bytes", "coll_bytes", "coll_detail",
    "coll_counts"}.  The arguments' bytes
    must equal ``holdings``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    dev = torch.device("cpu")
    want = holdings(cfg, shape, mesh, rules)
    meter = StepMeter()
    grad = torch.enable_grad() if shape.kind == "train" else torch.no_grad()
    with FakeTensorMode(allow_non_fake_inputs=True), \
            sharding_context(mesh, rules), isolated_propagation(), grad:
        fn, args, got = _args_of(shape.kind, cfg, shape, dev)
        if got != want:
            raise RuntimeError(f"the step's inputs hold {got} bytes a "
                               f"rank; the placements give {want}")
        for t in _tensors(args):
            meter.track(t)
        with meter:
            out = fn(*args)
        out_bytes = _tree_bytes(out)
    arg_bytes = sum(want.values())
    return {
        "arguments": want,
        "memory": {"argument_size_in_bytes": arg_bytes,
                   "output_size_in_bytes": out_bytes,
                   "temp_size_in_bytes": meter.peak - arg_bytes,
                   "peak_memory_in_bytes": meter.peak},
        "flops_by_dtype": dict(meter.flops_by_dtype),
        "result_bytes": meter.result_bytes, "coll_bytes": meter.coll_bytes,
        "coll_detail": dict(meter.coll_detail),
        "coll_counts": dict(meter.coll_counts),
    }


def _mesh_name(multi_pod: bool, mesh_shape: Optional[Sequence[int]]) -> str:
    if mesh_shape is not None:
        return "x".join(str(v) for v in mesh_shape)
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             variant: str = "", *, mesh_shape: Optional[Sequence[int]] = None,
             batch: Optional[int] = None, seq: Optional[int] = None,
             small: bool = False) -> Dict[str, Any]:
    """One cell: its record, written as ``<out_dir>/<tag>.json``.
    ``mesh_shape`` lays a smaller fake group out on the production mesh's
    axes; ``batch`` and ``seq`` replace the shape's global batch and
    sequence length (both for comparisons with runs on the card);
    ``small`` takes the reduced same-family config (``configs.smoke``)."""
    import dataclasses
    from ..configs import smoke
    cfg = get_config(arch)
    if small:
        cfg = smoke(cfg)
    if variant in CFG_VARIANTS:
        cfg = CFG_VARIANTS[variant](cfg)
    shape = SHAPES[shape_name]
    if batch is not None or seq is not None:
        shape = dataclasses.replace(
            shape, global_batch=batch or shape.global_batch,
            seq_len=seq or shape.seq_len)
    mesh_name = _mesh_name(multi_pod, mesh_shape)
    tag = f"{arch}_{shape_name}_{mesh_name}" + (f"_{variant}" if variant
                                                 else "")
    if batch is not None or seq is not None:
        tag += f"_b{shape.global_batch}_s{shape.seq_len}"
    if small:
        tag += "_smoke"
    skip = cell_skip_reason(cfg, shape)
    record: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                              "mesh": mesh_name, "kind": shape.kind,
                              "variant": variant, "smoke": small,
                              "global_batch": shape.global_batch,
                              "seq_len": shape.seq_len}
    if skip:
        record["status"] = "skipped"
        record["reason"] = skip
        _write(out_dir, tag, record)
        print(f"[dryrun] {tag}: SKIPPED ({skip})", flush=True)
        return record

    t0 = time.time()
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, shape=mesh_shape,
                                    fake=True)
        n_chips = mesh.size
        rules = rules_for(cfg, shape, mesh, variant)
        got = fake_step(cfg, shape, mesh, rules)
        mflops = rf.model_flops(cfg, shape)
        roof = rf.analyze(got["flops_by_dtype"], got["result_bytes"],
                          got["coll_bytes"], got["coll_detail"],
                          model_flops_global=mflops, n_chips=n_chips)
        peak = got["memory"]["peak_memory_in_bytes"]
        record.update(
            memory=got["memory"], arguments=got["arguments"],
            roofline={**roof.to_dict(), "coll_counts": got["coll_counts"]},
            model_flops_global=mflops, n_chips=n_chips,
            fits_80GB=peak <= RANK_MEMORY_BYTES,
            fits_on=f"one rank of an {RANK_DEVICE} ({RANK_MEMORY_BYTES} "
                    f"bytes)",
            torch=torch.__version__,
            lacks=list(LACKS))
        record["trace_s"] = round(time.time() - t0, 1)
        record["status"] = "ok"
        print(f"[dryrun] {tag}: OK  trace={record['trace_s']}s "
              f"bottleneck={roof.bottleneck} terms(ms): "
              f"c={roof.compute_s * 1e3:.2f} m={roof.memory_s * 1e3:.2f} "
              f"coll={roof.collective_s * 1e3:.2f} "
              f"args={got['memory']['argument_size_in_bytes'] / 2**30:.2f}"
              f"GiB peak={peak / 2**30:.2f}GiB fits_80GB="
              f"{record['fits_80GB']} flops={roof.flops:.3e} coll="
              f"{roof.coll_bytes:.3e}B useful={roof.useful_ratio:.2f}",
              flush=True)
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        record["status"] = "failed"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-2000:]
        record["trace_s"] = round(time.time() - t0, 1)
        print(f"[dryrun] {tag}: FAILED {record['error']}", flush=True)
    _write(out_dir, tag, record)
    return record


def _write(out_dir: str, tag: str, record: Dict[str, Any]) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(record, f, indent=1)


def main(argv: Optional[Sequence[str]] = None) -> None:
    from .mesh import parse_mesh_shape
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="an architecture, or several separated by commas")
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--variant", default="",
                    choices=[""] + list(VARIANTS) + list(CFG_VARIANTS))
    ap.add_argument("--mesh-shape", default=None,
                    help="DxM or PxDxM: a fake group of that many ranks on "
                         "the production mesh's axes (default: 16x16 or "
                         "2x16x16)")
    ap.add_argument("--batch", type=int, default=None,
                    help="replace the shape's global batch")
    ap.add_argument("--seq", type=int, default=None,
                    help="replace the shape's sequence length")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family configs")
    args = ap.parse_args(argv)

    mesh_shape = parse_mesh_shape(args.mesh_shape)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    archs = (list(ARCHS) if (args.all or args.arch is None)
             else args.arch.split(","))
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    # mesh by mesh: the fake group is made once for each
    cells = [(a, s, mp) for mp in meshes for a in archs for s in shapes]
    ok = fail = skip = 0
    for a, s, mp in cells:
        r = run_cell(a, s, mp, args.out, args.variant, mesh_shape=mesh_shape,
                     batch=args.batch, seq=args.seq, small=args.smoke)
        ok += r["status"] == "ok"
        fail += r["status"] == "failed"
        skip += r["status"] == "skipped"
    print(f"[dryrun] done: {ok} ok, {skip} skipped, {fail} failed",
          flush=True)
    if fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
