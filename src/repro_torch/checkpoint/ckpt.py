"""Checkpoints with threaded writes, in the JAX package's on-disk format
(mirrors ``repro/checkpoint/ckpt.py``).

Layout: <dir>/step_<N>/
    manifest.json           leaf shapes/dtypes + step + ``extra``
    arrays.npz              one array per leaf, named as the JAX package
                            names its pytree paths

A port ``DeepState`` is written leaf for leaf as the JAX ``DeepState``
would be: ``projs/<l>/traces/{pi,pj,pij,t}``, ``projs/<l>/{w,b,mask}``,
``projs/<l>/table`` (compact-resident projections only), the same under
``readout/``, ``step`` (int32 scalar) and ``key`` (uint32 (2,)).  So a JAX
checkpoint restores into the port, and a port checkpoint restores in the
JAX ``CheckpointManager`` and ``load_model``.  The spec in
``extra["spec"]`` names the JAX backends (``"jnp"``, ``"pallas"``);
``core.network.spec_from_dict`` maps them back.

The random state.  The port draws from a ``torch.Generator``, the JAX
package from a threefry key; neither can reproduce the other's stream.
A port save writes

* ``extra["torch_generator"]``: the generator's device type and its full
  state (``get_state()``), which the JAX package ignores;
* the ``key`` leaf: ``[seed >> 32, seed & 0xffffffff]`` of the
  generator's ``initial_seed()``, a key the JAX package can restore.

The rule when loading: a port checkpoint restored on the device type it
was saved on sets the new generator to the saved state, so the random
stream resumes exactly where it stopped; a JAX checkpoint, or a port
checkpoint saved on the other device type, re-seeds the generator with
``seed = (key[0] << 32) | key[1]``.  ``restore`` returns a state of new
tensors and a new generator, never writing the target's.

An LM train state, ``{"params": LM, "opt": optimizer state}`` (the
``optim.init_opt_state`` of ``convert.lm_leaf_groups(params)``, with
``"err"`` when gradients are compressed), is written under the JAX train
driver's leaf names: ``params/<JAX tree path>``, ``opt/mu/<path>``,
``opt/nu/<path>``, ``opt/err/<path>``, ``opt/step``, each leaf in the JAX
layout (the repeats of a scanned leaf stacked).  bf16 leaves are written
as float32, as the JAX manager writes them (npz has no bf16), so nothing
of this path needs ``ml_dtypes``; a restore casts each array to its
target's dtype.  A train state restores in place: the target's tensors
take the checkpoint's values, every leaf checked before any is written,
and the target is returned.

A train state split over a mesh (DTensor leaves) saves the same files: each
leaf is gathered whole in turn (every rank takes part) and rank 0 writes it,
so the host holds one leaf at a time; the save is blocking and no rank
returns before the directory is in place.  Any checkpoint restores onto any
mesh: each target tensor takes its own block of the saved array.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# The port's backend names -> the JAX package's, for the spec a checkpoint
# carries (``spec_from_dict`` reads either).
_BACKEND_TO_JAX = {"torch": "jnp", "cuda": "pallas"}

_PROJ_LEAVES = ("traces/pi", "traces/pj", "traces/pij", "traces/t", "w",
                "b", "mask", "table")


def spec_manifest(spec_or_cfg) -> dict:
    """The spec as a checkpoint manifest carries it: ``spec_to_dict`` with
    the JAX package's backend names, so either package rebuilds the
    network from the checkpoint directory alone."""
    from ..core.network import spec_to_dict
    d = spec_to_dict(spec_or_cfg)
    for p in d["projs"] + [d["readout"]]:
        p["backend"] = _BACKEND_TO_JAX.get(p["backend"], p["backend"])
    return d


def _proj_leaf(proj, name: str) -> Optional[torch.Tensor]:
    obj = proj
    for part in name.split("/"):
        obj = getattr(obj, part)
    return obj


def generator_key(gen: torch.Generator) -> np.ndarray:
    """The uint32 (2,) ``key`` leaf of a generator: its initial seed's high
    and low words."""
    seed = int(gen.initial_seed())
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    np.uint32)


def key_seed(key: np.ndarray) -> int:
    """The seed a ``key`` leaf re-seeds a generator with."""
    k = np.asarray(key, np.uint32).reshape(-1)
    return (int(k[0]) << 32) | int(k[1])


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A numpy array of its own holding ``t``'s values now: a CUDA tensor's
    one ``.cpu()`` copy, a CPU tensor's clone (``.numpy()`` of a CPU tensor
    is a view of its live storage)."""
    t = t.detach()
    return (t.clone() if t.device.type == "cpu" else t.cpu()).numpy()


def _flatten_with_names(state) -> Tuple[List[str], List[Any]]:
    """(names, leaves) in the JAX package's pytree order; ``key`` is the
    generator's numpy key leaf, every other leaf a tensor."""
    names: List[str] = []
    leaves: List[Any] = []
    for prefix, proj in ([(f"projs/{l}", p) for l, p in
                          enumerate(state.projs)]
                         + [("readout", state.readout)]):
        for leaf in _PROJ_LEAVES:
            t = _proj_leaf(proj, leaf)
            if t is not None:
                names.append(f"{prefix}/{leaf}")
                leaves.append(t)
    names += ["step", "key"]
    leaves += [state.step, generator_key(state.generator)]
    return names, leaves


def _is_train_state(tree) -> bool:
    return isinstance(tree, dict) and "params" in tree


def _train_groups(tree) -> Dict[str, List[torch.Tensor]]:
    """``{leaf name: [tensor, ...]}`` of a train state, one tensor a repeat
    of a stacked leaf, in the JAX package's pytree order."""
    from ..convert import lm_leaf_groups
    out = {f"params/{k}": g
           for k, g in lm_leaf_groups(tree["params"]).items()}
    opt = tree.get("opt") or {}
    for key in sorted(opt):
        if key == "step":
            out["opt/step"] = [opt["step"]]
        else:
            out.update({f"opt/{key}/{k}": g for k, g in opt[key].items()})
    return out


def _is_split(groups: Dict[str, List[torch.Tensor]]) -> bool:
    from torch.distributed.tensor import DTensor
    return any(isinstance(t, DTensor) for g in groups.values() for t in g)


def _check_placed(groups: Dict[str, List[torch.Tensor]], shardings) -> None:
    """Each target leaf is placed as ``shardings`` (nested dicts of
    ``NamedSharding`` or None, keyed as the train state) says: a leaf the
    sharding splits is a DTensor of its placements, a leaf it leaves whole
    is whole on this rank."""
    from ..distributed.sharding import (NamedSharding, placements,
                                        split_mesh)

    def flat(node, prefix=""):
        if isinstance(node, dict):
            for k, v in node.items():
                yield from flat(v, f"{prefix}{k}/")
        elif isinstance(node, NamedSharding):
            yield prefix[:-1], node

    for name, shd in flat(shardings):
        if name not in groups or not split_mesh(shd.mesh):
            continue
        want = placements(shd.mesh, shd.spec)
        for t in groups[name]:
            got = tuple(getattr(t, "placements", ()))
            # a stacked JAX leaf's spec has the stacking dim first
            shift = len(shd.spec) - t.dim()
            want_t = tuple(type(p)(p.dim - shift) if p.is_shard() else p
                           for p in want)
            if got != want_t:
                raise ValueError(f"restoring {name}: the target is placed "
                                 f"{got or 'whole'}, the sharding asks for "
                                 f"{want_t}")


def _write_split(path: str, groups: Dict[str, List[torch.Tensor]]
                 ) -> Optional[Dict[str, Any]]:
    """The arrays of a split train state, gathered whole one leaf at a
    time (``full_tensor``: every rank takes part) and written by rank 0
    into ``path``/arrays.npz as ``np.savez`` writes them, so the host holds
    one leaf at a time.  Returns rank 0's manifest leaves (None
    elsewhere)."""
    import zipfile
    from ..convert import stack_leaf
    from ..distributed.sharding import _rank
    leader = _rank() == 0
    leaves: Dict[str, Any] = {}
    zf = (zipfile.ZipFile(os.path.join(path, "arrays.npz"), mode="w",
                          compression=zipfile.ZIP_STORED, allowZip64=True)
          if leader else None)
    try:
        for name, group in groups.items():
            a = stack_leaf(group)  # gathers a DTensor on every rank
            if zf is not None:
                with zf.open(name + ".npy", mode="w", force_zip64=True) as f:
                    np.lib.format.write_array(f, np.asanyarray(a),
                                              allow_pickle=False)
                leaves[name] = {"shape": list(a.shape),
                                "dtype": str(a.dtype)}
            del a
    finally:
        if zf is not None:
            zf.close()
    return leaves if leader else None


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------ save --
    def save(self, step: int, tree, blocking: bool = False,
             extra: Optional[dict] = None) -> None:
        """Write ``tree`` (a port ``DeepState``, or an LM train state
        ``{"params", "opt"}``) as ``step_<step>``.  The arrays are copied to
        the host here (one read of the card; a CPU tensor is cloned, since
        the steps write states in place), so the checkpoint is the state at
        the call; the files are written on a thread unless ``blocking``.
        ``extra`` (JSON-serializable) goes into the manifest, with a
        ``DeepState``'s generator state added under
        ``"torch_generator"``."""
        self.wait()
        if _is_train_state(tree) and _is_split(_train_groups(tree)):
            self._save_split(step, _train_groups(tree), extra)
            return
        if _is_train_state(tree):
            from ..convert import stack_leaf  # bf16 widened to float32
            groups = _train_groups(tree)
            names = list(groups)
            host = [stack_leaf(g) for g in groups.values()]
        else:
            names, leaves = _flatten_with_names(tree)
            host = [a if isinstance(a, np.ndarray) else _host_array(a)
                    for a in leaves]
            gen = tree.generator
            extra = dict(extra or {})
            extra["torch_generator"] = {
                "device": gen.device.type,
                "state": gen.get_state().tolist()}

        def write():
            tmp = os.path.join(self.dir, f".tmp_step_{step}")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"),
                     **{n: a for n, a in zip(names, host)})
            manifest = {
                "step": step,
                "leaves": {n: {"shape": list(a.shape), "dtype": str(a.dtype)}
                           for n, a in zip(names, host)},
            }
            if extra is not None:
                manifest["extra"] = extra
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def _save_split(self, step: int, groups, extra: Optional[dict]
                    ) -> None:
        """A split train state's ``step_<step>``, written at once: every
        rank gathers each leaf in turn, rank 0 writes it (the files a
        one-rank save of the same state writes), and no rank returns
        before the directory is in place."""
        from ..distributed.sharding import _rank
        tmp = os.path.join(self.dir, f".tmp_step_{step}")
        final = os.path.join(self.dir, f"step_{step}")
        leader = _rank() == 0
        if leader:
            os.makedirs(tmp, exist_ok=True)
        leaves = _write_split(tmp, groups)
        if leader:
            manifest = {"step": step, "leaves": leaves}
            if extra is not None:
                manifest["extra"] = extra
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()
        torch.distributed.barrier()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # --------------------------------------------------------- restore --
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _manifest(self, step: int) -> dict:
        self.wait()
        with open(os.path.join(self.dir, f"step_{step}",
                               "manifest.json")) as f:
            return json.load(f)

    def read_extra(self, step: int) -> Optional[dict]:
        """The ``extra`` metadata stored with ``save`` (None if absent)."""
        return self._manifest(step).get("extra")

    def resume_point(self) -> Optional[Tuple[int, dict]]:
        """``(step, extra)`` of the latest checkpoint, or None when the
        directory holds none: ``extra`` carries the spec and, for mid-fit
        checkpoints, the ``FitCursor`` naming the next work item."""
        step = self.latest_step()
        if step is None:
            return None
        return step, self.read_extra(step) or {}

    def restore(self, step: int, target, shardings: Any = None):
        """A new ``DeepState`` shaped like ``target`` (a port
        ``DeepState``), on its device, from ``step_<step>``; the generator
        follows the module's rule.  ``target`` is not written.

        ``shardings`` (optional) places each leaf on a mesh, which is what
        restarting on another mesh takes: one ``NamedSharding`` (or None)
        per leaf, as a sequence in the leaves' order or as the dict of
        ``distributed.projection_shardings`` keyed by leaf name.  A leaf
        split over a mesh axis longer than 1 becomes a ``DTensor`` of this
        rank's block; every other leaf goes to the target's device
        (``distributed.sharding.place``)."""
        if _is_train_state(target):
            return self._restore_train(step, target, shardings)
        from ..distributed.sharding import place
        extra = self.read_extra(step) or {}
        path = os.path.join(self.dir, f"step_{step}")
        arrays = np.load(os.path.join(path, "arrays.npz"))
        names, leaves = _flatten_with_names(target)
        shard_leaves = [None] * len(leaves)
        if shardings is not None:
            by_name = isinstance(shardings, dict)
            if len(shardings) != len(leaves) or (
                    by_name and set(shardings) != set(names)):
                raise ValueError(
                    f"shardings tree has {len(shardings)} leaves for "
                    f"{len(leaves)} target leaves")
            shard_leaves = ([shardings[n] for n in names] if by_name
                            else list(shardings))
        missing = sorted(set(names) - set(arrays.files))
        surplus = sorted(set(arrays.files) - set(names))
        if missing or surplus:
            def _fmt(kind, items):
                return (f"{kind} leaves {items[:5]}"
                        + (f" ... +{len(items) - 5} more"
                           if len(items) > 5 else ""))
            detail = "; ".join(_fmt(k, v) for k, v in
                               (("missing", missing), ("extra", surplus))
                               if v)
            hint = ""
            # A table leaf on one side only is the signature of a
            # dense<->compact patchy layout mismatch, not another network.
            if any(n.endswith("table") for n in missing + surplus):
                hint = (" — this looks like a dense vs compact-resident "
                        "patchy layout mismatch (ProjSpec.compact): migrate "
                        "the checkpoint with python -m "
                        "repro_torch.checkpoint.migrate, or restore with "
                        "the spec the checkpoint was saved under (manifest "
                        "extra['spec'])")
            raise ValueError(
                f"checkpoint step_{step} does not match the target "
                f"structure (e.g. a different network depth/geometry): "
                f"{detail}{hint}")
        dev = target.device
        host = {name: arrays[name] for name in names}
        out: Dict[str, Any] = {}
        for name, ref, shd in zip(names, leaves, shard_leaves):
            a = host[name]
            if tuple(a.shape) != tuple(ref.shape):
                hint = ""
                if a.ndim != ref.ndim and {a.ndim, ref.ndim} == {2, 3}:
                    hint = (" — a 2-D vs 3-D trace/weight leaf means the "
                            "checkpoint and target disagree on the patchy "
                            "state layout (dense (Ni, Nj) vs "
                            "compact-resident (Hj, K, Mj)); migrate with "
                            "python -m repro_torch.checkpoint.migrate")
                raise ValueError(
                    f"checkpoint leaf {name!r} has shape {tuple(a.shape)}, "
                    f"target expects {tuple(ref.shape)}{hint}")
            if name != "key":
                out[name] = place(torch.from_numpy(np.array(a)).to(
                    device=dev, dtype=ref.dtype), shd)
        return _unflatten(target, out, host,
                          _generator(extra, host["key"], dev))

    @torch.no_grad()
    def _restore_train(self, step: int, target, shardings: Any = None):
        """An LM train state restored in place (a checkpoint of either
        package, saved on any mesh): each target tensor takes its block of
        the saved array, the whole array for a plain tensor, this rank's
        block for a DTensor (``assign_``), one leaf at a time on the host.
        ``shardings`` (optional, nested dicts of ``NamedSharding`` or None
        keyed as the state) must agree with the targets' placements: the
        leaves are placed by them."""
        from ..distributed.sharding import assign_
        groups = _train_groups(target)
        if shardings is not None:
            _check_placed(groups, shardings)
        self.wait()
        arrays = np.load(os.path.join(self.dir, f"step_{step}",
                                      "arrays.npz"))
        from ..convert import leaf_spec
        names = set(groups)
        missing = sorted(names - set(arrays.files))
        surplus = sorted(set(arrays.files) - names)
        if missing or surplus:
            raise ValueError(
                f"checkpoint step_{step} does not match the train state: "
                f"missing leaves {missing[:5]}, extra leaves {surplus[:5]}")
        manifest = self._manifest(step)["leaves"]
        for name, group in groups.items():
            want = leaf_spec(group).shape
            if tuple(manifest[name]["shape"]) != want:
                raise ValueError(f"checkpoint leaf {name!r} has shape "
                                 f"{tuple(manifest[name]['shape'])}, target "
                                 f"expects {want}")
        for name, group in groups.items():
            a = arrays[name]
            parts = [a] if len(group) == 1 else list(a)
            for t, part in zip(group, parts):
                assign_(t, torch.from_numpy(np.array(part)).to(t.dtype))
            del a, parts
        return target


def _generator(extra: dict, key: np.ndarray,
               dev: torch.device) -> torch.Generator:
    """The restored generator, by the module's rule."""
    gen = torch.Generator(device=dev)
    saved = extra.get("torch_generator")
    if saved is not None and saved.get("device") == dev.type:
        gen.set_state(torch.tensor(saved["state"], dtype=torch.uint8))
    else:
        gen.manual_seed(key_seed(key))
    return gen


def _unflatten(target, leaves: Dict[str, torch.Tensor],
               host: Dict[str, np.ndarray], gen: torch.Generator):
    """The ``DeepState`` of the restored tensors; each clock's host mirror
    comes from the file's array, not from a read of the card."""
    from ..core.bcpnn_layer import Projection
    from ..core.network import DeepState
    from ..core.traces import Traces

    def proj(prefix: str) -> Projection:
        return Projection(
            traces=Traces(pi=leaves[f"{prefix}/traces/pi"],
                          pj=leaves[f"{prefix}/traces/pj"],
                          pij=leaves[f"{prefix}/traces/pij"],
                          t=leaves[f"{prefix}/traces/t"],
                          t_host=int(host[f"{prefix}/traces/t"])),
            w=leaves[f"{prefix}/w"], b=leaves[f"{prefix}/b"],
            mask=leaves[f"{prefix}/mask"],
            table=leaves.get(f"{prefix}/table"))

    return DeepState(
        projs=tuple(proj(f"projs/{l}") for l in range(len(target.projs))),
        readout=proj("readout"),
        step=leaves["step"], generator=gen)


# ------------------------------------------------- serving-model loading --

def load_model(directory: str, step: Optional[int] = None, seed: int = 0,
               device=None) -> Tuple[Any, Any, int]:
    """(state, spec, step) from a checkpoint directory ALONE, on ``device``
    (the card unless ``"cpu"`` is asked for): the serving deployment
    loader.  The NetworkSpec rides in the manifest ``extra`` (written by
    ``Trainer.save``, of either package).  ``seed`` seeds only the
    throwaway target the arrays are restored into.  Raises
    FileNotFoundError when the directory holds no checkpoint and
    ValueError when the manifest lacks the spec."""
    # Lazy: core.trainer imports this package.
    from ..core.network import init_deep, spec_from_dict

    mgr = CheckpointManager(directory)
    step = step if step is not None else mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    extra = mgr.read_extra(step)
    if not extra or "spec" not in extra:
        raise ValueError(
            f"checkpoint step_{step} under {directory} has no spec "
            f"metadata; re-save it with Trainer.save")
    spec = spec_from_dict(extra["spec"])
    state = mgr.restore(step, init_deep(spec, seed, device))
    return state, spec, step


def load_models(directories: Sequence[str], seed: int = 0,
                device=None) -> Dict[str, Tuple[Any, Any]]:
    """Multi-model manifest load: ``{name: (state, spec)}`` for one serving
    engine from several checkpoint directories.  Names derive from each
    directory's basename (deduplicated with ``#i`` suffixes so two
    deployments of the same artifact can be hosted side by side)."""
    out: Dict[str, Tuple[Any, Any]] = {}
    for d in directories:
        base = os.path.basename(os.path.normpath(d)) or "model"
        name, i = base, 1
        while name in out:
            i += 1
            name = f"{base}#{i}"
        state, spec, _ = load_model(d, seed=seed, device=device)
        out[name] = (state, spec)
    return out
