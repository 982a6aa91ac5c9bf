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


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------ save --
    def save(self, step: int, tree, blocking: bool = False,
             extra: Optional[dict] = None) -> None:
        """Write ``tree`` (a port ``DeepState``) as ``step_<step>``.  The
        arrays are copied to the host here (one read of the card; a CPU
        tensor is cloned, since the steps write states in place), so the
        checkpoint is the state at the call; the files are written on a
        thread unless ``blocking``.  ``extra`` (JSON-serializable) goes
        into the manifest, with the generator's state added under
        ``"torch_generator"``."""
        self.wait()
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
                "extra": extra,
            }
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
