"""Traffic kind ``fit``: back-to-back ``Trainer.fit`` calls on one trainer,
closed loop, one caller.

Parameters (``traffic/<name>.json``): ``epochs`` and ``batch`` of every
fit.  The state carries from fit to fit (no ``reset``, which would
capture the steps again).

Set-up makes the configuration's training rows on the device from the
seed and copies them to the host, where ``fit`` takes them; builds the
trainer; runs its first fit on the first ``2·batch + tail`` rows for one
epoch (three unsupervised steps, the last on the padded tail, and three
readout steps), whose result the check holds against the reference
started from the seed; then one whole fit, which warms up every path the
window runs.

A unit is one fit.  Its record: the images it learned (rows × (epochs ×
depth + 1)), the program's own ``unsup_s`` and ``sup_s``, and its spans
(preparation, unsupervised epochs, supervised pass).

The check, after the window: the program's state is copied, and the same
probe fit runs on it through ``fit``; the reference follows both probe
fits from their starting states (the seed's, and the copy with its
generator's position), and each is judged by its worst leaf
(``hbench/compare.py``): ``start`` and ``end``.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Optional

import numpy as np
import torch

from counts import bcpnn as counts
from hbench import compare, data
from hbench.port import copy_leaves, program_leaves, reference_state
from hbench.trace import Span
from reference import bcpnn as ref


@dataclasses.dataclass
class State:
    trainer: object
    x: np.ndarray
    y: np.ndarray
    probe: int
    start_after: Dict[str, torch.Tensor]


def probe_rows(n: int, batch: int) -> int:
    """Rows of the probe fit: two whole batches and the padded tail (a
    third whole batch where the rows fill whole batches)."""
    tail = n % batch
    return min(n, 2 * batch + (tail or batch))


def setup(run) -> State:
    from repro_torch.core.network import BCPNNConfig
    from repro_torch.core.trainer import Trainer
    d = run.config["data"]
    (x, y), = data.surrogate([d["n_train"]], d["side"], d["n_classes"],
                             d["noise"], d["max_shift"], run.generator())
    x_np, y_np = x.cpu().numpy(), y.cpu().numpy()
    del x, y
    batch = run.traffic["batch"]
    probe = probe_rows(len(x_np), batch)
    tr = Trainer(BCPNNConfig(**run.config["network"]), seed=run.seed,
                 device=run.device)
    tr.fit(x_np[:probe], y_np[:probe], epochs=1, batch=batch)
    start_after = copy_leaves(program_leaves(tr.state), "cpu")
    tr.fit(x_np, y_np, epochs=run.traffic["epochs"], batch=batch)
    return State(trainer=tr, x=x_np, y=y_np, probe=probe,
                 start_after=start_after)


def _finite_state(state) -> bool:
    flags = [torch.isfinite(t).all() for t in program_leaves(state).values()]
    return bool(torch.stack(flags).all())


def unit(run, st: State) -> dict:
    tr = st.trainer
    epochs, batch = run.traffic["epochs"], run.traffic["batch"]
    t0 = time.perf_counter()
    stats = tr.fit(st.x, st.y, epochs=epochs, batch=batch)
    t1 = time.perf_counter()
    ok = (all(math.isfinite(v) for v in stats.values())
          and _finite_state(tr.state))
    depth = tr.spec.depth
    n = len(st.x)
    nb = -(-n // batch)
    net = run.config["network"]
    sup0 = t1 - stats["sup_s"]
    unsup0 = sup0 - stats["unsup_s"]
    return {
        "ok": ok,
        "images": n * (epochs * depth + 1),
        "unsup_s": stats["unsup_s"], "sup_s": stats["sup_s"],
        "fit_s": t1 - t0,
        "unsup_steps": nb * epochs * depth,
        "sup_steps": nb,
        "flops": counts.fit_flops(n, epochs, net["input_hc"] * net["input_mc"],
                                  net["hidden_hc"] * net["hidden_mc"],
                                  net["n_classes"]),
        "spans": [Span("fit.prep", t0, unsup0),
                  Span("fit.unsup", unsup0, sup0),
                  Span("fit.sup", sup0, t1)],
    }


def _reference_fit(start: ref.State, net: ref.Net, x, y, batch: int,
                   gen: Optional[torch.Generator], tf32: bool) -> ref.State:
    with torch.no_grad():
        return ref.fit_epoch_steps(start, net, x, y, batch, gen, tf32=tf32)


def check(run, st: State, control: bool) -> Dict[str, float]:
    """The program's numbers; with ``control`` also the control's, the
    reference in TF32 put in the program's place (``run.control``)."""
    tr = st.trainer
    dev = run.device
    batch = run.traffic["batch"]
    xp, yp = st.x[:st.probe], st.y[:st.probe]
    before = copy_leaves(program_leaves(tr.state), dev)
    gen_state = tr.state.generator.get_state()
    tr.fit(xp, yp, epochs=1, batch=batch)
    after = copy_leaves(program_leaves(tr.state), dev)
    st.trainer = None
    del tr
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    net = ref.Net.from_config(run.config["network"])
    x = torch.from_numpy(xp).to(dev)
    y = torch.from_numpy(yp).to(dev)

    def seeded():
        g = torch.Generator(device=dev)
        g.manual_seed(run.seed)
        return g

    def resumed():
        g = torch.Generator(device=dev)
        g.set_state(gen_state)
        return g

    gen = seeded()
    init = ref.init_state(net, gen)
    init_leaves = copy_leaves(init.leaves(), dev)
    start_ref = _reference_fit(init, net, x, y, batch, gen,
                               tf32=False).leaves()
    end_ref = _reference_fit(reference_state(before), net, x, y, batch,
                             resumed(), tf32=False).leaves()
    gaps = {"start": compare.leaf_gaps(init_leaves, st.start_after, start_ref),
            "end": compare.leaf_gaps(before, after, end_ref)}
    run.details = gaps
    if control:
        g2 = seeded()
        start_c = _reference_fit(ref.init_state(net, g2), net, x, y, batch,
                                 g2, tf32=True).leaves()
        end_c = _reference_fit(reference_state(before), net, x, y, batch,
                               resumed(), tf32=True).leaves()
        ctrl = {"start": compare.leaf_gaps(init_leaves, start_c, start_ref),
                "end": compare.leaf_gaps(before, end_c, end_ref)}
        run.details = {"program": gaps, "control": ctrl}
        run.control = {k: compare.worst(v) for k, v in ctrl.items()}
    return {k: compare.worst(v) for k, v in gaps.items()}
