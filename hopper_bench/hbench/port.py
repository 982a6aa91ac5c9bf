"""The harness's view of the program's state: its tensors under the
reference's leaf names, copied out, so that the reference can start from
them without reading any module of the program."""
from __future__ import annotations

from typing import Dict

import torch

from reference import bcpnn as ref

FIELDS = ("pi", "pj", "pij", "t", "w", "b")


def program_leaves(state) -> Dict[str, torch.Tensor]:
    """A depth-1 program state's tensors as ``hidden.<leaf>`` and
    ``readout.<leaf>``, the clock as float32."""
    out = {}
    for side, p in (("hidden", state.projs[0]), ("readout", state.readout)):
        tr = p.traces
        out.update({f"{side}.pi": tr.pi, f"{side}.pj": tr.pj,
                    f"{side}.pij": tr.pij,
                    f"{side}.t": tr.t.to(torch.float32), f"{side}.w": p.w,
                    f"{side}.b": p.b})
    return out


def copy_leaves(leaves: Dict[str, torch.Tensor], device
                ) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to(device, copy=True) for k, v in leaves.items()}


def reference_state(leaves: Dict[str, torch.Tensor]) -> ref.State:
    """A reference state of copies of ``leaves``."""
    def proj(side):
        return ref.Proj(**{k: leaves[f"{side}.{k}"].clone() for k in FIELDS})
    return ref.State(hidden=proj("hidden"), readout=proj("readout"))
