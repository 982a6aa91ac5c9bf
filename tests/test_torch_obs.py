"""The port's own spans and counters (``repro_torch/obs.py``): the span
gate, a fit's spans, report and keys, and the device kernels each kernel
wrapper declares (``kernels/ops.py::device_kernels``) against the CUDA
sources.  On the CPU; the card's side (captures, and the profiler's
kernels against the launch counters) is ``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs.bcpnn_models import deep_synth_spec
from repro_torch.core import Trainer
from repro_torch.kernels import ops

CSRC = Path(ops.__file__).resolve().parent / "csrc"
FUNCTION_SCOPE = 0  # at::RecordScope::FUNCTION; USER_SCOPE is 7


def _fit_data(spec, n):
    rng = np.random.default_rng(7)
    x = rng.random((n, spec.input_geom.H), dtype=np.float32)
    return (np.stack([x, 1 - x], -1).reshape(n, -1),
            rng.integers(0, spec.n_classes, n))


def _ancestors(event):
    out, e = [], event.cpu_parent
    while e is not None:
        out.append(e.name)
        e = e.cpu_parent
    return out


def test_span_without_a_profiler_is_the_shared_null_context():
    a, b = obs.span("repro_torch.a"), obs.span("repro_torch.b")
    assert a is b
    with a, b:
        pass


def test_span_under_a_cpu_profiler_records_its_name_and_parent():
    """A function-scope range (the profiler gives a user-scope one a copy
    on the card's timeline), nested under the range that holds it."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("repro_torch.outer"):
            with obs.span("repro_torch.inner"):
                torch.ones(4).add_(1)
    assert obs.span("repro_torch.after") is obs.span("repro_torch.other")
    events = {e.name: e for e in prof.events()}
    assert _ancestors(events["repro_torch.inner"])[0] == "repro_torch.outer"
    assert events["repro_torch.inner"].scope == FUNCTION_SCOPE
    assert all(e.device_type.name == "CPU" for e in prof.events()
               if e.name.startswith("repro_torch."))


def test_a_fit_reports_its_phases_keys_and_spans():
    """Two fits on one trainer: the keys beside the JAX ones, the report's
    bounds in order and equal to the returned seconds, no capture on the
    CPU; under a profiler the phase spans nest in ``repro_torch.fit``, a
    chunk's sync in its epoch, the padded tail's eager step in its
    epoch."""
    spec = deep_synth_spec(side=12, depth=1, hidden_hc=4, hidden_mc=8)
    x, y = _fit_data(spec, 75)  # 4 whole batches of 16 and an 11-row tail
    tr = Trainer(spec, seed=3, device="cpu")
    tr.fit(x, y, epochs=1, batch=16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        stats = tr.fit(x, y, epochs=2, batch=16)
    f = obs.FITS[-1]
    assert {"unsup_s", "sup_s", "train_ms_per_img", "pad_s", "h2d_s",
            "captures"} <= set(stats)
    assert stats["captures"] == 0 == f.captures and f.launches == {}
    assert (f.t0 == f.pad[0] <= f.pad[1] == f.h2d[0] <= f.h2d[1]
            <= f.unsup[0] <= f.unsup[1] == f.sup[0] <= f.sup[1] <= f.t1)
    for key, (a, b) in (("pad_s", f.pad), ("h2d_s", f.h2d),
                        ("unsup_s", f.unsup), ("sup_s", f.sup)):
        assert stats[key] == b - a
    assert stats["train_ms_per_img"] == pytest.approx(
        1e3 * stats["unsup_s"] / (75 * 2))
    spans = [e for e in prof.events() if e.name.startswith("repro_torch.")]
    count = {}
    for e in spans:
        count[e.name] = count.get(e.name, 0) + 1
    # 2 unsupervised epochs and the readout pass, each one chunk with a
    # padded tail
    assert count == {"repro_torch.fit": 1, "repro_torch.fit.pad": 1,
                     "repro_torch.fit.h2d": 1, "repro_torch.fit.unsup": 1,
                     "repro_torch.fit.sup": 1, "repro_torch.fit.epoch": 3,
                     "repro_torch.fit.sync": 3, "repro_torch.step.eager": 3}
    parent = {"repro_torch.fit.pad": "repro_torch.fit",
              "repro_torch.fit.h2d": "repro_torch.fit",
              "repro_torch.fit.unsup": "repro_torch.fit",
              "repro_torch.fit.sup": "repro_torch.fit",
              "repro_torch.fit.sync": "repro_torch.fit.epoch"}
    for e in spans:
        up = _ancestors(e)
        if e.name in parent:
            assert up[0] == parent[e.name], (e.name, up)
        if e.name in ("repro_torch.fit.epoch", "repro_torch.step.eager"):
            assert up[:2] in (["repro_torch.fit.unsup", "repro_torch.fit"],
                              ["repro_torch.fit.sup", "repro_torch.fit"],
                              ["repro_torch.fit.epoch",
                               "repro_torch.fit.unsup"],
                              ["repro_torch.fit.epoch",
                               "repro_torch.fit.sup"]), (e.name, up)


# ------------------------------------------------- declared kernels ----

def _globals() -> set:
    """The names of every ``__global__`` function in ``csrc/*.cu``."""
    pattern = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                         r"\s*)?(\w+)\s*\(")
    return {m.group(1) for p in sorted(CSRC.glob("*.cu"))
            for m in pattern.finditer(p.read_text())}


def undefined_kernels(declared: dict, defined: set) -> list:
    """(entry, pattern) of each declared pattern whose leading name is no
    ``__global__`` of the sources."""
    return [(entry, p) for entry, patterns in declared.items()
            for p in patterns
            if re.match(r"\w+", p).group() not in defined]


def test_every_launch_counter_has_declared_device_kernels():
    declared = ops.device_kernels()
    assert set(declared) == set(ops.launch_counts())
    for patterns in declared.values():
        assert patterns and all(isinstance(p, str) for p in patterns)


def test_every_declared_kernel_is_a_global_of_the_cuda_sources():
    defined = _globals()
    assert {"trace_update_kernel", "bcpnn_fwd_tc_kernel",
            "hc_softmax_kernel", "quant_fwd_tc_kernel"} <= defined
    assert undefined_kernels(ops.device_kernels(), defined) == []


def test_a_declared_kernel_no_global_defines_is_found():
    declared = dict(ops.device_kernels(),
                    bcpnn_update=(r"trace_update_kernel_v2<0,",))
    assert undefined_kernels(declared, _globals()) == [
        ("bcpnn_update", r"trace_update_kernel_v2<0,")]


# The profiler's (demangled) names of each body's instantiations, as the
# card's trace gives them (torch 2.11, CUDA 12.8; argument lists cut): each
# names one entry, the layout telling the entries that share a body apart.
NAMES = {
    "void (anonymous namespace)::trace_update_kernel<0, (anonymous "
    "namespace)::TraceTile<64, 128, 32, 4> >(float const*)": "bcpnn_update",
    "void (anonymous namespace)::trace_update_kernel<1, (anonymous "
    "namespace)::TraceTile<64, 32, 16, 2> >(float const*)": "patchy_update",
    "void (anonymous namespace)::trace_update_kernel<2, (anonymous "
    "namespace)::TraceTile<64, 32, 16, 2> >(float const*)": "compact_update",
    "void (anonymous namespace)::bcpnn_fwd_tc_kernel<(anonymous namespace)"
    "::FwdTile<128, float, 0> >(CUtensorMap_st, float const*)": "bcpnn_fwd",
    "void (anonymous namespace)::bcpnn_fwd_tc_kernel<(anonymous namespace)"
    "::FwdTile<16, __nv_bfloat16, 1> >(CUtensorMap_st)": "patchy_forward",
    "void (anonymous namespace)::bcpnn_fwd_tc_kernel<(anonymous namespace)"
    "::FwdTile<64, float, 2> >(CUtensorMap_st)": "compact_forward",
    "void (anonymous namespace)::hc_softmax_kernel<4, 32, 1>(float const*, "
    "float*, long long, int, float)": "hc_softmax",
    "void (anonymous namespace)::hc_softmax_long_kernel<4>(float const*, "
    "float*, long long, int, float)": "hc_softmax",
    "void (anonymous namespace)::quant_fwd_tc_kernel<128, 0, 64, true>("
    "CUtensorMap_st)": "quant_fwd",
    "void (anonymous namespace)::quant_fwd_tc_kernel<32, 1, 64, false>("
    "CUtensorMap_st)": "quant_patchy_forward",
    "void (anonymous namespace)::quant_fwd_tc_kernel<128, 2, 128, false>("
    "CUtensorMap_st)": "quant_compact_forward",
}


@pytest.mark.parametrize("name", sorted(NAMES))
def test_each_kernel_name_matches_one_entry(name):
    declared = ops.device_kernels()
    hits = [entry for entry, patterns in declared.items()
            if any(re.search(p, name) for p in patterns)]
    assert hits == [NAMES[name]]
