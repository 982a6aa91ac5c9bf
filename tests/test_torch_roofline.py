"""The port's roofline (``repro_torch.launch.roofline``) held against the
JAX package's (``repro/launch/roofline.py``), and the dry run's byte and
FLOP meter on a hand-counted sequence of operations, on the CPU.

* ``dtype_bytes`` of every HLO name and alias, and its ``ValueError``,
  equal JAX's; ``bcpnn_fwd_traffic`` equals JAX's exactly at Table-1
  Models 1-3's hidden and readout shapes in fp32, bf16 and int8 at
  batches 1, 64 and 128.
* ``Roofline`` carries every field of JAX's; ``analyze`` prices an fp32
  FLOP at the CUDA cores' 67 TFLOP/s and a bf16 one at the tensor cores'
  989, bytes at 3.35 TB/s and collective bytes at one NVLink direction,
  and names the largest term.
* ``StepMeter`` counts a bf16 product, an add, a view, an in-place
  ``mul_`` and a functional all-reduce on a fake group (no DTensor): the
  bytes each writes, FLOPs by dtype, the collective.
"""
import dataclasses

import pytest
import torch

from repro.launch import roofline as jroof
from repro_torch.configs.bcpnn_models import (MODEL1_MNIST, MODEL2_PNEUMONIA,
                                              MODEL3_BREAST)
from repro_torch.launch import roofline as rf


def test_dtype_bytes_equal_jax():
    names = sorted(jroof._DTYPE_BYTES) + sorted(jroof._DTYPE_ALIASES)
    assert names == sorted(rf._DTYPE_BYTES) + sorted(rf._DTYPE_ALIASES)
    for name in names:
        assert rf.dtype_bytes(name) == jroof.dtype_bytes(name), name
    for bad in ("q4", "fp8", ""):
        with pytest.raises(ValueError) as want:
            jroof.dtype_bytes(bad)
        with pytest.raises(ValueError) as got:
            rf.dtype_bytes(bad)
        assert str(got.value) == str(want.value)


def _layers():
    """(model, layer, n_in, n_out, n_hc) of Table-1 Models 1-3: the hidden
    projection and the readout."""
    out = []
    for name, cfg in (("m1", MODEL1_MNIST), ("m2", MODEL2_PNEUMONIA),
                      ("m3", MODEL3_BREAST)):
        ni, hidden = cfg.input_hc * cfg.input_mc, cfg.hidden_hc * cfg.hidden_mc
        out += [(name, "hidden", ni, hidden, cfg.hidden_hc),
                (name, "readout", hidden, cfg.n_classes, 1)]
    return out


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("batch", [1, 64, 128])
@pytest.mark.parametrize("model,layer,n_in,n_out,n_hc", _layers())
def test_bcpnn_fwd_traffic_equals_jax(model, layer, n_in, n_out, n_hc, batch,
                                      dtype):
    got = rf.bcpnn_fwd_traffic(batch, n_in, n_out, weight_dtype=dtype,
                               n_hc=n_hc)
    want = jroof.bcpnn_fwd_traffic(batch, n_in, n_out, weight_dtype=dtype,
                                   n_hc=n_hc)
    assert got == want
    assert rf.bcpnn_fwd_traffic(batch, n_in, n_out, dtype, "bf16", n_hc) == \
        jroof.bcpnn_fwd_traffic(batch, n_in, n_out, dtype, "bf16", n_hc)


def test_roofline_fields_include_jax():
    want = [f.name for f in dataclasses.fields(jroof.Roofline)]
    got = [f.name for f in dataclasses.fields(rf.Roofline)]
    assert got[:len(want)] == want
    assert "flops_by_dtype" in got


def test_peaks_are_the_h100_data_sheet():
    assert (rf.PEAK_BYTES_S, rf.PEAK_FP32_FLOP_S, rf.PEAK_TF32_FLOP_S,
            rf.PEAK_BF16_FLOP_S, rf.PEAK_INT8_OPS_S, rf.LINK_BYTES_S) == (
        3.35e12, 67e12, 495e12, 989e12, 1979e12, 450e9)


def test_analyze_prices_each_dtype_at_its_peak():
    r = rf.analyze({"float32": 67e9, "bfloat16": 989e9}, result_bytes=1e9,
                   coll_bytes=4.5e8, coll_detail={"all-reduce": 4.5e8},
                   model_flops_global=4 * 528e9, n_chips=4)
    assert r.compute_s == pytest.approx(2e-3)
    assert r.bytes == 2e9
    assert r.memory_s == pytest.approx(2e9 / 3.35e12)
    assert r.collective_s == pytest.approx(1e-3)
    assert r.bottleneck == "compute"
    assert r.flops == 67e9 + 989e9
    assert r.useful_ratio == pytest.approx(528e9 / (67e9 + 989e9))
    assert r.coll_detail == {"all-reduce": 4.5e8}
    assert r.to_dict()["flops_by_dtype"] == {"float32": 67e9,
                                             "bfloat16": 989e9}
    # the same FLOPs all in bf16 are 15x cheaper than all in fp32
    fp32 = rf.analyze({"float32": 1e12}, 0.0).compute_s
    bf16 = rf.analyze({"bfloat16": 1e12}, 0.0).compute_s
    assert fp32 / bf16 == pytest.approx(989 / 67)


@pytest.mark.parametrize("terms,want", [
    (({"bfloat16": 1e9}, 1e12, 0.0), "memory"),
    (({"float32": 1e12}, 1e9, 1e6), "compute"),
    (({"bfloat16": 1e9}, 1e6, 1e10), "collective"),
])
def test_analyze_bottleneck_is_the_largest_term(terms, want):
    flops, nbytes, coll = terms
    r = rf.analyze(flops, nbytes, coll)
    assert r.bottleneck == want
    largest = max(r.compute_s, r.memory_s, r.collective_s)
    assert getattr(r, {"memory": "memory_s", "compute": "compute_s",
                       "collective": "collective_s"}[want]) == largest


def test_analyze_refuses_a_dtype_without_a_peak():
    with pytest.raises(ValueError, match="float64"):
        rf.analyze({"float64": 1.0}, 0.0)


@pytest.fixture
def fake_group():
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_fake_group
    init_fake_group(2)
    yield dist.group.WORLD.group_name
    dist.destroy_process_group()


def test_step_meter_counts_a_hand_counted_sequence(fake_group):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.dryrun import StepMeter
    c10d = torch.ops._c10d_functional
    meter = StepMeter()
    with FakeTensorMode():
        a = torch.ones((4, 8), dtype=torch.bfloat16)
        b = torch.ones((8, 16), dtype=torch.bfloat16)
        d = torch.ones((4, 16), dtype=torch.bfloat16)
        t = torch.ones((10,), dtype=torch.float32)
        with meter:
            c = a @ b                   # 4 x 16 bf16: 128 B, 1024 FLOPs
            e = c + d                   # 128 B
            v = e.view(64)              # a view: nothing
            v.mul_(2.0)                 # writes its 128 B
            r = c10d.all_reduce(t, "sum", fake_group)   # 40 B
            c10d.wait_tensor(r)         # the collective's own result
    assert meter.result_bytes == 128 + 128 + 128 + 40
    assert dict(meter.flops_by_dtype) == {"bfloat16": 2 * 4 * 8 * 16}
    assert meter.coll_bytes == 2 * 40 and meter.coll_counts == {
        "all-reduce": 1}
    r = rf.analyze(meter.flops_by_dtype, meter.result_bytes,
                   meter.coll_bytes)
    assert r.bytes == 2 * (128 + 128 + 128 + 40)


def test_step_meter_counts_out_and_list_results():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.dryrun import StepMeter
    meter = StepMeter()
    with FakeTensorMode():
        x = torch.ones((6, 4))
        y = torch.empty((6, 4))
        with meter:
            torch.add(x, x, out=y)          # writes y: 96 B
            parts = torch.split(x, 2)       # views: nothing
            torch._foreach_mul_(list(parts), 3.0)   # writes each: 96 B
            torch.unbind(x.clone())         # clone 96 B, views nothing
            x.float().t()                   # same dtype, a view: nothing
    assert meter.result_bytes == 96 + 96 + 96
    assert not meter.flops_by_dtype
