"""Low-precision serving in the port (bf16 cast-on-fold, int8 per-post-HC
quantization, ``pack_state``/``infer_packed``), held against the JAX
package on the CPU.

The same numpy inputs go through the JAX function and the port's.  Codes,
scales, bf16 casts and packs compare bitwise; the int8 forwards' plain
versions compare with the JAX kernels (Pallas in interpret mode off-TPU)
within 1e-6 on rates, and their exact accumulators with a numpy int64
oracle; whole ``infer`` calls within 1e-5 with equal predictions.  The
kernel inputs are scaled to supports of a few units, as a fitted layer's:
the two packages round the fp32 epilogue and ``exp`` differently, and at
supports of hundreds one ulp of the support is already ~1e-5 of a rate.
The fp32-accumulating JAX oracle (``quant_support_dense_jnp``) is exact
only while partial sums stay below 2**24, so at Ni = 8192 it is compared
within a tolerance only.
"""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import network as jn
from repro.kernels import ops as jops
from repro.kernels import quant as jq
from repro_torch import convert
from repro_torch.configs.bcpnn_models import deep_synth_spec
from repro_torch.core import network as tn
from repro_torch.core.trainer import Trainer, evaluate_padded
from repro_torch.data.synthetic import encode_images, make_synthetic
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant as tq
from repro_torch.kernels import ref as tref

KERNEL_TOL = 1e-6   # same exact accumulator: only fp32 epilogue rounding
FWD_TOL = 1e-5      # whole infer: fp32 sums in other orders upstream
BACKENDS = [("pallas", "cuda"), ("jnp", "torch")]
# (B, Ni, Hj, Mj): the JAX suite's GEOMETRIES less Ni = 8192 (its own test
# below), and the ragged shape of chip_smoke.py.
DENSE_SHAPES = [(8, 1568, 32, 128), (8, 1568, 32, 256), (13, 33, 7, 10),
                (1, 5, 1, 2), (37, 1000, 3, 10)]
# (B, Hi, Mi, Hj, Mj, nact): Model 1-struct, the JAX suite's hostile
# patchy geometry and chip_smoke.py's ragged shape.
PATCHY_SHAPES = [(8, 784, 2, 32, 128, 128), (13, 11, 3, 5, 10, 4),
                 (37, 13, 3, 3, 10, 4)]
LAYOUTS = ("dense", "patchy", "compact")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(a):
    """A bf16 tensor or array as its 16-bit patterns."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def _weights(rng, shape, half_grid=False):
    w = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    if half_grid:
        # Values on the half-code grid of an exact scale 2**-4 (the group's
        # absmax is 127 * 2**-4), so w / scale lands on k + 0.5 and the
        # rounding must go half to even in both packages.
        codes = rng.integers(-126, 126, shape) + 0.5
        w = (codes * 2.0 ** -4).astype(np.float32)
        w.reshape(-1)[0] = 127 * 2.0 ** -4
    return w


def _scales(rng, hj, k):
    """Per-HC scales that put random codes' supports at a few units: the
    accumulator of k terms spreads by ~sqrt(k) * 63 * 73."""
    su = 2.0 / (np.sqrt(k) * 63 * 73)
    return (su * 127 * (0.5 + rng.random(hj))).astype(np.float32)


def _table(rng, hi, hj, nact):
    return np.stack([np.sort(rng.permutation(hi)[:nact])
                     for _ in range(hj)]).astype(np.int32)


# ------------------------------------------------- fold-time quantize ----

@pytest.mark.parametrize("ni,hj,mj", [(1568, 32, 128), (1568, 32, 256),
                                      (8192, 32, 128), (33, 7, 10), (5, 1, 2)])
def test_quantize_dense_codes_and_scales_bitwise(ni, hj, mj):
    rng = np.random.default_rng(ni + hj)
    w = _weights(rng, (ni, hj * mj))
    w[:, :mj] = 0.0  # an all-zero group takes the 1e-12 floor
    w_q, scale = tq.quantize_dense(_t(w), hj, mj)
    jw_q, jscale = jq.quantize_dense(jnp.asarray(w), hj, mj)
    assert w_q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(w_q.numpy(), np.asarray(jw_q))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(
        tq.dequantize_dense(w_q, scale, hj, mj).numpy(),
        np.asarray(jq.dequantize_dense(jw_q, jscale, hj, mj)))


def test_quantize_rounds_half_to_even_bitwise():
    rng = np.random.default_rng(1)
    w = _weights(rng, (40, 30), half_grid=True)
    w_q, scale = tq.quantize_dense(_t(w), 1, 30)
    jw_q, jscale = jq.quantize_dense(jnp.asarray(w), 1, 30)
    assert float(scale[0]) == 2.0 ** -4
    np.testing.assert_array_equal(w_q.numpy(), np.asarray(jw_q))
    np.testing.assert_array_equal(w_q.numpy().reshape(-1)[1:],
                                  np.round(w.reshape(-1)[1:] * 16))
    w_c = w.reshape(2, 20, 30)
    c_q, c_s = tq.quantize_compact(_t(w_c))
    jc_q, jc_s = jq.quantize_compact(jnp.asarray(w_c))
    np.testing.assert_array_equal(c_q.numpy(), np.asarray(jc_q))
    np.testing.assert_array_equal(c_s.numpy(), np.asarray(jc_s))


@pytest.mark.parametrize("hj,k,mj", [(32, 256, 128), (5, 12, 10), (3, 4, 1)])
def test_quantize_compact_codes_and_scales_bitwise(hj, k, mj):
    rng = np.random.default_rng(k)
    w_c = _weights(rng, (hj, k, mj))
    w_c[0] = 0.0
    w_q, scale = tq.quantize_compact(_t(w_c))
    jw_q, jscale = jq.quantize_compact(jnp.asarray(w_c))
    np.testing.assert_array_equal(w_q.numpy(), np.asarray(jw_q))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(
        tq.dequantize_compact(w_q, scale).numpy(),
        np.asarray(jq.dequantize_compact(jw_q, jscale)))


def test_quantize_acts_bitwise():
    rng = np.random.default_rng(2)
    x = rng.uniform(-0.25, 1.25, 20000).astype(np.float32)
    # rates whose fp32 product with 127 is exactly k + 0.5
    cand = ((np.arange(127) + 0.5) / 127).astype(np.float32)
    halves = cand[(cand * np.float32(127)) % 1 == 0.5]
    assert len(halves) > 10
    x = np.concatenate([x, halves, [0.0, 1.0, -1.0, 2.0]]).astype(np.float32)
    got = tq.quantize_acts(_t(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jq.quantize_acts(
        jnp.asarray(x))))
    np.testing.assert_array_equal(got[-4:], [0, 127, 0, 127])


def test_dequant_factor_bitwise_and_kernel_constant():
    """``scale * fp32(1/127)``, as the reference's ``scale * ACT_SCALE``
    (``scale / 127`` differs in the last bit); the kernels' constant
    ``1.0f / 127.0f`` is that same fp32 number, the nearest to 1/127."""
    rng = np.random.default_rng(3)
    scale = (rng.random(4096) * 0.3).astype(np.float32)
    got = tq.dequant_factor(_t(scale)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.asarray(scale)
                                                  * jq.ACT_SCALE))
    np.testing.assert_array_equal(got, scale * np.float32(1 / 127))
    assert (got != scale / np.float32(127)).any()
    f = np.float32(1 / 127)
    assert f == np.float32(1.0) / np.float32(127.0)
    err = abs(Fraction(float(f)) - Fraction(1, 127))
    for nb in (np.nextafter(f, np.float32(0)), np.nextafter(f, np.float32(1))):
        assert err < abs(Fraction(float(nb)) - Fraction(1, 127))


def test_bf16_cast_bitwise():
    rng = np.random.default_rng(4)
    w = np.concatenate([rng.standard_normal(50000) * 3,
                        [1 + 2 ** -8, 1 + 3 * 2 ** -8, -1 - 2 ** -8, 0.0,
                         1e-40, np.finfo(np.float32).max]]).astype(np.float32)
    np.testing.assert_array_equal(
        _bits(_t(w).to(torch.bfloat16)),
        _bits(jnp.asarray(w).astype(jnp.bfloat16)))


# ------------------------------------------------ plain int8 forwards ----

def _int64_acc(x, w_q):
    xq = np.round(np.clip(x, 0, 1) * np.float32(127)).astype(np.int64)
    return xq @ w_q.astype(np.int64)


@pytest.mark.parametrize("b,ni,hj,mj", DENSE_SHAPES)
def test_quant_fwd_plain_matches_jax_kernel(b, ni, hj, mj):
    rng = np.random.default_rng(b * ni + mj)
    x = rng.uniform(-0.1, 1.1, (b, ni)).astype(np.float32)
    w_q = rng.integers(-127, 128, (ni, hj * mj)).astype(np.int8)
    bias = rng.standard_normal(hj * mj).astype(np.float32)
    scale = _scales(rng, hj, ni)
    acc = tref.quant_acc_dense(_t(x), _t(w_q))
    np.testing.assert_array_equal(acc.numpy(), _int64_acc(x, w_q))
    got = tops.quant_fwd(_t(x), _t(w_q), _t(bias), _t(scale), hj, mj, 1.25)
    want = jq.quant_fwd_pallas(jnp.asarray(x), jnp.asarray(w_q),
                               jnp.asarray(bias), jnp.asarray(scale), hj, mj,
                               1.25, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=KERNEL_TOL,
                               rtol=0)


# The dense kernel's edge shapes: one row, one either side of a 64-row
# multiple, contractions either side of a 32-deep slice, an HC width whose
# codes are not whole 16-byte runs (Mj = 10) and the smallest column tile
# (Mj = 16).
@pytest.mark.parametrize("mj", [10, 16])
@pytest.mark.parametrize("ni", [31, 33])
@pytest.mark.parametrize("b", [1, 63, 65])
def test_quant_fwd_plain_matches_jax_kernel_at_edge_shapes(b, ni, mj):
    rng = np.random.default_rng(1000 * b + 10 * ni + mj)
    hj = 3
    x = rng.uniform(-0.1, 1.1, (b, ni)).astype(np.float32)
    w_q = rng.integers(-127, 128, (ni, hj * mj)).astype(np.int8)
    bias = rng.standard_normal(hj * mj).astype(np.float32)
    scale = _scales(rng, hj, ni)
    np.testing.assert_array_equal(
        tref.quant_acc_dense(_t(x), _t(w_q)).numpy(), _int64_acc(x, w_q))
    got = tops.quant_fwd(_t(x), _t(w_q), _t(bias), _t(scale), hj, mj, 1.25)
    want = jq.quant_fwd_pallas(jnp.asarray(x), jnp.asarray(w_q),
                               jnp.asarray(bias), jnp.asarray(scale), hj, mj,
                               1.25, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=KERNEL_TOL,
                               rtol=0)


def test_kernel_activation_codes_round_half_to_even():
    """The dense tensor-core kernel makes a rate's code as the low byte of
    fp32(fp32(saturate(v) * 127) + 1.5 * 2**23) (csrc/quant.cu::code_bits):
    equal to ``quantize_acts`` (clip, x127, round half to even) on random
    rates in and out of [0, 1], infinities, and the fp32 neighbours of
    every tie (k + 0.5) / 127."""
    rng = np.random.default_rng(11)
    ties = ((np.arange(127) + 0.5) / 127).astype(np.float32)
    near = np.concatenate([ties, np.nextafter(ties, np.float32(0)),
                           np.nextafter(ties, np.float32(1))])
    edges = np.float32([0.0, -0.0, 1.0, np.inf,
                        # repro: suppress[pad-fill-literal] — test input: a rate of -inf clips to 0
                        -np.inf])
    v = np.concatenate([rng.uniform(-0.5, 1.5, 1 << 20).astype(np.float32),
                        rng.random(1 << 20, dtype=np.float32), near, edges])
    sat = np.clip(v, np.float32(0), np.float32(1))
    prod = (sat * np.float32(127)).astype(np.float32)
    assert bool((prod - np.floor(prod) == 0.5).any())  # exact ties occur
    magic = (prod + np.float32(1.5 * 2 ** 23)).astype(np.float32)
    kernel = (magic.view(np.uint32) & 0xFF).astype(np.int8)
    np.testing.assert_array_equal(kernel, tq.quantize_acts(_t(v)).numpy())


def test_kernel_softmax_quotient_equals_the_division():
    """The dense tensor-core kernel divides a row's exp values by their sum
    through the reciprocal and one FMA correction
    (csrc/quant.cu::quotient): q = a * inv, q + (a - q b) * inv, each
    rounded once (emulated exactly in float64).  Equal to the fp32 division
    wherever the quotient is at least 2**-118, within 1e-42 below."""
    rng = np.random.default_rng(12)
    n = 1 << 20
    b = rng.uniform(1.0, 128.0, n).astype(np.float32)
    a = np.exp(-rng.uniform(0.0, 100.0, n)).astype(np.float32)
    a[:64] = 1.0
    f64 = np.float64
    inv = (f64(1.0) / b.astype(f64)).astype(np.float32)
    q = (a.astype(f64) * inv).astype(np.float32)
    r = (a.astype(f64) - q.astype(f64) * b).astype(np.float32)
    got = (q.astype(f64) + r.astype(f64) * inv).astype(np.float32)
    want = a / b
    big = want >= np.float32(2.0 ** -118)
    np.testing.assert_array_equal(got[big], want[big])
    assert np.abs(got.astype(f64) - want).max() < 1e-42


@pytest.mark.parametrize("b,hi,mi,hj,mj,nact", PATCHY_SHAPES)
def test_quant_patchy_and_compact_plain_match_jax_kernels(b, hi, mi, hj, mj,
                                                          nact):
    rng = np.random.default_rng(hi * hj + nact)
    ni, k = hi * mi, nact * mi
    x = rng.uniform(-0.1, 1.1, (b, ni)).astype(np.float32)
    table = _table(rng, hi, hj, nact)
    w_q = rng.integers(-127, 128, (ni, hj * mj)).astype(np.int8)
    w_c = rng.integers(-127, 128, (hj, k, mj)).astype(np.int8)
    bias = rng.standard_normal(hj * mj).astype(np.float32)
    scale = _scales(rng, hj, k)
    # int64 oracle of the compact accumulator: each post-HC's live units
    ui = (table[:, :, None] * mi + np.arange(mi)).reshape(hj, k)
    xq = np.round(np.clip(x, 0, 1) * np.float32(127)).astype(np.int64)
    want_acc = np.einsum("bjk,jkm->bjm", xq[:, ui], w_c.astype(np.int64))
    np.testing.assert_array_equal(
        tref.quant_acc_compact(_t(x), _t(w_c), _t(table), mi).numpy(),
        want_acc)
    args = (jnp.asarray(x), jnp.asarray(w_c), jnp.asarray(bias),
            jnp.asarray(scale), jnp.asarray(table))
    got = tops.quant_compact_forward(_t(x), _t(w_c), _t(bias), _t(scale),
                                     _t(table), mi, 1.25)
    want = jq.quant_compact_forward(*args, mi, 1.25, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=KERNEL_TOL,
                               rtol=0)
    got = tops.quant_patchy_forward(_t(x), _t(w_q), _t(bias), _t(scale),
                                    _t(table), mi, hj, mj, 1.25)
    want = jq.quant_patchy_forward(jnp.asarray(x), jnp.asarray(w_q),
                                   *args[2:], mi, hj, mj, 1.25,
                                   interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=KERNEL_TOL,
                               rtol=0)


# The gathered kernels' edge shapes: one row, one either side of a 64-row
# multiple, an odd Mi (K = nact * 3 = 33, not a multiple of the 32-deep
# slice) and the HC widths 10 and 16, as for the dense kernel above.
@pytest.mark.parametrize("mj", [10, 16])
@pytest.mark.parametrize("b", [1, 63, 65])
def test_quant_patchy_and_compact_plain_match_jax_kernels_at_edge_shapes(b,
                                                                         mj):
    rng = np.random.default_rng(100 * b + mj)
    hi, mi, hj, nact = 17, 3, 3, 11
    ni, k = hi * mi, nact * mi
    x = rng.uniform(-0.1, 1.1, (b, ni)).astype(np.float32)
    table = _table(rng, hi, hj, nact)
    w_q = rng.integers(-127, 128, (ni, hj * mj)).astype(np.int8)
    w_c = rng.integers(-127, 128, (hj, k, mj)).astype(np.int8)
    bias = rng.standard_normal(hj * mj).astype(np.float32)
    scale = _scales(rng, hj, k)
    args = (jnp.asarray(bias), jnp.asarray(scale), jnp.asarray(table))
    got = tops.quant_compact_forward(_t(x), _t(w_c), _t(bias), _t(scale),
                                     _t(table), mi, 1.25)
    want = jq.quant_compact_forward(jnp.asarray(x), jnp.asarray(w_c), *args,
                                    mi, 1.25, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=KERNEL_TOL,
                               rtol=0)
    got = tops.quant_patchy_forward(_t(x), _t(w_q), _t(bias), _t(scale),
                                    _t(table), mi, hj, mj, 1.25)
    want = jq.quant_patchy_forward(jnp.asarray(x), jnp.asarray(w_q), *args,
                                   mi, hj, mj, 1.25, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=KERNEL_TOL,
                               rtol=0)


def test_exact_plain_version_at_ni_8192_agrees_with_the_kernel_not_the_oracle():
    """Model 3's width with accumulators near 1e8: the fp32 oracle rounds
    its sums (> 2**24), the JAX kernel (exact f32 blocks of 512 terms,
    int32 across blocks) and the port's plain version do not."""
    rng = np.random.default_rng(5)
    b, ni, hj, mj = 8, 8192, 32, 128
    x = rng.uniform(0.9, 1.0, (b, ni)).astype(np.float32)
    w_q = rng.integers(64, 128, (ni, hj * mj)).astype(np.int8)
    bias = rng.standard_normal(hj * mj).astype(np.float32)
    # supports ~4 (acc ~9.4e7 x 4e-8), spread ~0.01 across an HC
    scale = np.full(hj, 4e-8 * 127, np.float32)
    exact = tref.quant_acc_dense(_t(x), _t(w_q)).numpy()
    np.testing.assert_array_equal(exact, _int64_acc(x, w_q))
    assert exact.max() > 2 ** 24
    got = tops.quant_fwd(_t(x), _t(w_q), _t(bias), _t(scale), hj, mj)
    kern = jq.quant_fwd_pallas(jnp.asarray(x), jnp.asarray(w_q),
                               jnp.asarray(bias), jnp.asarray(scale), hj, mj,
                               interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), atol=KERNEL_TOL,
                               rtol=0)
    sup = jq.quant_support_dense_jnp(jnp.asarray(x), jnp.asarray(w_q),
                                     jnp.asarray(scale), jnp.asarray(bias),
                                     hj, mj)
    exact_sup = (exact.astype(np.float32)
                 * np.repeat(scale * np.float32(1 / 127), mj) + bias)
    assert (np.asarray(sup) != exact_sup).any()
    oracle = jops.hc_softmax(sup, hj, mj, 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=1e-3,
                               rtol=0)


def test_plain_supports_match_jax_oracles():
    """The fp32-accumulating supports of the ``"torch"`` backend and the
    readout against the reference's ``*_jnp`` oracles (exact sums here)."""
    rng = np.random.default_rng(6)
    x = rng.random((9, 66)).astype(np.float32)
    w_q = rng.integers(-127, 128, (66, 40)).astype(np.int8)
    bias = rng.standard_normal(40).astype(np.float32)
    scale = (rng.random(4) * 0.1).astype(np.float32)
    np.testing.assert_array_equal(
        tq.quant_support_dense_torch(_t(x), _t(w_q), _t(scale), _t(bias), 4,
                                     10).numpy(),
        np.asarray(jq.quant_support_dense_jnp(
            jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(scale),
            jnp.asarray(bias), 4, 10)))
    table = _table(rng, 33, 4, 5)
    w_c = rng.integers(-127, 128, (4, 10, 10)).astype(np.int8)
    np.testing.assert_array_equal(
        tq.quant_support_compact_torch(_t(x), _t(w_c), _t(scale), _t(bias),
                                       _t(table), 2).numpy(),
        np.asarray(jq.quant_support_compact_jnp(
            jnp.asarray(x), jnp.asarray(w_c), jnp.asarray(scale),
            jnp.asarray(bias), jnp.asarray(table), 2)))


def test_int8_wrappers_on_cpu_count_nothing_and_refuse_other_devices():
    rng = np.random.default_rng(7)
    x = _t(rng.random((3, 6)).astype(np.float32))
    table = torch.tensor([[0, 2], [1, 2]], dtype=torch.int32)
    w_q = torch.ones((6, 8), dtype=torch.int8)
    bias, scale = torch.zeros(8), torch.ones(2)
    before = tops.launch_counts()
    tops.quant_fwd(x, w_q, bias, scale, 2, 4)
    tops.quant_patchy_forward(x, w_q, bias, scale, table, 2, 2, 4)
    tops.quant_compact_forward(x, torch.ones((2, 4, 4), dtype=torch.int8),
                               bias, scale, table, 2)
    assert tops.launch_counts() == before
    meta = dict(device="meta")
    with pytest.raises(ValueError):
        tops.quant_fwd(torch.empty(3, 6, **meta),
                       torch.empty(6, 8, dtype=torch.int8, **meta),
                       torch.empty(8, **meta), torch.empty(2, **meta), 2, 4)


# --------------------------------------------------- network serving ----

def _nets(layout, jb, tb):
    """The JAX suite's small serving net (16x2 -> 4x8 -> 4) in ``layout``,
    in both packages."""
    nact = 16 if layout == "dense" else 6
    kw = dict(input_hc=16, input_mc=2, hidden_hc=4, hidden_mc=8, n_classes=4,
              nact_hi=nact, patchy_traces=layout == "compact",
              compact=layout == "compact")
    return (jn.BCPNNConfig(backend=jb, **kw).network_spec(),
            tn.BCPNNConfig(backend=tb, **kw).network_spec())


def _jtree(st):
    def proj(p):
        return {"traces": {"pi": np.asarray(p.traces.pi),
                           "pj": np.asarray(p.traces.pj),
                           "pij": np.asarray(p.traces.pij),
                           "t": int(p.traces.t)},
                "w": np.asarray(p.w), "b": np.asarray(p.b),
                "mask": np.asarray(p.mask),
                "table": None if p.table is None else np.asarray(p.table)}
    return {"projs": [proj(p) for p in st.projs], "readout": proj(st.readout),
            "step": int(st.step)}


def _learned_pair(layout, jb, tb, steps=5):
    """A JAX state after ``steps`` online folds and its port copy, with the
    batch (B=16, rows 8.. marked as padding)."""
    jspec, tspec = _nets(layout, jb, tb)
    rng = np.random.default_rng(0)
    x = rng.random((16, jspec.projs[0].pre.N)).astype(np.float32)
    y = rng.integers(0, 4, 16).astype(np.int32)
    st = jn.init_network(jspec, jax.random.PRNGKey(0))
    for _ in range(steps):
        st = jn.online_learn_step(st, jspec, jnp.asarray(x), jnp.asarray(y))
    st_t = convert.state_from_numpy(_jtree(st), tspec, device="cpu")
    valid = np.array([1.0] * 8 + [0.0] * 8, np.float32)
    return jspec, tspec, st, st_t, x, y, valid


def _pack_arrays(pack):
    return [a for a in (pack.w, pack.b, pack.scale, pack.table)]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_pack_state_bitwise_matches_jax(layout, dtype):
    jspec, tspec, st, st_t, *_ = _learned_pair(layout, "jnp", "torch")
    jp = jn.pack_state(st, jspec.with_infer_dtype(dtype))
    tp = tn.pack_state(st_t, tspec.with_infer_dtype(dtype))
    for where, a, b in (("stack", tp.projs[0], jp.projs[0]),
                        ("readout", tp.readout, jp.readout)):
        for name, ta, ja in zip("w b scale table".split(), _pack_arrays(a),
                                _pack_arrays(b)):
            assert (ta is None) == (ja is None), f"{where}.{name}"
            if ta is None:
                continue
            if ta.dtype == torch.bfloat16:
                np.testing.assert_array_equal(_bits(ta), _bits(ja))
            else:
                assert ta.numpy().dtype == np.asarray(ja).dtype
                np.testing.assert_array_equal(ta.numpy(), np.asarray(ja),
                                              err_msg=f"{where}.{name}")
    if dtype == "fp32":
        assert tp.projs[0].w is st_t.projs[0].w


@pytest.mark.parametrize("jb,tb", BACKENDS)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_low_precision_infer_matches_jax(jb, tb, layout, dtype):
    jspec, tspec, st, st_t, x, _, valid = _learned_pair(layout, jb, tb)
    jspec, tspec = jspec.with_infer_dtype(dtype), tspec.with_infer_dtype(dtype)
    assert tspec.uses_low_precision
    jp, jq_ = jn.infer(st, jspec, jnp.asarray(x), jnp.asarray(valid))
    tp, tq_ = tn.infer(st_t, tspec, _t(x), _t(valid))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=FWD_TOL,
                               rtol=0)
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq_))
    assert (tp[8:] == 0).all() and (tq_[8:] == -1).all()
    # the rerouted infer is the packed serving path
    pp, pq = tn.infer_packed(tn.pack_state(st_t, tspec), tspec, _t(x),
                             _t(valid))
    assert torch.equal(pp, tp) and torch.equal(pq, tq_)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_jax_packs_through_convert_serve_in_the_port(layout, dtype):
    jspec, tspec, st, _, x, _, valid = _learned_pair(layout, "pallas", "cuda")
    jspec, tspec = jspec.with_infer_dtype(dtype), tspec.with_infer_dtype(dtype)
    jparams = jn.pack_state(st, jspec)

    def tree(p):
        return {k: None if v is None else np.asarray(v)
                for k, v in zip("w b scale table".split(), _pack_arrays(p))}

    params = convert.params_from_numpy(
        {"projs": [tree(p) for p in jparams.projs],
         "readout": tree(jparams.readout)}, tspec, device="cpu")
    jp, jq_ = jn.infer_packed(jparams, jspec, jnp.asarray(x),
                              jnp.asarray(valid))
    tp, tq_ = tn.infer_packed(params, tspec, _t(x), _t(valid))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=FWD_TOL,
                               rtol=0)
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq_))


def test_params_from_numpy_refuses_a_pack_of_another_dtype():
    jspec, tspec, st, *_ = _learned_pair("compact", "jnp", "torch", steps=1)
    jparams = jn.pack_state(st, jspec.with_infer_dtype("bf16"))
    tree = {"projs": [{"w": np.asarray(p.w), "b": np.asarray(p.b),
                       "scale": None, "table": np.asarray(p.table)}
                      for p in jparams.projs],
            "readout": {"w": np.asarray(jparams.readout.w),
                        "b": np.asarray(jparams.readout.b), "scale": None,
                        "table": None}}
    with pytest.raises(ValueError, match="int8"):
        convert.params_from_numpy(tree, tspec.with_infer_dtype("int8"),
                                  device="cpu")
    params = convert.params_from_numpy(tree, tspec.with_infer_dtype("bf16"),
                                       device="cpu")
    assert params.projs[0].w.dtype == torch.bfloat16


def test_repack_after_a_fold_serves_fresh_scales():
    """The stale-scale rule (DESIGN.md §8): a pack is a snapshot; after an
    online fold, packing again gives a fresh quantization of the folded
    state and serving reads it."""
    _, tspec, _, st, x, y, _ = _learned_pair("compact", "jnp", "cuda")
    spec = tspec.with_infer_dtype("int8")
    pack0 = tn.pack_state(st, spec)
    st1 = tn.online_learn_step(st, spec, _t(x), _t(y))
    pack1 = tn.pack_state(st1, spec)
    rq, rs = tq.quantize_dense(st1.readout.w, 1, 4)
    assert torch.equal(pack1.readout.w, rq) and torch.equal(pack1.readout.scale,
                                                            rs)
    assert not torch.equal(pack1.readout.scale, pack0.readout.scale)
    assert st1.readout.w.dtype == torch.float32
    p1, _ = tn.infer_packed(pack1, spec, _t(x))
    assert torch.equal(p1, tn.infer(st1, spec, _t(x))[0])
    assert not torch.equal(p1, tn.infer_packed(pack0, spec, _t(x))[0])


def test_compact_struct_fit_low_precision_accuracy_within_half_a_point():
    """The configuration of ``benchmarks/run.py::assert_quant_accuracy``,
    fitted by the port on the CPU: bf16 and int8 evaluation of the same
    state lose at most 0.5 pp against fp32 (the repo's gate)."""
    ds = make_synthetic(768, 256, 8, 4, seed=3, max_shift=1)
    xt, xe = encode_images(ds.x_train), encode_images(ds.x_test)
    spec = deep_synth_spec(side=8, depth=1, n_classes=4, hidden_hc=8,
                           hidden_mc=16, nact=[32], patchy_traces=True,
                           compact=True, struct_every=25, backend="cuda")
    tr = Trainer(spec, seed=0, device="cpu")
    tr.fit(xt, ds.y_train, epochs=6, batch=64)
    acc32 = evaluate_padded(tr.state, spec, xe, ds.y_test, 64)
    assert acc32 > 0.3  # 4 classes; the JAX reference fit reaches 0.38
    for dtype in ("bf16", "int8"):
        acc = evaluate_padded(tr.state, spec.with_infer_dtype(dtype), xe,
                              ds.y_test, 64)
        assert (acc32 - acc) * 100 <= 0.5, (dtype, acc32, acc)
