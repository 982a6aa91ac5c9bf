"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: the kernels have no CPU mode, so without a card every test
here skips.  On a machine with one:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerances (absolute unless noted): rates 1e-5 and softmax 2e-6 (fp32 sums
in another order); pij' rtol 1e-5; the log-weight fold 1e-4.
"""
from repro_torch.core.compact import build_table
from repro_torch.core.bcpnn_layer import topk_mask
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _rand(gen, *shape):
    return torch.rand(shape, generator=gen, device="cuda")


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda")


# Table-1 Models 2 and 3 (pneumonia, breast) at their fit's batch of 64,
# (B, Ni, Hj, Mj): the hidden layers 1568 -> 32x256 and 8192 -> 32x128 and
# Model 2's 2-class readout (the -struct presets in PATCHY_SHAPES).
M2_HIDDEN, M2_READOUT, M3_HIDDEN = (64, 1568, 32, 256), (64, 8192, 1, 2), \
    (64, 8192, 32, 128)


# (B, H, M): sub-warp segments in registers up to M=256, a loop beyond
@pytest.mark.parametrize("b,h,m", [(1, 1, 2), (37, 3, 10), (128, 32, 128),
                                   (64, 32, 256), (64, 1, 2),
                                   (5, 2, 256), (3, 4, 300)])
def test_hc_softmax_kernel(gen, b, h, m):
    s = _randn(gen, b, h * m) * 4
    got = ops.hc_softmax(s, h, m, 1.5)
    want = ref.ref_hc_softmax(s, h, m, 1.5)
    assert (got - want).abs().max().item() <= 2e-6


# Every segment width: M picks the lanes a segment (1 .. 32) and the floats
# a load (4, 2 or 1); 129 holds 8 loads a lane, 300 takes the loop.  The
# offset view (4 bytes past an aligned base) takes the scalar or float2
# loads of the same widths.
SOFTMAX_WIDTHS = [1, 2, 3, 8, 10, 16, 17, 31, 32, 33, 64, 128, 129, 256, 300]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("m", SOFTMAX_WIDTHS)
def test_hc_softmax_kernel_every_width(gen, m, offset):
    b, h = 37, 3
    buf = _randn(gen, b * h * m + offset) * 4
    s = buf[offset:].view(b, h * m)
    got = ops.hc_softmax(s, h, m, 1.5)
    want = ref.ref_hc_softmax(s, h, m, 1.5)
    assert (got - want).abs().max().item() <= 2e-6


def test_hc_softmax_plans_cover_every_width_and_load():
    """SOFTMAX_WIDTHS on aligned and offset operands launch every sub-warp
    width, every vector width and the long-segment loop."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from repro_torch.kernels.hc_softmax import softmax_plan
    plans = set()
    for m in SOFTMAX_WIDTHS:
        for offset in (0, 1):
            buf = torch.empty(3 * m + offset, device="cuda")
            plans.add(softmax_plan(buf[offset:], torch.empty(3 * m,
                                                             device="cuda"), m))
    assert {p[1] for p in plans if p[2]} == {1, 2, 4, 8, 16, 32}
    assert {p[0] for p in plans} == {1, 2, 4}
    assert {p[2] for p in plans} == {0, 1, 2, 4, 8}


# the softmax pad value of DESIGN.md §7 (repro.kernels.tiling.NEG; the JAX
# package is not importable on the machine with the card)
NEG = -1e30  # repro: suppress[pad-fill-literal] — test input: the pad value itself


@pytest.mark.parametrize("b,h,m", [(37, 3, 10), (128, 32, 128), (5, 4, 2),
                                   (3, 2, 129), (3, 2, 300)])
def test_hc_softmax_kernel_non_finite_and_pads(gen, b, h, m):
    """A NaN, a +inf and an all -inf segment make their segments NaN, and
    NEG pad lanes give exactly 0, as in the plain version."""
    s = _randn(gen, b, h * m) * 4
    s[0, 0] = float("nan")
    s[1, m] = float("inf")
    # repro: suppress[pad-fill-literal] — test input: an all -inf segment
    s[2, :m] = float("-inf")
    s[b - 1, (h - 1) * m + m // 2:] = NEG  # the last HC's upper half
    got = ops.hc_softmax(s, h, m, 1.5)
    want = ref.ref_hc_softmax(s, h, m, 1.5)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert bool(torch.isnan(want[0, :m]).all())
    assert bool(torch.isnan(want[1, m:2 * m]).all())
    assert bool(torch.isnan(want[2, :m]).all())
    assert torch.equal(got == 0, want == 0)
    assert bool((got[b - 1, (h - 1) * m + m // 2:] == 0).all())
    ok = ~torch.isnan(want)
    assert (got[ok] - want[ok]).abs().max().item() <= 2e-6


# Mj picks the column tile (16, 32, 64, 128 lanes); Mj=256 takes two
# column chunks and more than 48 KB of shared memory.
@pytest.mark.parametrize("b,ni,hj,mj", [(1, 7, 1, 2), (37, 1000, 3, 10),
                                        (33, 100, 5, 20), (64, 257, 4, 40),
                                        (128, 1568, 32, 128),
                                        (40, 300, 2, 256), M2_HIDDEN,
                                        M2_READOUT, M3_HIDDEN])
def test_bcpnn_fwd_kernel(gen, b, ni, hj, mj):
    x = _rand(gen, b, ni)
    w = _randn(gen, ni, hj * mj) * 0.1
    bias = _randn(gen, hj * mj)
    got = ops.bcpnn_fwd(x, w, bias, hj, mj, 1.25)
    want = ref.ref_bcpnn_fwd(x, w, bias, hj, mj, 1.25)
    assert (got - want).abs().max().item() <= 1e-5


def _fitted_log_odds(gen, hi, hj, mj, b=128, n=512, eps=1e-4):
    """x (b, 2*hi) and fitted-range log-odds (w, bias): w = log clip(pij)
    − log pi − log pj from traces of n binary-pixel inputs (two
    minicolumns a pixel) and sharp hidden rates, bias = log pj."""
    def encode(rows):
        pix = (torch.rand((rows, hi), generator=gen, device="cuda") < 0.3)
        pix = pix.double()
        return torch.stack([pix, 1.0 - pix], -1).reshape(rows, 2 * hi)

    xf = encode(n)
    proj = torch.randn((2 * hi, hj * mj), generator=gen, device="cuda",
                       dtype=torch.float64)
    yf = torch.softmax((xf @ proj * 0.05).view(n, hj, mj), -1).view(n, -1)
    pi, pj, pij = xf.mean(0), yf.mean(0), xf.T @ yf / n
    w = (torch.log(pij.clamp(eps * eps, 1.0)) - torch.log(pi.clamp(eps, 1.0))[:, None]
         - torch.log(pj.clamp(eps, 1.0))[None, :]).float().contiguous()
    bias = torch.log(pj.clamp(eps, 1.0)).float()
    return encode(b).float().contiguous(), w, bias


def _assert_rates_close(got, plain, want64, tol=1e-5):
    """Rates within ``tol`` of the plain version and of the fp64 ones; a
    failure names the worst element of each comparison: (row, column,
    kernel, plain, fp64)."""
    for what, ref_rates in (("plain", plain.double()), ("fp64", want64)):
        diff = (got.double() - ref_rates).abs()
        worst = int(diff.argmax())
        r, c = divmod(worst, got.shape[1])
        assert diff.max().item() <= tol, (
            f"{diff.max().item():.3e} from {what} at row {r}, column {c}: "
            f"kernel {got[r, c].item()!r}, plain {plain[r, c].item()!r}, "
            f"fp64 {want64[r, c].item()!r}")


def test_bcpnn_fwd_kernel_at_fitted_log_odds(gen):
    """Model 1's hidden shape with weights at the fitted range of log-odds
    (log clip(pij) − log pi − log pj from traces of binary-pixel inputs and
    sharp hidden rates; supports reach 10 and more), where an error in the
    kernel's 3xTF32 split would show: rates within 1e-5 of the plain
    version and of an fp64 forward."""
    hi, hj, mj = 784, 32, 128
    x, w, bias = _fitted_log_odds(gen, hi, hj, mj)
    b = x.shape[0]
    s64 = x.double() @ w.double() + bias.double()
    assert s64.abs().max().item() >= 10.0
    want64 = torch.softmax(s64.view(b, hj, mj), -1).view(b, -1)
    got = ops.bcpnn_fwd(x, w, bias, hj, mj)
    _assert_rates_close(got, ref.ref_bcpnn_fwd(x, w, bias, hj, mj), want64)


# B = 37, Ni = 1000 on each way the slices reach shared memory: TMA tensor
# copies (Nj = 128), 4-byte cp.async of w (Nj = 30, and Nj = 20, whose
# 16-byte rows would start the second HC's box off a 16-byte boundary),
# and 4-byte x with plain bf16 loads (Ni = 1001, Mj = 7).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ni,hj,mj", [(1000, 2, 64), (1000, 3, 10),
                                      (1000, 2, 10), (1001, 3, 7)])
def test_bcpnn_fwd_kernel_copy_paths(gen, dtype, ni, hj, mj):
    b = 37
    x = _rand(gen, b, ni)
    w = (_randn(gen, ni, hj * mj) * 0.1).to(dtype)
    bias = _randn(gen, hj * mj).to(dtype)
    got = ops.bcpnn_fwd(x, w, bias, hj, mj, 1.25)
    want = ref.ref_bcpnn_fwd(x, w.float(), bias.float(), hj, mj, 1.25)
    assert (got - want).abs().max().item() <= 1e-5


def _canonical_nan():
    """The NaN the card's arithmetic produces (0x7FFFFFFF), as a 0-d tensor."""
    return torch.tensor(0x7FFFFFFF, dtype=torch.int32).view(torch.float32)


def _same_non_finite(got, want):
    """Non-finite exactly where the plain version is, and somewhere."""
    bad = ~torch.isfinite(want)
    return bool(bad.any()) and torch.equal(~torch.isfinite(got), bad)


# A NaN in x reaches the rates, through the 3xTF32 split of the TMA and
# cp.async paths and of a bf16 weight, as it reaches the plain version's.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,ni,hj,mj", [(128, 1568, 32, 128),
                                        (37, 1000, 3, 10)])
def test_bcpnn_fwd_kernel_keeps_nan(gen, dtype, b, ni, hj, mj):
    x = _rand(gen, b, ni)
    x[3, 5] = _canonical_nan()
    w = (_randn(gen, ni, hj * mj) * 0.1).to(dtype)
    bias = _randn(gen, hj * mj).to(dtype)
    got = ops.bcpnn_fwd(x, w, bias, hj, mj)
    want = ref.ref_bcpnn_fwd(x, w.float(), bias.float(), hj, mj)
    assert _same_non_finite(got, want)
    ok = torch.isfinite(want)
    assert (got[ok] - want[ok]).abs().max().item() <= 1e-5


def test_trace_updates_keep_nan(gen):
    """A NaN in x reaches pij' and w of its pre-unit's rows in the three
    layouts, as it reaches the plain versions' (the fold's clip keeps it)."""
    b, hi, mi, hj, mj, nact = 128, 784, 2, 32, 128, 128
    ni, nj = hi * mi, hj * mj
    lpi = torch.log(_rand(gen, ni) * 0.5 + 1e-4)
    lpj = torch.log(_rand(gen, nj) * 0.5 + 1e-4)
    x, y = _rand(gen, b, ni), _rand(gen, b, nj)
    a = torch.tensor(0.02, device="cuda")
    pij = _rand(gen, ni, nj) * 0.01 + 1e-5
    mask = (_rand(gen, hi, hj) > 0.3).float()
    table = build_table(topk_mask(_rand(gen, hi, hj), nact), nact)
    x[3, int(table[0, 0]) * mi] = _canonical_nan()  # a live unit of HC 0
    got = ops.bcpnn_update(pij, lpi, lpj, x, y, mask, a)
    want = ref.ref_bcpnn_update(pij, lpi, lpj, x, y, mask, a)
    for g, w_ in zip(got, want):
        assert _same_non_finite(g, w_)
    got = ops.patchy_update(pij, lpi, lpj, x, y, table, a, mi, hj, mj)
    want = ref.ref_patchy_update(pij, lpi, lpj, x, y, table, a, mi, hj, mj)
    for g, w_ in zip(got, want):
        assert _same_non_finite(g, w_)
    pij_c = _rand(gen, hj, nact * mi, mj) * 0.01 + 1e-5
    got = ops.compact_update(pij_c, lpi, lpj, x, y, table, a, mi)
    want = ref.ref_compact_update(pij_c, lpi, lpj, x, y, table, a, mi)
    for g, w_ in zip(got, want):
        assert _same_non_finite(g, w_)


# a = 1 is a fit's first step: pij' is XᵀY/n itself, undamped.
@pytest.mark.parametrize("alpha", [0.02, 1.0])
@pytest.mark.parametrize("b,hi,mi,hj,mj", [(1, 3, 2, 1, 2), (37, 500, 2, 3, 10),
                                           (128, 784, 2, 32, 128),
                                           (17, 32, 128, 1, 10),
                                           (300, 40, 2, 2, 64),
                                           (64, 784, 2, 32, 256),
                                           (64, 32, 256, 1, 2),
                                           (64, 4096, 2, 32, 128)])
def test_bcpnn_update_kernel(gen, b, hi, mi, hj, mj, alpha):
    ni, nj = hi * mi, hj * mj
    pij = _rand(gen, ni, nj) * 0.01 + 1e-5
    lpi = torch.log(_rand(gen, ni) * 0.5 + 1e-4)
    lpj = torch.log(_rand(gen, nj) * 0.5 + 1e-4)
    x, y = _rand(gen, b, ni), _rand(gen, b, nj)
    mask = (_rand(gen, hi, hj) > 0.3).float()
    mask[:, 0] = 0.0
    a = torch.tensor(alpha, device="cuda")
    gp, gw = ops.bcpnn_update(pij, lpi, lpj, x, y, mask, a)
    wp, ww = ref.ref_bcpnn_update(pij, lpi, lpj, x, y, mask, a)
    assert bool(((gp - wp).abs() <= 1e-9 + 1e-5 * wp.abs()).all())
    assert (gw - ww).abs().max().item() <= 1e-4
    assert bool((gw[:, :mj] == 0).all())


def test_bcpnn_update_kernel_divides_by_count(gen):
    """A Model-1 hidden tail batch: 104 genuine rows, 24 zero pad rows,
    divided by the genuine count read on the device."""
    ni, nj, n = 1568, 4096, 104
    pij = _rand(gen, ni, nj) * 0.01 + 1e-5
    lpi = torch.log(_rand(gen, ni) * 0.5 + 1e-4)
    lpj = torch.log(_rand(gen, nj) * 0.5 + 1e-4)
    x, y = _rand(gen, 128, ni), _rand(gen, 128, nj)
    x[n:], y[n:] = 0.0, 0.0
    mask = torch.ones(784, 32, device="cuda")
    a = torch.tensor(0.02, device="cuda")
    count = torch.tensor(float(n), device="cuda")
    gp, gw = ops.bcpnn_update(pij, lpi, lpj, x, y, mask, a, count=count)
    wp, ww = ref.ref_bcpnn_update(pij, lpi, lpj, x[:n], y[:n], mask, a)
    assert bool(((gp - wp).abs() <= 1e-9 + 1e-5 * wp.abs()).all())
    assert (gw - ww).abs().max().item() <= 1e-4


def test_launches_are_counted_and_bad_operands_refused(gen):
    ops.reset_launch_counts()
    s = _randn(gen, 4, 6)
    ops.hc_softmax(s, 2, 3)
    ops.hc_softmax(s, 2, 3)
    assert ops.launch_counts()["hc_softmax"] == 2
    with pytest.raises(ValueError):
        ops.hc_softmax(s.double(), 2, 3)
    with pytest.raises(ValueError):
        ops.hc_softmax(_randn(gen, 6, 4).T, 2, 3)  # not contiguous
    with pytest.raises(ValueError):
        ops.bcpnn_fwd(_rand(gen, 4, 5), _randn(gen, 5, 6), torch.zeros(6),
                      2, 3)  # bias on the CPU
    assert ops.launch_counts()["hc_softmax"] == 2


def test_online_step_on_card_matches_cpu_plain(gen):
    """A converted state folds one feedback batch on the card (kernels) and
    on the CPU (plain torch): the states agree within 1e-4."""
    from repro_torch.configs.bcpnn_models import deep_synth_spec
    from repro_torch.convert import state_from_numpy, state_to_numpy
    from repro_torch.core.network import init_deep, online_learn_step
    spec = deep_synth_spec(side=12, depth=2, hidden_hc=4, hidden_mc=8)
    tree = state_to_numpy(init_deep(spec, seed=0, device="cpu"))
    rng = np.random.default_rng(0)
    x = rng.random((37, spec.input_geom.N), dtype=np.float32)
    labels = rng.integers(0, spec.n_classes, 37)
    outs = []
    for dev, sp in (("cuda", spec), ("cpu", spec.with_backend("torch"))):
        st = state_from_numpy(tree, sp, device=dev)
        st = online_learn_step(st, sp, torch.from_numpy(x).to(dev),
                               torch.from_numpy(labels).to(dev))
        outs.append(state_to_numpy(st))
    for pa, pb in zip(outs[0]["projs"] + [outs[0]["readout"]],
                      outs[1]["projs"] + [outs[1]["readout"]]):
        for k in ("w", "b"):
            np.testing.assert_allclose(pa[k], pb[k], atol=1e-4)
        np.testing.assert_allclose(pa["traces"]["pij"], pb["traces"]["pij"],
                                   atol=1e-5)


# ------------------------------------------------- patchy / compact ----

def _patchy_operands(gen, b, hi, mi, hj, mj, nact):
    ni, nj = hi * mi, hj * mj
    table = build_table(topk_mask(_rand(gen, hi, hj), nact), nact)
    return ni, nj, table


def _live_units(table, hi, mi, mj):
    """(Ni, Hj*Mj) bool: the entries the (Hj, nact) table makes live."""
    hc = torch.zeros((hi, table.shape[0]), dtype=torch.bool,
                     device=table.device)
    hc[table.long(), torch.arange(table.shape[0],
                                  device=table.device)[:, None]] = True
    return hc.repeat_interleave(mi, 0).repeat_interleave(mj, 1)


def _close_update(got, want):
    (gp, gw), (wp, ww) = got, want
    assert bool(((gp - wp).abs() <= 1e-9 + 1e-5 * wp.abs()).all())
    assert (gw - ww).abs().max().item() <= 1e-4


# (B, Hi, Mi, Hj, Mj, nact): Model 1-struct, the ragged shape, a wide HC,
# Model 2-struct and Model 3-struct
PATCHY_SHAPES = [(128, 784, 2, 32, 128, 128), (37, 13, 3, 3, 10, 4),
                 (19, 13, 2, 5, 10, 4), (40, 30, 2, 2, 256, 7),
                 (64, 784, 2, 32, 256, 128), (64, 4096, 2, 32, 128, 128)]


@pytest.mark.parametrize("b,hi,mi,hj,mj,nact", PATCHY_SHAPES)
def test_patchy_and_compact_forward_kernels(gen, b, hi, mi, hj, mj, nact):
    ni, nj, table = _patchy_operands(gen, b, hi, mi, hj, mj, nact)
    x = _rand(gen, b, ni)
    w = _randn(gen, ni, nj) * 0.1
    bias = _randn(gen, nj)
    got = ops.patchy_forward(x, w, bias, table, mi, hj, mj, 1.25)
    want = ref.ref_patchy_forward(x, w, bias, table, mi, hj, mj, 1.25)
    assert (got - want).abs().max().item() <= 1e-5
    w_c = _randn(gen, hj, nact * mi, mj) * 0.1
    got = ops.compact_forward(x, w_c, bias, table, mi, 1.25)
    want = ref.ref_compact_forward(x, w_c, bias, table, mi, 1.25)
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("alpha", [0.02, 1.0])
@pytest.mark.parametrize("b,hi,mi,hj,mj,nact", PATCHY_SHAPES)
@pytest.mark.parametrize("n", [None, 5])
def test_patchy_and_compact_update_kernels(gen, b, hi, mi, hj, mj, nact, n,
                                           alpha):
    """Whole batches, and a zero-padded batch of ``n`` genuine rows divided
    by its count, at a small smoothing and at a fit's first step (a = 1).
    Patchy: silent pij held bit for bit, silent w exactly 0, input
    untouched."""
    ni, nj, table = _patchy_operands(gen, b, hi, mi, hj, mj, nact)
    lpi = torch.log(_rand(gen, ni) * 0.5 + 1e-4)
    lpj = torch.log(_rand(gen, nj) * 0.5 + 1e-4)
    x, y = _rand(gen, b, ni), _rand(gen, b, nj)
    count = None
    if n is not None:
        x[n:], y[n:] = 0.0, 0.0
        count = torch.tensor(float(n), device="cuda")
    a = torch.tensor(alpha, device="cuda")
    pij = _rand(gen, ni, nj) * 0.01 + 1e-5
    before = pij.clone()
    got = ops.patchy_update(pij, lpi, lpj, x, y, table, a, mi, hj, mj,
                            count=count)
    want = ref.ref_patchy_update(pij, lpi, lpj, x, y, table, a, mi, hj, mj,
                                 count=count)
    _close_update(got, want)
    assert torch.equal(pij, before)
    silent = ~_live_units(table, hi, mi, mj)
    assert bool(silent.any())
    assert torch.equal(got[0][silent], pij[silent])
    assert bool((got[1][silent] == 0).all())
    pij_c = _rand(gen, hj, nact * mi, mj) * 0.01 + 1e-5
    got = ops.compact_update(pij_c, lpi, lpj, x, y, table, a, mi,
                             count=count)
    want = ref.ref_compact_update(pij_c, lpi, lpj, x, y, table, a, mi,
                                  count=count)
    _close_update(got, want)


def test_patchy_launches_counted_and_bad_operands_refused(gen):
    ni, nj, table = _patchy_operands(gen, 8, 13, 2, 5, 10, 4)
    x, w, bias = _rand(gen, 8, ni), _randn(gen, ni, nj), _randn(gen, nj)
    ops.reset_launch_counts()
    ops.patchy_forward(x, w, bias, table, 2, 5, 10)
    ops.compact_forward(x, _randn(gen, 5, 8, 10), bias, table, 2)
    counts = ops.launch_counts()
    assert counts["patchy_forward"] == 1 and counts["compact_forward"] == 1
    with pytest.raises(ValueError):  # table of the wrong shape
        ops.patchy_forward(x, w, bias, table[:4], 2, 5, 10)
    with pytest.raises(ValueError):  # int64 table
        ops.patchy_forward(x, w, bias, table.long(), 2, 5, 10)
    with pytest.raises(ValueError):  # table on the CPU
        ops.patchy_forward(x, w, bias, table.cpu(), 2, 5, 10)
    with pytest.raises(ValueError):  # compact weights of the wrong K
        ops.compact_forward(x, _randn(gen, 5, 9, 10), bias, table, 2)
    with pytest.raises(ValueError):  # more pre-HCs than the input has
        ops.patchy_forward(x, w, bias, table, 4, 5, 10)
    assert ops.launch_counts() == counts


def test_struct_fit_steps_on_card_match_cpu_plain(gen):
    """One unsupervised step (noise injected) and one online fold across
    a rewire from one converted state, in each plasticity layout, on the
    card (kernels) and on the CPU (plain torch): within 1e-4."""
    from repro_torch.configs.bcpnn_models import deep_synth_spec
    from repro_torch.convert import state_from_numpy, state_to_numpy
    from repro_torch.core.network import (init_deep, online_learn_step,
                                          train_projection_step)
    rng = np.random.default_rng(0)
    for pt, cp in ((False, False), (True, False), (True, True)):
        spec = deep_synth_spec(side=12, depth=1, hidden_hc=4, hidden_mc=8,
                               nact=[40], patchy_traces=pt, compact=cp,
                               struct_every=1)
        tree = state_to_numpy(init_deep(spec, seed=0, device="cpu"))
        x = rng.random((37, spec.input_geom.N), dtype=np.float32)
        labels = rng.integers(0, spec.n_classes, 37)
        noise = rng.standard_normal((37, spec.projs[0].post.N),
                                    dtype=np.float32)
        outs = []
        for dev, sp in (("cuda", spec), ("cpu", spec.with_backend("torch"))):
            st = state_from_numpy(tree, sp, device=dev)
            xt = torch.from_numpy(x).to(dev)
            st = train_projection_step(st, sp, xt, 0,
                                       noise=torch.from_numpy(noise).to(dev))
            st = online_learn_step(st, sp, xt,
                                   torch.from_numpy(labels).to(dev))
            outs.append(state_to_numpy(st))
        for pa, pb in zip(outs[0]["projs"] + [outs[0]["readout"]],
                          outs[1]["projs"] + [outs[1]["readout"]]):
            np.testing.assert_array_equal(pa["mask"], pb["mask"])
            for k in ("w", "b"):
                np.testing.assert_allclose(pa[k], pb[k], atol=1e-4)
            np.testing.assert_allclose(pa["traces"]["pij"],
                                       pb["traces"]["pij"], atol=1e-5)


# ------------------------------------------- int8 and bf16 serving ----
#
# The int8 kernels and their plain versions compute one exact integer
# accumulator and the same fp32 epilogue, operation by operation: rates
# agree within 1e-6 (sums of exp in another order).  The bf16 reads are
# held against the plain fp32 forward of the same bf16-rounded weights.

QUANT_TOL = 1e-6


def _codes(gen, *shape):
    return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                         dtype=torch.int8)


def _quant_operands(gen, hj, nj):
    return _randn(gen, nj), _rand(gen, hj) * 0.02 + 1e-3


# (B, Ni, Hj, Mj): Model 1's hidden layer, ragged and odd HC widths (Mj not
# a multiple of 4 takes the bytewise weight loads), two column chunks.
@pytest.mark.parametrize("b,ni,hj,mj", [(128, 1568, 32, 128), (37, 1000, 3, 10),
                                        (1, 7, 1, 2), (33, 100, 5, 20),
                                        (64, 257, 4, 40), (40, 300, 2, 256),
                                        M2_HIDDEN, M3_HIDDEN])
def test_quant_fwd_kernel(gen, b, ni, hj, mj):
    x = _rand(gen, b, ni) * 1.2 - 0.1  # codes clip outside [0, 1]
    w_q = _codes(gen, ni, hj * mj)
    bias, scale = _quant_operands(gen, hj, hj * mj)
    got = ops.quant_fwd(x, w_q, bias, scale, hj, mj, 1.25)
    want = ref.ref_quant_fwd(x, w_q, bias, scale, hj, mj, 1.25)
    assert (got - want).abs().max().item() <= QUANT_TOL


def test_quant_fwd_kernel_on_unaligned_codes(gen):
    """Codes at an odd byte offset (a contiguous view) take the bytewise
    loads even where Mj is a multiple of 4."""
    b, ni, hj, mj = 16, 50, 3, 8
    w_q = _codes(gen, ni * hj * mj + 1)[1:].view(ni, hj * mj)
    x = _rand(gen, b, ni)
    bias, scale = _quant_operands(gen, hj, hj * mj)
    got = ops.quant_fwd(x, w_q, bias, scale, hj, mj)
    want = ref.ref_quant_fwd(x, w_q, bias, scale, hj, mj)
    assert (got - want).abs().max().item() <= QUANT_TOL


# (B, Ni, Hj, Mj): dense shapes, each taking one of the body's copy routes.
# x and the codes by TMA where their rows (and the HC's first column) are
# 16-byte aligned and sized (Ni % 4 == 0, Mj % 16 == 0): one or several
# batch tiles, K not a multiple of the 32-deep slice, Mj below its column
# tile (the box reads the next HC's codes, masked at staging); x by 4-byte
# cp.async pieces where Ni % 4 != 0; the codes by 4-byte pieces or plain
# loads where Mj % 16 != 0 (40: 4-byte words, 10: loads); Mj = 256 in two
# column chunks.
QUANT_ROUTES = [(128, 1568, 32, 128),
                (1, 8, 1, 16),
                (37, 1000, 3, 16),
                (65, 260, 4, 32),
                (130, 36, 2, 64),
                (33, 1568, 5, 48),
                (65, 257, 4, 32),
                (37, 1000, 3, 10),
                (16, 96, 8, 10),
                (64, 257, 4, 40),
                (40, 300, 2, 256)]


@pytest.mark.parametrize("b,ni,hj,mj", QUANT_ROUTES)
def test_quant_fwd_kernel_routes(gen, b, ni, hj, mj):
    from repro_torch.kernels.quant import quant_fwd_plan
    x = _rand(gen, b, ni) * 1.2 - 0.1
    w_q = _codes(gen, ni, hj * mj)
    bias, scale = _quant_operands(gen, hj, hj * mj)
    rows, ks = quant_fwd_plan(x, w_q, hj, mj)
    assert rows in (64, 128) and 1 <= ks <= 8
    got = ops.quant_fwd(x, w_q, bias, scale, hj, mj, 1.25)
    want = ref.ref_quant_fwd(x, w_q, bias, scale, hj, mj, 1.25)
    assert (got - want).abs().max().item() <= QUANT_TOL


def test_quant_fwd_kernel_takes_unaligned_operands(gen):
    """x or the codes off a 16-byte boundary take cp.async pieces in place
    of TMA, in the same body, and give the plain version's rates."""
    b, ni, hj, mj = 16, 64, 2, 32
    x = _rand(gen, b, ni)
    w_q = _codes(gen, ni, hj * mj)
    bias, scale = _quant_operands(gen, hj, hj * mj)
    w_off = _unaligned(w_q, 1)
    x_off = _unaligned(x, 1)
    want = ref.ref_quant_fwd(x, w_q, bias, scale, hj, mj)
    for xx, ww in ((x, w_q), (x, w_off), (x_off, w_q), (x_off, w_off)):
        got = ops.quant_fwd(xx, ww, bias, scale, hj, mj)
        assert (got - want).abs().max().item() <= QUANT_TOL


def test_quant_fwd_kernel_past_2_24(gen):
    """Ni = 8192 with x = 1 and every code at +-127, most of a column's of
    one sign: the int32 sums pass 2**24 (where the reference's fp32 oracle
    rounds, tests/test_quant.py::test_quant_fwd_close_to_fp32[8-8192-32-128])
    and stay exact, so the rates equal the exact plain version's."""
    b, ni, hj, mj = 128, 8192, 4, 128
    x = torch.ones((b, ni), device="cuda")
    flip = _rand(gen, ni, hj * mj) < torch.linspace(0.0, 0.05, hj * mj,
                                                    device="cuda")
    w_q = torch.where(flip, -127, 127).to(torch.int8)
    bias = _randn(gen, hj * mj)
    # supports of acc * scale / 127 within a few tens
    scale = torch.full((hj,), 2e-5, device="cuda")
    acc = ref.quant_acc_dense(x, w_q)
    assert acc.max().item() > 2 ** 24
    got = ops.quant_fwd(x, w_q, bias, scale, hj, mj)
    want = ref.ref_quant_fwd(x, w_q, bias, scale, hj, mj)
    assert bool(torch.isfinite(want).all())
    assert (got - want).abs().max().item() <= QUANT_TOL


def test_quant_fwd_kernel_equals_patchy_with_every_pre_hc_live(gen):
    """The dense layout (x and codes by TMA) against the patchy one (both
    gathered by cp.async) on a full table (nact = Hi): the same sums, so
    rates within QUANT_TOL and the same argmax in every HC."""
    b, hi, mi, hj, mj = 128, 784, 2, 32, 128
    ni, nj = hi * mi, hj * mj
    table = torch.arange(hi, device="cuda",
                         dtype=torch.int32).repeat(hj, 1).contiguous()
    x = _rand(gen, b, ni) * 1.2 - 0.1
    w_q = _codes(gen, ni, nj)
    bias, scale = _quant_operands(gen, hj, nj)
    dense = ops.quant_fwd(x, w_q, bias, scale, hj, mj, 1.25)
    patchy = ops.quant_patchy_forward(x, w_q, bias, scale, table, mi, hj, mj,
                                      1.25)
    assert (dense - patchy).abs().max().item() <= QUANT_TOL
    assert torch.equal(dense.view(b, hj, mj).argmax(-1),
                       patchy.view(b, hj, mj).argmax(-1))


def test_quant_fwd_kernel_repeats_bit_for_bit(gen):
    """Integer partial sums are exact in any order: ten launches of the
    tensor-core body give the same rates bit for bit."""
    b, ni, hj, mj = 128, 1568, 32, 128
    x = _rand(gen, b, ni)
    w_q = _codes(gen, ni, hj * mj)
    bias, scale = _quant_operands(gen, hj, hj * mj)
    first = ops.quant_fwd(x, w_q, bias, scale, hj, mj)
    assert all(torch.equal(ops.quant_fwd(x, w_q, bias, scale, hj, mj), first)
               for _ in range(10))


# PATCHY_SHAPES and the gathered int8 body's edges: K not a multiple of the
# 32-deep slice, odd Mi (x in 4-byte pieces), Mi % 4 == 0 (16-byte pieces),
# Mj of 10 (codes by plain loads), 48 (below its column tile) and 256 (two
# column chunks), one row and two batch tiles, and x and the codes off a
# 16-byte boundary.  (B, Hi, Mi, Hj, Mj, nact, x offset, w offset)
QUANT_PATCHY_SHAPES = [s + (0, 0) for s in PATCHY_SHAPES] + [
    (1, 50, 3, 4, 48, 11, 0, 0),        # B = 1, K = 33, Mj = 48
    (130, 40, 2, 3, 10, 13, 0, 0),      # two tiles, K = 26, Mj = 10
    (37, 30, 4, 2, 256, 9, 0, 0),       # x 16 B, K = 36, two chunks
    (20, 25, 5, 3, 16, 7, 0, 0),        # Mi = 5, K = 35
    (20, 25, 2, 3, 16, 7, 1, 1),        # unaligned x and codes
    (128, 784, 2, 32, 128, 128, 1, 3)]  # Model 1-struct, unaligned


@pytest.mark.parametrize("b,hi,mi,hj,mj,nact,xo,wo", QUANT_PATCHY_SHAPES)
def test_quant_patchy_and_compact_kernels(gen, b, hi, mi, hj, mj, nact, xo,
                                          wo):
    ni, nj, table = _patchy_operands(gen, b, hi, mi, hj, mj, nact)
    x = _unaligned(_rand(gen, b, ni) * 1.2 - 0.1, xo)
    bias, scale = _quant_operands(gen, hj, nj)
    w_q = _unaligned(_codes(gen, ni, nj), wo)
    got = ops.quant_patchy_forward(x, w_q, bias, scale, table, mi, hj, mj,
                                   1.25)
    want = ref.ref_quant_patchy_forward(x, w_q, bias, scale, table, mi, hj,
                                        mj, 1.25)
    assert (got - want).abs().max().item() <= QUANT_TOL
    w_c = _unaligned(_codes(gen, hj, nact * mi, mj), wo)
    got = ops.quant_compact_forward(x, w_c, bias, scale, table, mi, 1.25)
    want = ref.ref_quant_compact_forward(x, w_c, bias, scale, table, mi, 1.25)
    assert (got - want).abs().max().item() <= QUANT_TOL


def _quant_gathered(gen, b, hi, mi, hj, mj, nact):
    """Both gathered int8 forwards on one set of operands (calls taking
    the keyword ``cluster``), and their plain versions' rates."""
    ni, nj, table = _patchy_operands(gen, b, hi, mi, hj, mj, nact)
    x = _rand(gen, b, ni) * 1.2 - 0.1
    bias, scale = _quant_operands(gen, hj, nj)
    w_q, w_c = _codes(gen, ni, nj), _codes(gen, hj, nact * mi, mj)
    return (
        lambda **kw: ops.quant_patchy_forward(x, w_q, bias, scale, table, mi,
                                              hj, mj, 1.25, **kw),
        lambda **kw: ops.quant_compact_forward(x, w_c, bias, scale, table,
                                               mi, 1.25, **kw),
        ref.ref_quant_patchy_forward(x, w_q, bias, scale, table, mi, hj, mj,
                                     1.25),
        ref.ref_quant_compact_forward(x, w_c, bias, scale, table, mi, 1.25))


@pytest.mark.parametrize("b,hi,mi,hj,mj,nact", [(128, 784, 2, 32, 128, 128),
                                                (37, 13, 3, 3, 10, 4)])
def test_quant_gathered_kernels_repeat_bit_for_bit(gen, b, hi, mi, hj, mj,
                                                   nact):
    """Integer partial sums are exact in any order: ten launches of each
    gathered forward give the same rates bit for bit."""
    patchy, compact, _, _ = _quant_gathered(gen, b, hi, mi, hj, mj, nact)
    for call in (patchy, compact):
        first = call()
        assert all(torch.equal(call(), first) for _ in range(10))


@pytest.mark.parametrize("layout", ["dense", "patchy", "compact"])
def test_quant_kernels_same_rates_under_every_plan(gen, layout):
    """Model 1-struct's table (Model 1's shape, dense) with the plan forced
    to tiles of 64 and 128 rows and clusters of 1 to 4 blocks: the int32
    partials sum exactly, so the rates are the same bit for bit under every
    plan (the launcher's own included), and within QUANT_TOL of the plain
    version."""
    patchy, compact, want_p, want_c = _quant_gathered(gen, 128, 784, 2, 32,
                                                      128, 128)
    if layout == "dense":
        x = _rand(gen, 128, 1568)
        w_q = _codes(gen, 1568, 4096)
        bias, scale = _quant_operands(gen, 32, 4096)

        def call(**kw):
            return ops.quant_fwd(x, w_q, bias, scale, 32, 128, 1.25, **kw)
        want = ref.ref_quant_fwd(x, w_q, bias, scale, 32, 128, 1.25)
    else:
        call, want = (patchy, want_p) if layout == "patchy" else \
            (compact, want_c)
    first = call()
    assert (first - want).abs().max().item() <= QUANT_TOL
    for rows in (64, 128):
        for ks in (1, 2, 3, 4):
            assert torch.equal(call(rows=rows, cluster=ks), first)


def test_quant_gathered_kernels_at_a_long_contraction(gen):
    """K = 70000 gathered terms (within MAX_EXACT_K): a 128-row tile's
    units would not fit in shared memory beside its ring at any cluster
    size, so the plan takes 64-row tiles, and both forwards give the plain
    version's rates."""
    from repro_torch.kernels.quant import quant_fwd_plan
    b, hi, mi, hj, mj, nact = 2, 35000, 2, 1, 16, 35000
    patchy, compact, want_p, want_c = _quant_gathered(gen, b, hi, mi, hj,
                                                      mj, nact)
    x, w_q = _rand(gen, b, hi * mi), _codes(gen, hi * mi, hj * mj)
    table = torch.arange(hi, device="cuda", dtype=torch.int32)[None]
    assert quant_fwd_plan(x, w_q, hj, mj, table, mi)[0] == 64
    assert (patchy() - want_p).abs().max().item() <= QUANT_TOL
    assert (compact() - want_c).abs().max().item() <= QUANT_TOL


@pytest.mark.parametrize("layout", ["dense", "patchy", "compact"])
def test_quant_kernels_read_nan_x_as_code_0(gen, layout):
    """A NaN rate saturates to code 0 in the kernels (__saturatef), so the
    rates equal the plain version's with that rate set to 0."""
    b, hi, mi, hj, mj, nact = 37, 13, 3, 3, 16, 4
    ni, nj, table = _patchy_operands(gen, b, hi, mi, hj, mj, nact)
    x = _rand(gen, b, ni)
    bias, scale = _quant_operands(gen, hj, nj)
    w_q = _codes(gen, hj, nact * mi, mj) if layout == "compact" else \
        _codes(gen, ni, nj)
    live = int(table[0, 0]) * mi
    xn, x0 = x.clone(), x.clone()
    xn[::3, live] = _canonical_nan()
    x0[::3, live] = 0.0
    if layout == "dense":
        got = ops.quant_fwd(xn, w_q, bias, scale, hj, mj)
        want = ref.ref_quant_fwd(x0, w_q, bias, scale, hj, mj)
    elif layout == "patchy":
        got = ops.quant_patchy_forward(xn, w_q, bias, scale, table, mi, hj,
                                       mj)
        want = ref.ref_quant_patchy_forward(x0, w_q, bias, scale, table, mi,
                                            hj, mj)
    else:
        got = ops.quant_compact_forward(xn, w_q, bias, scale, table, mi)
        want = ref.ref_quant_compact_forward(x0, w_q, bias, scale, table, mi)
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= QUANT_TOL


@pytest.mark.parametrize("b,ni,hj,mj", [(128, 1568, 32, 128), (37, 1000, 3, 10),
                                        (40, 300, 2, 256)])
def test_bcpnn_fwd_kernel_reads_bf16(gen, b, ni, hj, mj):
    x = _rand(gen, b, ni)
    w = (_randn(gen, ni, hj * mj) * 0.1).to(torch.bfloat16)
    bias = _randn(gen, hj * mj).to(torch.bfloat16)
    got = ops.bcpnn_fwd(x, w, bias, hj, mj, 1.25)
    want = ref.ref_bcpnn_fwd(x, w.float(), bias.float(), hj, mj, 1.25)
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("b,hi,mi,hj,mj,nact", PATCHY_SHAPES)
def test_patchy_and_compact_forward_kernels_read_bf16(gen, b, hi, mi, hj, mj,
                                                      nact):
    ni, nj, table = _patchy_operands(gen, b, hi, mi, hj, mj, nact)
    x = _rand(gen, b, ni)
    w = (_randn(gen, ni, nj) * 0.1).to(torch.bfloat16)
    bias = _randn(gen, nj).to(torch.bfloat16)
    got = ops.patchy_forward(x, w, bias, table, mi, hj, mj, 1.25)
    want = ref.ref_patchy_forward(x, w.float(), bias.float(), table, mi, hj,
                                  mj, 1.25)
    assert (got - want).abs().max().item() <= 1e-5
    w_c = (_randn(gen, hj, nact * mi, mj) * 0.1).to(torch.bfloat16)
    got = ops.compact_forward(x, w_c, bias, table, mi, 1.25)
    want = ref.ref_compact_forward(x, w_c.float(), bias.float(), table, mi,
                                   1.25)
    assert (got - want).abs().max().item() <= 1e-5


def _unaligned(t, offset):
    """A contiguous copy of ``t`` whose data starts ``offset`` elements
    into its storage (so not 16-byte aligned)."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


# Each way the gathered forwards' slices reach shared memory (x by
# cp.async in 16-, 8- or 4-byte pieces; w by TMA, one 3-D box or one row
# box a gathered row, or by cp.async in 16- or 4-byte pieces, or plain bf16
# loads), with K not a multiple of 16 and split between the ranks of a
# cluster, K < 16, odd Mi, Mj = 10, two column chunks and unaligned bases.
# (B, Hi, Mi, Hj, Mj, nact, x offset, w offset)
GATHER_PATHS = [(37, 50, 4, 3, 64, 9, 0, 0),     # x 16 B; w TMA, K = 36
                (37, 30, 3, 2, 128, 13, 0, 0),   # x 4 B; w TMA, 7-row slice
                (20, 40, 2, 3, 20, 11, 0, 0),    # x 8 B; bf16 w 4 B
                (9, 7, 2, 2, 7, 3, 0, 0),        # w 4 B; bf16 w elementwise
                (37, 13, 3, 3, 10, 4, 0, 0),     # K = 12 < 16, Mj = 10
                (16, 90, 2, 2, 256, 40, 1, 1),   # unaligned x, w; Mj = 256
                (128, 784, 2, 32, 128, 128, 0, 1)]  # Model 1-struct, w 4 B


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hi,mi,hj,mj,nact,xo,wo", GATHER_PATHS)
def test_gathered_forward_kernel_copy_paths(gen, dtype, b, hi, mi, hj, mj,
                                            nact, xo, wo):
    ni, nj, table = _patchy_operands(gen, b, hi, mi, hj, mj, nact)
    x = _unaligned(_rand(gen, b, ni), xo)
    w = _unaligned((_randn(gen, ni, nj) * 0.1).to(dtype), wo)
    w_c = _unaligned((_randn(gen, hj, nact * mi, mj) * 0.1).to(dtype), wo)
    bias = _randn(gen, nj).to(dtype)
    got = ops.patchy_forward(x, w, bias, table, mi, hj, mj, 1.25)
    want = ref.ref_patchy_forward(x, w.float(), bias.float(), table, mi, hj,
                                  mj, 1.25)
    assert (got - want).abs().max().item() <= 1e-5
    got = ops.compact_forward(x, w_c, bias, table, mi, 1.25)
    want = ref.ref_compact_forward(x, w_c.float(), bias.float(), table, mi,
                                   1.25)
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hi,mi,hj,mj,nact", [(128, 784, 2, 32, 128, 128),
                                                (37, 13, 3, 3, 10, 4)])
def test_gathered_forward_kernels_keep_nan(gen, dtype, b, hi, mi, hj, mj,
                                           nact):
    """A NaN in x at a live unit, or in a live weight, reaches the rates
    where the plain version's; one in a silent row of the dense-resident w
    (never read) or at a silent unit of x changes nothing."""
    ni, nj, table = _patchy_operands(gen, b, hi, mi, hj, mj, nact)
    live = int(table[0, 0]) * mi
    silent_hcs = sorted(set(range(hi)) - set(table.flatten().tolist()))
    x = _rand(gen, b, ni)
    w = (_randn(gen, ni, nj) * 0.1).to(dtype)
    w_c = (_randn(gen, hj, nact * mi, mj) * 0.1).to(dtype)
    bias = _randn(gen, nj).to(dtype)
    nan = _canonical_nan()

    def both(x, w, w_c):
        for kern, plain in (
                (lambda: ops.patchy_forward(x, w, bias, table, mi, hj, mj),
                 lambda: ref.ref_patchy_forward(x, w.float(), bias.float(),
                                                table, mi, hj, mj)),
                (lambda: ops.compact_forward(x, w_c, bias, table, mi),
                 lambda: ref.ref_compact_forward(x, w_c.float(),
                                                 bias.float(), table, mi))):
            yield kern(), plain()

    xn = x.clone()
    xn[3, live] = nan
    wn, wcn = w.clone(), w_c.clone()
    wn[live, 2] = nan.to(dtype)
    wcn[0, 0, 2] = nan.to(dtype)
    for xs, ws, wcs in ((xn, w, w_c), (x, wn, wcn)):
        for got, want in both(xs, ws, wcs):
            assert _same_non_finite(got, want)
            ok = torch.isfinite(want)
            assert (got[ok] - want[ok]).abs().max().item() <= 1e-5
    if silent_hcs:
        xs, ws = x.clone(), w.clone()
        xs[:, silent_hcs[0] * mi] = nan
        ws[silent_hcs[0] * mi, :] = nan.to(dtype)
        for got, want in both(xs, ws, w_c):
            assert bool(torch.isfinite(got).all())
            assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hi,mi,hj,mj,nact", [(128, 784, 2, 32, 128, 128),
                                                (37, 13, 3, 3, 10, 4)])
def test_gathered_forward_kernels_repeat_bit_for_bit(gen, dtype, b, hi, mi,
                                                     hj, mj, nact):
    """The cluster adds its partial supports in rank order: ten launches on
    the same operands give the same rates bit for bit."""
    ni, nj, table = _patchy_operands(gen, b, hi, mi, hj, mj, nact)
    x = _rand(gen, b, ni)
    w = (_randn(gen, ni, nj) * 0.1).to(dtype)
    w_c = (_randn(gen, hj, nact * mi, mj) * 0.1).to(dtype)
    bias = _randn(gen, nj).to(dtype)
    for call in (lambda: ops.patchy_forward(x, w, bias, table, mi, hj, mj),
                 lambda: ops.compact_forward(x, w_c, bias, table, mi)):
        first = call()
        assert all(torch.equal(call(), first) for _ in range(10))


def test_gathered_forward_kernels_at_fitted_log_odds(gen):
    """Model 1-struct (nact 128 of 784 input HCs, K = 256) with weights at
    the fitted range of log-odds: both gathered forwards within 1e-5 of
    the plain version and of an fp64 forward over the live rows."""
    from repro_torch.core.compact import (gather_dense, gather_pre,
                                          unit_indices)
    hi, mi, hj, mj, nact = 784, 2, 32, 128, 128
    x, w, bias = _fitted_log_odds(gen, hi, hj, mj)
    b, nj = x.shape[0], hj * mj
    table = build_table(topk_mask(_rand(gen, hi, hj), nact), nact)
    ui = unit_indices(table, mi, sentinel=hi * mi)
    w_c = gather_dense(w, ui, hj, mj).contiguous()
    s64 = torch.einsum("jbk,jkm->bjm", gather_pre(x.double(), ui),
                       w_c.double()).reshape(b, nj) + bias.double()
    assert s64.abs().max().item() >= 10.0
    want64 = torch.softmax(s64.view(b, hj, mj), -1).view(b, -1)
    _assert_rates_close(ops.patchy_forward(x, w, bias, table, mi, hj, mj),
                        ref.ref_patchy_forward(x, w, bias, table, mi, hj, mj),
                        want64)
    _assert_rates_close(ops.compact_forward(x, w_c, bias, table, mi),
                        ref.ref_compact_forward(x, w_c, bias, table, mi),
                        want64)


def test_quant_launches_counted_and_bad_operands_refused(gen):
    ni, nj, table = _patchy_operands(gen, 8, 13, 2, 5, 10, 4)
    x, w_q = _rand(gen, 8, ni), _codes(gen, ni, nj)
    bias, scale = _quant_operands(gen, 5, nj)
    w_c = _codes(gen, 5, 8, 10)
    ops.reset_launch_counts()
    ops.quant_fwd(x, w_q, bias, scale, 5, 10)
    ops.quant_patchy_forward(x, w_q, bias, scale, table, 2, 5, 10)
    ops.quant_compact_forward(x, w_c, bias, scale, table, 2)
    counts = ops.launch_counts()
    assert counts["quant_fwd"] == 1 and counts["quant_patchy_forward"] == 1
    assert counts["quant_compact_forward"] == 1
    bad = [
        lambda: ops.quant_fwd(x, w_q.float(), bias, scale, 5, 10),  # fp32 w
        lambda: ops.quant_fwd(x, w_q[:, :40], bias, scale, 5, 10),  # shape
        lambda: ops.quant_fwd(x, w_q, bias, scale[:4], 5, 10),      # scale
        lambda: ops.quant_fwd(x, w_q, bias.double(), scale, 5, 10),
        lambda: ops.quant_patchy_forward(x, w_q, bias, scale, table.long(), 2,
                                         5, 10),
        lambda: ops.quant_compact_forward(x, w_q, bias, scale, table, 2),
        lambda: ops.quant_compact_forward(x, _codes(gen, 5, 9, 10), bias,
                                          scale, table, 2),
        lambda: ops.quant_fwd(x, w_q, bias, scale, 5, 10, cluster=9),
        lambda: ops.quant_patchy_forward(x, w_q, bias, scale, table, 2, 5, 10,
                                         cluster=-1),
        lambda: ops.bcpnn_fwd(x, w_q, bias, 5, 10),                 # int8 w
        lambda: ops.bcpnn_fwd(x, w_q.to(torch.bfloat16), bias, 5, 10),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()
    assert ops.launch_counts() == counts


@pytest.mark.parametrize("layout", ["dense", "patchy", "compact"])
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_low_precision_infer_on_card_matches_cpu_plain(gen, layout, dtype):
    """A converted, briefly trained state served in ``dtype`` on the card
    (kernels) and on the CPU (plain torch): probabilities within 1e-5,
    predictions equal, pad rows inert."""
    from repro_torch.convert import state_from_numpy, state_to_numpy
    from repro_torch.core.network import (BCPNNConfig, infer, init_deep,
                                          online_learn_step)
    nact = 16 if layout == "dense" else 6
    spec = BCPNNConfig(input_hc=16, hidden_hc=4, hidden_mc=8, n_classes=4,
                       nact_hi=nact, patchy_traces=layout == "compact",
                       compact=layout == "compact").network_spec()
    rng = np.random.default_rng(0)
    x = rng.random((16, 32), dtype=np.float32)
    y = rng.integers(0, 4, 16)
    st = init_deep(spec.with_backend("torch"), seed=0, device="cpu")
    for _ in range(5):
        st = online_learn_step(st, spec.with_backend("torch"),
                               torch.from_numpy(x), torch.from_numpy(y))
    tree = state_to_numpy(st)
    valid = np.array([1.0] * 8 + [0.0] * 8, np.float32)
    outs = []
    for dev, sp in (("cuda", spec), ("cpu", spec.with_backend("torch"))):
        sp = sp.with_infer_dtype(dtype)
        p, q = infer(state_from_numpy(tree, sp, device=dev), sp,
                     torch.from_numpy(x).to(dev),
                     torch.from_numpy(valid).to(dev))
        outs.append((p.cpu(), q.cpu()))
    (pk, qk), (pp, qp) = outs
    assert (pk - pp).abs().max().item() <= 1e-5
    assert torch.equal(qk, qp)
    assert (pk[8:] == 0).all() and (qk[8:] == -1).all()


# ------------------------------------------- donated and captured steps ----

# (B, Hi, Mi, Hj, Mj, nact): Model 1-struct (the dense update at its full
# 1568 x 4096 too) and the ragged shape of phase 1
IN_PLACE_SHAPES = [(128, 784, 2, 32, 128, 128), (37, 13, 3, 3, 10, 4)]


@pytest.mark.parametrize("n", [None, 5])
@pytest.mark.parametrize("b,hi,mi,hj,mj,nact", IN_PLACE_SHAPES)
def test_update_kernels_in_place_equal_out_of_place(gen, b, hi, mi, hj, mj,
                                                    nact, n):
    """Each of the three layouts' update written over pij and w (``out``)
    gives what the fresh outputs hold, bit for bit: every block reads only
    the pij tile it writes.  The patchy update in place still leaves its
    silent entries as they were."""
    ni, nj, table = _patchy_operands(gen, b, hi, mi, hj, mj, nact)
    lpi = torch.log(_rand(gen, ni) * 0.5 + 1e-4)
    lpj = torch.log(_rand(gen, nj) * 0.5 + 1e-4)
    x, y = _rand(gen, b, ni), _rand(gen, b, nj)
    count = None
    if n is not None:
        x[n:], y[n:] = 0.0, 0.0
        count = torch.tensor(float(n), device="cuda")
    a = torch.tensor(0.02, device="cuda")
    mask = topk_mask(_rand(gen, hi, hj), nact)
    pij = _rand(gen, ni, nj) * 0.01 + 1e-5
    pij_c = _rand(gen, hj, nact * mi, mj) * 0.01 + 1e-5
    silent = ~_live_units(table, hi, mi, mj)
    calls = {
        "bcpnn_update": (pij, lambda p, **kw: ops.bcpnn_update(
            p, lpi, lpj, x, y, mask, a, count=count, **kw)),
        "patchy_update": (pij, lambda p, **kw: ops.patchy_update(
            p, lpi, lpj, x, y, table, a, mi, hj, mj, count=count, **kw)),
        "compact_update": (pij_c, lambda p, **kw: ops.compact_update(
            p, lpi, lpj, x, y, table, a, mi, count=count, **kw)),
    }
    for name, (p0, call) in calls.items():
        want = call(p0)
        p, w = p0.clone(), torch.full_like(p0, float("nan"))
        ops.reset_launch_counts()
        got = call(p, out=(p, w))
        assert ops.launch_counts()[name] == 1
        assert got[0] is p and got[1] is w, name
        assert torch.equal(p, want[0]) and torch.equal(w, want[1]), name
        if name == "patchy_update":
            assert torch.equal(p[silent], p0[silent])
            assert bool((w[silent] == 0).all())


LAYOUTS = {"dense": {}, "a": dict(nact=[40, 3]),
           "b": dict(nact=[40, 3], patchy_traces=True),
           "c": dict(nact=[40, 3], patchy_traces=True, compact=True)}


def _small_fit_data(spec, n=75):
    rng = np.random.default_rng(7)
    x = rng.random((n, spec.input_geom.H), dtype=np.float32)
    return (np.stack([x, 1 - x], -1).reshape(n, -1),
            rng.integers(0, spec.n_classes, n))


def _eager_fit(spec, x, labels, epochs, batch, seed):
    """The loop of functional steps that ``Trainer.fit`` replays; returns
    the state and the launches it made."""
    from repro_torch.core import Trainer
    from repro_torch.core.bcpnn_layer import forward
    from repro_torch.core.network import (supervised_readout_step,
                                          train_projection_step)
    from repro_torch.core.trainer import _batchify_padded
    st = Trainer(spec, seed=seed, device="cuda").state
    xs_np, valid_np = _batchify_padded(x, batch)
    ys_np, _ = _batchify_padded(labels.astype(np.int32), batch)
    xs, ys, valid = (torch.from_numpy(v).cuda()
                     for v in (xs_np, ys_np, valid_np))
    nb = xs.shape[0]
    ops.reset_launch_counts()
    cur = xs
    for layer in range(spec.depth):
        for _ in range(epochs):
            for b in range(nb):
                st = train_projection_step(
                    st, spec, cur[b], layer,
                    valid=valid[b] if b == nb - 1 else None)
        if layer + 1 < spec.depth:
            cur = torch.stack([forward(st.projs[layer], spec.projs[layer],
                                       h) for h in cur])
    for b in range(nb):
        st = supervised_readout_step(st, spec, xs[b], ys[b],
                                     valid=valid[b] if b == nb - 1 else None)
    torch.cuda.synchronize()
    return st, ops.launch_counts()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_graphed_fit_equals_the_eager_step_loop(gen, layout):
    """``Trainer.fit`` on the card (captured steps replayed, depth 2, a
    rewire every 3 steps, a padded tail taken eagerly) ends in the eager
    loop's state bit for bit, with the same launch counts; ``evaluate``
    through the captured eval step gives the accuracy of eager ``infer``
    calls on the same batches of that state, and counts one forward per
    stack projection and one softmax per batch."""
    from repro_torch.configs.bcpnn_models import deep_synth_spec
    from repro_torch.core import Trainer
    from repro_torch.core.graphs import state_tensors
    from repro_torch.core.network import infer
    from repro_torch.core.trainer import _eval_data
    spec = deep_synth_spec(side=12, depth=2, hidden_hc=4, hidden_mc=8,
                           struct_every=3, **LAYOUTS[layout])
    x, labels = _small_fit_data(spec)
    want, eager_counts = _eager_fit(spec, x, labels, 2, 16, seed=3)
    tr = Trainer(spec, seed=3, device="cuda")
    ops.reset_launch_counts()
    tr.fit(x, labels, epochs=2, batch=16)
    torch.cuda.synchronize()
    assert ops.launch_counts() == eager_counts
    for a, b in zip(state_tensors(tr.state), state_tensors(want)):
        assert torch.equal(a, b)
    for p, q in zip(tr.state.projs, want.projs):
        assert p.traces.t_host == q.traces.t_host == 10
    ops.reset_launch_counts()
    acc = tr.evaluate(x, labels, batch=16)
    counts = ops.launch_counts()
    assert counts["hc_softmax"] == 5  # the readout's normalize, 5 batches
    assert sum(counts.values()) == 5 * 3  # and the two stack forwards
    xs, ys, valid = _eval_data(x, labels, 16, torch.device("cuda"))
    correct = 0.0
    for b in range(xs.shape[0]):
        _, pred = infer(want, spec, xs[b], valid=valid[b])
        correct += float((pred == ys[b]).sum())
    assert acc == pytest.approx(correct / len(x), abs=1e-6)


def test_graphed_steps_make_no_sync_and_count_their_launches(gen):
    """After capture at the first batch, 8 replayed unsupervised steps
    across the rewire at clock 6 (patchy-held layout), a readout step and
    an eval batch run with any device synchronisation an error; each
    replay adds what its capture counted, the capture itself nothing."""
    from repro_torch.configs.bcpnn_models import deep_synth_spec
    from repro_torch.core import Trainer
    spec = deep_synth_spec(side=12, depth=1, hidden_hc=4, hidden_mc=8,
                           nact=[40], patchy_traces=True, struct_every=6)
    tr = Trainer(spec, seed=0, device="cuda")
    x, labels = _small_fit_data(spec, 9 * 16)
    xs = torch.from_numpy(x).cuda().view(9, 16, -1)
    ys = torch.from_numpy(labels.astype(np.int32)).cuda().view(9, 16)
    valid = torch.ones((9, 16), device="cuda")
    unsup, sup, ev = tr._unsup_fn(0, False), tr._sup_fn(False), tr._eval_fn()
    ops.reset_launch_counts()
    tr.state = unsup(tr.state, xs[:1])
    assert ops.launch_counts()["patchy_update"] == 1  # the first replay
    tr.state = sup(tr.state, xs[:1], ys[:1])
    ev(tr.state, xs[:1], ys[:1], valid[:1])
    mask = tr.state.projs[0].mask.clone()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tr.state = unsup(tr.state, xs[1:])
        tr.state = sup(tr.state, xs[:1], ys[:1])
        acc = ev(tr.state, xs[:1], ys[:1], valid[:1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counts = ops.launch_counts()
    assert counts["patchy_update"] == 8 and counts["bcpnn_update"] == 1
    assert counts["patchy_forward"] == 2 and counts["hc_softmax"] == 9
    proj = tr.state.projs[0]
    assert proj.traces.t_host == 9 == int(proj.traces.t)
    assert not torch.equal(proj.mask, mask)  # the rewire at 6 ran
    assert 0.0 <= float(acc) <= 1.0


def test_captures_survive_graphs_collected_as_garbage(gen):
    """A Trainer is a reference cycle (its cached epoch programs refer back
    to it), so its graphs die only when the cycle collector runs, and a
    graph destroyed during another capture invalidates that capture.  With
    the collector run at almost every allocation, trainers dropped one
    after another still leave the next one's captures whole."""
    import gc
    from repro_torch.configs.bcpnn_models import deep_synth_spec
    from repro_torch.core import Trainer
    spec = deep_synth_spec(side=12, depth=1, hidden_hc=4, hidden_mc=8)
    x, labels = _small_fit_data(spec)
    threshold = gc.get_threshold()
    try:
        for seed in range(3):
            tr = Trainer(spec, seed=seed, device="cuda")
            tr.fit(x, labels, epochs=1, batch=16)
            assert 0.0 <= tr.evaluate(x, labels, batch=16) <= 1.0
            del tr
            gc.set_threshold(1)
    finally:
        gc.set_threshold(*threshold)


# ------------------------------------------ checkpoints and serving ----

def _serve_spec(**over):
    from repro_torch.configs.bcpnn_models import deep_synth_spec
    kw = dict(side=12, depth=1, hidden_hc=4, hidden_mc=8)
    kw.update(over)
    return deep_synth_spec(**kw)


def _eager_served(state, spec, x, valid):
    from repro_torch.core.network import infer_packed, pack_state
    return infer_packed(pack_state(state, spec), spec, x, valid)


@pytest.mark.parametrize("layout,dtype", [
    ("dense", "fp32"), ("dense", "int8"), ("b", "fp32"), ("b", "int8"),
    ("c", "bf16"), ("c", "int8")])
def test_served_bucket_graph_equals_eager_after_fold_and_rewire(
        gen, layout, dtype):
    """A bucket's CUDA graph serves what eager ``infer_packed`` gives on
    the same padded group, bit for bit: on the loaded state, after each of
    three stack folds (the third crosses a rewire in the patchy layouts;
    (b)'s moves pre-HCs, (c)'s, as at Model 1-struct, may not), and after
    loading another seed's state, whose mask and table differ.  The static
    pack keeps its tensors: every load is written into them."""
    from repro_torch.core.graphs import ServeProgram, pack_tensors
    from repro_torch.core.network import init_deep, online_learn_step
    over = {"dense": {}, "b": dict(nact=[40], patchy_traces=True,
                                   struct_every=2),
            "c": dict(nact=[40], patchy_traces=True, compact=True,
                      struct_every=2)}[layout]
    spec = _serve_spec(**over).with_infer_dtype(dtype)
    state = init_deep(spec, 3, "cuda")
    program = ServeProgram(spec)
    program.load(state)
    for b in (1, 4, 8):
        program.capture(b)
    ptrs = [t.data_ptr() for t in pack_tensors(program.pack)]
    x, labels = _small_fit_data(spec, 16)
    xs = torch.from_numpy(x).cuda()
    ys = torch.from_numpy(labels.astype(np.int32)).cuda()
    mask0 = state.projs[0].mask.clone()
    for step in range(5):
        for b in (1, 4, 8):
            xb = xs[:b].clone()
            valid = (torch.arange(b, device="cuda") < max(1, b - 1)).float()
            probs, pred = program(xb, valid)
            want_p, want_q = _eager_served(state, spec, xb, valid)
            assert torch.equal(probs, want_p) and torch.equal(pred, want_q)
            hp, hq = program.serve(xb.cpu().numpy(), valid.cpu().numpy())
            assert np.array_equal(hp, want_p.cpu().numpy())
            assert np.array_equal(hq, want_q.cpu().numpy())
        if step < 3:
            state = online_learn_step(state, spec, xs, ys, learn_stack=True)
        else:
            if layout == "b" and step == 3:
                assert state.projs[0].traces.t_host == 3
                assert not torch.equal(state.projs[0].mask, mask0)
            state = init_deep(spec, 9 + step, "cuda")
        program.load(state)
        assert [t.data_ptr() for t in pack_tensors(program.pack)] == ptrs
    if layout != "dense":
        assert not torch.equal(state.projs[0].mask, mask0)


def test_no_sync_in_repack_or_replay(gen):
    """``load`` (the fold-boundary repack, int8 quantization and a patchy
    table included) and a replay run with any device synchronisation an
    error."""
    from repro_torch.core.graphs import ServeProgram
    from repro_torch.core.network import init_deep, online_learn_step
    spec = _serve_spec(nact=[40], patchy_traces=True,
                       struct_every=1).with_infer_dtype("int8")
    state = init_deep(spec, 0, "cuda")
    program = ServeProgram(spec)
    program.load(state)
    program.capture(8)
    x, labels = _small_fit_data(spec, 8)
    xs = torch.from_numpy(x).cuda()
    ys = torch.from_numpy(labels.astype(np.int32)).cuda()
    valid = torch.ones(8, device="cuda")
    folded = online_learn_step(state, spec, xs, ys, learn_stack=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        program.load(folded)
        probs, _ = program(xs, valid)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want, _ = _eager_served(folded, spec, xs, valid)
    assert torch.equal(probs, want)


def _quarantine_run(spec, state, nan_row, fault_schedule):
    from repro_torch.core.graphs import state_tensors
    from repro_torch.serve import BCPNNService, FaultInjector
    inj = FaultInjector(seed=0, schedule=fault_schedule)
    svc = BCPNNService(state, spec, max_batch=8, online_learning=True,
                       feedback_batch=4, feedback_eager=False,
                       fault_injector=inj).start()
    x, labels = _small_fit_data(spec, 12)
    try:
        for i in range(4):
            svc.feedback(x[i], int(labels[i]))
        _wait_for(lambda: svc.snapshot()["learn_steps"] == 1)
        good = [t.clone() for t in state_tensors(svc.model_state())]
        for i in range(4, 8):
            row = x[i].copy()
            if nan_row and i == 5:
                row[7] = np.nan
            svc.feedback(row, int(labels[i]))
        _wait_for(lambda: svc.snapshot()["quarantined"] == 1.0)
        for g, a in zip(good, state_tensors(svc.model_state())):
            assert torch.equal(g, a)
        served = svc.classify(x[9], timeout=30)
        want_p, want_q = _eager_served(
            svc.model_state(), spec,
            torch.from_numpy(x[9:10]).cuda(), torch.ones(1, device="cuda"))
        assert served.pred == int(want_q[0])
        assert np.array_equal(served.probs, want_p[0].cpu().numpy())
        assert svc.snapshot()["learn_steps"] == 1.0
    finally:
        svc.stop()


def _wait_for(cond, timeout_s=60.0):
    import time
    end = time.perf_counter() + timeout_s
    while not cond():
        assert time.perf_counter() < end, "condition never held"
        time.sleep(0.002)


def test_quarantine_rolls_back_bitwise_on_the_card(gen):
    from repro_torch.core.network import init_deep
    spec = _serve_spec()
    _quarantine_run(spec, init_deep(spec, 1, "cuda"), False,
                    {"nan-state": {1}})


def test_nan_feedback_row_is_quarantined_on_the_card(gen):
    """A NaN in one feedback row goes through the forward and update
    kernels of a readout fold (the tensor-core kernels keep NaN) and the
    sentinel catches the candidate."""
    from repro_torch.core.network import init_deep
    spec = _serve_spec()
    _quarantine_run(spec, init_deep(spec, 2, "cuda"), True, {})


def test_restored_trainer_next_noisy_epoch_equals_the_uninterrupted_one(
        gen, tmp_path):
    """A trainer whose steps were captured restores a checkpoint (new
    tensors, a new generator at the saved state): its next noisy epoch,
    through a fresh capture, equals the epoch the saving trainer runs on,
    bit for bit, generator included."""
    from repro_torch.core import Trainer
    from repro_torch.core.graphs import state_tensors
    spec = _serve_spec()
    x, labels = _small_fit_data(spec, 64)
    a = Trainer(spec, seed=0, device="cuda")
    a.fit(x, labels, epochs=1, batch=16)
    a.save(str(tmp_path))
    b = Trainer(spec, seed=5, device="cuda")
    b.fit(x, labels, epochs=1, batch=16)  # captured on other tensors
    assert b.restore(str(tmp_path)) == int(a.state.step)
    xs = torch.from_numpy(x).cuda().view(4, 16, -1)
    a.state = a._unsup_fn(0, False)(a.state, xs)
    b.state = b._unsup_fn(0, False)(b.state, xs)
    for u, v in zip(state_tensors(a.state), state_tensors(b.state)):
        assert torch.equal(u, v)
    assert torch.equal(a.state.generator.get_state(),
                       b.state.generator.get_state())


# ------------------------------------------------------------- the router --

class _Groups:
    """Wraps a ``ServeProgram.serve``: every served padded group and its
    results."""

    def __init__(self, program):
        self.serve, self.records = program.serve, []
        program.serve = self

    def __call__(self, x, valid):
        probs, pred = self.serve(x, valid)
        self.records.append((x.copy(), valid.copy(), probs, pred))
        return probs, pred

    def check_eager(self, pack, spec):
        from repro_torch.core.network import infer_packed
        for x, valid, probs, pred in self.records:
            p, q = infer_packed(pack, spec, torch.from_numpy(x).cuda(),
                                torch.from_numpy(valid).cuda())
            assert np.array_equal(p.cpu().numpy(), probs)
            assert np.array_equal(q.cpu().numpy(), pred)
        return len(self.records)


def test_live_add_model_captures_while_two_engines_serve(gen):
    """``add_model(live=True)`` on a running engine while two other
    engines' workers serve on the card from client threads: the capture
    succeeds, each bucket's graph counts the launches a capture on a quiet
    card counts (no other thread's work taken into it), every row the new
    slot serves equals eager ``infer_packed`` on its padded group, and the
    busy engines serve on, bit for bit, after it."""
    import threading
    from repro_torch.core.graphs import ServeProgram
    from repro_torch.core.network import init_deep
    from repro_torch.serve import BCPNNService
    spec = _serve_spec()
    x, _ = _small_fit_data(spec, 64)
    busy = [BCPNNService(init_deep(spec, s, "cuda"), spec,
                         max_batch=8).start() for s in (5, 6)]
    groups = [_Groups(svc._slot(None).program) for svc in busy]
    late = BCPNNService(max_batch=8).start()
    stop, errors = threading.Event(), []

    def client(svc):
        try:
            while not stop.is_set():
                ids = [svc.submit(x[i]) for i in range(16)]
                for rid in ids:
                    svc.result(rid, timeout=60)
        except BaseException as e:  # reported by the test below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(svc,))
               for svc in busy]
    for t in threads:
        t.start()
    try:
        _wait_for(lambda: all(len(g.records) >= 5 for g in groups))
        before = [len(g.records) for g in groups]
        state = init_deep(spec, 4, "cuda")
        late.add_model("m", state, spec, live=True)
        slot = late._slot("m")
        new = _Groups(slot.program)
        _wait_for(lambda: all(len(g.records) >= n + 5
                              for g, n in zip(groups, before)))
        ids = [late.submit(x[i], model="m") for i in range(40)]
        for rid in ids:
            late.result(rid, timeout=60)
    finally:
        stop.set()
        for t in threads:
            t.join(60)
        for svc in busy + [late]:
            svc.stop()
    assert not errors and not any(t.is_alive() for t in threads)
    assert sorted(slot.program.buckets) == [1, 2, 4, 8]
    quiet = ServeProgram(spec)
    quiet.load(state)
    for b, bucket in slot.program.buckets.items():
        quiet.capture(b)
        assert bucket.launches == quiet.buckets[b].launches
    assert new.check_eager(slot.pack, spec) > 0
    for svc, g in zip(busy, groups):
        assert g.check_eager(svc._slot(None).pack, spec) >= 10


def test_three_engines_on_one_card_serve_the_same_rows(gen):
    """One state placed on three engines of one card (replicas=3, each a
    copy of its own): the same row served by each engine gives the same
    probabilities bit for bit, equal to eager ``infer_packed``."""
    from repro_torch.core.network import init_deep, infer_packed, pack_state
    from repro_torch.serve import BCPNNRouter
    spec = _serve_spec()
    state = init_deep(spec, 7, "cuda")
    r = BCPNNRouter.local(3, max_batch=8)
    r.add_model("m", state, spec, replicas=3)
    r.start()
    x, _ = _small_fit_data(spec, 8)
    try:
        got = {e: [h.result(h.submit(row, "m"), timeout=60).probs
                   for row in x] for e, h in r._engines.items()}
    finally:
        r.stop()
    for e, rows in got.items():
        assert r._engines[e].model_state_sync("m").readout.w.data_ptr() \
            != state.readout.w.data_ptr()
        for i, p in enumerate(rows):
            p1, _ = infer_packed(pack_state(state, spec), spec,
                                 torch.from_numpy(x[i:i + 1]).cuda(),
                                 torch.ones(1, device="cuda"))
            assert np.array_equal(p, p1[0].cpu().numpy()), (e, i)
            assert np.array_equal(p, got["engine0"][i])


def test_recovery_from_the_checkpoint_lands_on_the_card(gen):
    """A model on one engine, lost with no live peer, is re-placed from the
    router's host checkpoint onto the card its placement serves on: its
    tensors and generator are the card's, at the saved values and
    position, its buckets captured live, and it serves as eager
    ``infer_packed``."""
    from repro_torch.core.network import init_deep, infer_packed, pack_state
    from repro_torch.serve import BCPNNRouter, states_bitwise_equal
    spec = _serve_spec()
    state = init_deep(spec, 8, "cuda")
    torch.rand(5, generator=state.generator, device="cuda")  # off the seed
    r = BCPNNRouter.local(2, max_batch=8)
    assert r.add_model("m", state, spec) == ("engine0",)
    ckpt, _ = r._checkpoints["m"]
    assert ckpt.device.type == "cpu"
    assert ckpt.generator.device.type == "cuda"
    r.start()
    x, _ = _small_fit_data(spec, 4)
    try:
        r._engines["engine0"].kill("test")
        _wait_for(lambda: r.placement("m")["replicas"] == ("engine1",)
                  or bool(r.check_engines()))
        assert r.placement("m")["replicas"] == ("engine1",)
        handle = r._engines["engine1"]
        got = handle.model_state_sync("m")
        served = [r.classify(row, timeout=60) for row in x]
        program = handle.service._slot("m").program
    finally:
        r.stop()
    assert got.device.type == "cuda" and got.generator.device.type == "cuda"
    assert torch.equal(got.generator.get_state(),
                       state.generator.get_state())
    assert states_bitwise_equal(got, state)
    assert sorted(program.buckets) == [1, 2, 4, 8]
    for i, res in enumerate(served):
        p, q = infer_packed(pack_state(state, spec), spec,
                            torch.from_numpy(x[i:i + 1]).cuda(),
                            torch.ones(1, device="cuda"))
        assert np.array_equal(res.probs, p[0].cpu().numpy())
        assert res.pred == int(q[0])


# ------------------------------------------ the data-parallel products --

def _block_diff(full, parts, dim):
    d = (torch.cat(parts, dim=dim) - full).abs()
    return int((d != 0).sum()), float(d.max())


@pytest.mark.parametrize("b", [128, 104])  # a whole batch, a tail's rows
@pytest.mark.parametrize("n", [2, 4])
def test_cublas_column_blocks_at_model1_shapes(gen, b, n):
    """The DP step's dense products at Model 1's shapes, n ranks' column
    blocks against the same columns of the whole product: the
    co-activation xᵀy and the HC softmax are column-invariant at 2 and 4
    blocks, the support x @ w at 2.  At 4 blocks (1024 columns) cuBLAS sums
    the support in another order (ROADMAP.md queue C), within 1e-4."""
    from repro_torch.core.hypercolumns import LayerGeom, hc_softmax
    ni, hj, mj = 1568, 32, 128
    x, w, y = _rand(gen, b, ni), _randn(gen, ni, hj * mj), _rand(gen, b,
                                                                hj * mj)
    k = hj * mj // n
    blk = [slice(i * k, (i + 1) * k) for i in range(n)]
    s = x @ w
    co = x.T @ y
    assert _block_diff(co, [x.T @ y[:, c] for c in blk], 1)[0] == 0
    assert _block_diff(hc_softmax(s, LayerGeom(hj, mj)), [
        hc_softmax(s[:, c].contiguous(), LayerGeom(hj // n, mj))
        for c in blk], 1)[0] == 0
    count, worst = _block_diff(s, [x @ w[:, c] for c in blk], 1)
    if n == 2:
        assert count == 0
    else:
        assert worst <= 1e-4, (count, worst)


@pytest.mark.parametrize("n", [2, 4])
def test_compact_column_blocks_at_model1_struct_shapes(gen, n):
    """The compact support and co-activation at Model 1-struct's shapes
    (nact 128, K = 256): n ranks' post-HC blocks equal the whole's."""
    from repro_torch.core.compact import compact_co_stats, compact_support
    hi, mi, hj, mj, nact = 784, 2, 32, 128, 128
    x, y = _rand(gen, 128, hi * mi), _rand(gen, 128, hj * mj)
    table = torch.stack([torch.sort(torch.randperm(
        hi, generator=gen, device="cuda")[:nact]).values
        for _ in range(hj)]).to(torch.int32)
    w_c, bias = _randn(gen, hj, nact * mi, mj), _randn(gen, hj * mj)
    l = hj // n
    hs = [slice(i * l, (i + 1) * l) for i in range(n)]
    s = compact_support(x, w_c, bias, table, mi)
    co = compact_co_stats(x, y, table, mi, mj)
    assert _block_diff(s, [compact_support(
        x, w_c[h], bias[h.start * mj:h.stop * mj], table[h], mi)
        for h in hs], 1)[0] == 0
    assert _block_diff(co, [compact_co_stats(
        x, y[:, h.start * mj:h.stop * mj].contiguous(), table[h], mi, mj)
        for h in hs], 0)[0] == 0


def test_dp_steps_on_the_card_equal_the_single_device_steps(gen):
    """Two rank processes sharing the card over gloo: Model 1's DP
    unsupervised and readout steps from seed 0's state equal the
    single-device steps bit for bit, generator included."""
    import dataclasses

    import torch_dp_ranks as R
    from repro_torch.configs.bcpnn_models import MODEL1_MNIST
    from repro_torch.core import init_deep
    from repro_torch.core.network import (as_spec, supervised_readout_step,
                                          unsupervised_layer_step)
    from repro_torch.distributed import run_group
    from repro_torch.launch.train_dp import snapshots_equal
    spec = as_spec(dataclasses.replace(MODEL1_MNIST, backend="torch"))
    rng = np.random.default_rng(0)
    xs = rng.random((2, 128, spec.input_geom.N), dtype=np.float32)
    ys = rng.integers(0, spec.n_classes, (2, 128)).astype(np.int32)
    ranks = run_group(R.run, 2, backend="gloo", device="cuda", args=(
        [("unsup_steps", dict(spec=spec, xs=xs)),
         ("sup_steps", dict(spec=spec, xs=xs, ys=ys))],), timeout_s=300)
    st, st_sup = init_deep(spec, 0, "cuda"), init_deep(spec, 0, "cuda")
    for i in range(2):
        x = torch.from_numpy(xs[i]).cuda()
        st = unsupervised_layer_step(st, spec, x, 0)
        st_sup = supervised_readout_step(st_sup, spec, x,
                                         torch.from_numpy(ys[i]).cuda())
        for r in ranks:
            assert snapshots_equal(r[0][i], R.tree(st)), (r, i)
            assert snapshots_equal(r[1][i], R.tree(st_sup)), (r, i)


# ------------------------------------------------------ the head's shapes --
# The BCPNN head on an LM trunk (core/head.py): input Ni = 2 x d_model
# (256 at the example's smoke trunk, 2048 at qwen1.5-0.5b), hidden 16 HCs
# of 16 (the example) or 64 (the default) minicolumns, readouts of 4 and
# 10 classes; served one row at a time, or in batches of 64 and 128.
HEAD_BATCHES = [1, 64, 128]
HEAD_LAYERS = [(256, 16, 16), (2048, 16, 64)]      # (Ni, Hj, Mj)
HEAD_READOUTS = [(16, 16, 4), (16, 64, 10)]        # (Hi, Mi, classes)


@pytest.mark.parametrize("b", HEAD_BATCHES)
@pytest.mark.parametrize("ni,hj,mj", HEAD_LAYERS)
def test_bcpnn_fwd_kernel_at_head_shapes(gen, b, ni, hj, mj):
    x = _rand(gen, b, ni)
    w = _randn(gen, ni, hj * mj) * 0.1
    bias = _randn(gen, hj * mj)
    got = ops.bcpnn_fwd(x, w, bias, hj, mj)
    want = ref.ref_bcpnn_fwd(x, w, bias, hj, mj)
    assert (got - want).abs().max().item() <= 1e-5


# The dense forward against an fp64 forward, with the plain (cuBLAS) path
# as the yardstick.  "rand": phase 1's draws at the head's and Model 1's
# hidden shapes, where both paths sit ~1e-6 from fp64 over 128 x 1024 or
# more rates and the kernel may be no further than twice the plain path.
# "logodds": operands as a fitted or head state gives them (complementary
# input rates, weights of -5.7 to 1.2, log-prior biases near -8: supports
# of thousands over a long contraction), held to chip_smoke.py phase 3's
# rule, max(1e-5, twice the plain path).  A tensor-core accumulator that
# carries a block's whole contraction truncates at the magnitude of the
# running sum: it sat 4-5x the plain path's distance on "rand" and broke
# the rule on "logodds" at a readout shape; the kernel now adds each
# slice's products into its sum in fp32.
@pytest.mark.parametrize("family,hi,hj,mj", [
    ("rand", 1024, 16, 64), ("rand", 784, 32, 128),
    ("logodds", 1024, 16, 64), ("logodds", 784, 32, 128),
    ("logodds", 512, 1, 10), ("logodds", 128, 1, 4)])
def test_bcpnn_fwd_kernel_against_fp64(gen, family, hi, hj, mj):
    if family == "rand":
        x = _rand(gen, 128, 2 * hi)
        w = _randn(gen, 2 * hi, hj * mj) * 0.1
        bias = _randn(gen, hj * mj) * 0.1
    else:
        p = torch.sigmoid(4 * _randn(gen, 128, hi))
        x = torch.stack([p, 1 - p], -1).reshape(128, 2 * hi).contiguous()
        w = _rand(gen, 2 * hi, hj * mj) * 6.9 - 5.7
        bias = _rand(gen, hj * mj) * 2 - 9
    s64 = bias.double() + x.double() @ w.double()
    r64 = torch.softmax(s64.view(128, hj, mj), -1).view(128, -1)
    err_k = (ops.bcpnn_fwd(x, w, bias, hj, mj).double() - r64).abs().max()
    err_p = (ref.ref_bcpnn_fwd(x, w, bias, hj, mj).double() - r64).abs().max()
    limit = 2 * err_p.item()
    if family == "logodds":
        limit = max(1e-5, limit)
    assert err_k.item() <= limit, (err_k.item(), err_p.item())


@pytest.mark.parametrize("b", HEAD_BATCHES)
@pytest.mark.parametrize("hi,mi,hj,mj", [(ni // 2, 2, hj, mj)
                                         for ni, hj, mj in HEAD_LAYERS]
                         + [(hi, mi, 1, c) for hi, mi, c in HEAD_READOUTS])
def test_bcpnn_update_kernel_at_head_shapes(gen, b, hi, mi, hj, mj):
    ni, nj = hi * mi, hj * mj
    pij = _rand(gen, ni, nj) * 0.01 + 1e-5
    lpi = torch.log(_rand(gen, ni) * 0.5 + 1e-4)
    lpj = torch.log(_rand(gen, nj) * 0.5 + 1e-4)
    x, y = _rand(gen, b, ni), _rand(gen, b, nj)
    mask = (_rand(gen, hi, hj) > 0.3).float()
    a = torch.tensor(5e-2, device="cuda")
    gp, gw = ops.bcpnn_update(pij, lpi, lpj, x, y, mask, a)
    wp, ww = ref.ref_bcpnn_update(pij, lpi, lpj, x, y, mask, a)
    assert bool(((gp - wp).abs() <= 1e-9 + 1e-5 * wp.abs()).all())
    assert (gw - ww).abs().max().item() <= 1e-4


@pytest.mark.parametrize("b", HEAD_BATCHES)
@pytest.mark.parametrize("h,m", [(16, 16), (16, 64), (1, 4), (1, 10)])
def test_hc_softmax_kernel_at_head_shapes(gen, b, h, m):
    s = _randn(gen, b, h * m) * 4
    got = ops.hc_softmax(s, h, m)
    want = ref.ref_hc_softmax(s, h, m)
    assert (got - want).abs().max().item() <= 2e-6


@pytest.mark.parametrize("nact", [0, 64])
def test_head_steps_on_card_match_cpu_plain(gen, nact):
    """The head's three calls, each from one state (the card's result of
    the call before, copied to the CPU) and the same features, on the card
    through the kernels and on the CPU through the plain versions: states
    within 1e-4, probabilities within 1e-5, predictions equal."""
    from repro_torch import convert
    from repro_torch.core import head
    cfg = head.BCPNNHeadConfig(feature_dim=128, nact_hi=nact)
    st_cpu = head.init_head(cfg, 0, "cpu")
    st_gpu = convert.state_from_numpy(convert.state_to_numpy(st_cpu),
                                      cfg.network_config(), "cuda")
    f = torch.randn((64, 128), generator=torch.Generator().manual_seed(1))
    y = torch.randint(0, 10, (64,), generator=torch.Generator().manual_seed(2))
    noise = torch.randn((64, 16 * 64),
                        generator=torch.Generator().manual_seed(3))
    def on_cpu(st):
        return convert.state_from_numpy(convert.state_to_numpy(st),
                                        cfg.network_config(), "cpu")

    def assert_states_close(a, b):
        for x, z in zip(_state_leaves(convert.state_to_numpy(a)),
                        _state_leaves(convert.state_to_numpy(b))):
            np.testing.assert_allclose(x, z, rtol=0, atol=1e-4)

    ops.reset_launch_counts()
    st_gpu = head.head_unsupervised(st_gpu, cfg, f.cuda(), noise=noise.cuda())
    assert_states_close(st_gpu, head.head_unsupervised(st_cpu, cfg, f,
                                                       noise=noise))
    st_cpu = on_cpu(st_gpu)
    st_gpu = head.head_supervised(st_gpu, cfg, f.cuda(), y.cuda())
    assert_states_close(st_gpu, head.head_supervised(st_cpu, cfg, f, y))
    st_cpu = on_cpu(st_gpu)
    probs_gpu, pred_gpu = head.head_predict(st_gpu, cfg, f.cuda())
    fwd = "patchy_forward" if nact else "bcpnn_fwd"
    counts = ops.launch_counts()
    assert (counts["hc_softmax"], counts["bcpnn_update"], counts[fwd]) == \
        (2, 2, 2), counts
    probs_cpu, pred_cpu = head.head_predict(st_cpu, cfg, f)
    assert (probs_gpu.cpu() - probs_cpu).abs().max().item() <= 1e-5
    assert torch.equal(pred_gpu.cpu(), pred_cpu)


def _state_leaves(tree):
    """The float array leaves of a ``convert.state_to_numpy`` tree, in order."""
    out = []
    for p in tree["projs"] + [tree["readout"]]:
        out += [p["traces"][k] for k in ("pi", "pj", "pij")]
        out += [p[k] for k in ("w", "b", "mask")]
    return out


# -------------------------------------------------------------- the LM zoo --

ZOO_ARCHS = ["falcon-mamba-7b", "gemma2-2b", "internvl2-26b",
             "mistral-nemo-12b", "moonshot-v1-16b-a3b", "qwen1.5-0.5b",
             "qwen3-32b", "qwen3-moe-30b-a3b", "recurrentgemma-2b",
             "whisper-tiny"]


def _zoo(arch):
    """A smoke architecture in fp32: its config, the seeded CPU parameters
    and a copy on the card, prompts (2 x 12 of 18) and extra inputs."""
    import copy

    from repro_torch.configs import get_config, smoke
    from repro_torch.models import lm
    cfg = smoke(get_config(arch))
    params = lm.init_params(cfg, 0, "cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 18)))
    extra = {}
    if cfg.vision_patches:
        extra["patches"] = torch.from_numpy(rng.normal(
            size=(2, cfg.vision_patches, cfg.d_model)).astype(np.float32))
    if cfg.enc_layers:
        extra["frames"] = torch.from_numpy(rng.normal(
            size=(2, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    return cfg, params, copy.deepcopy(params).to("cuda"), toks, extra


def _cache_leaves(cache):
    return [t for c in cache.layers for t in c.values()] + [cache.pos]


def _assert_leaves_close(got, want, what):
    for a, b in zip(_cache_leaves(got), _cache_leaves(want)):
        if a.is_floating_point():
            assert (a.cpu() - b).abs().max().item() <= 1e-4, what
        else:
            assert torch.equal(a.cpu(), b), what


@pytest.mark.parametrize("arch", ZOO_ARCHS)
def test_decode_steps_on_card_match_cpu(gen, arch):
    """forward's hidden states, prefill (logits and every cache leaf) and
    six decode steps on the card against the CPU, fp32, within 1e-4
    (cuBLAS sums in another order), integer leaves and ``pos`` equal;
    gemma2 and recurrentgemma decode past their ring's wrap.  Decode
    against forward on the card within the reference's 2e-3
    (tests/test_archs_smoke.py)."""
    from repro_torch.models import lm
    cfg, params, params_gpu, toks, extra = _zoo(arch)
    ex_gpu = {k: v.cuda() for k, v in extra.items()}
    hid_c = lm.forward(params, cfg, toks, **extra)
    hid_g = lm.forward(params_gpu, cfg, toks.cuda(), **ex_gpu)
    assert (hid_g.cpu() - hid_c).abs().max().item() <= 1e-4, arch
    fwd_g = lm.logits_for(params_gpu, cfg, hid_g)
    lo_c, c_c = lm.prefill(params, cfg, toks[:, :12], 18, **extra)
    lo_g, c_g = lm.prefill(params_gpu, cfg, toks[:, :12].cuda(), 18,
                           **ex_gpu)
    assert (lo_g.cpu() - lo_c).abs().max().item() <= 1e-4
    _assert_leaves_close(c_g, c_c, (arch, "prefill"))
    for i in range(6):
        lo_c, c_c = lm.decode_step(params, cfg, c_c, toks[:, 12 + i])
        lo_g, c_g = lm.decode_step(params_gpu, cfg, c_g,
                                   toks[:, 12 + i].cuda())
        assert (lo_g.cpu() - lo_c).abs().max().item() <= 1e-4, (arch, i)
        assert (lo_g - fwd_g[:, 12 + i]).abs().max().item() <= 2e-3, \
            (arch, i)
    _assert_leaves_close(c_g, c_c, (arch, "decode"))


@pytest.mark.parametrize("arch", ZOO_ARCHS)
def test_decode_step_on_card_needs_no_host_sync(gen, arch):
    """A decode step reads nothing back from the card: the cache slot, the
    validity mask and the MoE dispatch are computed on the device."""
    from repro_torch.models import lm
    cfg, _, params, toks, extra = _zoo(arch)
    ex_gpu = {k: v.cuda() for k, v in extra.items()}
    _, cache = lm.prefill(params, cfg, toks[:, :12].cuda(), 18, **ex_gpu)
    tokens = toks[:, 12].cuda()
    lm.decode_step(params, cfg, cache, tokens)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            logits, cache = lm.decode_step(params, cfg, cache, tokens)
            tokens = torch.argmax(logits, -1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(cache.pos) == 16


def _loss_and_grads(params, cfg, toks, extra):
    from repro_torch.convert import lm_leaf_groups
    from repro_torch.models import lm
    loss = lm.lm_loss(params, cfg, toks, **extra)
    groups = lm_leaf_groups(params)
    flat = [t for g in groups.values() for t in g]
    got = iter(torch.autograd.grad(loss, flat))
    return loss.detach(), {k: [next(got) for _ in g]
                           for k, g in groups.items()}


@pytest.mark.parametrize("arch", ZOO_ARCHS)
def test_train_step_on_card_matches_cpu(gen, arch):
    """One train step of each smoke architecture in fp32 on the card
    against the CPU: the loss within 1e-5, every gradient within 1e-4 of
    its leaf's largest |gradient| (cuBLAS and the CPU sum in other
    orders), and the parameters after ``make_train_step`` (AdamW, lr 1e-3)
    within one step's bound, 2 * lr * (1 + wd * max|p|): an element whose
    gradient is near 0 moves by lr either way on its sign."""
    import copy

    from repro_torch.configs import get_config, smoke
    from repro_torch.convert import lm_leaf_groups
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, init_opt_state
    cfg = smoke(get_config(arch)).with_(lmhead_chunk=8)
    params = lm.init_params(cfg, 0, "cpu", train=True)
    params_gpu = copy.deepcopy(params).to("cuda")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)).astype(
        np.int32))
    extra = {}
    if cfg.vision_patches:
        extra["patches"] = torch.from_numpy(rng.normal(
            size=(2, cfg.vision_patches, cfg.d_model)).astype(np.float32))
    if cfg.enc_layers:
        extra["frames"] = torch.from_numpy(rng.normal(
            size=(2, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    ex_gpu = {k: v.cuda() for k, v in extra.items()}
    loss_c, g_c = _loss_and_grads(params, cfg, toks, extra)
    loss_g, g_g = _loss_and_grads(params_gpu, cfg, toks.cuda(), ex_gpu)
    assert abs(loss_g.item() - loss_c.item()) <= 1e-5, arch
    for path in g_c:
        for a, b in zip(g_g[path], g_c[path]):
            tol = 1e-4 * max(b.abs().max().item(), 1e-30)
            assert (a.cpu() - b).abs().max().item() <= tol, (arch, path)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step = make_train_step(cfg, opt_cfg)
    pmax = max(p.abs().max().item() for p in params.parameters())
    batch = {"tokens": toks, **extra}
    step(params, init_opt_state(lm_leaf_groups(params)), batch)
    step(params_gpu, init_opt_state(lm_leaf_groups(params_gpu)),
         {k: v.cuda() for k, v in batch.items()})
    bound = 2 * opt_cfg.lr * (1 + opt_cfg.weight_decay * pmax)
    for (name, a), b in zip(params_gpu.named_parameters(),
                            params.parameters()):
        assert (a.detach().cpu() - b.detach()).abs().max().item() <= bound, \
            (arch, name)


def test_compress_grads_on_card_is_bitwise_the_cpu(gen):
    """``compress_grads`` on the card against the CPU on the same
    gradients and error, a stacked leaf's repeats at other magnitudes:
    codes, dequantized gradients and error bit for bit (IEEE division by
    a device scale, products, and the error formed in fp64)."""
    from repro_torch.optim import compress_grads
    rng = np.random.default_rng(2)
    grads = {"blocks/a": [torch.from_numpy((rng.normal(size=(64, 96)) *
                                            10.0 ** e).astype(np.float32))
                          for e in (-3, 0, 1)],
             "tail/b": [torch.from_numpy(rng.normal(size=(4097,)).astype(
                 np.float32) * 1e-7)]}
    err = {k: [torch.from_numpy((rng.normal(size=t.shape) * 1e-3).astype(
        np.float32)) for t in g] for k, g in grads.items()}

    def cuda(tree):
        return {k: [t.cuda() for t in g] for k, g in tree.items()}

    d_c, e_c = compress_grads(grads, err)
    d_g, e_g = compress_grads(cuda(grads), cuda(err))
    for want, got in ((d_c, d_g), (e_c, e_g)):
        for k in want:
            for a, b in zip(got[k], want[k]):
                assert torch.equal(a.cpu(), b), k


# ------------------------------------------------------ split meshes --

# The split paths the card's phase 13 does not take: the MoE dispatch, the
# selective scan, the RG-LRU, whisper's encoder and cross-attention, the
# vision patches.
SPLIT_CARD_ARCHS = ["qwen3-moe-30b-a3b", "falcon-mamba-7b",
                    "recurrentgemma-2b", "whisper-tiny", "internvl2-26b"]


@pytest.fixture(scope="module")
def split_card():
    """Every split job of the tests below, in one group of four rank
    processes sharing the card over gloo (``tests/torch_mesh_ranks.py``):
    rank 0's results by architecture, and ``"compress"``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the split steps run on the card")
    import torch_mesh_ranks as R
    from repro_torch.distributed import run_group
    jobs = ([("train_step", (2, 2), {"arch": a, "tree": R.port_tree(a)})
             for a in SPLIT_CARD_ARCHS] + [("compress", (2, 2), {})])
    out = run_group(R.run, 4, backend="gloo", device="cuda", args=(jobs,),
                    timeout_s=600)[0]
    return dict(zip(SPLIT_CARD_ARCHS + ["compress"], out))


@pytest.mark.parametrize("arch", SPLIT_CARD_ARCHS)
def test_split_train_step_on_the_card_matches_one_rank(split_card, arch):
    """A smoke architecture split over (data 2, model 2) against the
    one-rank step on the card from the same parameters (``moe_groups`` = 2
    for the MoE), at ``test_torch_mesh_train.py``'s tolerances with the
    card's gradient tolerance, 1e-4 of each leaf's largest (PERF.md
    section 2): the loss, the gradients and their global norm, ``mu`` and
    ``nu``, and each parameter's change (``torch_mesh_ranks.hold_step``);
    the split model drawn by ``init_params`` bit for bit."""
    import torch_mesh_ranks as R
    R.check_split_step(split_card[arch], arch, 1e-4)


def test_compress_grads_on_split_card_tensors_is_bitwise(split_card):
    """``compress_grads`` on gradients split over (data 2, model 2) on the
    card against the one-rank call on the card, 3 steps carrying the
    error: bit for bit."""
    assert split_card["compress"]["bitwise"]
