"""The port's kernel level, held against the JAX package on the CPU.

The same numpy inputs go through the JAX kernel entry points
(``repro.kernels.ops``: the Pallas kernels in interpret mode off-TPU) and
through the port's wrappers handed CPU tensors, which run the kernels'
plain PyTorch versions.  The CUDA kernels themselves are held against
those plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.hc_softmax import hc_softmax_pallas
from repro_torch.core.bcpnn_layer import topk_mask
from repro_torch.kernels import ops as tops

ROOT = Path(__file__).resolve().parents[1]

# Tolerances (absolute): forward rates 1e-5 (fp32 sums in another order);
# pij' 1e-6 on values ~1e-2; the log-weight fold 1e-4 (log amplifies the
# relative pij difference near the eps² floor).
FWD_TOL = 1e-5
PIJ_TOL = 1e-6
W_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers; torch's intra-op pool would take
    every core of the machine for these small shapes and slow the
    timing-sensitive tests running beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("b,h,m,gain", [(8, 4, 8, 1.0), (37, 3, 10, 1.0),
                                        (13, 1, 10, 2.5), (16, 32, 128, 1.0)])
def test_hc_softmax_matches_jax(b, h, m, gain):
    rng = np.random.default_rng(0)
    s = (rng.standard_normal((b, h * m)) * 4).astype(np.float32)
    want = np.asarray(jops.hc_softmax(jnp.asarray(s), h, m, gain))
    got = tops.hc_softmax(_t(s), h, m, gain).numpy()
    np.testing.assert_allclose(got, want, atol=FWD_TOL)


# The CUDA kernel's edge widths: a segment a lane (M = 1), one load past a
# whole warp (17, 33: masked lanes and a second load a lane) and one past
# its float4 width (129: eight scalar loads a lane).
@pytest.mark.parametrize("m", [1, 17, 33, 129])
def test_hc_softmax_plain_matches_pallas_at_edge_widths(m):
    rng = np.random.default_rng(m)
    b, h = 5, 3
    s = (rng.standard_normal((b, h * m)) * 4).astype(np.float32)
    want = np.asarray(hc_softmax_pallas(jnp.asarray(s), h, m, 1.5,
                                        interpret=True))
    got = tops.hc_softmax(_t(s), h, m, 1.5).numpy()
    np.testing.assert_allclose(got, want, atol=FWD_TOL)


@pytest.mark.parametrize("b,ni,hj,mj", [(8, 32, 4, 16), (37, 1000, 3, 10),
                                        (16, 1568, 2, 128)])
def test_bcpnn_fwd_matches_jax(b, ni, hj, mj):
    rng = np.random.default_rng(1)
    x = rng.random((b, ni), dtype=np.float32)
    w = (rng.standard_normal((ni, hj * mj)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(hj * mj).astype(np.float32)
    want = np.asarray(jops.bcpnn_fwd(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(bias), hj, mj))
    got = tops.bcpnn_fwd(_t(x), _t(w), _t(bias), hj, mj).numpy()
    np.testing.assert_allclose(got, want, atol=FWD_TOL)


@pytest.mark.parametrize("b,hi,mi,hj,mj,zero_mask", [
    (8, 16, 2, 4, 16, False), (37, 500, 2, 3, 10, True),
    (16, 784, 2, 1, 10, False)])
def test_bcpnn_update_matches_jax(b, hi, mi, hj, mj, zero_mask):
    rng = np.random.default_rng(2)
    ni, nj = hi * mi, hj * mj
    pij = (rng.random((ni, nj)) * 0.01 + 1e-5).astype(np.float32)
    lpi = np.log(rng.random(ni) * 0.5 + 1e-4).astype(np.float32)
    lpj = np.log(rng.random(nj) * 0.5 + 1e-4).astype(np.float32)
    x = rng.random((b, ni), dtype=np.float32)
    y = rng.random((b, nj), dtype=np.float32)
    mask = (rng.random((hi, hj)) > 0.3).astype(np.float32)
    if zero_mask:
        mask[:, 0] = 0.0  # a post-HC with no live input at all
    units = np.repeat(np.repeat(mask, mi, axis=0), mj, axis=1)
    alpha = np.float32(0.02)
    jp, jw = jops.bcpnn_update(jnp.asarray(pij), jnp.asarray(lpi),
                               jnp.asarray(lpj), jnp.asarray(x),
                               jnp.asarray(y), jnp.asarray(units),
                               jnp.asarray(alpha))
    tp, tw = tops.bcpnn_update(_t(pij), _t(lpi), _t(lpj), _t(x), _t(y),
                               _t(mask), torch.tensor(alpha))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=PIJ_TOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=W_TOL)
    if zero_mask:
        assert np.all(tw.numpy()[:, :mj] == 0.0)


@pytest.mark.parametrize("b,n", [(16, 9), (37, 1)])
def test_bcpnn_update_count_on_zeroed_rows_matches_jax_on_genuine_rows(b, n):
    """A padded batch whose pad rows are zero, divided by ``count`` (the
    genuine rows), updates as the JAX kernel does on the genuine rows
    alone."""
    rng = np.random.default_rng(7)
    hi, mi, hj, mj = 12, 2, 3, 10
    ni, nj = hi * mi, hj * mj
    pij = (rng.random((ni, nj)) * 0.01 + 1e-5).astype(np.float32)
    lpi = np.log(rng.random(ni) * 0.5 + 1e-4).astype(np.float32)
    lpj = np.log(rng.random(nj) * 0.5 + 1e-4).astype(np.float32)
    x = rng.random((n, ni), dtype=np.float32)
    y = rng.random((n, nj), dtype=np.float32)
    mask = (rng.random((hi, hj)) > 0.3).astype(np.float32)
    units = np.repeat(np.repeat(mask, mi, axis=0), mj, axis=1)
    alpha = np.float32(0.02)
    jp, jw = jops.bcpnn_update(jnp.asarray(pij), jnp.asarray(lpi),
                               jnp.asarray(lpj), jnp.asarray(x),
                               jnp.asarray(y), jnp.asarray(units),
                               jnp.asarray(alpha))
    xp = np.zeros((b, ni), np.float32)
    yp = np.zeros((b, nj), np.float32)
    xp[:n], yp[:n] = x, y
    tp, tw = tops.bcpnn_update(_t(pij), _t(lpi), _t(lpj), _t(xp), _t(yp),
                               _t(mask), torch.tensor(alpha),
                               count=torch.tensor(float(n)))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=PIJ_TOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=W_TOL)


def test_split_tf32_product_holds_the_update_tolerance_and_one_pass_does_not():
    """The resident-trace update forms XᵀY on the tensor cores in 3xTF32.
    At a Model-1 column slice (B=128, Ni=1568, 256 columns) and a = 1 (the
    first step of every fit, where pij' is XᵀY/n itself), the CPU model
    of that arithmetic holds the card check's pij tolerance (1e-9 +
    1e-5·|ref|, chip_smoke.py phase 1) against an fp64 XᵀY; a single
    TF32 pass breaks it, so the check can tell the two apart."""
    from repro_torch.kernels.ref import split_tf32_mm, tf32_round
    rng = np.random.default_rng(14)
    b, ni, nj = 128, 1568, 256
    x = rng.random((b, ni), dtype=np.float32)
    y = rng.random((b, nj), dtype=np.float32)
    pij = (rng.random((ni, nj)) * 0.01 + 1e-5).astype(np.float32)
    a = torch.tensor(1.0)
    want = x.astype(np.float64).T @ y.astype(np.float64) / b

    def within(co):
        new = ((1.0 - a) * _t(pij) + a * co).double().numpy()
        return bool(np.all(np.abs(new - want) <= 1e-9 + 1e-5 * np.abs(want)))

    assert within(split_tf32_mm(_t(x).T, _t(y)) / b)
    assert not within(tf32_round(_t(x)).T @ tf32_round(_t(y)) / b)
    # the split halves are TF32 numbers: 13 low mantissa bits clear
    hi = tf32_round(_t(x))
    lo = tf32_round(_t(x) - hi)
    for part in (hi, lo):
        assert bool(((part.view(torch.int32) & 0x1FFF) == 0).all())
    np.testing.assert_array_equal((hi + lo - _t(x)).abs().numpy() <=
                                  np.abs(x) * 2.0 ** -21, True)


def _fitted_hidden_operands(rng, b, hi, mi, hj, mj, eps=1e-4):
    """x and a Model-1-like fitted (w, bias) at the learned log-odds range:
    w = log clip(pij, eps², 1) − log pi − log pj and bias = log pj, from
    traces of 512 binary-pixel inputs (two minicolumns a pixel) and sharp
    hidden rates.  Their supports reach ~10–20, where an error in the
    split would show in the rates."""
    ni, nj, n = hi * mi, hj * mj, 512

    def encode(rows):
        pix = (rng.random((rows, hi)) < 0.3).astype(np.float64)
        return np.stack([pix, 1.0 - pix], -1).reshape(rows, ni)

    xf = encode(n)
    s = (xf @ rng.standard_normal((ni, nj)) * 0.05).reshape(n, hj, mj)
    e = np.exp(s - s.max(-1, keepdims=True))
    yf = (e / e.sum(-1, keepdims=True)).reshape(n, nj)
    pi, pj, pij = xf.mean(0), yf.mean(0), xf.T @ yf / n
    w = (np.log(np.clip(pij, eps * eps, 1.0))
         - np.log(np.clip(pi, eps, 1.0))[:, None]
         - np.log(np.clip(pj, eps, 1.0))[None, :]).astype(np.float32)
    bias = np.log(np.clip(pj, eps, 1.0)).astype(np.float32)
    return encode(b).astype(np.float32), w, bias


def test_split_tf32_support_holds_the_forward_tolerance_and_one_pass_does_not():
    """The dense forward forms its support on the tensor cores in 3xTF32.
    At Model 1's hidden shape (B=128, Ni=1568, 32×128) with fitted-range
    weights, the CPU model of that arithmetic gives rates within the
    forward tolerance (1e-5 abs) of the JAX forward and of an fp64 one; a
    single TF32 pass breaks it."""
    from repro_torch.kernels.ref import (ref_hc_softmax, split_tf32_mm,
                                         tf32_round)
    rng = np.random.default_rng(15)
    b, hi, mi, hj, mj = 128, 784, 2, 32, 128
    x, w, bias = _fitted_hidden_operands(rng, b, hi, mi, hj, mj)
    s64 = x.astype(np.float64) @ w.astype(np.float64) + bias
    assert 10.0 <= np.abs(s64).max() <= 40.0
    want64 = ref_hc_softmax(torch.from_numpy(s64), hj, mj).numpy()
    want = np.asarray(jops.bcpnn_fwd(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(bias), hj, mj))

    def rates(support):
        return ref_hc_softmax(support + _t(bias), hj, mj).numpy()

    split = rates(split_tf32_mm(_t(x), _t(w)))
    one_pass = rates(tf32_round(_t(x)) @ tf32_round(_t(w)))
    for ref_rates in (want, want64):
        assert np.abs(split - ref_rates).max() <= FWD_TOL
        assert np.abs(one_pass - ref_rates).max() > FWD_TOL


def test_split_tf32_gathered_support_holds_the_forward_tolerance_and_one_pass_does_not():
    """The patchy and compact forwards form each post-HC's support over
    its K = nact*Mi gathered rows on the tensor cores in 3xTF32.  At Model
    1-struct (B=128, 784×2 → 32×128, nact 128, K=256) with fitted-range
    weights, the CPU model of that arithmetic on the gathered operands
    gives rates within the forward tolerance (1e-5 abs) of the JAX compact
    forward and of an fp64 one; a single TF32 pass breaks it."""
    from repro.kernels import patchy as jpatchy
    from repro_torch.core.compact import (build_table, gather_dense,
                                          gather_pre, unit_indices)
    from repro_torch.kernels.ref import (ref_hc_softmax, split_tf32_mm,
                                         tf32_round)
    rng = np.random.default_rng(18)
    b, hi, mi, hj, mj, nact = 128, 784, 2, 32, 128, 128
    x, w, bias = _fitted_hidden_operands(rng, b, hi, mi, hj, mj)
    table = build_table(topk_mask(torch.from_numpy(rng.random((hi, hj))),
                                  nact), nact)
    ui = unit_indices(table, mi, sentinel=hi * mi)
    xg, wg = gather_pre(_t(x), ui), gather_dense(_t(w), ui, hj, mj)
    s64 = torch.einsum("jbk,jkm->bjm", xg.double(), wg.double())
    s64 = s64.reshape(b, hj * mj) + _t(bias).double()
    assert 10.0 <= s64.abs().max().item() <= 60.0
    want64 = ref_hc_softmax(s64, hj, mj).numpy()
    want = np.asarray(jpatchy.compact_forward(
        jnp.asarray(x), jnp.asarray(wg.numpy()), jnp.asarray(bias),
        jnp.asarray(table.numpy()), mi, interpret=jops._interpret()))

    def rates(support):  # (Hj, B, Mj) -> (B, Hj*Mj)
        s = support.transpose(0, 1).reshape(b, hj * mj) + _t(bias)
        return ref_hc_softmax(s, hj, mj).numpy()

    split = rates(split_tf32_mm(xg, wg))
    one_pass = rates(tf32_round(xg) @ tf32_round(wg))
    for ref_rates in (want, want64):
        assert np.abs(split - ref_rates).max() <= FWD_TOL
        assert np.abs(one_pass - ref_rates).max() > FWD_TOL


def test_bf16_weight_is_its_own_tf32_rounding():
    """A bf16 weight widened to fp32 has 8 mantissa bits, inside TF32's
    10: its TF32 split is (w, 0), so the bf16 forward needs only the two
    products with x's halves, and they are the whole 3xTF32 support."""
    from repro_torch.kernels.ref import (split_tf32_mm, tf32_round,
                                         tf32_truncate)
    rng = np.random.default_rng(16)
    w = torch.from_numpy(rng.standard_normal((300, 40)).astype(np.float32)
                         * 5).to(torch.bfloat16).float()
    hi = tf32_round(w)
    assert torch.equal(hi, w)
    assert bool((w - hi == 0).all())
    x = _t(rng.random((17, 300), dtype=np.float32))
    xh = tf32_round(x)
    two = tf32_truncate(x - xh) @ w + xh @ w
    np.testing.assert_array_equal(two.numpy(), split_tf32_mm(x, w).numpy())


def test_tf32_rounding_keeps_non_finite_values():
    """The integer rounding must not carry a NaN into the sign bit: every
    NaN (the card's canonical 0x7FFFFFFF, negative ones, one whose payload
    sits in the dropped bits) stays a NaN, infinities stay as they are,
    and a NaN in x reaches its whole row of the 3xTF32 product."""
    from repro_torch.kernels.ref import split_tf32_mm, tf32_round
    bits = torch.tensor([0x7FFFFFFF, -1, 0x7F800001, -0x400000, 0x7FC00000],
                        dtype=torch.int32)  # -1: 0xFFFFFFFF; 0xFFC00000
    nan = bits.view(torch.float32)
    assert bool(torch.isnan(tf32_round(nan)).all())
    # +inf, -inf (0xFF800000), the largest finite and its negative
    big = torch.tensor([0x7F800000, -0x800000, 0x7F7FFFFF, -0x800001],
                       dtype=torch.int32).view(torch.float32)
    got = tf32_round(big)
    assert torch.equal(got[:2], big[:2]) and not bool(torch.isnan(got).any())
    rng = np.random.default_rng(17)
    x = _t(rng.random((5, 64), dtype=np.float32))
    x[2, 7] = nan[0]
    w = _t(rng.standard_normal((64, 12)).astype(np.float32))
    finite = torch.isfinite(split_tf32_mm(x, w))
    assert torch.equal(finite, torch.isfinite(x @ w))
    assert not bool(finite[2].any()) and bool(finite[[0, 1, 3, 4]].all())


def test_split_tf32_compact_co_at_a1_holds_the_compact_update_tolerance():
    """The compact layout of the resident-trace update forms each
    post-HC's gathered xgᵀyg in 3xTF32.  At a = 1 (a fit's first step,
    where pij' is the product itself) and Model 1-struct's widths (B=128,
    784×2 inputs, nact 128 so K = 256, Mj = 128; four post-HCs), the CPU
    model of that arithmetic holds the card check's compact_update
    tolerance (pij' 1e-9 + 1e-5·|ref|, w 1e-4) against the JAX
    compact_update; a single TF32 pass breaks the pij' one."""
    from repro.kernels import patchy as jpatchy
    from repro_torch.core.compact import (fold_weights_compact, gather_pre,
                                          unit_indices)
    from repro_torch.kernels.ref import split_tf32_mm, tf32_round
    rng = np.random.default_rng(17)
    b, hi, mi, hj, mj, nact = 128, 784, 2, 4, 128, 128
    ni, nj, k = hi * mi, hj * mj, nact * mi
    table = np.sort(np.stack([rng.choice(hi, nact, replace=False)
                              for _ in range(hj)]), axis=1).astype(np.int32)
    pij_c = (rng.random((hj, k, mj)) * 0.01 + 1e-5).astype(np.float32)
    lpi = np.log(rng.random(ni) * 0.5 + 1e-4).astype(np.float32)
    lpj = np.log(rng.random(nj) * 0.5 + 1e-4).astype(np.float32)
    x = rng.random((b, ni), dtype=np.float32)
    y = rng.random((b, nj), dtype=np.float32)
    jp, jw = jpatchy.compact_update(
        jnp.asarray(pij_c), jnp.asarray(lpi), jnp.asarray(lpj),
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(table),
        jnp.asarray(np.float32(1.0)), mi, interpret=jops._interpret())
    jp, jw = np.asarray(jp), np.asarray(jw)
    tt = torch.from_numpy(table)
    xg = gather_pre(_t(x), unit_indices(tt, mi, sentinel=ni))  # (Hj, B, K)
    yg = _t(y).reshape(b, hj, mj).transpose(0, 1)               # (Hj, B, Mj)

    def close(co):
        w = fold_weights_compact(co, _t(lpi), _t(lpj), tt, mi, 1e-4)
        ok_p = np.all(np.abs(co.numpy() - jp) <= 1e-9 + 1e-5 * np.abs(jp))
        return bool(ok_p), float(np.abs(w.numpy() - jw).max())

    split = torch.stack([split_tf32_mm(xg[h].T, yg[h]) for h in range(hj)])
    ok_p, err_w = close(split / b)
    assert ok_p and err_w <= W_TOL
    one = torch.stack([tf32_round(xg[h]).T @ tf32_round(yg[h])
                       for h in range(hj)])
    assert not close(one / b)[0]


def test_cpu_tensors_take_plain_versions_without_counting():
    """A CPU tensor runs the plain version; only a kernel launch counts."""
    before = tops.launch_counts()
    assert set(before) == {"hc_softmax", "bcpnn_fwd", "bcpnn_update",
                           "patchy_forward", "compact_forward",
                           "patchy_update", "compact_update", "quant_fwd",
                           "quant_compact_forward", "quant_patchy_forward"}
    s = torch.randn(4, 6)
    tops.hc_softmax(s, 2, 3)
    tops.bcpnn_fwd(torch.rand(4, 5), torch.randn(5, 6), torch.zeros(6), 2, 3)
    tops.bcpnn_update(torch.full((4, 6), 0.05), torch.zeros(4),
                      torch.zeros(6), torch.rand(3, 4), torch.rand(3, 6),
                      torch.ones(2, 2), 0.1)
    assert tops.launch_counts() == before


def test_wrappers_refuse_other_devices():
    """Neither CPU nor CUDA: the wrappers raise instead of falling back."""
    s = torch.empty(4, 6, device="meta")
    with pytest.raises(ValueError):
        tops.hc_softmax(s, 2, 3)
    with pytest.raises(ValueError):
        tops.bcpnn_fwd(s, torch.empty(6, 6, device="meta"),
                       torch.empty(6, device="meta"), 2, 3)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_topk_mask_breaks_ties_toward_lower_index(k):
    """Exactly k ones per column, tied scores admitted in index order (the
    ``lax.top_k`` contract the JAX package relies on)."""
    from repro.core.bcpnn_layer import topk_mask as jtopk
    scores = np.array([[0.5, 0.0, 1.0],
                       [0.5, 0.0, 1.0],
                       [0.9, 0.0, 1.0],
                       [0.5, 0.0, 0.2]], np.float32)
    got = topk_mask(torch.from_numpy(scores), k).numpy()
    want = np.asarray(jtopk(jnp.asarray(scores), k))
    np.testing.assert_array_equal(got, want)
    assert np.all(got.sum(axis=0) == k)
    # all-tied column 1: the first k pre-HCs win
    np.testing.assert_array_equal(got[:, 1], (np.arange(4) < k).astype(float))


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{f.relative_to(ROOT)} imports {mod}"
