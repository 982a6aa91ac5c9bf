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
    from repro_torch.kernels.ref import split_tf32_co, tf32_round
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

    assert within(split_tf32_co(_t(x), _t(y), b))
    assert not within(tf32_round(_t(x)).T @ tf32_round(_t(y)) / b)
    # the split halves are TF32 numbers: 13 low mantissa bits clear
    hi = tf32_round(_t(x))
    lo = tf32_round(_t(x) - hi)
    for part in (hi, lo):
        assert bool(((part.view(torch.int32) & 0x1FFF) == 0).all())
    np.testing.assert_array_equal((hi + lo - _t(x)).abs().numpy() <=
                                  np.abs(x) * 2.0 ** -21, True)


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
