"""The port's LM zoo (``repro_torch.models``) held against the JAX package
on the CPU, for each of the ten architectures at its ``smoke`` size.

Parameters come from JAX's ``lm.init_params`` and cross by
``convert.lm_params_from_numpy``; tokens, patches and frames are numpy
draws handed to both.  JAX runs jitted (the reference's own functions,
outside a mesh context, where ``shard`` is a no-op).

Tolerances (absolute):
  * fp32, port against JAX: 1e-4 on hidden states, logits and every float
    cache leaf (two fp32 summation orders over a few layers part by a few
    1e-6); integer leaves and ``pos`` bitwise.
  * decode against forward, within the port: 2e-3, the reference test's
    (``tests/test_archs_smoke.py::test_decode_matches_forward``).
  * bf16, port against JAX: 4 % of the largest magnitude of the reference
    tensor.  bf16 keeps 8 significant bits (a rounding of 2**-9 relative);
    every layer rounds some ten intermediates to bf16, and XLA keeps excess
    precision inside its fused elementwise chains where PyTorch rounds each
    op, so over the smoke depth the two part by a few bf16 ulps of the
    largest values (measured: 1.1 % to 2.7 %).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, get_config, smoke
from repro.data.pipeline import TokenStream as JTokenStream
from repro.data.pipeline import batch_indices as j_batch_indices
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke as t_smoke
from repro_torch.data.pipeline import TokenStream, batch_indices
from repro_torch.models import lm, moe

ARCH_IDS = sorted(ARCHS)
TOL = 1e-4
DECODE_VS_FORWARD = 2e-3
BF16_REL = 0.04
B, S, PROMPT, STEPS = 2, 18, 12, 6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dtype="float32"):
    return (smoke(get_config(arch)).with_(dtype=dtype),
            t_smoke(t_get_config(arch)).with_(dtype=dtype))


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    extra = {}
    if cfg.vision_patches:
        extra["patches"] = rng.normal(
            size=(B, cfg.vision_patches, cfg.d_model)).astype(np.float32)
    if cfg.enc_layers:
        extra["frames"] = rng.normal(
            size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return toks, extra


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy() if t.is_floating_point() else t.numpy()


def _jax_run(arch, dtype="float32", steps=STEPS):
    """JAX's forward (hidden and logits at every position), prefill (logits
    and cache) and ``steps`` decode steps (logits, and the cache after the
    last), jitted, with the parameter tree as numpy leaves."""
    cfg, _ = _cfgs(arch, dtype)
    params = jlm.init_params(cfg, jax.random.PRNGKey(0))
    toks, extra = _inputs(cfg)
    kw = {k: jnp.asarray(v) for k, v in extra.items()}
    hidden = jax.jit(lambda p, t, kw: jlm.forward(p, cfg, t, **kw))(
        params, toks, kw)
    logits = jax.jit(lambda p, h: jlm.logits_for(p, cfg, h))(params, hidden)
    lo, cache = jax.jit(lambda p, t, kw: jlm.prefill(p, cfg, t, S, **kw))(
        params, toks[:, :PROMPT], kw)
    run = {"tree": jax.tree.map(np.asarray, params), "toks": toks,
           "extra": extra, "hidden": np.asarray(hidden),
           "logits": np.asarray(logits), "prefill_logits": np.asarray(lo),
           "prefill_cache": jax.tree.map(np.asarray, cache)}
    dec = jax.jit(lambda p, c, t: jlm.decode_step(p, cfg, c, t))
    outs = []
    for i in range(steps):
        lo, cache = dec(params, cache, toks[:, PROMPT + i])
        outs.append(np.asarray(lo))
    run["decode_logits"] = outs
    run["decode_cache"] = jax.tree.map(np.asarray, cache)
    return run


@pytest.fixture(scope="module")
def jax_runs():
    """arch -> ``_jax_run(arch)``, computed once for the module's tests."""
    runs = {}

    def get(arch):
        if arch not in runs:
            runs[arch] = _jax_run(arch)
        return runs[arch]

    return get


def _port(run, tcfg):
    params = convert.lm_params_from_numpy(run["tree"], tcfg, "cpu")
    extra = {k: _t(v) for k, v in run["extra"].items()}
    return params, extra


def _close(got, want, atol, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


def _assert_cache_close(port_tree, jax_tree, atol, where):
    assert jax.tree.structure(port_tree) == jax.tree.structure(jax_tree), \
        where
    flat_p = jax.tree_util.tree_flatten_with_path(port_tree)[0]
    for (path, got), want in zip(flat_p, jax.tree.leaves(jax_tree)):
        name = f"{where} {jax.tree_util.keystr(path)}"
        assert np.asarray(got).dtype == np.asarray(want).dtype, name
        if np.issubdtype(np.asarray(want).dtype, np.integer):
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            _close(got, want, atol, name)


# ------------------------------------------------------------ fp32 parity --

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_matches_jax(arch, jax_runs):
    run = jax_runs(arch)
    _, tcfg = _cfgs(arch)
    params, extra = _port(run, tcfg)
    hidden = lm.forward(params, tcfg, _t(run["toks"]), **extra)
    _close(_np(hidden), run["hidden"], TOL, f"{arch} hidden")
    _close(_np(lm.logits_for(params, tcfg, hidden)), run["logits"], TOL,
           f"{arch} logits")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_matches_jax(arch, jax_runs):
    run = jax_runs(arch)
    _, tcfg = _cfgs(arch)
    params, extra = _port(run, tcfg)
    logits, cache = lm.prefill(params, tcfg, _t(run["toks"][:, :PROMPT]), S,
                               **extra)
    _close(_np(logits), run["prefill_logits"], TOL, f"{arch} prefill logits")
    assert cache.pos.dtype == torch.int32 and cache.pos.dim() == 0
    _assert_cache_close(convert.lm_cache_to_numpy(cache, tcfg),
                        run["prefill_cache"], TOL, f"{arch} prefill cache")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_matches_jax(arch, jax_runs):
    """Six teacher-forced decode steps from the port's own prefill; gemma2's
    and recurrentgemma's local layers (window 8) decode past the ring's
    wrap (positions 12..17).  The cache is written in place."""
    run = jax_runs(arch)
    _, tcfg = _cfgs(arch)
    params, extra = _port(run, tcfg)
    toks = _t(run["toks"])
    _, cache = lm.prefill(params, tcfg, toks[:, :PROMPT], S, **extra)
    leaves = [t for c in cache.layers for t in c.values()]
    for i in range(STEPS):
        logits, out = lm.decode_step(params, tcfg, cache, toks[:, PROMPT + i])
        assert out is cache
        _close(_np(logits), run["decode_logits"][i], TOL,
               f"{arch} decode step {i}")
    assert all(a is b for a, b in zip(
        leaves, [t for c in cache.layers for t in c.values()]))
    assert int(cache.pos) == PROMPT + STEPS
    _assert_cache_close(convert.lm_cache_to_numpy(cache, tcfg),
                        run["decode_cache"], TOL, f"{arch} decode cache")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_matches_forward(arch, jax_runs):
    """The port's decode logits at position p against its forward's logits
    at p, at the reference test's 2e-3."""
    run = jax_runs(arch)
    _, tcfg = _cfgs(arch)
    params, extra = _port(run, tcfg)
    toks = _t(run["toks"])
    ref = lm.logits_for(params, tcfg, lm.forward(params, tcfg, toks, **extra))
    _, cache = lm.prefill(params, tcfg, toks[:, :PROMPT], S, **extra)
    for i in range(STEPS - 1):
        logits, cache = lm.decode_step(params, tcfg, cache,
                                       toks[:, PROMPT + i])
        _close(_np(logits), _np(ref[:, PROMPT + i]), DECODE_VS_FORWARD,
               f"{arch} decode vs forward at {PROMPT + i}")


# ------------------------------------------------------------ bf16 parity --

@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "gemma2-2b",
                                  "falcon-mamba-7b"])
def test_bf16_matches_jax(arch):
    run = _jax_run(arch, "bfloat16", steps=3)
    _, tcfg = _cfgs(arch, "bfloat16")
    params, extra = _port(run, tcfg)
    assert params.tok_embed.dtype == torch.bfloat16
    toks = _t(run["toks"])

    def close(got, want, what):
        want = np.asarray(want, np.float32)
        _close(_np(got), want, BF16_REL * np.abs(want).max(), what)

    hidden = lm.forward(params, tcfg, toks, **extra)
    close(hidden, run["hidden"], f"{arch} bf16 hidden")
    close(lm.logits_for(params, tcfg, hidden), run["logits"],
          f"{arch} bf16 logits")
    logits, cache = lm.prefill(params, tcfg, toks[:, :PROMPT], S, **extra)
    close(logits, run["prefill_logits"], f"{arch} bf16 prefill logits")
    for i in range(3):
        logits, cache = lm.decode_step(params, tcfg, cache,
                                       toks[:, PROMPT + i])
        close(logits, run["decode_logits"][i], f"{arch} bf16 decode {i}")


# --------------------------------------------------------------- the MoE --

def _jax_routing(params, cfg, x):
    """The dispatch of JAX's ``moe_ffn`` (``repro/models/moe.py:38-76``,
    the same operations): top-k ids and gates, ranks, kept flags, slots."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_active
    groups, tg = 1, b * s
    cap = min(max(1, int(k * tg / e * cfg.capacity_factor)), tg)
    xt = x.reshape(groups, tg, d)
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ params["router"], -1)
    gate_vals, expert_ids = jax.lax.top_k(probs, k)
    gate_vals = gate_vals / jnp.sum(gate_vals, -1, keepdims=True)
    flat_ids = expert_ids.reshape(groups, tg * k)
    sort_idx = jnp.argsort(flat_ids, axis=1, stable=True)
    sorted_ids = jnp.take_along_axis(flat_ids, sort_idx, axis=1)
    first = jax.vmap(lambda q: jnp.searchsorted(
        q, jnp.arange(e, dtype=q.dtype)))(sorted_ids)
    pos = jnp.arange(tg * k, dtype=jnp.int32)[None]
    rank_sorted = pos - jnp.take_along_axis(first, sorted_ids, axis=1)
    rank = jnp.take_along_axis(rank_sorted,
                               jnp.argsort(sort_idx, axis=1), axis=1)
    keep = rank < cap
    slot = jnp.where(keep, flat_ids * cap + rank, e * cap)
    return {"probs": np.asarray(probs), "gates": np.asarray(gate_vals),
            "expert_ids": np.asarray(expert_ids), "rank": np.asarray(rank),
            "keep": np.asarray(keep), "slot": np.asarray(slot), "cap": cap}


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "qwen3-moe-30b-a3b"])
def test_moe_capacity_drops_match_jax(arch):
    """capacity_factor 1.0 drops choices: the expert ids, ranks, slots and
    the dropped set equal JAX's, the outputs within 1e-4.  A top-k
    near-tie that flips a choice fails with its gap; nothing is re-seeded
    to avoid one."""
    cfg, tcfg = (c.with_(capacity_factor=1.0) for c in _cfgs(arch))
    jp = jmoe.init_moe(jax.random.PRNGKey(3), cfg, jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    tp = moe.MoE(tcfg, torch.float32, torch.device("cpu"))
    for name, p in tp.named_parameters():
        p.copy_(_t(tree[name]))
    x = np.random.default_rng(7).normal(
        size=(2, 16, cfg.d_model)).astype(np.float32)

    ref = _jax_routing(tree, cfg, jnp.asarray(x))
    groups, tg, cap = moe.dispatch_shape(tcfg, 2, 16)
    assert (groups, cap) == (1, ref["cap"])
    got = moe.route(tp.router, tcfg, _t(x).reshape(groups, tg, -1), cap)
    srt = -np.sort(-ref["probs"], axis=-1)
    k = cfg.n_experts_active
    gap = float((srt[..., k - 1] - srt[..., k]).min())
    np.testing.assert_array_equal(
        got.expert_ids.numpy(), ref["expert_ids"],
        err_msg=f"top-k ids differ; the smallest k-th/(k+1)-th gap is "
                f"{gap:.3e}")
    for name in ("rank", "keep", "slot"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), ref[name],
                                      err_msg=name)
    dropped = int((~ref["keep"]).sum())
    assert dropped > 0, "capacity_factor 1.0 dropped nothing: no drop tested"
    _close(got.gates.numpy(), ref["gates"], 1e-6, "gates")
    y = moe.moe_ffn(tp, tcfg, _t(x))
    y_ref = np.asarray(jmoe.moe_ffn(jp, cfg, jnp.asarray(x)))
    _close(_np(y), y_ref, TOL, f"{arch} moe_ffn with {dropped} drops")


def test_top_k_takes_the_lower_index_on_a_tie():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3]])
    vals, idx = moe.top_k(probs, 2)
    assert idx.tolist() == [[1, 2]]
    _, j_idx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert np.asarray(j_idx).tolist() == [[1, 2]]


# --------------------------------------------------------- conversions --

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_cache_round_trip_bitwise(arch, jax_runs):
    run = jax_runs(arch)
    _, tcfg = _cfgs(arch)
    params = convert.lm_params_from_numpy(run["tree"], tcfg, "cpu")
    back = convert.lm_params_to_numpy(params, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(run["tree"])
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(run["tree"])):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == np.asarray(b).tobytes()
    for key in ("prefill_cache", "decode_cache"):
        cache = convert.lm_cache_from_numpy(run[key], tcfg, "cpu")
        back = convert.lm_cache_to_numpy(cache, tcfg)
        assert jax.tree.structure(back) == jax.tree.structure(run[key])
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(run[key])):
            assert a.dtype == b.dtype and a.tobytes() == \
                np.asarray(b).tobytes()


def test_bf16_params_round_trip_bitwise():
    cfg, tcfg = _cfgs("qwen3-32b", "bfloat16")
    tree = jax.tree.map(np.asarray,
                        jlm.init_params(cfg, jax.random.PRNGKey(1)))
    params = convert.lm_params_from_numpy(tree, tcfg, "cpu")
    assert params.layers[0].attn.wq.dtype == torch.bfloat16
    back = convert.lm_params_to_numpy(params, tcfg)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_conversion_refuses_a_mismatched_tree(jax_runs):
    run = jax_runs("qwen1.5-0.5b")
    _, tcfg = _cfgs("qwen1.5-0.5b")
    with pytest.raises(ValueError, match="wants"):
        convert.lm_params_from_numpy(run["tree"], tcfg.with_(d_ff=128),
                                     "cpu")
    with pytest.raises(ValueError, match="holds"):
        convert.lm_params_from_numpy(run["tree"], tcfg.with_(qkv_bias=False),
                                     "cpu")


def test_port_init_is_seeded_and_layered_in_execution_order():
    _, tcfg = _cfgs("recurrentgemma-2b")
    a = lm.init_params(tcfg, 3, "cpu")
    b = lm.init_params(tcfg, 3, "cpu")
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
        assert not p.requires_grad
    assert [layer.char for layer in a.layers] == ["r", "r", "l", "r", "r"]
    assert lm.layer_chars(tcfg) == ["r", "r", "l", "r", "r"]


# ------------------------------------------------------------ the data --

def test_token_stream_matches_jax_bitwise():
    for vocab, seed in ((512, 0), (151936, 3)):
        js, ts = JTokenStream(vocab, seed), TokenStream(vocab, seed)
        for step in (0, 5):
            a, b = js.batch(step, 4, 32), ts.batch(step, 4, 32)
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    for step in (0, 7, 40):
        np.testing.assert_array_equal(j_batch_indices(1000, 32, step, 9),
                                      batch_indices(1000, 32, step, 9))
