"""The port's BCPNN head (``repro_torch.core.head``), its example and the
LM serve launcher, held against the JAX package on the CPU.

The head's steps start from one state carried across from JAX's
``init_head`` (``convert.state_from_numpy``) and see the same pooled
trunk features (a smoke qwen1.5 trunk's mean-pooled final hidden states);
the unsupervised step gets JAX's exploration noise injected (the draw of
the state's key split, as ``tests/test_torch_trainer.py::_jax_noise``
does).  Tolerances (absolute, DESIGN.md §3): 1e-6 on the encoded rates
(one sigmoid of the same fp32 inputs; bf16 features within one bf16
ulp), 1e-5 on rates, probabilities and
traces, 1e-4 on weights and biases; masks and predictions exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import head as jhead
from repro_torch import convert
from repro_torch.configs import get_config, smoke
from repro_torch.core import head as thead
from repro_torch.examples import bcpnn_head_on_lm
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import lm

RATE_TOL = 1e-5
W_TOL = 1e-4
B, F = 48, 64


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _features():
    """(B, F) pooled features of a smoke qwen1.5 trunk (d_model cut to F)
    on TokenStream-like tokens, and (B,) labels."""
    cfg = smoke(get_config("qwen1.5-0.5b")).with_(d_model=F, head_dim=16)
    params = lm.init_params(cfg, 0, "cpu")
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 16)))
    with torch.no_grad():
        feats = lm.forward(params, cfg, toks).mean(dim=1)
    return feats.numpy(), rng.integers(0, 10, B).astype(np.int32)


def _jtree(st):
    def proj(p):
        return {"traces": {k: np.asarray(getattr(p.traces, k))
                           for k in ("pi", "pj", "pij", "t")},
                "w": np.asarray(p.w), "b": np.asarray(p.b),
                "mask": np.asarray(p.mask),
                "table": None if p.table is None else np.asarray(p.table)}
    return {"projs": [proj(p) for p in st.projs],
            "readout": proj(st.readout), "step": int(st.step)}


def _assert_state_close(st_t, st_j, where):
    for name, pt, pj in (("hidden", st_t.projs[0], st_j.projs[0]),
                         ("readout", st_t.readout, st_j.readout)):
        for k in ("pi", "pj", "pij"):
            np.testing.assert_allclose(
                getattr(pt.traces, k).numpy(), np.asarray(getattr(pj.traces,
                                                                  k)),
                rtol=0, atol=RATE_TOL, err_msg=f"{where} {name} {k}")
        for k in ("w", "b"):
            np.testing.assert_allclose(
                getattr(pt, k).numpy(), np.asarray(getattr(pj, k)), rtol=0,
                atol=W_TOL, err_msg=f"{where} {name} {k}")
        np.testing.assert_array_equal(pt.mask.numpy(), np.asarray(pj.mask))
        assert int(pt.traces.t) == int(pj.traces.t), where
    assert int(st_t.step) == int(st_j.step), where


def test_encode_features_matches_jax():
    feats, _ = _features()
    for gain in (4.0, 1.5):
        got = thead.encode_features(torch.from_numpy(feats), gain)
        want = np.asarray(jhead.encode_features(jnp.asarray(feats), gain))
        assert got.shape == (B, 2 * F)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_head_config_and_init_carry_across():
    for nact in (0, 16):
        jcfg = jhead.BCPNNHeadConfig(feature_dim=F, nact_hi=nact)
        tcfg = thead.BCPNNHeadConfig(feature_dim=F, nact_hi=nact)
        jnet, tnet = jcfg.network_config(), tcfg.network_config()
        for field in ("input_hc", "input_mc", "hidden_hc", "hidden_mc",
                      "n_classes", "nact_hi", "alpha", "eps", "gain",
                      "struct_every", "support_noise", "noise_steps"):
            assert getattr(jnet, field) == getattr(tnet, field), field
        assert tnet.backend == "cuda"
        st_j = jhead.init_head(jcfg, jax.random.PRNGKey(1))
        st_t = convert.state_from_numpy(_jtree(st_j), tnet, device="cpu")
        _assert_state_close(st_t, st_j, f"init nact={nact}")
        own = thead.init_head(tcfg, 1, "cpu")
        assert own.projs[0].w.shape == st_t.projs[0].w.shape


@pytest.mark.parametrize("nact", [0, 16])
def test_head_steps_match_jax(nact):
    """One unsupervised step (JAX's noise injected), one supervised step
    and a prediction, each from the state the previous step left, on both
    packages; dense (nact 0) and with a binding nact (16 of 64 input HCs:
    the patchy forward and the masked update)."""
    feats, labels = _features()
    jcfg = jhead.BCPNNHeadConfig(feature_dim=F, nact_hi=nact)
    tcfg = thead.BCPNNHeadConfig(feature_dim=F, nact_hi=nact)
    st_j = jhead.init_head(jcfg, jax.random.PRNGKey(2))
    st_t = convert.state_from_numpy(_jtree(st_j), tcfg.network_config(),
                                    device="cpu")
    fj, ft = jnp.asarray(feats), torch.from_numpy(feats)
    nj = tcfg.hidden_hc * tcfg.hidden_mc
    _, sub = jax.random.split(st_j.key)
    noise = torch.from_numpy(np.array(
        jax.random.normal(sub, (B, nj), jnp.float32)))

    st_j = jhead.head_unsupervised(st_j, jcfg, fj)
    st_t = thead.head_unsupervised(st_t, tcfg, ft, noise=noise)
    _assert_state_close(st_t, st_j, "unsupervised")

    st_j = jhead.head_supervised(st_j, jcfg, fj, jnp.asarray(labels))
    st_t = thead.head_supervised(st_t, tcfg, ft, torch.from_numpy(labels))
    _assert_state_close(st_t, st_j, "supervised")

    pj, yj = jhead.head_predict(st_j, jcfg, fj)
    pt, yt = thead.head_predict(st_t, tcfg, ft)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0,
                               atol=RATE_TOL)
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))


def test_head_takes_bf16_features_as_fp32_rates():
    """bf16 trunk features: the sigmoid in bf16, the network in fp32 (the
    JAX promotion at the first product).  The encoded rates agree within
    one bf16 ulp below 1 (2**-8): XLA keeps the product with the gain in
    fp32 inside its fused sigmoid, PyTorch rounds it to bf16 first."""
    feats, _ = _features()
    tcfg = thead.BCPNNHeadConfig(feature_dim=F)
    fb = torch.from_numpy(feats).to(torch.bfloat16)
    enc = thead.encode_features(fb, tcfg.encode_gain)
    assert enc.dtype == torch.bfloat16
    want = np.asarray(jhead.encode_features(
        jnp.asarray(feats).astype(jnp.bfloat16), tcfg.encode_gain))
    np.testing.assert_allclose(enc.float().numpy(), want.astype(np.float32),
                               rtol=0, atol=2.0 ** -8)
    st = thead.init_head(tcfg, 0, "cpu")
    probs, _ = thead.head_predict(st, tcfg, fb)
    assert probs.dtype == torch.float32
    st = thead.head_unsupervised(st, tcfg, fb)
    assert st.projs[0].traces.pij.dtype == torch.float32


def test_example_passes_its_gate_on_the_cpu(capsys):
    acc = bcpnn_head_on_lm.main(["--device", "cpu"])
    assert acc > 0.7
    assert "[bcpnn-head] online semi-supervised accuracy" in \
        capsys.readouterr().out


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "whisper-tiny"])
def test_serve_launcher_smoke_on_the_cpu(arch, capsys):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "16", "--gen", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[serve] prefill 2x16 in ")
    assert "decode 3 steps in " in out[0] and "tok/s" in out[0]
    assert out[1].startswith("[serve] sample continuation: [")


def test_serve_launcher_refuses_meshes_it_cannot_run():
    """A production mesh needs a group of its size: this process alone
    holds neither the 16x16 mesh nor the 2x16x16 one."""
    with pytest.raises(ValueError, match="256 ranks; the process group "
                                         "has 1"):
        serve.main(["--smoke", "--device", "cpu", "--mesh", "single"])
    with pytest.raises(ValueError, match="multi-pod mesh"):
        make_production_mesh(multi_pod=True)
    mesh = make_local_mesh()
    assert dict(mesh.shape) == {"data": 1, "model": 1}


def test_serve_launcher_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the launcher would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke", "--batch", "1", "--gen", "2"])
