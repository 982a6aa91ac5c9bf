"""Decode on a cache split along its sequence: the JAX dry run's decode
rule (``launch/dryrun.py::rules_for``: ``cache_seq`` on the model axis and
``kv_heads`` whole, where the K/V heads do not divide the axis), which the
port's production decode cells take, run for real on four CPU rank
processes over gloo (``tests/torch_mesh_ranks.py``) on the 2 x 2 mesh:
prefill (B = 4, 16 tokens) and 4 greedy decode steps of six smoke
architectures (global and local attention, an MoE, the RG-LRU hybrid,
enc-dec cross-attention, vision patches) from JAX's seed-0 parameters,
against one rank and against JAX's jitted ``prefill`` and ``decode_step``
on the same parameters and tokens, the one-rank greedy tokens driving all
three.  Each step's logits within 1e-5 of the largest |logit| of the
one-rank step (fp32; the blocks' softmax statistics combine in another
order) and within 1e-4 of JAX's (``tests/test_torch_lm.py``'s tolerance),
the split's own greedy tokens equal, every cache leaf after the last step
within 1e-5 of the one-rank leaf's, and the K/V caches split along the
sequence (``attention._decode_seq_split``)."""
import numpy as np
import pytest

import torch_mesh_ranks as ranks
from repro_torch.distributed import run_group
from test_torch_mesh_serve import _jax_serve
from test_torch_mesh_train import jax_tree

ARCHS = ["qwen1.5-0.5b", "gemma2-2b", "qwen3-moe-30b-a3b",
         "recurrentgemma-2b", "whisper-tiny", "internvl2-26b"]
REL = 1e-5
JAX_TOL = 1e-4
SEQ_RULES = {"cache_seq": "model", "kv_heads": None}


@pytest.fixture(scope="module")
def results():
    jobs = [("serve", (2, 2), {"arch": a, "tree": jax_tree(a),
                               "gen": 4, "overrides": SEQ_RULES})
            for a in ARCHS]
    out = run_group(ranks.run, 4, backend="gloo", device="cpu",
                    args=(jobs,), timeout_s=600)[0]
    return dict(zip(ARCHS, out))


@pytest.mark.parametrize("arch", ARCHS)
def test_sequence_split_decode_matches_one_rank(results, arch):
    r = results[arch]
    want = _jax_serve(arch, r["tokens"][:-1])
    assert len(r["logits"]) == len(r["one_logits"]) == len(want) == 5
    for i, (a, b, w) in enumerate(zip(r["logits"], r["one_logits"], want)):
        assert a.shape == b.shape == w.shape, (arch, i)
        err, big = float(np.abs(a - b).max()), float(np.abs(b).max())
        assert err <= REL * big, (arch, i, err, big)
        err = float(np.abs(a - w).max())
        assert err <= JAX_TOL, (arch, i, "against JAX", err)
    for a, b in zip(r["split_tokens"], r["tokens"]):
        np.testing.assert_array_equal(a, b, err_msg=arch)
    assert r["pos"] == ranks.S + 4
    for path, err in r["cache"].items():
        assert err <= REL * max(1.0, err), (arch, path, err)
    kv = [k for k in r["split_seq"] if k.endswith(("/k", "/v"))]
    assert kv, (arch, r["split_seq"])
