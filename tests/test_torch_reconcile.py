"""Replica reconciliation of the port (``repro_torch.serve.reconcile``), on
the CPU at small sizes: the six cases of ``tests/test_reconcile.py`` on port
``DeepState``s, and the merge, the bitwise comparison, the divergence
report and the finiteness probe against the JAX functions on the same
numpy states, with ``-0.0`` elements and a NaN payload among the leaves.

Tolerances: none — everything here compares bit for bit (the merge is
the reference's arithmetic, leaf for leaf; the reports name the same
leaves in the same words).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.bcpnn_models import deep_synth_spec as j_deep_synth_spec
from repro.core import init_deep as j_init_deep
from repro.serve import merge_replica_states as j_merge
from repro.serve import state_divergence as j_divergence
from repro.serve import state_finite as j_finite
from repro.serve import states_bitwise_equal as j_equal
from repro_torch import convert
from repro_torch.checkpoint.ckpt import key_seed
from repro_torch.configs.bcpnn_models import deep_synth_spec
from repro_torch.core import init_deep, supervised_readout_step
from repro_torch.serve import (
    BCPNNService, chunk_bounds, cycle_batch, merge_replica_states,
    state_divergence, state_finite, states_bitwise_equal,
)
from repro_torch.serve.reconcile import _named_leaves, copy_state

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # local runs without the optional dep; CI has it
    given = None

KW = dict(side=6, n_classes=3, hidden_hc=4, hidden_mc=8)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _spec(depth=1):
    return deep_synth_spec(depth=depth, backend="cuda", **KW)


def _net(seed=0, depth=1):
    spec = _spec(depth)
    return spec, init_deep(spec, seed, "cpu")


def _stream(spec, n, seed):
    rng = np.random.default_rng(seed)
    xs = rng.random((n, spec.input_geom.N)).astype(np.float32)
    ys = rng.integers(0, spec.n_classes, size=n).astype(np.int32)
    return xs, ys


FEEDBACK_BATCH = 4


def _replay(state, spec, xs, ys):
    """The engine's feedback_eager=False fold compositions: full batches
    in stream order, one cycled tail."""
    items = list(zip(xs, ys))
    while items:
        chunk, items = items[:FEEDBACK_BATCH], items[FEEDBACK_BATCH:]
        x, y = cycle_batch(chunk, FEEDBACK_BATCH)
        state = supervised_readout_step(state, spec, torch.from_numpy(x),
                                        torch.from_numpy(y))
    return state


def _with_leaf(state, name, fn):
    """A copy of ``state`` whose leaf ``name`` (a checkpoint name) is
    ``fn`` of a clone of it."""
    out = copy_state(state)
    obj = out
    parts = name.split("/")
    for p in parts[:-1]:
        obj = obj[int(p)] if p.isdigit() else getattr(obj, p)
    setattr(obj, parts[-1], fn(getattr(obj, parts[-1]).clone()))
    return out


# ------------------------------------------------------------ chunking --

def test_chunk_bounds_cover_range_disjointly():
    for n, k in [(0, 1), (1, 1), (7, 3), (8, 2), (3, 5), (10, 10),
                 (1, 4), (100, 7)]:
        bounds = chunk_bounds(n, k)
        assert len(bounds) == k
        assert bounds[0][0] == 0 and bounds[-1][1] == n
        for (a0, b0), (a1, b1) in zip(bounds, bounds[1:]):
            assert b0 == a1 and a0 <= b0  # contiguous, non-overlapping
        sizes = [b - a for a, b in bounds]
        assert sizes == sorted(sizes, reverse=True)
        assert sum(sizes) == n
    with pytest.raises(ValueError, match="k >= 1"):
        chunk_bounds(4, 0)


# --------------------------------------------------------------- merge --

def test_merge_of_agreeing_replicas_is_bit_identical():
    spec, state0 = _net()
    xs, ys = _stream(spec, 11, seed=1)
    s = _replay(state0, spec, xs, ys)
    for k in (1, 2, 3, 4):
        merged = merge_replica_states([copy_state(s) for _ in range(k)])
        assert states_bitwise_equal(merged, s)
        assert state_divergence(merged, s) == []
        assert merged.device.type == "cpu"
        assert merged.generator is not s.generator
        assert torch.equal(merged.generator.get_state(),
                           s.generator.get_state())


def test_merge_exposes_a_diverged_replica():
    """If replicas disagree, the merged state cannot equal all of them —
    the detection contract reconcile() rests on."""
    spec, state0 = _net()
    xs, ys = _stream(spec, 8, seed=2)
    a = _replay(state0, spec, xs, ys)
    b = state0  # a stale replica
    merged = merge_replica_states([a, b])
    assert not (states_bitwise_equal(merged, a)
                and states_bitwise_equal(merged, b))
    div = state_divergence(a, b)
    assert div and any("byte" in d for d in div)


def test_merge_rejects_incongruent_states():
    with pytest.raises(ValueError, match="at least|>= 1"):
        merge_replica_states([])
    _, one = _net(depth=1)
    _, two = _net(depth=2)
    with pytest.raises(ValueError, match="congruent"):
        merge_replica_states([two, one])
    assert state_divergence(two, one) == ["leaf count differs: 23 vs 16"]


def test_bitwise_equal_uses_bit_patterns_not_ieee():
    _, s = _net()

    def put(v):
        return lambda t: t.view(-1).index_fill_(0, torch.tensor([0]), v) \
            .view(t.shape)

    nan = _with_leaf(s, "projs/0/traces/pi", put(float("nan")))
    assert states_bitwise_equal(nan, copy_state(nan))
    two = _with_leaf(nan, "projs/0/traces/pi",
                     lambda t: t.view(-1).index_fill_(
                         0, torch.tensor([1]), 2.0).view(t.shape))
    assert not states_bitwise_equal(nan, two)
    wide = _with_leaf(s, "projs/0/w", lambda t: t.double())
    assert not states_bitwise_equal(s, wide)
    neg = _with_leaf(s, "readout/b", put(-0.0))
    pos = _with_leaf(s, "readout/b", put(0.0))
    assert not states_bitwise_equal(neg, pos)  # -0.0 == 0.0 under IEEE
    assert not state_finite(nan)
    assert state_finite(s)  # float leaves beside int32 t, step, key


# ------------------------------------- broadcast-replica protocol (live) --

def test_merged_broadcast_replicas_match_single_engine_bitwise():
    """Two replica engines fed the same broadcast stream, merged, equal
    the ONE engine serving the interleaved stream — all with
    feedback_eager=False, all bit-exact."""
    spec, state0 = _net()
    xs, ys = _stream(spec, 14, seed=3)  # 3 full batches + cycled tail 2
    engines = [BCPNNService(copy_state(state0), spec, online_learning=True,
                            feedback_batch=FEEDBACK_BATCH,
                            feedback_eager=False).start(warmup=False)
               for _ in range(3)]  # replica A, replica B, reference
    for svc in engines:
        for x, y in zip(xs, ys):
            svc.feedback(x, int(y))
    for svc in engines:
        svc.stop()  # drains: folds every buffered batch incl. the tail
    rep_a, rep_b, ref = (svc.state for svc in engines)
    merged = merge_replica_states([rep_a, rep_b])
    assert states_bitwise_equal(merged, ref), state_divergence(merged, ref)
    assert not states_bitwise_equal(ref, state0)  # it actually learned


# ------------------------------------------------ hypothesis property --

if given is not None:
    @settings(deadline=None, max_examples=12)
    @given(n=st.integers(1, 25), k=st.integers(1, 4),
           seed=st.integers(0, 2 ** 16 - 1))
    def test_merge_bit_identical_to_interleaved_serve_property(n, k, seed):
        """For ANY feedback stream, replicas produced by the broadcast
        protocol merge bit-identically to the single-engine serve of the
        interleaved stream; replicas are replayed independently."""
        spec, state0 = _net()
        xs, ys = _stream(spec, n, seed)
        ref = _replay(state0, spec, xs, ys)
        replicas = [_replay(copy_state(state0), spec, xs, ys)
                    for _ in range(k)]
        merged = merge_replica_states(replicas)
        assert states_bitwise_equal(merged, ref), \
            state_divergence(merged, ref)
else:  # pragma: no cover - exercised only without hypothesis installed
    @pytest.mark.skip(reason="optional dep: property test needs hypothesis")
    def test_merge_bit_identical_to_interleaved_serve_property():
        pass


# ------------------------------------------------- parity with the JAX --

def _jax_state(depth=1, seed=0):
    jspec = j_deep_synth_spec(depth=depth, backend="jnp", **KW)
    return j_init_deep(jspec, jax.random.PRNGKey(seed))


def _port_of(jst, depth=1):
    """The port state of a JAX state's arrays, its generator seeded so that
    its ``key`` leaf is the JAX key."""
    def proj(p):
        return {"traces": {k: np.asarray(getattr(p.traces, k))
                           for k in ("pi", "pj", "pij", "t")},
                "w": np.asarray(p.w), "b": np.asarray(p.b),
                "mask": np.asarray(p.mask),
                "table": None if p.table is None else np.asarray(p.table)}

    tree = {"projs": [proj(p) for p in jst.projs],
            "readout": proj(jst.readout), "step": int(jst.step)}
    return convert.state_from_numpy(tree, _spec(depth), "cpu",
                                    seed=key_seed(np.asarray(jst.key)))


def _jax_edit(jst, path, fn):
    """A JAX state whose leaf at ``path`` (a keystr) is ``fn`` of a numpy
    copy of it."""
    def edit(kp, leaf):
        if jax.tree_util.keystr(kp) != path:
            return leaf
        return jnp.asarray(fn(np.array(leaf)))
    return jax.tree_util.tree_map_with_path(edit, jst)


def _bits(a, i, bits):
    a.reshape(-1).view(np.uint32)[i] = bits
    return a


NEG_ZERO, NAN_PAYLOAD = 0x80000000, 0x7FC00123


def _replica_sets():
    """Pairs of JAX replica states (same key) with a -0.0 element in
    every replica, a NaN with a payload in the first, and one diverged
    weight, each with the port states of the same arrays."""
    base = _jax_state()
    neg = _jax_edit(base, ".readout.b", lambda a: _bits(a, 1, NEG_ZERO))
    nan = _jax_edit(neg, ".projs[0].traces.pij",
                    lambda a: _bits(a, 5, NAN_PAYLOAD))
    moved = _jax_edit(neg, ".projs[0].w", lambda a: a + np.float32(1e-3))
    late = dataclasses.replace(neg, step=neg.step + 1)
    sets = {"agree": [neg, neg, neg], "nan": [nan, nan], "nan-vs-not":
            [nan, neg], "diverged": [neg, moved, neg], "step": [late, neg]}
    return {k: (v, [_port_of(s) for s in v]) for k, v in sets.items()}


@pytest.mark.parametrize("case", ["agree", "nan", "nan-vs-not", "diverged",
                                  "step"])
def test_merge_equals_the_jax_merge_bitwise(case):
    jstates, tstates = _replica_sets()[case]
    want = jax.tree_util.tree_leaves(j_merge(jstates))
    names, got = _named_leaves(merge_replica_states(tstates))
    assert len(got) == len(want) == 16
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name
    b = got[names.index("readout/b")]
    assert b.view(np.uint32)[1] == 0  # -0.0 + 0.0 is +0.0, in both


@pytest.mark.parametrize("case", ["agree", "nan", "nan-vs-not", "diverged",
                                  "step"])
def test_reports_equal_the_jax_reports(case):
    """``states_bitwise_equal``, ``state_divergence`` (leaf names and
    byte counts) and ``state_finite`` of every pair give what the JAX
    functions give on the same arrays."""
    jstates, tstates = _replica_sets()[case]
    for i in range(len(jstates)):
        for j in range(len(jstates)):
            assert states_bitwise_equal(tstates[i], tstates[j]) == \
                j_equal(jstates[i], jstates[j])
            assert state_divergence(tstates[i], tstates[j]) == \
                j_divergence(jstates[i], jstates[j])
        assert state_finite(tstates[i]) == j_finite(jstates[i])
    if case == "diverged":
        div = state_divergence(tstates[0], tstates[1])
        assert len(div) == 1 and div[0].startswith(".projs[0].w: ")
