"""The port's data-parallel steps, meshes, fault helpers, sharding records
and rank groups (counterpart of tests/test_distributed.py and the fault
cases of tests/test_train_dp.py).

A DP step on 2 or 3 rank processes (gloo groups on the CPU; the rank
bodies are tests/torch_dp_ranks.py, which imports no JAX) must equal the
port's single-device step bit for bit on every state array, clock and the
generator's state, for dense, patchy-held and compact-resident
projections and across a rewire.  Held against the JAX DP step on the
2-device mesh (conftest.py), with the JAX noise injected, at DESIGN.md
§3's tolerances: 1e-5 for traces, 1e-4 for weights and biases; masks,
tables and clocks exactly.  Each group runs once per module (fixtures);
the tests are cases over its results.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_ranks as R
from repro.core.hypercolumns import LayerGeom as JLayerGeom
from repro.core.network import init_deep as j_init_deep
from repro.core.network import make_network_spec as j_make_network_spec
from repro.distributed import make_data_parallel_unsupervised_step as j_dp
from repro.distributed import fault as jfault
from repro.distributed import sharding as jsharding
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import init_deep
from repro_torch.core.hypercolumns import LayerGeom
from repro_torch.core.network import (make_network_spec,
                                      supervised_readout_step,
                                      unsupervised_layer_step)
from repro_torch.distributed import (
    Mesh, RankDevice, RankFailed, describe_failure_domains, elastic_mesh,
    fit_mesh_shape, make_data_parallel_supervised_step,
    make_data_parallel_unsupervised_step, make_rules,
    order_devices_host_major, projection_shardings, rank_devices, run_group,
    sharding_context)
from repro_torch.launch.train_dp import snapshots_equal

B2, B3 = 16, 18  # batch rows: whole rows per rank on 2 and on 3 ranks
TRACE_TOL, W_TOL = 1e-5, 1e-4
KINDS = ["dense", "patchy", "compact"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # as every CPU rank runs
    yield
    torch.set_num_threads(n)


def _kw(kind):
    return {"dense": {}, "patchy": dict(nact=[4], patchy_traces=True),
            "compact": dict(nact=[4], patchy_traces=True,
                            compact=True)}[kind]


def _spec(kind, struct_every=0, depth=1, jax_spec=False):
    """The JAX test's network (Hj = 6: whole HCs on 2 and 3 ranks; depth
    2 dense only), in the port or in the JAX package."""
    layers = [(6, 8)] if depth == 1 else [(6, 8), (6, 4)]
    kw = dict(alpha=1e-2, support_noise=2.0, noise_steps=50,
              struct_every=struct_every, **_kw(kind))
    if jax_spec:
        return j_make_network_spec(JLayerGeom(12, 2), layers, n_classes=3,
                                   backend="jnp", **kw)
    return make_network_spec(LayerGeom(12, 2), layers, n_classes=3,
                             backend="torch", **kw)


def _rates(seed, n, b):
    return np.random.default_rng(seed).random((n, b, 24), dtype=np.float32)


def _labels(seed, n, b):
    return np.random.default_rng(seed).integers(0, 3, (n, b)).astype(
        np.int32)


def _single_unsup(spec, xs, layer=0):
    st = init_deep(spec, 0, "cpu")
    out = []
    for x in xs:
        st = unsupervised_layer_step(st, spec, torch.from_numpy(x), layer)
        out.append(R.tree(st))
    return out


def _single_sup(spec, xs, ys):
    st = init_deep(spec, 0, "cpu")
    out = []
    for x, y in zip(xs, ys):
        st = supervised_readout_step(st, spec, torch.from_numpy(x),
                                     torch.from_numpy(y))
        out.append(R.tree(st))
    return out


def _assert_ranks_equal_single(ranks, job, want, context):
    for r, res in enumerate(ranks):
        assert len(res[job]) == len(want)
        for i, (got, ref) in enumerate(zip(res[job], want)):
            assert snapshots_equal(got, ref), f"{context}: rank {r} step {i}"


# ---------------------------------------------------- JAX parity inputs --

def _jtree(st):
    def proj(p):
        return {"traces": {k: np.asarray(getattr(p.traces, k))
                           for k in ("pi", "pj", "pij", "t")},
                "w": np.asarray(p.w), "b": np.asarray(p.b),
                "mask": np.asarray(p.mask),
                "table": None if p.table is None else np.asarray(p.table)}
    return {"projs": [proj(p) for p in st.projs],
            "readout": proj(st.readout), "step": int(st.step)}


def _jax_dp_run(kind, xs):
    """The JAX DP step on the 2-device mesh from PRNGKey(0)'s state: the
    init tree, the noise each step drew, the tree after each step."""
    jspec = _spec(kind, jax_spec=True)
    state = j_init_deep(jspec, jax.random.PRNGKey(0))
    init = _jtree(state)
    step = j_dp(jspec, jax.make_mesh((2,), ("data",)), layer=0)
    noise, trees = [], []
    for x in xs:
        _, sub = jax.random.split(state.key)
        noise.append(np.asarray(jax.random.normal(
            sub, (x.shape[0], jspec.projs[0].post.N), jnp.float32)))
        state = step(state, jnp.asarray(x))
        trees.append(_jtree(state))
    return init, np.stack(noise), trees


PARITY_KINDS = ["dense", "compact"]


@pytest.fixture(scope="module")
def jax_runs():
    xs = _rates(11, 3, B2)
    return xs, {k: _jax_dp_run(k, xs) for k in PARITY_KINDS}


# ---------------------------------------------------------- the groups --

@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """A compact state saved at step 0, for the sharded restore."""
    d = str(tmp_path_factory.mktemp("sharded"))
    CheckpointManager(d).save(0, init_deep(_spec("compact"), 3, "cpu"),
                              blocking=True)
    return d


@pytest.fixture(scope="module")
def group2(jax_runs, ckpt_dir):
    xs_p, runs = jax_runs
    jobs = [("unsup_steps", dict(spec=_spec(k), xs=_rates(1, 4, B2)))
            for k in KINDS]
    jobs += [("unsup_steps", dict(spec=_spec(k, struct_every=2),
                                  xs=_rates(2, 5, B2)))
             for k in ("patchy", "compact")]
    jobs += [("sup_steps", dict(spec=_spec(k), xs=_rates(3, 3, B2),
                                ys=_labels(3, 3, B2)))
             for k in ("dense", "compact")]
    jobs += [("unsup_steps", dict(spec=_spec("dense", depth=2),
                                  xs=_rates(4, 2, B2), layer=1))]
    jobs += [("unsup_steps", dict(spec=_spec(k), xs=xs_p, init=runs[k][0],
                                  noise=runs[k][1]))
             for k in PARITY_KINDS]
    jobs += [("restore_sharded", dict(spec=_spec("compact"),
                                      ckpt_dir=ckpt_dir))]
    return run_group(R.run, 2, backend="gloo", device="cpu", args=(jobs,),
                     timeout_s=240)


@pytest.fixture(scope="module")
def group3():
    jobs = [("unsup_steps", dict(spec=_spec(k), xs=_rates(5, 3, B3)))
            for k in KINDS]
    jobs += [("sup_steps", dict(spec=_spec("dense"), xs=_rates(6, 2, B3),
                                ys=_labels(6, 2, B3)))]
    return run_group(R.run, 3, backend="gloo", device="cpu", args=(jobs,),
                     timeout_s=240)


# ------------------------------------------- DP steps vs single-device --

@pytest.mark.parametrize("i,kind", list(enumerate(KINDS)))
def test_dp_unsupervised_matches_single_device_bitwise(group2, i, kind):
    _assert_ranks_equal_single(group2, i,
                               _single_unsup(_spec(kind), _rates(1, 4, B2)),
                               kind)


@pytest.mark.parametrize("i,kind", [(3, "patchy"), (4, "compact")])
def test_dp_step_exact_across_rewire(group2, i, kind):
    """The struct_every rewire runs replicated after the learn: masks,
    tables and re-gathered traces stay bit-identical through it."""
    spec = _spec(kind, struct_every=2)
    want = _single_unsup(spec, _rates(2, 5, B2))
    _assert_ranks_equal_single(group2, i, want, kind)
    assert want[-1]["t_host"][0] >= 4  # crossed two rewires
    if kind == "patchy":  # (the compact rewire keeps its pre-HCs here)
        assert not np.array_equal(want[0]["state"]["projs"][0]["mask"],
                                  want[-1]["state"]["projs"][0]["mask"])


@pytest.mark.parametrize("i,kind", [(5, "dense"), (6, "compact")])
def test_dp_supervised_matches_single_device_bitwise(group2, i, kind):
    want = _single_sup(_spec(kind), _rates(3, 3, B2), _labels(3, 3, B2))
    _assert_ranks_equal_single(group2, i, want, kind)


def test_dp_step_on_an_upper_layer_matches_single_device(group2):
    """Layer 1 of a depth-2 stack: the frozen layer 0 runs as the
    column-sharded forward and a gather."""
    want = _single_unsup(_spec("dense", depth=2), _rates(4, 2, B2), layer=1)
    _assert_ranks_equal_single(group2, 7, want, "depth 2, layer 1")


@pytest.mark.parametrize("i,kind", [(8, "dense"), (9, "compact")])
def test_dp_step_against_the_jax_dp_step(group2, jax_runs, i, kind):
    """The port's DP step on 2 ranks against the JAX DP step on the
    2-device mesh, from the JAX init state with the JAX draws injected."""
    _, runs = jax_runs
    _, _, want = runs[kind]
    for r, res in enumerate(group2):
        for step, (got, ref) in enumerate(zip(res[i], want)):
            for l, (pg, pr) in enumerate(zip(
                    got["state"]["projs"] + [got["state"]["readout"]],
                    ref["projs"] + [ref["readout"]])):
                where = f"{kind} rank {r} step {step} proj {l}"
                for k in ("pi", "pj", "pij"):
                    np.testing.assert_allclose(
                        pg["traces"][k], pr["traces"][k], atol=TRACE_TOL,
                        rtol=0, err_msg=f"{where} {k}")
                assert pg["traces"]["t"] == int(pr["traces"]["t"]), where
                for k in ("w", "b"):
                    np.testing.assert_allclose(pg[k], pr[k], atol=W_TOL,
                                               rtol=0, err_msg=f"{where} {k}")
                np.testing.assert_array_equal(pg["mask"], pr["mask"])
                if pr["table"] is not None:
                    np.testing.assert_array_equal(pg["table"], pr["table"])
            assert got["state"]["step"] == ref["step"]


@pytest.mark.parametrize("i,kind", list(enumerate(KINDS)))
def test_dp_unsupervised_on_three_ranks(group3, i, kind):
    """Any shard count: Hj = 6 over 3 ranks, 6 rows each."""
    _assert_ranks_equal_single(group3, i,
                               _single_unsup(_spec(kind), _rates(5, 3, B3)),
                               f"{kind} on 3 ranks")


def test_dp_supervised_on_three_ranks(group3):
    want = _single_sup(_spec("dense"), _rates(6, 2, B3), _labels(6, 2, B3))
    _assert_ranks_equal_single(group3, 3, want, "readout on 3 ranks")


def test_sharded_restore_places_compact_leaves_as_dtensors(group2,
                                                           ckpt_dir):
    """restore(shardings=projection_shardings(...)) on a (data 1, model 2)
    mesh: compact (Hj, K, Mj) leaves and the table split along the post-HC
    axis as DTensors of half the HCs each; vectors replicate; the full
    values are the saved ones."""
    for res in group2:
        got = res[10]
        for name in ("projs/0/traces/pij", "projs/0/w", "projs/0/table"):
            placements, local, equal = got[name]
            assert placements == "(Replicate(), Shard(dim=0))", name
            assert local[0] == 3 and equal, (name, got[name])
        assert got["projs/0/b"] == ("None", (48,), True)


# ------------------------------------------------------------ refusals --

def _stub_mesh(n):
    """A mesh of n ranks in this process (no process group): enough for
    the checks that run before any collective."""
    return elastic_mesh((n,), ("data",), devices=rank_devices(n))


def test_dp_step_rejects_unshardable_geometry():
    spec = make_network_spec(LayerGeom(12, 2), [(5, 8)], n_classes=3,
                             backend="torch")  # 5 post-HCs on a 2-way axis
    with pytest.raises(ValueError, match="not divisible"):
        make_data_parallel_unsupervised_step(spec, _stub_mesh(2), layer=0)
    with pytest.raises(ValueError, match="not divisible"):
        make_data_parallel_supervised_step(spec, _stub_mesh(2))


def test_a_mesh_of_ranks_needs_a_process_group():
    with pytest.raises(RuntimeError, match="needs torch.distributed"):
        _stub_mesh(2).axis("data")
    ax = _stub_mesh(1).axis("data")  # one rank: the collectives are copies
    x = torch.arange(6.0).reshape(2, 3)
    assert ax.gather(x, dim=1) is x and ax.index == 0 and ax.n == 1
    with pytest.raises(NotImplementedError, match="item 10"):
        Mesh(np.array(rank_devices(2), dtype=object).reshape(1, 2),
             ("data", "model")).axis("data")


# ------------------------------------------------------ sharding records --

def _port_specs(sh):
    return [tuple(s.spec) for s in sh.values()]


def _jax_specs(sh):
    return [tuple(s.spec) for s in jax.tree.leaves(sh)]


def test_compact_projection_shardings_use_hj_axis():
    """Compact (Hj, K, Mj) leaves and the integer table shard along the
    post-HC axis, dense 2-D leaves keep the proj_pre rule: leaf for leaf
    the JAX function's specs on the same state."""
    jspec, spec = _spec("compact", jax_spec=True), _spec("compact")
    jstate = j_init_deep(jspec, jax.random.PRNGKey(0))
    state = convert.state_from_numpy(_jtree(jstate), spec, device="cpu")
    jmesh = jax.make_mesh((1, 2), ("data", "model"))
    mesh = Mesh(np.array(rank_devices(2), dtype=object).reshape(1, 2),
                ("data", "model"))
    with jsharding.sharding_context(jmesh, jsharding.make_rules(jmesh)):
        want = jsharding.projection_shardings(jstate)
    with sharding_context(mesh, make_rules(mesh)):
        got = projection_shardings(state)
    assert _port_specs(got) == _jax_specs(want)
    assert got["projs/0/traces/pij"].spec == ("model", None, None)
    assert got["projs/0/table"].spec == ("model", None)
    assert got["readout/w"].spec == ("model", None)


def test_projection_shardings_place_deep_state(tmp_path):
    """No context: None.  On a (1, 1) mesh the specs are the JAX
    function's, and a restore with them gives the saved state, leaves
    replicated on this rank's device."""
    from repro.configs.bcpnn_models import deep_synth_spec as j_deep
    from repro_torch.configs.bcpnn_models import deep_synth_spec
    kw = dict(side=4, depth=2, n_classes=3, hidden_hc=2, hidden_mc=8)
    jstate = j_init_deep(j_deep(backend="jnp", **kw), jax.random.PRNGKey(0))
    state = init_deep(deep_synth_spec(backend="torch", **kw), 0, "cpu")
    assert projection_shardings(state) is None
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    mesh = Mesh(np.array(rank_devices(1), dtype=object).reshape(1, 1),
                ("data", "model"))
    with jsharding.sharding_context(jmesh, jsharding.make_rules(jmesh)):
        want = jsharding.projection_shardings(jstate)
    with sharding_context(mesh, make_rules(mesh)):
        sh = projection_shardings(state)
    assert _port_specs(sh) == _jax_specs(want)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, state, blocking=True)
    got = mgr.restore(0, init_deep(deep_synth_spec(backend="torch", **kw),
                                   1, "cpu"), shardings=sh)
    assert snapshots_equal(R.tree(got), R.tree(state))


# ------------------------------------------------------------ fault.py --

class _StubDev:
    def __init__(self, pid, did):
        self.process_index, self.id = pid, did


def test_order_devices_host_major_matches_jax():
    devs = [_StubDev(1, 0), _StubDev(0, 3), _StubDev(1, 2), _StubDev(0, 1)]
    got = order_devices_host_major(devs)
    want = jfault.order_devices_host_major(devs)
    assert [(d.process_index, d.id) for d in got] == [
        (d.process_index, d.id) for d in want] == [(0, 1), (0, 3), (1, 0),
                                                   (1, 2)]
    ranks = rank_devices(4, per_host=2)
    assert order_devices_host_major(ranks[::-1]) == ranks
    assert [d.process_index for d in ranks] == [0, 0, 1, 1]


@pytest.mark.parametrize("shape,n", [((4,), 4), ((4,), 3), ((2, 4), 4),
                                     ((1, 8), 4), ((3, 2), 5), ((1,), 1)])
def test_fit_mesh_shape_matches_jax(shape, n):
    try:
        want = jfault.fit_mesh_shape(shape, n)
    except RuntimeError as e:
        with pytest.raises(RuntimeError, match="cannot build mesh"):
            fit_mesh_shape(shape, n)
        assert "cannot build mesh" in str(e)
        return
    assert fit_mesh_shape(shape, n) == want


def test_elastic_mesh_shrinks_and_reports_domains_as_jax():
    """The JAX test's cases, on the 2 devices of the JAX mesh and the 2
    ranks of a port world (given as devices: no process group here)."""
    two = rank_devices(2)
    for shape, names, k in (((4,), ("data",), 2), ((4,), ("data",), 1),
                            ((2, 2), ("data", "model"), 2)):
        jm = jfault.elastic_mesh(shape, names, devices=jax.devices()[:k])
        m = elastic_mesh(shape, names, devices=two[:k])
        assert dict(m.shape) == dict(jm.shape)
        assert describe_failure_domains(m) == \
            jfault.describe_failure_domains(jm)
    with pytest.raises(RuntimeError, match="cannot build mesh"):
        elastic_mesh((1, 4), ("data", "model"), devices=two)
    assert dict(elastic_mesh((4,), ("data",)).shape) == {"data": 1}
    assert elastic_mesh((4,), ("data",)).devices.flat[0] == RankDevice(0)


# ---------------------------------------------------------- rank groups --

def test_rank_group_reraises_and_stops_the_waiting_ranks():
    """Rank 1 raises while rank 0 waits in a barrier that never completes:
    the parent gets rank 1's ValueError (its traceback as the cause) long
    before the group's timeout, and no rank is left running."""
    import time
    t = time.monotonic()
    with pytest.raises(ValueError, match="on purpose") as info:
        run_group(R.fail_or_wait, 2, backend="gloo", device="cpu",
                  timeout_s=120)
    assert time.monotonic() - t < 60
    assert isinstance(info.value.__cause__, RankFailed)
    assert "rank 1 raised" in str(info.value.__cause__)


def test_rank_group_times_out():
    import time
    t = time.monotonic()
    with pytest.raises(TimeoutError, match="ranks \\[0\\] did not finish"):
        run_group(R.sleep, 1, backend="gloo", device="cpu", args=(600,),
                  timeout_s=3)
    assert time.monotonic() - t < 30


def test_rank_group_refuses_nccl_without_a_card_each():
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one"):
        run_group(R.sleep, 2, backend="nccl", device="cpu", args=(0,))
    with pytest.raises(ValueError, match="unknown backend"):
        run_group(R.sleep, 1, backend="mpi", device="cpu", args=(0,))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_group(R.sleep, 1, backend="gloo", device="cuda", args=(0,))
