"""The comparison that decides ``correct`` fails what it must: the control
(the reference in TF32 put in the program's place) and the faults a cell
can have, each planted under the timed path of a small run on the CPU,
which drives everything of a run but the look for a card.  A sound run of
the same cell comes out correct."""
from __future__ import annotations

import contextlib
import dataclasses
import io

import hb_small
import pytest
import torch
from hbench import faults


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return hb_small.make(tmp_path_factory.mktemp("hb"))


def _run(root, cell, **kw):
    with contextlib.redirect_stderr(io.StringIO()):
        return hb_small.run(root, cell, seconds=0.3, **kw)


def test_a_sound_run_is_correct_and_its_control_is_not(root):
    r = _run(root, "s-fit", control=True)
    assert r["correct"] is True
    assert r["control"]["correct"] is False


@pytest.mark.parametrize("fault", faults.FIT)
def test_a_fit_cell_fails_each_planted_fault(root, fault):
    with faults.planted("fit", fault):
        r = _run(root, "s-fit")
    assert r["correct"] is False
    assert any(c["value"] is None or c["value"] > c["limit"]
               for c in r["checks"].values())


def test_a_planted_fault_is_taken_out_again(root):
    from repro_torch.kernels import ops
    before = ops.fused_learn
    with faults.planted("fit", "half"):
        assert ops.fused_learn is not before
    assert ops.fused_learn is before
    assert _run(root, "s-fit")["correct"] is True


def test_the_reference_rounds_to_tf32_as_the_tensor_cores_do():
    from reference import bcpnn as ref
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.3e-7,
                      1.0 + 2 ** -10])
    r = ref.round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0  # a tie goes to even
    assert r[2] == 1.0 + 2 ** -9 and r[4] == 1.0 + 2 ** -10
    bits = r.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    assert abs(float(r[3]) + 3.3e-7) <= 3.3e-7 * 2 ** -11


def test_the_reference_step_is_the_papers_update():
    """One reference step by hand on a 2 x 2 -> 1 x 2 projection."""
    from reference import bcpnn as ref
    net = ref.Net(hi=2, mi=2, hj=1, mj=2, n_classes=2, alpha=0.5, eps=1e-4,
                  gain=1.0, support_noise=0.0, noise_steps=1)
    g = torch.Generator().manual_seed(0)
    st = ref.init_state(net, g)
    st = dataclasses.replace(st, hidden=dataclasses.replace(
        st.hidden, t=torch.tensor(4.0)))
    x = torch.tensor([[1.0, 0.0, 0.5, 0.5], [0.0, 1.0, 1.0, 0.0]])
    new = ref.unsupervised_step(st, net, x, None)
    s = st.hidden.b + x @ st.hidden.w
    y = torch.softmax(s, dim=-1)
    a = 0.5
    torch.testing.assert_close(new.hidden.pij,
                               (1 - a) * st.hidden.pij + a * x.T @ y / 2)
    torch.testing.assert_close(new.hidden.pj,
                               (1 - a) * st.hidden.pj + a * y.mean(0))
    assert float(new.hidden.t) == 5.0
