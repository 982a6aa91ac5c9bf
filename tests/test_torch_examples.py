"""The port's examples (``repro_torch.examples``) on the CPU at a small size,
each through ``main([...,"--device", "cpu"])`` with the assertion its JAX
example makes: medical's accuracy floors (pneumonia above 0.8, breast above
0.7), quickstart's (above 0.85 at depth 1), structural plasticity's
captured MI not below where it started."""
import pytest
import torch

from repro_torch.examples import medical, quickstart, structural_plasticity


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers: one intra-op thread, so these
    full-width products do not slow the timing-sensitive tests beside
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_medical_example_passes_its_floors_at_a_small_size():
    """Models 2 and 3 at their full widths, on 300 training rows (4 whole
    batches of 64 and a 44-row tail) for one epoch, 104 test rows."""
    accs = medical.main(["--device", "cpu", "--train-rows", "300",
                         "--test-rows", "104", "--epochs-pneumonia", "1",
                         "--epochs-breast", "1"])
    assert set(accs) == set(medical.FLOORS)
    for name, acc in accs.items():
        assert acc > medical.FLOORS[name], (name, acc)


def test_quickstart_small_passes_its_floor():
    assert quickstart.main(["--small", "--device", "cpu"]) > 0.85


def test_quickstart_refuses_a_card_it_does_not_have(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.main(["--small"])


def test_structural_plasticity_keeps_its_captured_mi():
    """97 steps: snapshots at steps 0, 48 and 96, six rewires between."""
    curve = structural_plasticity.main(["--device", "cpu", "--steps", "97"])
    assert len(curve) == 3
    assert curve[-1] >= curve[0]
