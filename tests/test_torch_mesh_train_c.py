"""Split train steps of the ten smoke architectures on the 4 x 1 mesh (all
data: FSDP and the MoE's four dispatch groups) of four CPU rank processes
over gloo, against the one-rank port step and JAX's step (``moe_groups``
4 on both), at the tolerances of ``test_torch_mesh_train.py``.  The group
starts once for the module."""
import pytest

from test_torch_mesh_train import ARCH_IDS, check_train_step, split_results


@pytest.fixture(scope="module")
def results():
    return split_results((4, 1))[0]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_split_train_step_matches_one_rank_4x1(results, arch):
    check_train_step(results[arch], f"{arch} 4x1")
