"""Split train steps of the ten smoke architectures on the 1 x 4 mesh (all
model: tensor and expert parallelism alone) of four CPU rank processes
over gloo, against the one-rank port step and JAX's step, at the
tolerances of ``test_torch_mesh_train.py`` (whose 2 x 2 cases these
complete; the 4 x 1 ones are in ``test_torch_mesh_train_c.py``).  The
group starts once for the module."""
import pytest

from test_torch_mesh_train import ARCH_IDS, check_train_step, split_results


@pytest.fixture(scope="module")
def results():
    return split_results((1, 4))[0]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_split_train_step_matches_one_rank_1x4(results, arch):
    check_train_step(results[arch], f"{arch} 1x4")
