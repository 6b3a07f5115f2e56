"""``tests/test_torch_train.py``'s three-step parity for the MoE and
hybrid smoke architectures (their ``repro`` steps compile the longest);
the tolerances are that file's."""

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from tests.test_torch_train import OTHER_ARCHS, check_three_steps


@pytest.mark.parametrize("arch", OTHER_ARCHS)
def test_three_steps_match_repro(arch):
    check_three_steps(arch)

