"""The port's sharded steps in float32 on the CPU over gloo: the cases,
world sizes and references of tests/test_torch_sharded.py (float64 there),
to 1e-5 of the largest value."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_sharded import CONFIGS, WORLDS, check_case, run_cases  # noqa: E402


@pytest.fixture(scope="module")
def sharded32(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("sharded32"), "float32")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(CONFIGS))
def test_sharded_step_matches_jax_and_one_device_f32(sharded32, case, world):
    check_case(*sharded32, case, world, "float32")
