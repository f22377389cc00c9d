"""Port examples, second part (see tests/test_torch_examples_a.py)."""
import pytest

from test_torch_examples_a import run_example


@pytest.mark.parametrize("script", [
    "on_device_mpc_loop.py",
    "differentiable_mpc.py",
    "dae_constrained_ocp.py",
])
def test_example_runs(script):
    run_example(script)
