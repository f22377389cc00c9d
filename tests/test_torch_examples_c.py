"""Port examples, third part (see tests/test_torch_examples_a.py)."""
import pytest

from test_torch_examples_a import run_example


@pytest.mark.parametrize("script", [
    "batched_scenario_mpc.py",
    "batched_rti_phases.py",
    "minimal_example_mhe.py",
])
def test_example_runs(script):
    run_example(script)
