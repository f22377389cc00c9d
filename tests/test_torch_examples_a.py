"""Every port example (examples_torch/) doubles as an integration test,
as tests/test_examples.py runs the JAX package's: each runs as a script
with --device cpu, its own asserts deciding. The nine examples are
split over tests/test_torch_examples_{a,b,c}.py so that no one file
takes much more than a minute on one core; each subprocess runs on one
thread, beside the other test workers."""
import os
import pathlib
import subprocess
import sys

import pytest

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples_torch"


def run_example(script: str) -> None:
    subprocess.run([sys.executable, script, "--device", "cpu"],
                   cwd=EXAMPLES, check=True, timeout=540,
                   env={**os.environ, "OMP_NUM_THREADS": "1"})


@pytest.mark.parametrize("script", [
    "minimal_example_ocp.py",
    "minimal_example_closed_loop.py",
    "mocp_transition_example.py",
])
def test_example_runs(script):
    run_example(script)
