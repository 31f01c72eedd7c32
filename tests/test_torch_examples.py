"""The port's walkthroughs (``examples/torch_*.py``) stay runnable: each
runs in a subprocess on the CPU (``--device cpu``), exits 0 and says which
device it ran on (subprocess smoke, as ``tests/test_examples.py`` runs the
JAX package's)."""

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("script", ["torch_poisson_direct.py",
                                    "torch_eigensolve.py",
                                    "torch_distributed.py",
                                    "torch_kernels_f64.py"])
@pytest.mark.slow
def test_torch_example_runs(script):
    out = subprocess.run(
        [sys.executable, os.path.join(_REPO, "examples", script),
         "--device", "cpu"],
        cwd=_REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.splitlines()[0].startswith("device: cpu"), out.stdout
