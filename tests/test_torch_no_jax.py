"""The port imports no JAX: every module of ``sparse_linear_tpu_torch``
imports in a fresh interpreter where ``import jax`` is made to fail."""

import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import sparse_linear_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert sys.modules["jax"] is None
assert not any(k.startswith(("jax.", "sparse_linear_tpu.")) for k in sys.modules)
print(len(names))
"""


def test_port_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 14


def test_port_sources_name_no_jax():
    for path in (ROOT / "sparse_linear_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            assert not (words[:1] in (["import"], ["from"])
                        and words[1].split(".")[0] == "jax"), (path, line)
