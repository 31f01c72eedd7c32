"""The port imports no JAX: every module of ``sparse_linear_tpu_torch``
imports in a fresh interpreter where ``import jax`` is made to fail.  Nor
does it load the JAX package's native library: its direct solver builds its
own host library from its own sources."""

import re
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
    assert int(proc.stdout.strip()) >= 44


def _port_sources():
    """The port's modules, its walkthroughs and its scale rehearsal."""
    yield from (ROOT / "sparse_linear_tpu_torch").rglob("*.py")
    yield from (ROOT / "examples").glob("torch_*.py")
    yield ROOT / "tools" / "torch_multichip_scale.py"


def test_port_sources_name_no_jax():
    paths = list(_port_sources())
    assert len([p for p in paths if p.parent.name == "examples"]) == 4
    for path in paths:
        for line in path.read_text().splitlines():
            words = line.split()
            assert not (words[:1] in (["import"], ["from"])
                        and words[1].split(".")[0] in (
                            "jax", "sparse_linear_tpu")), (path, line)


_MAPS_PROBE = """
import sys
sys.modules["jax"] = None
import torch
from sparse_linear_tpu_torch.solve import multifrontal as mf
from sparse_linear_tpu_torch.utils.grids import poisson_2d
a = poisson_2d(12, dtype=torch.float64, device="cpu")
for ordering in ("amd", "nd"):
    f = mf.factor(a, mf.analyze(a, ordering=ordering), kind="cholesky")
    assert float(mf.rcond(f)) > 0
print(open("/proc/self/maps").read())
"""


def test_direct_solver_maps_no_jax_package_library():
    """After AMD and general ND orderings and a factorization, the process
    maps the port's own host library and nothing under ``native/``."""
    if not Path("/proc/self/maps").exists():
        pytest.skip("needs /proc/self/maps (Linux)")
    proc = subprocess.run([sys.executable, "-c", _MAPS_PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    libs = {line.split()[-1] for line in proc.stdout.splitlines()
            if line.rstrip().endswith(".so") or ".so." in line}
    native = str(ROOT / "native") + "/"
    assert not [p for p in libs if p.startswith(native)]
    assert [p for p in libs if "/sparse_linear_tpu_torch/_build/libslt_host_"
            in p]


def test_port_sources_name_no_jax_native_library():
    # "native/", os.path.join(..., "native") or root / "native"
    pattern = re.compile(r"(?<![\w.])native/|join\([^)]*[\"']native[\"']"
                         r"|/\s*[\"']native[\"']|libslt_symbolic")
    for path in (ROOT / "sparse_linear_tpu_torch").rglob("*"):
        if path.suffix in (".py", ".cpp", ".cu", ".h", ".cuh"):
            for line in path.read_text().splitlines():
                assert not pattern.search(line), (path, line)
