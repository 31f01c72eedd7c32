"""Build and load the port's host library: the symmetrized pattern, symbolic
analysis, AMD and ND.

Counterpart of :mod:`sparse_linear_tpu.utils.native`.  The port keeps its
own copy of the C++ sources in ``csrc/host/`` and builds them itself with
``g++ -O2 -shared -fPIC`` at first use into
``sparse_linear_tpu_torch/_build/libslt_host_<hash>.so``.  The name carries
a hash of the sources and the flags, so an edited source is always rebuilt
and a stale binary is never loaded.  The library is loaded with ``ctypes``.

The functions keep the JAX package's signatures, but a missing ``g++`` or a
failed build raises ``RuntimeError``: there is no silent fall-back to the
Python engine (``solve/symbolic_py.py``), which at 1M dof would turn
seconds into hours.  That engine runs only when asked for
(``multifrontal.analyze(..., engine="python")``).

This is separate from ``kernels/_build.py``, which builds the CUDA kernels
in ``csrc/*.cu`` with nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["GXX_FLAGS", "library_path", "load", "native_amd", "native_nd",
           "native_symbolic", "native_symmetrize", "sources"]

_PKG = Path(__file__).resolve().parent.parent
GXX_FLAGS = ("-O2", "-shared", "-fPIC")


def sources() -> list[Path]:
    return sorted((_PKG / "csrc" / "host").glob("*.cpp"))


def library_path() -> Path:
    """Where the library lives: its name carries a hash of the sources and
    the flags."""
    h = hashlib.sha256("\0".join(GXX_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _PKG / "_build" / f"libslt_host_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(
            "g++ not found on PATH: a C++ compiler is needed to build the "
            "sparse_linear_tpu_torch host library (symbolic analysis, AMD, "
            "nested dissection)")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [gxx, *GXX_FLAGS, *map(str, sources()), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and load the host library, once per process."""
    path = library_path()
    if not path.is_file():
        _compile(path)
    lib = ctypes.CDLL(str(path))
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.slt_symmetrize.restype = ctypes.c_int64
    lib.slt_symmetrize.argtypes = [ctypes.c_int, i64p, i32p, i32p, i64p,
                                   i32p]
    lib.slt_analyze.restype = ctypes.c_void_p
    lib.slt_analyze.argtypes = [ctypes.c_int, i32p, i32p, ctypes.c_int,
                                ctypes.c_double]
    lib.slt_sizes.restype = None
    lib.slt_sizes.argtypes = [ctypes.c_void_p, i64p]
    lib.slt_arrays.restype = None
    lib.slt_arrays.argtypes = [ctypes.c_void_p, i32p, i32p, i32p, i32p, i32p]
    lib.slt_free.restype = None
    lib.slt_free.argtypes = [ctypes.c_void_p]
    lib.slt_amd.restype = ctypes.c_int
    lib.slt_amd.argtypes = [ctypes.c_int, i64p, i32p, i32p]
    lib.slt_nd.restype = ctypes.c_int
    lib.slt_nd.argtypes = [ctypes.c_int, i64p, i32p, ctypes.c_int, i32p]
    return lib


def native_symmetrize(n, indptr, indices, perm):
    """The pattern of P (A + A^T + I) P^T as canonical CSR ``(indptr int64,
    indices int32)``, P sending node ``perm[k]`` to ``k``: each row's
    columns sorted and unique, its diagonal present.  ``indptr`` and
    ``indices`` are A's CSR pattern."""
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    perm = np.ascontiguousarray(perm, dtype=np.int32)
    n = int(n)
    if indptr.shape != (n + 1,) or perm.shape != (n,):
        raise ValueError(f"native_symmetrize: indptr must have shape "
                         f"({n + 1},) and perm ({n},)")
    if (indptr[0] != 0 or indices.shape[0] != indptr[-1]
            or np.any(np.diff(indptr) < 0)):
        raise ValueError("native_symmetrize: indptr must rise from 0 to "
                         "the number of indices")
    out_indptr = np.empty(n + 1, dtype=np.int64)
    out_indices = np.empty(2 * int(indptr[-1]) + n, dtype=np.int32)
    nnz = load().slt_symmetrize(n, indptr, indices, perm, out_indptr,
                                out_indices)
    if nnz < 0:
        raise ValueError("native_symmetrize: perm is not a permutation of "
                         f"range({n}) or an index lies outside it")
    return out_indptr, out_indices[:nnz]


def native_amd(n, indptr, indices):
    """Approximate-minimum-degree permutation (int32)."""
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    perm = np.zeros(int(n), dtype=np.int32)
    if load().slt_amd(int(n), indptr, indices, perm):
        raise RuntimeError("native AMD ordering failed")
    return perm


def native_nd(n, indptr, indices, leaf=64):
    """General-graph nested-dissection permutation (int32): George-Liu
    level-set bisection with AMD-ordered leaves."""
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    perm = np.zeros(int(n), dtype=np.int32)
    if load().slt_nd(int(n), indptr, indices, int(leaf), perm):
        raise RuntimeError("native nested-dissection ordering failed")
    return perm


def native_symbolic(n, indptr, indices, relax_small=16, relax_frac=0.25):
    """The native symbolic analysis as a dict of numpy arrays (the contract
    of ``solve.symbolic_py.python_symbolic``)."""
    lib = load()
    indptr = np.ascontiguousarray(indptr, dtype=np.int32)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    h = lib.slt_analyze(int(n), indptr, indices, int(relax_small),
                        float(relax_frac))
    try:
        sizes = np.zeros(6, dtype=np.int64)
        lib.slt_sizes(h, sizes)
        nsuper, rows_total = int(sizes[0]), int(sizes[1])
        sup_start = np.zeros(nsuper + 1, dtype=np.int32)
        sup_parent = np.zeros(nsuper, dtype=np.int32)
        sup_level = np.zeros(nsuper, dtype=np.int32)
        rows_ptr = np.zeros(nsuper + 1, dtype=np.int32)
        rows = np.zeros(rows_total, dtype=np.int32)
        lib.slt_arrays(h, sup_start, sup_parent, sup_level, rows_ptr, rows)
        return {
            "nsuper": nsuper,
            "sup_start": sup_start,
            "sup_parent": sup_parent,
            "sup_level": sup_level,
            "rows_ptr": rows_ptr,
            "rows": rows,
            "lnnz": int(sizes[2]),
            "height": int(sizes[3]),
            "max_front": int(sizes[4]),
            "max_pivots": int(sizes[5]),
        }
    finally:
        lib.slt_free(h)
