"""Build and load the Hopper kernels in ``csrc/`` at first use.

``nvcc`` compiles every ``csrc/*.cu`` to an object, one process per source,
all started together, and links them into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds), for the H100's
``sm_90a`` target, into ``sparse_linear_tpu_torch/_build/``.  The library's
name carries a hash of the sources and the flags, so an edited source is
always rebuilt and a stale binary is never loaded (a modification-time check
can be fooled by a fresh checkout).  The library is loaded with ``ctypes``;
every pointer and the stream are passed as ``c_void_p``.

A missing ``nvcc`` or a failed build raises ``RuntimeError``: there is no
fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build_dir", "check", "find_nvcc", "library_path",
           "load_library", "sources"]

_PKG = Path(__file__).resolve().parent.parent
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_SPMV_ARGS = [_P, _P, _P, _P, _I64, _I64, _I64, ctypes.c_double,
              ctypes.c_int, _P]
_DIA_SPMM_ARGS = [_P, _P, _P, _P, _I64, _I64, _I64, _I64, ctypes.c_int,
                  ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]
_CHAIN_ARGS = [_P, _P, _P, _P, _P, _I64, _I64, ctypes.c_int,
               ctypes.c_double, ctypes.c_int, _P]
_WELL_SPMV_ARGS = [_P, _P, _P, _P, _P, _I64, ctypes.c_int, _P]
_WELL_SPMM_ARGS = [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]
_CG_PQ_ARGS = [_P, _P, _P, _I64, ctypes.c_int, ctypes.c_int, _P]
_CG_UPDATE_ARGS = [_P, _P, _P, _P, _P, _I64, ctypes.c_int, ctypes.c_int, _P]
_CG_DIRECTION_ARGS = [_P, _P, _P, _I64, ctypes.c_int, ctypes.c_int, _P]
_TYPES = ("f32", "f64", "c64", "c128")
_SIGNATURES = {
    **{f"slt_dia_spmv_{t}": _SPMV_ARGS for t in _TYPES},
    **{f"slt_dia_spmm_{t}": _DIA_SPMM_ARGS for t in _TYPES},
    "slt_dia_chain_f32": _CHAIN_ARGS,
    "slt_dia_chain_f64": _CHAIN_ARGS,
    **{f"slt_well_spmv_{t}": _WELL_SPMV_ARGS for t in _TYPES},
    **{f"slt_well_spmm_{t}": _WELL_SPMM_ARGS for t in _TYPES},
    **{f"slt_cg_pq_{t}": _CG_PQ_ARGS for t in _TYPES},
    **{f"slt_cg_update_{t}": _CG_UPDATE_ARGS for t in _TYPES},
    **{f"slt_cg_direction_{t}": _CG_DIRECTION_ARGS for t in _TYPES},
}


def build_dir() -> Path:
    return _PKG / "_build"


def sources() -> list[Path]:
    return sorted((_PKG / "csrc").glob("*.cu"))


def library_path(srcs=None, flags=NVCC_FLAGS) -> Path:
    """Where the library built from ``srcs`` with ``flags`` lives: the name
    carries a hash of both."""
    h = hashlib.sha256("\0".join(flags).encode())
    for src in sources() if srcs is None else srcs:
        h.update(Path(src).name.encode())
        h.update(Path(src).read_bytes())
    return build_dir() / f"libslt_kernels_{h.hexdigest()[:16]}.so"


def find_nvcc() -> str | None:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` or ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    return None


def _run(cmds) -> None:
    """Run the commands in parallel; raise with the output of the first
    that fails."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = None
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, out)
    if failed is not None:
        cmd, code, out = failed
        raise RuntimeError(f"nvcc failed ({code}): {' '.join(cmd)}\n{out}")


def _compile(out: Path) -> None:
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked on PATH, $CUDA_HOME/bin, "
            "/usr/local/cuda/bin): the CUDA toolkit is needed to build the "
            "sparse_linear_tpu_torch kernels"
        )
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [out.with_name(f"{tag}.{src.stem}.o") for src in sources()]
    tmp = out.with_name(f"{tag}.tmp.so")
    try:
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
              for obj, src in zip(objs, sources())])
        _run([[nvcc, *_ARCH, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    path = library_path()
    if not path.is_file():
        _compile(path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    lib.slt_error_string.argtypes = [ctypes.c_int]
    lib.slt_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a non-zero CUDA error code returned by a launch."""
    if code != 0:
        msg = lib.slt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
