"""Hopper kernels for DIA SpMV: wrappers around ``csrc/dia_spmv.cu``.

Counterpart of :mod:`sparse_linear_tpu.kernels.spmv_pallas`.

* :func:`dia_spmv_kernel` (kernel A) replaces both TPU kernels behind
  ``dia_spmv_pallas``: the blocked-halo kernel (``_blocked_kernel``,
  ``_dia_spmv_blocked``) and the streaming kernel (``_stream_kernel``,
  ``_dia_spmv_streamed``).  One CUDA kernel takes any shape.
* :func:`dia_spmv_chain` (kernel B) replaces ``_chain_kernel`` /
  ``dia_spmv_chain``: y = (alpha A)^k x in one cooperative launch.
* :func:`dia_spmm_kernel` and :func:`dia_spmm_planes_kernel` (kernel A's
  multi-RHS form, ``dia_spmm_kernel<T, V, G, C>`` /
  ``dia_spmm_planes_kernel<T, TP>``) replace the XLA forms
  ``sparse_linear_tpu/kernels/spmv.py:45-90`` (``dia_spmm``,
  ``dia_spmm_planes``) that FEAST's banded route runs
  (``eig/real_pipeline.py:124-132``): Y = A X for X column-major (ncols, m)
  or plane-major (m, ncols).  What bounds it is bytes (the diagonals, X and
  Y once), with L2 serving X's re-reads.  A block stages its tile of rows'
  diagonals and per-diagonal row ranges in shared memory once; column-major,
  a group of lanes takes a row of X in 16-byte vectors (one value a lane
  where m * itemsize is not a multiple of 16 or X or Y is not 16-byte
  aligned), up to four chunks a lane (a thread takes two rows at one or
  two chunks, one row past that), all of a diagonal's loads in flight
  together; plane-major, a thread takes a row and up to four planes at
  once.  :func:`_dia_spmm_plan` picks the
  geometry from m, the item size, the pointers' alignment and the layout
  (never a fallback).  Every entry sums its diagonals in stored order from
  zero with one fma each, so every column is bitwise kernel A on it,
  whatever the geometry.

Kernel A and its multi-RHS form take float32, float64, complex64 and
complex128.  The result's dtype is ``torch.result_type(data, x)``, the JAX
forms' ``jnp.result_type``: complex if either operand is.  A complex
operator runs the complex kernel (x cast to the result's dtype; each term
one complex fma of four real ones, so columns stay bitwise kernel A).  A
real operator with a complex x needs no complex kernel: it runs the real
multi-RHS form on the real block ``torch.view_as_real(x)`` (a vector as an
(nc, 2) block, a column-major X as (nc, 2m)), one launch, and each of the
real and imaginary parts is bitwise the real kernel on it.  Kernel B
(the chain) is real only: no main path chains a complex operator.

A wrapper takes the plain PyTorch version (:func:`.spmv.dia_spmv`,
:func:`.spmv.dia_spmm`, :func:`.spmv.dia_spmm_planes`) only because its
tensors lie on the CPU.  On CUDA tensors it launches its kernel
on the current stream or raises; nothing falls back.  Each wrapper counts
its kernel launches in ``.launches`` (a plain int; set it to 0 to reset);
both multi-RHS wrappers count in ``dia_spmm_kernel.launches``.
"""

from __future__ import annotations

import torch

from sparse_linear_tpu_torch.kernels import _build
from sparse_linear_tpu_torch.kernels.spmv import (
    dia_spmm,
    dia_spmm_planes,
    dia_spmv,
)

__all__ = ["dia_spmv_kernel", "dia_spmv_chain", "dia_spmm_kernel",
           "dia_spmm_planes_kernel"]

# the kernels' element types and the suffix of their C entry points
_SUFFIX = {torch.float32: "f32", torch.float64: "f64",
           torch.complex64: "c64", torch.complex128: "c128"}


def _device_of(name, *tensors) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(
            f"{name}: operands on different devices "
            f"{sorted(str(d) for d in devices)}"
        )
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: runs on cpu or cuda tensors, not {device}")
    return device


def _check_data(name, dia) -> None:
    """``data`` must hold one row of nrows entries per offset: the kernels
    index it without bounds checks."""
    if tuple(dia.data.shape) != (len(dia.offsets), dia.shape[0]):
        raise ValueError(
            f"{name}: DIA data of shape {tuple(dia.data.shape)} does not "
            f"match {len(dia.offsets)} offsets x {dia.shape[0]} rows")


def _flat(name, dia, x):
    """``x`` as a 1-D vector of length ncols, and the row width to give the
    result back in when ``x`` came pre-tiled (2-D with ncols elements, as
    the JAX package's ``(n // 128, 128)`` layout), else None; ``data`` is
    checked with :func:`_check_data`."""
    nr, nc = dia.shape
    _check_data(name, dia)
    if x.ndim == 2 and x.numel() == nc:
        return x.reshape(-1), x.shape[1]
    if x.ndim != 1 or x.shape[0] != nc:
        raise ValueError(
            f"{name}: dimension mismatch {dia.shape} @ {tuple(x.shape)}")
    return x, None


def _check_dtype(name, dtype) -> None:
    """Raise ``TypeError`` for a dtype the kernels do not take."""
    if dtype not in _SUFFIX:
        raise TypeError(f"{name}: the CUDA kernel takes float32, float64, "
                        f"complex64 or complex128, not {dtype}")


def _entry(lib, name, stem, dtype):
    """The C entry point ``slt_<stem>_<type>`` of the kernel for
    ``dtype``."""
    _check_dtype(name, dtype)
    return getattr(lib, f"slt_{stem}_{_SUFFIX[dtype]}")


def _real_parts(x: torch.Tensor, kernel) -> torch.Tensor:
    """``kernel`` (a real multi-RHS product of a column-major (nc, k) block)
    on a complex x, (nc,) or column-major (nc, m), through the real block
    ``torch.view_as_real(x)``: (nc, 2) or (nc, 2m).  Each of the result's
    real and imaginary parts is bitwise the real kernel on that part."""
    m = x.shape[1] if x.ndim == 2 else 1
    xr = torch.view_as_real(_resolved(x))
    y = kernel(xr.reshape(x.shape[0], 2 * m))
    return torch.view_as_complex(y.reshape(y.shape[0], m, 2)).reshape(
        (y.shape[0],) + tuple(x.shape[1:]))


def _alpha(alpha) -> float:
    return 1.0 if alpha is None else float(alpha)


def _resolved(t: torch.Tensor) -> torch.Tensor:
    """``t`` as contiguous memory holding its values: a conjugated or
    negated view is resolved first (its ``data_ptr`` holds the values
    before the lazy conjugation or negation)."""
    return t.resolve_conj().resolve_neg().contiguous()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def dia_spmv_kernel(dia, x: torch.Tensor, alpha=None) -> torch.Tensor:
    """y = (alpha *) A @ x for DIA storage.

    Any shape (rectangular, unaligned, wide offsets).  ``data`` and ``x``
    are promoted to ``torch.result_type(data, x)`` first.  ``x`` may come
    pre-tiled as a 2-D tensor with ncols elements; y then comes back in
    rows of the same width.  ``alpha`` is fused into the store.
    """
    name = "dia_spmv_kernel"
    device = _device_of(name, dia.data, x)
    xf, width = _flat(name, dia, x)
    if device.type == "cpu":
        y = dia_spmv(dia, xf)
        if alpha is not None:
            y = y * alpha
    else:
        y = _launch_spmv(dia, xf, alpha, device)
    return y if width is None else y.reshape(-1, width)


def _launch_spmv(dia, x, alpha, device):
    nr, nc = dia.shape
    name = "dia_spmv_kernel"
    dtype = torch.result_type(dia.data, x)
    _check_dtype(name, dtype)
    if dtype.is_complex and not dia.data.dtype.is_complex:
        y = _real_parts(x.to(dtype), lambda xr: _launch_spmm(
            name, dia, xr, False, device))
        return y if alpha is None else y * _alpha(alpha)
    data = _resolved(dia.data.to(dtype))
    x = _resolved(x.to(dtype))
    y = torch.empty((nr,), dtype=dtype, device=device)
    if nr == 0:
        return y
    lib = _build.load_library()
    fn = _entry(lib, name, "dia_spmv", dtype)
    code = fn(data.data_ptr(), dia.offsets_tensor.data_ptr(), x.data_ptr(),
              y.data_ptr(), len(dia.offsets), nr, nc, _alpha(alpha),
              device.index, _stream(device))
    _build.check(lib, code, "dia_spmv_kernel launch")
    dia_spmv_kernel.launches += 1
    return y


dia_spmv_kernel.launches = 0


def dia_spmv_chain(dia, x: torch.Tensor, k: int, alpha=None) -> torch.Tensor:
    """y = (alpha A)^k @ x in ONE kernel launch (the iterative-method hot
    loop: power or Chebyshev iteration).

    A persistent cooperative grid runs the k steps with a grid-wide barrier
    between them and two ping-pong vectors.  ``x`` is cast to the data
    dtype and so is the result.  Square operators only; ``k >= 1``.  The
    JAX kernel's 1024-row alignment and 120 MB budget are VMEM limits and
    do not apply: any square size runs.  The CUDA kernel is real only
    (float32, float64): a complex operator or x on CUDA raises
    ``TypeError``.  The H100 has no 128 MB scratchpad
    for the operator, and its 50 MB L2 holds the 84 MB f32 2048**2 Poisson
    operator only in part.
    """
    nr, nc = dia.shape
    if nr != nc:
        raise ValueError("dia_spmv_chain: square shapes only")
    if k < 1:
        raise ValueError("dia_spmv_chain: k must be >= 1")
    name = "dia_spmv_chain"
    device = _device_of(name, dia.data, x)
    xf, width = _flat(name, dia, x)
    if device.type == "cpu":
        y = xf.to(dia.data.dtype)
        for _ in range(k):
            y = dia_spmv(dia, y)
            if alpha is not None:
                y = y * alpha
    else:
        y = _launch_chain(dia, xf, int(k), alpha, device)
    return y if width is None else y.reshape(-1, width)


def _launch_chain(dia, x, k, alpha, device):
    n = dia.shape[0]
    dtype = dia.data.dtype
    if dtype not in (torch.float32, torch.float64) or x.is_complex():
        raise TypeError(
            f"dia_spmv_chain: the CUDA kernel takes a float32 or float64 "
            f"operator and a real x, not {dtype} and {x.dtype} (the chain "
            f"has no complex form)")
    if k >= 2**31:
        raise ValueError("dia_spmv_chain: k must be < 2**31")
    data = _resolved(dia.data)
    x = _resolved(x.to(dtype))
    bufs = (torch.empty((n,), dtype=dtype, device=device),)
    bufs += (torch.empty_like(bufs[0]),) if k > 1 else bufs
    if n == 0:
        return bufs[0]
    lib = _build.load_library()
    fn = _entry(lib, "dia_spmv_chain", "dia_chain", dtype)
    code = fn(data.data_ptr(), dia.offsets_tensor.data_ptr(), x.data_ptr(),
              bufs[0].data_ptr(), bufs[1].data_ptr(), len(dia.offsets), n, k,
              _alpha(alpha), device.index, _stream(device))
    _build.check(lib, code, "dia_spmv_chain launch")
    dia_spmv_chain.launches += 1
    return bufs[(k - 1) % 2]


dia_spmv_chain.launches = 0


def dia_spmm_kernel(dia, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for DIA storage and a dense column-major X of shape
    (ncols, m); a 1-D x is :func:`dia_spmv_kernel`.

    ``data`` and X are promoted to ``torch.result_type(data, X)``.  A
    complex X on a real operator runs the real kernel on the (ncols, 2m)
    block ``torch.view_as_real(X)``."""
    name = "dia_spmm_kernel"
    if x.ndim == 1:
        return dia_spmv_kernel(dia, x)
    device = _device_of(name, dia.data, x)
    nr, nc = dia.shape
    if x.ndim != 2 or x.shape[0] != nc:
        raise ValueError(
            f"{name}: dimension mismatch {dia.shape} @ {tuple(x.shape)}")
    _check_data(name, dia)
    if device.type == "cpu":
        return dia_spmm(dia, x)
    return _launch_spmm(name, dia, x, False, device)


def dia_spmm_planes_kernel(dia, xp: torch.Tensor) -> torch.Tensor:
    """Plane-major Y = A @ X for DIA storage: ``xp`` of shape (m, ncols),
    one right-hand side a row, returns (m, nrows).  A complex X on a real
    operator runs the real kernel on the real and imaginary planes, (2m,
    ncols), one launch."""
    name = "dia_spmm_planes_kernel"
    device = _device_of(name, dia.data, xp)
    nr, nc = dia.shape
    if xp.ndim != 2 or xp.shape[1] != nc:
        raise ValueError(
            f"{name}: expected (m, {nc}) planes, got {tuple(xp.shape)}")
    _check_data(name, dia)
    if device.type == "cpu":
        return dia_spmm_planes(dia, xp)
    return _launch_spmm(name, dia, xp, True, device)


# The multi-RHS form's geometry (csrc/dia_spmv.cu).  Column-major: a group
# of lanes takes one row of X, at most _ROW_BYTES of it a chunk, and a lane
# holds at most _MAX_CHUNKS chunks before m is tiled.  Plane-major: one
# thread a row, at most _PLANES_A_PASS planes at a time.  On an NVIDIA H100
# 80GB HBM3 at 700.00 W (tools/torch_dia_spmm_probe.py, 1024**2 and
# 2048**2, m = 16, 80, 160) five chunks a lane ran slower than four at six
# of the eight shapes that take more than three, and 28-44 % slower at
# m = 160 in f64; four planes took 7-16 % less time than eight.
_ROW_BYTES = 128
_MAX_CHUNKS = 4
_PLANES_A_PASS = 4


def _dia_spmm_plan(m: int, itemsize: int, vector: bool,
                   planes: bool) -> tuple[int, int]:
    """(lanes a row, chunks a lane) of kernel A's multi-RHS form for ``m``
    right-hand sides; plane-major (1, planes a thread takes at once).
    ``vector``: X and Y can be read and written in 16-byte vectors (m *
    itemsize a multiple of 16, both 16-byte aligned); else one value a
    lane.  The lanes of a row are the fewest (a power of two) that cover m,
    up to one 128-byte run; past that a lane takes more chunks (vector
    lanes only, at most four), and past those the kernel tiles m.
    ``itemsize`` is 4, 8 (float64, complex64) or 16 (complex128, one value
    a 16-byte vector): a chunk holds 16 bytes a lane whatever the type, so
    its registers, and the cap, are the same for complex."""
    if planes:
        return 1, min(_PLANES_A_PASS, 1 << (m - 1).bit_length())
    per_lane = 16 // itemsize if vector else 1
    lanes_max = _ROW_BYTES // (per_lane * itemsize)
    units = -(-m // per_lane)
    if units <= lanes_max:
        return 1 << (units - 1).bit_length(), 1
    cap = _MAX_CHUNKS if vector else 1
    return lanes_max, min(-(-units // lanes_max), cap)


def _launch_spmm(name, dia, x, planes, device):
    nr, nc = dia.shape
    dtype = torch.result_type(dia.data, x)
    _check_dtype(name, dtype)
    if dtype.is_complex and not dia.data.dtype.is_complex:
        x = x.to(dtype).resolve_conj()
        if planes:
            m = x.shape[0]
            y = _launch_spmm(name, dia, torch.cat([x.real, x.imag]), True,
                             device)
            return torch.complex(y[:m], y[m:])
        return _real_parts(x, lambda xr: _launch_spmm(name, dia, xr, False,
                                                      device))
    m = x.shape[0] if planes else x.shape[1]
    if m >= 2**31:
        raise ValueError(f"{name}: m must be < 2**31")
    data = _resolved(dia.data.to(dtype))
    x = _resolved(x.to(dtype))
    y = torch.empty((m, nr) if planes else (nr, m), dtype=dtype,
                    device=device)
    if nr == 0 or m == 0:
        return y
    item = y.element_size()
    vector = (not planes and m * item % 16 == 0 and x.data_ptr() % 16 == 0
              and y.data_ptr() % 16 == 0)
    lanes, chunks = _dia_spmm_plan(m, item, vector, planes)
    lib = _build.load_library()
    fn = _entry(lib, name, "dia_spmm", dtype)
    code = fn(data.data_ptr(), dia.offsets_tensor.data_ptr(), x.data_ptr(),
              y.data_ptr(), len(dia.offsets), nr, nc, m, int(planes),
              int(vector), lanes, chunks, device.index, _stream(device))
    _build.check(lib, code, f"{name} launch")
    dia_spmm_kernel.launches += 1
    return y


dia_spmm_kernel.launches = 0
