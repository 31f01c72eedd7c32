"""SpMV / SpMM for WELL storage: wrappers around ``csrc/well_spmv.cu``.

Counterpart of :mod:`sparse_linear_tpu.kernels.spmv_well`, with the same
public names.

* :func:`well_spmv` (kernel C, ``well_spmv_kernel<T>``) replaces
  ``_kernel`` / ``_well_spmv_real`` and, in f64, the double-float
  ``_kernel_df64`` / ``_well_spmv_df64`` of ``spmv_well64``.
* :func:`well_spmm_planes` and :func:`well_spmm` (kernel D,
  ``well_spmm_kernel<T, V, G, C>``) replace the resident-X
  ``_spmm_kernel`` / ``_spmm_resident`` and the windowed
  ``_spmm_kernel_win`` / ``_spmm_windowed`` (one op with two memory plans
  on the TPU) and, in f64, ``_kernel_spmm_df64`` / ``_well_spmm_df64``.
  Kernel D reads X as (nc, m) row-major, the layout of the column-major
  ``well_spmm``, where the m values one slot gathers are contiguous;
  ``well_spmm_planes`` copies its (m, nc) planes to that layout first (on
  an NVIDIA H100 80GB HBM3 at 700.00 W, permuted 2048**2 operator, m = 16,
  the kernel gathering plane-major X took 4-7x as long as this layout
  plus the copy).  Y is written through strides in either layout.

  What bounds kernel D on that card is bytes: counted once (A's slots, X,
  Y) the permuted 2048**2 operator moves 1326 MB at m = 16 in f64 (0.396
  ms at 3.35 TB/s) and 5621 MB at m = 80 (1.678 ms); but on a numbering
  without locality every slot gathers its own run of X, so the floor is
  about 1.04 ms (m = 16) and 4.9 ms (m = 80).  One warp takes one
  32-row slice and stages its slots in shared memory once, so A is read
  from device memory once per call whatever m; its lanes lie across the
  right-hand sides, a group of them on one row, so each gather is one
  coalesced run of up to 128 bytes in 16-byte vectors; a plane-major Y is
  staged so that each plane's 32 rows go out as one run.
  :func:`_spmm_plan` picks the lanes a row and chunks a lane from m (a
  pure function of m, the item size, alignment and layout, never a
  fallback): the fewest lanes that cover m, so small m keeps every lane
  busy, and up to five chunks a lane (m = 80 in f64, 160 in f32; two
  plane-major) before it tiles m.  Each entry is summed over its row's
  slots in slot order from zero, as kernel C sums, so column t of
  ``well_spmm(a, X)`` is bitwise ``well_spmv(a, X[:, t])``.

Output dtype follows the JAX package: x is cast to the matrix's dtype, and
the result is complex when A or x is.  Both kernels take float32, float64,
complex64 and complex128.  A complex WELL runs the complex kernels (each
slot one complex fma of four real ones, so column t of kernel D stays
bitwise kernel C on column t).  A real WELL with a complex x needs no
complex kernel: it runs real kernel D on the real block
``torch.view_as_real(x)`` (a vector as an (nc, 2) block, a column-major X
as (nc, 2m), planes as their real and imaginary planes), one launch, and
each part is bitwise the real kernel on it (the JAX package runs the same
real plane passes, ``spmv_well.py:493-563``).  A wrapper takes the plain
PyTorch version (:func:`well_spmv_plain`, :func:`well_spmm_planes_plain`:
gather ``x[cols]``, multiply by ``vals``, ``index_add_`` by row) only
because its tensors lie on the CPU.  On CUDA tensors it launches its
kernel on the current stream or raises.  Kernel C's launches are counted
in ``well_spmv.launches`` and kernel D's in ``well_spmm.launches``,
whichever wrapper launched it (plain ints; set to 0 to reset).
"""

from __future__ import annotations

import numpy as np
import torch

from sparse_linear_tpu_torch.dtypes import complex_of
from sparse_linear_tpu_torch.formats.well import SLICE_ROWS
from sparse_linear_tpu_torch.kernels import _build
from sparse_linear_tpu_torch.kernels.spmv_dia import (
    _check_dtype,
    _device_of,
    _entry,
    _resolved,
    _real_parts,
    _stream,
)

__all__ = ["well_spmv", "well_spmm", "well_spmm_planes", "well_planes_width",
           "well_spmv_plain", "well_spmm_planes_plain"]


def _as_tensor(a, x):
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=a.vals.device)


def _out_dtype(a, x) -> torch.dtype:
    """The JAX package's rule: x takes A's dtype; complex if either is."""
    dtype = a.vals.dtype
    if x.is_complex() and not dtype.is_complex:
        return complex_of(dtype)
    return dtype


def _padded_rows(a) -> int:
    return a.n_slices * SLICE_ROWS


def well_spmv_plain(a, x: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel C: y = A @ x over the stored slots."""
    dtype = _out_dtype(a, x)
    prod = a.vals.to(dtype) * x.to(dtype)[a.cols]
    y = torch.zeros((_padded_rows(a),), dtype=dtype, device=x.device)
    return y.index_add_(0, a.slot_rows, prod)[: a.shape[0]]


def well_spmm_planes_plain(a, xp: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel D, plane-major: xp (m, nc) -> (m, nr)."""
    dtype = _out_dtype(a, xp)
    prod = a.vals.to(dtype)[None, :] * xp.to(dtype)[:, a.cols]
    y = torch.zeros((xp.shape[0], _padded_rows(a)), dtype=dtype,
                    device=xp.device)
    return y.index_add_(1, a.slot_rows, prod)[:, : a.shape[0]]


def _check_layout(name, a) -> None:
    """The kernels index ``slice_ptr``, ``cols``, ``vals`` and x without
    bounds checks: hold the arrays to the layout first."""
    n_slices = -(-a.shape[0] // SLICE_ROWS)
    if (a.slice_ptr.dtype != torch.int64 or a.cols.dtype != torch.int32
            or tuple(a.slice_ptr.shape) != (n_slices + 1,)
            or a.cols.ndim != 1 or a.cols.shape != a.vals.shape
            or not a.slots_in_bounds):
        raise ValueError(
            f"{name}: WELL arrays do not match the sliced layout of shape "
            f"{a.shape}: slice_ptr {a.slice_ptr.dtype} "
            f"{tuple(a.slice_ptr.shape)}, cols {a.cols.dtype} "
            f"{tuple(a.cols.shape)}, vals {tuple(a.vals.shape)}"
        )


def well_spmv(a, x) -> torch.Tensor:
    """y = A @ x for WELL storage."""
    x = _as_tensor(a, x)
    if x.ndim != 1 or x.shape[0] != a.shape[1]:
        raise ValueError(
            f"well_spmv: dimension mismatch {a.shape} @ {tuple(x.shape)}"
        )
    device = _device_of("well_spmv", a.vals, x)
    if device.type == "cpu":
        return well_spmv_plain(a, x)
    name = "well_spmv"
    dtype = _out_dtype(a, x)
    _check_dtype(name, dtype)
    _check_layout(name, a)
    if dtype.is_complex and not a.vals.is_complex():
        return _real_parts(x.to(dtype), lambda xr: _column_major(name, a, xr))
    nr = a.shape[0]
    x = _resolved(x.to(dtype))
    y = torch.empty((nr,), dtype=dtype, device=device)
    if nr == 0:
        return y
    vals = _resolved(a.vals)
    lib = _build.load_library()
    fn = _entry(lib, name, "well_spmv", dtype)
    code = fn(a.slice_ptr.contiguous().data_ptr(),
              a.cols.contiguous().data_ptr(), vals.data_ptr(), x.data_ptr(),
              y.data_ptr(), nr, device.index, _stream(device))
    _build.check(lib, code, "well_spmv launch")
    well_spmv.launches += 1
    return y


well_spmv.launches = 0


# Kernel D's geometry (csrc/well_spmv.cu): a group of lanes takes one row
# of X, at most _ROW_BYTES of it a chunk; a lane holds at most
# _MAX_CHUNKS chunks (plane-major _MAX_CHUNKS_PLANES, which bounds the
# shared-memory Y stage), and the rest of m is tiled.  A warp stages at
# most _MAX_STAGE_SLOTS slots a row of its slice at a time (kMaxStage).
# On an NVIDIA H100 80GB HBM3 at 700.00 W (permuted 2048**2 operator,
# chip_smoke.py phase 5) the fewest lanes that cover m ran 1.3-6.2x as
# fast as the widest group at every scalar m timed (1, 2, 3, 5, 13), and
# plane-major m = 80 in one pass ran within 0.5 % of the cap of two.
_ROW_BYTES = 128
_MAX_CHUNKS = 5
_MAX_CHUNKS_PLANES = 2
_MAX_STAGE_SLOTS = 32


def _spmm_plan(m: int, itemsize: int, vector: bool,
               planes: bool) -> tuple[int, int]:
    """(lanes a row, chunks a lane) of kernel D for ``m`` right-hand
    sides.  ``vector``: X (and a column-major Y) can be read in 16-byte
    vectors (m * itemsize a multiple of 16, X 16-byte aligned); else each
    lane takes one value.  The lanes of a row are the fewest
    (a power of two) that cover m, up to one 128-byte run; past that a
    lane takes more chunks (vector lanes only), and past those the kernel
    tiles m.  ``itemsize`` is 4, 8 (float64, complex64) or 16 (complex128,
    one value a 16-byte vector): a chunk holds 16 bytes a lane whatever the
    type, so its registers, and the caps, are the same for complex."""
    per_lane = 16 // itemsize if vector else 1
    lanes_max = _ROW_BYTES // (per_lane * itemsize)
    units = -(-m // per_lane)
    if units <= lanes_max:
        return 1 << (units - 1).bit_length(), 1
    cap = (_MAX_CHUNKS_PLANES if planes else _MAX_CHUNKS) if vector else 1
    return lanes_max, min(-(-units // lanes_max), cap)


def _stage_slots(a) -> int:
    """Slots a row that kernel D stages at a time: the mean slice width,
    so that a typical slice is staged in one round, at most
    _MAX_STAGE_SLOTS (longer rows take several rounds)."""
    mean = -(-int(a.cols.shape[0]) // max(a.n_slices * SLICE_ROWS, 1))
    return min(max(mean, 1), _MAX_STAGE_SLOTS)


def _launch_spmm(name, a, xt, y, y_row, y_rhs) -> None:
    """Kernel D on ``xt``, X as (nc, m), into ``y`` written through the
    strides (y_row, y_rhs) between rows of A and right-hand sides: y_row
    1 (plane-major) or y_rhs 1 (column-major).  X is copied to row-major
    first unless it already is."""
    _check_layout(name, a)
    nr, m = a.shape[0], xt.shape[1]
    if nr == 0 or m == 0:
        return
    xt = _resolved(xt)
    item = y.element_size()
    planes = y_row == 1
    vector = (m * item % 16 == 0 and xt.data_ptr() % 16 == 0
              and (planes or (y_rhs == 1 and y.data_ptr() % 16 == 0)))
    lanes, chunks = _spmm_plan(m, item, vector, planes)
    device = y.device
    vals = _resolved(a.vals)
    lib = _build.load_library()
    fn = _entry(lib, name, "well_spmm", y.dtype)
    code = fn(a.slice_ptr.contiguous().data_ptr(),
              a.cols.contiguous().data_ptr(), vals.data_ptr(), xt.data_ptr(),
              y.data_ptr(), nr, m, y_row, y_rhs, int(vector), lanes, chunks,
              _stage_slots(a), device.index, _stream(device))
    _build.check(lib, code, f"{name} launch")
    well_spmm.launches += 1


def _column_major(name, a, x) -> torch.Tensor:
    """Kernel D on a column-major X (nc, m), into a new Y (nr, m)."""
    y = torch.empty((a.shape[0], x.shape[1]), dtype=x.dtype, device=x.device)
    _launch_spmm(name, a, x, y, x.shape[1], 1)
    return y


def well_planes_width(a) -> int:
    """Plane width that :func:`well_spmm_planes` takes: ``a.shape[1]``.
    (The JAX package's kernel may want planes padded to its window plan;
    the port's kernel needs no padding, as the JAX function's fallback
    without a plan.)"""
    return int(a.shape[1])


def well_spmm_planes(a, xp) -> torch.Tensor:
    """Plane-major multi-RHS SpMM: ``xp`` of shape (m, nc), one RHS per
    ROW, returns (m, nr)."""
    xp = _as_tensor(a, xp)
    ok_width = xp.ndim == 2 and (
        xp.shape[1] == a.shape[1] or xp.shape[1] == well_planes_width(a)
    )
    if not ok_width:
        raise ValueError(
            f"well_spmm_planes: expected (m, {a.shape[1]}) planes (or the "
            f"pre-padded width well_planes_width(a)), got {tuple(xp.shape)}"
        )
    device = _device_of("well_spmm_planes", a.vals, xp)
    if device.type == "cpu":
        return well_spmm_planes_plain(a, xp)
    dtype = _out_dtype(a, xp)
    _check_dtype("well_spmm_planes", dtype)
    xp = xp.to(dtype)
    if dtype.is_complex and not a.vals.is_complex():
        xp = xp.resolve_conj()
        y = well_spmm_planes(a, torch.cat([xp.real, xp.imag]))
        return torch.complex(y[: xp.shape[0]], y[xp.shape[0]:])
    nr = a.shape[0]
    y = torch.empty((xp.shape[0], nr), dtype=dtype, device=device)
    _launch_spmm("well_spmm_planes", a, xp.T, y, 1, nr)
    return y


def well_spmm(a, x) -> torch.Tensor:
    """Y = A @ X for WELL storage, X dense (nc, m), column-major: the same
    op as :func:`well_spmm_planes` with the layout transposed on each
    side.  On CUDA this is kernel D's own layout: it reads X (nc, m) and
    writes Y (nr, m) with no transpose."""
    x = _as_tensor(a, x)
    if x.ndim == 1:
        return well_spmv(a, x)
    if x.ndim != 2 or x.shape[0] != a.shape[1]:
        raise ValueError(
            f"well_spmm: dimension mismatch {a.shape} @ {tuple(x.shape)}"
        )
    device = _device_of("well_spmm", a.vals, x)
    if device.type == "cpu":
        return well_spmm_planes_plain(a, x.T).T
    dtype = _out_dtype(a, x)
    _check_dtype("well_spmm", dtype)
    x = x.to(dtype)
    if dtype.is_complex and not a.vals.is_complex():
        return _real_parts(x, lambda xr: _column_major("well_spmm", a, xr))
    return _column_major("well_spmm", a, x)


well_spmm.launches = 0
