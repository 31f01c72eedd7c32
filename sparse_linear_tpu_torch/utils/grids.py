"""Structured-grid model operators: 1D/2D/3D Laplacians (Poisson systems).

Counterpart of :mod:`sparse_linear_tpu.utils.grids`.  The generators build
directly in DIA and CSR with vectorized tensor code on ``device``, so the
2048**2 operator is made on the card without a host round trip.
"""

from __future__ import annotations

import torch

from sparse_linear_tpu_torch.dtypes import as_torch_dtype, index_dtype
from sparse_linear_tpu_torch.formats.base import compute_indptr
from sparse_linear_tpu_torch.formats.matrix import CSR
from sparse_linear_tpu_torch.formats.structured import DIA

__all__ = ["laplacian_1d", "poisson_2d", "poisson_3d"]


def _stencil_dia(n: int, offsets, boundary_masks, values, dtype,
                 device) -> DIA:
    """DIA from per-offset constant values with boundary masking; rows
    where i + off falls outside [0, n) hold 0."""
    dtype = as_torch_dtype(dtype)
    i = torch.arange(n, device=device)
    data = torch.zeros((len(offsets), n), dtype=dtype, device=device)
    for d, (off, mask, v) in enumerate(zip(offsets, boundary_masks, values)):
        ok = (i + off >= 0) & (i + off < n)
        if mask is not None:
            ok &= mask
        data[d].masked_fill_(ok, v)
    return DIA(data=data, shape=(n, n), offsets=tuple(offsets))


def _dia_to_csr(dia: DIA) -> CSR:
    """Exact DIA -> CSR conversion of the stored nonzeros."""
    n_r, n_c = dia.shape
    i = torch.arange(n_r, device=dia.data.device)
    rows_l, cols_l, vals_l = [], [], []
    for d, off in enumerate(dia.offsets):
        j = i + off
        ok = (j >= 0) & (j < n_c) & (dia.data[d] != 0)
        rows_l.append(i[ok])
        cols_l.append(j[ok])
        vals_l.append(dia.data[d][ok])
    rows = torch.cat(rows_l)
    cols = torch.cat(cols_l)
    _, order = torch.sort(rows * n_c + cols)
    return CSR(
        indptr=compute_indptr(rows, n_r),
        indices=cols[order].to(index_dtype),
        data=torch.cat(vals_l)[order],
        shape=dia.shape,
    )


def laplacian_1d(n: int, dtype=torch.float32, fmt: str = "csr", *,
                 device="cpu"):
    """Tridiagonal [-1, 2, -1] operator."""
    dia = _stencil_dia(n, (-1, 0, 1), (None, None, None), (-1.0, 2.0, -1.0),
                       dtype, device)
    return dia if fmt == "dia" else _dia_to_csr(dia)


def poisson_2d(nx: int, ny: int | None = None, dtype=torch.float32,
               fmt: str = "csr", *, device="cpu"):
    """5-point 2D Laplacian on an nx x ny grid (row-major ordering):
    diag 4, neighbors -1.  N = nx*ny unknowns."""
    ny = nx if ny is None else ny
    n = nx * ny
    ix = torch.arange(n, device=device) % nx
    # x-neighbors must not wrap across grid rows
    dia = _stencil_dia(
        n,
        offsets=(-nx, -1, 0, 1, nx),
        boundary_masks=(None, ix > 0, None, ix < nx - 1, None),
        values=(-1.0, -1.0, 4.0, -1.0, -1.0),
        dtype=dtype,
        device=device,
    )
    return dia if fmt == "dia" else _dia_to_csr(dia)


def poisson_3d(nx: int, ny: int | None = None, nz: int | None = None,
               dtype=torch.float32, fmt: str = "csr", *, device="cpu"):
    """7-point 3D Laplacian on an nx x ny x nz grid: diag 6, neighbors -1."""
    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    n = nx * ny * nz
    i = torch.arange(n, device=device)
    ix = i % nx
    iy = (i // nx) % ny
    dia = _stencil_dia(
        n,
        offsets=(-nx * ny, -nx, -1, 0, 1, nx, nx * ny),
        boundary_masks=(None, iy > 0, ix > 0, None, ix < nx - 1,
                        iy < ny - 1, None),
        values=(-1.0, -1.0, -1.0, 6.0, -1.0, -1.0, -1.0),
        dtype=dtype,
        device=device,
    )
    return dia if fmt == "dia" else _dia_to_csr(dia)
