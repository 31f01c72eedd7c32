"""BLAS-like sparse linear algebra over the interchange formats.

Counterpart of the ``spmv``/``axpy``/``spmm``/``scale`` part of
:mod:`sparse_linear_tpu.ops.linalg`: a gather of x by column and an
``index_add_`` by row.  On the card these are the independent CSR reference
that residual checks use beside the DIA kernels.  ``glin``/``lin``/``add``
are not ported yet (ROADMAP.md queue 1 item 6).

``index_add_`` on CUDA sums each row's products in an unspecified order, so
results agree with the JAX package to rounding (1e-12 relative in f64), not
bit for bit.
"""

from __future__ import annotations

import torch

from sparse_linear_tpu_torch.formats.matrix import COO, CSC, CSR

__all__ = ["spmv", "axpy", "spmm", "scale"]


def _valid_coords(mat):
    """(row_ids, col_ids, values) of the valid (non-padding) entries."""
    if isinstance(mat, COO):
        ok = (mat.row < mat.shape[0]) & (mat.col < mat.shape[1])
        if bool(ok.all()):
            return mat.row, mat.col, mat.data
        return mat.row[ok], mat.col[ok], mat.data[ok]
    n = mat.nnz
    if isinstance(mat, CSR):
        return mat.row_ids()[:n], mat.indices[:n], mat.data[:n]
    if isinstance(mat, CSC):
        return mat.indices[:n], mat.col_ids()[:n], mat.data[:n]
    raise TypeError(type(mat))


def spmv(mat, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a dense vector ``x`` (reference ``mulV``)."""
    nr, nc = mat.shape
    if x.shape[0] != nc:
        raise ValueError(
            f"spmv: dimension mismatch {mat.shape} @ {tuple(x.shape)}")
    rows, cols, vals = _valid_coords(mat)
    dtype = torch.result_type(vals, x)
    y = torch.zeros((nr,), dtype=dtype, device=x.device)
    return y.index_add_(0, rows, vals.to(dtype) * x[cols].to(dtype))


def axpy(mat, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y + A @ x (reference ``axpy``)."""
    return y + spmv(mat, x)


def spmm(mat, b: torch.Tensor) -> torch.Tensor:
    """A @ B for a dense B of shape (ncols, k) (reference ``mulM``)."""
    nr, nc = mat.shape
    if b.shape[0] != nc:
        raise ValueError(
            f"spmm: dimension mismatch {mat.shape} @ {tuple(b.shape)}")
    rows, cols, vals = _valid_coords(mat)
    dtype = torch.result_type(vals, b)
    y = torch.zeros((nr,) + tuple(b.shape[1:]), dtype=dtype, device=b.device)
    contrib = vals.to(dtype)[:, None] * b[cols].to(dtype)
    return y.index_add_(0, rows, contrib)


def scale(mat, alpha):
    """alpha * A elementwise (reference ``scale``)."""
    return mat.map_values(lambda v: v * alpha)
