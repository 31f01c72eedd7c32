"""BLAS-like sparse linear algebra over the interchange formats.

Counterpart of :mod:`sparse_linear_tpu.ops.linalg`.  ``spmv``/``spmm`` are a
gather of x by column and an ``index_add_`` by row; on the card they are the
independent CSR reference that residual checks use beside the DIA kernels.
``glin``/``lin``/``add`` are the reference's union merge (``glin``,
Matrix/Sparse.hs:401-431) as one sort of the (row, col) keys of both
operands: ``torch.unique`` finds the union pattern, and each slot folds its
A and B values as the reference's workspace does; ``elementwise_mul`` is the
same merge with the reference's union-fold product.

``index_add_`` on CUDA sums each row's products in an unspecified order, so
results agree with the JAX package to rounding (1e-12 relative in f64), not
bit for bit.
"""

from __future__ import annotations

import torch

from sparse_linear_tpu_torch.dtypes import index_dtype
from sparse_linear_tpu_torch.formats.base import compute_indptr
from sparse_linear_tpu_torch.formats.matrix import COO, CSC, CSR

__all__ = ["spmv", "axpy", "spmm", "scale", "glin", "lin", "add",
           "elementwise_mul"]


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


def glin(c0, add_a, mat_a, add_b, mat_b):
    """Generalized elementwise combine over the union pattern with the
    reference's fold semantics (``glin``, Matrix/Sparse.hs:401-424): a
    workspace initialized to ``c0``; where A has an entry,
    ``c := add_a(c, a)``; then where B has an entry, ``c := add_b(c, b)``.

    Every position that either operand stores stays in the pattern, even
    where the fold gives zero.  Returns an exact-size canonical CSR on the
    operands' device."""
    if mat_a.shape != mat_b.shape:
        raise ValueError(f"glin: shape mismatch {mat_a.shape} vs {mat_b.shape}")
    nr, nc = mat_a.shape
    ra, ca, va = _valid_coords(mat_a)
    rb, cb, vb = _valid_coords(mat_b)
    dtype = torch.result_type(va, vb)
    key = torch.cat([ra.to(torch.int64) * nc + ca.to(torch.int64),
                     rb.to(torch.int64) * nc + cb.to(torch.int64)])
    ukey, slot = torch.unique(key, sorted=True, return_inverse=True)
    del key
    nu, na = ukey.shape[0], ra.shape[0]

    def occupied(sel, vals):
        val = torch.zeros((nu,), dtype=dtype, device=ukey.device)
        occ = torch.zeros((nu,), dtype=torch.bool, device=ukey.device)
        val[sel] = vals.to(dtype)
        occ[sel] = True
        return val, occ

    a_val, a_occ = occupied(slot[:na], va)
    b_val, b_occ = occupied(slot[na:], vb)
    c = torch.full((nu,), c0, dtype=dtype, device=ukey.device)
    for occ, val, add in ((a_occ, a_val, add_a), (b_occ, b_val, add_b)):
        new = add(c, val)
        c = torch.where(occ, new, c.to(new.dtype))
    rows = torch.div(ukey, nc, rounding_mode="floor")
    return CSR(indptr=compute_indptr(rows, nr),
               indices=torch.remainder(ukey, nc).to(index_dtype), data=c,
               shape=(nr, nc))


def lin(alpha, mat_a, beta, mat_b):
    """alpha*A + beta*B (reference ``lin``, Matrix/Sparse.hs:426-431)."""
    return glin(
        0, lambda c, a: c + alpha * a, mat_a, lambda c, b: c + beta * b, mat_b
    )


def add(mat_a, mat_b):
    """A + B (reference Num ``+``, Matrix/Sparse.hs:100-113)."""
    return lin(1, mat_a, 1, mat_b)


def elementwise_mul(mat_a, mat_b):
    """Elementwise product with the reference's union-fold semantics
    (slots only in A keep A's value; see Vector/Sparse.hs:126)."""
    return glin(0, lambda c, a: c + a, mat_a, lambda c, b: c * b, mat_b)
