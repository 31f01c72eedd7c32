"""Core sparse matrix formats: COO, CSR, CSC.

Counterpart of :mod:`sparse_linear_tpu.formats.matrix`.  COO is the
construction format, CSR the primary one, and CSC the column view obtained
from CSR by an O(1) buffer-sharing transpose.  Each format is a frozen
dataclass of tensors with a ``.to(device)`` method.

Constructors produce exact-size canonical arrays that satisfy the reference
invariants: nondecreasing pointers, strictly increasing minor indices within
each segment, indices in range, duplicates summed.  Buffers with padding
past the valid entries are accepted as the JAX package defines them: padded
COO entries carry sentinel coordinates (row == nrows, col == ncols, value
0); padded CSR/CSC entries lie past ``indptr[-1]``.

``@`` and ``*`` between two sparse matrices are SpGEMM
(:func:`ops.spgemm.spgemm`), and ``+``/``-`` the union merge
(:func:`ops.linalg.add` / ``lin``), as in the JAX package; ``abs``,
``signum``, ``reduce_values`` and ``sum_values`` are the reference's
elementwise and fold methods.  ``CSR.row`` / ``CSC.col`` cut one row or
column as a :class:`formats.sparse_vector.SparseVector`, as the JAX
methods do; ``ops.structure.to_rows`` / ``to_columns`` cut all of them from
one host copy of the pointers.
"""

from __future__ import annotations

import numpy as np
import torch

from sparse_linear_tpu_torch.dtypes import (
    as_torch_dtype,
    conj as _conj,
    default_device,
    index_dtype,
)
from sparse_linear_tpu_torch.formats.base import (
    TensorFields,
    expand_indptr,
    tensor_dataclass,
)
from sparse_linear_tpu_torch.utils.profiling import annotate

__all__ = ["COO", "CSR", "CSC", "from_triples", "eye", "zeros", "diag"]

def _shape2(shape):
    nr, nc = shape
    return (int(nr), int(nc))


class _MatrixOpsMixin(TensorFields):
    """Operator sugar shared by all matrix formats: ``@`` is the
    matrix-vector / matrix-dense product, ``*`` by a scalar scales, and both
    with a sparse operand are SpGEMM; ``+``/``-`` merge over the union
    pattern."""

    def __matmul__(self, other):
        from sparse_linear_tpu_torch.ops import linalg, spgemm

        if isinstance(other, _MatrixOpsMixin):
            return spgemm.spgemm(self, other)
        if not isinstance(other, torch.Tensor):
            other = torch.as_tensor(np.asarray(other), device=self.device)
        if other.ndim == 1:
            return linalg.spmv(self, other)
        return linalg.spmm(self, other)

    def __mul__(self, other):
        from sparse_linear_tpu_torch.ops import linalg, spgemm

        if isinstance(other, _MatrixOpsMixin):
            return spgemm.spgemm(self, other)
        return linalg.scale(self, other)

    def __rmul__(self, other):
        from sparse_linear_tpu_torch.ops import linalg

        return linalg.scale(self, other)

    def __add__(self, other):
        from sparse_linear_tpu_torch.ops import linalg

        return linalg.add(self, other)

    def __sub__(self, other):
        from sparse_linear_tpu_torch.ops import linalg

        return linalg.lin(1.0, self, -1.0, other)

    def __neg__(self):
        return self.map_values(torch.negative)

    def __abs__(self):
        """Elementwise absolute value (reference Num ``abs``)."""
        return self.map_values(torch.abs)

    def signum(self):
        """Elementwise sign (reference Num ``signum``): x / |x| for complex
        values, as ``jnp.sign``; 0 stays 0."""
        return self.map_values(torch.sgn)

    def reduce_values(self, f, init):
        """Fold over STORED values only (reference MonoFoldable
        ``ofoldl'``), on a host copy of the values, as the JAX package
        folds.

        When ``f`` is one of the recognized associative binary ops (add,
        multiply, maximum, minimum of numpy or torch; ``operator.add`` /
        ``operator.mul``) the fold runs as ONE numpy reduction and the
        numpy op of ``(init, reduced)``: the same result up to
        floating-point reassociation.  Any other ``f`` gets
        the exact sequential left fold, O(nnz) host iterations."""
        import operator

        from sparse_linear_tpu_torch.ops.build import trim

        vals = trim(self).data.detach().resolve_conj().cpu().numpy()
        folds = {}
        for ufunc, torch_op in ((np.add, torch.add), (np.multiply, torch.mul),
                                (np.maximum, torch.maximum),
                                (np.minimum, torch.minimum)):
            folds[ufunc] = folds[torch_op] = ufunc
        folds[operator.add] = np.add
        folds[operator.mul] = np.multiply
        ufunc = folds.get(f)
        if ufunc is not None and vals.size:
            return ufunc(init, ufunc.reduce(vals))
        acc = init
        for v in vals:
            acc = f(acc, v)
        return acc

    def sum_values(self):
        """Sum of the stored (valid) values, a 0-d tensor on the matrix's
        device (``ofoldl' (+)``)."""
        from sparse_linear_tpu_torch.ops.linalg import _valid_coords

        return _valid_coords(self)[2].sum()

    def conj(self):
        return self.map_values(_conj)

    def ctrans(self):
        """Conjugate transpose."""
        return self.T.conj()

    def is_hermitian(self, tol: float = 0.0) -> bool:
        """ctrans m == m (reference ``hermitian``, Matrix/Sparse.hs:377-379;
        exact equality there, ``tol`` generalizes).

        O(nnz) on the canonical CSR, never densified: the pattern of A and
        of ctrans(A) must agree entry for entry, and their values within
        ``tol``."""
        nr, nc = self.shape
        if nr != nc:
            return False
        from sparse_linear_tpu_torch.ops.build import trim

        a = trim(self.tocsr())
        h = trim(a.ctrans().tocsr())
        for p, q in ((a.indptr, h.indptr), (a.indices, h.indices)):
            if not torch.equal(p.to(torch.int64), q.to(torch.int64)):
                return False
        return bool(torch.all(torch.abs(a.data - h.data) <= tol))

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])


def _scatter_dense(shape, rows, cols, data):
    """Dense (nr, nc) from coordinates; out-of-range (padding) entries are
    dropped."""
    nr, nc = shape
    ok = (rows < nr) & (cols < nc)
    out = torch.zeros((nr, nc), dtype=data.dtype, device=data.device)
    out.index_put_((rows[ok].long(), cols[ok].long()), data[ok],
                   accumulate=True)
    return out


@tensor_dataclass
class COO(_MatrixOpsMixin):
    """Coordinate format.  ``nnz`` is the count of valid entries, or
    ``None`` when the buffers may carry sentinel padding."""

    row: torch.Tensor
    col: torch.Tensor
    data: torch.Tensor
    shape: tuple
    nnz: object = None  # int | None

    def todense(self):
        return _scatter_dense(self.shape, self.row, self.col, self.data)

    @property
    def T(self):
        return COO(row=self.col, col=self.row, data=self.data,
                   shape=(self.shape[1], self.shape[0]), nnz=self.nnz)

    def map_values(self, f):
        return COO(row=self.row, col=self.col, data=f(self.data),
                   shape=self.shape, nnz=self.nnz)

    def tocsr(self):
        from sparse_linear_tpu_torch.ops import build

        with annotate("slt.format.tocsr"):
            return build.coo_to_csr(self)

    def tocsc(self):
        from sparse_linear_tpu_torch.ops import build

        return build.coo_to_csc(self)

    def tocoo(self):
        return self


@tensor_dataclass
class CSR(_MatrixOpsMixin):
    """Compressed sparse row.  Valid entries are positions < indptr[-1]."""

    indptr: torch.Tensor
    indices: torch.Tensor
    data: torch.Tensor
    shape: tuple

    @property
    def nnz(self) -> int:
        """Valid-entry count (reference ``nonZero``)."""
        return int(self.indptr[-1])

    def row_ids(self):
        """Per-entry row ids (reference ``decompress``); padded entries get
        id == nrows."""
        return expand_indptr(self.indptr, self.capacity)

    def todense(self):
        return _scatter_dense(self.shape, self.row_ids(), self.indices,
                              self.data)

    @property
    def T(self):
        """O(1) transpose: the same buffers viewed as CSC of the transposed
        shape."""
        return CSC(indptr=self.indptr, indices=self.indices, data=self.data,
                   shape=(self.shape[1], self.shape[0]))

    def map_values(self, f):
        return CSR(indptr=self.indptr, indices=self.indices,
                   data=f(self.data), shape=self.shape)

    def tocoo(self):
        """Exact-size COO of the valid entries, sorted by (row, col)."""
        n = self.nnz
        return COO(row=self.row_ids()[:n], col=self.indices[:n],
                   data=self.data[:n], shape=self.shape, nnz=n)

    def tocsr(self):
        return self

    def tocsc(self):
        from sparse_linear_tpu_torch.ops import build

        return build.reorder_major(self, to="csc")

    def row(self, i: int):
        """Row i as a sparse vector of length ncols (reference ``slice``,
        Matrix/Sparse.hs:161-182), its buffers views of this matrix's."""
        return _segment(self, i, self.shape[1])


@tensor_dataclass
class CSC(_MatrixOpsMixin):
    """Compressed sparse column (the reference's native format)."""

    indptr: torch.Tensor
    indices: torch.Tensor
    data: torch.Tensor
    shape: tuple

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    def col_ids(self):
        return expand_indptr(self.indptr, self.capacity)

    def todense(self):
        return _scatter_dense(self.shape, self.indices, self.col_ids(),
                              self.data)

    @property
    def T(self):
        return CSR(indptr=self.indptr, indices=self.indices, data=self.data,
                   shape=(self.shape[1], self.shape[0]))

    def map_values(self, f):
        return CSC(indptr=self.indptr, indices=self.indices,
                   data=f(self.data), shape=self.shape)

    def tocoo(self):
        return self.T.tocoo().T

    def tocsc(self):
        return self

    def tocsr(self):
        from sparse_linear_tpu_torch.ops import build

        with annotate("slt.format.tocsr"):
            return build.reorder_major(self, to="csr")

    def col(self, j: int):
        """Column j as a sparse vector of length nrows (reference
        ``slice``, Matrix/Sparse.hs:161-182), its buffers views of this
        matrix's."""
        return _segment(self, j, self.shape[0])


def _segment(mat, k: int, length: int):
    """Segment k of a compressed matrix (one host read of its two
    pointers) as a SparseVector of ``length``."""
    from sparse_linear_tpu_torch.formats.sparse_vector import SparseVector

    nseg = mat.indptr.shape[0] - 1
    if not 0 <= k < nseg:
        raise IndexError(f"segment {k} out of range for {nseg} segments")
    lo, hi = (int(v) for v in mat.indptr[k:k + 2].tolist())
    return SparseVector(indices=mat.indices[lo:hi], data=mat.data[lo:hi],
                        length=length)


# ---------------------------------------------------------------------------
# Constructors (exact-size canonical output)
# ---------------------------------------------------------------------------


def _as_tensor(x, device, dtype=None):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _first_bad(mask: torch.Tensor):
    """Position of the first True in ``mask``, or None."""
    bad = torch.nonzero(mask)
    return int(bad[0, 0]) if bad.shape[0] else None


def from_triples(shape, rows, cols, vals, dtype=None, *, device=None):
    """Build a canonical COO from triples, summing duplicates.

    Analog of reference ``fromTriples``/``compress`` including its bounds
    checking with the position of the first offending entry.  ``rows``,
    ``cols`` and ``vals`` may be tensors or host arrays; the work runs on
    ``device``, by default the device of the first tensor argument, and the
    card when all three are host arrays.

    Duplicates are summed with ``index_add_`` in (row, col)-sorted order:
    on the CPU in input order, as the JAX package's ``np.add.at``; on CUDA
    in an unspecified order, which can change the sum of three or more
    duplicates in its last bit (within 1e-15 relative in f64).
    """
    with annotate("slt.format.from_triples"):
        nr, nc = _shape2(shape)
        device = default_device(device, rows, cols, vals)
        rows = _as_tensor(rows, device)
        cols = _as_tensor(cols, device)
        vals = _as_tensor(vals, device,
                          None if dtype is None else as_torch_dtype(dtype))
        if not (rows.shape == cols.shape == vals.shape) or rows.ndim != 1:
            raise ValueError(
                "rows, cols, vals must be 1-D arrays of equal length")
        bad = _first_bad((rows < 0) | (rows >= nr))
        if bad is not None:
            raise ValueError(
                f"row index out of bounds at position {bad}: "
                f"{int(rows[bad])} not in [0, {nr})"
            )
        bad = _first_bad((cols < 0) | (cols >= nc))
        if bad is not None:
            raise ValueError(
                f"column index out of bounds at position {bad}: "
                f"{int(cols[bad])} not in [0, {nc})"
            )
        from sparse_linear_tpu_torch.ops.build import _sort_dedup

        row, col, data = _sort_dedup(rows, cols, vals, nr, nc)
        return COO(row=row, col=col, data=data, shape=(nr, nc),
                   nnz=int(row.shape[0]))


def diag(values, shape=None, *, device=None):
    """Diagonal matrix from a vector (reference ``diag``).  A tensor keeps
    its device unless ``device`` is given; host values go to ``device``,
    by default the card."""
    values = _as_tensor(values, default_device(device, values))
    n = int(values.shape[0])
    if shape is None:
        shape = (n, n)
    nr, nc = _shape2(shape)
    if min(nr, nc) != n:
        raise ValueError("diag length must equal min(shape)")
    dev = values.device
    idx = torch.arange(n, dtype=index_dtype, device=dev)
    indptr = torch.cat([
        torch.arange(n + 1, dtype=index_dtype, device=dev),
        torch.full((nr - n,), n, dtype=index_dtype, device=dev),
    ])
    return CSR(indptr=indptr, indices=idx, data=values, shape=(nr, nc))


def eye(n, dtype=torch.float32, *, device=None):
    """Identity (reference ``ident``), on ``device``, by default the card."""
    return diag(torch.ones((n,), dtype=as_torch_dtype(dtype),
                           device=default_device(device)))


def zeros(shape, dtype=torch.float32, *, device=None):
    """All-zero matrix with empty arrays (reference ``zeros``), on
    ``device``, by default the card."""
    nr, nc = _shape2(shape)
    device = default_device(device)
    return CSR(
        indptr=torch.zeros((nr + 1,), dtype=index_dtype, device=device),
        indices=torch.zeros((0,), dtype=index_dtype, device=device),
        data=torch.zeros((0,), dtype=as_torch_dtype(dtype), device=device),
        shape=(nr, nc),
    )
