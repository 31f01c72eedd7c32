"""Format-invariant checker.

Counterpart of :mod:`sparse_linear_tpu.formats.validate` (the idea of the
reference's ``checkMatrix``), with the same checks and messages:

  * pointer array has length nseg+1, starts at 0, is nondecreasing
  * len(values) == len(indices) == capacity >= indptr[-1]
  * minor indices strictly increasing within each segment (sorted + deduped)
  * all indices within bounds

The checks run on the tensors' device; only their verdicts come back to the
host.  Raises ``InvariantError`` with the first offending position.
"""

from __future__ import annotations

import torch

from sparse_linear_tpu_torch.formats.base import expand_indptr
from sparse_linear_tpu_torch.formats.matrix import COO, CSC, CSR

__all__ = ["InvariantError", "check_matrix", "nondecreasing", "increasing"]


class InvariantError(AssertionError):
    pass


def _tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def nondecreasing(x) -> bool:
    """Reference ``nondecreasing``."""
    x = _tensor(x)
    return bool(torch.all(x[1:] >= x[:-1])) if x.numel() else True


def increasing(x) -> bool:
    """Reference ``increasing``."""
    x = _tensor(x)
    return bool(torch.all(x[1:] > x[:-1])) if x.numel() else True


def _first(mask: torch.Tensor):
    bad = torch.nonzero(mask)
    return int(bad[0, 0]) if bad.shape[0] else None


def _check_compressed(indptr, indices, data, nseg, minor_dim, kind):
    if indptr.shape[0] != nseg + 1:
        raise InvariantError(
            f"{kind}: indptr length {indptr.shape[0]} != nseg+1 = {nseg + 1}"
        )
    if int(indptr[0]) != 0:
        raise InvariantError(f"{kind}: indptr[0] = {int(indptr[0])} != 0")
    if not nondecreasing(indptr):
        bad = _first(indptr[1:] < indptr[:-1])
        raise InvariantError(f"{kind}: indptr decreases at position {bad}")
    nnz = int(indptr[-1])
    if indices.shape[0] != data.shape[0]:
        raise InvariantError(
            f"{kind}: len(indices) {indices.shape[0]} != len(values) "
            f"{data.shape[0]}"
        )
    if indices.shape[0] < nnz:
        raise InvariantError(
            f"{kind}: capacity {indices.shape[0]} < indptr[-1] = {nnz}"
        )
    valid = indices[:nnz]
    if valid.numel():
        bad = _first((valid < 0) | (valid >= minor_dim))
        if bad is not None:
            raise InvariantError(
                f"{kind}: index out of bounds at entry {bad}: "
                f"{int(valid[bad])} not in [0, {minor_dim})"
            )
    if nnz > 1:
        seg_ids = expand_indptr(indptr, nnz)
        same_seg = seg_ids[1:] == seg_ids[:-1]
        bad = _first(same_seg & (valid[1:] <= valid[:-1]))
        if bad is not None:
            raise InvariantError(
                f"{kind}: indices not strictly increasing in segment "
                f"{int(seg_ids[bad])} (entry {bad + 1})"
            )
    return True


def check_matrix(m) -> bool:
    """Validate all canonical-format invariants; True or raises
    InvariantError."""
    nr, nc = m.shape
    if isinstance(m, CSR):
        return _check_compressed(m.indptr, m.indices, m.data, nr, nc, "CSR")
    if isinstance(m, CSC):
        return _check_compressed(m.indptr, m.indices, m.data, nc, nr, "CSC")
    if isinstance(m, COO):
        row, col, data = m.row, m.col, m.data
        if not (row.shape == col.shape == data.shape):
            raise InvariantError("COO: row/col/data length mismatch")
        n = m.nnz if m.nnz is not None else row.shape[0]
        r, c = row[:n], col[:n]
        bad = _first((r < 0) | (r >= nr))
        if bad is not None:
            raise InvariantError(
                f"COO: row out of bounds at entry {bad}: {int(r[bad])}"
            )
        bad = _first((c < 0) | (c >= nc))
        if bad is not None:
            raise InvariantError(
                f"COO: col out of bounds at entry {bad}: {int(c[bad])}"
            )
        # canonical COO: sorted by (row, col) with no duplicates
        if not increasing(r.to(torch.int64) * nc + c.to(torch.int64)):
            raise InvariantError("COO: entries not sorted/unique by (row, col)")
        # padding region must be sentinel
        if m.nnz is not None and row.shape[0] > n:
            if not (bool(torch.all(row[n:] == nr))
                    and bool(torch.all(col[n:] == nc))):
                raise InvariantError(
                    "COO: padding entries must be sentinel (nr, nc)")
        return True
    raise TypeError(f"unknown matrix type: {type(m)}")
