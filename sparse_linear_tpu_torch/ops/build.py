"""Construction / normalization pipeline: COO -> CSR/CSC on the tensors'
device.

Counterpart of :mod:`sparse_linear_tpu.ops.build`, the reference's
``compress`` path done as:

  1. sort entries by one int64 key ``major * nminor + minor`` (stable; torch
     has no ``lexsort``)
  2. mark run starts, prefix-sum run ids            [the "dedupInPlace" step]
  3. ``index_add_`` values by run id                [duplicate summation]
  4. histogram + exclusive scan -> indptr           [the "computePtrs" step]

PyTorch runs eagerly, so the output is exact-size: no sentinel padding is
kept behind the unique entries.  Padding arriving in the input (entries with
major >= nmajor) is dropped.
"""

from __future__ import annotations

import numpy as np
import torch

from sparse_linear_tpu_torch.dtypes import default_device, index_dtype
from sparse_linear_tpu_torch.formats.base import compute_indptr
from sparse_linear_tpu_torch.formats.matrix import COO, CSC, CSR

__all__ = ["coo_to_csr", "coo_to_csc", "reorder_major", "trim", "from_dense"]


def _sort_dedup(major, minor, data, nmajor: int, nminor: int):
    """Sort by (major, minor) and sum duplicate coordinates.

    Returns exact-size (major, minor, data) of the unique entries, indices
    int32.  Entries with major >= nmajor are padding and are dropped.
    Temporaries are freed as soon as they are used: at 21M entries on the
    card each int64 array is 170 MB.
    """
    keep = major < nmajor
    if not bool(keep.all()):
        major, minor, data = major[keep], minor[keep], data[keep]
    del keep
    if data.shape[0] == 0:
        empty = torch.zeros((0,), dtype=index_dtype, device=data.device)
        return empty, empty.clone(), data
    key = major.to(torch.int64) * nminor + minor.to(torch.int64)
    key, perm = torch.sort(key, stable=True)
    data = data[perm]
    del perm
    new_run = torch.ones(key.shape, dtype=torch.bool, device=key.device)
    torch.ne(key[1:], key[:-1], out=new_run[1:])
    uid = torch.cumsum(new_run, 0) - 1
    key = key[new_run]
    del new_run
    out = torch.zeros((key.shape[0],), dtype=data.dtype, device=data.device)
    out.index_add_(0, uid, data)
    del uid, data
    return (
        torch.div(key, nminor, rounding_mode="floor").to(index_dtype),
        torch.remainder(key, nminor).to(index_dtype),
        out,
    )


def coo_to_csr(coo: COO) -> CSR:
    """COO -> CSR with dedup-by-sum (reference ``compress``, row-major)."""
    nr, nc = coo.shape
    major, minor, data = _sort_dedup(coo.row, coo.col, coo.data, nr, nc)
    return CSR(indptr=compute_indptr(major, nr), indices=minor, data=data,
               shape=coo.shape)


def coo_to_csc(coo: COO) -> CSC:
    """COO -> CSC (the reference's native orientation)."""
    return coo_to_csr(coo.T).T


def reorder_major(mat, to: str):
    """Explicit CSR<->CSC conversion by re-sorting (reference
    ``transpose``)."""
    coo = mat.tocoo()
    if to == "csr":
        return coo_to_csr(coo)
    if to == "csc":
        return coo_to_csc(coo)
    raise ValueError(f"unknown target format: {to}")


def trim(mat):
    """Cut padding so capacity == nnz (canonical form)."""
    if isinstance(mat, CSR):
        n = mat.nnz
        return CSR(indptr=mat.indptr, indices=mat.indices[:n],
                   data=mat.data[:n], shape=mat.shape)
    if isinstance(mat, CSC):
        return trim(mat.T).T
    if isinstance(mat, COO):
        valid = mat.row < mat.shape[0]
        n = int(valid.sum())
        # slicing [:n] is only correct when the padding forms a SUFFIX; a
        # hand-built COO with interior sentinels would silently drop real
        # entries
        if n and not bool(valid[:n].all()):
            raise ValueError(
                "trim: COO padding (row >= nrows) must be a suffix — "
                "found sentinel entries interleaved with real ones; "
                "normalize via tocsr()/coo_to_csr first"
            )
        return COO(row=mat.row[:n], col=mat.col[:n], data=mat.data[:n],
                   shape=mat.shape, nnz=n)
    raise TypeError(type(mat))


def from_dense(x, fmt: str = "csr", *, device=None):
    """Dense -> sparse (exact nnz).  Inverse of ``todense``/the reference's
    ``pack``.  ``x`` is a tensor or a host array; ``device`` defaults to
    where a tensor lives, and to the card for a host array."""
    device = default_device(device, x)
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x), device=device)
    x = x.to(device)
    if x.ndim != 2:
        raise ValueError("from_dense expects a 2-D array")
    r, c = torch.nonzero(x, as_tuple=True)
    coo = COO(row=r.to(index_dtype), col=c.to(index_dtype), data=x[r, c],
              shape=(int(x.shape[0]), int(x.shape[1])), nnz=int(r.shape[0]))
    if fmt == "coo":
        return coo
    if fmt == "csr":
        return coo.tocsr()
    if fmt == "csc":
        return coo.tocsc()
    raise ValueError(f"unknown format: {fmt}")
