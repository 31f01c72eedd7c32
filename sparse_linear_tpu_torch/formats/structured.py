"""Structured sparse formats: DIA, ELL, BSR.

Counterpart of :mod:`sparse_linear_tpu.formats.structured`.

* DIA is diagonal storage for stencil operators (the Poisson family); its
  SpMV is a sum of shifted multiply-adds with no gathers.  ``DIA @ x`` is
  the main path's SpMV: on a CUDA tensor it launches the hand-written
  Hopper kernel (:func:`kernels.spmv_dia.dia_spmv_kernel`, real or
  complex), on a CPU tensor it runs the plain version
  (:func:`kernels.spmv.dia_spmv`).
* ELL holds K entries a row, padded with (column 0, value 0); ``@`` is a
  gather and a row sum (:func:`kernels.spmv.ell_spmv`).
* BSR holds dense (bm, bn) blocks in CSR layout over the block grid; ``@``
  is batched block products and a sum by block row
  (:func:`kernels.spmv.bsr_spmv` / :func:`kernels.spmv.bsr_spmm`).

ELL's and BSR's products are XLA forms in the JAX package, not
``pallas_call`` sites: their port is plain PyTorch, which runs PyTorch's
own kernels on the card.  Every conversion runs on the matrix's device.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from sparse_linear_tpu_torch.dtypes import index_dtype
from sparse_linear_tpu_torch.formats.base import (
    TensorFields,
    compute_indptr,
    expand_indptr,
    tensor_dataclass,
)
from sparse_linear_tpu_torch.formats.matrix import CSR

__all__ = ["DIA", "ELL", "BSR", "csr_to_dia", "csr_to_ell",
           "csr_to_bsr", "pad_dia"]


@tensor_dataclass
class DIA(TensorFields):
    """Diagonal storage: ``data[d, i] = A[i, i + offsets[d]]`` (row-aligned).

    Out-of-matrix positions hold 0.  ``offsets`` is a tuple of Python ints;
    :attr:`offsets_tensor` is the same offsets as an int64 tensor on the
    data's device, made once per matrix for the kernels."""

    data: torch.Tensor  # (ndiag, nrows)
    shape: tuple
    offsets: tuple

    @property
    def dtype(self):
        return self.data.dtype

    @functools.cached_property
    def offsets_tensor(self) -> torch.Tensor:
        return torch.tensor(self.offsets, dtype=torch.int64,
                            device=self.data.device)

    def todense(self):
        nr, nc = self.shape
        out = torch.zeros((nr, nc), dtype=self.data.dtype,
                          device=self.data.device)
        rows = torch.arange(nr, device=self.data.device)
        for d, off in enumerate(self.offsets):
            cols = rows + off
            ok = (cols >= 0) & (cols < nc)
            out[rows[ok], cols[ok]] += self.data[d][ok]
        return out

    def __matmul__(self, x):
        from sparse_linear_tpu_torch.kernels.spmv_dia import dia_spmv_kernel

        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(x, device=self.data.device)
        return dia_spmv_kernel(self, x)


def csr_to_dia(mat: CSR, max_diags: int = 64) -> DIA:
    """CSR -> DIA on the matrix's device.  Errors if the pattern needs more
    than ``max_diags`` distinct diagonals (then DIA is the wrong format)."""
    from sparse_linear_tpu_torch.ops.build import trim

    mat = trim(mat.tocsr())
    nr, _ = mat.shape
    rows = mat.row_ids().to(torch.int64)
    diff = mat.indices.to(torch.int64) - rows
    offs, d_idx = torch.unique(diff, sorted=True, return_inverse=True)
    del diff
    if offs.shape[0] > max_diags:
        raise ValueError(
            f"csr_to_dia: pattern has {offs.shape[0]} diagonals "
            f"(> {max_diags}); use ELL/BSR instead"
        )
    data = torch.zeros((offs.shape[0], nr), dtype=mat.data.dtype,
                       device=mat.data.device)
    data.view(-1)[d_idx * nr + rows] = mat.data
    return DIA(data=data, shape=mat.shape,
               offsets=tuple(int(o) for o in offs.tolist()))


def pad_dia(dia: DIA, multiple: int = 1024) -> DIA:
    """Square DIA padded with zero rows/cols to a row-count multiple.

    The pad is inert: padded data entries are zero, so padded x/y rows stay
    zero through any iteration chain.  Pad x to ``out.shape[1]`` (zeros)
    and slice y back to the original n.  (The Hopper kernel takes any
    shape; padding remains for callers that want aligned vectors.)"""
    nr, nc = dia.shape
    if nr != nc:
        raise ValueError("pad_dia: only square operators")
    n_pad = -(-nr // multiple) * multiple
    if n_pad == nr:
        return dia
    return dataclasses.replace(
        dia,
        data=torch.nn.functional.pad(dia.data, (0, n_pad - nr)),
        shape=(n_pad, n_pad),
    )


# ---------------------------------------------------------------------- ELL


@tensor_dataclass
class ELL(TensorFields):
    """ELLPACK: fixed K entries per row, padded with (column 0, value 0)."""

    cols: torch.Tensor  # (nrows, K) int32
    vals: torch.Tensor  # (nrows, K)
    shape: tuple

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def width(self) -> int:
        return int(self.cols.shape[1])

    def todense(self):
        nr, nc = self.shape
        out = torch.zeros((nr, nc), dtype=self.vals.dtype,
                          device=self.vals.device)
        rows = torch.arange(nr, device=self.vals.device)[:, None].expand(
            self.cols.shape)
        out.index_put_((rows.reshape(-1), self.cols.reshape(-1).long()),
                       self.vals.reshape(-1), accumulate=True)
        return out

    def __matmul__(self, x):
        from sparse_linear_tpu_torch.kernels.spmv import ell_spmv

        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(x, device=self.vals.device)
        return ell_spmv(self, x)


def csr_to_ell(mat: CSR, width: int | None = None) -> ELL:
    """CSR -> ELL on the matrix's device.  ``width`` defaults to the max
    row nnz."""
    from sparse_linear_tpu_torch.ops.build import trim

    mat = trim(mat.tocsr())
    nr, _ = mat.shape
    row_nnz = (mat.indptr[1:] - mat.indptr[:-1]).to(torch.int64)
    longest = int(row_nnz.max()) if nr else 0
    k = longest if width is None else int(width)
    if width is not None and longest > width:
        raise ValueError(
            f"csr_to_ell: max row nnz {longest} exceeds width {width}"
        )
    device = mat.data.device
    cols = torch.zeros((nr, k), dtype=index_dtype, device=device)
    vals = torch.zeros((nr, k), dtype=mat.data.dtype, device=device)
    # padding gathers x[0] times 0: harmless and always in bounds
    rows = mat.row_ids().long()
    pos = (torch.arange(mat.nnz, device=device)
           - mat.indptr.to(torch.int64)[rows])
    cols[rows, pos] = mat.indices
    vals[rows, pos] = mat.data
    return ELL(cols=cols, vals=vals, shape=mat.shape)


# ---------------------------------------------------------------------- BSR


@tensor_dataclass
class BSR(TensorFields):
    """Block sparse rows: dense (bm, bn) blocks in CSR layout over the
    (nrows/bm, ncols/bn) block grid."""

    indptr: torch.Tensor   # (nbrows + 1,) int32
    indices: torch.Tensor  # (nblocks,) int32 block-column ids
    blocks: torch.Tensor   # (nblocks, bm, bn)
    shape: tuple
    block_shape: tuple

    @property
    def dtype(self):
        return self.blocks.dtype

    def todense(self):
        nr, nc = self.shape
        bm, bn = self.block_shape
        brow = expand_indptr(self.indptr, int(self.blocks.shape[0])).long()
        out = torch.zeros((nr // bm, nc // bn, bm, bn),
                          dtype=self.blocks.dtype, device=self.blocks.device)
        out.index_put_((brow, self.indices.long()), self.blocks,
                       accumulate=True)
        return out.permute(0, 2, 1, 3).reshape(nr, nc)

    def __matmul__(self, x):
        from sparse_linear_tpu_torch.kernels.spmv import bsr_spmm, bsr_spmv

        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(x, device=self.blocks.device)
        if x.ndim == 1:
            return bsr_spmv(self, x)
        return bsr_spmm(self, x)


def csr_to_bsr(mat: CSR, block_shape=(8, 128)) -> BSR:
    """CSR -> BSR on the matrix's device.  Dimensions must divide by the
    block shape (pad the matrix first if not)."""
    from sparse_linear_tpu_torch.ops.build import trim

    mat = trim(mat.tocsr())
    nr, nc = mat.shape
    bm, bn = block_shape
    if nr % bm or nc % bn:
        raise ValueError(
            f"csr_to_bsr: shape {mat.shape} not divisible by blocks "
            f"{block_shape}"
        )
    rows = mat.row_ids().to(torch.int64)
    cols = mat.indices.to(torch.int64)
    key = (rows // bm) * (nc // bn) + cols // bn
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    blocks = torch.zeros((uniq.shape[0], bm, bn), dtype=mat.data.dtype,
                         device=mat.data.device)
    blocks[inv, rows % bm, cols % bn] = mat.data
    ubr = torch.div(uniq, nc // bn, rounding_mode="floor")
    return BSR(
        indptr=compute_indptr(ubr, nr // bm),
        indices=torch.remainder(uniq, nc // bn).to(index_dtype),
        blocks=blocks,
        shape=mat.shape,
        block_shape=(int(bm), int(bn)),
    )
