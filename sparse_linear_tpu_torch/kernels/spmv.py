"""Plain PyTorch SpMV / SpMM over the structured formats.

Counterpart of :mod:`sparse_linear_tpu.kernels.spmv`, whose functions are
XLA forms in the JAX package, not ``pallas_call`` sites.

* DIA: each diagonal is one shifted multiply-add over a zero-padded x, so a
  column index outside [0, ncols) contributes nothing.  :func:`dia_spmv`,
  :func:`dia_spmm` and :func:`dia_spmm_planes` are also the plain versions
  of the Hopper kernels in :mod:`.spmv_dia`: the CPU path of those
  wrappers, and the reference the tests and ``chip_smoke.py`` hold the
  kernels against.
* ELL: a gather of x by the (nrows, K) column table and a row sum.
* BSR: batched (bm, bn) block products (``torch.einsum``) and a sum by
  block row (``index_add_``).  The JAX forms cast x to the blocks' dtype
  before the product; here both are promoted to ``torch.result_type``, so
  a real BSR times a complex x keeps x's imaginary part.

On CUDA the ELL and BSR forms run PyTorch's own kernels: no hand-written
kernel replaces them.
"""

from __future__ import annotations

import torch

__all__ = ["dia_spmv", "dia_spmm", "dia_spmm_planes", "ell_spmv",
           "bsr_spmv", "bsr_spmm"]


def _pads(dia):
    nr, nc = dia.shape
    offsets = dia.offsets
    pad_lo = max(0, -min(offsets, default=0))
    pad_hi = max(0, max(offsets, default=0) + nr - nc)
    return pad_lo, pad_hi


def _padded(x, dim, pad_lo, pad_hi, dtype):
    """``x`` cast to ``dtype`` with zero rows added along ``dim``."""
    shape = list(x.shape)
    n = shape[dim]
    shape[dim] = pad_lo + n + pad_hi
    xp = torch.zeros(shape, dtype=dtype, device=x.device)
    xp.narrow(dim, pad_lo, n).copy_(x)
    return xp


def dia_spmv(dia, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for DIA storage: y[i] = sum_d data[d, i] * x[i + off_d]."""
    nr, nc = dia.shape
    if x.shape[0] != nc:
        raise ValueError(
            f"dia_spmv: dimension mismatch {dia.shape} @ {tuple(x.shape)}")
    pad_lo, pad_hi = _pads(dia)
    dtype = torch.result_type(dia.data, x)
    xp = _padded(x, 0, pad_lo, pad_hi, dtype)
    data = dia.data.to(dtype)
    y = torch.zeros((nr,), dtype=dtype, device=x.device)
    for d, off in enumerate(dia.offsets):
        y.addcmul_(data[d], xp.narrow(0, off + pad_lo, nr))
    return y


def dia_spmm(dia, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for DIA storage and dense X (ncols, m): the dia_spmv
    shifted multiply-add lifted over the column axis."""
    nr, nc = dia.shape
    if x.ndim == 1:
        return dia_spmv(dia, x)
    if x.shape[0] != nc:
        raise ValueError(
            f"dia_spmm: dimension mismatch {dia.shape} @ {tuple(x.shape)}")
    pad_lo, pad_hi = _pads(dia)
    dtype = torch.result_type(dia.data, x)
    xp = _padded(x, 0, pad_lo, pad_hi, dtype)
    data = dia.data.to(dtype)
    y = torch.zeros((nr, x.shape[1]), dtype=dtype, device=x.device)
    for d, off in enumerate(dia.offsets):
        y.addcmul_(data[d][:, None], xp.narrow(0, off + pad_lo, nr))
    return y


def dia_spmm_planes(dia, xp: torch.Tensor) -> torch.Tensor:
    """Plane-major Y = A @ X for DIA storage: ``xp`` of shape (m, ncols),
    one RHS per ROW, returns (m, nrows)."""
    nr, nc = dia.shape
    if xp.ndim != 2 or xp.shape[1] != nc:
        raise ValueError(
            f"dia_spmm_planes: expected (m, {nc}) planes, got "
            f"{tuple(xp.shape)}"
        )
    pad_lo, pad_hi = _pads(dia)
    dtype = torch.result_type(dia.data, xp)
    x2 = _padded(xp, 1, pad_lo, pad_hi, dtype)
    data = dia.data.to(dtype)
    y = torch.zeros((xp.shape[0], nr), dtype=dtype, device=xp.device)
    for d, off in enumerate(dia.offsets):
        y.addcmul_(data[d][None, :], x2.narrow(1, off + pad_lo, nr))
    return y


def ell_spmv(ell, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for ELL storage: gather + row-sum over the static width
    K."""
    nr, nc = ell.shape
    if x.shape[0] != nc:
        raise ValueError(
            f"ell_spmv: dimension mismatch {ell.shape} @ {tuple(x.shape)}")
    return (ell.vals * x[ell.cols.long()]).sum(dim=1)


def _bsr_product(bsr, xb: torch.Tensor, spec: str) -> torch.Tensor:
    """Sum by block row of the block products ``einsum(spec, blocks,
    xb[indices])``: (nbrows, bm, ...) before the final reshape."""
    from sparse_linear_tpu_torch.formats.base import expand_indptr

    nr = bsr.shape[0]
    bm = bsr.block_shape[0]
    dtype = torch.result_type(bsr.blocks, xb)
    contrib = torch.einsum(spec, bsr.blocks.to(dtype),
                           xb[bsr.indices.long()].to(dtype))
    brow = expand_indptr(bsr.indptr, int(bsr.blocks.shape[0]))
    y = torch.zeros((nr // bm,) + tuple(contrib.shape[1:]), dtype=dtype,
                    device=xb.device)
    # block rows are nondecreasing by CSR construction
    return y.index_add_(0, brow, contrib)


def bsr_spmv(bsr, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for BSR storage: batched block GEMV + block-row sum."""
    nr, nc = bsr.shape
    bn = bsr.block_shape[1]
    if x.shape[0] != nc:
        raise ValueError(
            f"bsr_spmv: dimension mismatch {bsr.shape} @ {tuple(x.shape)}")
    y = _bsr_product(bsr, x.reshape(nc // bn, bn), "kij,kj->ki")
    return y.reshape(nr)


def bsr_spmm(bsr, b: torch.Tensor) -> torch.Tensor:
    """Y = A @ B for BSR storage and dense B (ncols, m): batched block
    GEMMs + block-row sum."""
    nr, nc = bsr.shape
    bn = bsr.block_shape[1]
    if b.shape[0] != nc:
        raise ValueError(
            f"bsr_spmm: dimension mismatch {bsr.shape} @ {tuple(b.shape)}")
    m = b.shape[1]
    y = _bsr_product(bsr, b.reshape(nc // bn, bn, m), "kij,kjm->kim")
    return y.reshape(nr, m)
