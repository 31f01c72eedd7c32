"""Plain PyTorch SpMV / SpMM over DIA storage.

Counterpart of the DIA part of :mod:`sparse_linear_tpu.kernels.spmv`, which
are XLA forms in the JAX package.  Each diagonal is one shifted
multiply-add over a zero-padded x, so a column index outside [0, ncols)
contributes nothing.  :func:`dia_spmv` is also the plain version of the
Hopper kernel in :mod:`.spmv_dia`: the CPU path of that kernel's wrapper,
and the reference the tests and ``chip_smoke.py`` hold the kernel against.
ELL/BSR forms are not ported yet (ROADMAP.md queue 1 item 6).
"""

from __future__ import annotations

import torch

__all__ = ["dia_spmv", "dia_spmm", "dia_spmm_planes"]


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
