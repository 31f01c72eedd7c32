"""Structured sparse formats: DIA.

Counterpart of the DIA part of :mod:`sparse_linear_tpu.formats.structured`.
DIA is diagonal storage for stencil operators (the Poisson family); its
SpMV is a sum of shifted multiply-adds with no gathers.  ELL and BSR are not
ported yet (ROADMAP.md queue 1 item 6).

``DIA @ x`` is the main path's SpMV: on a CUDA tensor it launches the
hand-written Hopper kernel (:func:`kernels.spmv_dia.dia_spmv_kernel`), on a
CPU tensor it runs the plain version (:func:`kernels.spmv.dia_spmv`).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from sparse_linear_tpu_torch.formats.base import TensorFields, tensor_dataclass
from sparse_linear_tpu_torch.formats.matrix import CSR

__all__ = ["DIA", "csr_to_dia", "pad_dia"]


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
