"""f64 SpMV / SpMM for WELL storage.

Counterpart of :mod:`sparse_linear_tpu.kernels.spmv_well64`, with the same
public names.  The TPU has no 64-bit in-register gather, so the JAX package
carries f64 as paired hi/lo f32 planes with compensated (TwoProd/TwoSum)
accumulation at ~1e-13 relative.  Hopper has native f64: :class:`WELL64` is
a WELL whose values are float64, and its products run the float64
instantiations of the same kernels as the f32 path (kernel C
``well_spmv_kernel<double>``, kernel D ``well_spmm_kernel<double, ...>``).
The contract kept from the JAX module: ||y - y_csr|| / ||y_csr|| <= 1e-13
against f64 CSR SpMV; native f64 sums reach ~1e-16 per entry.
"""

from __future__ import annotations

import dataclasses

import torch

from sparse_linear_tpu_torch.formats.base import tensor_dataclass
from sparse_linear_tpu_torch.formats.well import WELL, csr_to_well
from sparse_linear_tpu_torch.kernels.spmv_well import (
    _as_tensor,
    well_spmm_planes,
    well_spmv,
)

__all__ = ["WELL64", "csr_to_well64", "well_spmv64", "well_spmm64_planes"]


@tensor_dataclass
class WELL64(WELL):
    """A WELL with float64 values; ``@`` is :func:`well_spmv64`."""

    def __matmul__(self, x):
        return well_spmv64(self, x)


def csr_to_well64(mat, c_max: int | None = None) -> WELL64:
    """Pack a real CSR into WELL storage with float64 values, on the
    matrix's device."""
    csr = mat.tocsr()
    if csr.data.is_complex():
        raise TypeError("csr_to_well64: complex input — use csr_to_well "
                        "(two value planes) instead")
    w = csr_to_well(csr.map_values(lambda v: v.to(torch.float64)),
                    c_max=c_max)
    return WELL64(**{f.name: getattr(w, f.name)
                     for f in dataclasses.fields(w)})


def well_spmv64(a64: WELL64, x) -> torch.Tensor:
    """y = A @ x in float64; x any real dtype (complex x runs as two real
    products), returns float64 (complex128)."""
    x = _as_tensor(a64, x)
    if x.ndim != 1 or x.shape[0] != a64.shape[1]:
        raise ValueError(
            f"well_spmv64: dimension mismatch {a64.shape} @ {tuple(x.shape)}"
        )
    if x.is_complex():
        return torch.complex(well_spmv64(a64, x.real),
                             well_spmv64(a64, x.imag))
    return well_spmv(a64, x.to(torch.float64))


def well_spmm64_planes(a64: WELL64, xp) -> torch.Tensor:
    """Y = A @ X in float64, plane-major: ``xp`` (m, nc), one RHS per row;
    returns (m, nr)."""
    xp = _as_tensor(a64, xp)
    if xp.ndim != 2 or xp.shape[1] != a64.shape[1]:
        raise ValueError(
            f"well_spmm64_planes: expected (m, {a64.shape[1]}) planes, "
            f"got {tuple(xp.shape)}"
        )
    if xp.is_complex():
        return torch.complex(well_spmm64_planes(a64, xp.real),
                             well_spmm64_planes(a64, xp.imag))
    return well_spmm_planes(a64, xp.to(torch.float64))
