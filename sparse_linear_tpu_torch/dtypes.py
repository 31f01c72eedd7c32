"""Element-type layer: unified real/complex code paths over torch dtypes.

Counterpart of :mod:`sparse_linear_tpu.dtypes`.  The reference's
``RealOf``/``ComplexOf`` type families and ``IsReal`` class
(sparse-linear/src/Data/Complex/Enhanced.hs:19-53) become lookups on torch
dtypes, so every operation is written once for real and complex elements.

Indices are int32, as in the JAX package.  Wherever a key can exceed 2**31
(the (row, col) sort key ``row * ncols + col`` reaches 1.7e13 on the 2048**2
Poisson operator) the code computes it in int64.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "real_of",
    "complex_of",
    "is_complex",
    "conj",
    "mag",
    "real",
    "imag",
    "index_dtype",
    "as_torch_dtype",
]

# Index dtype used across the library, as in the JAX package.
index_dtype = torch.int32

_REAL_OF = {
    torch.float32: torch.float32,
    torch.float64: torch.float64,
    torch.complex64: torch.float32,
    torch.complex128: torch.float64,
}

_COMPLEX_OF = {
    torch.float32: torch.complex64,
    torch.float64: torch.complex128,
    torch.complex64: torch.complex64,
    torch.complex128: torch.complex128,
}


def as_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a scalar type, so
    that callers can name element types as the JAX package's callers do."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype


def real_of(dtype) -> torch.dtype:
    """``RealOf``: the real dtype underlying ``dtype``."""
    dtype = as_torch_dtype(dtype)
    if dtype not in _REAL_OF:
        raise TypeError(f"unsupported element dtype: {dtype}")
    return _REAL_OF[dtype]


def complex_of(dtype) -> torch.dtype:
    """``ComplexOf``: the complex dtype containing ``dtype``."""
    dtype = as_torch_dtype(dtype)
    if dtype not in _COMPLEX_OF:
        raise TypeError(f"unsupported element dtype: {dtype}")
    return _COMPLEX_OF[dtype]


def is_complex(dtype) -> bool:
    return as_torch_dtype(dtype).is_complex


def conj(x):
    """Complex conjugate; identity on real tensors."""
    return torch.conj(x).resolve_conj() if x.is_complex() else x


def real(x):
    """Real part."""
    return torch.real(x) if x.is_complex() else x


def imag(x):
    """Imaginary part; zeros for a real tensor."""
    if x.is_complex():
        return torch.imag(x)
    return torch.zeros_like(x)


def mag(x):
    """Magnitude |x|."""
    return torch.abs(x)
