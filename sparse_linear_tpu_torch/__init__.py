"""sparse_linear_tpu_torch — the PyTorch / CUDA port of sparse_linear_tpu.

A second package beside the JAX one, laid out the same way so that each
module's counterpart is found by path, and held against it by parity tests.
It imports torch and never JAX.  This slice covers the iterative-solve path:

  * formats/ — COO/CSR/CSC frozen dataclasses of tensors, DIA, invariant
    checker.
  * ops/     — construction (sort + dedup-by-sum), CSR/CSC/COO SpMV/SpMM.
  * kernels/ — plain PyTorch DIA SpMV/SpMM, and the hand-written Hopper
    (sm_90a) CUDA kernels for DIA SpMV and the one-launch SpMV chain,
    built with nvcc at first use.
  * solve/   — conjugate gradients.
  * utils/   — 1D/2D/3D Poisson operators.
  * interop/ — carrying matrices across from the JAX package as numpy
    arrays.

Every constructor that makes tensors from nothing takes ``device=``; the
rest follow the device of their inputs.
"""

from sparse_linear_tpu_torch import dtypes
from sparse_linear_tpu_torch.formats.matrix import (
    COO,
    CSC,
    CSR,
    diag,
    eye,
    from_triples,
    zeros,
)
from sparse_linear_tpu_torch.formats.validate import InvariantError, check_matrix
from sparse_linear_tpu_torch.ops.build import from_dense, trim
from sparse_linear_tpu_torch.ops.linalg import axpy, scale, spmm, spmv

__version__ = "0.1.0"

__all__ = [
    "COO",
    "CSR",
    "CSC",
    "InvariantError",
    "check_matrix",
    "from_triples",
    "from_dense",
    "trim",
    "diag",
    "eye",
    "zeros",
    "axpy",
    "scale",
    "spmv",
    "spmm",
    "dtypes",
]
