"""sparse_linear_tpu_torch — the PyTorch / CUDA port of sparse_linear_tpu.

A second package beside the JAX one, laid out the same way so that each
module's counterpart is found by path, and held against it by parity tests.
It imports torch and never JAX.  It covers the iterative-solve path on
structured (DIA) and unstructured (WELL) operators and the staged direct
solver:

  * formats/ — COO/CSR/CSC frozen dataclasses of tensors, DIA, WELL (a
    sliced ELL for unstructured patterns), format selection, invariant
    checker.
  * ops/     — construction (sort + dedup-by-sum), CSR/CSC/COO SpMV/SpMM,
    SpGEMM (sort-based and staged through WELL SpMVs).
  * kernels/ — plain PyTorch versions of every kernel, and the hand-written
    Hopper (sm_90a) CUDA kernels for DIA SpMV, the one-launch DIA SpMV
    chain, WELL SpMV and WELL SpMM (f32 and f64), built with nvcc at first
    use.
  * solve/   — conjugate gradients, and the multifrontal direct solver:
    fill-reducing orderings (natural, RCM, AMD, nested dissection),
    symbolic analysis, numeric LU / Cholesky factorization on the card
    (batched ``torch.linalg`` fronts), solves and partial solves,
    refinement, GMRES, determinant and condition queries, with a dense
    backend beside it (``solve.api``, ``solve.multifrontal``, imported by
    path as in the JAX package).
  * utils/   — 1D/2D/3D Poisson operators; the host library (symbolic
    analysis, AMD, ND) built with g++ at first use from ``csrc/host``.
  * interop/ — scipy.sparse / raw-array interchange, and carrying matrices
    and direct-solver artifacts across from the JAX package as numpy
    arrays.

Entry points run on the card unless the caller asks for the CPU.  Every
constructor that makes tensors from nothing or from host arrays takes
``device=`` and, without it, uses ``dtypes.default_device()``: the CUDA
card, with no probe and no fallback, so on a machine without a GPU such a
call raises torch's own error.  An input that is already a tensor keeps its
device.  Pass ``device="cpu"`` (or CPU tensors) to run on the CPU, as the
CPU tests do.
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
from sparse_linear_tpu_torch.formats.select import recommend_format, to_fast_format
from sparse_linear_tpu_torch.formats.validate import InvariantError, check_matrix
from sparse_linear_tpu_torch.formats.well import WELL, csr_to_well
from sparse_linear_tpu_torch.ops.build import from_dense, trim
from sparse_linear_tpu_torch.ops.linalg import axpy, scale, spmm, spmv
from sparse_linear_tpu_torch.ops.spgemm import spgemm

__version__ = "0.1.0"

__all__ = [
    "COO",
    "CSR",
    "CSC",
    "WELL",
    "InvariantError",
    "check_matrix",
    "from_triples",
    "from_dense",
    "trim",
    "csr_to_well",
    "recommend_format",
    "to_fast_format",
    "diag",
    "eye",
    "zeros",
    "axpy",
    "scale",
    "spmv",
    "spmm",
    "spgemm",
    "dtypes",
]
