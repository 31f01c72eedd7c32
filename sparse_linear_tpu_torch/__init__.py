"""sparse_linear_tpu_torch — the PyTorch / CUDA port of sparse_linear_tpu.

A second package beside the JAX one, laid out the same way so that each
module's counterpart is found by path, and held against it by parity tests.
It imports torch and never JAX.  It covers the iterative-solve path on
structured (DIA) and unstructured (WELL) operators, real and complex, the
staged direct solver, FEAST and the JAX package's op surface:

  * formats/ — COO/CSR/CSC frozen dataclasses of tensors, sparse vectors,
    DIA, ELL, BSR, WELL (a sliced ELL for unstructured patterns), format
    selection, invariant checker.
  * ops/     — construction (sort + dedup-by-sum), structural algebra
    (concatenation, block assembly, Kronecker products, diagonals,
    submatrices, rows and columns), CSR/CSC/COO SpMV/SpMM, the union
    merge (``glin``/``lin``/``add``/``elementwise_mul``), SpGEMM
    (sort-based and staged through WELL SpMVs).
  * kernels/ — plain PyTorch versions of every kernel, and the hand-written
    Hopper (sm_90a) CUDA kernels for DIA SpMV and its multi-RHS form, the
    one-launch DIA SpMV chain, WELL SpMV and WELL SpMM (float32, float64,
    complex64 and complex128; the chain real only), built with nvcc at
    first use.
  * eig/     — the FEAST interval eigensolver (``eig.feast``), with
    counting and slicing, for real symmetric and complex Hermitian pencils,
    and the factorization-free Chebyshev-filtered subspace iteration for
    the lowest pairs of a real symmetric operator (``eig.chebyshev``).
  * solve/   — conjugate gradients, and the multifrontal direct solver:
    fill-reducing orderings (natural, RCM, AMD, nested dissection),
    symbolic analysis, numeric LU / Cholesky factorization on the card
    (batched ``torch.linalg`` fronts), solves and partial solves,
    refinement, GMRES, determinant and condition queries, with a dense
    backend beside it (``solve.api``, ``solve.multifrontal``, imported by
    path as in the JAX package).
  * utils/   — 1D/2D/3D Poisson operators; the host library (symbolic
    analysis, AMD, ND) built with g++ at first use from ``csrc/host``;
    checkpoints of factors, FEAST subspaces and WELL packings in the JAX
    package's ``.npz`` files (``utils.serialize``); ``torch.profiler`` /
    NVTX tracing hooks (``utils.profiling``).  ``eig.chebyshev``,
    ``utils.serialize`` and ``utils.profiling`` are imported by path, as in
    the JAX package.
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
from sparse_linear_tpu_torch.formats.sparse_vector import SparseVector, from_pairs
from sparse_linear_tpu_torch.formats.validate import InvariantError, check_matrix
from sparse_linear_tpu_torch.formats.well import WELL, csr_to_well
from sparse_linear_tpu_torch.ops.build import from_dense, trim
from sparse_linear_tpu_torch.ops.linalg import (
    add,
    axpy,
    elementwise_mul,
    glin,
    lin,
    scale,
    spmm,
    spmv,
)
from sparse_linear_tpu_torch.ops.spgemm import spgemm
from sparse_linear_tpu_torch.ops.structure import (
    block_diag,
    from_blocks,
    from_blocks_diag,
    from_columns,
    from_rows,
    hcat,
    kron,
    outer,
    submatrix,
    take_diag,
    to_columns,
    to_rows,
    vcat,
)

__version__ = "0.1.0"

__all__ = [
    "COO",
    "CSR",
    "CSC",
    "WELL",
    "SparseVector",
    "InvariantError",
    "check_matrix",
    "from_triples",
    "from_pairs",
    "from_dense",
    "trim",
    "csr_to_well",
    "recommend_format",
    "to_fast_format",
    "diag",
    "eye",
    "zeros",
    "add",
    "axpy",
    "glin",
    "lin",
    "scale",
    "spmv",
    "spmm",
    "elementwise_mul",
    "spgemm",
    "vcat",
    "hcat",
    "from_blocks",
    "from_blocks_diag",
    "block_diag",
    "kron",
    "outer",
    "submatrix",
    "take_diag",
    "to_columns",
    "from_columns",
    "to_rows",
    "from_rows",
    "dtypes",
]
