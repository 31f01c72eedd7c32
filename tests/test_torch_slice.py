"""The whole iterative-solve slices in both packages, on the CPU, in f64:

1. triples -> from_triples -> tocsr -> csr_to_dia -> cg(dia @ .) at g = 48;
2. the unstructured path: the g = 16 triples with their unknowns relabelled
   by a seeded permutation -> from_triples -> tocsr -> recommend_format
   ("well") -> to_fast_format -> cg(well @ .), the JAX side through its WELL
   kernel in Pallas interpret mode.

Solutions agree within atol 1e-9; the port's true residual
||b - A x|| / ||b||, through the CSR SpMV, is at most 1e-10.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import sparse_linear_tpu as sl  # noqa: E402
import sparse_linear_tpu_torch as st  # noqa: E402
from sparse_linear_tpu.formats import select as j_select  # noqa: E402
from sparse_linear_tpu.formats.structured import csr_to_dia as j_csr_to_dia  # noqa: E402
from sparse_linear_tpu.solve.cg import cg as j_cg  # noqa: E402
from sparse_linear_tpu_torch.formats.structured import (  # noqa: E402
    csr_to_dia as t_csr_to_dia,
)
from sparse_linear_tpu_torch.formats.well import WELL  # noqa: E402
from sparse_linear_tpu_torch.kernels import spmv_well  # noqa: E402
from sparse_linear_tpu_torch.kernels.spmv_dia import dia_spmv_kernel  # noqa: E402
from sparse_linear_tpu_torch.solve.cg import cg as t_cg  # noqa: E402
from tests.torch_parity import assert_same_leaves, np_of  # noqa: E402


def poisson_triples(g, rng):
    """The 5-point Poisson operator as shuffled triples, with the diagonal
    split into two duplicate entries of 2 (dedup-by-sum restores 4)."""
    n = g * g
    i = np.arange(n)
    ix = i % g
    rows, cols, vals = [i, i], [i, i], [np.full(n, 2.0), np.full(n, 2.0)]
    for off, ok in ((-g, i >= g), (g, i < n - g), (-1, ix > 0),
                    (1, ix < g - 1)):
        rows.append(i[ok])
        cols.append(i[ok] + off)
        vals.append(np.full(int(ok.sum()), -1.0))
    rows, cols, vals = (np.concatenate(a) for a in (rows, cols, vals))
    perm = rng.permutation(rows.size)
    return rows[perm], cols[perm], vals[perm]


def test_slice_triples_to_cg_matches_jax():
    g = 48
    n = g * g
    rng = np.random.default_rng(50)
    rows, cols, vals = poisson_triples(g, rng)
    b = rng.standard_normal(n)

    j_csr = sl.from_triples((n, n), rows, cols, vals).tocsr()
    j_dia = j_csr_to_dia(j_csr)
    rj = j_cg(lambda v: j_dia @ v, jnp.asarray(b), tol=1e-10, maxiter=3000)

    k0 = dia_spmv_kernel.launches
    t_coo = st.from_triples((n, n), rows, cols, vals, device="cpu")
    t_csr = t_coo.tocsr()
    assert st.check_matrix(t_coo) and st.check_matrix(t_csr)
    assert_same_leaves(t_csr, j_csr, atol=0)
    t_dia = t_csr_to_dia(t_csr)
    assert t_dia.offsets == (-g, -1, 0, 1, g)
    assert_same_leaves(t_dia, j_dia, atol=0)
    bt = torch.as_tensor(b)
    rt = t_cg(t_dia.__matmul__, bt, tol=1e-10, maxiter=3000)
    # CPU tensors: the plain version ran, no kernel launch
    assert dia_spmv_kernel.launches == k0

    assert rt.converged and bool(rj.converged)
    assert abs(rt.iterations - int(rj.iterations)) <= 1
    np.testing.assert_allclose(np_of(rt.x), np_of(rj.x), rtol=0, atol=1e-9)
    true_res = float(torch.linalg.vector_norm(bt - st.spmv(t_csr, rt.x))
                     / torch.linalg.vector_norm(bt))
    assert true_res <= 1e-10


def test_slice2_permuted_triples_to_well_cg_matches_jax():
    g = 16
    n = g * g
    rng = np.random.default_rng(51)
    rows, cols, vals = poisson_triples(g, rng)
    perm = rng.permutation(n)
    rows, cols = perm[rows], perm[cols]
    b = rng.standard_normal(n)

    j_csr = sl.from_triples((n, n), rows, cols, vals).tocsr()
    assert j_select.recommend_format(j_csr) == "well"
    j_w = j_select.to_fast_format(j_csr)
    rj = j_cg(lambda v: j_w @ v, jnp.asarray(b), tol=1e-10, maxiter=1000)

    k0 = spmv_well.well_spmv.launches
    t_csr = st.from_triples((n, n), rows, cols, vals, device="cpu").tocsr()
    assert st.check_matrix(t_csr)
    assert_same_leaves(t_csr, j_csr, atol=0)
    assert st.recommend_format(t_csr) == "well"
    t_w = st.to_fast_format(t_csr)
    assert isinstance(t_w, WELL) and t_w.dtype == torch.float64
    np.testing.assert_array_equal(np_of(t_w.todense()), np_of(j_w.todense()))
    bt = torch.as_tensor(b)
    rt = t_cg(t_w.__matmul__, bt, tol=1e-10, maxiter=1000)
    # CPU tensors: the plain version ran, no kernel launch
    assert spmv_well.well_spmv.launches == k0

    assert rt.converged and bool(rj.converged)
    assert abs(rt.iterations - int(rj.iterations)) <= 1
    np.testing.assert_allclose(np_of(rt.x), np_of(rj.x), rtol=0, atol=1e-9)
    true_res = float(torch.linalg.vector_norm(bt - st.spmv(t_csr, rt.x))
                     / torch.linalg.vector_norm(bt))
    assert true_res <= 1e-10
