"""Parity of the port's SpGEMM with the JAX package, on the CPU: the
sort-based ``spgemm`` (and the ``@``/``*`` operators that route to it) and
the staged ``spgemm_plan_well`` / ``spgemm_apply_well``.

The JAX staged form runs its three WELL SpMVs in Pallas interpret mode,
which compiles each shape for ~10 s, so its operator is the 8**2 five-point
operator with its unknowns relabelled by a seeded permutation (about 1400
products).  Patterns must be identical (indptr and indices equal); values
agree within atol 1e-12 (f64 and c128 sums in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import sparse_linear_tpu as sl  # noqa: E402
from sparse_linear_tpu.ops import spgemm as jsg  # noqa: E402
import sparse_linear_tpu_torch as st  # noqa: E402
from sparse_linear_tpu_torch.kernels import _build  # noqa: E402
from sparse_linear_tpu_torch.kernels import spmv_well as tk  # noqa: E402
from sparse_linear_tpu_torch.ops import spgemm as tsg  # noqa: E402
from tests.conftest import random_coo  # noqa: E402
from tests.torch_parity import (  # noqa: E402
    assert_same_leaves,
    np_of,
    permuted_poisson,
    to_port,
)


@pytest.fixture(autouse=True)
def _no_launches():
    c0 = tk.well_spmv.launches
    yield
    assert tk.well_spmv.launches == c0
    assert _build.load_library.cache_info().currsize == 0


def _pair(rng, dtype, shapes=((7, 5), (5, 9))):
    (nr, nk), (_, nc) = shapes
    a = sl.from_triples((nr, nk), *random_coo(rng, nr, nk, dtype)).tocsr()
    b = sl.from_triples((nk, nc), *random_coo(rng, nk, nc, dtype)).tocsr()
    return a, b


def _assert_same_csr(t, j, atol=1e-12):
    np.testing.assert_array_equal(np_of(t.indptr), np_of(j.indptr))
    np.testing.assert_array_equal(np_of(t.indices), np_of(j.indices))
    np.testing.assert_allclose(np_of(t.data), np_of(j.data), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("shapes", [((7, 5), (5, 9)), ((12, 12), (12, 12)),
                                    ((1, 6), (6, 1))])
def test_spgemm_matches_jax(dtype, shapes):
    rng = np.random.default_rng(40)
    a, b = _pair(rng, dtype, shapes)
    jc = jsg.spgemm(a, b)
    ta, tb = to_port(a), to_port(b)
    tc = tsg.spgemm(ta, tb)
    assert st.check_matrix(tc)
    assert_same_leaves(tc, jc)
    # the operators route to spgemm, as in the JAX package
    assert_same_leaves(ta @ tb, jc)
    assert_same_leaves(ta * tb, a * b)
    # a CSC or COO operand is taken through CSR
    assert_same_leaves(tsg.spgemm(ta.tocsc(), tb.tocoo()), jc)


def test_spgemm_plan_reuse(dtype):
    rng = np.random.default_rng(41)
    a, b = _pair(rng, dtype)
    ta, tb = to_port(a), to_port(b)
    plan = tsg.spgemm_plan(ta, tb)
    jplan = jsg.spgemm_plan(a, b)
    assert plan.n_products == jplan.n_products and plan.shape == jplan.shape
    np.testing.assert_array_equal(np_of(plan.slot_start),
                                  np_of(jplan.slot_start))
    a2 = a.map_values(lambda v: v * 2.0 - 1.0)
    ta2 = to_port(a2)
    _assert_same_csr(st.trim(tsg.spgemm_apply(plan, ta2, tb)),
                     jsg.spgemm(a2, b))


def test_spgemm_empty_product():
    a = sl.zeros((3, 4), dtype=np.float64).tocsr()
    b = sl.eye(4, dtype=np.float64).tocsr()
    jc = jsg.spgemm(a, b)
    tc = tsg.spgemm(to_port(a), to_port(b))
    assert tc.shape == jc.shape == (3, 4) and tc.nnz == jc.nnz == 0
    with pytest.raises(ValueError) as ej:
        jsg.spgemm_plan_well(a, b)
    with pytest.raises(ValueError) as et:
        tsg.spgemm_plan_well(to_port(a), to_port(b))
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("fn", ["spgemm", "spgemm_plan", "spgemm_plan_well"])
def test_inner_dimension_error_matches_jax(fn):
    a = sl.eye(4, dtype=np.float64).tocsr()
    b = sl.eye(5, dtype=np.float64).tocsr()
    with pytest.raises(ValueError) as ej:
        getattr(jsg, fn)(a, b)
    with pytest.raises(ValueError) as et:
        getattr(tsg, fn)(to_port(a), to_port(b))
    assert str(et.value) == str(ej.value)
    assert "inner dimension mismatch" in str(et.value)


# ------------------------------------------------------------------ staged


@pytest.fixture(scope="module")
def staged():
    """The permuted 8**2 operator A and the staged plans of A @ A in both
    packages."""
    j = permuted_poisson(8, np.float64, seed=3)
    t = to_port(j)
    return j, t, jsg.spgemm_plan_well(j, j), tsg.spgemm_plan_well(t, t)


def test_staged_plan_matches_jax(staged):
    j, t, jplan, tplan = staged
    assert tplan.shape == jplan.shape
    assert (tplan.t_products, tplan.nnz_out) == (jplan.t_products,
                                                 jplan.nnz_out)
    np.testing.assert_array_equal(np_of(tplan.c_indptr),
                                  np_of(jplan.c_indptr))
    np.testing.assert_array_equal(np_of(tplan.c_indices),
                                  np_of(jplan.c_indices))
    # the three 0/1 operators store the same matrices
    for name in ("wa", "wb", "wc"):
        tw, jw = getattr(tplan, name), getattr(jplan, name)
        assert tw.shape == jw.shape
        np.testing.assert_array_equal(np_of(tw.todense()),
                                      np_of(jw.todense()))


def test_staged_apply_matches_jax_and_sort_based(staged):
    j, t, jplan, tplan = staged
    jc = jsg.spgemm_apply_well(jplan, j.data, j.data)
    tc = tsg.spgemm_apply_well(tplan, t.data, t.data)
    _assert_same_csr(tc, jc)
    assert st.check_matrix(tc)
    _assert_same_csr(tc, tsg.spgemm(t, t))
    # plan reuse: new values on the same patterns
    rng = np.random.default_rng(42)
    v1 = rng.standard_normal(t.nnz)
    v2 = rng.standard_normal(t.nnz)
    jc2 = jsg.spgemm_apply_well(jplan, jnp.asarray(v1), jnp.asarray(v2))
    tc2 = tsg.spgemm_apply_well(tplan, torch.as_tensor(v1),
                                torch.as_tensor(v2))
    _assert_same_csr(tc2, jc2)
    ref = tsg.spgemm(t.map_values(lambda _: torch.as_tensor(v1)),
                     t.map_values(lambda _: torch.as_tensor(v2)))
    _assert_same_csr(tc2, ref)


def test_staged_apply_complex_values(staged):
    """Complex values ride the same real plan (plain path on the CPU)."""
    _, t, _, tplan = staged
    rng = np.random.default_rng(43)
    v = torch.as_tensor(rng.standard_normal(t.nnz)
                        + 1j * rng.standard_normal(t.nnz))
    tc = tsg.spgemm_apply_well(tplan, v, t.data)
    assert tc.data.dtype == torch.complex128
    _assert_same_csr(tc, tsg.spgemm(t.map_values(lambda _: v), t))
