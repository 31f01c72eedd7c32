"""Parity of the port's formats core with the JAX package, on the CPU.

The same numpy inputs (from ``np.random.default_rng``) go through both
packages.  Tolerances: index arrays equal; values within atol 1e-12 in
f64/c128 (duplicates are summed in the same sorted order) and 1e-4 in f32.
Every port matrix built here passes ``check_matrix``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import sparse_linear_tpu as sl  # noqa: E402
import sparse_linear_tpu_torch as st  # noqa: E402
from sparse_linear_tpu_torch import dtypes as tdt  # noqa: E402
from sparse_linear_tpu_torch.interop.jax_state import (  # noqa: E402
    from_arrays,
    to_arrays,
)
from tests.conftest import random_coo  # noqa: E402
from tests.torch_parity import (  # noqa: E402
    assert_same_leaves,
    jax_arrays,
    np_of,
    to_jax,
    to_port,
)

SHAPES = [(7, 5), (5, 9), (1, 1), (16, 16)]
DTYPES = [np.float64, np.complex128, np.float32]


def _atol(dtype):
    return 1e-4 if np.dtype(dtype) == np.float32 else 1e-12


def _both_from_triples(shape, rows, cols, vals):
    return (sl.from_triples(shape, rows, cols, vals),
            st.from_triples(shape, rows, cols, vals, device="cpu"))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "c128", "f32"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_from_triples_coo_csr_csc(shape, dtype):
    rng = np.random.default_rng(10)
    rows, cols, vals = random_coo(rng, *shape, dtype)
    # force duplicates: every triple appears again with a new value
    rows = np.concatenate([rows, rows[::-1]])
    cols = np.concatenate([cols, cols[::-1]])
    vals = np.concatenate([vals, vals[::-1] * 0.5]).astype(dtype)
    j, t = _both_from_triples(shape, rows, cols, vals)
    atol = _atol(dtype)
    assert t.nnz == j.nnz < rows.size
    assert_same_leaves(t, j, atol=atol)
    assert st.check_matrix(t)
    for conv in ("tocsr", "tocsc"):
        tm, jm = getattr(t, conv)(), getattr(j, conv)()
        assert st.check_matrix(tm)
        assert_same_leaves(tm, jm, atol=atol)
    np.testing.assert_allclose(np_of(t.tocsr().todense()),
                               np_of(j.tocsr().todense()), atol=atol)
    # round trips between the compressed formats
    back = t.tocsc().tocsr()
    assert st.check_matrix(back)
    assert_same_leaves(back, j.tocsc().tocsr(), atol=atol)


@pytest.mark.parametrize("case", [
    ("row", [0, 1, -1, 2], [0, 0, 0, 0]),
    ("row", [0, 1, 2, 4], [0, 0, 0, 0]),
    ("col", [0, 1, 2, 3], [0, 5, 0, 0]),
    ("col", [0, 1, 2, 3], [0, 0, 0, -3]),
], ids=["row_neg", "row_big", "col_big", "col_neg"])
def test_from_triples_bounds_errors_identical(case):
    _, rows, cols = case
    vals = np.ones(len(rows))
    with pytest.raises(ValueError) as ej:
        sl.from_triples((4, 5), rows, cols, vals)
    with pytest.raises(ValueError) as et:
        st.from_triples((4, 5), rows, cols, vals, device="cpu")
    assert str(et.value) == str(ej.value)
    assert "position" in str(et.value)


def test_from_triples_length_error_identical():
    with pytest.raises(ValueError) as ej:
        sl.from_triples((3, 3), [0, 1], [0], [1.0, 2.0])
    with pytest.raises(ValueError) as et:
        st.from_triples((3, 3), [0, 1], [0], [1.0, 2.0], device="cpu")
    assert str(et.value) == str(ej.value)


def test_from_triples_empty_and_dtype():
    j = sl.from_triples((3, 4), [], [], [], dtype=np.float32)
    t = st.from_triples((3, 4), [], [], [], dtype=np.float32, device="cpu")
    assert t.nnz == j.nnz == 0
    assert t.dtype == torch.float32
    assert st.check_matrix(t) and st.check_matrix(t.tocsr())
    assert_same_leaves(t.tocsr(), j.tocsr())


def test_trim_padded_coo_and_csr():
    rng = np.random.default_rng(11)
    rows, cols, vals = random_coo(rng, 6, 6, np.float64)
    j = sl.from_triples((6, 6), rows, cols, vals).tocsr()
    # the JAX package's tocoo keeps sentinel padding (nnz=None)
    jcoo = j.tocoo()
    pad = sl.COO(row=jnp.concatenate([jcoo.row, jnp.full(3, 6, jnp.int32)]),
                 col=jnp.concatenate([jcoo.col, jnp.full(3, 6, jnp.int32)]),
                 data=jnp.concatenate([jcoo.data, jnp.zeros(3)]),
                 shape=(6, 6), nnz=None)
    tpad = to_port(pad)
    assert tpad.nnz is None
    assert_same_leaves(st.trim(tpad), sl.trim(pad))
    assert st.check_matrix(st.trim(tpad))
    # CSR with capacity past indptr[-1]
    jcsr = sl.CSR(indptr=j.indptr, indices=jnp.concatenate(
        [j.indices, jnp.zeros(4, jnp.int32)]),
        data=jnp.concatenate([j.data, jnp.zeros(4)]), shape=(6, 6))
    tcsr = to_port(jcsr)
    assert tcsr.capacity == j.nnz + 4
    assert_same_leaves(st.trim(tcsr), sl.trim(jcsr))
    assert st.check_matrix(tcsr) and st.check_matrix(st.trim(tcsr))
    # padded inputs convert like the JAX package's, which keeps the padding
    # as capacity (the port's output is exact-size)
    assert_same_leaves(tpad.tocsr(), sl.trim(pad.tocsr()))
    # interior sentinels are refused with the same message
    bad = sl.COO(row=jnp.asarray([0, 6, 1], jnp.int32),
                 col=jnp.asarray([0, 6, 1], jnp.int32),
                 data=jnp.asarray([1.0, 0.0, 2.0]), shape=(6, 6), nnz=None)
    with pytest.raises(ValueError) as ej:
        sl.trim(bad)
    with pytest.raises(ValueError) as et:
        st.trim(to_port(bad))
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("fmt", ["coo", "csr", "csc"])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["f64", "c128"])
def test_from_dense(fmt, dtype):
    rng = np.random.default_rng(12)
    d = rng.standard_normal((6, 8)) * (rng.random((6, 8)) < 0.4)
    d = d.astype(dtype)
    j = sl.from_dense(d, fmt)
    t = st.from_dense(d, fmt, device="cpu")
    assert st.check_matrix(t)
    assert_same_leaves(t, j)
    np.testing.assert_array_equal(np_of(t.todense()), d)


def test_transpose_views_share_buffers():
    rng = np.random.default_rng(13)
    rows, cols, vals = random_coo(rng, 5, 7, np.complex128)
    j, t = _both_from_triples((5, 7), rows, cols, vals)
    tc, jc = t.tocsr(), j.tocsr()
    tt = tc.T
    assert isinstance(tt, st.CSC) and tt.shape == (7, 5)
    assert tt.data.data_ptr() == tc.data.data_ptr()
    assert tt.T.indptr.data_ptr() == tc.indptr.data_ptr()
    assert st.check_matrix(tt)
    assert_same_leaves(tt, jc.T)
    assert_same_leaves(tt.tocsr(), jc.T.tocsr())
    np.testing.assert_allclose(np_of(tt.todense()), np_of(jc.todense()).T,
                               atol=0)
    np.testing.assert_allclose(np_of(tc.ctrans().todense()),
                               np_of(jc.ctrans().todense()), atol=0)
    assert_same_leaves(t.T, j.T)


def test_check_matrix_errors_identical():
    j = sl.from_triples((3, 3), [0, 0, 1], [0, 2, 1], [1.0, 2.0, 3.0]).tocsr()
    broken = [
        sl.CSR(indptr=jnp.asarray([0, 2, 3], jnp.int32), indices=j.indices,
               data=j.data, shape=(3, 3)),
        sl.CSR(indptr=jnp.asarray([1, 2, 3, 3], jnp.int32),
               indices=j.indices, data=j.data, shape=(3, 3)),
        sl.CSR(indptr=jnp.asarray([0, 2, 1, 3], jnp.int32),
               indices=j.indices, data=j.data, shape=(3, 3)),
        sl.CSR(indptr=j.indptr, indices=jnp.asarray([2, 0, 1], jnp.int32),
               data=j.data, shape=(3, 3)),
        sl.CSR(indptr=j.indptr, indices=jnp.asarray([0, 5, 1], jnp.int32),
               data=j.data, shape=(3, 3)),
        sl.CSR(indptr=j.indptr, indices=j.indices, data=j.data[:2],
               shape=(3, 3)),
        sl.COO(row=jnp.asarray([1, 0], jnp.int32),
               col=jnp.asarray([0, 0], jnp.int32),
               data=jnp.asarray([1.0, 2.0]), shape=(3, 3), nnz=2),
        sl.COO(row=jnp.asarray([0, 3], jnp.int32),
               col=jnp.asarray([0, 0], jnp.int32),
               data=jnp.asarray([1.0, 2.0]), shape=(3, 3), nnz=2),
    ]
    for m in broken:
        with pytest.raises(sl.InvariantError) as ej:
            sl.check_matrix(m)
        with pytest.raises(st.InvariantError) as et:
            st.check_matrix(to_port(m))
        assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("kind", ["coo", "csr", "csc", "dia"])
def test_jax_state_round_trip(kind):
    from sparse_linear_tpu.formats.structured import csr_to_dia

    rng = np.random.default_rng(14)
    rows, cols, vals = random_coo(rng, 9, 9, np.float64)
    j = sl.from_triples((9, 9), rows, cols, vals)
    j = {"coo": j, "csr": j.tocsr(), "csc": j.tocsc(),
         "dia": csr_to_dia(j.tocsr(), max_diags=64)}[kind]
    t = to_port(j)
    assert_same_leaves(t, j, atol=0)
    # port -> numpy -> port and port -> JAX give the same matrix back
    t2 = from_arrays(*to_arrays(t), device="cpu")
    assert_same_leaves(t2, j, atol=0)
    j2 = to_jax(t)
    kind2, arrays2, shape2, offs2 = jax_arrays(j2)
    kind1, arrays1, shape1, offs1 = jax_arrays(j)
    assert (kind2, shape2, offs2) == (kind1, shape1, offs1)
    for name in arrays1:
        np.testing.assert_array_equal(arrays2[name], arrays1[name])
    if kind != "dia":
        assert st.check_matrix(t)
    with pytest.raises(ValueError, match="unknown format kind"):
        from_arrays("hyb", {}, (1, 1))


def test_constructors_eye_zeros_diag():
    assert_same_leaves(st.eye(5, dtype=torch.float64, device="cpu"),
                       sl.eye(5, dtype=jnp.float64))
    assert_same_leaves(st.zeros((3, 4), dtype=torch.float64, device="cpu"),
                       sl.zeros((3, 4), dtype=jnp.float64))
    v = np.random.default_rng(15).standard_normal(4)
    assert_same_leaves(st.diag(torch.as_tensor(v), shape=(6, 4)),
                       sl.diag(jnp.asarray(v), shape=(6, 4)))
    for m in (st.eye(5, device="cpu"), st.zeros((3, 4), device="cpu"),
              st.diag(torch.ones(3))):
        assert st.check_matrix(m)
    with pytest.raises(ValueError, match="diag length"):
        st.diag(torch.ones(3), shape=(5, 4))


@pytest.mark.parametrize("fmt", ["coo", "csr", "csc"])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["f64", "c128"])
def test_spmv_spmm_axpy_scale(fmt, dtype):
    rng = np.random.default_rng(16)
    rows, cols, vals = random_coo(rng, 8, 6, dtype)
    j, t = _both_from_triples((8, 6), rows, cols, vals)
    j = {"coo": j, "csr": j.tocsr(), "csc": j.tocsc()}[fmt]
    t = {"coo": t, "csr": t.tocsr(), "csc": t.tocsc()}[fmt]
    x = rng.standard_normal(6).astype(dtype)
    y = rng.standard_normal(8).astype(dtype)
    b = rng.standard_normal((6, 3)).astype(dtype)
    tx, ty, tb = (torch.as_tensor(a) for a in (x, y, b))
    np.testing.assert_allclose(np_of(t @ tx), np_of(j @ x), atol=1e-12)
    np.testing.assert_allclose(np_of(st.spmv(t, tx)), np_of(sl.spmv(j, x)),
                               atol=1e-12)
    np.testing.assert_allclose(np_of(t @ tb), np_of(j @ b), atol=1e-12)
    np.testing.assert_allclose(np_of(st.axpy(t, tx, ty)),
                               np_of(sl.axpy(j, x, y)), atol=1e-12)
    np.testing.assert_allclose(np_of((2.5 * t).todense()),
                               np_of(sl.scale(j, 2.5).todense()), atol=1e-12)
    np.testing.assert_allclose(np_of((-t).todense()),
                               np_of((-j).todense()), atol=0)
    with pytest.raises(ValueError, match="dimension mismatch"):
        st.spmv(t, torch.ones(5, dtype=tx.dtype))


def test_sparse_products_not_ported_yet():
    """``@`` and ``*`` between sparse matrices are SpGEMM and ``+``/``-``
    the union merge, as in the JAX package (the name is kept from when the
    union merge was not ported)."""
    t = st.eye(3, device="cpu")
    j = sl.eye(3, dtype=np.float32)
    for op in (lambda a: a @ a, lambda a: a * a, lambda a: a + a,
               lambda a: a - a, lambda a: a + 2.0 * a - a):
        assert_same_leaves(op(t), op(j), atol=0)


def _union_pair(dtype, seed):
    """Two random matrices whose patterns overlap in part, with one shared
    entry that cancels to zero in A + B and in A - (-B)."""
    rng = np.random.default_rng(seed)
    ra, ca, va = random_coo(rng, 7, 6, dtype)
    rb, cb, vb = random_coo(rng, 7, 6, dtype)
    rb = np.concatenate([rb, ra[:1]])
    cb = np.concatenate([cb, ca[:1]])
    vb = np.concatenate([vb, -va[:1]]).astype(dtype)
    return ((ra, ca, va), (rb, cb, vb))


@pytest.mark.parametrize("fmt", ["coo", "csr", "csc"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "c128", "f32"])
def test_lin_add_sub_match_jax(dtype, fmt):
    from sparse_linear_tpu.ops import linalg as jlinalg
    from sparse_linear_tpu_torch.ops import linalg as tlinalg

    (ra, ca, va), (rb, cb, vb) = _union_pair(dtype, 17)
    ja, ta = _both_from_triples((7, 6), ra, ca, va)
    jb, tb = _both_from_triples((7, 6), rb, cb, vb)
    ja, jb = (getattr(m, f"to{fmt}")() for m in (ja, jb))
    ta, tb = (getattr(m, f"to{fmt}")() for m in (ta, tb))
    atol = _atol(dtype)
    alpha = 0.5 - 2j if np.dtype(dtype).kind == "c" else -1.5
    pairs = [(tlinalg.lin(alpha, ta, 2.0, tb), jlinalg.lin(alpha, ja, 2.0, jb)),
             (tlinalg.add(ta, tb), jlinalg.add(ja, jb)),
             (ta + tb, ja + jb), (ta - tb, ja - jb),
             (tlinalg.lin(1, tb, 0, ta), jlinalg.lin(1, jb, 0, ja))]
    for got, want in pairs:
        assert got.dtype == tdt.as_torch_dtype(want.dtype)
        assert_same_leaves(got, jax_trimmed(want), atol=atol)
        assert st.check_matrix(got)
    # the shared entry that cancels stays in the union pattern, as zero
    s = tlinalg.add(ta, tb).tocsr()
    r0, c0 = int(ra[0]), int(ca[0])
    row = np_of(s.indices[int(s.indptr[r0]):int(s.indptr[r0 + 1])])
    k = int(s.indptr[r0]) + int(np.nonzero(row == c0)[0][0])
    assert abs(complex(np_of(s.data)[k])) <= atol
    with pytest.raises(ValueError, match="shape mismatch"):
        tlinalg.add(ta, st.eye(7, device="cpu"))


def jax_trimmed(m):
    from sparse_linear_tpu.ops.build import trim

    return trim(m)


@pytest.mark.parametrize("case", ["real_sym", "real_nonsym", "herm",
                                  "complex_sym", "rect", "near"])
def test_is_hermitian_matches_jax(case):
    rng = np.random.default_rng(18)
    n = 6
    if case == "rect":
        d = rng.standard_normal((4, 5))
    else:
        d = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.5)
        if case in ("herm", "complex_sym"):
            d = d + 1j * rng.standard_normal((n, n)) * (d != 0)
        if case in ("real_sym", "near"):
            d = d + d.T
        elif case == "herm":
            d = d + d.conj().T
        elif case == "complex_sym":
            d = d + d.T
    jm = sl.from_dense(jnp.asarray(d))
    tm = st.from_dense(torch.as_tensor(d))
    if case == "near":
        # one value off by 1e-13: equal within tol 1e-12, not exactly
        tm = tm.map_values(lambda v: v + 1e-13 * (torch.arange(
            v.shape[0]) == 0))
        jm = to_jax(tm)
    for tol in (0.0, 1e-12):
        assert tm.is_hermitian(tol) == bool(jm.is_hermitian(tol))
    expect = {"real_sym": True, "real_nonsym": False, "herm": True,
              "complex_sym": False, "rect": False, "near": False}[case]
    assert tm.is_hermitian() is expect
    assert tm.tocsc().is_hermitian() is expect


def test_to_device_and_dtypes():
    t = st.from_triples((2, 2), [0, 1], [1, 0], [1.0, 2.0],
                        device="cpu").tocsr()
    moved = t.to("cpu")
    assert moved.device == torch.device("cpu")
    assert moved.shape == t.shape
    assert tdt.real_of(torch.complex64) == torch.float32
    assert tdt.complex_of(np.float64) == torch.complex128
    assert tdt.is_complex(torch.complex128) and not tdt.is_complex(
        torch.float32)
    z = torch.tensor([1 + 2j, -3j])
    np.testing.assert_array_equal(np_of(tdt.conj(z)), np.conj(np_of(z)))
    np.testing.assert_array_equal(np_of(tdt.imag(torch.ones(2))), [0, 0])
    np.testing.assert_allclose(np_of(tdt.mag(z)), [5 ** 0.5, 3])
    with pytest.raises(TypeError):
        tdt.real_of(torch.int32)
