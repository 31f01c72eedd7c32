"""Parity of the port's sparse vector (``formats/sparse_vector.py``) with
the JAX package, on the CPU.

The same numpy pairs, with duplicate indices, go through both packages in
f64 and c128 (the ``dtype`` fixture).  Indices compare exactly, values
exactly (duplicates are summed in the same order, and +, - and the union
fold round alike in both), error texts word for word.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sparse_linear_tpu as sl  # noqa: E402
from sparse_linear_tpu.formats import sparse_vector as jsv  # noqa: E402
import sparse_linear_tpu_torch as st  # noqa: E402
from sparse_linear_tpu_torch.formats import sparse_vector as tsv  # noqa: E402
from sparse_linear_tpu_torch.interop.jax_state import (  # noqa: E402
    from_arrays,
    to_arrays,
)
from tests.torch_parity import np_of  # noqa: E402


def _vals(rng, n, dtype):
    v = rng.standard_normal(n)
    if np.issubdtype(dtype, np.complexfloating):
        v = v + 1j * rng.standard_normal(n)
    return v.astype(dtype)


def _pair(length, idx, vals):
    return (sl.from_pairs(length, idx, vals),
            st.from_pairs(length, idx, vals, device="cpu"))


def _same(t, j, atol=0.0):
    assert t.length == j.length and t.nnz == j.nnz
    assert t.indices.dtype == torch.int32
    np.testing.assert_array_equal(np_of(t.indices), np_of(j.indices))
    np.testing.assert_allclose(np_of(t.data), np_of(j.data), rtol=0,
                               atol=atol)


def _same_error(exc, f_jax, f_port):
    with pytest.raises(exc) as ej:
        f_jax()
    with pytest.raises(exc) as et:
        f_port()
    assert str(et.value) == str(ej.value)


def test_from_pairs_dedups_like_jax(dtype):
    rng = np.random.default_rng(70)
    idx = rng.integers(0, 9, 30)  # many duplicate indices
    vals = _vals(rng, 30, dtype)
    j, t = _pair(9, idx, vals)
    _same(t, j)
    assert bool((t.indices[1:] > t.indices[:-1]).all())
    dense = np.zeros(9, dtype)
    np.add.at(dense, idx, vals)
    np.testing.assert_allclose(np_of(t.todense()), dense, rtol=1e-15)
    np.testing.assert_array_equal(np_of(t.todense()), np_of(j.todense()))
    assert t.to_pairs() == j.to_pairs()
    # no pairs, and a tensor input keeps its device
    _same(st.from_pairs(4, [], np.zeros(0, dtype), device="cpu"),
          sl.from_pairs(4, [], np.zeros(0, dtype)))
    tt = st.from_pairs(9, torch.as_tensor(idx), torch.as_tensor(vals))
    _same(tt, j)
    assert tt.data.device.type == "cpu"


def test_from_pairs_errors_match_jax():
    for args in ((2, [5], [1.0]), (3, [0, -1], [1.0, 2.0]),
                 (3, [0, 1], [1.0]), (3, [[0]], [[1.0]])):
        _same_error(ValueError, lambda: sl.from_pairs(*args),
                    lambda: st.from_pairs(*args, device="cpu"))


def test_map_values_conj_neg_scalar_products_match_jax(dtype):
    rng = np.random.default_rng(71)
    j, t = _pair(8, [6, 1, 3, 1], _vals(rng, 4, dtype))
    _same(t.map_values(lambda v: v * 2 + 1), j.map_values(lambda v: v * 2 + 1))
    _same(t.conj(), j.conj())
    _same(-t, -j)
    _same(t * 2.5, j * 2.5)
    _same(2.5 * t, 2.5 * j)
    assert t.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype


def test_union_algebra_matches_jax(dtype):
    """+, -, the reference's union-fold * (A-only slots keep A's value,
    B-only slots become 0 and stay in the pattern), glin and lin."""
    rng = np.random.default_rng(72)
    ja, ta = _pair(10, [4, 1, 1, 3, 9], _vals(rng, 5, dtype))
    jb, tb = _pair(10, [0, 1, 8, 9], _vals(rng, 4, dtype))
    je, te = _pair(10, [], np.zeros(0, dtype))
    for op in (lambda a, b: a + b, lambda a, b: a - b,
               lambda a, b: a * b):
        for (jx, tx), (jy, ty) in (((ja, ta), (jb, tb)), ((jb, tb), (ja, ta)),
                                   ((ja, ta), (je, te)),
                                   ((je, te), (ja, ta))):
            _same(op(tx, ty), op(jx, jy), atol=1e-15)
    _same(tsv.lin(0.5, ta, -2.0, tb), jsv.lin(0.5, ja, -2.0, jb), atol=1e-15)
    fold = (1.0, lambda c, a: c - a, lambda c, b: c * b)
    _same(tsv.glin(fold[0], fold[1], ta, fold[2], tb),
          jsv.glin(fold[0], fold[1], ja, fold[2], jb), atol=1e-15)
    jc, tc = _pair(7, [0], np.ones(1, dtype))
    _same_error(ValueError, lambda: ja + jc, lambda: ta + tc)


def test_concat_is_the_direct_sum(dtype):
    rng = np.random.default_rng(73)
    ja, ta = _pair(3, [0, 2], _vals(rng, 2, dtype))
    jb, tb = _pair(4, [1], _vals(rng, 1, dtype))
    je, te = _pair(0, [], np.zeros(0, dtype))
    for (jx, tx), (jy, ty) in (((ja, ta), (jb, tb)), ((je, te), (ja, ta)),
                               ((jb, tb), (je, te))):
        c = tsv.concat(tx, ty)
        _same(c, jsv.concat(jx, jy))
        np.testing.assert_array_equal(
            np_of(c.todense()),
            np.concatenate([np_of(tx.todense()), np_of(ty.todense())]))


def test_jax_state_round_trip(dtype):
    """A JAX sparse vector crosses as numpy leaves (kind "sparse_vector")
    and back."""
    rng = np.random.default_rng(74)
    j = sl.from_pairs(11, [7, 2, 7, 0], _vals(rng, 4, dtype))
    arrays = {"indices": np.asarray(j.indices), "data": np.asarray(j.data)}
    t = from_arrays("sparse_vector", arrays, (j.length,), device="cpu")
    _same(t, j)
    kind, back, shape, offsets = to_arrays(t)
    assert (kind, shape, offsets) == ("sparse_vector", (11,), None)
    for name, a in arrays.items():
        np.testing.assert_array_equal(back[name], a)
    _same(from_arrays(kind, back, shape, device="cpu"), j)


def test_csr_row_and_csc_col_match_jax(dtype):
    """``CSR.row`` / ``CSC.col`` cut one segment as a sparse vector, as
    the JAX methods do: every row of a random CSR and every column of its
    CSC, empty ones included; an index out of range raises."""
    rng = np.random.default_rng(75)
    nr, nc, n = 7, 9, 20
    rows, cols = rng.integers(0, nr, n), rng.integers(0, nc, n)
    vals = _vals(rng, n, dtype)
    j = sl.from_triples((nr, nc), rows, cols, vals).tocsr()
    t = st.from_triples((nr, nc), rows, cols, vals, device="cpu").tocsr()
    for i in range(nr):
        _same(t.row(i), j.row(i))
    jc, tc = j.tocsc(), t.tocsc()
    for k in range(nc):
        _same(tc.col(k), jc.col(k))
    with pytest.raises(IndexError):
        t.row(nr)
    with pytest.raises(IndexError):
        tc.col(-1)
