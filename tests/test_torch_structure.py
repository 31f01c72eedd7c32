"""Parity of the port's structural algebra (``ops/structure.py``), its
``elementwise_mul`` and the matrix methods ``abs``, ``signum``,
``reduce_values`` and ``sum_values`` with the JAX package, on the CPU.

The same numpy triples, with duplicate coordinates, go through both
packages; each case runs in f64 and c128 (the ``dtype`` fixture).  Results
are compared leaf by leaf after ``trim``: index arrays exactly, values
exactly where an op copies them and within 1e-14 where it multiplies two
(``kron``, ``outer``, ``elementwise_mul``: torch and XLA round a complex
product differently in the last bit), error texts word for word.  Edge cases follow
``tests/test_ops.py`` and ``tests/test_property.py``: empty blocks, 0 x n
operands, all-zero matrices, rectangular shapes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sparse_linear_tpu as sl  # noqa: E402
import sparse_linear_tpu_torch as st  # noqa: E402
from tests.conftest import random_coo  # noqa: E402
from tests.torch_parity import assert_same_leaves, np_of, to_port  # noqa: E402


def _pair(rng, nr, nc, dtype, density=0.25):
    """(JAX CSR, port CSR) of the same random triples with duplicates (of
    no triples where a side is 0)."""
    if nr == 0 or nc == 0:
        return _empty(nr, nc, dtype)
    rows, cols, vals = random_coo(rng, nr, nc, dtype, density)
    j = sl.from_triples((nr, nc), rows, cols, vals).tocsr()
    return j, to_port(j)


def _empty(nr, nc, dtype):
    j = sl.zeros((nr, nc), dtype=dtype)
    return j, st.zeros((nr, nc), dtype=dtype, device="cpu")


def _same(t, j, atol=0.0):
    """Same format, shape, index leaves and values as the JAX result."""
    assert type(t).__name__ == type(j).__name__
    assert_same_leaves(t, sl.trim(j), atol=atol)
    assert st.check_matrix(t)


def _same_error(exc, f_jax, f_port):
    with pytest.raises(exc) as ej:
        f_jax()
    with pytest.raises(exc) as et:
        f_port()
    assert str(et.value) == str(ej.value)


def test_vcat_hcat_match_jax(dtype):
    rng = np.random.default_rng(60)
    a, b, c = (_pair(rng, *s, dtype) for s in ((4, 5), (3, 5), (4, 2)))
    z05, z40 = _empty(0, 5, dtype), _empty(4, 0, dtype)
    zz = _empty(2, 5, dtype)
    for mats in ([a, b], [a, z05, b, zz], [z05, z05]):
        _same(st.vcat([m[1] for m in mats]), sl.vcat([m[0] for m in mats]))
    for mats in ([a, c], [a, z40, c]):
        _same(st.hcat([m[1] for m in mats]), sl.hcat([m[0] for m in mats]))
    _same_error(ValueError, lambda: sl.vcat([a[0], c[0]]),
                lambda: st.vcat([a[1], c[1]]))
    _same_error(ValueError, lambda: sl.vcat([]), lambda: st.vcat([]))


def test_from_blocks_matches_jax(dtype):
    rng = np.random.default_rng(61)
    a, d = _pair(rng, 2, 3, dtype), _pair(rng, 4, 1, dtype)
    e = _pair(rng, 2, 1, np.float64)  # promoted to the grid's dtype
    grid = [[a, None], [None, d]]
    _same(st.from_blocks([[m and m[1] for m in r] for r in grid]),
          sl.from_blocks([[m and m[0] for m in r] for r in grid]))
    grid = [[a, e], [None, d]]
    _same(st.from_blocks([[m and m[1] for m in r] for r in grid]),
          sl.from_blocks([[m and m[0] for m in r] for r in grid]))
    bad = _pair(rng, 3, 3, dtype)
    for rows in ([[None, None], [None, d]], [[a, bad]], [], [[a], [a, a]],
                 [[a, None], [bad, None]]):
        _same_error(ValueError,
                    lambda: sl.from_blocks([[m and m[0] for m in r]
                                            for r in rows]),
                    lambda: st.from_blocks([[m and m[1] for m in r]
                                            for r in rows]))


def test_from_blocks_diag_and_block_diag_match_jax(dtype):
    rng = np.random.default_rng(62)
    a, b, c = (_pair(rng, *s, dtype) for s in ((2, 2), (3, 3), (2, 3)))
    # cyclic placement: blocks[d][i] at (i, (i + d) mod n)
    ct = (c[0].T.tocsr(), c[1].T.tocsr())
    blocks = [[a, b], [c, ct]]
    _same(st.from_blocks_diag([[m[1] for m in r] for r in blocks]),
          sl.from_blocks_diag([[m[0] for m in r] for r in blocks]))
    _same(st.from_blocks_diag([[a[1], b[1]], [None, None]]),
          sl.from_blocks_diag([[a[0], b[0]], [None, None]]))
    _same(st.block_diag([a[1], b[1], c[1]]),
          sl.block_diag([a[0], b[0], c[0]]))


@pytest.mark.parametrize("shapes", [((3, 4), (2, 5)), ((1, 1), (4, 4)),
                                    ((0, 3), (2, 2))],
                         ids=["rect", "scalar_block", "empty"])
def test_kron_matches_jax(dtype, shapes):
    rng = np.random.default_rng(63)
    (ja, ta), (jb, tb) = (_pair(rng, *s, dtype, density=0.4) for s in shapes)
    _same(st.kron(ta, tb), sl.kron(ja, jb), atol=1e-14)
    _same(st.kron(tb, ta.tocsc()), sl.kron(jb, ja.tocsc()), atol=1e-14)
    np.testing.assert_allclose(
        np_of(st.kron(ta, tb).todense()),
        np.kron(np_of(ta.todense()), np_of(tb.todense())), rtol=0,
        atol=1e-14)
    eye = st.kron(st.eye(3, dtype=dtype, device="cpu"),
                  st.eye(4, dtype=dtype, device="cpu"))
    np.testing.assert_array_equal(np_of(eye.todense()), np.eye(12))


def test_kron_builds_the_gauge_operator_bitwise():
    """kron(I, T_theta) + kron(T, I) on the port equals, leaf for leaf and
    bit for bit, the gauge-transformed Poisson operator from triples (the
    construction ``chip_smoke.py`` checks at 2048**2 on the card)."""
    g, theta = 7, 0.3

    def chain(th):
        lo, hi = list(range(g - 1)), list(range(1, g))
        return st.from_triples(
            (g, g), list(range(g)) + lo + hi, list(range(g)) + hi + lo,
            np.array([2.0] * g + [-np.exp(1j * th)] * (g - 1)
                     + [-np.exp(-1j * th)] * (g - 1)), device="cpu").tocsr()

    eye = st.eye(g, dtype=torch.complex128, device="cpu")
    t = st.kron(eye, chain(theta)) + st.kron(chain(0.0), eye)
    p = np.arange(g * g)
    right, up = p[p % g < g - 1], p[p < g * g - g]
    triples = st.from_triples(
        (g * g, g * g), np.concatenate([p, right, right + 1, up, up + g]),
        np.concatenate([p, right + 1, right, up + g, up]),
        np.concatenate([np.full(g * g, 4.0 + 0j),
                        np.full(right.size, -np.exp(1j * theta)),
                        np.full(right.size, -np.exp(-1j * theta)),
                        np.full(2 * up.size, -1.0 + 0j)]),
        device="cpu").tocsr()
    for name in ("indptr", "indices", "data"):
        assert torch.equal(getattr(t, name), getattr(triples, name)), name
    assert t.is_hermitian()


@pytest.mark.parametrize("shape", [(5, 7), (7, 5), (0, 4)])
def test_take_diag_matches_jax(dtype, shape):
    j, t = _pair(np.random.default_rng(64), *shape, dtype, density=0.5)
    np.testing.assert_array_equal(np_of(st.take_diag(t)),
                                  np_of(sl.take_diag(j)))
    np.testing.assert_array_equal(np_of(st.take_diag(t.tocoo())),
                                  np_of(sl.take_diag(j.tocoo())))


def test_outer_matches_jax(dtype):
    vals = np.asarray([2, 5, 7], dtype=dtype)
    if np.issubdtype(dtype, np.complexfloating):
        vals = vals * (1 + 0.5j)
    jc = sl.from_pairs(4, [1, 3, 1], vals)
    jr = sl.from_pairs(3, [0, 2], vals[:2])
    tc = st.from_pairs(4, [1, 3, 1], vals, device="cpu")
    tr = st.from_pairs(3, [0, 2], vals[:2], device="cpu")
    _same(st.outer(tc, tr), sl.outer(jc, jr), atol=1e-14)
    te = st.from_pairs(3, [], np.zeros(0, dtype), device="cpu")
    je = sl.from_pairs(3, [], np.zeros(0, dtype))
    _same(st.outer(tc, te), sl.outer(jc, je))


@pytest.mark.parametrize("box", [(2, 6, 3, 8), (0, 9, 0, 9), (4, 4, 1, 5),
                                 (8, 9, 8, 9)])
def test_submatrix_matches_jax(dtype, box):
    j, t = _pair(np.random.default_rng(65), 9, 9, dtype, density=0.4)
    _same(st.submatrix(t, *box), sl.submatrix(j, *box))


def test_columns_and_rows_round_trip_match_jax(dtype):
    rng = np.random.default_rng(66)
    j, t = _pair(rng, 6, 4, dtype, density=0.3)
    for tv, jv in zip(st.to_columns(t), sl.to_columns(j)):
        assert tv.length == jv.length == 6
        np.testing.assert_array_equal(np_of(tv.indices), np_of(jv.indices))
        np.testing.assert_array_equal(np_of(tv.data), np_of(jv.data))
    _same(st.from_columns(st.to_columns(t)),
          sl.from_columns(sl.to_columns(j)))
    rows_t, rows_j = st.to_rows(t), sl.to_rows(j)
    assert len(rows_t) == len(rows_j) == 6
    for tv, jv in zip(rows_t, rows_j):
        assert tv.length == jv.length == 4
        np.testing.assert_array_equal(np_of(tv.indices), np_of(jv.indices))
        np.testing.assert_array_equal(np_of(tv.data), np_of(jv.data))
    _same(st.from_rows(rows_t), sl.from_rows(rows_j))
    # all-empty columns: the port keeps the columns' dtype
    ze = st.from_columns(st.to_columns(st.zeros((3, 2), dtype=dtype,
                                                device="cpu")))
    assert ze.shape == (3, 2) and ze.nnz == 0
    assert ze.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
    _same_error(ValueError, lambda: sl.from_columns([]),
                lambda: st.from_columns([]))
    _same_error(ValueError,
                lambda: sl.from_columns([sl.to_columns(j)[0],
                                         sl.from_pairs(2, [0], [1.0])]),
                lambda: st.from_columns([st.to_columns(t)[0],
                                         st.from_pairs(2, [0], [1.0],
                                                       device="cpu")]))


def test_elementwise_mul_matches_jax(dtype):
    """The reference's union fold: A-only slots keep A's value, B-only
    slots become 0 and stay in the pattern."""
    rng = np.random.default_rng(67)
    (ja, ta), (jb, tb) = (_pair(rng, 6, 5, dtype, density=0.3)
                          for _ in range(2))
    _same(st.elementwise_mul(ta.tocoo(), tb.tocsc()),
          sl.elementwise_mul(ja.tocoo(), jb.tocsc()), atol=1e-14)
    _same_error(ValueError, lambda: sl.elementwise_mul(ja, ja.T),
                lambda: st.elementwise_mul(ta, ta.T))


@pytest.mark.parametrize("fmt", ["coo", "csr", "csc"])
def test_matrix_methods_match_jax(dtype, fmt):
    """abs, signum (x / |x| for complex, 0 at 0), reduce_values (the
    vector folds and the exact left fold) and sum_values."""
    rng = np.random.default_rng(68)
    rows, cols, vals = random_coo(rng, 5, 6, dtype)
    vals[:2] = 0  # stored zeros: signum 0, abs 0
    j = getattr(sl.from_triples((5, 6), rows, cols, vals), f"to{fmt}")()
    t = to_port(j)
    for op in (abs, lambda m: m.signum()):
        np.testing.assert_allclose(np_of(op(t).todense()),
                                   np_of(op(j).todense()), rtol=1e-15,
                                   atol=0)
    np.testing.assert_allclose(complex(t.sum_values()),
                               complex(j.sum_values()), atol=1e-12)
    import operator

    for f, init in ((np.add, 0.5), (operator.add, 0.0),
                    (np.multiply, 1.0), (torch.add, 0.0)):
        jf = np.add if f is torch.add else f
        np.testing.assert_allclose(complex(t.reduce_values(f, init)),
                                   complex(j.reduce_values(jf, init)),
                                   rtol=1e-15)
    if dtype == np.float64:
        for f in (np.maximum, np.minimum, torch.maximum):
            jf = np.maximum if f is torch.maximum else f
            assert t.reduce_values(f, -1e300) == j.reduce_values(jf, -1e300)
    # any other f: the exact sequential left fold
    seq = lambda acc, v: acc * 0.5 + v  # noqa: E731
    assert complex(t.reduce_values(seq, 1.0)) == complex(
        j.reduce_values(seq, 1.0))
    empty = st.zeros((3, 3), dtype=dtype, device="cpu")
    assert empty.reduce_values(np.add, 7.0) == 7.0
    assert complex(empty.sum_values()) == 0


def test_new_names_are_exported():
    """The port exports the JAX package's op surface by the same names."""
    for name in sl.__all__:
        assert hasattr(st, name), name
