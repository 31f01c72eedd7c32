"""Parity of the port's ELL and BSR formats (``formats/structured.py``) and
their products (``kernels/spmv.py``: ``ell_spmv``, ``bsr_spmv``,
``bsr_spmm``) with the JAX package, on the CPU.

The same numpy triples go through both packages in f64 and c128 (the
``dtype`` fixture).  The conversions compare leaf by leaf, exactly; the
products within 1e-12 relative (both sum a row's or a block row's terms,
in orders that may differ); error texts word for word.  ELL and BSR are
XLA forms in the JAX package, not ``pallas_call`` sites, so the port's
plain PyTorch forms are what runs on the card too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import sparse_linear_tpu as sl  # noqa: E402
from sparse_linear_tpu.formats import select as jselect  # noqa: E402
from sparse_linear_tpu.formats import structured as jst  # noqa: E402
from sparse_linear_tpu.kernels import spmv as jspmv  # noqa: E402
from sparse_linear_tpu_torch.formats import select as tselect  # noqa: E402
from sparse_linear_tpu_torch.formats import structured as tst  # noqa: E402
from sparse_linear_tpu_torch.interop.jax_state import (  # noqa: E402
    from_arrays,
    to_arrays,
)
from sparse_linear_tpu_torch.kernels import spmv as tspmv  # noqa: E402
from tests.conftest import random_coo  # noqa: E402
from tests.torch_parity import np_of, to_port  # noqa: E402

LEAVES = {"ell": ("cols", "vals"), "bsr": ("indptr", "indices", "blocks")}


def _matrix(rng, nr, nc, dtype, empty_rows=()):
    rows, cols, vals = random_coo(rng, nr, nc, dtype, density=0.2)
    keep = ~np.isin(rows, empty_rows)
    return sl.from_triples((nr, nc), rows[keep], cols[keep],
                           vals[keep]).tocsr()


def _x(rng, shape, dtype):
    x = rng.standard_normal(shape)
    if np.issubdtype(dtype, np.complexfloating):
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def _rel(got, want):
    got, want = np_of(got), np_of(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _same_leaves(t, j, kind):
    for name in LEAVES[kind]:
        a, b = np_of(getattr(t, name)), np_of(getattr(j, name))
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b)
    assert tuple(t.shape) == tuple(j.shape)


def _same_error(exc, f_jax, f_port):
    with pytest.raises(exc) as ej:
        f_jax()
    with pytest.raises(exc) as et:
        f_port()
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("width", [None, 9])
def test_ell_matches_jax(dtype, width):
    """csr_to_ell leaf for leaf (padding: column 0, value 0), todense, and
    ELL @ x against the JAX ell_spmv, with empty rows."""
    rng = np.random.default_rng(80)
    j = _matrix(rng, 30, 20, dtype, empty_rows=(0, 7, 29))
    je = jst.csr_to_ell(j, width=width)
    te = tst.csr_to_ell(to_port(j), width=width)
    _same_leaves(te, je, "ell")
    assert te.width == je.width and te.dtype == to_port(j).dtype
    np.testing.assert_array_equal(np_of(te.todense()), np_of(je.todense()))
    x = _x(rng, 20, dtype)
    y = te @ torch.as_tensor(x)
    assert _rel(y, jspmv.ell_spmv(je, jnp.asarray(x))) <= 1e-12
    assert _rel(y, np_of(j.todense()) @ x) <= 1e-12
    _same_error(ValueError, lambda: jst.csr_to_ell(j, width=2),
                lambda: tst.csr_to_ell(to_port(j), width=2))
    _same_error(ValueError, lambda: jspmv.ell_spmv(je, jnp.ones(19)),
                lambda: tspmv.ell_spmv(te, torch.ones(19)))


@pytest.mark.parametrize("block_shape", [(2, 4), (5, 1), (1, 20)])
def test_bsr_matches_jax(dtype, block_shape):
    """csr_to_bsr leaf for leaf, todense, and BSR @ x / @ X against the JAX
    bsr_spmv / bsr_spmm, with an empty block row."""
    rng = np.random.default_rng(81)
    j = _matrix(rng, 30, 20, dtype, empty_rows=tuple(range(10, 15)))
    jb = jst.csr_to_bsr(j, block_shape=block_shape)
    tb = tst.csr_to_bsr(to_port(j), block_shape=block_shape)
    _same_leaves(tb, jb, "bsr")
    assert tb.block_shape == jb.block_shape == block_shape
    np.testing.assert_array_equal(np_of(tb.todense()), np_of(jb.todense()))
    x = _x(rng, 20, dtype)
    y = tb @ torch.as_tensor(x)
    assert y.shape == (30,)
    assert _rel(y, jspmv.bsr_spmv(jb, jnp.asarray(x))) <= 1e-12
    xm = _x(rng, (20, 3), dtype)
    ym = tb @ torch.as_tensor(xm)
    assert ym.shape == (30, 3)
    assert _rel(ym, jspmv.bsr_spmm(jb, jnp.asarray(xm))) <= 1e-12
    assert _rel(ym, np_of(j.todense()) @ xm) <= 1e-12
    _same_error(ValueError, lambda: jst.csr_to_bsr(j, block_shape=(4, 4)),
                lambda: tst.csr_to_bsr(to_port(j), block_shape=(4, 4)))
    _same_error(ValueError, lambda: jspmv.bsr_spmv(jb, jnp.ones(19)),
                lambda: tspmv.bsr_spmv(tb, torch.ones(19)))


def test_empty_matrix_and_real_operator_times_complex():
    """An all-zero matrix packs to width 0 / no blocks and gives y = 0; a
    real ELL or BSR times a complex x keeps x's imaginary part."""
    z = sl.zeros((8, 16), dtype=np.float64)
    te, tb = tst.csr_to_ell(to_port(z)), tst.csr_to_bsr(to_port(z), (4, 8))
    _same_leaves(te, jst.csr_to_ell(z), "ell")
    _same_leaves(tb, jst.csr_to_bsr(z, (4, 8)), "bsr")
    x = torch.ones(16, dtype=torch.float64)
    assert not bool((te @ x).any()) and not bool((tb @ x).any())
    rng = np.random.default_rng(82)
    j = _matrix(rng, 8, 16, np.float64)
    xc = _x(rng, 16, np.complex128)
    want = np_of(j.todense()) @ xc
    for m in (tst.csr_to_ell(to_port(j)), tst.csr_to_bsr(to_port(j), (4, 8))):
        assert _rel(m @ torch.as_tensor(xc), want) <= 1e-12


@pytest.mark.parametrize("kind", ["ell", "bsr"])
def test_select_branches_match_jax(monkeypatch, kind):
    """to_fast_format keeps the JAX function's ELL and BSR branches (the
    rule never names them; forced here in both packages)."""
    rng = np.random.default_rng(83)
    j = _matrix(rng, 16, 256, np.float64)
    monkeypatch.setattr(jselect, "recommend_format", lambda *a, **k: kind)
    monkeypatch.setattr(tselect, "recommend_format", lambda *a, **k: kind)
    jm, tm = jselect.to_fast_format(j), tselect.to_fast_format(to_port(j))
    assert type(tm).__name__ == type(jm).__name__ == kind.upper()
    _same_leaves(tm, jm, kind)


@pytest.mark.parametrize("kind", ["ell", "bsr"])
def test_jax_state_round_trip(dtype, kind):
    """A JAX ELL / BSR crosses as numpy leaves (kinds "ell" and "bsr"; the
    block shape is the blocks' trailing shape) and back."""
    rng = np.random.default_rng(84)
    j = _matrix(rng, 12, 8, dtype)
    jm = jst.csr_to_ell(j) if kind == "ell" else jst.csr_to_bsr(j, (3, 4))
    arrays = {n: np.asarray(getattr(jm, n)) for n in LEAVES[kind]}
    t = from_arrays(kind, arrays, jm.shape, device="cpu")
    _same_leaves(t, jm, kind)
    if kind == "bsr":
        assert t.block_shape == (3, 4)
    kind2, back, shape, offsets = to_arrays(t)
    assert (kind2, shape, offsets) == (kind, (12, 8), None)
    for name, a in arrays.items():
        np.testing.assert_array_equal(back[name], a)
