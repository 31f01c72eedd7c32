"""Parity of the port's interop with the JAX package, on the CPU:
``interop.scipy_io`` (scipy.sparse and raw-array round trips, against the
JAX package's own exports), and ``interop.jax_state`` carrying a JAX WELL
or WELL64 packing across, after which both compute the same y.

Tolerances: exports and round trips are exact; y agrees within
max |y - y_jax| / max |y_jax| <= 1e-5 in f32 and complex64 (f32 sums in
another order) and 1e-12 in f64 against the JAX double-float kernel.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
sp = pytest.importorskip("scipy.sparse")

import jax.numpy as jnp  # noqa: E402

import sparse_linear_tpu as sl  # noqa: E402
from sparse_linear_tpu.formats.well import csr_to_well as j_csr_to_well  # noqa: E402
from sparse_linear_tpu.interop import scipy_io as jio  # noqa: E402
from sparse_linear_tpu.kernels import spmv_well as jk  # noqa: E402
from sparse_linear_tpu.kernels import spmv_well64 as jk64  # noqa: E402
import sparse_linear_tpu_torch as st  # noqa: E402
from sparse_linear_tpu_torch.formats.well import WELL  # noqa: E402
from sparse_linear_tpu_torch.interop import jax_state  # noqa: E402
from sparse_linear_tpu_torch.interop import scipy_io as tio  # noqa: E402
from sparse_linear_tpu_torch.kernels.spmv_well64 import WELL64  # noqa: E402
from tests.conftest import random_coo  # noqa: E402
from tests.torch_parity import (  # noqa: E402
    jax_arrays,
    np_of,
    permuted_poisson,
    to_port,
)


def _jax_mat(rng, fmt, dtype, shape=(7, 9)):
    m = sl.from_triples(shape, *random_coo(rng, *shape, dtype)).tocsr()
    return getattr(m, f"to{fmt}")()


@pytest.mark.parametrize("fmt", ["csr", "csc", "coo"])
def test_scipy_roundtrip_matches_jax(fmt, dtype):
    rng = np.random.default_rng(60)
    j = _jax_mat(rng, fmt, dtype)
    t = to_port(j)
    jsp, tsp = jio.to_scipy(j), tio.to_scipy(t)
    assert tsp.format == jsp.format == fmt
    assert tsp.dtype == jsp.dtype and tsp.shape == jsp.shape
    np.testing.assert_array_equal(tsp.toarray(), jsp.toarray())
    back = tio.from_scipy(tsp, device="cpu")
    assert type(back).__name__ == type(j).__name__
    np.testing.assert_array_equal(np_of(back.todense()), np_of(j.todense()))
    assert st.check_matrix(back if fmt != "coo" else st.trim(back))


@pytest.mark.parametrize("fmt", ["csr", "csc", "coo"])
def test_arrays_roundtrip_matches_jax(fmt, dtype):
    rng = np.random.default_rng(61)
    j = _jax_mat(rng, fmt, dtype)
    t = to_port(j)
    dj, dt = jio.to_arrays(j), tio.to_arrays(t)
    assert dt.keys() == dj.keys()
    assert dt["format"] == dj["format"] and tuple(dt["shape"]) == tuple(
        dj["shape"])
    for k in dj:
        if k not in ("format", "shape"):
            np.testing.assert_array_equal(dt[k], np.asarray(dj[k]))
    back = tio.from_arrays(dt, device="cpu")
    np.testing.assert_array_equal(np_of(back.todense()), np_of(j.todense()))
    jback = jio.from_arrays(dt)
    np.testing.assert_array_equal(np_of(jback.todense()), np_of(j.todense()))


def test_scipy_import_renormalizes():
    """Duplicates are summed and the result is canonical, as in the JAX
    package."""
    m = sp.coo_matrix((np.array([1.0, 2.0, 5.0]),
                       (np.array([0, 0, 1]), np.array([0, 0, 1]))),
                      shape=(2, 2))
    back = tio.from_scipy(m, fmt="csr", device="cpu")
    assert st.check_matrix(back)
    np.testing.assert_array_equal(np_of(back.todense()),
                                  np_of(jio.from_scipy(m, fmt="csr")
                                        .todense()))
    assert isinstance(tio.from_scipy(m, device="cpu"), st.COO)
    assert isinstance(tio.from_scipy(m, fmt="csc", device="cpu"), st.CSC)
    assert tio.from_scipy(m, device="cpu").data.device.type == "cpu"
    with pytest.raises(ValueError, match="unknown format"):
        tio.from_scipy(m, fmt="bsr", device="cpu")
    with pytest.raises(ValueError, match="unknown format"):
        tio.from_arrays({"format": "ell", "shape": (2, 2)}, device="cpu")
    with pytest.raises(TypeError, match="unsupported"):
        tio.to_scipy(st.csr_to_well(back))


# ------------------------------------------------ a JAX WELL carried across


@pytest.mark.parametrize("which", ["f32", "c64", "rect_f32"])
def test_jax_well_carried_across(which):
    rng = np.random.default_rng(62)
    if which == "f32":
        j = permuted_poisson(16, np.float32)
    elif which == "c64":
        j = permuted_poisson(16, np.complex64)
    else:
        j = sl.from_triples((150, 1300),
                            *random_coo(rng, 150, 1300, np.float64,
                                        density=0.004)).tocsr()
        j = j.map_values(lambda v: v.astype(np.float32))
    jw = j_csr_to_well(j)
    kind, arrays, shape, _ = jax_arrays(jw)
    assert kind == "well" and ("vals_im" in arrays) == (which == "c64")
    tw = jax_state.from_arrays(kind, arrays, shape, device="cpu")
    assert isinstance(tw, WELL) and tw.shape == tuple(j.shape)
    assert tw.vals.dtype == to_port(j).data.dtype
    np.testing.assert_array_equal(np_of(tw.todense()), np_of(j.todense()))
    x = rng.standard_normal(shape[1]).astype(np.float32)
    if which == "c64":
        x = (x + 1j * rng.standard_normal(shape[1])).astype(np.complex64)
    yj = np_of(jk.well_spmv(jw, jnp.asarray(x)))
    yt = np_of(tw @ torch.as_tensor(x))
    assert np.abs(yt - yj).max() <= 1e-5 * np.abs(yj).max()


def test_jax_well64_carried_across():
    """hi + lo planes summed in f64 restore the values to ~2**-48 relative
    (the two f32 planes carry 48 of f64's 53 significand bits)."""
    rng = np.random.default_rng(63)
    j = permuted_poisson(16, np.float64)
    j = j.map_values(lambda v: v * jnp.asarray(
        1 + 1e-3 * rng.standard_normal(v.shape[0])))
    jw = jk64.csr_to_well64(j)
    kind, arrays, shape, _ = jax_arrays(jw)
    assert kind == "well64"
    tw = jax_state.from_arrays(kind, arrays, shape, device="cpu")
    assert isinstance(tw, WELL64) and tw.vals.dtype == torch.float64
    np.testing.assert_allclose(np_of(tw.todense()), np_of(j.todense()),
                               rtol=2.0 ** -46, atol=0)
    x = rng.standard_normal(shape[1])
    yj = np_of(jk64.well_spmv64(jw, jnp.asarray(x)))
    yt = np_of(tw @ torch.as_tensor(x))
    assert np.abs(yt - yj).max() <= 1e-12 * np.abs(yj).max()


def test_jax_state_well_errors():
    with pytest.raises(ValueError, match=r"missing leaves \['vals_lo'\]"):
        jax_state.from_arrays("well64", {"bases": 0, "idx": 0, "vals": 0},
                              (4, 4), device="cpu")
    assert "well" in jax_state.KINDS and "well64" in jax_state.KINDS
    with pytest.raises(TypeError, match="unknown format"):
        jax_state.to_arrays(st.csr_to_well(st.eye(3, device="cpu")))
