"""Parity of the port's CG and entry step with the JAX package, on the CPU.

Tolerances: CG at tol 1e-10 in f64 reaches iteration counts within 1 of
each other and solutions within atol 1e-9 (the two packages round the
in-place updates differently); the one-step entry in f32 agrees to rtol
1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sparse_linear_tpu.solve import cg as jcg  # noqa: E402
from sparse_linear_tpu.utils import grids as jgrids  # noqa: E402
from sparse_linear_tpu_torch.entry import entry as tentry  # noqa: E402
from sparse_linear_tpu_torch.solve import cg as tcg  # noqa: E402
from tests.torch_parity import np_of, to_port  # noqa: E402


def _both_cg(j, b, **kw):
    t = to_port(j)
    rj = jcg.cg(lambda v: j @ v, jnp.asarray(b), **kw)
    rt = tcg.cg(t.__matmul__, torch.as_tensor(b), **kw)
    return rj, rt


@pytest.mark.parametrize("which", ["p2d_32", "p3d_8"])
def test_cg_matches_jax(which):
    rng = np.random.default_rng(40)
    if which == "p2d_32":
        j = jgrids.poisson_2d(32, dtype=np.float64, fmt="dia")
    else:
        j = jgrids.poisson_3d(8, dtype=np.float64, fmt="dia")
    b = rng.standard_normal(j.shape[0])
    rj, rt = _both_cg(j, b, tol=1e-10, maxiter=2000)
    assert rt.converged and bool(rj.converged)
    assert abs(rt.iterations - int(rj.iterations)) <= 1
    np.testing.assert_allclose(np_of(rt.x), np_of(rj.x), rtol=0, atol=1e-9)
    assert float(rt.residual_norm) <= 1e-10 * np.linalg.norm(b)
    # the true residual, through the operator itself
    res = np.linalg.norm(np_of(to_port(j) @ rt.x) - b) / np.linalg.norm(b)
    assert res <= 1e-10


def test_cg_preconditioned_matches_jax():
    rng = np.random.default_rng(41)
    j = jgrids.poisson_2d(20, dtype=np.float64, fmt="dia")
    b = rng.standard_normal(400)
    d = 1.0 / 4.0
    rj = jcg.cg(lambda v: j @ v, jnp.asarray(b), tol=1e-10, maxiter=1000,
                m_inv=lambda r: r * d)
    rt = tcg.cg(to_port(j).__matmul__, torch.as_tensor(b), tol=1e-10,
                maxiter=1000, m_inv=lambda r: r * d)
    assert abs(rt.iterations - int(rj.iterations)) <= 1
    np.testing.assert_allclose(np_of(rt.x), np_of(rj.x), rtol=0, atol=1e-9)


def test_cg_complex_hermitian_matches_jax():
    rng = np.random.default_rng(42)
    j = jgrids.poisson_2d(12, dtype=np.float64, fmt="dia")
    b = rng.standard_normal(144) + 1j * rng.standard_normal(144)
    rj, rt = _both_cg(j, b, tol=1e-10, maxiter=1000)
    assert rt.x.dtype == torch.complex128
    assert abs(rt.iterations - int(rj.iterations)) <= 1
    np.testing.assert_allclose(np_of(rt.x), np_of(rj.x), rtol=0, atol=1e-9)


def test_cg_maxiter_x0_and_zero_rhs():
    rng = np.random.default_rng(43)
    j = jgrids.poisson_2d(16, dtype=np.float64, fmt="dia")
    b = rng.standard_normal(256)
    rj, rt = _both_cg(j, b, tol=1e-12, maxiter=5)
    assert rt.iterations == int(rj.iterations) == 5
    assert not rt.converged and not bool(rj.converged)
    np.testing.assert_allclose(np_of(rt.x), np_of(rj.x), rtol=0, atol=1e-9)
    # a warm start continues where the first solve stopped
    x0 = np_of(rt.x)
    rj2 = jcg.cg(lambda v: j @ v, jnp.asarray(b), jnp.asarray(x0),
                 tol=1e-10, maxiter=1000)
    rt2 = tcg.cg(to_port(j).__matmul__, torch.as_tensor(b),
                 torch.as_tensor(x0), tol=1e-10, maxiter=1000)
    assert abs(rt2.iterations - int(rj2.iterations)) <= 1
    np.testing.assert_allclose(np_of(rt2.x), np_of(rj2.x), rtol=0, atol=1e-9)
    # ||b|| = 0: the tiny guard keeps the test finite, x stays 0
    z = np.zeros(256)
    rj0, rt0 = _both_cg(j, z, tol=1e-10, maxiter=10)
    assert rt0.iterations == int(rj0.iterations) == 0
    assert not np.any(np_of(rt0.x)) and rt0.converged


def test_entry_matches_graft_entry():
    import __graft_entry__

    fn_j, args_j = __graft_entry__.entry()
    x_j, rn_j = fn_j(*args_j)
    fn_t, args_t = tentry("cpu", grid=64, dtype=torch.float32)
    x_t, rn_t = fn_t(*args_t)
    assert x_t.dtype == torch.float32 and x_t.shape == (64 * 64,)
    np.testing.assert_allclose(np_of(x_t), np_of(x_j), rtol=1e-5)
    np.testing.assert_allclose(float(rn_t), float(rn_j), rtol=1e-5)
