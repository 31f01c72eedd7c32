"""The port's staged solver API (``solve/api.py``) against the JAX package.

The dense backend (``torch.linalg.lu_factor`` / ``lu_solve``, whose pivots
are LAPACK's 1-based swaps where the JAX package's are 0-based) and the
multifrontal backend, through the same entry points: solves in the three
modes, partial solves, determinants, condition estimates, factor export,
refinement with f64 residuals on f32 factors, GMRES and the residual norm.
Inputs are made with numpy and handed to both packages on the CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import sparse_linear_tpu as sl  # noqa: E402
from sparse_linear_tpu.ops.build import trim  # noqa: E402
from sparse_linear_tpu.solve import api as japi  # noqa: E402
from sparse_linear_tpu.utils.grids import poisson_2d  # noqa: E402
from sparse_linear_tpu_torch.solve import api  # noqa: E402
from tests.torch_parity import np_of, to_port  # noqa: E402

N = 30


def _dense(dtype, seed=11):
    """A nonsymmetric matrix that needs row exchanges (a weak diagonal),
    real or complex, about 40 % full."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((N, N)) * (rng.random((N, N)) < 0.4)
    d += np.diag(rng.uniform(0.1, 0.3, N))
    if np.issubdtype(dtype, np.complexfloating):
        d = d + 1j * rng.standard_normal((N, N)) * (d != 0)
    return d.astype(dtype)


_CACHE = {}


def _dense_pair(dtype):
    key = np.dtype(dtype).name
    if key not in _CACHE:
        d = _dense(dtype)
        ja = trim(sl.from_dense(d))
        a = to_port(ja)
        _CACHE[key] = (d, ja, a, japi.factor(ja), api.factor(a))
    return _CACHE[key]


def _rhs(dtype, k=None, seed=2):
    rng = np.random.default_rng(seed)
    shape = (N,) if k is None else (N, k)
    b = rng.standard_normal(shape)
    if np.issubdtype(dtype, np.complexfloating):
        b = b + 1j * rng.standard_normal(shape)
    return b


def _rel(x, ref):
    return np.abs(x - ref).max() / max(np.abs(ref).max(), 1e-300)


DTYPES = [np.float64, np.complex128]
IDS = ["f64", "c128"]


@pytest.mark.parametrize("k", [None, 4])
@pytest.mark.parametrize("trans", ["N", "H", "T"])
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_dense_solve_equal_jax(dtype, trans, k):
    d, ja, a, jf, f = _dense_pair(dtype)
    b = _rhs(dtype, k)
    x = np_of(api.solve(f, torch.as_tensor(b), trans=trans))
    assert _rel(x, np.asarray(japi.solve(jf, jnp.asarray(b),
                                         trans=trans))) <= 1e-12
    op = {"N": d, "H": d.conj().T, "T": d.T}[trans]
    assert np.linalg.norm(op @ x - b) / np.linalg.norm(b) <= 1e-12


@pytest.mark.parametrize("sys", api.SOLVE_PART_SYS)
def test_dense_solve_part_equal_jax(sys):
    """The 1-based pivots become the JAX package's row order."""
    _, _, _, jf, f = _dense_pair(np.complex128)
    b = _rhs(np.complex128, 2)
    got = np_of(api.solve_part(f, torch.as_tensor(b), sys))
    want = np.asarray(japi.solve_part(jf, jnp.asarray(b), sys))
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_dense_queries_equal_jax(dtype):
    d, _, _, jf, f = _dense_pair(dtype)
    sign, logabs = api.slogdet(f)
    jsign, jlogabs = japi.slogdet(jf)
    np.testing.assert_allclose(logabs, jlogabs, rtol=1e-12)
    np.testing.assert_allclose(sign, jsign, rtol=1e-12, atol=1e-12)
    wsign, wlog = np.linalg.slogdet(d)
    np.testing.assert_allclose(sign, wsign, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(api.det(f), np.linalg.det(d), rtol=1e-10)
    np.testing.assert_allclose(api.rcond(f), japi.rcond(jf), rtol=1e-12)
    L, U, rp, cp = api.get_factors(f)
    jL, jU, jrp, jcp = japi.get_factors(jf)
    np.testing.assert_array_equal(rp, jrp)
    np.testing.assert_array_equal(cp, jcp)
    assert _rel(np_of(L.todense()) @ np_of(U.todense()),
                d[np.ix_(rp, cp)]) <= 1e-12
    assert api.lunz(f) == japi.lunz(jf)
    # the row exchanges really happened
    assert (rp != np.arange(N)).any()


def test_dense_batched_equal_jax():
    d, ja, a, _, _ = _dense_pair(np.float64)
    stack = np.stack([np.asarray(ja.data) * (1 + 0.1 * e) for e in range(3)])
    jfb = japi.factor_batched(ja, jnp.asarray(stack), japi.analyze(ja))
    fb = api.factor_batched(a, torch.as_tensor(stack), api.analyze(a))
    assert fb.batch == 3
    bs = np.random.default_rng(4).standard_normal((3, N, 2))
    for trans in ("N", "H", "T"):
        got = np_of(api.solve_batched(fb, torch.as_tensor(bs), trans=trans))
        want = np.asarray(japi.solve_batched(jfb, jnp.asarray(bs),
                                             trans=trans))
        assert _rel(got, want) <= 1e-12
    for got, want in zip(api.slogdet(fb), japi.slogdet(jfb)):
        np.testing.assert_allclose(got, want, rtol=1e-12)
    L, U, rp, cp = api.get_factors(fb, index=1)
    assert _rel(np_of(L.todense()) @ np_of(U.todense()),
                1.1 * d[np.ix_(rp, cp)]) <= 1e-12
    with pytest.raises(ValueError, match="batched"):
        api.solve_part(fb, torch.zeros(N, dtype=torch.float64), "L")
    with pytest.raises(ValueError, match="batched"):
        api.condest(fb, a)


def test_dense_rejects_scale_and_bad_input():
    _, _, a, _, f = _dense_pair(np.float64)
    with pytest.raises(ValueError, match="multifrontal-backend option"):
        api.factor(a, scale="sum")
    with pytest.raises(ValueError, match="unknown sys"):
        api.solve_part(f, torch.zeros(N, dtype=torch.float64), "P")
    with pytest.raises(ValueError, match="rows, expected"):
        api.solve_part(f, torch.zeros(N + 1, dtype=torch.float64), "L")
    with pytest.raises(ValueError, match="trans must be"):
        api.solve(f, torch.zeros(N, dtype=torch.float64), trans="X")
    with pytest.raises(ValueError, match="unknown backend"):
        api.analyze(a, backend="gpu-magic")


@pytest.mark.parametrize("backend", ["dense", "multifrontal"])
def test_linear_solve_and_residual_norm_equal_jax(backend):
    g = 8
    ja = poisson_2d(g, dtype=np.float64)
    a = to_port(ja)
    b = np.random.default_rng(6).standard_normal((g * g, 3))
    opts = {"dims": (g, g)} if backend == "multifrontal" else {}
    x = api.linear_solve(a, torch.as_tensor(b), backend=backend, **opts)
    jx = japi.linear_solve(ja, jnp.asarray(b), backend=backend, **opts)
    assert _rel(np_of(x), np.asarray(jx)) <= 1e-12
    assert float(api.residual_norm(a, x, torch.as_tensor(b))) <= 1e-13
    # an inexact x, so that the residual is not rounding noise
    xp = np_of(x) + 1e-3 * np.random.default_rng(7).standard_normal(b.shape)
    for trans in ("N", "H", "T"):
        r = float(api.residual_norm(a, torch.as_tensor(xp),
                                    torch.as_tensor(b), trans=trans))
        jr = float(japi.residual_norm(ja, jnp.asarray(xp), jnp.asarray(b),
                                      trans=trans))
        np.testing.assert_allclose(r, jr, rtol=1e-12)


@pytest.mark.parametrize("trans", ["N", "H"])
def test_solve_refined_f32_factors_reach_1e10(trans):
    """f32 multifrontal factors, f64 residuals through the port's CSR SpMV:
    the refined residual reaches 1e-10, as in the JAX package."""
    g = 16
    rng = np.random.default_rng(9)
    a64 = poisson_2d(g, dtype=np.float64)
    d = np.asarray(a64.todense())
    d = d + 0.3 * rng.uniform(-1, 1, d.shape) * (d != 0) * (1 - np.eye(g * g))
    ja64 = trim(sl.from_dense(d))
    ja32 = trim(sl.from_dense(d.astype(np.float32)))
    a64, a32 = to_port(ja64), to_port(ja32)
    b = rng.standard_normal(g * g)
    jf = japi.factor(ja32, backend="multifrontal", dims=(g, g))
    f = api.factor(a32, backend="multifrontal", dims=(g, g))
    x, info = api.solve_refined(f, a64, torch.as_tensor(b), trans=trans,
                                tol=1e-11)
    jx, jinfo = japi.solve_refined(jf, ja64, jnp.asarray(b), trans=trans,
                                   tol=1e-11)
    assert x.dtype == torch.float64
    assert info.converged and float(info.residual_norm) <= 1e-11
    assert info.refinement_steps == jinfo.refinement_steps
    assert _rel(np_of(x), np.asarray(jx)) <= 1e-10
    op = d if trans == "N" else d.T
    assert np.linalg.norm(op @ np_of(x) - b) / np.linalg.norm(b) <= 1e-10


def test_solve_gmres_equal_jax():
    """GMRES with a statically perturbed factorization of an indefinite
    shift as preconditioner."""
    g = 12
    a = poisson_2d(g, dtype=np.float64)
    ja = sl.lin(1.0, a, -2.9, sl.eye(g * g, dtype=jnp.float64)).tocsr()
    pa = to_port(ja)
    b = np.random.default_rng(12).standard_normal(g * g)
    jf = japi.factor(ja, backend="multifrontal", dims=(g, g), pivot_eps=1e-3)
    f = api.factor(pa, backend="multifrontal", dims=(g, g), pivot_eps=1e-3)
    assert f.n_flagged == jf.n_flagged
    x, info = api.solve_gmres(f, pa, torch.as_tensor(b), tol=1e-12)
    jx, jinfo = japi.solve_gmres(jf, ja, jnp.asarray(b), tol=1e-12)
    assert info.converged and float(info.residual_norm) <= 1e-12
    assert info.refinement_steps == jinfo.refinement_steps
    assert _rel(np_of(x), np.asarray(jx)) <= 1e-9
    with pytest.raises(ValueError, match="single RHS"):
        api.solve_gmres(f, pa, torch.zeros((g * g, 2), dtype=torch.float64))
    x0, info0 = api.solve_gmres(f, pa, torch.zeros(g * g,
                                                   dtype=torch.float64))
    assert float(info0.residual_norm) == 0 and not bool(x0.any())


@pytest.mark.parametrize("backend", ["dense", "multifrontal"])
def test_condest_equal_jax(backend):
    d, ja, a, jf, f = _dense_pair(np.float64)
    if backend == "multifrontal":
        jf = japi.factor(ja, backend="multifrontal", ordering="amd")
        f = api.factor(a, backend="multifrontal", ordering="amd")
    est = api.condest(f, a)
    np.testing.assert_allclose(est, japi.condest(jf, ja), rtol=1e-10)
    true = np.linalg.norm(d, 1) * np.linalg.norm(np.linalg.inv(d), 1)
    assert true / 10 <= est <= true * (1 + 1e-10)
