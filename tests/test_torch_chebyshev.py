"""Parity of the port's Chebyshev-filtered eigensolver
(``sparse_linear_tpu_torch/eig/chebyshev.py``) with the JAX package's, on
the CPU.

The same numpy inputs go through both packages; where the port draws
random numbers (``chebyshev._start_block``) the tests put the JAX
package's own draws in their place, so the two run iterate for iterate.
The JAX side runs on the CPU as ``tests/test_eig.py`` and
``tests/test_planes.py`` run it.  Tolerances: the Lanczos bound, the
CholeskyQR2 block and one filter application within 1e-12 relative;
eigenvalues within 1e-10 of the analytic spectrum and of the JAX
package's, residuals through a dense numpy product < 1e-8 (the bound of
``tests/test_eig.py``), the same number of passes.

Routes: the port sends a banded operator to kernel A's multi-RHS form and
any other to kernel D (their plain versions here, on CPU tensors); the
JAX package runs the permuted f64 operator through its BSR route, so the
WELL cases compare two implementations of the same product.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sparse_linear_tpu.eig import chebyshev as jcheb  # noqa: E402
from sparse_linear_tpu.eig.real_pipeline import (  # noqa: E402
    _StructuredOp as _JaxOp,
    _structured_op as _jax_structured_op,
)
from sparse_linear_tpu.utils import grids as jgrids  # noqa: E402
from sparse_linear_tpu_torch.eig import chebyshev  # noqa: E402
from sparse_linear_tpu_torch.eig.feast import (  # noqa: E402
    INFO_OK,
    INFO_SUBSPACE_TOO_SMALL,
)
from sparse_linear_tpu_torch.eig.pipeline import _structured_op  # noqa: E402
from tests.torch_parity import permuted_poisson, to_port  # noqa: E402

G = 24   # the JAX test's grid (tests/test_eig.py)
K = 10   # its pairs
M0 = 24  # its block
ROUTES = ["dia", "well"]


def _spectrum(g):
    lam1 = 4 * np.sin(np.arange(1, g + 1) * np.pi / (2 * (g + 1))) ** 2
    return np.sort((lam1[:, None] + lam1[None, :]).ravel())


def _operator(route, g, dtype=np.float64):
    """(JAX operator, port operator on the CPU): the g**2 Poisson operator
    in stencil order (banded: the DIA route) or relabelled by a seeded
    permutation (the WELL route)."""
    a = (jgrids.poisson_2d(g, dtype=dtype) if route == "dia"
         else permuted_poisson(g, dtype))
    return a, to_port(a.tocsr())


def _jax_block(n, m, seed):
    return np.array(jax.random.normal(jax.random.key(seed), (n, m),
                                      dtype=jnp.float64))


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's start blocks replaced by the JAX package's draws: the
    (n, m0) block of ``jax.random.key(seed)`` and, for the Lanczos vector
    (m = 1), the (n,) one JAX draws there."""
    def fake(n, m, seed, device, dtype=torch.float64):
        shape = (n,) if m == 1 else (n, m)
        blk = np.array(jax.random.normal(jax.random.key(seed), shape,
                                         dtype=jnp.float64))
        return torch.as_tensor(blk.reshape(n, m), dtype=dtype,
                               device=device)

    monkeypatch.setattr(chebyshev, "_start_block", fake)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's eigsh_filtered on the JAX test's case, per route,
    with its own Lanczos bound: (lam_ub, result)."""
    lam = _spectrum(G)
    emax = float((lam[K - 1] + lam[K]) / 2)
    out = {}
    for route in ROUTES:
        a, _ = _operator(route, G)
        op, _ = _jax_structured_op(a)
        lam_ub = jcheb.lanczos_upper_bound(op, G * G)
        out[route] = (lam_ub, jcheb.eigsh_filtered(M0, (0.0, emax), a,
                                                   tol=1e-10, lam_ub=lam_ub))
    return out


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("route", ROUTES)
def test_lanczos_upper_bound_matches_jax(route, jax_draws, jax_runs):
    a, ap = _operator(route, G)
    op = _structured_op(ap)
    assert op.route == route
    got = chebyshev.lanczos_upper_bound(op, G * G, device="cpu")
    want = jax_runs[route][0]
    assert abs(got - want) <= 1e-12 * abs(want)
    assert got > _spectrum(G)[-1]


@pytest.mark.parametrize("graded", [False, True], ids=["random", "graded"])
def test_cholqr2_matches_jax(graded):
    """The same numpy block through both CholeskyQR2s (the JAX one forms
    its Grams with ``dot64``); ``graded`` scales the columns over five
    decades."""
    y = np.random.default_rng(3).standard_normal((300, 7))
    if graded:
        y = y * np.logspace(0, -5, 7)[None, :]
    want = np.asarray(jcheb._cholqr2(jnp.asarray(y)))
    got = chebyshev._cholqr2(torch.as_tensor(y)).numpy()
    assert _rel(got, want) <= 1e-12
    np.testing.assert_allclose(got.T @ got, np.eye(7), atol=1e-12)


def _filters(route, planes=False):
    """(JAX filter, port filter, input block) on poisson_2d(12), m = 5,
    degree 6 (the case of tests/test_planes.py); ``planes`` runs the JAX
    recurrence plane-major, as it does for an operator that prefers it."""
    a, ap = _operator(route, 12)
    op, _ = _jax_structured_op(a)
    if planes:
        op = _JaxOp(op.cm, planes=op.planes, prefers_planes=True)
    y = _jax_block(144, 5, 0)
    top = _structured_op(ap)
    assert top.route == route
    return (jcheb._make_filter(op, jnp.asarray(y), 6),
            chebyshev._make_filter(top, None, 6), y)


@pytest.mark.parametrize("route,planes", [("dia", False), ("well", False),
                                          ("dia", True)],
                         ids=["dia", "well", "jax_plane_major"])
def test_filter_matches_jax(route, planes):
    jfilt, filt, y = _filters(route, planes)
    args = (20.0, 6.0, 1.0)
    want = np.asarray(jfilt(jnp.asarray(y), *args))
    yt = torch.as_tensor(y)
    got = filt(yt, *args).numpy()
    assert _rel(got, want) <= 1e-12
    assert torch.equal(yt, torch.as_tensor(y))  # the input is only read


@pytest.mark.parametrize("route", ROUTES)
def test_eigsh_filtered_lowest(route):
    """The JAX test's case on the port alone, from the port's own draws:
    the 10 lowest pairs against the analytic spectrum."""
    lam = _spectrum(G)
    emax = float((lam[K - 1] + lam[K]) / 2)
    a, ap = _operator(route, G)
    res = chebyshev.eigsh_filtered(M0, (0.0, emax), ap, tol=1e-10)
    assert res.info == INFO_OK and res.n_found == K
    np.testing.assert_allclose(np.sort(res.values), lam[:K], rtol=1e-10)
    x = res.vectors.numpy()
    r = np.linalg.norm(np.asarray(a.todense()) @ x - x * res.values[None, :],
                       axis=0)
    assert r.max() < 1e-8
    assert res.vectors.device.type == "cpu"
    assert tuple(res.subspace.shape) == (G * G, M0)
    assert np.all(res.residuals <= 1e-10)
    # what the run records: its route, bound, degree and a row a pass
    run = chebyshev.last_run
    assert run["route"] == route and run["lam_ub"] > lam[-1]
    ratio = emax / run["lam_ub"]
    assert run["degree"] == int(np.clip(14.0 / np.sqrt(ratio) / 2.0,
                                        30, 400))
    assert len(run["passes"]) == res.iterations
    assert run["passes"][0]["kind"] == "filter"
    assert run["passes"][-1]["epsout"] == res.epsout


@pytest.mark.parametrize("route", ROUTES)
def test_eigsh_filtered_matches_jax(route, jax_draws, jax_runs):
    """With the JAX package's start block and Lanczos bound, the port
    takes the same passes to the same values."""
    lam = _spectrum(G)
    emax = float((lam[K - 1] + lam[K]) / 2)
    _, ap = _operator(route, G)
    lam_ub, want = jax_runs[route]
    got = chebyshev.eigsh_filtered(M0, (0.0, emax), ap, tol=1e-10,
                                   lam_ub=lam_ub)
    assert want.info == INFO_OK and got.info == INFO_OK
    assert got.iterations == want.iterations
    assert got.n_found == want.n_found == K
    np.testing.assert_allclose(got.values, want.values, rtol=1e-10)
    np.testing.assert_allclose(got.values, lam[:K], rtol=1e-10)


def test_errors_match_jax():
    """The JAX package's three ValueErrors, raised by both packages."""
    a, ap = _operator("dia", 8)
    for mod, mat in ((jcheb, a), (chebyshev, ap)):
        with pytest.raises(ValueError, match="empty"):
            mod.eigsh_filtered(8, (1.0, 0.5), mat)
        with pytest.raises(ValueError, match="upper bound"):
            mod.eigsh_filtered(8, (0.0, 9.0), mat)
        with pytest.raises(ValueError, match="m0 must be >= 2"):
            mod.eigsh_filtered(1, (0.0, 0.5), mat)


@pytest.mark.parametrize("lam_ub", [None, 8.5], ids=["lanczos", "given"])
def test_complex_operator_raises_like_jax(lam_ub):
    """A complex operator: the JAX package raises TypeError (from its
    Lanczos scalars, or from its filter's loop carry when the bound is
    given); the port raises TypeError before any product."""
    a = jgrids.poisson_2d(8, dtype=np.complex128)
    with pytest.raises(TypeError):
        jcheb.eigsh_filtered(6, (0.0, 0.5), a, max_passes=2, lam_ub=lam_ub)
    with pytest.raises(TypeError, match="complex"):
        chebyshev.eigsh_filtered(6, (0.0, 0.5), to_port(a.tocsr()),
                                 max_passes=2, lam_ub=lam_ub)
    op = _structured_op(to_port(a.tocsr()))
    with pytest.raises(TypeError, match="complex"):
        chebyshev.lanczos_upper_bound(op, 64, device="cpu")


def test_float32_operator_matches_jax(jax_draws):
    """A float32 banded operator: both packages apply it to float64 blocks
    (the DIA products promote) and reach the f64 tolerance together."""
    g, k = 12, 4
    lam = _spectrum(g)
    emax = float((lam[k - 1] + lam[k]) / 2)
    a, ap = _operator("dia", g, np.float32)
    want = jcheb.eigsh_filtered(10, (0.0, emax), a, tol=1e-10)
    got = chebyshev.eigsh_filtered(10, (0.0, emax), ap, tol=1e-10)
    assert want.info == got.info == INFO_OK
    assert got.iterations == want.iterations
    np.testing.assert_allclose(got.values, want.values, rtol=1e-10)
    np.testing.assert_allclose(got.values, lam[:k], rtol=1e-10)
    assert got.vectors.dtype == torch.float64


def test_float32_well_operator_computes_in_float32(jax_draws):
    """A float32 unstructured operator takes kernel D in its own type, as
    the JAX package's WELL route does (plane-major, in f32), so both
    filters reach f32 resolution together: the same passes to 1e-5, the
    lowest pairs within 1e-5 of each other and of the analytic spectrum.
    Both are given the Gershgorin bound 8 (the JAX Lanczos bound through
    its interpreted WELL kernel would double the test's time)."""
    g, k = 12, 4
    lam = _spectrum(g)
    emax = float((lam[k - 1] + lam[k]) / 2)
    a, ap = _operator("well", g, np.float32)
    assert _structured_op(ap).route == "well"
    assert _jax_structured_op(a)[0].prefers_planes
    want = jcheb.eigsh_filtered(10, (0.0, emax), a, tol=1e-5, lam_ub=8.0)
    res = chebyshev.eigsh_filtered(10, (0.0, emax), ap, tol=1e-5,
                                   lam_ub=8.0)
    assert want.info == res.info == INFO_OK and res.n_found == k
    assert res.iterations == want.iterations
    np.testing.assert_allclose(res.values, want.values, rtol=1e-5)
    np.testing.assert_allclose(res.values, lam[:k], rtol=1e-5)
    # f32 products: the residual floor is f32's, not f64's
    assert 1e-8 < res.epsout <= 1e-5 and 1e-8 < want.epsout <= 1e-5


def test_subspace_too_small_and_restart_block():
    """Every Ritz value inside the window: INFO_SUBSPACE_TOO_SMALL, as the
    JAX module decides it, with a subspace to restart from."""
    lam = _spectrum(8)
    emax = float((lam[5] + lam[6]) / 2)
    _, ap = _operator("dia", 8)
    res = chebyshev.eigsh_filtered(4, (0.0, emax), ap, max_passes=3)
    assert res.info == INFO_SUBSPACE_TOO_SMALL and res.n_found == 4
    assert res.subspace is not None and tuple(res.subspace.shape) == (64, 4)
