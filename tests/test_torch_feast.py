"""Parity of the port's FEAST eigensolver (``eig/feast.py``,
``eig/pipeline.py``) with the JAX package, on the CPU.

The same numpy inputs, and the same starting subspace ``guess``, go through
both packages; the JAX side runs on the CPU as ``tests/test_eig.py`` runs
it, once per case in a module-scoped fixture (its CPU path compiles per
shape).  Tolerances: eigenvalues within 1e-10 relative of the JAX
package's and of the analytic spectrum; the cosines of the principal
angles between the two packages' eigenvectors (B inner product, per group
of equal eigenvalues) >= 1 - 1e-8; one filter application within 1e-12
relative of a dense numpy sum; the three contour modes within 1e-12 of
each other; the eigenvalue count within 1e-4 relative of the JAX
package's, whose real path factors in f32.  The two faults of the
reference (``real_pipeline.py:802-810`` and ``:357-371``) are tested
against analytic values and the port's own functions, never against the
JAX package's output.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import sparse_linear_tpu as sl  # noqa: E402
from sparse_linear_tpu.eig import feast as jfeast  # noqa: E402
from sparse_linear_tpu.utils import grids as jgrids  # noqa: E402
import sparse_linear_tpu_torch as st  # noqa: E402
from sparse_linear_tpu_torch.dist import Mesh  # noqa: E402
from sparse_linear_tpu_torch.eig import feast as tfeast  # noqa: E402
from sparse_linear_tpu_torch.eig import pipeline  # noqa: E402
from sparse_linear_tpu_torch.eig.feast import (  # noqa: E402
    INFO_NO_EIGENVALUES,
    INFO_OK,
    FeastParams,
    count_eigenvalues,
    eigsh,
    eigsh_sliced,
    geigsh,
)
from sparse_linear_tpu_torch.utils import grids as tgrids  # noqa: E402
from tests.torch_parity import np_of, to_port  # noqa: E402

G = 12  # the Poisson grid of the multifrontal cases


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The solves here are small: one intra-op thread keeps the workers of
    a parallel pytest run from oversubscribing the cores (with torch's
    default pool per worker the contour tests ran an order of magnitude
    slower); restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _poisson_spectrum(g):
    lam1 = 4 * np.sin(np.arange(1, g + 1) * np.pi / (2 * (g + 1))) ** 2
    return np.sort((lam1[:, None] + lam1[None, :]).ravel())


def _laplacian_spectrum(n):
    return 2.0 - 2.0 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1))


def _case(name):
    """(JAX A, JAX B or None, m0, interval, params kwargs, analytic values,
    guess) of one parity case; inputs from numpy with a fixed seed."""
    rng = np.random.default_rng(40)
    if name == "2x2":
        a = sl.from_triples((2, 2), [0, 0, 1, 1], [0, 1, 0, 1],
                            [2.0, -1.0, -1.0, 2.0]).tocsr()
        return a, None, 2, (0.0, 4.0), {}, np.array([1.0, 3.0]), \
            rng.standard_normal((2, 2))
    if name == "2x2_complex":
        a = sl.from_triples((2, 2), [0, 0, 1, 1], [0, 1, 0, 1],
                            np.array([2.0, -1j, 1j, 2.0])).tocsr()
        guess = rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))
        return a, None, 2, (0.0, 4.0), {}, np.array([1.0, 3.0]), guess
    if name == "laplacian_window":
        n = 24
        exact = _laplacian_spectrum(n)
        want = np.sort(exact[(exact >= 0.5) & (exact <= 1.5)])
        m0 = len(want) + 6
        return (jgrids.laplacian_1d(n, dtype=np.float64), None, m0,
                (0.5, 1.5), {"tol": 1e-13}, want,
                rng.standard_normal((n, m0)))
    if name == "diagonal_pencil":
        n = 16
        a = jgrids.laplacian_1d(n, dtype=np.float64)
        d = np.linspace(1.0, 2.0, n)
        ad = np.asarray(a.todense())
        exact = np.sort(np.linalg.eigvalsh(
            np.diag(d ** -0.5) @ ad @ np.diag(d ** -0.5)))
        want = exact[(exact >= 0.3) & (exact <= 1.2)]
        m0 = len(want) + 4
        return (a, sl.diag(jnp.asarray(d)), m0, (0.3, 1.2), {"tol": 1e-13},
                want, rng.standard_normal((n, m0)))
    if name == "gauge_12_multifrontal":
        # complex Hermitian, banded, with Poisson's spectrum: the lowest 10
        # pairs through the JAX package's native complex path
        lam = _poisson_spectrum(G)
        emax = float((lam[9] + lam[10]) / 2)
        guess = (rng.standard_normal((G * G, 16))
                 + 1j * rng.standard_normal((G * G, 16)))
        return (_jax_gauge_poisson(G), None, 16, (0.0, emax),
                {"tol": 1e-11, "backend": "multifrontal", "dims": (G, G),
                 "complex_strategy": "native"}, lam[:10], guess)
    assert name == "poisson_12_multifrontal"
    lam = _poisson_spectrum(G)
    want = lam[lam <= 1.5]
    return (jgrids.poisson_2d(G, dtype=np.float64), None, 24, (0.0, 1.5),
            {"tol": 1e-11, "backend": "multifrontal", "dims": (G, G)},
            want, rng.standard_normal((G * G, 24)))


CASES = ["2x2", "2x2_complex", "laplacian_window", "diagonal_pencil",
         "poisson_12_multifrontal", "gauge_12_multifrontal"]

THETA = 0.3  # the gauge operator's phase on the x-links


def _gauge_triples(g, theta=THETA):
    """(rows, cols, values) of the g**2 five-point operator with the phase
    e^{i theta} on its x-links: A[p, p + e_x] = -e^{i theta}, A[p + e_x,
    p] = -e^{-i theta}.  It is D A_0 D^H with D = diag(e^{i theta x_p})
    unitary: complex Hermitian, banded, with Poisson's spectrum."""
    p = np.arange(g * g)
    x = p % g
    right, up = p[x < g - 1], p[p < g * g - g]
    rows = np.concatenate([p, right, right + 1, up, up + g])
    cols = np.concatenate([p, right + 1, right, up + g, up])
    vals = np.concatenate([np.full(g * g, 4.0 + 0j),
                           np.full(right.size, -np.exp(1j * theta)),
                           np.full(right.size, -np.exp(-1j * theta)),
                           np.full(2 * up.size, -1.0 + 0j)])
    return rows, cols, vals


def _jax_gauge_poisson(g):
    return sl.from_triples((g * g, g * g), *_gauge_triples(g)).tocsr()


def _solve(pkg, name):
    ja, jb, m0, interval, kw, _, guess = _case(name)
    if pkg == "jax":
        if jb is None:
            return jfeast.eigsh(m0, interval, ja, jfeast.FeastParams(**kw),
                                guess=guess)
        return jfeast.geigsh(m0, interval, ja, jb, jfeast.FeastParams(**kw),
                             guess=guess)
    ta = to_port(ja)
    if jb is None:
        return eigsh(m0, interval, ta, FeastParams(**kw), guess=guess)
    return geigsh(m0, interval, ta, to_port(jb), FeastParams(**kw),
                  guess=guess)


@pytest.fixture(scope="module")
def jax_results():
    """Every JAX-package solve of this file, run once."""
    out = {name: _solve("jax", name) for name in CASES}
    out["count"] = jfeast.count_eigenvalues(
        (0.0, 1.5), jgrids.poisson_2d(G, dtype=np.float64), probes=16,
        params=jfeast.FeastParams(backend="multifrontal", dims=(G, G)))
    return out


def _b_dense(jb, n):
    return np.eye(n) if jb is None else np.asarray(jb.todense())


def _principal_cosines(values, x1, x2, b):
    """Cosines of the principal angles between the two packages' vectors,
    B inner product, one group of equal eigenvalues at a time."""
    out = []
    j0 = 0
    for j in range(1, len(values) + 1):
        if j < len(values) and abs(values[j] - values[j - 1]) < 1e-8:
            continue
        m = x1[:, j0:j].conj().T @ b @ x2[:, j0:j]
        out.extend(np.linalg.svd(m, compute_uv=False))
        j0 = j
    return np.asarray(out)


# -------------------------------------------------------------- helpers


@pytest.mark.parametrize("kind", ["gauss", "trapezoid"])
@pytest.mark.parametrize("ne", [1, 4, 8, 12])
def test_contour_equals_jax(kind, ne):
    zt, st_ = tfeast._contour(-0.3, 2.7, ne, kind)
    zj, sj = jfeast._contour(-0.3, 2.7, ne, kind)
    np.testing.assert_array_equal(zt, zj)
    np.testing.assert_array_equal(st_, sj)


def test_contour_rejects_unknown_quadrature():
    with pytest.raises(ValueError, match="quadrature"):
        tfeast._contour(0.0, 1.0, 4, "zolotarev")


@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["real", "complex"])
def test_reduced_geig_and_whiten_equal_jax(dtype):
    rng = np.random.default_rng(41)
    m, rank = 12, 8  # a rank-deficient Gram, as the filtered subspace gives
    q = rng.standard_normal((40, rank)) @ rng.standard_normal((rank, m))
    if dtype == np.complex128:
        q = q + 1j * (rng.standard_normal((40, rank))
                      @ rng.standard_normal((rank, m)))
    g = q.conj().T @ q
    np.testing.assert_array_equal(tfeast._whiten_mat(g), jfeast._whiten_mat(g))
    h = rng.standard_normal((m, m))
    aq = h + h.T
    lt, ct = tfeast._reduced_geig(aq, g)
    lj, cj = jfeast._reduced_geig(aq, g)
    np.testing.assert_array_equal(lt, lj)
    np.testing.assert_array_equal(ct, cj)


# ------------------------------------------------------------ filter step


def _pencil_12(complex_a):
    rng = np.random.default_rng(42)
    a = jgrids.poisson_2d(G, dtype=np.float64)
    if complex_a:
        # a Hermitian perturbation on the same pattern
        rows = np.repeat(np.arange(G * G), np.diff(np.asarray(a.indptr)))
        cols = np.asarray(a.indices)
        im = rng.standard_normal(rows.size) * 0.2
        im = np.where(rows < cols, im, 0.0)
        full = np.zeros((G * G, G * G))
        full[rows, cols] = im
        full = full - full.T
        vals = np.asarray(a.data) + 1j * full[rows, cols]
        a = sl.from_triples(a.shape, rows, cols, vals).tocsr()
    d = rng.uniform(1.0, 2.0, G * G)
    return a, sl.diag(jnp.asarray(d)), d


@pytest.mark.parametrize("backend", ["dense", "multifrontal"])
@pytest.mark.parametrize("complex_a", [False, True], ids=["real", "complex"])
def test_one_filter_step_equals_dense_sum(complex_a, backend):
    """q from one filter application against the dense numpy
    sum_k sigma_k (z_k B - A)^-1 B y + conj(sigma_k) (conj(z_k) B - A)^-1
    B y.  For the real pencil the port solves only the upper nodes and
    doubles their real part: this holds the conjugate elimination."""
    ja, jb, _ = _pencil_12(complex_a)
    a, b = to_port(ja), to_port(jb)
    ad, bd = np.asarray(ja.todense()), np.asarray(jb.todense())
    rng = np.random.default_rng(43)
    y = rng.standard_normal((G * G, 6))
    if complex_a:
        y = y + 1j * rng.standard_normal((G * G, 6))
    z, sigma = tfeast._contour(0.0, 1.5, 8)
    pipe, _ = pipeline._get_pipeline(a, b, backend, (G, G))
    contour = pipe.contour(z, sigma, 6, "auto")
    q = np_of(contour.apply(torch.as_tensor(y), 0))
    want = sum(s * np.linalg.solve(zk * bd - ad, bd @ y)
               + np.conj(s) * np.linalg.solve(np.conj(zk) * bd - ad, bd @ y)
               for zk, s in zip(z, sigma))
    assert np.iscomplexobj(q) == complex_a
    rel = np.abs(q - want).max() / np.abs(want).max()
    assert rel <= 1e-12


# ----------------------------------------------- the slice against JAX


@pytest.mark.parametrize("name", CASES)
def test_eigsh_matches_jax_and_analytic(jax_results, name):
    ja, jb, m0, _, _, want, _ = _case(name)
    jr = jax_results[name]
    tr = _solve("port", name)
    assert tr.n_found == jr.n_found == len(want)
    tv = np.asarray(tr.values)
    np.testing.assert_allclose(tv, np.sort(np.asarray(jr.values)),
                               rtol=1e-10)
    np.testing.assert_allclose(tv, want, rtol=1e-10)
    assert tr.epsout < 1e-10
    b = _b_dense(jb, ja.shape[0])
    jx = np.asarray(jr.vectors)[:, np.argsort(np.asarray(jr.values))]
    cos = _principal_cosines(tv, np_of(tr.vectors), jx, b)
    assert cos.size == tr.n_found and cos.min() >= 1 - 1e-8
    assert tuple(tr.subspace.shape) == (ja.shape[0], m0)
    assert tr.vectors.device.type == "cpu"


def test_jax_subspace_warm_starts_the_port(jax_results):
    """A JAX ``EigResult.subspace`` crosses as a numpy array into
    ``guess=``: no interop kind is needed."""
    jr = jax_results["laplacian_window"]
    ja, _, m0, interval, kw, want, _ = _case("laplacian_window")
    res = eigsh(m0, interval, to_port(ja), FeastParams(**kw),
                guess=np.asarray(jr.subspace))
    assert res.info == INFO_OK and res.iterations <= jr.iterations
    np.testing.assert_allclose(res.values, want, rtol=1e-10)


def test_count_eigenvalues_matches_jax(jax_results):
    a = to_port(jgrids.poisson_2d(G, dtype=np.float64))
    est = count_eigenvalues((0.0, 1.5), a, probes=16,
                            params=FeastParams(backend="multifrontal",
                                               dims=(G, G)))
    assert abs(est - jax_results["count"]) <= 1e-4 * abs(jax_results["count"])
    assert abs(est - 17) < 0.25 * 17
    with pytest.raises(ValueError, match="empty"):
        count_eigenvalues((1.0, 0.5), a)


def test_count_eigenvalues_complex_generalized():
    """A complex Hermitian pencil with a diagonal B: the estimate runs both
    the S and the ^H solves (the JAX package's slow test, at its bound)."""
    n = 32
    rng = np.random.default_rng(49)
    h = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    h = (h + h.conj().T) / 2
    d = rng.uniform(0.5, 2.0, n)
    a = st.from_dense(torch.as_tensor(h))
    b = st.diag(torch.as_tensor(d))
    gev = np.sort(np.linalg.eigvalsh(np.diag(d ** -0.5) @ h
                                     @ np.diag(d ** -0.5)))
    lo, hi = float((gev[9] + gev[10]) / 2), float((gev[24] + gev[25]) / 2)
    est = count_eigenvalues((lo, hi), a, b, probes=32)
    assert abs(est - 15) < 5


# -------------------------------------------- port-only, against analytic


def _poisson_port(g=G):
    return tgrids.poisson_2d(g, dtype=torch.float64, device="cpu")


def test_empty_interval_info():
    a = tgrids.laplacian_1d(10, dtype=torch.float64, device="cpu")
    res = eigsh(4, (100.0, 200.0), a, FeastParams(max_loops=6))
    assert res.n_found == 0
    assert res.info == INFO_NO_EIGENVALUES


def test_warm_restart_takes_no_more_loops():
    a = tgrids.laplacian_1d(24, dtype=torch.float64, device="cpu")
    p = FeastParams(tol=1e-13)
    first = eigsh(8, (0.5, 1.5), a, p)
    again = eigsh(8, (0.5, 1.5), a, p, guess=first.subspace)
    again_np = eigsh(8, (0.5, 1.5), a, p, guess=np_of(first.subspace))
    assert again.iterations <= first.iterations
    assert again_np.iterations == again.iterations
    np.testing.assert_allclose(again.values, first.values, rtol=1e-10)


def test_non_hermitian_rejected():
    a = st.from_triples((2, 2), [0], [1], [1.0], device="cpu").tocsr()
    with pytest.raises(ValueError, match="hermitian"):
        eigsh(1, (0.0, 1.0), a)
    with pytest.raises(ValueError, match="hermitian"):
        count_eigenvalues((0.0, 1.0), a)


def _bidiagonal(n=30):
    """A non-symmetric A with a real spectrum on [1, 3]: upper
    bidiagonal."""
    rng = np.random.default_rng(48)
    ad = np.diag(np.linspace(1.0, 3.0, n)) + np.diag(
        rng.uniform(0.1, 0.5, n - 1), 1)
    return ad, st.from_dense(torch.as_tensor(ad))


@pytest.mark.parametrize("call,message", [
    ("eigsh", "geigsh: matrix A is not hermitian"),
    ("geigsh", "geigsh: matrix B is not hermitian"),
    ("count", "count_eigenvalues: matrix A is not hermitian")])
def test_non_hermitian_raises_before_any_analyze(monkeypatch, call,
                                                 message):
    """The Hermitian check runs before the pipeline's ``analyze``: the
    parent's error, and nothing left in the pipeline cache."""
    from sparse_linear_tpu_torch.solve import api

    ad, a = _bidiagonal()
    spd = st.from_dense(torch.as_tensor(np.diag(np.linspace(1.0, 2.0, 30))))
    analyzed = []
    real = api.analyze
    monkeypatch.setattr(api, "analyze",
                        lambda *args, **kw: analyzed.append(1)
                        or real(*args, **kw))
    pipeline.clear_pipeline_cache()
    with pytest.raises(ValueError, match=f"^{message}$"):
        if call == "eigsh":
            eigsh(8, (0.9, 2.0), a)
        elif call == "geigsh":
            geigsh(8, (0.9, 2.0), spd, a)
        else:
            count_eigenvalues((0.9, 2.0), a)
    assert analyzed == [] and pipeline._PIPELINE_CACHE == {}


@pytest.mark.parametrize("generalized", [False, True],
                         ids=["eigsh", "geigsh"])
def test_a_cached_pencil_is_checked_once(monkeypatch, generalized):
    """The Hermitian verdict lives on the cached pipeline: a second call on
    the same pencil, another window, checks nothing again.  An identity B
    is never checked."""
    a = tgrids.laplacian_1d(24, dtype=torch.float64, device="cpu")
    b = st.from_dense(torch.as_tensor(np.diag(np.linspace(1.0, 2.0, 24))))
    checked = []
    real = pipeline._check_hermitian

    def spy(mat, name, where):
        checked.append(name)
        real(mat, name, where)

    monkeypatch.setattr(pipeline, "_check_hermitian", spy)
    pipeline.clear_pipeline_cache()
    for window in ((0.2, 1.0), (0.3, 1.2)):
        if generalized:
            res = geigsh(8, window, a, b, FeastParams(tol=1e-10))
        else:
            res = eigsh(8, window, a, FeastParams(tol=1e-10))
        assert res.info == INFO_OK
    assert checked == (["A", "B"] if generalized else ["A"])
    assert len(pipeline._PIPELINE_CACHE) == 1


def test_a_pencil_built_unchecked_is_checked_when_asked():
    """A pipeline first built with check_hermitian=False is checked by the
    next call that asks for the check, and a non-Hermitian A raises."""
    _, a = _bidiagonal()
    pipeline.clear_pipeline_cache()
    eigsh(8, (0.9, 2.0), a, FeastParams(check_hermitian=False, max_loops=2))
    assert len(pipeline._PIPELINE_CACHE) == 1
    with pytest.raises(ValueError, match="^geigsh: matrix A is not "
                                         "hermitian$"):
        eigsh(8, (0.9, 2.0), a, FeastParams(max_loops=2))
    with pytest.raises(ValueError, match="^count_eigenvalues: matrix A"):
        count_eigenvalues((0.9, 2.0), a, params=FeastParams(max_loops=2))


def test_eigsh_and_geigsh_with_the_identity_share_one_pipeline():
    """eigsh(A) and geigsh(A, I) are one pencil: one cached pipeline, one
    contour, bitwise the same answers."""
    a = _poisson_port()
    p = FeastParams(tol=1e-10, backend="multifrontal", dims=(G, G))
    pipeline.clear_pipeline_cache()
    first = eigsh(24, (0.0, 1.5), a, p)
    (pipe,) = pipeline._PIPELINE_CACHE.values()
    again = geigsh(24, (0.0, 1.5), a,
                   st.eye(G * G, dtype=torch.float64, device="cpu"), p)
    assert list(pipeline._PIPELINE_CACHE.values()) == [pipe]
    assert len(pipe.contours) == 1
    assert pipeline.last_run["routes"] == ("dia", "identity")
    assert first.info == INFO_OK and first.n_found > 0
    np.testing.assert_array_equal(again.values, first.values)
    assert torch.equal(again.vectors, first.vectors)
    assert again.iterations == first.iterations


def test_invalid_args():
    a = tgrids.laplacian_1d(4, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="interval"):
        eigsh(2, (1.0, 1.0), a)
    with pytest.raises(ValueError, match="m0"):
        eigsh(0, (0.0, 1.0), a)
    with pytest.raises(ValueError, match="square"):
        geigsh(2, (0.0, 1.0), a, st.eye(5, dtype=torch.float64, device="cpu"))
    with pytest.raises(ValueError, match="guess"):
        eigsh(2, (0.0, 1.0), a, guess=np.ones((4, 3)))
    with pytest.raises(ValueError, match="embedded"):
        eigsh(2, (0.0, 1.0), a, FeastParams(complex_strategy="embedded"))
    with pytest.raises(ValueError, match="contour_batching"):
        eigsh(2, (0.0, 1.0), a, FeastParams(contour_batching="scan"))
    with pytest.raises(ValueError, match="not divisible"):
        eigsh(2, (0.0, 1.0), a, FeastParams(contour_points=3),
              mesh=Mesh(np.array(["cpu"] * 4).reshape(2, 2), ("cp", "rows")))
    with pytest.raises(ValueError, match="quadrature"):
        eigsh(2, (0.0, 1.0), a, FeastParams(quadrature="bogus"))


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128],
                         ids=["real", "complex"])
def test_contour_modes_agree(monkeypatch, dtype):
    """Batched ("vmap"), per-node ("loop") and streaming (auto under a
    1-byte budget) give the same eigenvalues within 1e-12."""
    a = _poisson_port().map_values(lambda v: v.to(dtype))
    lam = _poisson_spectrum(G)
    want = lam[lam <= 1.5]
    got = {}
    for mode, batching in (("batched", "vmap"), ("per-node", "loop"),
                           ("streaming", "auto")):
        if mode == "streaming":
            monkeypatch.setattr(pipeline, "_budget",
                                lambda device, held=0.0: 1.0)
        res = eigsh(24, (0.0, 1.5), a,
                    FeastParams(tol=1e-11, backend="multifrontal",
                                dims=(G, G), contour_batching=batching))
        assert pipeline.last_run["mode"] == mode
        assert res.info == INFO_OK and res.n_found == len(want)
        got[mode] = np.asarray(res.values)
    np.testing.assert_allclose(got["batched"], want, rtol=1e-10)
    for mode in ("per-node", "streaming"):
        np.testing.assert_allclose(got[mode], got["batched"], rtol=1e-12,
                                   atol=0)


def test_clear_pipeline_cache_frees_the_factors_at_once():
    """Clearing the cache releases the factor sets by reference counting
    alone (the pipeline <-> contour cycle is cut), with the cycle
    collector off: on the card that memory is free for the next plan."""
    import gc
    import weakref

    pipeline.clear_pipeline_cache()
    a = tgrids.laplacian_1d(24, dtype=torch.float64, device="cpu")
    eigsh(8, (0.5, 1.5), a, FeastParams(tol=1e-10))
    (pipe,) = pipeline._PIPELINE_CACHE.values()
    refs = [weakref.ref(c) for c in pipe.contours.values()]
    assert refs
    del pipe
    gc.disable()
    try:
        pipeline.clear_pipeline_cache()
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def test_plan_by_bytes(monkeypatch):
    """The auto plan takes the first mode whose bytes fit the budget."""
    pipe, _ = pipeline._get_pipeline(_poisson_port(), st.eye(
        G * G, dtype=torch.float64, device="cpu"), "multifrontal", (G, G))
    need = pipe.needs(8, 80)
    assert need["batched"] > need["per-node"] > need["streaming"] > 0
    fac, front = pipe.set_bytes()
    assert fac > 0 and front > 0
    for budget, mode in ((need["batched"], "batched"),
                         (need["per-node"], "per-node"),
                         (need["per-node"] - 1, "streaming")):
        monkeypatch.setattr(pipeline, "_budget",
                            lambda device, held=0.0, b=budget: float(b))
        assert pipe.plan(8, 80, "auto")[0] == mode
    assert pipe.plan(8, 80, "vmap")[0] == "batched"
    assert pipe.plan(8, 80, "loop")[0] == "per-node"


def test_routes_of_the_structured_operators():
    a = _poisson_port()
    assert pipeline._structured_op(a).route == "dia"
    assert pipeline._structured_op(None).route == "identity"
    g = 8
    coo = tgrids.poisson_2d(g, dtype=torch.float64, device="cpu").tocoo()
    perm = torch.as_tensor(np.random.default_rng(44).permutation(g * g))
    ap = st.from_triples((g * g, g * g), perm[coo.row.long()],
                         perm[coo.col.long()], coo.data).tocsr()
    op = pipeline._structured_op(ap)
    assert op.route == "well"
    x = torch.as_tensor(np.random.default_rng(45).standard_normal((g * g, 3))
                        + 1j * np.random.default_rng(46).standard_normal(
                            (g * g, 3)))
    np.testing.assert_allclose(np_of(op(x)), np_of(ap.todense()) @ np_of(x),
                               atol=1e-13)
    # a complex operator takes the route a real one does: DIA when banded,
    # else WELL (the complex kernels on the card, never ops.linalg.spmm)
    for real, route in ((a, "dia"), (ap, "well")):
        ac = real.map_values(lambda v: v.to(torch.complex128) * (1 + 0.5j))
        op = pipeline._structured_op(ac)
        assert op.route == route
        rng = np.random.default_rng(47)
        xc = torch.as_tensor(rng.standard_normal((ac.shape[1], 3))
                             + 1j * rng.standard_normal((ac.shape[1], 3)))
        np.testing.assert_allclose(np_of(op(xc)),
                                   np_of(ac.todense()) @ np_of(xc),
                                   atol=1e-13)


@pytest.mark.parametrize("permuted", [False, True], ids=["banded",
                                                         "permuted"])
def test_complex_operator_never_reaches_the_csr_spmm(monkeypatch,
                                                     permuted):
    """FEAST on the complex Hermitian gauge operator: banded it takes the
    "dia" route (complex kernel A's multi-RHS form on the card), permuted
    the "well" route (complex kernel D); ``ops.linalg.spmm`` is never
    called; the spectrum is Poisson's."""
    from sparse_linear_tpu_torch.ops import linalg

    def refuse(*args, **kwargs):
        raise AssertionError("ops.linalg.spmm reached for an operator")

    monkeypatch.setattr(linalg, "spmm", refuse)
    g = 8
    rows, cols, vals = _gauge_triples(g)
    if permuted:
        perm = np.random.default_rng(48).permutation(g * g)
        rows, cols = perm[rows], perm[cols]
    a = st.from_triples((g * g, g * g), rows, cols, vals,
                        device="cpu").tocsr()
    lam = _poisson_spectrum(g)
    emax = float((lam[5] + lam[6]) / 2)
    res = eigsh(12, (0.0, emax), a, FeastParams(
        tol=1e-11, backend="multifrontal",
        dims=None if permuted else (g, g)))
    assert pipeline.last_run["routes"] == (
        ("well" if permuted else "dia"), "identity")
    assert res.info == INFO_OK
    np.testing.assert_allclose(np.asarray(res.values), lam[:6], rtol=1e-10)


@pytest.mark.parametrize("full_rows", [[0, 32, 64, 96], [1, 50, 127]])
def test_low_fill_real_operator_takes_the_well_route(monkeypatch,
                                                     full_rows):
    """A real operator that is not banded goes to kernel D's route however
    low its WELL fill (one full row a slice: the layout's lowest, 1/32);
    the plain ``ops.linalg.spmm`` is on no FEAST route."""
    from sparse_linear_tpu_torch.formats.well import csr_to_well
    from sparse_linear_tpu_torch.ops import linalg

    def refuse(*args, **kwargs):
        raise AssertionError("ops.linalg.spmm reached for a real operator")

    monkeypatch.setattr(linalg, "spmm", refuse)
    n = 128
    rows = np.repeat(full_rows, n)
    cols = np.tile(np.arange(n), len(full_rows))
    vals = np.random.default_rng(50).standard_normal(rows.size)
    a = st.from_triples((n, n), rows, cols, vals, device="cpu").tocsr()
    assert csr_to_well(a).fill < 1.0 / 16.0
    op = pipeline._structured_op(a)
    assert op.route == "well"
    x = np.random.default_rng(51).standard_normal((n, 4))
    np.testing.assert_allclose(np_of(op(torch.as_tensor(x))),
                               np_of(a.todense()) @ x, atol=1e-12)


def test_permuted_operator_through_well():
    g = 8
    coo = tgrids.poisson_2d(g, dtype=torch.float64, device="cpu").tocoo()
    perm = torch.as_tensor(np.random.default_rng(47).permutation(g * g))
    ap = st.from_triples((g * g, g * g), perm[coo.row.long()],
                         perm[coo.col.long()], coo.data).tocsr()
    lam = _poisson_spectrum(g)
    want = lam[lam <= 2.0]
    res = eigsh(len(want) + 8, (0.0, 2.0), ap,
                FeastParams(tol=1e-11, backend="multifrontal"))
    assert pipeline.last_run["routes"] == ("well", "identity")
    assert res.info == INFO_OK
    np.testing.assert_allclose(res.values, want, rtol=1e-10)


def test_eigsh_sliced_poisson_12():
    lam = _poisson_spectrum(G)
    cand = np.arange(25, 36)
    k = int(cand[np.argmax(lam[cand] - lam[cand - 1])])
    emax = float((lam[k - 1] + lam[k]) / 2)
    res = eigsh_sliced((0.0, emax), _poisson_port(), m0_max=20,
                       params=FeastParams(tol=1e-10, dims=(G, G),
                                          backend="multifrontal"))
    assert res.n_found == k
    np.testing.assert_allclose(np.sort(res.values), lam[:k], rtol=1e-9)
    assert float(np.max(res.residuals)) < 1e-8
    assert np.all(np.diff(res.values) >= 0)
    assert tuple(res.vectors.shape) == (G * G, k)
    empty = eigsh_sliced((100.0, 200.0), _poisson_port(), m0_max=20,
                         params=FeastParams(max_loops=4, dims=(G, G)))
    assert empty.n_found == 0 and empty.info == INFO_NO_EIGENVALUES


# ------------------------------------- the two faults of the reference


def _state(values, ghosts, rejected, eps):
    return pipeline._LoopState(np.asarray(values, float),
                               np.asarray(ghosts, float),
                               np.asarray(rejected, float), eps)


@pytest.mark.parametrize("case", [
    "accepted", "rejected_residuals_wander", "a_ghost_left",
    "equal_counts_other_values", "rejected_residual_halved",
    "rejected_residual_falls_1.5x", "converging_pair_hidden_by_rank",
    "new_ghost_below_the_old", "no_previous_loop", "no_rejected_pair",
    "previous_above_tol", "count_changed"])
def test_ghost_filtered_convergence_rule(case):
    tol = 1e-10
    prev = _state([0.1, 0.2, 0.3], [0.15, 0.25], [1e-4, 5e-3], 1e-12)
    cur = _state([0.1, 0.2, 0.3], [0.25, 0.15], [5e-3, 2e-4], 1e-12)
    expect = False
    if case == "accepted":
        expect = True
    elif case == "rejected_residuals_wander":
        # ghosts' residuals move by a few percent a loop: no progress
        cur = cur._replace(rejected=np.array([4.6e-3, 0.9e-4]))
        expect = True
    elif case == "a_ghost_left":
        cur = cur._replace(ghosts=np.array([0.151]),
                           rejected=np.array([2e-4]))
        expect = True
    elif case == "equal_counts_other_values":
        # the same COUNT of genuine pairs, one of them another eigenvalue
        cur = cur._replace(values=np.array([0.1, 0.2, 0.31]))
    elif case == "rejected_residual_halved":
        # a rejected pair converging 2.5x a loop: it may be genuine
        cur = cur._replace(rejected=np.array([5e-3, 4e-5]))
    elif case == "rejected_residual_falls_1.5x":
        # a slowly converging rejected pair must not be dropped in silence
        cur = cur._replace(rejected=np.array([5e-3, 1e-4 / 1.5]))
    elif case == "converging_pair_hidden_by_rank":
        # sorted rank by rank the residuals did not fall; matched by Ritz
        # value the pair at 0.25 fell 40x
        cur = cur._replace(rejected=np.array([1.25e-4, 5e-3]))
    elif case == "new_ghost_below_the_old":
        cur = cur._replace(ghosts=np.array([0.16, 0.25, 0.15]),
                           rejected=np.array([1e-6, 5e-3, 2e-4]))
    elif case == "no_previous_loop":
        prev = None
    elif case == "no_rejected_pair":
        cur = cur._replace(ghosts=np.zeros(0), rejected=np.zeros(0))
    elif case == "previous_above_tol":
        prev = prev._replace(epsout=1e-8)
    else:
        cur = cur._replace(values=np.array([0.1, 0.2]))
    assert pipeline._ghost_converged(prev, cur, tol, 1.0) is expect


def test_interior_window_with_ghosts_converges():
    """An interior window leaves spurious Ritz values inside the interval
    (mixtures of eigenvectors from both sides); the genuine pairs converge
    and the rule above accepts them."""
    g = 32
    lam = _poisson_spectrum(g)
    lo, hi = float((lam[99] + lam[100]) / 2), float((lam[149] + lam[150]) / 2)
    res = eigsh(80, (lo, hi), tgrids.poisson_2d(g, dtype=torch.float64,
                                                device="cpu"),
                FeastParams(tol=1e-10, dims=(g, g), backend="multifrontal"))
    assert any(lp["rejected"] for lp in pipeline.last_run["loops"])
    assert res.info == INFO_OK and res.n_found == 50
    np.testing.assert_allclose(res.values, lam[100:150], rtol=1e-10)


def test_reduced_blocks_do_not_assume_symmetry(monkeypatch):
    """A non-symmetric A (check_hermitian=False): the reduced block is
    qw^T (A qw), not the reference's (A qw)^T qw."""
    n = 30
    rng = np.random.default_rng(48)
    ad = np.diag(np.linspace(1.0, 3.0, n)) + np.diag(
        rng.uniform(0.1, 0.5, n - 1), 1)  # upper bidiagonal: real spectrum
    a = st.from_dense(torch.as_tensor(ad))
    seen = []
    real_blocks = pipeline._reduced_blocks

    def spy(a_op, b_op, qw):
        out = real_blocks(a_op, b_op, qw)
        seen.append((np_of(qw), out[0]))
        return out

    monkeypatch.setattr(pipeline, "_reduced_blocks", spy)
    eigsh(8, (0.9, 2.0), a, FeastParams(check_hermitian=False, max_loops=2))
    assert seen and pipeline.last_run["routes"][0] == "dia"
    for qw, aq in seen:
        np.testing.assert_allclose(aq, qw.T @ (ad @ qw), atol=1e-12)
        assert np.abs(aq - (ad @ qw).T @ qw).max() > 1e-3
