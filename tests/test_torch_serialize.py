"""The port's checkpoints (``sparse_linear_tpu_torch/utils/serialize.py``)
against the JAX package's (``sparse_linear_tpu/utils/serialize.py``), on
the CPU: every artifact written by one package's ``save_*`` is read by the
other's ``load_*``.

Factors: dense (f64, c128, batched; the files hold the JAX package's
0-based pivots, the port's Factors torch's 1-based ones) and multifrontal
(LU, Cholesky, equilibrated and batched, c128 LU), the cases of
``tests/test_interop.py``.  Solves on factors carried across agree with
the writer's own solves within 1e-13 relative; within one package a
loaded artifact's blocks and solves are bitwise the saved one's.  FEAST
subspaces cross both ways as warm starts.  A JAX WELL file loads in the
port as the port's own packing of the same matrix; the port's WELL file
(its own ``kind``) round-trips bitwise and the JAX ``load_well`` refuses
it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import sparse_linear_tpu as sl  # noqa: E402
from sparse_linear_tpu.eig import feast as jfeast  # noqa: E402
from sparse_linear_tpu.formats import well as jwell  # noqa: E402
from sparse_linear_tpu.solve import api as japi  # noqa: E402
from sparse_linear_tpu.solve import multifrontal as jmf  # noqa: E402
from sparse_linear_tpu.solve.complex_embed import embed_matrix  # noqa: E402
from sparse_linear_tpu.utils import grids as jgrids  # noqa: E402
from sparse_linear_tpu.utils import serialize as jser  # noqa: E402
from sparse_linear_tpu_torch.eig import feast as tfeast  # noqa: E402
from sparse_linear_tpu_torch.formats.well import csr_to_well  # noqa: E402
from sparse_linear_tpu_torch.kernels.spmv_well import well_spmv  # noqa: E402
from sparse_linear_tpu_torch.solve import api as tapi  # noqa: E402
from sparse_linear_tpu_torch.solve import multifrontal as tmf  # noqa: E402
from sparse_linear_tpu_torch.utils import serialize as tser  # noqa: E402
from tests.torch_parity import permuted_poisson, to_port  # noqa: E402

DIRECTIONS = ["jax_to_port", "port_to_jax"]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _complex_poisson(g):
    """The g**2 Poisson operator with a complex, non-Hermitian value on
    every entry (same pattern): a c128 LU case."""
    a = jgrids.poisson_2d(g, dtype=np.float64).tocsr()
    rng = np.random.default_rng(5)
    vals = np.asarray(a.data) * (1.0 + 0.3j) \
        + 0.1j * rng.standard_normal(a.nnz)
    return sl.CSR(indptr=a.indptr, indices=a.indices,
                  data=jnp.asarray(vals), shape=a.shape)


def _rhs(n, dtype, k=None):
    rng = np.random.default_rng(11)
    shape = (n,) if k is None else (n, k)
    b = rng.standard_normal(shape)
    if np.issubdtype(dtype, np.complexfloating):
        b = b + 1j * rng.standard_normal(shape)
    return b


# ---------------------------------------------------------------- dense


def _dense_case(dtype):
    if dtype == np.float64:
        return jgrids.poisson_2d(6, dtype=np.float64).tocsr()
    return _complex_poisson(6)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["f64", "c128"])
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_dense_factors_cross(direction, dtype, tmp_path):
    a = _dense_case(dtype)
    ap = to_port(a)
    b = _rhs(a.shape[0], dtype)
    path = tmp_path / "dense.npz"
    jf, tf = japi.factor(a), tapi.factor(ap)
    if direction == "jax_to_port":
        jser.save_factors(path, jf)
        got = tser.load_factors(path, device="cpu")
        # torch's 1-based pivots, as the port's own factorization holds
        assert torch.equal(got.payload[1], tf.payload[1])
        x = tapi.solve(got, torch.as_tensor(b)).numpy()
        assert _rel(x, japi.solve(jf, jnp.asarray(b))) <= 1e-13
    else:
        tser.save_factors(path, tf)
        got = jser.load_factors(path)
        np.testing.assert_array_equal(np.asarray(got.payload[1]),
                                      np.asarray(jf.payload[1]))
        x = np.asarray(japi.solve(got, jnp.asarray(b)))
        assert _rel(x, tapi.solve(tf, torch.as_tensor(b)).numpy()) <= 1e-13
    # within the port: bitwise
    tser.save_factors(tmp_path / "own.npz", tf)
    own = tser.load_factors(tmp_path / "own.npz", device="cpu")
    assert own.n == tf.n and own.batch is None
    assert torch.equal(tapi.solve(own, torch.as_tensor(b)),
                       tapi.solve(tf, torch.as_tensor(b)))


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_dense_batched_factors_cross(direction, tmp_path):
    """Batched dense factors keep their batch count across packages, so
    batched solves and the batch-aware queries keep working."""
    a = jgrids.laplacian_1d(12, dtype=np.float64).tocsr()
    ap = to_port(a)
    d0 = np.asarray(a.data)
    stack = np.stack([d0, 2.0 * d0])
    jf = japi.factor_batched(a, stack, japi.analyze(a))
    tf = tapi.factor_batched(ap, torch.as_tensor(stack), tapi.analyze(ap))
    b = np.stack([_rhs(12, np.float64, 2)] * 2)
    path = tmp_path / "dense_batched.npz"
    if direction == "jax_to_port":
        jser.save_factors(path, jf)
        got = tser.load_factors(path, device="cpu")
        assert got.batch == 2
        x = tapi.solve_batched(got, torch.as_tensor(b)).numpy()
        assert _rel(x, japi.solve_batched(jf, jnp.asarray(b))) <= 1e-13
        with pytest.raises(ValueError, match="index"):
            tapi.get_factors(got)
    else:
        tser.save_factors(path, tf)
        got = jser.load_factors(path)
        assert getattr(got, "batch", None) == 2
        x = np.asarray(japi.solve_batched(got, jnp.asarray(b)))
        assert _rel(x, tapi.solve_batched(tf, torch.as_tensor(b)).numpy()) \
            <= 1e-13
        L, U, rp, cp = japi.get_factors(got, index=1)
        dense = 2.0 * np.asarray(a.todense())
        err = np.max(np.abs(np.asarray(L.todense()) @ np.asarray(U.todense())
                            - dense[np.ix_(rp, cp)]))
        assert err < 1e-12 * np.max(np.abs(dense))


# ---------------------------------------------------------- multifrontal

MF_CASES = ["lu", "cholesky", "scaled_batched", "lu_c128"]


def _mf_case(case):
    """(JAX matrix, JAX factors, port matrix, port factors, rhs); the
    batched case's rhs is (2, n, 1)."""
    g = 6 if case == "scaled_batched" else 8
    a = _complex_poisson(g) if case == "lu_c128" else \
        jgrids.poisson_2d(g, dtype=np.float64).tocsr()
    ap = to_port(a)
    jsym = jmf.analyze(a, dims=(g, g))
    tsym = tmf.analyze(ap, dims=(g, g))
    if case == "scaled_batched":
        d0 = np.asarray(a.data)
        stack = np.stack([d0, 3.0 * d0])
        jf = jmf.factor_batched(stack, jsym, scale="sum")
        tf = tmf.factor_batched(stack, tsym, scale="sum", device="cpu")
        return a, jf, ap, tf, np.stack([_rhs(g * g, np.float64, 1)] * 2)
    kind = "cholesky" if case == "cholesky" else "lu"
    jf = jmf.factor(a, jsym, kind=kind)
    tf = tmf.factor(ap, tsym, kind=kind)
    return a, jf, ap, tf, _rhs(g * g, np.complex128 if "c128" in case
                               else np.float64)


def _jsolve(f, b):
    if getattr(f, "batch", None) is not None:
        return np.asarray(jmf.solve_batched(f, jnp.asarray(b)))
    return np.asarray(jmf.solve(f, jnp.asarray(b)))


def _tsolve(f, b):
    if f.batch is not None:
        return tmf.solve_batched(f, torch.as_tensor(b))
    return tmf.solve(f, torch.as_tensor(b))


@pytest.mark.parametrize("case", MF_CASES)
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_multifrontal_factors_cross(direction, case, tmp_path):
    a, jf, ap, tf, b = _mf_case(case)
    path = tmp_path / "mf.npz"
    if direction == "jax_to_port":
        jser.save_factors(path, jf)
        got = tser.load_factors(path, mat=ap)
        assert (got.kind, got.batch) == (jf.kind, getattr(jf, "batch", None))
        assert got.device.type == "cpu"
        assert _rel(_tsolve(got, b).numpy(), _jsolve(jf, b)) <= 1e-13
    else:
        tser.save_factors(path, tf)
        got = jser.load_factors(path, mat=a)
        assert (got.kind, getattr(got, "batch", None)) == (tf.kind, tf.batch)
        assert _rel(_jsolve(got, b), _tsolve(tf, b).numpy()) <= 1e-13
    # within the port: every block and the solve bitwise
    tser.save_factors(tmp_path / "own.npz", tf)
    own = tser.load_factors(tmp_path / "own.npz", mat=ap)
    assert own.symbolic.schedule.keys() == tf.symbolic.schedule.keys()
    np.testing.assert_array_equal(own.symbolic.perm, tf.symbolic.perm)
    assert own.blocks.keys() == tf.blocks.keys()
    for bidx, blk in tf.blocks.items():
        for name, t in blk.items():
            assert torch.equal(own.blocks[bidx][name], t.resolve_conj()), \
                (bidx, name)
    assert torch.equal(_tsolve(own, b), _tsolve(tf, b))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_multifrontal_load_errors(writer, tmp_path):
    """The JAX package's errors: a missing ``mat``, a matrix of another
    pattern, and one of another size."""
    g = 8
    a = jgrids.poisson_2d(g, dtype=np.float64).tocsr()
    path = tmp_path / "mf.npz"
    if writer == "jax":
        jser.save_factors(path, jmf.factor(a, jmf.analyze(a, dims=(g, g))))
    else:
        ap = to_port(a)
        tser.save_factors(path, tmf.factor(ap, tmf.analyze(ap, dims=(g, g))))
    with pytest.raises(ValueError, match="needs the matrix"):
        tser.load_factors(path)
    with pytest.raises(ValueError, match="pattern"):
        tser.load_factors(path, mat=to_port(
            jgrids.laplacian_1d(g * g, dtype=np.float64).tocsr()))
    with pytest.raises(ValueError, match="perm"):
        tser.load_factors(path, mat=to_port(
            jgrids.poisson_2d(7, dtype=np.float64).tocsr()))


def test_embedded_complex_factors_raise(tmp_path):
    """Real factors of the JAX package's 2n embedding of a complex matrix
    (``solve/complex_embed.py``, a TPU workaround the port leaves out)
    do not load as factors of the complex matrix: the loader says why."""
    a = _complex_poisson(4)
    e = embed_matrix(a)
    jser.save_factors(tmp_path / "emb.npz", jmf.factor(e, jmf.analyze(e)))
    with pytest.raises(ValueError, match="embedding"):
        tser.load_factors(tmp_path / "emb.npz", mat=to_port(a))


# --------------------------------------------------------------- subspace


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_subspace_cross(direction, tmp_path):
    """A FEAST result's subspace written by one package warm-starts the
    other's solve of the same window: no more loops than its cold solve,
    the same values."""
    a = jgrids.laplacian_1d(16, dtype=np.float64).tocsr()
    ap = to_port(a)
    path = tmp_path / "sub.npz"
    jres = jfeast.eigsh(6, (0.2, 1.2), a, jfeast.FeastParams(tol=1e-12))
    tres = tfeast.eigsh(6, (0.2, 1.2), ap, tfeast.FeastParams(tol=1e-12))
    if direction == "jax_to_port":
        jser.save_subspace(path, jres)
        sub = tser.load_subspace(path, device="cpu")
        assert isinstance(sub, torch.Tensor) and sub.device.type == "cpu"
        np.testing.assert_array_equal(sub.numpy(), np.asarray(jres.subspace))
        warm = tfeast.eigsh(6, (0.2, 1.2), ap, tfeast.FeastParams(tol=1e-12),
                            guess=sub)
        assert warm.iterations <= tres.iterations
    else:
        tser.save_subspace(path, tres)
        sub = jser.load_subspace(path)
        np.testing.assert_array_equal(sub, tres.subspace.numpy())
        warm = jfeast.eigsh(6, (0.2, 1.2), a, jfeast.FeastParams(tol=1e-12),
                            guess=sub)
        assert warm.iterations <= jres.iterations
    np.testing.assert_allclose(warm.values, jres.values, rtol=1e-10)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_complex_subspace_array_cross(direction, tmp_path):
    """A raw c128 block (a complex Hermitian FEAST subspace's type) crosses
    bitwise; the port's writer resolves a lazily conjugated view."""
    rng = np.random.default_rng(2)
    y = rng.standard_normal((20, 4)) + 1j * rng.standard_normal((20, 4))
    path = tmp_path / "sub.npz"
    if direction == "jax_to_port":
        jser.save_subspace(path, jnp.asarray(y))
        got = tser.load_subspace(path, device="cpu").numpy()
    else:
        tser.save_subspace(path, torch.as_tensor(y.conj()).conj())
        got = jser.load_subspace(path)
    np.testing.assert_array_equal(got, y)


# ------------------------------------------------------------------- WELL


@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["f64", "c128"])
def test_jax_well_file_loads_in_port(dtype, tmp_path):
    """A JAX-written WELL (chunk planes, ``vals_im`` for complex) loads as
    the port's own packing of the same matrix, field for field."""
    a = permuted_poisson(6, dtype)
    jser.save_well(tmp_path / "w.npz", jwell.csr_to_well(a))
    got = tser.load_well(tmp_path / "w.npz", device="cpu")
    own = csr_to_well(to_port(a))
    for name in ("slice_ptr", "cols", "vals"):
        assert torch.equal(getattr(got, name), getattr(own, name)), name
    assert (got.shape, got.c_max, got.fill) == (own.shape, own.c_max,
                                                own.fill)
    x = torch.as_tensor(_rhs(36, dtype))
    y = well_spmv(got, x).numpy()
    assert _rel(y, np.asarray(a.todense()) @ x.numpy()) <= 1e-13


@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["f64", "c128"])
def test_port_well_file_roundtrip_and_jax_refuses_it(dtype, tmp_path):
    w = csr_to_well(to_port(permuted_poisson(6, dtype)))
    path = tmp_path / "w.npz"
    tser.save_well(path, w)
    got = tser.load_well(path, device="cpu")
    for name in ("slice_ptr", "cols", "vals"):
        assert torch.equal(getattr(got, name), getattr(w, name)), name
    assert (got.shape, got.c_max, got.fill) == (w.shape, w.c_max, w.fill)
    x = torch.as_tensor(_rhs(36, dtype))
    assert torch.equal(well_spmv(got, x), well_spmv(w, x))
    with pytest.raises(ValueError, match="not a WELL checkpoint"):
        jser.load_well(path)


def test_load_well_refuses_other_files(tmp_path):
    np.savez_compressed(tmp_path / "x.npz", kind="dia", shape=[2, 2])
    with pytest.raises(ValueError, match="not a WELL checkpoint"):
        tser.load_well(tmp_path / "x.npz", device="cpu")


# ------------------------------------------------------------------ device


def test_loads_go_to_the_card_unless_asked(tmp_path):
    """Without ``device=`` a load builds on the card; without a GPU that
    is torch's own error, never a quiet CPU fallback."""
    y = np.ones((4, 2))
    tser.save_subspace(tmp_path / "s.npz", y)
    tser.save_well(tmp_path / "w.npz",
                   csr_to_well(to_port(permuted_poisson(4, np.float64))))
    ap = to_port(jgrids.laplacian_1d(6, dtype=np.float64).tocsr())
    tser.save_factors(tmp_path / "f.npz", tapi.factor(ap))
    loads = {"subspace": lambda: tser.load_subspace(tmp_path / "s.npz"),
             "well": lambda: tser.load_well(tmp_path / "w.npz").vals,
             "factors": lambda: tser.load_factors(
                 tmp_path / "f.npz").payload[0]}
    for name, load in loads.items():
        if torch.cuda.is_available():
            assert load().device.type == "cuda", name
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                load()
