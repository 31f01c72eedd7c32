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
from sparse_linear_tpu_torch.utils import grids as tgrids  # noqa: E402
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


# --------------------------------------------- the chunked loop (no m_inv)


def _poisson(which):
    if which == "p2d_32":
        return tgrids.poisson_2d(32, dtype=torch.float64, fmt="dia",
                                 device="cpu")
    return tgrids.poisson_3d(8, dtype=torch.float64, fmt="dia", device="cpu")


def _per_iteration(a, b, **kw):
    """The per-iteration loop on the same call: an identity m_inv takes
    it, and with z = r it computes what the unpreconditioned loop does."""
    return tcg.cg(a.__matmul__, b, m_inv=lambda r: r, **kw)


@pytest.mark.parametrize("k", [1, 3, 8, 64])
@pytest.mark.parametrize("which", ["p2d_32", "p3d_8"])
def test_chunked_loop_is_the_per_iteration_loop(monkeypatch, which, k):
    """Chunks of k iterations with the plain steps stop at exactly the
    per-iteration loop's iteration with bitwise its x and ||r||; the
    host reads once a chunk (chunk j's copy once j+1 is queued) and once
    at the end."""
    monkeypatch.setattr(tcg, "_chunk", lambda readings, launched, t: k)
    a = _poisson(which)
    b = torch.as_tensor(np.random.default_rng(44).standard_normal(
        a.shape[0]))
    ref = _per_iteration(a, b, tol=1e-10, maxiter=2000)
    res = tcg.cg(a.__matmul__, b, tol=1e-10, maxiter=2000)
    assert res.iterations == ref.iterations > 0
    assert torch.equal(res.x, ref.x)
    assert torch.equal(res.residual_norm, ref.residual_norm)
    assert res.converged and ref.converged
    chunks = -(-res.iterations // k)  # the chunk whose copy shows the stop
    assert res.launched == (chunks + 1) * k >= res.iterations
    assert res.host_reads == chunks + 1
    # the per-iteration loop: ||b||, a test an iteration and one more, the
    # verdict
    assert ref.host_reads == ref.iterations + 3
    assert ref.launched == ref.iterations


@pytest.mark.parametrize("case", ["x0_solves", "maxiter_first", "zero_b"])
def test_chunked_loop_edge_cases(case):
    """0 iterations where x0 already solves the system or b = 0 (the stop
    flag is set by the first r·r; two chunks are queued before the host
    sees it), and maxiter below the stop (one chunk, read only at the
    end); each bitwise the per-iteration loop."""
    a = tgrids.poisson_2d(16, dtype=torch.float64, fmt="dia", device="cpu")
    rng = np.random.default_rng(45)
    kw = {"tol": 1e-10, "maxiter": 1000}
    x0 = None
    if case == "x0_solves":
        # small integers: A x0 is exact, so r = b - A x0 is exactly 0
        x0 = torch.as_tensor(rng.integers(-3, 4, 256).astype(np.float64))
        b = a @ x0
    elif case == "zero_b":
        b = torch.zeros(256, dtype=torch.float64)
    else:
        b = torch.as_tensor(rng.standard_normal(256))
        kw = {"tol": 1e-12, "maxiter": 5}
    res = tcg.cg(a.__matmul__, b, x0, **kw)
    ref = tcg.cg(a.__matmul__, b, x0, m_inv=lambda r: r, **kw)
    assert res.iterations == ref.iterations
    assert torch.equal(res.x, ref.x) and res.converged == ref.converged
    if case == "maxiter_first":
        assert res.iterations == res.launched == 5 and not res.converged
        assert res.host_reads == 1
    else:
        assert res.iterations == 0 and res.converged
        assert res.launched == 2 * tcg._FIRST and res.host_reads == 2
        assert torch.equal(res.x, b if x0 is None else x0) or not b.any()


def test_preconditioned_and_sharded_calls_keep_the_per_iteration_loop():
    """An m_inv call and a ShardedVector call read ||r||² on the host every
    iteration, as the counters show; the chunked loop reads a few times a
    solve."""
    from sparse_linear_tpu_torch.dist import ShardedVector, card_mesh
    from sparse_linear_tpu_torch.dist.spmv import (
        dia_spmv_sharded,
        shard_dia_rows,
    )

    a = tgrids.poisson_2d(24, dtype=torch.float64, fmt="dia", device="cpu")
    b = torch.as_tensor(np.random.default_rng(46).standard_normal(576))
    plain = tcg.cg(a.__matmul__, b, tol=1e-10, maxiter=500)
    pre = tcg.cg(a.__matmul__, b, tol=1e-10, maxiter=500,
                 m_inv=lambda r: r * 0.25)
    mesh = card_mesh(4, ("rows",), device="cpu")
    sh = shard_dia_rows(a, mesh)
    shd = tcg.cg(lambda v: dia_spmv_sharded(sh, v, mesh),
                 ShardedVector.from_tensor(b, mesh), tol=1e-10, maxiter=500)
    for res in (pre, shd):
        assert res.converged
        assert res.host_reads == res.iterations + 3
        assert res.launched == res.iterations
    assert shd.iterations == plain.iterations
    assert plain.converged and plain.launched >= plain.iterations
    assert plain.host_reads <= plain.iterations // 4


@pytest.mark.parametrize("readings,launched,want", [
    ([], 0, "first"),
    ([(0, 1.0)], 8, "first"),
    # gamma falls tenfold an iteration: 22 more to 1e-40, 8 of them
    # queued, a quarter of the other 14
    ([(0, 1e-10), (8, 1e-18)], 16, 3),
    # far from the target: the largest chunk
    ([(0, 1.0), (8, 0.5), (16, 0.25)], 24, "max"),
    # at the target's door: the smallest
    ([(0, 1.0), (100, 1e-39)], 108, "min"),
    # gamma rose: no estimate, the largest chunk
    ([(0, 1.0), (8, 2.0)], 16, "max"),
])
def test_chunk_sizes_follow_the_decay(readings, launched, want):
    want = {"first": tcg._FIRST, "max": tcg._MAX, "min": tcg._MIN}.get(
        want, want)
    assert tcg._chunk(readings, launched, 1e-40) == want
