"""Parity of the port's multi-device paths (``sparse_linear_tpu_torch/dist``,
``multifrontal.factor(mesh=)``, ``eigsh(mesh=)``, ``entry.dryrun_multichip``)
with the JAX package's, on the CPU.

The JAX side runs on the conftest's 8 virtual CPU devices, as
``tests/test_dist.py`` does; the port side on ``card_mesh(8, ...,
device="cpu")``: eight shards on one CPU, whose exchanges and per-shard
products run for real.  The same numpy inputs, made from a seed, go to both.
One test here stands for each of the 13 tests of ``tests/test_dist.py``
(cases of one parametrised test where they repeat each other), with the
window plans held equal element for element.  Tolerances: sharded products
within 1e-12 of the JAX package's (f64 and c128) and bitwise the port's own
unsharded product where the arithmetic is the same; FEAST eigenvalues within
1e-10 of the JAX results; direct solutions within 1e-12 of the JAX
solution, residuals <= 1e-10.

The JAX FEAST solves and the JAX sharded WELL products (Pallas in interpret
mode) are the slow parts: each runs once, in a module fixture or a single
test.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as hst  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

import sparse_linear_tpu as sl  # noqa: E402
from sparse_linear_tpu.dist import spmv as jds  # noqa: E402
from sparse_linear_tpu.eig import feast as jfeast  # noqa: E402
from sparse_linear_tpu.solve import multifrontal as jmf  # noqa: E402
from sparse_linear_tpu.utils import grids as jgrids  # noqa: E402
import sparse_linear_tpu_torch as st  # noqa: E402
from sparse_linear_tpu_torch.dist import (  # noqa: E402
    Mesh,
    ShardedBlock,
    ShardedDIA,
    ShardedVector,
    card_mesh,
)
from sparse_linear_tpu_torch.dist import collectives  # noqa: E402
from sparse_linear_tpu_torch.dist import spmv as tds  # noqa: E402
from sparse_linear_tpu_torch.eig import feast as tfeast  # noqa: E402
from sparse_linear_tpu_torch.eig import pipeline  # noqa: E402
from sparse_linear_tpu_torch.entry import dryrun_multichip  # noqa: E402
from sparse_linear_tpu_torch.interop.jax_state import (  # noqa: E402
    from_arrays,
    to_arrays,
)
from sparse_linear_tpu_torch.kernels.spmv_dia import (  # noqa: E402
    dia_spmv_kernel,
)
from sparse_linear_tpu_torch.solve import multifrontal as tmf  # noqa: E402
from sparse_linear_tpu_torch.solve.cg import cg  # noqa: E402
from tests.torch_parity import np_of, to_port  # noqa: E402

ND = 8


@pytest.fixture(scope="module")
def jmesh():
    return JMesh(np.array(jax.devices()[:ND]), ("rows",))


@pytest.fixture(scope="module")
def tmesh():
    return card_mesh(ND, ("rows",), device="cpu")


def _vec(rng, n, dtype):
    v = rng.standard_normal(n)
    if np.issubdtype(dtype, np.complexfloating):
        v = v + 1j * rng.standard_normal(n)
    return v.astype(dtype)


def _jax_dia(nx, dtype, rng, dim=2):
    """The nx**dim Poisson DIA of the JAX package; complex: its values
    turned by seeded phases (zeros stay zero)."""
    make = jgrids.poisson_2d if dim == 2 else jgrids.poisson_3d
    a = make(nx, dtype=np.float64, fmt="dia")
    data = np.asarray(a.data)
    if np.issubdtype(dtype, np.complexfloating):
        data = data * np.exp(1j * rng.uniform(0, 2 * np.pi, data.shape))
    return type(a)(data=jnp.asarray(data.astype(dtype)), shape=a.shape,
                   offsets=a.offsets)


def _random_csr(rng, nr, nc, n, dtype, real_values=False):
    """(JAX CSR, port CSR) of n random triples (duplicates summed)."""
    rows, cols = rng.integers(0, nr, n), rng.integers(0, nc, n)
    vals = _vec(rng, n, np.float64 if real_values else dtype)
    return (sl.from_triples((nr, nc), rows, cols, vals).tocsr(),
            st.from_triples((nr, nc), rows, cols, vals, device="cpu")
            .tocsr())


# ------------------------------------------------------------------ mesh


def test_mesh_layout_and_card_mesh():
    mesh = Mesh(np.array(["cpu"] * 8).reshape(4, 2), ("cp", "rows"))
    assert mesh.shape == {"cp": 4, "rows": 2} and mesh.size == 8
    assert mesh.shards("cp") == [torch.device("cpu")] * 4
    assert mesh.layout() == "8 shards on 1 device: cpu x8"
    with pytest.raises(ValueError, match="no axis"):
        mesh.shards("x")
    with pytest.raises(ValueError, match="axis names"):
        Mesh(["cpu"] * 2, ("a", "b"))
    cm = card_mesh((2, 3), ("a", "b"), device="cpu")
    assert cm.shape == {"a": 2, "b": 3}


def test_cp_rows_card_mesh_leaves_a_card_empty(monkeypatch):
    """On four cards ``card_mesh((2, 2), ("cp", "rows"))`` puts shard i on
    card i; ``Mesh.shards`` takes index 0 of the other axis (where the JAX
    package replicates), so the contour runs on cards 0 and 2, the row
    pieces live on cards 0 and 1, and card 3 holds no work of a row-sharded
    FEAST run."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = card_mesh((2, 2), ("cp", "rows"))
    cp = [d.index for d in mesh.shards("cp")]
    rows = [d.index for d in mesh.shards("rows")]
    assert cp == [0, 2] and rows == [0, 1]
    assert 3 not in cp + rows
    assert mesh.layout() == ("4 shards on 4 cards: cuda:0 x1, cuda:1 x1, "
                             "cuda:2 x1, cuda:3 x1")


def test_without_a_card_the_mesh_and_dry_run_raise():
    """The card is the default: without ``device=`` the mesh helper and
    the dry run raise here rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default mesh is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        card_mesh(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(4)


def test_collectives_return_fresh_tensors_in_shard_order():
    pieces = [torch.full((3,), float(i)) for i in range(4)]
    shifted = collectives.ppermute(pieces, [(i, (i + 1) % 4)
                                            for i in range(4)])
    assert [float(p[0]) for p in shifted] == [3.0, 0.0, 1.0, 2.0]
    assert all(s.data_ptr() != p.data_ptr()
               for s in shifted for p in pieces)
    partial = collectives.ppermute(pieces, [(0, 2)])
    assert [float(p.sum()) for p in partial] == [0.0, 0.0, 0.0, 0.0]
    gathered = collectives.all_gather(pieces)
    assert all(torch.equal(g, torch.cat(pieces)) for g in gathered)
    total = collectives.psum(pieces, "cpu")
    assert torch.equal(total, torch.full((3,), 6.0))
    assert total.data_ptr() != pieces[0].data_ptr()


# ------------------------------------------------------------------- DIA


@pytest.mark.parametrize("exchange", ["allgather", "halo"])
def test_sharded_dia_spmv_matches_single(jmesh, tmesh, exchange, dtype):
    """``test_dist.py::test_sharded_dia_spmv_matches_single``: 16**2 over
    8 shards against the JAX sharded product (<= 1e-12) and bitwise the
    port's unsharded kernel A (its plain version here)."""
    rng = np.random.default_rng(1)
    ja = _jax_dia(16, dtype, rng)
    x = _vec(rng, 256, dtype)
    y_jax = jds.dia_spmv_sharded(jds.shard_dia_rows(ja, jmesh),
                                 jnp.asarray(x), jmesh, exchange=exchange)
    ta = to_port(ja)
    sh = tds.shard_dia_rows(ta, tmesh)
    assert isinstance(sh, ShardedDIA) and sh.halo == 16
    y = tds.dia_spmv_sharded(sh, torch.as_tensor(x), tmesh,
                             exchange=exchange)
    assert isinstance(y, ShardedVector) and y.blocks == (32,) * ND
    np.testing.assert_allclose(np_of(y.full()), np.asarray(y_jax), rtol=0,
                               atol=1e-12)
    assert torch.equal(y.full(), dia_spmv_kernel(ta, torch.as_tensor(x)))


def test_sharded_dia_called_twice_is_bitwise(tmesh):
    """``test_dist.py::test_sharded_spmv_under_jit``: the JAX test compiles
    the sharded product; its counterpart here is the same sharded operator
    called twice (and through ``spmv_sharded``), bitwise, with a sharded x
    taken as it is."""
    from sparse_linear_tpu_torch.utils.grids import poisson_2d

    a = poisson_2d(16, dtype=torch.float64, fmt="dia", device="cpu")
    sh = tds.shard_dia_rows(a, tmesh)
    x = ShardedVector.from_tensor(torch.ones(256, dtype=torch.float64),
                                  tmesh)
    y1 = tds.dia_spmv_sharded(sh, x, tmesh, exchange="halo")
    y2 = tds.dia_spmv_sharded(sh, x, tmesh, exchange="halo")
    y3 = tds.spmv_sharded(sh, x, tmesh)
    assert all(torch.equal(p, q) and torch.equal(p, r)
               for p, q, r in zip(y1.pieces, y2.pieces, y3.pieces))
    ref = np.asarray(jgrids.poisson_2d(16, dtype=np.float64).todense()) \
        @ np.ones(256)
    np.testing.assert_allclose(np_of(y1.full()), ref, atol=1e-12)


def test_halo_fallback_when_band_too_wide(jmesh, tmesh):
    """4**2 over 8 shards: 2 rows a shard < halo 4, so "halo" silently
    takes the all-gather (the JAX rule), with the JAX package's result."""
    rng = np.random.default_rng(2)
    ja = _jax_dia(4, np.float64, rng)
    x = rng.standard_normal(16)
    y_jax = jds.dia_spmv_sharded(jds.shard_dia_rows(ja, jmesh),
                                 jnp.asarray(x), jmesh, exchange="halo")
    sh = tds.shard_dia_rows(to_port(ja), tmesh)
    assert sh.halo_slabs is None
    y = tds.dia_spmv_sharded(sh, torch.as_tensor(x), tmesh, exchange="halo")
    y_ag = tds.dia_spmv_sharded(sh, torch.as_tensor(x), tmesh,
                                exchange="allgather")
    assert torch.equal(y.full(), y_ag.full())
    np.testing.assert_allclose(np_of(y.full()), np.asarray(y_jax), rtol=0,
                               atol=1e-12)


def test_dia_errors_match_jax(jmesh, tmesh):
    a = _jax_dia(3, np.float64, None)  # 9 rows over 8 shards
    with pytest.raises(ValueError, match="not divisible by mesh axis size"):
        jds.dia_spmv_sharded(a, jnp.ones(9), jmesh)
    with pytest.raises(ValueError, match="not divisible by mesh axis size"):
        tds.dia_spmv_sharded(to_port(a), torch.ones(9, dtype=torch.float64),
                             tmesh)
    b = to_port(_jax_dia(4, np.float64, None))
    with pytest.raises(ValueError, match="unknown exchange strategy"):
        tds.dia_spmv_sharded(b, torch.ones(16, dtype=torch.float64), tmesh,
                             exchange="ring")


def test_ring_wrap_around_meets_zero_data(tmesh):
    """The halo's ring wraps the last shard's x onto the first shard's
    lower band: ``csr_to_dia`` stores zeros there, so a huge x at the far
    end changes nothing at the other (and the result stays the unsharded
    one)."""
    from sparse_linear_tpu_torch.formats.structured import csr_to_dia
    from sparse_linear_tpu_torch.utils.grids import poisson_2d

    a = csr_to_dia(poisson_2d(16, dtype=torch.float64, device="cpu"))
    off = a.offsets.index(-16)
    assert torch.equal(a.data[off, :16], torch.zeros(16, dtype=a.dtype))
    x = torch.ones(256, dtype=torch.float64)
    x[-16:] = 1e300
    y = tds.dia_spmv_sharded(tds.shard_dia_rows(a, tmesh), x, tmesh)
    assert torch.equal(y.full(), dia_spmv_kernel(a, x))
    assert float(y.pieces[0][0]) == 2.0


def test_sharded_3d_poisson_spmv(jmesh, tmesh):
    """``test_dist.py::test_sharded_3d_poisson_spmv`` (at 12**3: 216 rows
    a shard > the +-144 band): the 7-point operator, halo and all-gather,
    against the JAX package and the dense product."""
    rng = np.random.default_rng(5)
    ja = _jax_dia(12, np.float64, rng, dim=3)
    x = rng.standard_normal(12 ** 3)
    dense = np.asarray(jgrids.poisson_3d(12, dtype=np.float64).todense()) @ x
    jsh = jds.shard_dia_rows(ja, jmesh)
    sh = tds.shard_dia_rows(to_port(ja), tmesh)
    assert sh.halo == 144 and sh.halo_slabs is not None
    for exchange in ("halo", "allgather"):
        y = np_of(tds.dia_spmv_sharded(sh, torch.as_tensor(x), tmesh,
                                       exchange=exchange).full())
        y_jax = np.asarray(jds.dia_spmv_sharded(jsh, jnp.asarray(x), jmesh,
                                                exchange=exchange))
        np.testing.assert_allclose(y, y_jax, rtol=0, atol=1e-12)
        np.testing.assert_allclose(y, dense, atol=1e-11)


def test_sharded_cg_matches_unsharded(tmesh):
    """``solve.cg.cg`` runs unchanged on sharded vectors (the dry run's step
    iterated): the same iterations as on the whole vectors, the solution
    within 1e-12 (the psum orders the dots' sums differently)."""
    from sparse_linear_tpu_torch.utils.grids import poisson_2d

    a = poisson_2d(32, dtype=torch.float64, fmt="dia", device="cpu")
    b = torch.as_tensor(np.random.default_rng(8).standard_normal(1024))
    sh = tds.shard_dia_rows(a, tmesh)
    res = cg(lambda v: tds.dia_spmv_sharded(sh, v, tmesh),
             ShardedVector.from_tensor(b, tmesh), tol=1e-10, maxiter=500)
    ref = cg(a.__matmul__, b, tol=1e-10, maxiter=500)
    assert res.converged and res.iterations == ref.iterations
    np.testing.assert_allclose(np_of(res.x.full()), np_of(ref.x), rtol=0,
                               atol=1e-12)
    true = torch.linalg.vector_norm(b - a @ res.x.full()) \
        / torch.linalg.vector_norm(b)
    assert float(true) <= 1e-10


@pytest.mark.parametrize("g,nshards", [(16, 8), (12, 5)])
@pytest.mark.parametrize("exchange", ["halo", "allgather"])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_spmm_sharded_dia_is_the_unsharded_kernel(g, nshards, exchange,
                                                   dtype):
    """The multi-RHS form on DIA slabs (kernel A's multi-RHS form, its
    plain version here): halo and all-gather, 144 rows over 5 shards on
    zero-padded slabs (``shard_dia_rows(pad=True)``), a ShardedBlock or a
    plain (n, m) X: bitwise the unsharded product."""
    from sparse_linear_tpu_torch.kernels.spmv_dia import dia_spmm_kernel

    rng = np.random.default_rng(11)
    a = to_port(_jax_dia(g, dtype, rng))
    n = g * g
    x = torch.as_tensor(_vec(rng, n * 7, dtype).reshape(n, 7))
    mesh = card_mesh(nshards, ("rows",), device="cpu")
    sh = tds.shard_dia_rows(a, mesh, pad=True)
    assert sh.n_local == -(-n // nshards)
    ref = dia_spmm_kernel(a, x)
    for xin in (x, ShardedBlock.from_tensor(x, mesh)):
        y = tds.spmm_sharded(sh, xin, mesh) if exchange == "halo" else \
            tds.dia_spmv_sharded(sh, xin, mesh, exchange="allgather")
        assert isinstance(y, ShardedBlock) and y.length == n
        assert y.blocks == (sh.n_local,) * nshards
        assert torch.equal(y.full(), ref)
        assert not y.pieces[-1][n - (nshards - 1) * sh.n_local:].any()
    if n % nshards:
        with pytest.raises(ValueError, match="not divisible"):
            tds.shard_dia_rows(a, mesh)
    with pytest.raises(ValueError, match=r"\(n, m\)"):
        tds.spmm_sharded(sh, ShardedVector.from_tensor(x[:, 0], mesh), mesh)


def test_sharded_block_reductions():
    """``ShardedBlock``'s Gram product, product with a small matrix and
    column norms against the whole block's (1e-12), rows past the length
    zero; ``split`` cuts an (n, m) tensor."""
    rng = np.random.default_rng(12)
    mesh = card_mesh(3, ("rows",), device="cpu")
    p = torch.as_tensor(rng.standard_normal((10, 4))
                        + 1j * rng.standard_normal((10, 4)))
    q = torch.as_tensor(rng.standard_normal((10, 4))).to(p.dtype)
    w = rng.standard_normal((4, 2))
    ps, qs = ShardedBlock.from_tensor(p, mesh), ShardedBlock.from_tensor(q,
                                                                         mesh)
    assert ps.blocks == (4, 4, 4) and ps.width == 4 and ps.length == 10
    assert not ps.pieces[-1][2:].any()
    torch.testing.assert_close(ps.gram(qs), p.mH @ q, rtol=0, atol=1e-12)
    pw = ps @ w
    assert isinstance(pw, ShardedBlock) and pw.width == 2
    torch.testing.assert_close(pw.full(), p @ torch.as_tensor(w).to(p.dtype),
                               rtol=0, atol=1e-12)
    torch.testing.assert_close(ps.col_norms(),
                               torch.linalg.vector_norm(p, dim=0), rtol=0,
                               atol=1e-12)
    d = ps - qs * torch.arange(4.0)[None, :]
    torch.testing.assert_close(d.full(), p - q * torch.arange(4.0)[None, :],
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="layouts differ"):
        ps.gram(ShardedBlock.from_tensor(q, mesh, block=5))


@pytest.mark.parametrize("fmt", ["well", "ell", "bsr"])
@pytest.mark.parametrize("exchange", ["window", "allgather"])
def test_spmm_sharded_unstructured(fmt, exchange):
    """The multi-RHS form on WELL slabs (kernel D, its plain version here),
    ELL and BSR slabs (plain products), with the window exchange and the
    all-gather, on the 64**2 operator over 4 shards (1024-row WELL slabs,
    so the window plan is the JAX package's): within 1e-12 of the
    unsharded WELL product and of the dense one."""
    from sparse_linear_tpu_torch.formats.well import csr_to_well
    from sparse_linear_tpu_torch.kernels.spmv_well import well_spmm
    from sparse_linear_tpu_torch.utils.grids import poisson_2d

    g = 64
    a = poisson_2d(g, dtype=torch.float64, device="cpu")
    x = torch.as_tensor(np.random.default_rng(13).standard_normal(
        (g * g, 5)))
    mesh = card_mesh(4, ("rows",), device="cpu")
    kw = {"block_shape": (8, 16)} if fmt == "bsr" else {}
    sh = tds.shard_rows(a, mesh, fmt=fmt, exchange=exchange, **kw)
    assert (sh.xplan is not None) == (exchange == "window")
    y = tds.spmm_sharded(sh, ShardedBlock.from_tensor(x, mesh), mesh)
    assert isinstance(y, ShardedBlock) and y.blocks == (1024,) * 4
    ref = well_spmm(csr_to_well(a), x)
    np.testing.assert_allclose(np_of(y.full()), np_of(ref), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(np_of(y.full()), np_of(a.todense() @ x),
                               rtol=0, atol=1e-12)


# ------------------------------------------------------- ELL / BSR / WELL


@pytest.mark.parametrize("fmt", ["well", "bsr", "ell"])
def test_sharded_cg_on_unaligned_slabs(tmesh, fmt):
    """CG on a row-sharded ELL / BSR / WELL whose slab heights are not
    ceil(n / shards): the permuted 60**2 Poisson operator over 8 shards
    (WELL slabs of 1024 rows, BSR slabs of 57 blocks of 8, x in segments
    of 450).  The products come back in x's layout, so ``solve.cg.cg``
    runs on them; the true residual meets the tolerance."""
    from sparse_linear_tpu_torch.utils.grids import poisson_2d

    g = 60
    n = g * g
    rng = np.random.default_rng(12)
    coo = poisson_2d(g, dtype=torch.float64, device="cpu").tocoo()
    perm = torch.as_tensor(rng.permutation(n))
    a = st.from_triples((n, n), perm[coo.row.long()], perm[coo.col.long()],
                        coo.data, device="cpu").tocsr()
    b = torch.as_tensor(rng.standard_normal(n))
    sh = tds.shard_rows(a, tmesh, fmt=fmt)
    bs = ShardedVector.from_tensor(b, tmesh)
    y = tds.spmv_sharded(sh, bs, tmesh)
    assert y.blocks == bs.blocks == (450,) * ND
    np.testing.assert_allclose(np_of(y.full()), np_of(a @ b), rtol=0,
                               atol=1e-12)
    res = cg(lambda v: tds.spmv_sharded(sh, v, tmesh), bs, tol=1e-10,
             maxiter=1000)
    true = torch.linalg.vector_norm(b - a @ res.x.full()) \
        / torch.linalg.vector_norm(b)
    assert res.converged and float(true) <= 1e-9


@pytest.mark.parametrize("fmt", ["ell", "bsr"])
def test_sharded_unstructured_spmv(jmesh, tmesh, fmt, dtype):
    """``test_dist.py::test_sharded_unstructured_spmv``: a random 100 x 84
    pattern (not divisible by 8 or the blocks) as ELL / BSR over 8 shards,
    against the JAX ``spmv_sharded`` (<= 1e-12) and the dense product."""
    rng = np.random.default_rng(7)
    ja, ta = _random_csr(rng, 100, 84, 100 * 84 // 6, dtype)
    x = _vec(rng, 84, dtype)
    kw = {"block_shape": (4, 8)} if fmt == "bsr" else {}
    y_jax = jds.spmv_sharded(jds.shard_rows(ja, jmesh, fmt=fmt, **kw),
                             jnp.asarray(x), jmesh)
    sh = tds.shard_rows(ta, tmesh, fmt=fmt, **kw)
    assert isinstance(sh, tds.ShardedELL if fmt == "ell" else tds.ShardedBSR)
    y = tds.spmv_sharded(sh, torch.as_tensor(x), tmesh)
    assert y.length == 100
    np.testing.assert_allclose(np_of(y.full()), np.asarray(y_jax), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(np_of(y.full()),
                               np.asarray(ja.todense()) @ x, atol=1e-11)


def test_shard_rows_auto_picks_dia_for_stencil(tmesh):
    from sparse_linear_tpu_torch.utils.grids import poisson_2d

    a = poisson_2d(16, dtype=torch.float64, device="cpu")
    sh = tds.shard_rows(a, tmesh, fmt="auto")
    assert isinstance(sh, ShardedDIA)
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(256))
    np.testing.assert_allclose(np_of(tds.spmv_sharded(sh, x, tmesh).full()),
                               np_of(a.todense() @ x), atol=1e-12)
    rng = np.random.default_rng(3)
    _, tr = _random_csr(rng, 300, 300, 3000, np.float64)
    assert isinstance(tds.shard_rows(tr, tmesh), tds.ShardedWELL)


@pytest.mark.parametrize("case", ["f64", "c128", "real_A_complex_x"])
def test_sharded_well_spmv(jmesh, tmesh, case):
    """``test_dist.py::test_sharded_well_spmv`` (f64, c128) and
    ``::test_sharded_well_spmv_mixed_real_complex`` (a real WELL times a
    complex x, the FEAST contour case): a random 300 x 260 pattern packed
    slab by slab as WELL, against the JAX sharded product (its Pallas
    kernel in interpret mode, one real pass per pair of planes; <= 1e-12)
    and scipy's.  The c128 operator meets a real x in the JAX comparison
    (two plane passes, not four: the interpret-mode kernel costs seconds a
    pass) and a complex x against scipy."""
    import scipy.sparse as sp

    rng = np.random.default_rng(11)
    dtype = np.complex128 if case == "c128" else np.float64
    ja, ta = _random_csr(rng, 300, 260, 500, dtype)
    x = _vec(rng, 260, np.complex128 if case == "real_A_complex_x"
             else np.float64)
    jsh = jds.shard_rows(ja, jmesh, fmt="well")
    y_jax = np.asarray(jds.spmv_sharded(jsh, jnp.asarray(x), jmesh))
    sh = tds.shard_rows(ta, tmesh, fmt="well")
    assert isinstance(sh, tds.ShardedWELL) and sh.xplan == jsh.xplan
    y = np_of(tds.spmv_sharded(sh, torch.as_tensor(x), tmesh).full())
    assert y.dtype == y_jax.dtype
    np.testing.assert_allclose(y, y_jax, rtol=0, atol=1e-12)
    a_sp = sp.csr_matrix((np.asarray(ja.data), np.asarray(ja.indices),
                          np.asarray(ja.indptr)), shape=ja.shape)
    np.testing.assert_allclose(y, a_sp @ x, atol=1e-12)
    if case == "c128":
        xc = _vec(rng, 260, np.complex128)
        np.testing.assert_allclose(
            np_of(tds.spmv_sharded(sh, torch.as_tensor(xc), tmesh).full()),
            a_sp @ xc, atol=1e-12)


def test_sharded_window_exchange_3d_poisson(jmesh, tmesh):
    """``test_dist.py::test_sharded_window_exchange_3d_poisson``: ELL, BSR
    and WELL row shards of the 16**3 operator take a column-window plan;
    the plan, ``col_lo``, the stacked ``cols`` / ``indices`` and the
    exchanged element count equal the JAX package's; each product matches
    the dense one, and the pinned all-gather agrees with the window."""
    n = 16 ** 3
    ja = jgrids.poisson_3d(16, dtype=np.float64)
    ta = to_port(ja)
    x = np.random.default_rng(3).standard_normal(n)
    ref = np.asarray(ja.todense()) @ x
    L = n // ND
    for name, jf, tf in (
        ("ell", jds.shard_ell_rows, tds.shard_ell_rows),
        ("bsr", lambda m, me: jds.shard_bsr_rows(m, me, block_shape=(8, 16)),
         lambda m, me: tds.shard_bsr_rows(m, me, block_shape=(8, 16))),
        ("well", jds.shard_well_rows, tds.shard_well_rows),
    ):
        jsh, sh = jf(ja, jmesh), tf(ta, tmesh)
        assert sh.xplan is not None and sh.xplan == jsh.xplan, name
        np.testing.assert_array_equal(sh.col_lo, np.asarray(jsh.col_lo))
        shipped = tds.window_exchange_elements(sh.xplan)
        assert shipped == jds.window_exchange_elements(jsh.xplan)
        assert shipped < (ND - 1) * L
        if name == "ell":
            np.testing.assert_array_equal(
                np.stack([np_of(c) for c in sh.cols]), np.asarray(jsh.cols))
        if name == "bsr":
            for leaf in ("indices", "brow"):
                np.testing.assert_array_equal(
                    np.stack([np_of(c) for c in getattr(sh, leaf)]),
                    np.asarray(getattr(jsh, leaf)))
        y = tds.spmv_sharded(sh, torch.as_tensor(x), tmesh)
        np.testing.assert_allclose(np_of(y.full()), ref, atol=1e-10,
                                   err_msg=name)
    sh_ag = tds.shard_ell_rows(ta, tmesh, exchange="allgather")
    assert sh_ag.xplan is None
    y_w = tds.spmv_sharded(tds.shard_ell_rows(ta, tmesh), torch.as_tensor(x),
                           tmesh)
    y_ag = tds.spmv_sharded(sh_ag, torch.as_tensor(x), tmesh)
    assert torch.equal(y_w.full(), y_ag.full())
    # 20 columns in blocks of 16: the aligned window (32) passes the 24
    # padded columns, so no plan exists, and "window" says so
    _, narrow = _random_csr(np.random.default_rng(4), 64, 20, 300,
                            np.float64)
    with pytest.raises(ValueError, match="no usable window plan"):
        tds.shard_bsr_rows(narrow, tmesh, block_shape=(4, 16),
                           exchange="window")


def test_window_plan_that_misses_columns_is_not_used():
    """A fault of the reference, not copied: BSR in (8, 128) blocks on the
    32**2 operator over 4 devices.  The JAX plan rounds each window's start
    down to a block after sizing it, so a window ends before its slab's
    last column and the JAX product is wrong; the port computes the same
    plan, finds that it does not cover the slabs and all-gathers (auto) or
    raises (window)."""
    ja = jgrids.poisson_2d(32, dtype=np.float64)
    x = np.random.default_rng(9).standard_normal(1024)
    ref = np.asarray(ja.todense()) @ x
    jmesh4 = JMesh(np.array(jax.devices()[:4]), ("rows",))
    jsh = jds.shard_bsr_rows(ja, jmesh4)
    assert jsh.xplan == (-1, 1, 128, 128, 256, 384)
    y_jax = np.asarray(jds.spmv_sharded(jsh, jnp.asarray(x), jmesh4))
    assert np.abs(y_jax - ref).max() > 1.0
    ta, tmesh4 = to_port(ja), card_mesh(4, device="cpu")
    nr = 1024
    ind = np.asarray(ja.indptr)
    lo, hi = tds._slab_col_ranges(ind, np.asarray(ja.indices),
                                  np.asarray(ja.data), 4, nr // 4)
    plan = tds._col_window_plan(lo, hi, 256, 4, 1024, align=128)
    assert plan["plan"] == jsh.xplan and not tds._covers(plan, lo, hi)
    sh = tds.shard_bsr_rows(ta, tmesh4)
    assert sh.xplan is None
    np.testing.assert_allclose(
        np_of(tds.spmv_sharded(sh, torch.as_tensor(x), tmesh4).full()), ref,
        atol=1e-12)
    with pytest.raises(ValueError, match="no usable window plan"):
        tds.shard_bsr_rows(ta, tmesh4, exchange="window")


@settings(max_examples=60, deadline=None)
@given(ndev=hst.integers(1, 8), seg=hst.integers(1, 40),
       align=hst.sampled_from([1, 2, 8]), data=hst.data())
def test_col_window_plan_equals_jax(ndev, seg, align, data):
    """The column-window plan is the JAX package's, element for element, on
    random windows (empty slabs included) and alignments."""
    L = seg
    nc_pad = ndev * L
    lo = np.asarray(data.draw(hst.lists(hst.integers(0, nc_pad - 1),
                                        min_size=ndev, max_size=ndev)))
    width = np.asarray(data.draw(hst.lists(hst.integers(-3, nc_pad),
                                           min_size=ndev, max_size=ndev)))
    hi = np.clip(lo + width, 0, nc_pad)
    j = jds._col_window_plan(lo, hi, L, ndev, nc_pad, align=align)
    t = tds._col_window_plan(lo, hi, L, ndev, nc_pad, align=align)
    if j is None:
        assert t is None
        return
    assert t["plan"] == j["plan"] and t["shipped"] == j["shipped"]
    np.testing.assert_array_equal(t["lo"], j["lo"])
    assert t["lo"].dtype == j["lo"].dtype
    assert tds.window_exchange_elements(t["plan"]) == t["shipped"]


def test_jax_state_carries_the_sharded_kinds(jmesh, tmesh):
    """The JAX package's sharded DIA, ELL, BSR (both ways) and WELL (one
    way: each slab decoded and repacked as the port's own) cross onto a
    port mesh as numpy arrays and compute the port's own products
    bitwise."""
    ja3 = jgrids.poisson_3d(16, dtype=np.float64)
    ta3 = to_port(ja3)
    x = torch.as_tensor(np.random.default_rng(6).standard_normal(16 ** 3))
    jdia = jgrids.poisson_3d(16, dtype=np.float64, fmt="dia")
    cases = (
        ("sharded_dia", jds.shard_dia_rows(jdia, jmesh),
         {"data": np.asarray(jdia.data)}, jdia.offsets,
         tds.shard_dia_rows(to_port(jdia), tmesh)),
        ("sharded_ell", jds.shard_ell_rows(ja3, jmesh), None, None,
         tds.shard_ell_rows(ta3, tmesh)),
        ("sharded_bsr", jds.shard_bsr_rows(ja3, jmesh, block_shape=(8, 16)),
         None, None, tds.shard_bsr_rows(ta3, tmesh, block_shape=(8, 16))),
        ("sharded_well", jds.shard_well_rows(ja3, jmesh), None, None,
         tds.shard_well_rows(ta3, tmesh)),
    )
    for kind, jsh, arrays, offsets, own in cases:
        if arrays is None:
            names = {"sharded_ell": ("cols", "vals"),
                     "sharded_bsr": ("brow", "indices", "blocks"),
                     "sharded_well": ("bases", "idx", "vals")}[kind]
            arrays = {n: np.asarray(getattr(jsh, n)) for n in names}
            arrays.update(col_lo=np.asarray(jsh.col_lo), xplan=jsh.xplan)
        t = from_arrays(kind, arrays, jsh.shape, offsets, mesh=tmesh)
        assert type(t) is type(own)
        y, y_own = (tds.spmv_sharded(m, x, tmesh) for m in (t, own))
        assert torch.equal(y.full(), y_own.full()), kind
        if kind == "sharded_well":
            for w, wo in zip(t.wells, own.wells):
                assert all(torch.equal(getattr(w, f), getattr(wo, f))
                           for f in ("slice_ptr", "cols", "vals"))
            continue
        back_kind, back, shape, back_off = to_arrays(t)
        assert back_kind == kind and shape == tuple(jsh.shape)
        for n, arr in arrays.items():
            if n == "xplan":
                assert back[n] == arr
            else:
                np.testing.assert_array_equal(back[n], arr)
    with pytest.raises(ValueError, match="mesh="):
        from_arrays("sharded_dia", {"data": np.asarray(jdia.data)},
                    jdia.shape, jdia.offsets)


# ------------------------------------------------------------- multifrontal


def test_multichip_multifrontal_factor_solve(tmesh):
    """``test_dist.py::test_multichip_multifrontal_factor_solve``: 24**2
    Cholesky with the fronts over 8 shards against the JAX package's
    front-sharded factor and solve (<= 1e-12), residual <= 1e-10."""
    g = 24
    ja = jgrids.poisson_2d(g, dtype=np.float64)
    b = np.random.default_rng(3).standard_normal(g * g)
    jsym = jmf.analyze(ja, dims=(g, g))
    jf = jmf.factor(ja, jsym, kind="cholesky",
                    mesh=JMesh(np.array(jax.devices()[:ND]), ("fronts",)))
    x_jax = np.asarray(jmf.solve(jf, jnp.asarray(b)))
    ta = to_port(ja)
    tf = tmf.factor(ta, tmf.analyze(ta, dims=(g, g)), kind="cholesky",
                    mesh=card_mesh(ND, ("fronts",), device="cpu"))
    x = np_of(tmf.solve(tf, torch.as_tensor(b)))
    np.testing.assert_allclose(x, x_jax, rtol=0, atol=1e-12)
    r = np.linalg.norm(np.asarray(ja.todense()) @ x - b) / np.linalg.norm(b)
    assert r <= 1e-10


@pytest.mark.parametrize("g,nshards,kind", [(24, 2, "lu"), (24, 4, "cholesky"),
                                            (64, 8, "cholesky")])
def test_front_sharded_blocks_are_the_unsharded_ones(g, nshards, kind):
    """Buckets whose front count divides by the shards are split (at least
    one here): every block, and the breakdown count, bitwise the unsharded
    factorization's on the CPU; ``api.factor`` passes ``mesh``/
    ``batch_axis`` through."""
    from sparse_linear_tpu_torch.solve import api
    from sparse_linear_tpu_torch.utils.grids import poisson_2d

    a = poisson_2d(g, dtype=torch.float64, device="cpu")
    sym = tmf.analyze(a, dims=(g, g))
    mesh = Mesh(["cpu"] * nshards, ("x",))
    parts = tmf._mesh_parts(sym, tmf._device_maps(sym, a.data.device),
                            mesh.shards("x"))
    assert any(p is not None for p in parts.values())
    ref = tmf.factor(a, sym, kind=kind)
    sh = api.factor(a, sym, backend="multifrontal", kind=kind, mesh=mesh,
                    batch_axis="x")
    assert ref.blocks.keys() == sh.blocks.keys()
    for k in ref.blocks:
        for name, t in ref.blocks[k].items():
            assert torch.equal(sh.blocks[k][name], t), (k, name)


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
@pytest.mark.parametrize("kind", ["cholesky", "lu"])
def test_front_sharded_solve_is_the_unsharded_one(kind, dtype):
    """``poisson_2d(20)`` with its fronts over 4 CPU shards: every split
    bucket's blocks come back in the unsharded layout (strides and conj
    views: torch.linalg's column-major blocks, Cholesky's g21 = g12^H and
    its expanded identity permutation), so a solve is ``torch.equal`` to
    the unsharded solve."""
    from sparse_linear_tpu_torch.utils.grids import poisson_2d

    g = 20
    a = poisson_2d(g, dtype=dtype, device="cpu")
    sym = tmf.analyze(a, dims=(g, g))
    ref = tmf.factor(a, sym, kind=kind)
    sh = tmf.factor(a, sym, kind=kind, mesh=Mesh(["cpu"] * 4, ("x",)))
    parts = tmf._mesh_parts(sym, tmf._device_maps(sym, a.data.device),
                            [torch.device("cpu")] * 4)
    assert any(p is not None for p in parts.values())
    for k in ref.blocks:
        for name, t in ref.blocks[k].items():
            u = sh.blocks[k][name]
            assert torch.equal(u, t), (k, name)
            assert u.stride() == t.stride(), (k, name)
            assert u.is_conj() == t.is_conj(), (k, name)
    b = torch.as_tensor(np.random.default_rng(14).standard_normal(
        (g * g, 3))).to(dtype)
    for trans in (False, True):
        assert torch.equal(tmf.solve(sh, b, trans), tmf.solve(ref, b, trans))
    assert torch.equal(tmf.solve(sh, b[:, 0]), tmf.solve(ref, b[:, 0]))


# ------------------------------------------------------------------ FEAST


def _lam3(g):
    k = np.arange(1, g + 1)
    lam1 = 4 * np.sin(k * np.pi / (2 * (g + 1))) ** 2
    return np.sort((lam1[:, None, None] + lam1[None, :, None]
                    + lam1[None, None, :]).ravel())


G3 = 6
LAM3 = _lam3(G3)
# lam3[4:7] is a degenerate triple: cut in the strict gap after it
HI3 = float((LAM3[6] + LAM3[7]) / 2)
P1 = dict(tol=1e-12, contour_points=8)
P3 = dict(tol=1e-10, contour_points=8, complex_strategy="native")


@pytest.fixture(scope="module")
def jax_feast():
    """The JAX contour-sharded solves, once: the 1D window of
    ``test_distributed_feast_contour_sharding`` and the 3D one of
    ``test_distributed_feast_3d_poisson`` (at 6**3)."""
    cp = JMesh(np.array(jax.devices()[:ND]), ("cp",))
    one = jfeast.eigsh(8, (0.5, 1.5), jgrids.laplacian_1d(24,
                                                          dtype=np.float64),
                       jfeast.FeastParams(**P1), mesh=cp)
    three = jfeast.eigsh(12, (0.0, HI3),
                         jgrids.poisson_3d(G3, dtype=np.float64),
                         jfeast.FeastParams(**P3), mesh=cp)
    return {"1d": one, "3d": three}


@pytest.fixture(scope="module")
def cp_mesh():
    return card_mesh(ND, ("cp",), device="cpu")


def test_distributed_feast_contour_sharding(jax_feast, cp_mesh):
    """``test_dist.py::test_distributed_feast_contour_sharding``: the 24-pt
    1D Laplacian's window with its 8 nodes over 8 shards: the JAX count
    and eigenvalues (<= 1e-10), epsout < 1e-10, and the port's unsharded
    solve's eigenvalues within 1e-12."""
    from sparse_linear_tpu_torch.utils.grids import laplacian_1d

    a = laplacian_1d(24, dtype=torch.float64, device="cpu")
    res = tfeast.eigsh(8, (0.5, 1.5), a, tfeast.FeastParams(**P1),
                       mesh=cp_mesh)
    assert pipeline.last_run["mode"] == "sharded"
    assert len(pipeline.last_run["shards"]) == ND
    j = jax_feast["1d"]
    assert res.n_found == j.n_found and res.epsout < 1e-10
    np.testing.assert_allclose(res.values, np.asarray(j.values), rtol=0,
                               atol=1e-10)
    single = tfeast.eigsh(8, (0.5, 1.5), a, tfeast.FeastParams(**P1))
    np.testing.assert_allclose(res.values, single.values, rtol=0, atol=1e-12)


def test_distributed_feast_3d_poisson(jax_feast, cp_mesh):
    """``test_dist.py::test_distributed_feast_3d_poisson`` at 6**3: the 7
    pairs below the gap after the degenerate triple, against the analytic
    spectrum and the JAX results (<= 1e-10)."""
    from sparse_linear_tpu_torch.utils.grids import poisson_3d

    res = tfeast.eigsh(12, (0.0, HI3),
                       poisson_3d(G3, dtype=torch.float64, device="cpu"),
                       tfeast.FeastParams(**P3), mesh=cp_mesh)
    j = jax_feast["3d"]
    assert res.n_found == j.n_found == 7
    np.testing.assert_allclose(res.values, LAM3[:7], rtol=1e-10)
    np.testing.assert_allclose(res.values, np.sort(np.asarray(j.values)),
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("batching", ["vmap", "loop"])
def test_sharded_contour_modes_agree(cp_mesh, batching, monkeypatch):
    """Each shard runs its nodes in the mode the byte plan picks
    (batched here), or the forced one, or streaming under a 1-byte budget:
    the same eigenvalues within 1e-12; 4 nodes over 8 shards raise the JAX
    package's divisibility error."""
    from sparse_linear_tpu_torch.utils.grids import laplacian_1d

    a = laplacian_1d(24, dtype=torch.float64, device="cpu")
    ref = tfeast.eigsh(8, (0.5, 1.5), a, tfeast.FeastParams(**P1),
                       mesh=cp_mesh)
    assert pipeline.last_run["shard_mode"] == "batched"
    res = tfeast.eigsh(8, (0.5, 1.5), a,
                       tfeast.FeastParams(contour_batching=batching, **P1),
                       mesh=card_mesh(4, ("cp",), device="cpu"))
    assert pipeline.last_run["shard_mode"] == {"vmap": "batched",
                                               "loop": "per-node"}[batching]
    np.testing.assert_allclose(res.values, ref.values, rtol=0, atol=1e-12)
    monkeypatch.setenv("SLT_FEAST_MEMORY_BUDGET", "1")
    res = tfeast.eigsh(8, (0.5, 1.5), a, tfeast.FeastParams(**P1),
                       mesh=card_mesh(2, ("cp",), device="cpu"))
    assert pipeline.last_run["shard_mode"] == "streaming"
    np.testing.assert_allclose(res.values, ref.values, rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="not divisible"):
        tfeast.eigsh(8, (0.5, 1.5), a, tfeast.FeastParams(contour_points=4),
                     mesh=cp_mesh)


def test_distributed_feast_2d_mesh():
    """``test_dist.py::test_distributed_feast_2d_mesh``: on a (4, 2)
    ("cp", "rows") mesh the contour nodes go over "cp" and the subspace is
    row-sharded over "rows": eigenvalues within 1e-12 of the unsharded
    port and of the JAX package on its (4, 2) mesh of virtual devices, the
    unsharded loop count, epsout < 1e-10 (a rows axis of one shard runs
    unsharded rows)."""
    from sparse_linear_tpu_torch.utils.grids import laplacian_1d

    p = dict(tol=1e-12)
    j = jfeast.eigsh(6, (0.2, 1.2), jgrids.laplacian_1d(16, dtype=np.float64),
                     jfeast.FeastParams(**p),
                     mesh=JMesh(np.array(jax.devices()[:ND]).reshape(4, 2),
                                ("cp", "rows")))
    a = laplacian_1d(16, dtype=torch.float64, device="cpu")
    single = tfeast.eigsh(6, (0.2, 1.2), a, tfeast.FeastParams(**p))
    mesh2 = Mesh(np.array(["cpu"] * 8).reshape(4, 2), ("cp", "rows"))
    res = tfeast.eigsh(6, (0.2, 1.2), a, tfeast.FeastParams(**p), mesh=mesh2)
    run = pipeline.last_run
    assert run["mode"] == "sharded" and len(run["shards"]) == 4
    assert len(run["rows_shards"]) == 2 and run["rows_local"] == 8
    assert res.n_found > 0 and res.epsout < 1e-10
    assert res.n_found == single.n_found == j.n_found
    assert res.iterations == single.iterations
    np.testing.assert_allclose(res.values, single.values, rtol=0, atol=1e-12)
    np.testing.assert_allclose(res.values, np.sort(np.asarray(j.values)),
                               rtol=0, atol=1e-12)
    assert res.vectors.shape == single.vectors.shape
    assert res.subspace.shape == (16, 6)
    res = tfeast.eigsh(6, (0.2, 1.2), a, tfeast.FeastParams(**p),
                       mesh=Mesh(np.array(["cpu"] * 4).reshape(4, 1),
                                 ("cp", "rows")))
    assert pipeline.last_run["rows_shards"] == []
    assert res.n_found > 0 and res.epsout < 1e-10


def _permuted_port(g, seed=7):
    """The port's g**2 five-point operator with rows and columns relabelled
    by one seeded permutation (no band: the WELL route)."""
    from sparse_linear_tpu_torch.utils.grids import poisson_2d

    coo = poisson_2d(g, dtype=torch.float64, device="cpu").tocoo()
    perm = np.random.default_rng(seed).permutation(g * g)
    return st.from_triples((g * g, g * g), perm[np_of(coo.row)],
                           perm[np_of(coo.col)], np_of(coo.data),
                           device="cpu").tocsr()


def _gauge_port(g, theta=0.3):
    """The g**2 five-point operator with the phase e^{i theta} on its
    x-links: complex Hermitian, banded, Poisson's spectrum."""
    from sparse_linear_tpu_torch.utils.grids import poisson_2d

    coo = poisson_2d(g, dtype=torch.float64, device="cpu").tocoo()
    r, c = np_of(coo.row), np_of(coo.col)
    vals = np_of(coo.data) * np.exp(1j * theta * (r % g - c % g))
    return st.from_triples((g * g, g * g), r, c, vals, device="cpu").tocsr()


def _row_case(case):
    """(A, B or None, m0, interval, params, mesh shape, route of A)."""
    from sparse_linear_tpu_torch.utils.grids import laplacian_1d, poisson_2d

    g = 12
    mf = dict(tol=1e-12, backend="multifrontal")
    if case == "dia":
        return (poisson_2d(g, dtype=torch.float64, device="cpu"), None, 16,
                (0.0, 1.0), dict(mf, dims=(g, g)), (2, 2), "dia")
    if case == "well permuted":
        return (_permuted_port(g), None, 16, (0.0, 1.0), mf, (2, 2), "well")
    if case == "complex":
        return (_gauge_port(g), None, 16, (0.0, 1.0), dict(mf, dims=(g, g)),
                (2, 2), "dia")
    if case == "rows not divisible":
        return (laplacian_1d(15, dtype=torch.float64, device="cpu"), None, 6,
                (0.2, 1.2), dict(tol=1e-12), (2, 4), "dia")
    if case == "generalized":
        a = poisson_2d(g, dtype=torch.float64, device="cpu")
        d = 1.0 + 0.5 * np.random.default_rng(5).random(g * g)
        b = st.from_triples((g * g, g * g), np.arange(g * g),
                            np.arange(g * g), d, device="cpu").tocsr()
        return a, b, 16, (0.0, 0.8), dict(mf, dims=(g, g)), (2, 3), "dia"
    raise ValueError(case)


@pytest.mark.parametrize("case", ["dia", "well permuted", "complex",
                                  "rows not divisible", "generalized"])
def test_row_sharded_feast_matches_unsharded(case):
    """The row-sharded subspace on each route, in c128, with n that the
    rows shards do not divide (zero-padded DIA slabs) and with B != I (its
    own row-sharded DIA): the unsharded port's loop count and eigenvalues
    within 1e-12 on the interval's scale, epsout < 1e-10, and vectors and
    subspace whole, on the matrices' device."""
    a, b, m0, iv, p, shape, route = _row_case(case)
    params = tfeast.FeastParams(**p)

    def solve(mesh=None):
        if b is None:
            return tfeast.eigsh(m0, iv, a, params, mesh=mesh)
        return tfeast.geigsh(m0, iv, a, b, params, mesh=mesh)

    single = solve()
    res = solve(card_mesh(shape, ("cp", "rows"), device="cpu"))
    run = pipeline.last_run
    n = a.shape[0]
    assert run["mode"] == "sharded" and len(run["shards"]) == shape[0]
    assert len(run["rows_shards"]) == shape[1]
    assert run["rows_local"] == -(-n // shape[1])
    assert run["routes"][0] == route
    assert res.n_found == single.n_found > 0
    assert res.iterations == single.iterations
    assert res.epsout < 1e-10
    scale = max(abs(iv[0]), abs(iv[1]), 1.0)
    assert np.max(np.abs(res.values - single.values)) <= 1e-12 * scale
    assert tuple(res.vectors.shape) == (n, res.n_found)
    assert tuple(res.subspace.shape) == (n, m0)
    assert res.vectors.device == a.data.device
    assert res.vectors.dtype == single.vectors.dtype


def test_row_sharded_feast_warm_start():
    """A ``guess`` given to a row-sharded call is split over the rows
    shards: from the cold run's subspace the warm run takes the unsharded
    warm run's loops and eigenvalues (1e-12), as a tensor or numpy."""
    a, _, m0, iv, p, shape, _ = _row_case("well permuted")
    params = tfeast.FeastParams(**p)
    mesh = card_mesh(shape, ("cp", "rows"), device="cpu")
    cold = tfeast.eigsh(m0, iv, a, params, mesh=mesh)
    single = tfeast.eigsh(m0, iv, a, params, guess=cold.subspace)
    for guess in (cold.subspace, np_of(cold.subspace)):
        warm = tfeast.eigsh(m0, iv, a, params, guess=guess, mesh=mesh)
        assert len(pipeline.last_run["rows_shards"]) == shape[1]
        assert warm.iterations == single.iterations <= cold.iterations
        assert warm.n_found == single.n_found
        np.testing.assert_allclose(warm.values, single.values, rtol=0,
                                   atol=1e-12)


def test_row_sharded_byte_plan_counts_the_row_pieces():
    """``card_needs`` counts each contour shard's quadrature sum, the row
    pieces of a row-sharded subspace and the whole psum'd sum on the first
    rows shard's card, on the card that holds each."""
    from sparse_linear_tpu_torch.utils.grids import laplacian_1d

    a = laplacian_1d(40, dtype=torch.float64, device="cpu")
    pipe = pipeline._Pipeline(a, st.eye(40, dtype=torch.float64,
                                        device="cpu"), "dense", None)
    c0, c1 = torch.device("cpu", 0), torch.device("cpu", 1)
    base = pipe.needs([4], 8)
    block = 40 * 8 * 8
    need = pipe.card_needs([(c0, 4)], 8, [(c0, 20), (c1, 20)])
    for mode, v in base.items():
        assert need[c0][mode] == (v + block + pipeline._ROW_COPIES * 20 * 8 * 8
                                  + block)
        assert need[c1][mode] == pipeline._ROW_COPIES * 20 * 8 * 8
    assert pipe.card_needs([(c0, 4)], 8)[c0]["batched"] == (
        base["batched"] + block)


# ---------------------------------------------------------------- dry run


def test_dryrun_multichip_on_cpu_shards(capsys):
    """The counterpart of ``__graft_entry__.dryrun_multichip(8)``: a
    sharded CG step, contour-sharded FEAST against the analytic spectrum
    and a front-sharded factor and solve, on 8 CPU shards."""
    out = dryrun_multichip(8, device="cpu")
    assert out["feast_found"] == 8 and out["feast_epsout"] <= 1e-8
    assert out["multifrontal_rres"] <= 1e-10
    assert out["x_blocks"] == (8,) * 8 and np.isfinite(out["cg_rnorm"])
    assert "dryrun_multichip(8): ok" in capsys.readouterr().out
