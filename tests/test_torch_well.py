"""Parity of the port's WELL format, its SpMV / SpMM and format selection
with the JAX package, on the CPU.

The JAX WELL kernels run in Pallas interpret mode off the TPU (their own
default there), the f64 ones with x64 on (``tests/conftest.py``).  Interpret
mode compiles each shape for ~10 s and unrolls its chunk loop, so the
operators here are small and share one pattern: the 16**2 five-point
operator with its unknowns relabelled by a seeded permutation, the
numbering an unstructured mesh gives.  The port's wrappers take their
plain PyTorch version because the tensors lie on the CPU (the CUDA kernels
are held against that version on the card, in ``tests/test_torch_cuda.py``
and ``chip_smoke.py``).

Tolerances: max |y - y_jax| / max |y_jax| <= 1e-5 in f32 and complex64
(f32 sums in another order), 1e-12 in f64 against the JAX double-float
kernels (~1e-13 accurate), and ||y - y_csr|| / ||y_csr|| <= 1e-13 against
numpy f64 CSR SpMV (the JAX f64 kernel's contract).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import sparse_linear_tpu as sl  # noqa: E402
from sparse_linear_tpu.formats import select as jselect  # noqa: E402
from sparse_linear_tpu.formats.well import csr_to_well as j_csr_to_well  # noqa: E402
from sparse_linear_tpu.kernels import spmv_well as jk  # noqa: E402
from sparse_linear_tpu.kernels import spmv_well64 as jk64  # noqa: E402
from sparse_linear_tpu.utils import grids as jgrids  # noqa: E402
import sparse_linear_tpu_torch as st  # noqa: E402
from sparse_linear_tpu_torch.formats import select as tselect  # noqa: E402
from sparse_linear_tpu_torch.formats.structured import DIA  # noqa: E402
from sparse_linear_tpu_torch.formats.well import WELL, csr_to_well  # noqa: E402
from sparse_linear_tpu_torch.kernels import _build  # noqa: E402
from sparse_linear_tpu_torch.kernels import spmv_well as tk  # noqa: E402
from sparse_linear_tpu_torch.kernels import spmv_well64 as tk64  # noqa: E402
from tests.torch_parity import np_of, permuted_poisson, to_port  # noqa: E402

G = 16
N = G * G


@pytest.fixture(autouse=True)
def _no_launches():
    """On CPU tensors the wrappers run the plain version: no launch is
    counted and the kernel library is never built."""
    c0, d0 = tk.well_spmv.launches, tk.well_spmm.launches
    yield
    assert tk.well_spmv.launches == c0
    assert tk.well_spmm.launches == d0
    assert _build.load_library.cache_info().currsize == 0


def _rel(y, ref):
    y, ref = np_of(y), np_of(ref)
    return float(np.abs(y - ref).max() / max(np.abs(ref).max(), 1e-300))


def random_csr(rng, nr, nc, density, dtype=np.float64):
    n = int(nr * nc * density) + 1
    vals = rng.standard_normal(n)
    if np.issubdtype(dtype, np.complexfloating):
        vals = vals + 1j * rng.standard_normal(n)
    return sl.from_triples((nr, nc), rng.integers(0, nr, n),
                           rng.integers(0, nc, n), vals.astype(dtype)).tocsr()


def skewed_csr(rng, nr, nc):
    """Rows of 0-12 entries, about a tenth of them empty, and two rows of
    nc/2 entries that pad their slices."""
    lens = rng.integers(1, 13, nr)
    lens[rng.random(nr) < 0.1] = 0
    lens[[3, nr - 5]] = nc // 2
    rows = np.repeat(np.arange(nr), lens)
    cols = np.concatenate([rng.choice(nc, k, replace=False) for k in lens])
    return sl.from_triples((nr, nc), rows, cols,
                           rng.standard_normal(rows.size)).tocsr()


# ------------------------------------------------------------- the format


@pytest.mark.parametrize("case", ["random_50x70", "random_1100x900",
                                  "flat_8x5000", "skewed_300x200",
                                  "permuted_poisson", "empty_100x100",
                                  "empty_0x5", "complex_40x33"])
def test_well_roundtrip(case):
    """todense of the port's WELL equals the CSR's dense form exactly; the
    layout invariants hold (slot-major slices of 32, padding value 0)."""
    rng = np.random.default_rng(1)
    if case == "random_50x70":
        j = random_csr(rng, 50, 70, 0.2)
    elif case == "random_1100x900":
        j = random_csr(rng, 1100, 900, 0.05)
    elif case == "flat_8x5000":
        j = random_csr(rng, 8, 5000, 0.01)
    elif case == "skewed_300x200":
        j = skewed_csr(rng, 300, 200)
    elif case == "permuted_poisson":
        j = permuted_poisson(G, np.float64)
    elif case == "empty_100x100":
        j = sl.zeros((100, 100), dtype=np.float64).tocsr()
    elif case == "empty_0x5":
        j = sl.zeros((0, 5), dtype=np.float64).tocsr()
    else:
        j = random_csr(rng, 40, 33, 0.2, np.complex128)
    t = to_port(j)
    w = csr_to_well(t)
    nr, nc = t.shape
    assert w.shape == (nr, nc) and w.dtype == t.dtype
    assert w.is_complex == t.data.is_complex()
    np.testing.assert_array_equal(np_of(w.todense()), np_of(t.todense()))
    # layout: one slice per 32 rows, 32 slots per row of width
    assert w.slice_ptr.dtype == torch.int64 and w.cols.dtype == torch.int32
    assert w.n_slices == -(-nr // 32)
    widths = np_of(w.slice_ptr[1:] - w.slice_ptr[:-1]) // 32
    lens = np.diff(np_of(t.indptr))
    lens = np.pad(lens, (0, w.n_slices * 32 - nr)).reshape(-1, 32)
    np.testing.assert_array_equal(widths, lens.max(axis=1))
    assert w.c_max == (int(widths.max()) if widths.size else 0)
    assert w.fill == pytest.approx(t.nnz / max(int(w.cols.shape[0]), 1))
    assert w.slots_in_bounds
    assert int((w.vals != 0).sum()) == int((t.data != 0).sum())
    # the slot-major placement: row r's k-th entry at ptr[r//32] + 32k + r%32
    r = 3 if nr > 3 else None
    if r is not None and lens.reshape(-1)[r]:
        p0 = int(w.slice_ptr[r // 32]) + r % 32
        k = int(lens.reshape(-1)[r])
        lo, hi = int(t.indptr[r]), int(t.indptr[r + 1])
        np.testing.assert_array_equal(np_of(w.cols[p0:p0 + 32 * k:32]),
                                      np_of(t.indices[lo:hi]))


@pytest.mark.parametrize("case", ["random_50x70", "complex_40x33",
                                  "permuted_poisson"])
def test_well_todense_matches_jax(case):
    rng = np.random.default_rng(2)
    if case == "random_50x70":
        j = random_csr(rng, 50, 70, 0.2)
    elif case == "complex_40x33":
        j = random_csr(rng, 40, 33, 0.2, np.complex64)
    else:
        j = permuted_poisson(G, np.float32)
    jw = j_csr_to_well(j)
    tw = csr_to_well(to_port(j))
    assert tw.is_complex == jw.is_complex
    np.testing.assert_array_equal(np_of(tw.todense()), np_of(jw.todense()))


def test_slots_in_bounds_flags_a_corrupt_layout():
    """The kernels index without bounds checks; their wrappers refuse a
    WELL whose slots point past its arrays or columns."""
    import dataclasses

    w = csr_to_well(st.eye(40, dtype=torch.float64, device="cpu"))
    assert w.slots_in_bounds
    assert not dataclasses.replace(w, cols=w.cols + 40).slots_in_bounds
    assert not dataclasses.replace(w, cols=w.cols - 1).slots_in_bounds
    assert not dataclasses.replace(w, slice_ptr=w.slice_ptr * 2
                                   ).slots_in_bounds


def test_well_c_max_cap():
    t = to_port(skewed_csr(np.random.default_rng(3), 64, 64))
    w = csr_to_well(t)
    assert csr_to_well(t, c_max=w.c_max).c_max == w.c_max
    with pytest.raises(ValueError,
                       match=rf"^csr_to_well: pattern needs {w.c_max} "
                             rf"slots/row in a slice > c_max={w.c_max - 1}$"):
        csr_to_well(t, c_max=w.c_max - 1)


# ----------------------------------------------------------------- SpMV


@pytest.fixture(scope="module")
def p32():
    """(JAX CSR, JAX WELL, port WELL) of the permuted operator in f32."""
    j = permuted_poisson(G, np.float32)
    return j, j_csr_to_well(j), csr_to_well(to_port(j))


def test_well_spmv_f32_matches_jax(p32):
    j, jw, tw = p32
    x = np.random.default_rng(4).standard_normal(N).astype(np.float32)
    yj = jk.well_spmv(jw, jnp.asarray(x))
    yt = tk.well_spmv(tw, torch.as_tensor(x))
    assert yt.dtype == torch.float32 and yt.shape == (N,)
    assert _rel(yt, yj) <= 1e-5
    assert _rel(tw @ torch.as_tensor(x), yj) <= 1e-5
    # f64 x takes the WELL's dtype, as in JAX
    assert tk.well_spmv(tw, torch.as_tensor(x, dtype=torch.float64)).dtype \
        == torch.float32


def test_well_spmv_complex64_matches_jax_planes():
    """One complex tensor in the port against the JAX package's two value
    planes (four real kernel passes); the same pattern as the f32 case, so
    the JAX kernel is not compiled again."""
    rng = np.random.default_rng(5)
    j = permuted_poisson(G, np.complex64)
    jw = j_csr_to_well(j)
    assert jw.is_complex
    tw = csr_to_well(to_port(j))
    assert tw.is_complex and tw.vals.dtype == torch.complex64
    x = (rng.standard_normal(N) + 1j * rng.standard_normal(N)).astype(
        np.complex64)
    yj = jk.well_spmv(jw, jnp.asarray(x))
    yt = tk.well_spmv(tw, torch.as_tensor(x))
    assert yt.dtype == torch.complex64
    assert _rel(yt, yj) <= 1e-5
    # real A against complex x: complex result
    real = to_port(permuted_poisson(G, np.float32))
    yr = tk.well_spmv(csr_to_well(real), torch.as_tensor(x))
    assert yr.dtype == torch.complex64
    assert _rel(yr, np_of(real.todense()) @ x) <= 1e-5


def test_well_spmv64_matches_jax_and_csr():
    rng = np.random.default_rng(6)
    j = permuted_poisson(G, np.float64)
    j = j.map_values(lambda v: v * (1 + 1e-3 * jnp.asarray(
        rng.standard_normal(v.shape[0]))))
    jw = jk64.csr_to_well64(j)
    tw = tk64.csr_to_well64(to_port(j))
    assert isinstance(tw, tk64.WELL64) and tw.vals.dtype == torch.float64
    x = rng.standard_normal(N)
    yj = np_of(jk64.well_spmv64(jw, jnp.asarray(x)))
    yt = tk64.well_spmv64(tw, torch.as_tensor(x))
    assert yt.dtype == torch.float64
    assert _rel(yt, yj) <= 1e-12
    ref = np_of(to_port(j).todense()) @ x
    assert np.linalg.norm(np_of(yt) - ref) / np.linalg.norm(ref) <= 1e-13
    assert _rel(tw @ torch.as_tensor(x, dtype=torch.float32),
                np_of(to_port(j).todense()) @ x.astype(np.float32)) <= 1e-12
    # complex x: two real passes, complex128 out
    xc = x + 1j * rng.standard_normal(N)
    yc = tk64.well_spmv64(tw, torch.as_tensor(xc))
    assert yc.dtype == torch.complex128
    assert _rel(yc, np_of(to_port(j).todense()) @ xc) <= 1e-13


@pytest.mark.parametrize("case", ["skewed_300x200", "empty_100x100",
                                  "flat_8x5000"])
def test_well_spmv_plain_against_csr(case):
    """Skewed, empty and rectangular operators through the port alone,
    against the CSR SpMV (no JAX kernel: its interpret mode unrolls the
    chunks of the long rows)."""
    rng = np.random.default_rng(7)
    if case == "skewed_300x200":
        t = to_port(skewed_csr(rng, 300, 200))
    elif case == "empty_100x100":
        t = st.zeros((100, 100), dtype=torch.float64, device="cpu")
    else:
        t = to_port(random_csr(rng, 8, 5000, 0.01))
    w = csr_to_well(t)
    x = torch.as_tensor(rng.standard_normal(t.shape[1]))
    np.testing.assert_allclose(np_of(tk.well_spmv(w, x)), np_of(st.spmv(t, x)),
                               rtol=0, atol=1e-12)
    X = torch.as_tensor(rng.standard_normal((3, t.shape[1])))
    np.testing.assert_allclose(np_of(tk.well_spmm_planes(w, X)),
                               np_of(st.spmm(t, X.T).T), rtol=0, atol=1e-12)


# ----------------------------------------------------------------- SpMM


@pytest.mark.parametrize("force", ["resident", "windowed"])
def test_well_spmm_planes_f32_matches_jax(p32, force):
    """Kernel D's one op against both TPU memory plans (K5 and K6)."""
    j, jw, tw = p32
    x = np.random.default_rng(8).standard_normal((3, N)).astype(np.float32)
    yj = jk.well_spmm_planes(jw, jnp.asarray(x), _force=force)
    yt = tk.well_spmm_planes(tw, torch.as_tensor(x))
    assert yt.shape == (3, N) and yt.dtype == torch.float32
    assert _rel(yt, yj) <= 1e-5
    # column-major form: the same op with a transpose on each side
    yc = tk.well_spmm(tw, torch.as_tensor(x.T))
    assert yc.shape == (N, 3)
    assert _rel(yc.T, yj) <= 1e-5
    assert tk.well_planes_width(tw) == N


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_well_spmm_planes_m40_matches_jax_resident(dtype):
    """m = 40, a width that takes kernel D three chunks a lane (and a
    second tile plane-major) on the card, against the JAX package's
    resident route (in f64 its WELL with f64 values, which interpret mode
    takes); the port's f64 entry is ``well_spmm64_planes``."""
    j = permuted_poisson(G, dtype)
    x = np.random.default_rng(13).standard_normal((40, N)).astype(dtype)
    yj = jk.well_spmm_planes(j_csr_to_well(j), jnp.asarray(x),
                             _force="resident")
    if dtype == np.float64:
        tw = tk64.csr_to_well64(to_port(j))
        yt = tk64.well_spmm64_planes(tw, torch.as_tensor(x))
        tol = 1e-12
    else:
        tw = csr_to_well(to_port(j))
        yt = tk.well_spmm_planes(tw, torch.as_tensor(x))
        tol = 1e-5
    assert yt.shape == (40, N) and yt.dtype == tw.vals.dtype
    assert _rel(yt, yj) <= tol
    assert _rel(tk.well_spmm(tw, torch.as_tensor(x.T)).T, yj) <= tol


@pytest.mark.parametrize("m, itemsize, vector, planes, plan", [
    (1, 8, False, False, (1, 1)),    # one lane a row: 32 rows at once
    (2, 8, True, False, (1, 1)),     # one double2 a row
    (5, 8, False, True, (8, 1)),     # odd m: scalar, 8 lanes, 5 busy
    (8, 8, True, False, (4, 1)),
    (16, 8, True, False, (8, 1)),    # one 128-byte run a row
    (16, 4, True, True, (4, 1)),
    (17, 8, False, False, (16, 1)),  # scalar: 16 lanes, m tiled
    (33, 4, False, False, (32, 1)),
    (40, 8, True, False, (8, 3)),
    (80, 8, True, False, (8, 5)),    # FEAST's m in one pass
    (80, 8, True, True, (8, 2)),     # plane-major: the Y stage caps it
    (80, 4, True, False, (8, 3)),
    (96, 8, True, False, (8, 5)),    # past five chunks: m tiled
    (160, 4, True, False, (8, 5)),
    (1, 16, True, False, (1, 1)),    # complex128: one value a vector
    (3, 16, True, False, (4, 1)),
    (16, 16, True, False, (8, 2)),
    (80, 16, True, False, (8, 5)),   # FEAST's m, complex: m tiled twice
    (80, 16, True, True, (8, 2)),
    (3, 8, False, False, (4, 1)),    # complex64, odd m: scalar lanes
])
def test_spmm_plan(m, itemsize, vector, planes, plan):
    """Kernel D's geometry by m: the fewest lanes (a power of two) that
    cover a row, up to one 128-byte run; then more chunks a lane."""
    assert tk._spmm_plan(m, itemsize, vector, planes) == plan
    lanes, chunks = plan
    per_lane = 16 // itemsize if vector else 1
    assert lanes * per_lane * itemsize <= 128
    assert lanes * per_lane * chunks >= m or chunks == (
        tk._MAX_CHUNKS_PLANES if planes else tk._MAX_CHUNKS) or not vector


def test_spmm_stage_slots():
    """Slots a row that kernel D stages at a time: the mean slice width,
    1 for an empty matrix, at most 32 (longer rows take rounds)."""
    def mean_width(w):
        return int(np.ceil(w.cols.shape[0] / (w.n_slices * 32)))

    rng = np.random.default_rng(14)
    w = csr_to_well(to_port(permuted_poisson(G, np.float32)))
    assert tk._stage_slots(w) == mean_width(w) == w.c_max == 5
    skew = csr_to_well(to_port(skewed_csr(rng, 300, 200)))
    assert tk._stage_slots(skew) == mean_width(skew) < skew.c_max
    dense = csr_to_well(to_port(random_csr(rng, 64, 64, 0.9)))
    assert mean_width(dense) > 32 and tk._stage_slots(dense) == 32
    empty = csr_to_well(st.zeros((100, 50), dtype=torch.float32,
                                 device="cpu"))
    assert tk._stage_slots(empty) == 1
    # the kernel keeps its occupancy per staging width up to the same cap
    src = (_build._PKG / "csrc" / "well_spmv.cu").read_text()
    assert f"kMaxStage = {tk._MAX_STAGE_SLOTS};" in src


def test_well_spmm_complex_and_vector():
    rng = np.random.default_rng(9)
    j = permuted_poisson(G, np.complex64)
    tw = csr_to_well(to_port(j))
    dense = np_of(to_port(j).todense())
    x = (rng.standard_normal((N, 2)) + 1j * rng.standard_normal((N, 2))
         ).astype(np.complex64)
    assert _rel(tk.well_spmm(tw, torch.as_tensor(x)), dense @ x) <= 1e-5
    y1 = tk.well_spmm(tw, torch.as_tensor(x[:, 0]))
    assert y1.ndim == 1 and _rel(y1, dense @ x[:, 0]) <= 1e-5


def test_well_complex128_matches_jax_planes():
    """A complex128 WELL (one complex tensor in the port; two f64 value
    planes, real kernel passes, in the JAX package) times a complex x and a
    complex X (m = 40 on the resident route, both layouts), and a
    complex64 WELL times a real x, within 1e-12 / 1e-5."""
    rng = np.random.default_rng(14)
    j = permuted_poisson(G, np.complex128)
    jw, tw = j_csr_to_well(j), csr_to_well(to_port(j))
    assert tw.vals.dtype == torch.complex128
    x = rng.standard_normal(N) + 1j * rng.standard_normal(N)
    yt = tk.well_spmv(tw, torch.as_tensor(x))
    assert yt.dtype == torch.complex128
    assert _rel(yt, jk.well_spmv(jw, jnp.asarray(x))) <= 1e-12
    xp = rng.standard_normal((40, N)) + 1j * rng.standard_normal((40, N))
    yj = jk.well_spmm_planes(jw, jnp.asarray(xp), _force="resident")
    assert _rel(tk.well_spmm_planes(tw, torch.as_tensor(xp)), yj) <= 1e-12
    assert _rel(tk.well_spmm(tw, torch.as_tensor(xp.T)).T, yj) <= 1e-12
    j64 = permuted_poisson(G, np.complex64)
    t64 = csr_to_well(to_port(j64))
    xr = rng.standard_normal(N).astype(np.float32)
    y64 = tk.well_spmv(t64, torch.as_tensor(xr))
    assert y64.dtype == torch.complex64
    assert _rel(y64, np_of(to_port(j64).todense()) @ xr) <= 1e-5


def test_well_spmm64_planes_matches_jax():
    rng = np.random.default_rng(10)
    j = permuted_poisson(G, np.float64)
    jw = jk64.csr_to_well64(j)
    tw = tk64.csr_to_well64(to_port(j))
    x = rng.standard_normal((3, N))
    yj = np_of(jk64.well_spmm64_planes(jw, jnp.asarray(x)))
    yt = tk64.well_spmm64_planes(tw, torch.as_tensor(x))
    assert yt.dtype == torch.float64 and yt.shape == (3, N)
    assert _rel(yt, yj) <= 1e-12
    ref = (np_of(to_port(j).todense()) @ x.T).T
    assert np.linalg.norm(np_of(yt) - ref) / np.linalg.norm(ref) <= 1e-13
    xc = x + 1j * rng.standard_normal((3, N))
    assert _rel(tk64.well_spmm64_planes(tw, torch.as_tensor(xc)),
                (np_of(to_port(j).todense()) @ xc.T).T) <= 1e-13


# ---------------------------------------------------------- error texts


def _same_error(exc, f_jax, f_port):
    with pytest.raises(exc) as ej:
        f_jax()
    with pytest.raises(exc) as et:
        f_port()
    assert str(et.value) == str(ej.value)


def test_error_texts_match_jax():
    rng = np.random.default_rng(11)
    j = random_csr(rng, 32, 48, 0.2, np.float32)
    jw, tw = j_csr_to_well(j), csr_to_well(to_port(j))
    _same_error(ValueError, lambda: jk.well_spmv(jw, jnp.ones(47)),
                lambda: tk.well_spmv(tw, torch.ones(47)))
    _same_error(ValueError, lambda: jk.well_spmm(jw, jnp.ones((7, 3))),
                lambda: tk.well_spmm(tw, torch.ones((7, 3))))
    _same_error(ValueError, lambda: jk.well_spmm_planes(jw, jnp.ones((3, 47))),
                lambda: tk.well_spmm_planes(tw, torch.ones((3, 47))))
    j64 = random_csr(rng, 32, 48, 0.2)
    jw64, tw64 = jk64.csr_to_well64(j64), tk64.csr_to_well64(to_port(j64))
    _same_error(ValueError, lambda: jk64.well_spmv64(jw64, jnp.ones(47)),
                lambda: tk64.well_spmv64(tw64, torch.ones(47)))
    _same_error(ValueError,
                lambda: jk64.well_spmm64_planes(jw64, jnp.ones((3, 47))),
                lambda: tk64.well_spmm64_planes(tw64, torch.ones((3, 47))))
    jc = random_csr(rng, 8, 8, 0.3, np.complex128)
    _same_error(TypeError, lambda: jk64.csr_to_well64(jc),
                lambda: tk64.csr_to_well64(to_port(jc)))


def test_f64_runs_on_the_plain_path():
    """The JAX package refuses 64-bit WELL values on the TPU; the port has
    no such refusal (f64 is native on the card)."""
    t = to_port(random_csr(np.random.default_rng(12), 40, 40, 0.1))
    w = csr_to_well(t)
    x = torch.ones(40, dtype=torch.float64)
    np.testing.assert_allclose(np_of(tk.well_spmv(w, x)), np_of(st.spmv(t, x)),
                               rtol=0, atol=1e-12)
    assert tk.well_spmm_planes(w, x[None, :]).dtype == torch.float64


def test_refuses_other_devices():
    w = csr_to_well(st.eye(4, dtype=torch.float64, device="cpu"))
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        tk.well_spmv(w.to("meta"), torch.ones(4, device="meta"))


# ------------------------------------------------------- format selection


@pytest.mark.parametrize("which", ["poisson", "permuted", "empty"])
def test_select_matches_jax(which):
    if which == "poisson":
        j = jgrids.poisson_2d(G, dtype=np.float64)
    elif which == "permuted":
        j = permuted_poisson(G, np.float64)
    else:
        j = sl.zeros((5, 5), dtype=np.float64).tocsr()
    t = to_port(j)
    kind = jselect.recommend_format(j)
    assert tselect.recommend_format(t) == kind
    assert st.recommend_format(t, max_diags=10 ** 6) == "dia"
    assert jselect.recommend_format(j, max_diags=10 ** 6) == "dia"
    jf, tf = jselect.to_fast_format(j), tselect.to_fast_format(t)
    np.testing.assert_array_equal(np_of(tf.todense()), np_of(jf.todense()))
    if kind == "dia":
        assert isinstance(tf, DIA) and tuple(tf.offsets) == tuple(jf.offsets)
    else:
        assert isinstance(tf, WELL)
    # to_fast_format passes its options to recommend_format, as in JAX
    assert isinstance(tselect.to_fast_format(t, max_diags=0), WELL) == (
        t.nnz > 0)
