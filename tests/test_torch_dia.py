"""Parity of the port's DIA format and DIA SpMV with the JAX package, on the
CPU.

The Pallas kernels run as the JAX package's own tests run them, under
``pltpu.force_tpu_interpret_mode()``; the port's kernel wrappers take their
plain PyTorch version because the tensors lie on the CPU (the CUDA kernels
themselves are held against that version on the card, in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``).  Tolerances: atol 1e-4
in f32 (the JAX kernel tests' own), 1e-12 in f64 and c128.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

import sparse_linear_tpu as sl  # noqa: E402
from sparse_linear_tpu.formats import structured as jst  # noqa: E402
from sparse_linear_tpu.kernels import spmv as jspmv  # noqa: E402
from sparse_linear_tpu.kernels import spmv_pallas  # noqa: E402
from sparse_linear_tpu.utils import grids as jgrids  # noqa: E402
from sparse_linear_tpu_torch.formats import structured as tst  # noqa: E402
from sparse_linear_tpu_torch.kernels import _build  # noqa: E402
from sparse_linear_tpu_torch.kernels import spmv as tspmv  # noqa: E402
from sparse_linear_tpu_torch.kernels.spmv_dia import (  # noqa: E402
    dia_spmv_chain,
    dia_spmv_kernel,
)
from sparse_linear_tpu_torch.utils import grids as tgrids  # noqa: E402
from tests.conftest import random_coo  # noqa: E402
from tests.torch_parity import assert_same_leaves, np_of, to_port  # noqa: E402

F32 = 1e-4
F64 = 1e-12
WIDE_OFFSETS = [-300, -128, -5, 0, 7, 129, 515]  # tests/test_structured.py


@pytest.fixture(autouse=True)
def _no_launches():
    """On CPU tensors the wrappers run the plain version: no launch is
    counted and the kernel library is never built."""
    k0, c0 = dia_spmv_kernel.launches, dia_spmv_chain.launches
    yield
    assert dia_spmv_kernel.launches == k0
    assert dia_spmv_chain.launches == c0
    assert _build.load_library.cache_info().currsize == 0


def _wide_dia(rng, n=1024, offs=WIDE_OFFSETS):
    d = np.zeros((n, n), np.float32)
    for o in offs:
        d += np.diag(rng.standard_normal(n - abs(o)).astype(np.float32), k=o)
    return jst.csr_to_dia(sl.from_dense(d))


def _rect_dia(rng, nr, nc, dtype=np.float32):
    """A rectangular DIA with a few diagonals, some reaching past the
    narrower side."""
    offs = sorted({-(nr * 2 // 3), -1, 0, 3, nc * 2 // 3})
    d = np.zeros((nr, nc))
    for o in offs:
        d += np.eye(nr, nc, k=o) * rng.standard_normal((nr, nc))
    return jst.csr_to_dia(sl.from_dense(d.astype(dtype)))


# ------------------------------------------------------------ format parity


@pytest.mark.parametrize("which", ["p2d_7", "lap1d_9", "p3d_4", "rect_5x8",
                                   "rect_9x4"])
def test_csr_to_dia(which):
    rng = np.random.default_rng(20)
    if which == "p2d_7":
        j = jgrids.poisson_2d(7, dtype=np.float64)
    elif which == "lap1d_9":
        j = jgrids.laplacian_1d(9, dtype=np.float64)
    elif which == "p3d_4":
        j = jgrids.poisson_3d(4, dtype=np.float64)
    else:
        nr, nc = (5, 8) if which == "rect_5x8" else (9, 4)
        rows, cols, vals = random_coo(rng, nr, nc, np.complex128)
        j = sl.from_triples((nr, nc), rows, cols, vals).tocsr()
    t = to_port(j)
    jd, td = jst.csr_to_dia(j), tst.csr_to_dia(t)
    assert_same_leaves(td, jd, atol=0)
    np.testing.assert_array_equal(np_of(td.todense()), np_of(jd.todense()))
    # through CSC and COO too
    assert_same_leaves(tst.csr_to_dia(t.tocsc().tocsr()), jd, atol=0)


def test_csr_to_dia_too_many_diagonals_identical():
    j = jgrids.poisson_2d(6, dtype=np.float64)
    with pytest.raises(ValueError) as ej:
        jst.csr_to_dia(j, max_diags=3)
    with pytest.raises(ValueError) as et:
        tst.csr_to_dia(to_port(j), max_diags=3)
    assert str(et.value) == str(ej.value)


def test_pad_dia():
    j = jst.csr_to_dia(jgrids.poisson_2d(9, dtype=np.float64))
    t = to_port(j)
    assert_same_leaves(tst.pad_dia(t, multiple=64),
                       jst.pad_dia(j, multiple=64), atol=0)
    tp = tst.pad_dia(t, multiple=64)
    assert tst.pad_dia(tp, multiple=64) is tp
    with pytest.raises(ValueError, match="only square"):
        tst.pad_dia(tst.csr_to_dia(to_port(
            sl.from_dense(np.ones((2, 3))))))


@pytest.mark.parametrize("gen", ["laplacian_1d", "poisson_2d", "poisson_3d"])
@pytest.mark.parametrize("fmt", ["dia", "csr"])
def test_grids(gen, fmt):
    arg = {"laplacian_1d": 11, "poisson_2d": 6, "poisson_3d": 3}[gen]
    j = getattr(jgrids, gen)(arg, dtype=np.float64, fmt=fmt)
    t = getattr(tgrids, gen)(arg, dtype=torch.float64, fmt=fmt,
                             device="cpu")
    assert_same_leaves(t, j, atol=0)
    if fmt == "csr":
        import sparse_linear_tpu_torch as st

        assert st.check_matrix(t)


def test_grids_rectangular_poisson_2d():
    j = jgrids.poisson_2d(5, 3, dtype=np.float32, fmt="dia")
    t = tgrids.poisson_2d(5, 3, dtype=torch.float32, fmt="dia")
    assert_same_leaves(t, j, atol=0)


# ------------------------------------------------------ plain SpMV / SpMM


@pytest.mark.parametrize("dtype", [np.float64, np.complex128, np.float32],
                         ids=["f64", "c128", "f32"])
@pytest.mark.parametrize("which", ["p2d", "rect_tall", "rect_flat"])
def test_plain_dia_spmv_spmm_planes(dtype, which):
    rng = np.random.default_rng(21)
    if which == "p2d":
        j = jgrids.poisson_2d(8, dtype=np.float64, fmt="dia")
        j = jst.DIA(data=j.data.astype(dtype), shape=j.shape,
                    offsets=j.offsets)
    else:
        nr, nc = (12, 7) if which == "rect_tall" else (7, 12)
        j = _rect_dia(rng, nr, nc, dtype)
    t = to_port(j)
    nr, nc = j.shape
    x = rng.standard_normal(nc).astype(dtype)
    xm = rng.standard_normal((nc, 3)).astype(dtype)
    xp = rng.standard_normal((4, nc)).astype(dtype)
    tol = F32 if dtype == np.float32 else F64
    pairs = [
        (tspmv.dia_spmv(t, torch.as_tensor(x)), jspmv.dia_spmv(j, x)),
        (tspmv.dia_spmm(t, torch.as_tensor(xm)), jspmv.dia_spmm(j, xm)),
        (tspmv.dia_spmm(t, torch.as_tensor(x)), jspmv.dia_spmm(j, x)),
        (tspmv.dia_spmm_planes(t, torch.as_tensor(xp)),
         jspmv.dia_spmm_planes(j, xp)),
        (t @ torch.as_tensor(x), j @ x),
    ]
    for got, want in pairs:
        assert got.shape == want.shape
        np.testing.assert_allclose(np_of(got), np_of(want), atol=tol)
    for f, bad in ((tspmv.dia_spmv, torch.ones(nc + 1)),
                   (tspmv.dia_spmm, torch.ones((nc + 1, 2))),
                   (tspmv.dia_spmm_planes, torch.ones((2, nc + 1)))):
        with pytest.raises(ValueError):
            f(t, bad)


# ------------------------------------- kernel A against the Pallas kernels


def _kernel_pair(j, x, **kw):
    """(port kernel wrapper, JAX dia_spmv_pallas in interpret mode)."""
    t = to_port(j)
    got = dia_spmv_kernel(t, torch.as_tensor(np.asarray(x)),
                          alpha=kw.get("alpha"))
    with pltpu.force_tpu_interpret_mode():
        want = spmv_pallas.dia_spmv_pallas(j, jnp.asarray(x), **kw)
    return got, want


@pytest.mark.parametrize("g", [32, 16, 40], ids=["blocked_32", "stream_16",
                                                 "stream_40"])
def test_dia_spmv_kernel_vs_pallas_poisson(g):
    rng = np.random.default_rng(22)
    j = jgrids.poisson_2d(g, dtype=np.float32, fmt="dia")
    x = rng.standard_normal(g * g).astype(np.float32)
    kw = {} if g == 32 else {"tile": 1024}
    got, want = _kernel_pair(j, x, **kw)
    np.testing.assert_allclose(np_of(got), np_of(want), atol=F32)


def test_dia_spmv_kernel_vs_pallas_wide_offsets():
    rng = np.random.default_rng(23)
    j = _wide_dia(rng)
    x = rng.standard_normal(1024).astype(np.float32)
    got, want = _kernel_pair(j, x)
    np.testing.assert_allclose(np_of(got), np_of(want), atol=F32)


@pytest.mark.parametrize("shape", [(300, 200), (200, 300)],
                         ids=["tall", "flat"])
def test_dia_spmv_kernel_vs_pallas_rectangular(shape):
    rng = np.random.default_rng(24)
    j = _rect_dia(rng, *shape)
    x = rng.standard_normal(shape[1]).astype(np.float32)
    got, want = _kernel_pair(j, x, tile=1024)
    assert got.shape == want.shape == (shape[0],)
    np.testing.assert_allclose(np_of(got), np_of(want), atol=F32)


@pytest.mark.parametrize("g", [32, 16], ids=["blocked", "stream"])
def test_dia_spmv_kernel_vs_pallas_pretiled_x(g):
    rng = np.random.default_rng(25)
    j = jgrids.poisson_2d(g, dtype=np.float32, fmt="dia")
    x = rng.standard_normal((g * g // 128, 128)).astype(np.float32)
    got, want = _kernel_pair(j, x)
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(np_of(got), np_of(want), atol=F32)


@pytest.mark.parametrize("g", [32, 16], ids=["blocked", "stream"])
def test_dia_spmv_kernel_vs_pallas_alpha(g):
    rng = np.random.default_rng(26)
    j = jgrids.poisson_2d(g, dtype=np.float32, fmt="dia")
    x = rng.standard_normal(g * g).astype(np.float32)
    kw = {"alpha": 0.5} if g == 32 else {"alpha": 0.5, "tile": 1024}
    got, want = _kernel_pair(j, x, **kw)
    np.testing.assert_allclose(np_of(got), np_of(want), atol=F32)


def test_dia_spmv_kernel_cpu_promotion_and_complex():
    rng = np.random.default_rng(27)
    j = jgrids.poisson_2d(6, dtype=np.float32, fmt="dia")
    t = to_port(j)
    x = rng.standard_normal(36)  # f64 x promotes the f32 operator
    got = dia_spmv_kernel(t, torch.as_tensor(x))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(np_of(got), np_of(jspmv.dia_spmv(j, x)),
                               atol=F64)
    xc = (x + 1j * rng.standard_normal(36)).astype(np.complex128)
    got = dia_spmv_kernel(t, torch.as_tensor(xc), alpha=2.0)
    np.testing.assert_allclose(np_of(got), 2.0 * np_of(jspmv.dia_spmv(j, xc)),
                               atol=F64)


def test_dia_spmv_kernel_refuses_other_devices():
    t = tgrids.poisson_2d(4, fmt="dia").to("meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        dia_spmv_kernel(t, torch.ones(16, device="meta"))
    with pytest.raises(ValueError, match="different devices"):
        dia_spmv_kernel(t, torch.ones(16))
    with pytest.raises(ValueError, match="dimension mismatch"):
        dia_spmv_kernel(tgrids.poisson_2d(4, fmt="dia"), torch.ones(15))
    short = tst.DIA(data=torch.ones((2, 16)), shape=(16, 16),
                    offsets=(-4, 0, 4))
    for call in (lambda: dia_spmv_kernel(short, torch.ones(16)),
                 lambda: dia_spmv_chain(short, torch.ones(16), 2)):
        with pytest.raises(ValueError, match="does not match 3 offsets"):
            call()


# ------------------------------------- kernel B against the Pallas chain


def test_dia_spmv_chain_vs_pallas():
    rng = np.random.default_rng(28)
    g = 32
    j = jgrids.poisson_2d(g, dtype=np.float32, fmt="dia")
    x = rng.standard_normal(g * g).astype(np.float32)
    got = dia_spmv_chain(to_port(j), torch.as_tensor(x), k=3, alpha=0.37)
    with pltpu.force_tpu_interpret_mode():
        want = spmv_pallas.dia_spmv_chain(j, jnp.asarray(x), k=3, alpha=0.37)
    np.testing.assert_allclose(np_of(got), np_of(want), atol=F32)
    # pre-tiled x comes back tiled; x is cast to the data dtype
    got2 = dia_spmv_chain(to_port(j), torch.as_tensor(x.astype(np.float64))
                          .reshape(8, 128), k=3, alpha=0.37)
    assert got2.shape == (8, 128) and got2.dtype == torch.float32
    np.testing.assert_allclose(np_of(got2).reshape(-1), np_of(want),
                               atol=F32)


def test_dia_spmv_chain_errors_match():
    g = 32
    j = jgrids.poisson_2d(g, dtype=np.float32, fmt="dia")
    x = np.ones(g * g, np.float32)
    with pytest.raises(ValueError):
        spmv_pallas.dia_spmv_chain(j, jnp.asarray(x), k=0)
    with pytest.raises(ValueError, match="k must be >= 1"):
        dia_spmv_chain(to_port(j), torch.as_tensor(x), k=0)
    rect = to_port(_rect_dia(np.random.default_rng(29), 6, 5))
    with pytest.raises(ValueError, match="square"):
        dia_spmv_chain(rect, torch.ones(5), k=2)
    # unaligned square sizes run (the 1024-row alignment was a VMEM limit)
    t = tgrids.poisson_2d(7, dtype=torch.float64, fmt="dia")
    xs = torch.as_tensor(np.random.default_rng(30).standard_normal(49))
    ref = xs
    for _ in range(4):
        ref = tspmv.dia_spmv(t, ref) * 0.25
    np.testing.assert_allclose(np_of(dia_spmv_chain(t, xs, 4, alpha=0.25)),
                               np_of(ref), atol=F64)


# ------------------------------------------------------------------ build


def test_build_key_follows_source_content(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = _build.library_path([src])
    assert first == _build.library_path([src])
    src.write_text("// two\n")
    assert _build.library_path([src]) != first
    assert _build.library_path([src], flags=("-O0",)) != _build.library_path(
        [src])
    assert first.parent == _build.build_dir()


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._compile(tmp_path / "lib.so")
    assert not (tmp_path / "lib.so").exists()
