"""The port's Hopper kernels against their plain versions, on the card:
kernels A and B (DIA SpMV and chain), kernel A's multi-RHS form (DIA
SpMM, both layouts, every column bitwise kernel A) and kernels C and D
(WELL SpMV and SpMM), real and complex (complex64 / complex128, and a real
operator times a complex x); the multifrontal direct solver on CUDA tensors
against the port on the CPU (f64/c128 within 1e-12, f32/c64 within 1e-5),
every block and solution on the card; and FEAST on the card against the
analytic spectrum.

Every test here needs an NVIDIA GPU and nvcc: it is marked ``cuda`` and
skips without a card.  This file imports no JAX, so it also runs where JAX
is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: max |y - y_plain| / max |y_plain| <= 1e-5 in f32 and c64 and
1e-12 in f64 and c128.  The DIA kernels sum the diagonals in the stored order, as the plain
version does; only fused multiply-adds may round differently.  The WELL
plain versions sum with ``index_add_``, whose order on CUDA is unspecified,
so their parity is to rounding.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sparse_linear_tpu_torch as st  # noqa: E402
from sparse_linear_tpu_torch.formats.structured import DIA  # noqa: E402
from sparse_linear_tpu_torch.formats.well import csr_to_well  # noqa: E402
from sparse_linear_tpu_torch.kernels.spmv import dia_spmv  # noqa: E402
from sparse_linear_tpu_torch.kernels.spmv import (  # noqa: E402
    dia_spmm,
    dia_spmm_planes,
)
from sparse_linear_tpu_torch.kernels.spmv_dia import (  # noqa: E402
    dia_spmm_kernel,
    dia_spmm_planes_kernel,
    dia_spmv_chain,
    dia_spmv_kernel,
)
from sparse_linear_tpu_torch.kernels.spmv_well import (  # noqa: E402
    well_spmm,
    well_spmm_planes,
    well_spmm_planes_plain,
    well_spmv,
    well_spmv_plain,
)
from sparse_linear_tpu_torch.kernels.spmv_well64 import (  # noqa: E402
    csr_to_well64,
    well_spmm64_planes,
    well_spmv64,
)
from sparse_linear_tpu_torch.ops.spgemm import (  # noqa: E402
    spgemm,
    spgemm_apply_well,
    spgemm_plan_well,
)
from sparse_linear_tpu_torch.utils.grids import poisson_2d, poisson_3d  # noqa: E402

pytestmark = pytest.mark.cuda

RTOL = {torch.float32: 1e-5, torch.float64: 1e-12,
        torch.complex64: 1e-5, torch.complex128: 1e-12}
COMPLEX = [torch.complex64, torch.complex128]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _rel(y, ref):
    # the floor is applied in Python floats: 1e-300 underflows to 0 in f32
    return float((y - ref).abs().max()) / max(float(ref.abs().max()), 1e-300)


def _random_dia(rng, shape, offsets, dtype, dev):
    nr, nc = shape
    data = rng.standard_normal((len(offsets), nr))
    i = np.arange(nr)
    for d, off in enumerate(offsets):
        data[d][(i + off < 0) | (i + off >= nc)] = 0
    return DIA(data=torch.as_tensor(data, dtype=dtype, device=dev),
               shape=shape, offsets=tuple(offsets))


def _phased(mat, dtype, seed=11):
    """``mat`` (a DIA or a CSR) with each stored value turned by a seeded
    random phase and cast to the complex ``dtype``: zeros stay zero."""
    vals = mat.data
    phase = np.random.default_rng(seed).uniform(0, 2 * np.pi,
                                                tuple(vals.shape))
    turned = vals.to(torch.complex128) * torch.as_tensor(
        np.exp(1j * phase), device=vals.device)
    if isinstance(mat, DIA):
        return DIA(data=turned.to(dtype), shape=mat.shape,
                   offsets=mat.offsets)
    return mat.map_values(lambda v: turned.to(dtype))


def _crandn(rng, shape, dtype, dev):
    return torch.as_tensor(rng.standard_normal(shape)
                           + 1j * rng.standard_normal(shape), dtype=dtype,
                           device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", ["p2d_32", "p2d_45", "p3d_9", "wide",
                                  "tall", "flat", "unsorted"])
def test_dia_spmv_kernel_matches_plain(dev, dtype, case):
    rng = np.random.default_rng(0)
    if case == "p2d_32":
        a = poisson_2d(32, dtype=dtype, fmt="dia", device=dev)
    elif case == "p2d_45":
        a = poisson_2d(45, dtype=dtype, fmt="dia", device=dev)
    elif case == "p3d_9":
        a = poisson_3d(9, dtype=dtype, fmt="dia", device=dev)
    elif case == "wide":
        a = _random_dia(rng, (1024, 1024), [-300, -128, -5, 0, 7, 129, 515],
                        dtype, dev)
    elif case == "tall":
        a = _random_dia(rng, (700, 300), [-400, -1, 0, 2, 299], dtype, dev)
    elif case == "flat":
        a = _random_dia(rng, (300, 700), [-299, -3, 0, 5, 650], dtype, dev)
    else:
        a = _random_dia(rng, (500, 500), [7, -2, 0, -40], dtype, dev)
    x = torch.as_tensor(rng.standard_normal(a.shape[1]), dtype=dtype,
                        device=dev)
    before = dia_spmv_kernel.launches
    y = dia_spmv_kernel(a, x)
    torch.cuda.synchronize()
    assert dia_spmv_kernel.launches == before + 1
    assert _rel(y, dia_spmv(a, x)) <= RTOL[dtype]
    y2 = dia_spmv_kernel(a, x, alpha=0.37)
    assert _rel(y2, 0.37 * dia_spmv(a, x)) <= RTOL[dtype]


def test_dia_spmv_kernel_layout_and_promotion(dev):
    rng = np.random.default_rng(1)
    a = poisson_2d(32, dtype=torch.float32, fmt="dia", device=dev)
    x = torch.as_tensor(rng.standard_normal(1024), device=dev)  # f64
    y = dia_spmv_kernel(a, x)
    assert y.dtype == torch.float64
    assert _rel(y, dia_spmv(a, x)) <= 1e-12
    y2 = dia_spmv_kernel(a, x.float().reshape(8, 128))
    assert y2.shape == (8, 128)
    assert _rel(y2.reshape(-1), dia_spmv(a, x.float())) <= 1e-5
    # DIA @ x is the kernel on CUDA tensors
    before = dia_spmv_kernel.launches
    a @ x.float()
    assert dia_spmv_kernel.launches == before + 1


def test_dia_spmv_kernel_refuses(dev):
    """Complex values run (kernel A's complex64 instantiation here); a
    dtype no kernel takes, other devices and a wrong length raise."""
    a = _phased(poisson_2d(8, dtype=torch.float64, fmt="dia", device=dev),
                torch.complex64)
    x = torch.ones(64, dtype=torch.complex64, device=dev)
    assert _rel(dia_spmv_kernel(a, x), dia_spmv(a, x)) <= 1e-5
    half = DIA(data=a.data.real.half(), shape=a.shape, offsets=a.offsets)
    with pytest.raises(TypeError, match="takes float32, float64, complex64"):
        dia_spmv_kernel(half, x.real.half())
    b = poisson_2d(8, fmt="dia", device=dev)
    with pytest.raises(ValueError, match="different devices"):
        dia_spmv_kernel(b, torch.ones(64))
    with pytest.raises(ValueError, match="dimension mismatch"):
        dia_spmv_kernel(b, torch.ones(63, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("k", [1, 2, 7])
def test_dia_spmv_chain_matches_plain_steps(dev, dtype, k):
    rng = np.random.default_rng(2)
    a = poisson_2d(33, dtype=dtype, fmt="dia", device=dev)
    x = torch.as_tensor(rng.standard_normal(33 * 33), dtype=dtype, device=dev)
    before = dia_spmv_chain.launches
    y = dia_spmv_chain(a, x, k, alpha=0.125)
    torch.cuda.synchronize()
    assert dia_spmv_chain.launches == before + 1
    ref = x
    for _ in range(k):
        ref = dia_spmv(a, ref) * 0.125
    assert _rel(y, ref) <= (1e-5 if dtype == torch.float32 else 1e-12)
    with pytest.raises(ValueError):
        dia_spmv_chain(a, x, 0)


# --------------------------------- kernel A's multi-RHS form (DIA SpMM)

DIA_CASES = ["p2d_32", "p2d_45", "p3d_9", "wide", "tall", "flat"]


def _dia_case(case, dtype, dev):
    rng = np.random.default_rng(0)
    if case.startswith("p2d"):
        return poisson_2d(int(case[4:]), dtype=dtype, fmt="dia", device=dev)
    if case == "p3d_9":
        return poisson_3d(9, dtype=dtype, fmt="dia", device=dev)
    if case == "wide":
        return _random_dia(rng, (1024, 1024), [-300, -128, -5, 0, 7, 129, 515],
                           dtype, dev)
    if case == "tall":
        return _random_dia(rng, (700, 300), [-400, -1, 0, 2, 299], dtype, dev)
    return _random_dia(rng, (300, 700), [-299, -3, 0, 5, 650], dtype, dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 8, 16, 33, 80, 96, 160, 1100])
@pytest.mark.parametrize("case", DIA_CASES)
def test_dia_spmm_kernel_matches_plain(dev, dtype, m, case):
    a = _dia_case(case, dtype, dev)
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.standard_normal((a.shape[1], m)), dtype=dtype,
                        device=dev)
    before = dia_spmm_kernel.launches
    y = dia_spmm_kernel(a, x)
    yp = dia_spmm_planes_kernel(a, x.T.contiguous())
    torch.cuda.synchronize()
    assert dia_spmm_kernel.launches == before + 2
    assert y.shape == (a.shape[0], m) and yp.shape == (m, a.shape[0])
    assert _rel(y, dia_spmm(a, x)) <= RTOL[dtype]
    assert _rel(yp, dia_spmm_planes(a, x.T.contiguous())) <= RTOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("m", [5, 16, 80, 160])
@pytest.mark.parametrize("case", ["p2d_45", "wide", "flat"])
def test_dia_spmm_columns_are_kernel_a(dev, dtype, m, case):
    """Each entry sums its diagonals in stored order from zero with one fma,
    as kernel A does: every column of either layout is bitwise kernel A on
    that column."""
    a = _dia_case(case, dtype, dev)
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (a.shape[1], m)), dtype=dtype, device=dev)
    y = dia_spmm_kernel(a, x)
    yp = dia_spmm_planes_kernel(a, x.T.contiguous())
    for t in range(m):
        col = dia_spmv_kernel(a, x[:, t].contiguous())
        assert torch.equal(y[:, t], col) and torch.equal(yp[t], col)
    assert torch.equal(dia_spmm_kernel(a, x), y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("m", [4, 8, 80])
def test_dia_spmm_misaligned_views(dev, dtype, m):
    """An X, and plane-major planes of Y's size, that start one element
    past a 16-byte boundary (contiguous views at storage offset 1) take the
    scalar lanes: the result is bitwise the aligned call's, and nothing
    outside the view is read (its neighbours are NaN, which would show)."""
    a = _dia_case("tall", dtype, dev)
    nr, nc = a.shape
    rng = np.random.default_rng(9)
    x = torch.as_tensor(rng.standard_normal((nc, m)), dtype=dtype, device=dev)
    xp = torch.as_tensor(rng.standard_normal((m, nc)), dtype=dtype,
                         device=dev)
    for src, planes in ((x, False), (xp, True)):
        flat = torch.full((src.numel() + 8,), float("nan"), dtype=dtype,
                          device=dev)
        view = flat[1:1 + src.numel()].view(src.shape)
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        view.copy_(src)
        call = dia_spmm_planes_kernel if planes else dia_spmm_kernel
        y = call(a, view)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(y).all())
        assert torch.equal(y, call(a, src))
        plain = dia_spmm_planes(a, src) if planes else dia_spmm(a, src)
        assert _rel(y, plain) <= RTOL[dtype]
    # a Y-sized plane-major input of the square operator, misaligned
    sq = _dia_case("p2d_45", dtype, dev)
    ys = torch.as_tensor(rng.standard_normal((m, sq.shape[0])), dtype=dtype,
                         device=dev)
    flat = torch.full((ys.numel() + 8,), float("nan"), dtype=dtype,
                      device=dev)
    view = flat[1:1 + ys.numel()].view(ys.shape)
    view.copy_(ys)
    assert torch.equal(dia_spmm_planes_kernel(sq, view),
                       dia_spmm_planes_kernel(sq, ys))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("m,planes,other", [
    (16, False, (8, 4)),   # one pass of the widest chunks, most lanes idle
    (80, False, (8, 1)),   # one chunk a lane, two rows a thread: m tiled
    (80, False, (2, 1)),
    (160, False, (8, 2)),
    (3, False, (1, 1)),    # scalar lanes (m * itemsize not a multiple of 16)
    (80, True, (1, 1)),    # plane-major: one plane at a time
    (5, True, (1, 2)),
])
def test_dia_spmm_geometries_agree(dev, monkeypatch, dtype, m, planes, other):
    """The geometry ``_dia_spmm_plan`` picks and a forced other one give
    bitwise equal results: each entry sums its diagonals in stored order,
    whatever the lanes, chunks and tiling of m."""
    from sparse_linear_tpu_torch.kernels import spmv_dia

    a = _dia_case("wide", dtype, dev)
    rng = np.random.default_rng(10)
    x = torch.as_tensor(rng.standard_normal((m, a.shape[1]) if planes else
                                            (a.shape[1], m)), dtype=dtype,
                        device=dev)
    call = dia_spmm_planes_kernel if planes else dia_spmm_kernel
    chosen = spmv_dia._dia_spmm_plan(m, x.element_size(),
                                     m * x.element_size() % 16 == 0, planes)
    assert chosen != other
    y = call(a, x)
    monkeypatch.setattr(spmv_dia, "_dia_spmm_plan", lambda *_: other)
    assert torch.equal(call(a, x), y)


def test_dia_spmm_kernel_complex_and_refusals(dev):
    """A complex X on a real operator runs the real kernel on its real
    block, one launch in either layout, each part bitwise the real kernel
    on it (StructuredOp's route too); a complex operator runs the complex
    kernel; kernel B refuses complex, and a dtype no kernel takes
    raises."""
    a = poisson_2d(16, dtype=torch.float64, fmt="dia", device=dev)
    rng = np.random.default_rng(6)
    xc = torch.as_tensor(rng.standard_normal((256, 3))
                         + 1j * rng.standard_normal((256, 3)), device=dev)
    from sparse_linear_tpu_torch.eig.pipeline import _structured_op
    op = _structured_op(poisson_2d(16, dtype=torch.float64, device=dev))
    assert op.route == "dia"
    before = dia_spmm_kernel.launches
    y = op(xc)
    assert dia_spmm_kernel.launches == before + 1
    assert _rel(y, dia_spmm(a, xc)) <= 1e-12
    assert torch.equal(dia_spmm_kernel(a, xc), y)
    assert torch.equal(y.real, dia_spmm_kernel(a, xc.real.contiguous()))
    assert torch.equal(y.imag, dia_spmm_kernel(a, xc.imag.contiguous()))
    before = dia_spmm_kernel.launches
    yp = dia_spmm_planes_kernel(a, xc.T.contiguous())
    assert dia_spmm_kernel.launches == before + 1
    assert torch.equal(yp, y.T)
    ac = _phased(a, torch.complex128)
    yc = dia_spmm_kernel(ac, xc)
    assert yc.dtype == torch.complex128
    assert _rel(yc, dia_spmm(ac, xc)) <= 1e-12
    with pytest.raises(TypeError, match="no complex form"):
        dia_spmv_chain(ac, xc[:, 0].contiguous(), 2)
    with pytest.raises(TypeError, match="no complex form"):
        dia_spmv_chain(a, xc[:, 0].contiguous(), 2)
    # a real x of another dtype takes the operator's, as on the CPU
    a32 = poisson_2d(16, dtype=torch.float32, fmt="dia", device=dev)
    x64 = xc[:, 0].real.contiguous()
    y2 = dia_spmv_chain(a32, x64, 2)
    assert y2.dtype == torch.float32
    assert _rel(y2, dia_spmv(a32, dia_spmv(a32, x64.float()))) <= 1e-5
    half = DIA(data=a.data.half(), shape=a.shape, offsets=a.offsets)
    with pytest.raises(TypeError, match="takes float32, float64, complex64"):
        dia_spmm_kernel(half, xc.real.half())
    with pytest.raises(ValueError, match="different devices"):
        dia_spmm_kernel(a, xc.cpu())


@pytest.mark.parametrize("dtype", COMPLEX, ids=["c64", "c128"])
@pytest.mark.parametrize("case", ["p2d_32", "p2d_45", "p3d_9", "wide",
                                  "tall", "flat"])
def test_dia_spmv_kernel_complex_matches_plain(dev, dtype, case):
    """Complex kernel A (one cfma a term, alpha real) against the plain
    version, and a real operator times a complex x (the real multi-RHS
    form on the (nc, 2) block, each part bitwise real kernel A)."""
    real = _dia_case(case, torch.float64, dev)
    a = _phased(real, dtype)
    rng = np.random.default_rng(12)
    x = _crandn(rng, a.shape[1], dtype, dev)
    before = dia_spmv_kernel.launches
    y = dia_spmv_kernel(a, x)
    torch.cuda.synchronize()
    assert dia_spmv_kernel.launches == before + 1
    assert y.dtype == dtype and _rel(y, dia_spmv(a, x)) <= RTOL[dtype]
    assert _rel(dia_spmv_kernel(a, x, alpha=0.37), 0.37 * dia_spmv(a, x)) \
        <= RTOL[dtype]
    assert torch.equal(dia_spmv_kernel(a, x), y)
    ar = DIA(data=real.data.to(torch.float64 if dtype == torch.complex128
                               else torch.float32),
             shape=real.shape, offsets=real.offsets)
    before = (dia_spmv_kernel.launches, dia_spmm_kernel.launches)
    yr = dia_spmv_kernel(ar, x)
    assert (dia_spmv_kernel.launches, dia_spmm_kernel.launches) == \
        (before[0], before[1] + 1)
    assert yr.dtype == dtype and _rel(yr, dia_spmv(ar, x)) <= RTOL[dtype]
    assert torch.equal(yr.real, dia_spmv_kernel(ar, x.real.contiguous()))
    assert torch.equal(yr.imag, dia_spmv_kernel(ar, x.imag.contiguous()))


@pytest.mark.parametrize("dtype", COMPLEX, ids=["c64", "c128"])
@pytest.mark.parametrize("m", [1, 2, 3, 16, 80, 96, 160])
@pytest.mark.parametrize("case", ["p2d_45", "p3d_9", "wide", "tall", "flat"])
def test_dia_spmm_kernel_complex_matches_plain(dev, dtype, m, case):
    """Complex kernel A's multi-RHS form, both layouts, against the plain
    versions: m from one lane a row past the four chunks a lane holds
    (tiled), every column bitwise complex kernel A on it."""
    a = _phased(_dia_case(case, torch.float64, dev), dtype)
    x = _crandn(np.random.default_rng(13), (a.shape[1], m), dtype, dev)
    before = dia_spmm_kernel.launches
    y = dia_spmm_kernel(a, x)
    yp = dia_spmm_planes_kernel(a, x.T.contiguous())
    torch.cuda.synchronize()
    assert dia_spmm_kernel.launches == before + 2
    assert y.shape == (a.shape[0], m) and yp.shape == (m, a.shape[0])
    assert _rel(y, dia_spmm(a, x)) <= RTOL[dtype]
    assert _rel(yp, dia_spmm_planes(a, x.T.contiguous())) <= RTOL[dtype]
    for t in range(m):
        col = dia_spmv_kernel(a, x[:, t].contiguous())
        assert torch.equal(y[:, t], col) and torch.equal(yp[t], col), t
    assert torch.equal(dia_spmm_kernel(a, x), y)


@pytest.mark.parametrize("dtype", COMPLEX, ids=["c64", "c128"])
@pytest.mark.parametrize("m", [1, 2, 16, 80, 96])
def test_dia_spmm_complex_offset_views(dev, dtype, m):
    """Complex X, and plane-major planes, that start one element past an
    aligned boundary (for complex64 8 bytes off 16, the scalar lanes) give
    bitwise the aligned call's result, and read nothing outside the view
    (NaN around it)."""
    a = _phased(_dia_case("tall", torch.float64, dev), dtype)
    nc = a.shape[1]
    rng = np.random.default_rng(14)
    for planes in (False, True):
        src = _crandn(rng, (m, nc) if planes else (nc, m), dtype, dev)
        flat = torch.full((src.numel() + 4,), complex("nan+nanj"),
                          dtype=dtype, device=dev)
        view = flat[1:1 + src.numel()].view(src.shape)
        view.copy_(src)
        call = dia_spmm_planes_kernel if planes else dia_spmm_kernel
        y = call(a, view)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(y).all())
        assert torch.equal(y, call(a, src))
        plain = dia_spmm_planes(a, src) if planes else dia_spmm(a, src)
        assert _rel(y, plain) <= RTOL[dtype]


def test_feast_eigsh_on_card(dev):
    """eigsh at 24**2 on the card: the DIA route through kernel A's
    multi-RHS form, the permuted operator through kernel D, both against
    the analytic spectrum within 1e-10."""
    from sparse_linear_tpu_torch.eig import pipeline
    from sparse_linear_tpu_torch.eig.feast import (
        INFO_OK, FeastParams, count_eigenvalues, eigsh)

    g = 24
    lam1 = 4 * np.sin(np.arange(1, g + 1) * np.pi / (2 * (g + 1))) ** 2
    lam = np.sort((lam1[:, None] + lam1[None, :]).ravel())
    emax = float((lam[19] + lam[20]) / 2)
    a = poisson_2d(g, dtype=torch.float64, device=dev)
    before = dia_spmm_kernel.launches
    res = eigsh(32, (0.0, emax), a, FeastParams(
        tol=1e-10, backend="multifrontal", dims=(g, g)))
    assert dia_spmm_kernel.launches > before
    assert res.info == INFO_OK and res.n_found == 20
    np.testing.assert_allclose(res.values, lam[:20], rtol=1e-10)
    assert res.vectors.device.type == "cuda"
    assert pipeline.last_run["routes"] == ("dia", "identity")
    before = well_spmm.launches
    res = eigsh(32, (0.0, emax), _permuted_poisson(g, torch.float64, dev),
                FeastParams(tol=1e-10, backend="multifrontal"))
    assert well_spmm.launches > before
    assert res.info == INFO_OK
    np.testing.assert_allclose(res.values, lam[:20], rtol=1e-10)
    est = count_eigenvalues((0.0, emax), a, params=FeastParams(
        backend="multifrontal", dims=(g, g)))
    assert abs(est - 20) < 5


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", ["one_full_row_a_slice",
                                  "three_full_rows_and_the_diagonal"])
def test_feast_low_fill_operator_runs_kernel_d(dev, monkeypatch, dtype,
                                               case):
    """A real operator that is not banded runs on kernel D however low its
    WELL fill: the plain ``ops.linalg.spmm`` is never reached on CUDA."""
    from sparse_linear_tpu_torch.eig import pipeline
    from sparse_linear_tpu_torch.ops import linalg

    def refuse(*args, **kwargs):
        raise AssertionError("ops.linalg.spmm reached on CUDA")

    monkeypatch.setattr(linalg, "spmm", refuse)
    n = 2048
    full = np.arange(0, n, 32) if case == "one_full_row_a_slice" else \
        np.array([1, n // 2, n - 1])
    rows = full.repeat(n)
    cols = np.tile(np.arange(n), full.size)
    if case != "one_full_row_a_slice":
        rows = np.concatenate([rows, np.arange(n)])
        cols = np.concatenate([cols, np.arange(n)])
    vals = np.random.default_rng(7).standard_normal(rows.size)
    a = st.from_triples((n, n), torch.as_tensor(rows), torch.as_tensor(cols),
                        torch.as_tensor(vals, dtype=dtype),
                        device=dev).tocsr()
    op = pipeline._structured_op(a)
    assert op.route == "well"
    x = torch.as_tensor(np.random.default_rng(8).standard_normal((n, 5)),
                        dtype=dtype, device=dev)
    xc = torch.complex(x, x.flip(0))
    before = well_spmm.launches
    y, yc = op(x), op(xc)
    torch.cuda.synchronize()
    assert well_spmm.launches == before + 2
    dense = a.todense()
    scale = max(float(dense.abs().max()), 1.0) * n
    assert float((y - dense @ x).abs().max()) <= RTOL[dtype] * scale
    assert float((yc - dense.to(xc.dtype) @ xc).abs().max()) <= \
        RTOL[dtype] * scale


# ------------------------------------------- WELL kernels C and D (slice 2)

def _permuted_poisson(g, dtype, dev, seed=0):
    """The g**2 five-point operator with rows and columns relabelled by one
    seeded permutation."""
    coo = poisson_2d(g, dtype=dtype, device=dev).tocoo()
    gen = torch.Generator(device=dev).manual_seed(seed)
    perm = torch.randperm(g * g, device=dev, generator=gen)
    return st.from_triples((g * g, g * g), perm[coo.row.long()],
                           perm[coo.col.long()], coo.data).tocsr()


def _skewed(rng, nr, nc, dtype, dev):
    """0-64 entries a row, about 1 % of rows empty, three rows of 4096."""
    lens = rng.integers(1, 65, nr)
    lens[rng.random(nr) < 0.01] = 0
    lens[[1, nr // 2, nr - 1]] = 4096
    rows = np.repeat(np.arange(nr), lens)
    cols = rng.integers(0, nc, rows.size)
    return st.from_triples((nr, nc), rows, cols, rng.standard_normal(
        rows.size), dtype=dtype, device=dev).tocsr()


def _well_case(case, dtype, dev):
    rng = np.random.default_rng(3)
    if case == "permuted_64":
        return _permuted_poisson(64, dtype, dev)
    if case == "skewed_3000x5000":
        return _skewed(rng, 3000, 5000, dtype, dev)
    if case == "tiny_7x9":
        return st.from_dense(rng.standard_normal((7, 9)) * (
            rng.random((7, 9)) < 0.4), device=dev).map_values(
                lambda v: v.to(dtype))
    return st.zeros((100, 50), dtype=dtype, device=dev)


WELL_CASES = ["permuted_64", "skewed_3000x5000", "tiny_7x9", "empty_100x50"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", WELL_CASES)
def test_well_spmv_kernel_matches_plain(dev, dtype, case):
    a = _well_case(case, dtype, dev)
    w = csr_to_well(a)
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(
        a.shape[1]), dtype=dtype, device=dev)
    before = well_spmv.launches
    y = well_spmv(w, x)
    torch.cuda.synchronize()
    assert well_spmv.launches == before + 1
    ref = well_spmv_plain(w, x)
    assert y.shape == ref.shape == (a.shape[0],)
    if a.nnz == 0:
        assert not bool(y.any())
    else:
        assert _rel(y, ref) <= RTOL[dtype]
        assert _rel(y, st.spmv(a, x)) <= RTOL[dtype]
    # W @ x is the kernel on CUDA tensors
    w @ x
    assert well_spmv.launches == before + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("m", [1, 2, 4, 5, 8, 16, 17, 32, 33, 40, 64, 80,
                               96, 168])
@pytest.mark.parametrize("case", WELL_CASES)
def test_well_spmm_kernel_matches_plain(dev, dtype, m, case):
    """Plane-major and column-major, m from one lane a row to five chunks a
    lane (m = 80 in f64, 160 in f32) and past them (96 and 168 in f64, 168
    in f32: column-major Y tiled in 16-byte vectors), every lane width of
    the vector and scalar lanes (m * itemsize a multiple of 16 or not),
    with strided planes, on empty
    rows, a partial last slice, skewed long rows (staged in several
    rounds) and rectangular shapes."""
    a = _well_case(case, dtype, dev)
    w = csr_to_well(a)
    xp = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (m, a.shape[1])), dtype=dtype, device=dev)
    before = well_spmm.launches
    y = well_spmm_planes(w, xp)
    torch.cuda.synchronize()
    assert well_spmm.launches == before + 1
    ref = well_spmm_planes_plain(w, xp)
    assert y.shape == (m, a.shape[0])
    assert _rel(y, ref) <= RTOL[dtype]
    yc = well_spmm(w, xp.T)          # column-major view: strides (1, nc)
    assert yc.shape == (a.shape[0], m)
    assert _rel(yc, ref.T) <= RTOL[dtype]
    yc2 = well_spmm(w, xp.T.contiguous())
    assert _rel(yc2, ref.T) <= RTOL[dtype]
    assert well_spmm.launches == before + 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("kernel", ["well_spmv", "dia_spmv_chain",
                                    "well_spmm"])
def test_redesigned_kernels_repeat_bitwise(dev, dtype, kernel):
    """Kernels C, B and D, redesigned for the H100, give bitwise the same
    result twice on one input: each row sums in a fixed order, with no
    atomics."""
    rng = np.random.default_rng(6)
    if kernel == "well_spmv":
        a = csr_to_well(_well_case("skewed_3000x5000", dtype, dev))
        run = lambda x: well_spmv(a, x)  # noqa: E731
    elif kernel == "well_spmm":
        a = csr_to_well(_well_case("skewed_3000x5000", dtype, dev))
        run = lambda x: well_spmm(a, x.reshape(-1, 1).expand(  # noqa: E731
            -1, 40) * torch.arange(1, 41, dtype=dtype, device=dev))
    else:
        a = poisson_2d(45, dtype=dtype, fmt="dia", device=dev)
        run = lambda x: dia_spmv_chain(a, x, 7, alpha=0.25)  # noqa: E731
    x = torch.as_tensor(rng.standard_normal(a.shape[1]), dtype=dtype,
                        device=dev)
    y1 = run(x)
    y2 = run(x)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("m", [16, 80])
@pytest.mark.parametrize("case", ["permuted_64", "skewed_3000x5000"])
def test_well_spmm_columns_are_kernel_c(dev, dtype, m, case):
    """Kernel D sums every entry over its row's slots in slot order from
    zero with one fma a slot, as kernel C does: each column of
    ``well_spmm(w, X)`` is bitwise ``well_spmv(w, X[:, t])``, in both
    layouts, across staging rounds of the skewed case's long rows."""
    w = csr_to_well(_well_case(case, dtype, dev))
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (w.shape[1], m)), dtype=dtype, device=dev)
    y = well_spmm(w, x)
    yp = well_spmm_planes(w, x.T.contiguous())
    torch.cuda.synchronize()
    for t in range(m):
        col = well_spmv(w, x[:, t])
        assert torch.equal(y[:, t], col), t
        assert torch.equal(yp[t], col), t


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_well_spmm_odd_x_layouts(dev, dtype):
    """X that kernel D cannot read in 16-byte vectors -- a column slice
    (copied to row-major, m * itemsize not a multiple of 16), a row-major
    X whose base is not 16-byte aligned, an odd m of planes -- takes the
    scalar lanes: the result matches the plain version, and nothing
    outside X is read (the values around it are NaN, which would show)."""
    w = csr_to_well(_well_case("permuted_64", dtype, dev))
    nc = w.shape[1]
    rng = np.random.default_rng(8)
    big = torch.as_tensor(rng.standard_normal((nc, 9)), dtype=dtype,
                          device=dev)
    xs = big[:, 2:7]  # strided column slice, m = 5
    ref = well_spmm_planes_plain(w, xs.T)
    assert _rel(well_spmm(w, xs), ref.T) <= RTOL[dtype]
    for m in (2, 4, 8):
        flat = torch.full((nc * m + 32,), float("nan"), dtype=dtype,
                          device=dev)
        # one element past a 16-byte boundary, NaN on both sides
        xm = flat[1:1 + nc * m].view(nc, m)
        assert xm.data_ptr() % 16 != 0
        xm.copy_(big[:, :m])
        y = well_spmm(w, xm)
        assert bool(torch.isfinite(y).all())
        assert _rel(y, well_spmm_planes_plain(w, xm.T).T) <= RTOL[dtype]
    xp = big[:, :7].T.contiguous()  # odd m of planes
    assert _rel(well_spmm_planes(w, xp), well_spmm_planes_plain(w, xp)) \
        <= RTOL[dtype]


def test_well_kernels_f64_contract_and_spgemm(dev):
    a = _permuted_poisson(96, torch.float64, dev, seed=1)
    a = a.map_values(lambda v: v * (1 + 1e-3 * torch.randn(
        v.shape, dtype=v.dtype, device=dev,
        generator=torch.Generator(device=dev).manual_seed(2))))
    w = csr_to_well64(a)
    x = torch.randn(a.shape[1], dtype=torch.float64, device=dev)
    y, ref = well_spmv64(w, x), st.spmv(a, x)
    assert float(torch.linalg.vector_norm(y - ref)
                 / torch.linalg.vector_norm(ref)) <= 1e-13
    xp = torch.randn((3, a.shape[1]), dtype=torch.float64, device=dev)
    assert _rel(well_spmm64_planes(w, xp), well_spmm_planes_plain(w, xp)) \
        <= 1e-12
    # staged SpGEMM (kernel C three times) against the sort-based form
    c0 = well_spmv.launches
    plan = spgemm_plan_well(a, a)
    c = spgemm_apply_well(plan, a.data, a.data)
    assert well_spmv.launches == c0 + 3
    ref_c = spgemm(a, a)
    assert torch.equal(c.indptr.long(), ref_c.indptr.long())
    assert torch.equal(c.indices, ref_c.indices)
    assert _rel(c.data, ref_c.data) <= 1e-12


def test_well_kernels_refuse(dev):
    """Complex values run (a complex WELL on the complex kernels, a real
    WELL times a complex x on the real ones); a dtype no kernel takes,
    other devices, a wrong length and a corrupt layout raise."""
    a = _permuted_poisson(8, torch.float32, dev)
    wc = csr_to_well(a.map_values(lambda v: v.to(torch.complex64)))
    x = torch.ones(64, dtype=torch.complex64, device=dev)
    ref = well_spmv_plain(wc, x)
    assert _rel(well_spmv(wc, x), ref) <= 1e-5
    assert _rel(well_spmm_planes(wc, x[None, :])[0], ref) <= 1e-5
    w = csr_to_well(a)
    assert _rel(well_spmv(w, x), ref) <= 1e-5
    half = csr_to_well(a.map_values(lambda v: v.half()))
    with pytest.raises(TypeError, match="takes float32, float64, complex64"):
        well_spmv(half, torch.ones(64, dtype=torch.half, device=dev))
    with pytest.raises(ValueError, match="different devices"):
        well_spmv(w, torch.ones(64))
    with pytest.raises(ValueError, match="dimension mismatch"):
        well_spmv(w, torch.ones(63, device=dev))
    import dataclasses

    bad = dataclasses.replace(w, cols=w.cols + 64)
    with pytest.raises(ValueError, match="sliced layout"):
        well_spmv(bad, torch.ones(64, device=dev))
    with pytest.raises(ValueError, match="sliced layout"):
        well_spmm(bad, torch.ones((64, 2), device=dev))


@pytest.mark.parametrize("dtype", COMPLEX, ids=["c64", "c128"])
@pytest.mark.parametrize("case", WELL_CASES)
def test_well_spmv_kernel_complex_matches_plain(dev, dtype, case):
    """Complex kernel C against its plain version and the CSR SpMV, and a
    real WELL times a complex x (real kernel D on the (nc, 2) block, each
    part bitwise real kernel C)."""
    real = _well_case(case, torch.float64, dev)
    a = _phased(real, dtype)
    w = csr_to_well(a)
    x = _crandn(np.random.default_rng(15), a.shape[1], dtype, dev)
    before = well_spmv.launches
    y = well_spmv(w, x)
    torch.cuda.synchronize()
    assert well_spmv.launches == before + 1
    assert y.dtype == dtype and y.shape == (a.shape[0],)
    if a.nnz == 0:
        assert not bool(y.any())
        return
    assert _rel(y, well_spmv_plain(w, x)) <= RTOL[dtype]
    assert _rel(y, st.spmv(a, x)) <= RTOL[dtype]
    assert torch.equal(well_spmv(w, x), y)
    rdtype = torch.float64 if dtype == torch.complex128 else torch.float32
    wr = csr_to_well(real.map_values(lambda v: v.to(rdtype)))
    before = (well_spmv.launches, well_spmm.launches)
    yr = well_spmv(wr, x)
    assert (well_spmv.launches, well_spmm.launches) == \
        (before[0], before[1] + 1)
    assert yr.dtype == dtype and _rel(yr, well_spmv_plain(wr, x)) <= \
        RTOL[dtype]
    assert torch.equal(yr.real, well_spmv(wr, x.real.contiguous()))
    assert torch.equal(yr.imag, well_spmv(wr, x.imag.contiguous()))


@pytest.mark.parametrize("dtype", COMPLEX, ids=["c64", "c128"])
@pytest.mark.parametrize("m", [1, 2, 5, 16, 80, 96])
@pytest.mark.parametrize("case", WELL_CASES)
def test_well_spmm_kernel_complex_matches_plain(dev, dtype, m, case):
    """Complex kernel D in both layouts against the plain version, m from
    one lane a row past the five chunks a lane holds; every column bitwise
    complex kernel C on it."""
    w = csr_to_well(_phased(_well_case(case, torch.float64, dev), dtype))
    xp = _crandn(np.random.default_rng(16), (m, w.shape[1]), dtype, dev)
    before = well_spmm.launches
    y = well_spmm_planes(w, xp)
    yc = well_spmm(w, xp.T)          # column-major view: strides (1, nc)
    yc2 = well_spmm(w, xp.T.contiguous())
    torch.cuda.synchronize()
    assert well_spmm.launches == before + 3
    ref = well_spmm_planes_plain(w, xp)
    assert y.shape == (m, w.shape[0]) and yc.shape == (w.shape[0], m)
    for got in (y, yc.T, yc2.T):
        assert _rel(got, ref) <= RTOL[dtype]
    if case in ("permuted_64", "skewed_3000x5000"):
        for t in range(m):
            col = well_spmv(w, xp[t])
            assert torch.equal(yc2[:, t], col) and torch.equal(y[t], col), t


@pytest.mark.parametrize("dtype", COMPLEX, ids=["c64", "c128"])
def test_well_spmm_complex_offset_x_and_real_operator(dev, dtype):
    """A complex X one element past an aligned boundary (scalar lanes for
    complex64) matches the aligned call and reads nothing outside it; a
    real WELL times a complex X in both layouts is one launch of real
    kernel D, each part bitwise the real kernel on it."""
    real = _well_case("permuted_64", torch.float64, dev)
    w = csr_to_well(_phased(real, dtype))
    nc = w.shape[1]
    rng = np.random.default_rng(17)
    for m in (2, 5, 16):
        x = _crandn(rng, (nc, m), dtype, dev)
        flat = torch.full((nc * m + 4,), complex("nan+nanj"), dtype=dtype,
                          device=dev)
        xm = flat[1:1 + nc * m].view(nc, m)
        xm.copy_(x)
        y = well_spmm(w, xm)
        assert bool(torch.isfinite(y).all())
        assert torch.equal(y, well_spmm(w, x))
    rdtype = torch.float64 if dtype == torch.complex128 else torch.float32
    wr = csr_to_well(real.map_values(lambda v: v.to(rdtype)))
    x = _crandn(rng, (nc, 16), dtype, dev)
    before = well_spmm.launches
    y = well_spmm(wr, x)
    yp = well_spmm_planes(wr, x.T.contiguous())
    assert well_spmm.launches == before + 2
    assert _rel(y, well_spmm_planes_plain(wr, x.T).T) <= RTOL[dtype]
    assert torch.equal(yp, y.T)
    assert torch.equal(y.real, well_spmm(wr, x.real.contiguous()))
    assert torch.equal(y.imag, well_spmm(wr, x.imag.contiguous()))


def test_feast_complex_operator_runs_the_complex_kernels(dev, monkeypatch):
    """FEAST on a complex Hermitian operator (the gauge-transformed 24**2
    Poisson operator, whose spectrum is Poisson's): banded, it takes the
    DIA route and complex kernel A's multi-RHS form; permuted, the WELL
    route and complex kernel D; ``ops.linalg.spmm`` is never reached."""
    from sparse_linear_tpu_torch.eig import pipeline
    from sparse_linear_tpu_torch.eig.feast import INFO_OK, FeastParams, eigsh
    from sparse_linear_tpu_torch.ops import linalg

    def refuse(*args, **kwargs):
        raise AssertionError("ops.linalg.spmm reached on CUDA")

    monkeypatch.setattr(linalg, "spmm", refuse)
    g = 24
    lam1 = 4 * np.sin(np.arange(1, g + 1) * np.pi / (2 * (g + 1))) ** 2
    lam = np.sort((lam1[:, None] + lam1[None, :]).ravel())
    emax = float((lam[19] + lam[20]) / 2)
    a = _gauge_poisson(g, 0.3, dev)
    assert a.is_hermitian(tol=0.0)
    before = dia_spmm_kernel.launches
    res = eigsh(32, (0.0, emax), a, FeastParams(
        tol=1e-10, backend="multifrontal", dims=(g, g)))
    assert dia_spmm_kernel.launches > before
    assert pipeline.last_run["routes"] == ("dia", "identity")
    assert res.info == INFO_OK
    np.testing.assert_allclose(res.values, lam[:20], rtol=1e-10)
    coo = a.tocoo()
    gen = torch.Generator(device=dev).manual_seed(3)
    perm = torch.randperm(g * g, device=dev, generator=gen)
    ap = st.from_triples((g * g, g * g), perm[coo.row.long()],
                         perm[coo.col.long()], coo.data).tocsr()
    before = well_spmm.launches
    res = eigsh(32, (0.0, emax), ap, FeastParams(tol=1e-10,
                                                 backend="multifrontal"))
    assert well_spmm.launches > before
    assert pipeline.last_run["routes"] == ("well", "identity")
    assert res.info == INFO_OK
    np.testing.assert_allclose(res.values, lam[:20], rtol=1e-10)


def _gauge_poisson(g, theta, dev):
    """The g**2 five-point operator with the phase e^{i theta} on its
    x-links, complex128: kron(I, T_theta) + kron(T_0, I), where T_theta is
    the 1D operator with -e^{i theta} above its diagonal and -e^{-i theta}
    below."""
    def chain(th):
        lo, hi = list(range(g - 1)), list(range(1, g))
        return st.from_triples(
            (g, g), list(range(g)) + lo + hi, list(range(g)) + hi + lo,
            [2.0] * g + [-np.exp(1j * th)] * (g - 1)
            + [-np.exp(-1j * th)] * (g - 1),
            dtype=np.complex128, device=dev).tocsr()

    i = st.eye(g, dtype=torch.complex128, device=dev)
    return st.kron(i, chain(theta)) + st.kron(chain(0.0), i)


# ------------------------------------------------ multifrontal direct solver


def _direct_pair(kind, dtype, g, dev, seed=13):
    """The g**2 five-point pattern with values for ``kind``: the operator
    (plus i times an antisymmetric part in complex: Hermitian positive
    definite) for Cholesky, perturbed off-diagonals (diagonally dominant)
    for LU; (CPU matrix, card matrix)."""
    a = poisson_2d(g, dtype=torch.float64, device="cpu")
    rows, cols = a.row_ids().numpy(), a.indices.numpy()
    vals = a.data.numpy().copy()
    rng = np.random.default_rng(seed)
    off = rows != cols
    pert = rng.uniform(-0.4, 0.4, vals.shape) * off
    if kind == "lu":
        vals = vals + pert
    if dtype.is_complex:
        if kind == "cholesky":
            # antisymmetric imaginary part: entry (r, c) gets +t, (c, r) -t
            key = np.minimum(rows, cols) * g * g + np.maximum(rows, cols)
            t = 0.3 * np.sin(key.astype(np.float64))
            vals = vals + 1j * np.where(rows < cols, t, -t) * off
        else:
            vals = vals + 1j * rng.uniform(-0.4, 0.4, vals.shape) * off
    host = st.from_triples((g * g, g * g), rows, cols,
                           torch.as_tensor(vals).to(dtype),
                           device="cpu").tocsr()
    return host, host.to(dev)


DIRECT_RTOL = {torch.float32: 1e-5, torch.complex64: 1e-5,
               torch.float64: 1e-12, torch.complex128: 1e-12}


@pytest.mark.parametrize("trans", ["N", "H", "T"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex64, torch.complex128],
                         ids=["f32", "f64", "c64", "c128"])
@pytest.mark.parametrize("kind", ["lu", "cholesky"])
def test_direct_solver_on_card_matches_cpu(dev, kind, dtype, trans):
    from sparse_linear_tpu_torch.solve import api

    g = 12
    host, card = _direct_pair(kind, dtype, g, dev)
    sym = api.analyze(host, backend="multifrontal", dims=(g, g))
    f_card = api.factor(card, sym, backend="multifrontal", kind=kind)
    f_host = api.factor(host, sym, backend="multifrontal", kind=kind)
    for blk in f_card.blocks.values():
        for t in blk.values():
            assert t.device.type == "cuda"
    assert not f_card.breakdown and f_card.n_flagged == 0
    rng = np.random.default_rng(3)
    b = rng.standard_normal((g * g, 3))
    if dtype.is_complex:
        b = b + 1j * rng.standard_normal(b.shape)
    b = torch.as_tensor(b).to(dtype)
    x = api.solve(f_card, b.to(dev), trans=trans)
    torch.cuda.synchronize()
    assert x.device.type == "cuda" and x.dtype == dtype
    ref = api.solve(f_host, b, trans=trans)
    assert _rel(x.cpu(), ref) <= DIRECT_RTOL[dtype]
    tol = 1e-4 if dtype in (torch.float32, torch.complex64) else 1e-12
    assert float(api.residual_norm(card, x, b.to(dev), trans=trans)) <= tol


def test_direct_factor_batched_on_card(dev):
    from sparse_linear_tpu_torch.solve import multifrontal as mf

    g = 10
    host, card = _direct_pair("lu", torch.complex128, g, dev)
    sym = mf.analyze(host, dims=(g, g))
    diag = (host.row_ids() == host.indices).to(torch.complex128)
    stack = torch.stack([host.data + (0.5j * e) * diag for e in range(3)])
    fb_card = mf.factor_batched(stack.to(dev), sym)
    fb_host = mf.factor_batched(stack, sym)
    assert fb_card.batch == 3
    for blk in fb_card.blocks.values():
        for t in blk.values():
            assert t.device.type == "cuda"
    bs = torch.randn((3, g * g, 4), dtype=torch.complex128,
                     generator=torch.Generator().manual_seed(5))
    for trans in (False, True):
        x = mf.solve_batched(fb_card, bs.to(dev), trans=trans)
        assert x.device.type == "cuda"
        assert _rel(x.cpu(), mf.solve_batched(fb_host, bs, trans=trans)
                    ) <= 1e-12
    np.testing.assert_allclose(mf.slogdet(fb_card)[1],
                               mf.slogdet(fb_host)[1], rtol=1e-12)


def test_direct_full_f32_on_card_under_tf32(dev):
    """TF32 asked for globally: the factor and the solve still run in full
    f32 (TF32's 10-bit mantissa would miss 1e-5 by far), and the caller's
    setting comes back."""
    from sparse_linear_tpu_torch.solve import api

    g = 48
    host, card = _direct_pair("cholesky", torch.float32, g, dev)
    sym = api.analyze(host, backend="multifrontal", dims=(g, g))
    b = torch.randn(g * g, generator=torch.Generator().manual_seed(1))
    ref = api.solve(api.factor(host, sym, backend="multifrontal",
                               kind="cholesky"), b)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        f = api.factor(card, sym, backend="multifrontal", kind="cholesky")
        x = api.solve(f, b.to(dev))
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert _rel(x.cpu(), ref) <= 1e-5


def test_direct_refined_on_card(dev):
    """f32 factors on the card refined with f64 residuals to 1e-10."""
    from sparse_linear_tpu_torch.solve import api

    g = 64
    a32 = poisson_2d(g, dtype=torch.float32, device=dev)
    a64 = poisson_2d(g, dtype=torch.float64, device=dev)
    sym = api.analyze(a32, backend="multifrontal", dims=(g, g))
    for kind, opts in (("cholesky", {}), ("lu", {"pivot_eps": 1e-10})):
        f = api.factor(a32, sym, backend="multifrontal", kind=kind, **opts)
        b = torch.randn(g * g, dtype=torch.float64, device=dev)
        x, info = api.solve_refined(f, a64, b, tol=1e-10, max_iter=4)
        assert x.device.type == "cuda" and info.converged
        assert float(api.residual_norm(a64, x, b)) <= 1e-10


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex128])
@pytest.mark.parametrize("exchange", ["halo", "allgather"])
def test_sharded_dia_on_four_shards_is_kernel_a(dev, dtype, exchange):
    """Kernel A on each of four shards of a card mesh (the halo-extended or
    gathered x): within tolerance of the plain product on the same x and
    bitwise the unsharded kernel A, every piece on the card, four launches
    a product."""
    from sparse_linear_tpu_torch.dist import card_mesh
    from sparse_linear_tpu_torch.dist.spmv import (
        dia_spmv_sharded,
        shard_dia_rows,
    )

    mesh = card_mesh(4)
    a = poisson_2d(256, dtype=dtype, fmt="dia", device=dev)
    x = torch.randn(256 * 256, dtype=dtype, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(4))
    sh = shard_dia_rows(a, mesh)
    before = dia_spmv_kernel.launches
    y = dia_spmv_sharded(sh, x, mesh, exchange=exchange)
    assert dia_spmv_kernel.launches - before == 4
    assert all(p.device.type == "cuda" for p in y.pieces)
    assert _rel(y.full(), dia_spmv(a, x)) <= RTOL[dtype]
    assert torch.equal(y.full(), dia_spmv_kernel(a, x))


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
@pytest.mark.parametrize("exchange", ["window", "allgather"])
def test_sharded_well_on_four_shards_is_kernel_c(dev, dtype, exchange):
    """Kernel C on each of four shards (the stencil-order operator: a
    window plan or the gathered x) and on the permuted one (all-gather):
    within 1e-12 of the plain product and of the unsharded kernel C on the
    same x."""
    from sparse_linear_tpu_torch.dist import card_mesh
    from sparse_linear_tpu_torch.dist.spmv import (
        shard_well_rows,
        spmv_sharded,
    )

    mesh = card_mesh(4)
    g = 128
    gen = torch.Generator(device=dev).manual_seed(5)
    csr = poisson_2d(g, dtype=dtype, device=dev)
    perm = torch.randperm(g * g, device=dev, generator=gen)
    coo = csr.tocoo()
    permuted = st.from_triples(csr.shape, perm[coo.row.long()],
                               perm[coo.col.long()], coo.data).tocsr()
    x = torch.randn(g * g, dtype=dtype, device=dev, generator=gen)
    for mat, ex in ((csr, exchange), (permuted, "allgather")):
        sh = shard_well_rows(mat, mesh, exchange=ex)
        assert (sh.xplan is not None) == (ex == "window")
        before = well_spmv.launches
        y = spmv_sharded(sh, x, mesh)
        assert well_spmv.launches - before == 4
        w = csr_to_well(mat)
        assert _rel(y.full(), well_spmv_plain(w, x)) <= 1e-12
        assert _rel(y.full(), well_spmv(w, x)) <= 1e-12


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_spmm_sharded_on_two_shards_is_the_unsharded_kernel(dev, dtype):
    """The multi-RHS form of the row-sharded product at FEAST's m = 80 on
    two shards of a card mesh: kernel A's multi-RHS form a DIA slab
    (halo, and zero-padded slabs where the shards do not divide the rows),
    bitwise the unsharded kernel, and kernel D a WELL slab (window and
    all-gather), within 1e-12 of the unsharded kernel D; one launch a
    slab."""
    from sparse_linear_tpu_torch.dist import ShardedBlock, card_mesh
    from sparse_linear_tpu_torch.dist.spmv import (
        shard_dia_rows,
        shard_well_rows,
        spmm_sharded,
    )
    from sparse_linear_tpu_torch.formats.structured import csr_to_dia

    mesh = card_mesh(2)
    gen = torch.Generator(device=dev).manual_seed(6)
    for g in (128, 127):
        csr = poisson_2d(g, dtype=dtype, device=dev)
        x = torch.randn((g * g, 80), dtype=dtype, device=dev, generator=gen)
        dia = csr_to_dia(csr)
        sh = shard_dia_rows(dia, mesh, pad=True)
        before = dia_spmm_kernel.launches
        y = spmm_sharded(sh, ShardedBlock.from_tensor(x, mesh), mesh)
        assert dia_spmm_kernel.launches - before == 2
        assert all(p.device.type == "cuda" for p in y.pieces)
        assert torch.equal(y.full(), dia_spmm_kernel(dia, x))
        assert _rel(y.full(), dia_spmm(dia, x)) <= RTOL[dtype]
        for mat, ex in ((csr, "window"),
                        (_permuted_poisson(g, dtype, dev), "allgather")):
            sw = shard_well_rows(mat, mesh, exchange=ex)
            before = well_spmm.launches
            y = spmm_sharded(sw, x, mesh)
            assert well_spmm.launches - before == 2
            assert _rel(y.full(), well_spmm(csr_to_well(mat), x)) <= 1e-12


def test_row_sharded_feast_on_card(dev):
    """FEAST on a (2, 2) ("cp", "rows") card mesh at 24**2, the DIA route
    and the permuted operator's WELL route: the unsharded run's loops and
    eigenvalues within 1e-12, the analytic spectrum within 1e-10, the
    row-sharded products launched, vectors on the card."""
    from sparse_linear_tpu_torch.dist import card_mesh
    from sparse_linear_tpu_torch.eig import pipeline
    from sparse_linear_tpu_torch.eig.feast import INFO_OK, FeastParams, eigsh

    g = 24
    lam1 = 4 * np.sin(np.arange(1, g + 1) * np.pi / (2 * (g + 1))) ** 2
    lam = np.sort((lam1[:, None] + lam1[None, :]).ravel())
    emax = float((lam[19] + lam[20]) / 2)
    mesh = card_mesh((2, 2), ("cp", "rows"))
    for a, p, kern in (
            (poisson_2d(g, dtype=torch.float64, device=dev),
             FeastParams(tol=1e-10, backend="multifrontal", dims=(g, g)),
             dia_spmm_kernel),
            (_permuted_poisson(g, torch.float64, dev),
             FeastParams(tol=1e-10, backend="multifrontal"), well_spmm)):
        single = eigsh(32, (0.0, emax), a, p)
        before = kern.launches
        res = eigsh(32, (0.0, emax), a, p, mesh=mesh)
        run = pipeline.last_run
        assert kern.launches > before
        assert run["mode"] == "sharded" and len(run["rows_shards"]) == 2
        assert res.info == INFO_OK and res.iterations == single.iterations
        np.testing.assert_allclose(res.values, single.values, rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(res.values, lam[:20], rtol=1e-10)
        assert res.vectors.device.type == "cuda"
