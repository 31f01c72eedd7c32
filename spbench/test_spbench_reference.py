"""The plain reference, the generators, the byte counts and the trace
reduction, at tiny sizes on the CPU:  python -m pytest spbench -q"""

import math

import numpy as np
import pytest
import torch

from spbench import devtrace, roofline
from spbench.operators import laplacian, lognormal
from spbench.reference import product, spectrum, subspace

GRIDS = [[5], [5, 4], [3, 4, 2]]


def _dense(grid, kappa=None):
    n = math.prod(grid)
    rows, cols, vals = laplacian.triples(grid, torch.float64, "cpu", kappa)
    a = np.zeros((n, n))
    np.add.at(a, (rows.numpy(), cols.numpy()), vals.numpy())
    return a


@pytest.mark.parametrize("grid", GRIDS)
def test_spectrum_is_numpy_eigh_of_the_generated_operator(grid):
    a = _dense(grid)
    assert np.allclose(a, a.T)
    np.testing.assert_allclose(spectrum.eigenvalues(grid),
                               np.linalg.eigvalsh(a), rtol=0, atol=1e-12)


def test_generator_is_the_five_point_stencil():
    a = _dense([4, 3])
    assert np.all(np.diag(a) == 4.0)
    assert a[0, 1] == -1 and a[0, 4] == -1 and a[3, 4] == 0  # no x wrap
    assert len(laplacian.pattern([4, 3], "cpu")[0]) == 12 + 2 * (9 + 8)


def test_spectrum_inside_a_window():
    lam = spectrum.eigenvalues([6, 6])
    got = spectrum.inside(lam, (lam[3] - 1e-9, lam[10] + 1e-9))
    np.testing.assert_array_equal(got, lam[3:11])


@pytest.mark.parametrize("grid", GRIDS)
def test_product_is_the_dense_product(grid):
    n = math.prod(grid)
    rows, cols, vals = laplacian.triples(grid, torch.float64, "cpu")
    x = torch.randn(n, 11, dtype=torch.float64)
    want = _dense(grid) @ x.numpy()
    np.testing.assert_allclose(product.matvec(rows, cols, vals, x).numpy(),
                               want, atol=1e-13)
    np.testing.assert_allclose(
        product.matvec(rows, cols, vals, x[:, 0]).numpy(), want[:, 0],
        atol=1e-13)


def test_residual_of_a_dense_solve_in_a_lognormal_field():
    grid = [6, 5]
    gen = torch.Generator().manual_seed(3)
    kappa = lognormal.field(grid, 1.0, 0.3, gen, "cpu")
    assert kappa.shape == (5, 6) and bool((kappa > 0).all())
    a = _dense(grid, kappa)
    assert np.allclose(a, a.T) and np.linalg.eigvalsh(a).min() > 0
    b = np.random.default_rng(0).standard_normal(30)
    x = np.linalg.solve(a, b)
    rows, cols, vals = laplacian.triples(grid, torch.float64, "cpu", kappa)
    good = product.relative_residual(rows, cols, vals, torch.tensor(x),
                                     torch.tensor(b))
    bad = product.relative_residual(rows, cols, vals,
                                    torch.tensor(x).to(torch.float32),
                                    torch.tensor(b))
    assert good < 1e-14 < 1e-10 < bad


def test_unit_kappa_is_the_constant_operator():
    grid = [4, 3, 2]
    ones = torch.ones(tuple(reversed(grid)), dtype=torch.float64)
    np.testing.assert_array_equal(
        laplacian.values(grid, torch.float64, "cpu", ones).numpy(),
        laplacian.values(grid, torch.float64, "cpu").numpy())


def test_field_has_unit_variance_in_the_log():
    gen = torch.Generator().manual_seed(1)
    g = torch.log(lognormal.field([128, 128], 1.0, 0.01, gen, "cpu"))
    assert abs(float(g.var()) - 1.0) < 0.1


def test_byte_counts_on_tiny_operators():
    # 2D 4x3: 12 rows, 46 nonzeros; f64 DIA reads values alone, WELL
    # values and int32 columns; x read and y written once
    rows, _, _ = laplacian.triples([4, 3], torch.float64, "cpu")
    nnz = len(rows)
    assert nnz == 46
    assert roofline.spmv_bytes(12, 12, nnz, 8, False) == 46 * 8 + 24 * 8
    assert roofline.spmv_bytes(12, 12, nnz, 8, True) == 46 * 12 + 24 * 8
    # the 3D configuration: 723.4 MB a DIA product, 1,004.4 MB through WELL
    n, nnz3 = 216 ** 3, 70_263_936
    assert roofline.spmv_bytes(n, n, nnz3, 8, False) == 723_354_624
    assert roofline.spmv_bytes(n, n, nnz3, 8, True) == 1_004_410_368
    t = 723_354_624 / 3.35e12
    assert roofline.roofline_pct(723_354_624, 2 * t) == pytest.approx(50.0)


def test_trace_reduction():
    # two kernels overlapping, then gaps of 5 us (the host in a copy that
    # aten::item made)
    # and 2 us; host events are (name, start, end) in ns
    dev = [("k1(double*)", 0, 10_000), ("k2", 5_000, 10_000),
           ("k1(double*)", 20_000, 3_000), ("k2", 25_000, 1_000)]
    host = [("spbench.request", -1_000, 39_000),
            ("aten::item", 16_000, 18_000),
            ("cudaMemcpyAsync", 16_500, 17_800)]
    tr = devtrace.Trace(1e-4, dev, host)
    assert tr.busy_s == pytest.approx(19e-6)
    assert tr.kernel("k1") == (pytest.approx(13e-6), 2)
    assert tr.device_ops[0] == ["k1", pytest.approx(13e-6)]
    names = dict(tr.idle_gaps)
    assert names["spbench.request / aten::item / cudaMemcpyAsync"] == \
        pytest.approx(5e-6)
    assert names["spbench.request / spbench.request"] == pytest.approx(2e-6)


def test_orthonormality_gap():
    q, _ = torch.linalg.qr(torch.randn(40, 6, dtype=torch.float64))
    assert subspace.orthonormality_gap(q) < 1e-14
    twin = q.clone()
    twin[:, 5] = twin[:, 2]
    assert subspace.orthonormality_gap(twin) == pytest.approx(1.0)
    qc, _ = torch.linalg.qr(torch.randn(40, 6, dtype=torch.complex128))
    assert subspace.orthonormality_gap(qc) < 1e-14
    assert subspace.orthonormality_gap(2 * q) == pytest.approx(3.0)
