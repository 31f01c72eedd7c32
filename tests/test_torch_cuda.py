"""The port's Hopper kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and nvcc: it is marked ``cuda`` and
skips without a card.  This file imports no JAX, so it also runs where JAX
is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: max |y - y_plain| / max |y_plain| <= 1e-5 in f32 and 1e-12 in
f64.  The kernel sums the diagonals in the stored order, as the plain
version does; only fused multiply-adds may round differently.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparse_linear_tpu_torch.formats.structured import DIA  # noqa: E402
from sparse_linear_tpu_torch.kernels.spmv import dia_spmv  # noqa: E402
from sparse_linear_tpu_torch.kernels.spmv_dia import (  # noqa: E402
    dia_spmv_chain,
    dia_spmv_kernel,
)
from sparse_linear_tpu_torch.utils.grids import poisson_2d, poisson_3d  # noqa: E402

pytestmark = pytest.mark.cuda

RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _rel(y, ref):
    return float((y - ref).abs().max() / ref.abs().max().clamp_min(1e-300))


def _random_dia(rng, shape, offsets, dtype, dev):
    nr, nc = shape
    data = rng.standard_normal((len(offsets), nr))
    i = np.arange(nr)
    for d, off in enumerate(offsets):
        data[d][(i + off < 0) | (i + off >= nc)] = 0
    return DIA(data=torch.as_tensor(data, dtype=dtype, device=dev),
               shape=shape, offsets=tuple(offsets))


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
    a = poisson_2d(8, dtype=torch.complex64, fmt="dia", device=dev)
    with pytest.raises(TypeError, match="complex"):
        dia_spmv_kernel(a, torch.ones(64, dtype=torch.complex64, device=dev))
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
