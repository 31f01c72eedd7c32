"""Interval eigensolver walkthrough on the PyTorch port: count -> solve ->
warm restart -> slice, then the Chebyshev filter, on the card.

The counterpart of ``eigensolve.py``: the reference's FEAST layer
(Feast.hs:53-70) plus the 4.x-class extensions (stochastic counting,
spectrum slicing), on the 24**2 Poisson operator in f64.  Runs on the CUDA
card by default; pass ``--device cpu`` for the CPU.

    python examples/torch_eigensolve.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import numpy as np
import torch

from sparse_linear_tpu_torch.eig.chebyshev import eigsh_filtered
from sparse_linear_tpu_torch.eig.feast import (
    FeastParams,
    count_eigenvalues,
    eigsh,
    eigsh_sliced,
)
from sparse_linear_tpu_torch.utils.grids import poisson_2d


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args(argv).device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "host"
    print(f"device: {dev} ({name})")
    g = 24
    a = poisson_2d(g, dtype=torch.float64, device=dev)
    params = FeastParams(tol=1e-10, dims=(g, g), backend="multifrontal")
    interval = (0.0, 0.8)

    # size the subspace before solving (FEAST 4.x fpm(14)=2 analog)
    est = count_eigenvalues(interval, a, probes=16, params=params)
    m0 = int(np.ceil(est * 1.25)) + 4
    print(f"estimated pairs in {interval}: {est:.1f} -> m0 = {m0}")

    res = eigsh(m0, interval, a, params)
    print(f"found {res.n_found} pairs in {res.iterations} loops, "
          f"worst residual {res.epsout:.1e}, vectors on "
          f"{res.vectors.device}")

    # analytic check: 2D Poisson spectrum
    i = np.arange(1, g + 1)
    lam1 = 4 * np.sin(i * np.pi / (2 * (g + 1))) ** 2
    lam2 = np.sort((lam1[:, None] + lam1[None, :]).ravel())
    want = lam2[(lam2 >= interval[0]) & (lam2 <= interval[1])]
    assert res.n_found == len(want)
    np.testing.assert_allclose(np.sort(res.values), want, rtol=1e-10)
    print("matches the analytic spectrum to 1e-10")

    # warm restart from the converged subspace (reference guess/fpm[4]=1)
    again = eigsh(m0, interval, a, params, guess=res.subspace)
    print(f"warm restart converged in {again.iterations} loops "
          f"(cold: {res.iterations})")

    # wide interval: spectrum slicing keeps every subspace small
    wide = (0.0, float((lam2[59] + lam2[60]) / 2))
    sliced = eigsh_sliced(wide, a, m0_max=24, params=params)
    print(f"sliced solve of {wide[1]:.3f}-wide interval: "
          f"{sliced.n_found} pairs, worst residual {sliced.epsout:.1e}")

    # k-lowest problems at scale: the factorization-free Chebyshev filter
    # (eig/chebyshev.py), products only, no contour factorizations
    k = 10
    emax = float((lam2[k - 1] + lam2[k]) / 2)
    filt = eigsh_filtered(2 * k, (0.0, emax), a, tol=1e-10)
    assert filt.n_found == k
    np.testing.assert_allclose(np.sort(filt.values), lam2[:k], rtol=1e-10)
    print(f"chebyshev-filtered: {filt.n_found} lowest pairs in "
          f"{filt.iterations} passes, worst residual {filt.epsout:.1e}")


if __name__ == "__main__":
    main()
