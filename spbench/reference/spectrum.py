"""The closed-form spectrum of the Dirichlet grid Laplacian.

On a grid of sides n_1 .. n_d the eigenvalues of the (2d, -1) stencil are
the sums over the axes of 4 sin^2(pi k_a / (2 (n_a + 1))), k_a = 1..n_a.
"""

from __future__ import annotations

import numpy as np


def eigenvalues(grid) -> np.ndarray:
    """All eigenvalues, ascending, float64."""
    lam = np.zeros((1,))
    for n in grid:
        k = np.arange(1, n + 1)
        one = 4.0 * np.sin(k * np.pi / (2.0 * (n + 1))) ** 2
        lam = (lam[:, None] + one[None, :]).ravel()
    return np.sort(lam)


def inside(lam: np.ndarray, interval) -> np.ndarray:
    """The eigenvalues in [emin, emax]."""
    lo, hi = np.searchsorted(lam, [interval[0], interval[1]], side="left")
    return lam[lo:hi]
