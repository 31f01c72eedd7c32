"""Triples of the Dirichlet grid Laplacian, 5-point in 2D, 7-point in 3D.

``grid`` is ``[nx, ny]`` or ``[nx, ny, nz]``; unknown ``ix + nx * (iy + ny
* iz)``, x fastest (the numbering of the port's ``utils.grids``, which this
module does not use).  With a node coefficient ``kappa`` the operator is
the finite-difference form of -div(kappa grad u): the coefficient of the
face between two nodes is the harmonic mean of theirs, a face to the
boundary takes its node's, the diagonal sums a node's 2d faces and each
neighbour gets minus its face.  Without ``kappa`` every face is 1: the
diagonal is 2d and each neighbour -1.

The triples come in a fixed order (the diagonal, then each axis and
direction), unsorted: sorting and assembly are the port's work.
"""

from __future__ import annotations

import math

import torch


def _index(grid, device) -> torch.Tensor:
    return torch.arange(math.prod(grid), device=device).reshape(
        tuple(reversed(grid)))


def _faces(shape):
    """(axis, direction) in the order the off-diagonal triples come."""
    return [(ax, d) for ax in range(len(shape)) for d in (-1, 1)]


def _lower(t: torch.Tensor, ax: int) -> torch.Tensor:
    return t.narrow(ax, 0, t.shape[ax] - 1)


def _upper(t: torch.Tensor, ax: int) -> torch.Tensor:
    return t.narrow(ax, 1, t.shape[ax] - 1)


def pattern(grid, device):
    """(rows, cols) int64 of every triple, the diagonal first."""
    idx = _index(grid, device)
    rows, cols = [idx.reshape(-1)], [idx.reshape(-1)]
    for ax, d in _faces(idx.shape):
        src, nb = (_upper(idx, ax), _lower(idx, ax)) if d < 0 else (
            _lower(idx, ax), _upper(idx, ax))
        rows.append(src.reshape(-1))
        cols.append(nb.reshape(-1))
    return torch.cat(rows), torch.cat(cols)


def values(grid, dtype, device, kappa=None) -> torch.Tensor:
    """The values of ``pattern``'s triples, in its order, in ``dtype``."""
    shape = tuple(reversed(grid))
    n = math.prod(grid)
    if kappa is None:
        parts = [torch.full((n,), 2.0 * len(grid), dtype=dtype,
                            device=device)]
        for ax, _ in _faces(shape):
            m = n // shape[ax] * (shape[ax] - 1)
            parts.append(torch.full((m,), -1.0, dtype=dtype, device=device))
        return torch.cat(parts)
    kappa = kappa.reshape(shape).to(torch.float64)
    diag = torch.zeros(shape, dtype=torch.float64, device=device)
    parts = []
    for ax in range(len(shape)):
        lo, hi = _lower(kappa, ax), _upper(kappa, ax)
        face = 2.0 * lo * hi / (lo + hi)
        _lower(diag, ax).add_(face)
        _upper(diag, ax).add_(face)
        diag.narrow(ax, 0, 1).add_(kappa.narrow(ax, 0, 1))
        diag.narrow(ax, shape[ax] - 1, 1).add_(
            kappa.narrow(ax, shape[ax] - 1, 1))
        off = -face.reshape(-1)
        parts += [off, off]
    return torch.cat([diag.reshape(-1)] + parts).to(dtype)


def triples(grid, dtype, device, kappa=None):
    """(rows, cols, vals) of the operator on ``grid``."""
    rows, cols = pattern(grid, device)
    return rows, cols, values(grid, dtype, device, kappa)
