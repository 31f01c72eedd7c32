"""y = A x from triples, in plain PyTorch (float64 or complex128).

Duplicates sum, as assembly sums them: each triple adds its value times
its column's entry of x into its row.  No sort, no format, no kernel of
the port: a gather, a product and an ``index_add_``.
"""

from __future__ import annotations

import torch

BLOCK = 8  # columns of a block x a pass, to bound the (nnz, BLOCK) temporary


def matvec(rows, cols, vals, x: torch.Tensor) -> torch.Tensor:
    """A x for x of shape (n,) or (n, k), in x's precision."""
    vals = vals.to(x.dtype)
    if x.ndim == 1:
        y = torch.zeros_like(x)
        return y.index_add_(0, rows, vals * x[cols])
    y = torch.zeros_like(x)
    for j in range(0, x.shape[1], BLOCK):
        xb = x[:, j:j + BLOCK]
        y[:, j:j + BLOCK].index_add_(0, rows, vals[:, None] * xb[cols])
    return y


def relative_residual(rows, cols, vals, x, b) -> float:
    """||b - A x|| / ||b||, in float64."""
    x = x.to(torch.float64)
    b = b.to(torch.float64)
    r = b - matvec(rows, cols, vals.to(torch.float64), x)
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))
