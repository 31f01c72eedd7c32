"""The port's counterpart of ``__graft_entry__.entry()``: one CG step on the
2D Poisson operator in DIA format, with the matvec through ``DIA.__matmul__``
(the Hopper kernel on CUDA tensors, the plain version on CPU tensors)."""

from __future__ import annotations

import torch

from sparse_linear_tpu_torch.utils.grids import poisson_2d

__all__ = ["entry"]


def _cg_step(a, b):
    """One CG iteration from x = 0; returns (x, ||r_new||)."""
    x = torch.zeros_like(b)
    r = b - a @ x
    p = r
    ap = a @ p
    alpha = torch.dot(r, r) / torch.dot(p, ap)
    x = x + alpha * p
    r_new = r - alpha * ap
    return x, torch.linalg.vector_norm(r_new)


def entry(device, grid: int = 64, dtype=torch.float32):
    """Returns (fn, args): ``fn(*args)`` is one CG step on the ``grid`` x
    ``grid`` Poisson operator (DIA) with b = ones, on ``device``."""
    a = poisson_2d(grid, dtype=dtype, fmt="dia", device=device)
    b = torch.ones((grid * grid,), dtype=dtype, device=device)
    return _cg_step, (a, b)
