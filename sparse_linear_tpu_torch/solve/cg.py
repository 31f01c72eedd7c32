"""Conjugate gradients over the sparse formats.

Counterpart of :mod:`sparse_linear_tpu.solve.cg`.  The JAX package's
``lax.while_loop`` becomes a Python loop; the vectors stay on their device
and are updated in place.  The convergence test reads ||r||^2 on the host
once per iteration, which synchronises with the device each step (a CUDA
graph or a batched check is later work).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from sparse_linear_tpu_torch.dtypes import real_of
from sparse_linear_tpu_torch.utils.profiling import annotate

__all__ = ["cg", "CgResult"]


class CgResult(NamedTuple):
    """Structured solver report."""

    x: torch.Tensor
    iterations: int
    residual_norm: torch.Tensor
    converged: bool


def _inner(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Re(a^H b) as a 0-d tensor on the device."""
    if a.is_complex():
        return torch.vdot(a, b).real
    return torch.dot(a, b)


def cg(
    matvec: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    tol: float = 1e-10,
    maxiter: int = 1000,
    m_inv: Callable | None = None,
) -> CgResult:
    """Preconditioned conjugate gradients for SPD operators.

    ``matvec``: x -> A @ x (any callable closing over a sparse format).
    ``m_inv``: optional preconditioner r -> M^{-1} r.
    Stops at ||r|| <= tol * ||b|| or maxiter.  The whole call is the
    span ``slt.cg``.
    """
    with annotate("slt.cg"):
        x = torch.zeros_like(b) if x0 is None else x0.clone()
        precond = m_inv if m_inv is not None else (lambda r: r)

        r = b - matvec(x)
        z = precond(r)
        p = z.clone()
        gamma = _inner(r, z)
        bnorm = max(float(torch.linalg.vector_norm(b)),
                    torch.finfo(real_of(b.dtype)).tiny)
        atol2 = (tol * bnorm) ** 2

        k = 0
        while k < maxiter and float(_inner(r, r)) > atol2:
            ap = matvec(p)
            alpha = gamma / _inner(p, ap)
            x.addcmul_(alpha, p)
            r.addcmul_(alpha, ap, value=-1)
            z = precond(r)
            gamma_new = _inner(r, z)
            p.mul_(gamma_new / gamma).add_(z)
            gamma = gamma_new
            k += 1
        rnorm = torch.linalg.vector_norm(r)
        return CgResult(x=x, iterations=k, residual_norm=rnorm,
                        converged=bool(rnorm <= tol * bnorm))
