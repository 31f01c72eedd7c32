"""Conjugate gradients over the sparse formats.

Counterpart of :mod:`sparse_linear_tpu.solve.cg`.  The JAX package's
``lax.while_loop`` becomes a Python loop; the vectors stay on their device
and are updated in place.  Two loops, chosen from what the call hands in:

* **Chunked** (``b`` a ``torch.Tensor`` and no ``m_inv``): after the first
  product and r·r, each iteration is the caller's product q = A p and the
  three steps of :mod:`sparse_linear_tpu_torch.kernels.cg_step` (on the
  card three hand-written kernels, on the CPU their plain PyTorch
  versions).  alpha, beta, gamma, the iteration count and the stop test
  live in a state tensor on the device; the host reads nothing while it
  queues a chunk of iterations.  After each chunk it queues a copy of the
  state (to pinned memory, with an event, on the card) and reads chunk j's
  copy only once chunk j+1 is queued, so the card never drains while the
  host decides.  It stops queueing when a copy shows the stop flag, or at
  ``maxiter`` by its own count.  How many iterations a chunk takes is
  derived from the readings (:func:`_chunk`): the rate at which gamma has
  been falling says how many iterations are left, and chunks shrink as the
  target nears, which bounds the products queued after the stop.
* **Per iteration** (a :class:`~sparse_linear_tpu_torch.dist.ShardedVector`
  ``b``, or a preconditioner ``m_inv``): PyTorch's operations an
  iteration, and ||r||² read on the host every iteration.

Stop contract (both loops): stop at the first iteration after which
Re(rᴴr) is not above (tol · max(||b||, tiny))², or at ``maxiter``; an x0
that already meets it takes 0 iterations.  In the chunked loop every step
does nothing once the flag is set, so x, r and ``residual_norm`` are
bitwise the state at the stopping iteration, however many iterations were
queued after it; their products still run, and their results are never
read.  On the CPU the chunked loop is bitwise the per-iteration loop.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Callable, NamedTuple

import torch

from sparse_linear_tpu_torch.dtypes import real_of
from sparse_linear_tpu_torch.kernels import cg_step
from sparse_linear_tpu_torch.kernels.cg_step import inner
from sparse_linear_tpu_torch.utils.profiling import annotate

__all__ = ["cg", "CgResult"]


class CgResult(NamedTuple):
    """Structured solver report.  ``host_reads``: the host's reads of
    device state in the call; ``launched``: the iterations queued, at
    least ``iterations``."""

    x: torch.Tensor
    iterations: int
    residual_norm: torch.Tensor
    converged: bool
    host_reads: int = 0
    launched: int = 0


# chunk sizes, in iterations: before any reading, and the bounds after
_FIRST, _MIN, _MAX = 8, 2, 64
# a chunk takes this share of the iterations estimated to remain beyond
# those already queued
_SHARE = 0.25


def _chunk(readings, launched: int, target: float) -> int:
    """Iterations to queue in the next chunk, from ``readings``, the
    (iteration, gamma) pairs read so far (the first at iteration 0), with
    ``launched`` iterations queued.  The rate at which log gamma falls,
    over the later half of the iterations read, estimates how many remain
    to the target."""
    if len(readings) < 2:
        return _FIRST
    i, g = readings[-1]
    a, ga = next(((j, h) for j, h in readings[:-1] if 2 * j >= i),
                 readings[-2])
    if not (g > 0 and ga > 0 and target > 0 and i > a):
        return _MAX
    rate = (math.log(ga) - math.log(g)) / (i - a)
    if rate <= 0:
        return _MAX
    left = math.log(g / target) / rate - (launched - i)
    return int(min(_MAX, max(_MIN, _SHARE * left)))


def _bound(b: torch.Tensor, tol: float) -> torch.Tensor:
    """tol · max(||b||, tiny) as a float64 0-d tensor on b's device."""
    tiny = torch.finfo(real_of(b.dtype)).tiny
    return tol * torch.linalg.vector_norm(b).to(torch.float64).clamp_min(
        tiny)


class _Copy:
    """A copy of the state's scalars queued behind the work before it:
    to pinned memory with an event on the card, a clone on the CPU."""

    def __init__(self, state: torch.Tensor):
        scalars = state[:cg_step.SLOTS]
        self.event = None
        if state.is_cuda:
            self.host = torch.empty(scalars.shape, dtype=scalars.dtype,
                                    pin_memory=True)
            self.host.copy_(scalars, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = scalars.clone()

    def read(self) -> list:
        if self.event is not None:
            self.event.synchronize()
        return self.host.tolist()


def _chunked(matvec, b, x, tol, maxiter):
    r = b - matvec(x)
    p = r.clone()
    bound = _bound(b, tol)
    state = cg_step.cg_state(r, bound ** 2)
    target = 0.0
    readings = []
    pending = deque()
    launched = reads = 0
    while launched < maxiter:
        k = min(_chunk(readings, launched, target), maxiter - launched)
        for _ in range(k):
            q = matvec(p)
            cg_step.cg_pq(p, q, state)
            cg_step.cg_update(x, r, p, q, state)
            cg_step.cg_direction(p, r, state)
        launched += k
        pending.append(_Copy(state))
        if len(pending) < 2:
            continue
        seen = pending.popleft().read()
        reads += 1
        if seen[cg_step.STOP]:
            break
        if not readings:
            readings.append((0, seen[cg_step.GAMMA0]))
            target = seen[cg_step.TARGET]
        readings.append((int(seen[cg_step.ITER]), seen[cg_step.GAMMA]))
    rnorm = torch.linalg.vector_norm(r)
    converged = rnorm <= bound.to(rnorm.dtype)
    its, conv = torch.stack([state[cg_step.ITER],
                             converged.to(torch.float64)]).tolist()
    return CgResult(x=x, iterations=int(its), residual_norm=rnorm,
                    converged=bool(conv), host_reads=reads + 1,
                    launched=launched)


def _per_iteration(matvec, b, x, tol, maxiter, m_inv):
    precond = m_inv if m_inv is not None else (lambda r: r)
    r = b - matvec(x)
    z = precond(r)
    p = z.clone()
    gamma = inner(r, z)
    bnorm = max(float(torch.linalg.vector_norm(b)),
                torch.finfo(real_of(b.dtype)).tiny)
    atol2 = (tol * bnorm) ** 2
    reads = 1

    k = 0
    while k < maxiter:
        reads += 1
        if not float(inner(r, r)) > atol2:
            break
        ap = matvec(p)
        alpha = gamma / inner(p, ap)
        x.addcmul_(alpha, p)
        r.addcmul_(alpha, ap, value=-1)
        z = precond(r)
        gamma_new = inner(r, z)
        p.mul_(gamma_new / gamma).add_(z)
        gamma = gamma_new
        k += 1
    rnorm = torch.linalg.vector_norm(r)
    return CgResult(x=x, iterations=k, residual_norm=rnorm,
                    converged=bool(rnorm <= tol * bnorm),
                    host_reads=reads + 1, launched=k)


def cg(
    matvec: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    tol: float = 1e-10,
    maxiter: int = 1000,
    m_inv: Callable | None = None,
) -> CgResult:
    """Preconditioned conjugate gradients for SPD (Hermitian positive
    definite) operators.

    ``matvec``: x -> A @ x (any callable closing over a sparse format).
    ``m_inv``: optional preconditioner r -> M^{-1} r.
    Stops at ||r|| <= tol * ||b|| or maxiter (the module docstring gives
    the two loops and the stop contract).  The whole call is the span
    ``slt.cg``.
    """
    with annotate("slt.cg"):
        x = torch.zeros_like(b) if x0 is None else x0.clone()
        if isinstance(b, torch.Tensor) and m_inv is None:
            return _chunked(matvec, b, x, tol, maxiter)
        return _per_iteration(matvec, b, x, tol, maxiter, m_inv)
