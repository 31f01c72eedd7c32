"""Staged direct-solver API: analyze -> factor -> solve.

Counterpart of :mod:`sparse_linear_tpu.solve.api`, the capability of the
reference's UMFPACK layer (reference:
suitesparse/src/Numeric/LinearAlgebra/Umfpack.hs):

* ``analyze``  (:60-69)  — symbolic analysis, reusable across all numeric
  factorizations with the same pattern.
* ``factor``   (:71-83)  — numeric factorization into a reusable artifact.
* ``solve``    (:85-102) — triangular solves; ``trans`` selects A x = b
  (sys=0), A^H x = b (sys=1), or the plain transpose A^T x = b
  (``trans="T"``, UMFPACK sys=2).
* ``linear_solve`` / ``solve_many`` (:38-46) as the one-shot path, batched
  over RHS.

Backends:
  * ``dense``        — pivoted dense LU (``torch.linalg.lu_factor`` /
    ``lu_solve``).  torch's pivots are LAPACK's 1-based swaps; where the
    JAX package reads 0-based ``piv`` the port subtracts one.
  * ``multifrontal`` — supernodal multifrontal sparse LU / Cholesky
    (``solve/multifrontal.py``) on the matrix's device.

Status is reported as a structured ``SolveInfo``.  Residuals in
``solve_refined`` / ``solve_gmres`` / ``residual_norm`` go through the
port's own CSR ``ops.linalg.spmv`` / ``spmm``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from sparse_linear_tpu_torch.dtypes import real_of
from sparse_linear_tpu_torch.formats.matrix import from_triples
from sparse_linear_tpu_torch.ops.build import trim
from sparse_linear_tpu_torch.ops.linalg import spmm, spmv

__all__ = [
    "analyze",
    "factor",
    "solve",
    "solve_many",
    "solve_part",
    "SOLVE_PART_SYS",
    "solve_refined",
    "factor_batched",
    "factor_batched_steps",
    "solve_batched",
    "solve_batched_steps",
    "linear_solve",
    "slogdet",
    "det",
    "rcond",
    "get_factors",
    "lunz",
    "condest",
    "solve_gmres",
    "residual_norm",
    "SolveInfo",
    "Symbolic",
    "Factors",
]


def _trans_mode(trans) -> str:
    """Normalize a ``trans`` argument to one of "N"/"H"/"T": False/None =
    A x = b, True = A^H x = b, and the string spellings.  For real data "T"
    and "H" coincide."""
    if trans is False or trans is None:
        return "N"
    if trans is True:
        return "H"
    mode = str(trans).upper()
    if mode in ("N", "H", "T"):
        return mode
    raise ValueError(
        f"trans must be False/'N', True/'H', or 'T', got {trans!r}"
    )


class SolveInfo(NamedTuple):
    residual_norm: torch.Tensor
    refinement_steps: int
    tol: float = float("nan")

    @property
    def converged(self) -> bool:
        """True when the refined RELATIVE residual is finite and met the
        requested tolerance (NaN/inf or a large residual means the
        factorization broke down or the refinement stalled)."""
        v = float(self.residual_norm)
        gate = self.tol if np.isfinite(self.tol) else 1e-6
        return bool(np.isfinite(v) and v <= gate)


@dataclasses.dataclass(frozen=True)
class Symbolic:
    """Reusable symbolic-analysis artifact of the dense backend (reference
    ``Analysis``, Umfpack.hs:56,60-69)."""

    n: int
    backend: str
    meta: object = None


@dataclasses.dataclass(frozen=True, eq=False)
class Factors:
    """Numeric factorization artifact of the dense backend (reference
    ``Factors``, Umfpack.hs:58,71-83): ``payload`` is (lu, pivots), the
    pivots torch's 1-based ones; ``batch`` the value-set count of
    ``factor_batched``."""

    payload: object
    n: int
    backend: str
    batch: int | None = None


def _device_of(factors) -> torch.device:
    if factors.backend == "dense":
        return factors.payload[0].device
    return factors.device


def _as_tensor(x, device):
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device)


def _lapack_piv(piv) -> np.ndarray:
    """torch's 1-based LAPACK pivots as the 0-based ones the JAX package
    reads."""
    return piv.cpu().numpy().astype(np.int64) - 1


def _row_order(piv0: np.ndarray) -> np.ndarray:
    """LAPACK ipiv (0-based sequential swaps) -> row order rp with
    A[rp] = L U."""
    rp = np.arange(piv0.shape[-1])
    for i, pi in enumerate(piv0):
        rp[[i, pi]] = rp[[pi, i]]
    return rp


def analyze(mat, backend: str = "dense", **opts):
    """Symbolic analysis of the pattern (reference ``analyze``,
    Umfpack.hs:60-69).  ``opts`` pass through to the backend (multifrontal:
    ordering=..., dims=..., relax_small=..., relax_frac=..., perm=...,
    engine=...)."""
    nr, nc = mat.shape
    if nr != nc:
        raise ValueError(f"analyze: matrix must be square, got {mat.shape}")
    if backend == "dense":
        return Symbolic(n=nr, backend="dense")
    if backend == "multifrontal":
        from sparse_linear_tpu_torch.solve import multifrontal

        return multifrontal.analyze(mat, **opts)
    raise ValueError(f"unknown backend: {backend}")


_FACTOR_OPTS = ("mesh", "batch_axis", "pivot_eps", "scale")


def factor(mat, symbolic=None, backend: str = "dense", kind: str = "lu",
           **opts):
    """Numeric factorization (reference ``factor``, Umfpack.hs:71-83), on
    the matrix's device.

    ``kind`` (multifrontal backend): "lu" for general matrices or
    "cholesky" for SPD ones.  ``scale`` (multifrontal backend): "sum"/"max"
    equilibration; dense LAPACK LU pivots fully and takes no scale
    option."""
    if symbolic is None:
        symbolic = analyze(mat, backend=backend,
                           **{k: v for k, v in opts.items()
                              if k not in _FACTOR_OPTS})
    if symbolic.backend == "dense":
        if opts.get("scale", "none") != "none":
            raise ValueError(
                "scale= equilibration is a multifrontal-backend option "
                "(dense LAPACK LU pivots fully)"
            )
        lu, piv = torch.linalg.lu_factor(mat.todense())
        return Factors(payload=(lu, piv), n=symbolic.n, backend="dense")
    if symbolic.backend == "multifrontal":
        from sparse_linear_tpu_torch.solve import multifrontal

        return multifrontal.factor(
            mat, symbolic, kind=kind,
            **{k: v for k, v in opts.items() if k in _FACTOR_OPTS},
        )
    raise ValueError(f"unknown backend: {symbolic.backend}")


def _dense_solve(lu, piv, b, adjoint: bool):
    dt = torch.promote_types(lu.dtype, b.dtype)
    vec = b.ndim == lu.ndim - 1
    x = torch.linalg.lu_solve(lu.to(dt), piv,
                              (b[..., None] if vec else b).to(dt),
                              adjoint=adjoint)
    return x[..., 0] if vec else x


def solve(factors, b, trans=False):
    """Triangular solves on an existing factorization (reference
    ``linearSolve_``, Umfpack.hs:85-102).  ``trans=True`` (or "H") solves
    A^H x = b; ``trans="T"`` solves the plain transpose A^T x = b.  All
    modes reuse the same factorization."""
    b = _as_tensor(b, _device_of(factors))
    mode = _trans_mode(trans)
    if mode == "T":
        # A^T x = b  <=>  A^H conj(x) = conj(b): one conjugated H-solve
        return torch.conj(solve(factors, torch.conj(b), trans="H")
                          ).resolve_conj()
    do_h = mode == "H"
    if factors.backend == "dense":
        lu, piv = factors.payload
        return _dense_solve(lu, piv, b, do_h)
    if factors.backend == "multifrontal":
        from sparse_linear_tpu_torch.solve import multifrontal

        return multifrontal.solve(factors, b, trans=do_h)
    raise ValueError(f"unknown backend: {factors.backend}")


def solve_many(factors, bs, trans=False):
    """Batched multi-RHS solve: ``bs`` of shape (n, k), one pass."""
    return solve(factors, bs, trans=trans)


SOLVE_PART_SYS = ("Pt_L", "L", "Lt_P", "Lat_P", "Lt", "Lat",
                  "U_Qt", "U", "Ut_Q", "Uat_Q", "Ut", "Uat")


def solve_part(factors, b, sys: str):
    """Partial solves with the stored factors — UMFPACK's sys codes
    UMFPACK_Pt_L .. UMFPACK_Uat (umfpack.h), spelled without the prefix and
    defined over ``get_factors``'s exported (L, U, row_perm, col_perm):
    e.g. ``sys="Pt_L"`` solves P^T L x = b, ``sys="U_Qt"`` U Q^T x = b;
    ``t`` = conjugate transpose, ``at`` = plain transpose.  Like UMFPACK,
    the factors are used AS STORED (no equilibration scaling)."""
    if sys not in SOLVE_PART_SYS:
        raise ValueError(
            f"solve_part: unknown sys {sys!r} (expected one of "
            f"{SOLVE_PART_SYS})")
    if factors.backend == "multifrontal":
        from sparse_linear_tpu_torch.solve import multifrontal

        return multifrontal.solve_part(factors, b, sys)
    if factors.backend != "dense":
        raise ValueError(f"unknown backend: {factors.backend}")
    b = _as_tensor(b, _device_of(factors))
    if sys in ("Lat", "Lat_P", "Uat", "Uat_Q"):
        x = solve_part(factors, torch.conj(b),
                       {"Lat": "Lt", "Lat_P": "Lt_P", "Uat": "Ut",
                        "Uat_Q": "Ut_Q"}[sys])
        return torch.conj(x).resolve_conj()
    lu, piv = factors.payload
    if factors.batch is not None:
        raise ValueError("solve_part: batched factors are not supported — "
                         "index one value-set out first")
    if b.shape[0] != lu.shape[-1]:
        raise ValueError(
            f"solve_part: rhs has {b.shape[0]} rows, expected {lu.shape[-1]}")
    rp = _row_order(_lapack_piv(piv))
    irp = np.empty_like(rp)
    irp[rp] = np.arange(rp.shape[0])
    dt = torch.promote_types(lu.dtype, b.dtype)
    lu = lu.to(dt)
    vec = b.ndim == 1
    b = (b[:, None] if vec else b).to(dt)

    def tri(a, rhs, upper, unit=False):
        return torch.linalg.solve_triangular(a, rhs, upper=upper,
                                             unitriangular=unit)

    def rows(order):
        return torch.as_tensor(order, device=b.device)

    if sys == "Pt_L":
        x = tri(lu, b[rows(rp)], upper=False, unit=True)
    elif sys == "L":
        x = tri(lu, b, upper=False, unit=True)
    elif sys == "Lt":
        x = tri(lu.mH, b, upper=True, unit=True)
    elif sys == "Lt_P":
        x = tri(lu.mH, b, upper=True, unit=True)[rows(irp)]
    elif sys in ("U", "U_Qt"):       # col_perm is identity for dense LU
        x = tri(lu, b, upper=True)
    else:                            # "Ut" / "Ut_Q" (col_perm identity)
        x = tri(lu.mH, b, upper=False)
    return x[:, 0] if vec else x


def factor_batched(pattern_mat, data_stack, symbolic, kind: str = "lu",
                   scale: str = "none"):
    """Batched numeric factorization of many value-sets over one pattern
    (contour parallelism).  ``data_stack``: (ne, nnz) values in the
    canonical entry order of ``pattern_mat``, on the pattern's device.
    ``kind`` and ``scale`` apply on the multifrontal backend."""
    from sparse_linear_tpu_torch.solve.multifrontal import _drain

    return _drain(factor_batched_steps(pattern_mat, data_stack, symbolic,
                                       kind, scale))


def factor_batched_steps(pattern_mat, data_stack, symbolic,
                         kind: str = "lu", scale: str = "none"):
    """:func:`factor_batched` as a stepper: a generator that returns the
    factors and, on the multifrontal backend, yields after each bucket's
    launches (``multifrontal.factor_batched_steps``); the dense backend's
    one LU takes no step."""
    m = trim(pattern_mat.tocsr())
    data_stack = _as_tensor(data_stack, m.data.device)
    if symbolic.backend == "dense":
        if scale != "none":
            raise ValueError(
                "scale= equilibration is a multifrontal-backend option "
                "(dense LAPACK LU pivots fully)"
            )
        n = symbolic.n
        ne = data_stack.shape[0]
        flat = m.row_ids().to(torch.int64) * n + m.indices.to(torch.int64)
        dense = torch.zeros((ne, n * n), dtype=data_stack.dtype,
                            device=data_stack.device)
        dense.index_add_(1, flat, data_stack)
        lu, piv = torch.linalg.lu_factor(dense.view(ne, n, n))
        return Factors(payload=(lu, piv), n=n, backend="dense", batch=ne)
    if symbolic.backend == "multifrontal":
        from sparse_linear_tpu_torch.solve import multifrontal

        return (yield from multifrontal.factor_batched_steps(
            data_stack, symbolic, kind=kind, scale=scale))
    raise ValueError(f"unknown backend: {symbolic.backend}")


def solve_batched(factors, b_stack, trans=False):
    """Solves on batched factors: (ne, n, k) -> (ne, n, k)."""
    from sparse_linear_tpu_torch.solve.multifrontal import _drain

    return _drain(solve_batched_steps(factors, b_stack, trans))


def solve_batched_steps(factors, b_stack, trans=False):
    """:func:`solve_batched` as a stepper, as :func:`factor_batched_steps`:
    it returns x, and yields after each bucket's launches of each pass on
    the multifrontal backend."""
    b_stack = _as_tensor(b_stack, _device_of(factors))
    mode = _trans_mode(trans)
    if mode == "T":
        x = yield from solve_batched_steps(factors, torch.conj(b_stack),
                                           trans="H")
        return torch.conj(x).resolve_conj()
    do_h = mode == "H"
    if factors.backend == "dense":
        lu, piv = factors.payload
        return _dense_solve(lu, piv, b_stack, do_h)
    if factors.backend == "multifrontal":
        from sparse_linear_tpu_torch.solve import multifrontal

        return (yield from multifrontal.solve_batched_steps(
            factors, b_stack, trans=do_h))
    raise ValueError(f"unknown backend: {factors.backend}")


def linear_solve(mat, bs, backend: str = "dense", trans=False, **opts):
    """One-shot: factor once, solve all RHS (reference ``linearSolve``,
    Umfpack.hs:38-46 and ``<\\>`` :48-50)."""
    f = factor(mat, backend=backend, **opts)
    return solve_many(f, bs, trans=trans)


def _op_and_trans(mat, trans):
    """Residual operator + factor-solve trans flag for a requested mode."""
    mode = _trans_mode(trans)
    op = {"N": lambda: mat,
          "H": lambda: mat.ctrans().tocsr(),
          "T": lambda: mat.T.tocsr()}[mode]()
    return op, {"N": False, "H": True, "T": "T"}[mode]


def _norm(x) -> torch.Tensor:
    return torch.linalg.vector_norm(x)


def solve_refined(factors, mat, b, trans=False, tol: float = 1e-10,
                  max_iter: int = 20, residual_dtype=torch.float64):
    """Mixed-precision iterative refinement (Wilkinson): solve with the
    (possibly low-precision) factors, then correct with residuals computed
    in ``residual_dtype`` through the port's CSR SpMV.  f32 factors with
    f64 residuals recover ~f64 backward error whenever kappa(A) * eps_f32
    < 1.  Returns (x, SolveInfo)."""
    b = _as_tensor(b, _device_of(factors))
    op, trans = _op_and_trans(mat, trans)
    hi = torch.promote_types(residual_dtype, b.dtype)
    b_hi = b.to(hi)
    bnorm = torch.clamp_min(_norm(b_hi), torch.finfo(real_of(hi)).tiny)
    x = solve(factors, b, trans=trans).to(hi)
    steps = 0
    rnorm = torch.tensor(float("inf"))
    for it in range(max_iter):
        ax = spmm(op, x) if x.ndim == 2 else spmv(op, x)
        r = b_hi - ax
        rnorm = _norm(r) / bnorm
        steps = it
        if float(rnorm) <= tol:
            break
        dx = solve(factors, r.to(b.dtype), trans=trans)
        x = x + dx.to(hi)
    return x, SolveInfo(residual_norm=rnorm, refinement_steps=steps,
                        tol=float(tol))


def solve_gmres(factors, mat, b, trans=False, tol: float = 1e-10,
                restart: int = 30, max_outer: int = 10,
                residual_dtype=torch.float64):
    """Right-preconditioned (F)GMRES with the factorization as the
    preconditioner — the fallback when stationary refinement stalls
    (statically perturbed pivots on indefinite systems).  Each inner step
    costs one factor solve + one SpMV in ``residual_dtype``; the Arnoldi
    least-squares problem is solved on the host in f64.  Returns
    (x, SolveInfo)."""
    b = _as_tensor(b, _device_of(factors))
    if b.ndim != 1:
        raise ValueError("solve_gmres: expected a single RHS (n,); loop "
                         "columns or use solve_refined for blocks")
    op, trans = _op_and_trans(mat, trans)
    hi = torch.promote_types(residual_dtype, b.dtype)
    b_hi = b.to(hi)
    bnorm = float(_norm(b_hi))
    if bnorm == 0.0:
        return torch.zeros_like(b_hi), SolveInfo(
            residual_norm=torch.zeros((), dtype=real_of(hi)),
            refinement_steps=0, tol=float(tol))
    cplx = hi.is_complex
    hdt = np.complex128 if cplx else np.float64

    def psolve(v):
        return solve(factors, v.to(b.dtype), trans=trans).to(hi)

    x = psolve(b_hi)
    steps = 0
    for _ in range(max_outer):
        r = b_hi - spmv(op, x)
        beta = float(_norm(r))
        if beta / bnorm <= tol:
            break
        v = [r / beta]
        z = []
        h = np.zeros((restart + 1, restart), dtype=hdt)
        j_used = 0
        for j in range(restart):
            zj = psolve(v[j])
            z.append(zj)
            w = spmv(op, zj)
            for i in range(j + 1):
                hij = torch.vdot(v[i], w).item()
                h[i, j] = hij
                w = w - hij * v[i]
            hlast = float(_norm(w))
            h[j + 1, j] = hlast
            j_used = j + 1
            steps += 1
            # small-residual estimate via the Arnoldi least-squares problem
            e1 = np.zeros(j_used + 1, dtype=hdt)
            e1[0] = beta
            y, *_ = np.linalg.lstsq(h[: j_used + 1, :j_used], e1, rcond=None)
            est = float(np.linalg.norm(e1 - h[: j_used + 1, :j_used] @ y))
            if est / bnorm <= tol or hlast == 0.0:
                break
            v.append(w / hlast)
        e1 = np.zeros(j_used + 1, dtype=hdt)
        e1[0] = beta
        y, *_ = np.linalg.lstsq(h[: j_used + 1, :j_used], e1, rcond=None)
        for i in range(j_used):
            x = x + y[i].item() * z[i]
    rnorm = float(_norm(b_hi - spmv(op, x))) / bnorm
    return x, SolveInfo(residual_norm=torch.tensor(rnorm),
                        refinement_steps=steps, tol=float(tol))


def slogdet(factors):
    """(sign, logabsdet) of the factored operator, from its LU/Cholesky
    pivots — UMFPACK's ``umfpack_*_get_determinant`` capability.  Host-side
    query; batched factors return (ne,) arrays."""
    if factors.backend == "dense":
        lu, piv = factors.payload
        d = torch.diagonal(lu, dim1=-2, dim2=-1).resolve_conj().cpu().numpy()
        piv0 = _lapack_piv(piv)
        with np.errstate(invalid="ignore", divide="ignore"):
            logabs = np.sum(np.log(np.abs(d)), axis=-1)
            unit = np.where(d == 0, 1.0, d / np.abs(d))
        sign = np.prod(unit, axis=-1)
        # LAPACK ipiv: row i was swapped with piv[i]; each non-fixed entry
        # is one executed transposition
        swaps = np.sum(piv0 != np.arange(piv0.shape[-1]), axis=-1)
        sign = sign * np.where(swaps % 2, -1.0, 1.0)
        # numpy slogdet convention: singular -> sign 0 (complex included)
        sign = np.where(logabs == -np.inf, 0.0 * sign, sign)
        return sign, logabs
    if factors.backend == "multifrontal":
        from sparse_linear_tpu_torch.solve import multifrontal

        return multifrontal.slogdet(factors)
    raise ValueError(f"unknown backend: {factors.backend}")


def det(factors):
    """Determinant of the factored operator (overflow-prone at scale — use
    ``slogdet`` for large n)."""
    sign, logabs = slogdet(factors)
    with np.errstate(over="ignore", invalid="ignore"):
        return sign * np.exp(logabs)


def rcond(factors):
    """Cheap reciprocal-condition estimate min|U_ii| / max|U_ii| — the
    ``Info[UMFPACK_RCOND]`` statistic.  0 means numerically singular."""
    if factors.backend == "dense":
        lu, _ = factors.payload
        d = np.abs(torch.diagonal(lu, dim1=-2, dim2=-1).cpu().numpy())
        dmax = d.max(axis=-1)
        return np.where(
            dmax > 0,
            d.min(axis=-1) / np.maximum(dmax, np.finfo(np.float64).tiny),
            0.0,
        )
    if factors.backend == "multifrontal":
        from sparse_linear_tpu_torch.solve import multifrontal

        return multifrontal.rcond(factors)
    raise ValueError(f"unknown backend: {factors.backend}")


def condest(factors, mat, itmax: int = 5):
    """1-norm condition estimate kappa_1(A) ~= ||A||_1 * est(||A^-1||_1)
    via the Hager-Higham power method on the factor solves (the LAPACK
    ``gecon``-class diagnostic).  Each iteration costs one solve with A and
    one with A^H.  The estimate is a lower bound on kappa_1."""
    if factors.batch is not None:
        raise ValueError(
            "condest: batched factors are not supported — estimate each "
            "value-set on its own (unbatched) factorization"
        )
    n = factors.n
    csr = trim(mat.tocsr())
    colsums = torch.zeros(n, dtype=real_of(csr.dtype), device=csr.data.device)
    colsums.index_add_(0, csr.indices.to(torch.int64), torch.abs(csr.data))
    anorm = float(colsums.max()) if n else 0.0

    dt = csr.dtype
    device = _device_of(factors)
    x = torch.full((n,), 1.0 / n, dtype=dt, device=device)
    est = 0.0
    prev_j = -1
    for _ in range(max(1, itmax)):
        y = solve(factors, x)
        # ||x||_1 == 1 throughout, so est = ||A^-1 x||_1 is always a valid
        # lower bound on ||A^-1||_1 — the loop only sharpens it
        est = max(est, float(torch.sum(torch.abs(y))))
        absy = torch.abs(y)
        xi = torch.where(absy == 0, 1.0,
                         y / torch.where(absy == 0, 1.0, absy))
        z = solve(factors, xi.to(dt), trans="H").cpu().numpy()
        zabs = np.abs(z)
        j = int(np.argmax(zabs))
        if (zabs[j] <= float(np.real(np.vdot(z, x.cpu().numpy())))
                or j == prev_j):
            break
        prev_j = j
        x = torch.zeros((n,), dtype=dt, device=device)
        x[j] = 1.0
    return anorm * est


def get_factors(factors, index: int | None = None):
    """Export the triangular factors as sparse matrices — UMFPACK's
    ``umfpack_*_get_numeric`` capability.  Returns ``(L, U, row_perm,
    col_perm)`` with L unit-lower / U upper CSR (Cholesky: L non-unit,
    U = L^H) on the factors' device, satisfying

        (L @ U).todense() == A.todense()[np.ix_(row_perm, col_perm)]

    ``index`` selects one value-set of a batched artifact."""
    if factors.backend == "dense":
        lu, piv = factors.payload
        ne = factors.batch
        if ne is not None and index is None:
            raise ValueError(
                f"get_factors: batched factors — pass index in [0, {ne})"
            )
        if ne is not None:
            lu, piv = lu[index], piv[index]
        n = lu.shape[-1]
        eye = torch.eye(n, dtype=lu.dtype, device=lu.device)

        def to_csr(d):
            r, c = torch.nonzero(d, as_tuple=True)
            return from_triples((n, n), r, c, d[r, c]).tocsr()

        return (to_csr(torch.tril(lu, -1) + eye), to_csr(torch.triu(lu)),
                _row_order(_lapack_piv(piv)), np.arange(n))
    if factors.backend == "multifrontal":
        from sparse_linear_tpu_torch.solve import multifrontal

        return multifrontal.get_factors(factors, index=index)
    raise ValueError(f"unknown backend: {factors.backend}")


def lunz(factors, index: int | None = None):
    """(lnz, unz): stored entries of the exported L and U — UMFPACK's
    ``umfpack_*_get_lunz``."""
    L, U, _, _ = get_factors(factors, index=index)
    return int(L.nnz), int(U.nnz)


def residual_norm(mat, x, b, trans=False):
    """||Ax - b|| / ||b|| (or A^H / A^T per ``trans``), for SolveInfo
    reporting."""
    mode = _trans_mode(trans)
    op = {"N": lambda: mat,
          "H": lambda: mat.ctrans(),
          "T": lambda: mat.T.tocsr()}[mode]()
    x = _as_tensor(x, mat.data.device)
    b = _as_tensor(b, mat.data.device)
    ax = spmm(op, x) if x.ndim == 2 else spmv(op, x)
    return _norm(ax - b) / torch.clamp_min(_norm(b),
                                           torch.finfo(real_of(b.dtype)).tiny)
