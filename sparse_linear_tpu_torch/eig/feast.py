"""FEAST contour-integral interval eigensolver on the card.

Counterpart of :mod:`sparse_linear_tpu.eig.feast`, which replaces the
reference's binding to the FEAST Fortran library (reference:
feast/src/Numeric/LinearAlgebra/Feast.hs:115-240, Feast/Internal.hs:24-79)
with a loop owned natively: quadrature nodes and weights computed directly,
one factorization of z_k B - A per contour node reused across refinement
loops, multi-RHS solves, a dense m0 x m0 Rayleigh-Ritz problem, plain
convergence code.

The public surface is the JAX package's: ``FeastParams``, ``EigResult``,
the ``INFO_*`` codes, ``geigsh``/``eigsh`` with the warm start through
``guess``, ``count_eigenvalues`` and ``geigsh_sliced``/``eigsh_sliced``.
Every solve runs through :mod:`.pipeline`: native complex contour factors
(complex128, or complex64 for f32 input), the conjugate-eliminated lower
contour for real pencils, and Rayleigh-Ritz in plain f64/c128 matmuls.  The
JAX package's real 2n embedding, its host pinning of complex pencils and
its ``dot64`` products work around TPU limits and are not ported
(``complex_strategy="embedded"`` raises).

Entry points run where the matrices live: on the card for matrices built
there (``dtypes.default_device()``), on the CPU only for CPU matrices.
Values and residuals come back as numpy arrays, ``vectors`` and
``subspace`` as tensors on that device; ``subspace`` feeds back into
``guess=`` as a tensor or a numpy array.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from sparse_linear_tpu_torch.dtypes import real_of
from sparse_linear_tpu_torch.formats.matrix import eye

__all__ = ["FeastParams", "EigResult", "eigsh", "geigsh",
           "count_eigenvalues", "eigsh_sliced", "geigsh_sliced", "INFO_OK",
           "INFO_NO_EIGENVALUES", "INFO_NOT_CONVERGED",
           "INFO_SUBSPACE_TOO_SMALL"]

INFO_OK = 0
INFO_NO_EIGENVALUES = 1
INFO_NOT_CONVERGED = 2
INFO_SUBSPACE_TOO_SMALL = 3


@dataclasses.dataclass(frozen=True)
class FeastParams:
    """Solver configuration (reference ``FeastParams`` + fpm array,
    Feast.hs:76-89, Feast/Internal.hs:73-79).

    contour_points: quadrature nodes on the upper semicircle (fpm[1]; the
        reference default is 8).
    tol: convergence tolerance on the max in-interval residual.
    max_loops: refinement-loop cap.
    debug: per-loop convergence printing (fpm[0]).
    backend: direct-solver backend for the shifted systems ("dense" or
        "multifrontal").
    dims: grid dims for the multifrontal nested-dissection ordering.
    complex_strategy: "native" or "auto" (both native complex factors);
        "embedded" raises.
    contour_batching: "vmap" factors and solves all nodes in one batched
        call, "loop" node by node with every node's factors resident,
        "auto" chooses by bytes (and streams one node at a time when even
        "loop" does not fit).
    refine_solves: refinement steps per contour solve; None = 0 on
        complex128 factors, 2 on complex64 ones.
    check_hermitian: check that A and B are Hermitian first.
    seed: seed of the random start and of the refill of dropped columns.
    quadrature: FEAST fpm(16): "gauss" or "trapezoid".
    """

    contour_points: int = 8
    tol: float = 1e-12
    max_loops: int = 20
    debug: bool = False
    backend: str = "dense"
    dims: tuple | None = None
    complex_strategy: str = "auto"
    contour_batching: str = "auto"
    refine_solves: int | None = None
    check_hermitian: bool = True
    seed: int = 0
    quadrature: str = "gauss"


class EigResult(NamedTuple):
    """Structured output (keeps epsout/loop/res instead of discarding them
    like the reference's loop, Feast.hs:140-155).  ``vectors`` and
    ``subspace`` are tensors on the matrices' device."""

    values: np.ndarray       # (m,) eigenvalues found inside the interval
    vectors: object          # (n, m) B-orthonormal eigenvectors
    n_found: int
    iterations: int
    epsout: float            # reached max residual (FEAST's epsout)
    residuals: np.ndarray    # (m,) per-pair relative residuals
    info: int                # INFO_* code (reference decode, Feast.hs:246-258)
    subspace: object         # (n, m0) final subspace for warm restart


_HERMITIAN_CACHE: dict = {}
_HERMITIAN_CACHE_MAX = 64


def _check_hermitian(mat, name, where="geigsh"):
    """Reference precondition (Feast.hs:129-130): ctrans m == m, compared
    in O(nnz) on the canonical CSR.  The verdict is cached per value
    fingerprint: warm restarts and interval sweeps re-solve one pencil."""
    from sparse_linear_tpu_torch.eig.pipeline import _fingerprint

    key = _fingerprint(mat)
    ok = _HERMITIAN_CACHE.get(key)
    if ok is None:
        csr = mat.tocsr()
        scale = float(torch.abs(csr.data[:csr.nnz]).max()) if csr.nnz else 1.0
        ok = bool(csr.is_hermitian(tol=1e-12 * max(1.0, scale)))
        if len(_HERMITIAN_CACHE) >= _HERMITIAN_CACHE_MAX:
            _HERMITIAN_CACHE.pop(next(iter(_HERMITIAN_CACHE)))
        _HERMITIAN_CACHE[key] = ok
    if not ok:
        raise ValueError(f"{where}: matrix {name} is not hermitian")


def _contour(emin, emax, ne, kind: str = "gauss"):
    """Quadrature nodes/weights on the upper semicircle: "gauss" (FEAST
    fpm(16)=0) or "trapezoid" (fpm(16)=1, midpoint angles).

    The projector P = (1/2pi) Int_0^{2pi} r e^{i t} (z(t)B - A)^{-1} B dt
    with z(t) = c + r e^{i t}.  For a Hermitian pencil the lower semicircle
    integrand is the conjugate-transpose solve on the same factors, so only
    upper-half nodes are materialized."""
    c = 0.5 * (emin + emax)
    r = 0.5 * (emax - emin)
    if kind == "trapezoid":
        theta = np.pi * (np.arange(ne) + 0.5) / ne
        z = c + r * np.exp(1j * theta)
        sigma = r * np.exp(1j * theta) / (2.0 * ne)
        return z, sigma
    if kind != "gauss":
        raise ValueError(
            f"unknown quadrature: {kind!r} (expected 'gauss' or 'trapezoid')"
        )
    x, w = np.polynomial.legendre.leggauss(ne)
    theta = 0.5 * np.pi * (x + 1.0)  # (0, pi)
    z = c + r * np.exp(1j * theta)
    # weight for each node: w_k * (pi/2) / (2 pi) * r e^{i theta_k}
    sigma = w * (np.pi / 2.0) / (2.0 * np.pi) * r * np.exp(1j * theta)
    return z, sigma


def _union_shift_stack(mat_a, mat_b):
    """Union-pattern pencil matrices and the shifted values over them.

    One symbolic analysis serves every contour node (Feast.hs:210-218), so
    A and B are rewritten onto their union pattern (``lin`` with 0/1
    coefficients; an entry whose fold is zero stays in the pattern) and
    the node values are z_k * B - A over that shared entry order.  Returns
    (union_b, union_a, stack) with ``stack(z)`` the (len(z), nnz) complex
    node values on the matrices' device."""
    from sparse_linear_tpu_torch.dtypes import complex_of
    from sparse_linear_tpu_torch.ops.linalg import lin

    union_b = lin(1, mat_b, 0, mat_a)  # union pattern, B values
    union_a = lin(0, mat_b, 1, mat_a)  # union pattern, A values
    cdtype = complex_of(torch.promote_types(mat_a.dtype, mat_b.dtype))
    ub, ua = union_b.data.to(cdtype), union_a.data.to(cdtype)

    def stack(z_nodes):
        z = torch.as_tensor(np.asarray(z_nodes, dtype=np.complex128),
                            device=ub.device).to(cdtype)
        return z[:, None] * ub[None, :] - ua[None, :]

    return union_b, union_a, stack


def _reduced_geig(aq, bq):
    """Generalized symmetric-definite reduced problem via spectral filtering
    of Bq (robust to rank-deficient subspaces)."""
    aq = np.asarray(aq)
    bq = np.asarray(bq)
    wb, vb = np.linalg.eigh(bq)
    keep = wb > max(1e-14 * max(wb.max(), 0.0), 0.0)
    if not np.any(keep):
        raise FloatingPointError("reduced Bq is numerically zero")
    binv_half = vb[:, keep] / np.sqrt(wb[keep])
    m = binv_half.conj().T @ aq @ binv_half
    lam, w = np.linalg.eigh(0.5 * (m + m.conj().T))
    coeff = binv_half @ w
    return lam, coeff


def _whiten_mat(g_np, passes=2):
    """Whitening matrix W (so Q W is orthonormal) from ONE pulled Gram.

    The FEAST-filtered subspace is numerically rank-deficient by design
    (the contour filter kills the m0 - m directions outside the interval),
    so a Gram Cholesky breaks down; eigh-based whitening floors the noise
    eigenvalues instead, and the reduced generalized eigenproblem drops
    those directions by its own B-mass cutoff.  The second pass's Gram
    W1^H G W1 is formed on the host in f64: only the m0 x m0 block crosses
    from the device."""
    g = np.asarray(g_np)
    g = 0.5 * (g + g.conj().T)
    wtot = np.eye(g.shape[0], dtype=g.dtype)
    tiny = np.finfo(np.float64).tiny
    for _ in range(passes):
        w, v = np.linalg.eigh(0.5 * (g + g.conj().T))
        floor = max(float(w.max()), 0.0) * np.finfo(np.float64).eps * len(w)
        wi = 1.0 / np.sqrt(np.maximum(w, max(floor, tiny)))
        w1 = (v * wi[None, :]) @ v.conj().T
        wtot = wtot @ w1
        g = w1.conj().T @ g @ w1
    return wtot


def _is_identity(mat) -> bool:
    """mat == I exactly (the eigSH B:=ident case, Feast.hs:99-100; skips
    every B product and B residual)."""
    csr = mat.tocsr()
    n = csr.shape[0]
    if csr.shape[1] != n or csr.nnz != n:
        return False
    ar = torch.arange(n, device=csr.data.device)
    return bool(torch.equal(csr.indptr.to(torch.int64),
                            torch.arange(n + 1, device=ar.device))
                and torch.equal(csr.indices[:n].to(torch.int64), ar)
                and bool((csr.data[:n] == 1).all()))


def _mesh_shards(where, mesh, params, contour_axis, rows_axis):
    """(the devices of ``mesh[contour_axis]``, one a group of contour
    nodes; the devices of ``mesh[rows_axis]`` when it has more than one
    shard, over which the subspace is row-sharded, else None), or (None,
    None) without a mesh.  As in the JAX package, the node count must
    divide by the contour shards; the rows need not divide by the rows
    shards."""
    if mesh is None:
        return None, None
    rows = None
    if rows_axis in mesh.axis_names and mesh.shape[rows_axis] > 1:
        rows = mesh.shards(rows_axis)
    shards = mesh.shards(contour_axis)
    ne = params.contour_points
    if ne % len(shards):
        raise ValueError(
            f"{where}: {ne} contour points are not divisible by the "
            f"{len(shards)} shards of mesh axis {contour_axis!r}")
    return shards, rows


def _check_args(where, interval, mat_a, mat_b, params):
    emin, emax = float(interval[0]), float(interval[1])
    if emax <= emin:
        raise ValueError(f"{where}: empty interval")
    n = mat_a.shape[0]
    if mat_a.shape != (n, n) or (mat_b is not None and mat_b.shape != (n, n)):
        raise ValueError(f"{where}: A and B must be square and equal-sized")
    if params.complex_strategy == "embedded":
        raise ValueError(
            f"{where}: complex_strategy='embedded' (the real 2n embedding) "
            "is a TPU workaround the port leaves out (ROADMAP.md, 'Port the "
            "capability, not the TPU workaround'); the card factors complex "
            "shifts natively")
    if params.complex_strategy not in ("auto", "native"):
        raise ValueError(
            f"unknown complex_strategy: {params.complex_strategy!r}")
    if params.contour_batching not in ("auto", "vmap", "loop"):
        raise ValueError(
            f"unknown contour_batching: {params.contour_batching!r} "
            "(expected 'vmap', 'loop' or 'auto')")
    return emin, emax, n


def _device_mats(mat_a, mat_b, device):
    if device is None:
        return mat_a, mat_b
    return mat_a.to(device), None if mat_b is None else mat_b.to(device)


def geigsh(m0, interval, mat_a, mat_b, params: FeastParams = FeastParams(),
           guess=None, mesh=None, contour_axis: str = "cp",
           rows_axis: str = "rows", *, device=None) -> EigResult:
    """Generalized Hermitian interval eigenproblem A x = lambda B x,
    eigenvalues in ``interval`` = (emin, emax), subspace dimension m0.

    Reference: ``geigSH``/``geigSH_`` (Feast.hs:62-70,102-113,115-240),
    including the warm start through ``guess`` (Feast.hs:119,157-168,
    fpm[4]=1).  Runs on the matrices' device, or on ``device`` when given.

    Distribution: with ``mesh`` (a ``dist.mesh.Mesh``) the contour nodes
    are split over ``mesh.shards(contour_axis)`` in contiguous groups (the
    JAX package shards the stacked node axis; the node count must divide
    by the shard count): each shard factors and solves its nodes on its
    device, and the quadrature sums are psum'd onto the subspace's device
    (``pipeline``'s "sharded" contour).  Where ``mesh[rows_axis]`` has more
    than one shard, the (n, m0) subspace blocks are also row-sharded over
    ``mesh.shards(rows_axis)`` (the JAX package's ``P(rows_axis, None)``):
    A and B run as row-sharded products, the Grams and norms as per-shard
    sums psum'd in shard order, and a ``guess`` is split; else the subspace
    and the Rayleigh-Ritz step stay on the matrices' device.  ``vectors``
    and ``subspace`` come back whole on the matrices' device either way."""
    from sparse_linear_tpu_torch.eig import pipeline

    emin, emax, n = _check_args("geigsh", interval, mat_a, mat_b, params)
    shards, rows = _mesh_shards("geigsh", mesh, params, contour_axis,
                                rows_axis)
    if m0 < 1 or m0 > n:
        raise ValueError(f"geigsh: m0 must be in [1, {n}]")
    mat_a, mat_b = _device_mats(mat_a, mat_b, device)
    if params.check_hermitian:
        _check_hermitian(mat_a, "A")
        _check_hermitian(mat_b, "B")
    return pipeline.geigsh_pipeline(m0, (emin, emax), mat_a, mat_b, params,
                                    guess=guess, shards=shards, rows=rows)


def eigsh(m0, interval, mat_a, params: FeastParams = FeastParams(),
          guess=None, mesh=None, contour_axis: str = "cp",
          rows_axis: str = "rows", *, device=None) -> EigResult:
    """Standard Hermitian interval problem: B = I (reference ``eigSH``,
    Feast.hs:53-60,91-100); ``mesh`` as in :func:`geigsh`."""
    mat_a, _ = _device_mats(mat_a, None, device)
    b = eye(mat_a.shape[0], dtype=real_of(mat_a.dtype),
            device=mat_a.data.device)
    return geigsh(m0, interval, mat_a, b, params=params, guess=guess,
                  mesh=mesh, contour_axis=contour_axis, rows_axis=rows_axis)


def count_eigenvalues(interval, mat_a, mat_b=None, probes: int = 16,
                      params: FeastParams = FeastParams(),
                      seed: int = 0, *, device=None) -> float:
    """Stochastic estimate of the NUMBER of eigenvalues in ``interval``:
    FEAST 4.x's stochastic-estimate mode (fpm(14)=2).  Use it to size
    ``m0`` before a full ``eigsh``/``geigsh`` run.

    Hutchinson trace estimator on the spectral projector P: with s
    Rademacher probes x_i (``np.random.default_rng(seed)``, as the JAX
    package draws them), count ~= (1/s) Re sum_i x_i^H P x_i, where each
    P x_i is one filter application on the SAME cached contour factors a
    following ``geigsh`` on the pencil reuses."""
    from sparse_linear_tpu_torch.eig import pipeline

    emin, emax, n = _check_args("count_eigenvalues", interval, mat_a, mat_b,
                                params)
    mat_a, mat_b = _device_mats(mat_a, mat_b, device)
    if mat_b is None:
        mat_b = eye(n, dtype=real_of(mat_a.dtype), device=mat_a.data.device)
    if params.check_hermitian:
        _check_hermitian(mat_a, "A", "count_eigenvalues")
        _check_hermitian(mat_b, "B", "count_eigenvalues")
    s = int(max(1, probes))
    rng = np.random.default_rng(seed)
    x = rng.choice(np.asarray([-1.0, 1.0]), size=(n, s))  # Rademacher
    return pipeline.count_pipeline((emin, emax), mat_a, mat_b, params, x)


def geigsh_sliced(interval, mat_a, mat_b=None, m0_max: int = 64,
                  params: FeastParams = FeastParams(), probes: int = 16,
                  max_depth: int = 8, *, device=None) -> EigResult:
    """Spectrum slicing: solve a WIDE interval whose eigenpair count
    exceeds one practical subspace by recursively bisecting it until each
    slice's stochastic count estimate (``count_eigenvalues``) fits in
    ``m0_max``, solving each slice independently, and merging (FEAST 4.x's
    contour splitting; the reference's 2.x binding solves one interval).

    A slice whose solve reports INFO_SUBSPACE_TOO_SMALL is bisected and
    solved again.  Returns one merged EigResult: values ascending, vectors
    column-concatenated, ``iterations`` summed over slices, ``epsout`` the
    worst slice, ``subspace`` the converged vectors."""
    emin, emax = float(interval[0]), float(interval[1])
    if emax <= emin:
        raise ValueError("geigsh_sliced: empty interval")
    if m0_max < 4:
        raise ValueError("geigsh_sliced: m0_max must be >= 4")
    mat_a, mat_b = _device_mats(mat_a, mat_b, device)
    dev = mat_a.data.device

    def margin(est):
        return int(np.ceil(max(est, 0.0) * 1.25)) + 4

    slices = []
    stack = [(emin, emax, 0)]
    while stack:
        lo, hi, depth = stack.pop()
        est = count_eigenvalues((lo, hi), mat_a, mat_b, probes=probes,
                                params=params)
        if margin(est) <= m0_max or depth >= max_depth:
            slices.append((lo, hi, min(max(margin(est), 8), m0_max)))
        else:
            mid = 0.5 * (lo + hi)
            stack.append((mid, hi, depth + 1))
            stack.append((lo, mid, depth + 1))
    slices.sort()

    results = []
    total_loops = 0
    worst_eps = 0.0
    worst_info = INFO_NO_EIGENVALUES
    i = 0
    while i < len(slices):
        lo, hi, m0 = slices[i]
        i += 1
        if mat_b is None:
            res = eigsh(m0, (lo, hi), mat_a, params)
        else:
            res = geigsh(m0, (lo, hi), mat_a, mat_b, params)
        if (res.info == INFO_SUBSPACE_TOO_SMALL
                or (res.n_found >= m0 and m0 < m0_max)):
            # the estimate undershot: bisect this slice and redo both halves
            mid = 0.5 * (lo + hi)
            if hi - lo > 1e-12 * max(abs(emin), abs(emax), 1.0):
                slices.insert(i, (mid, hi, m0))
                slices.insert(i, (lo, mid, m0))
                continue
        total_loops += res.iterations
        # drop unconverged pairs (residual far above tolerance): a slice
        # that hit max_loops can report filter leftovers beside its
        # converged pairs
        gate = max(1e4 * params.tol, 1e-8)
        rk = np.asarray(res.residuals) <= gate
        if res.n_found and not np.all(rk):
            sel = torch.as_tensor(np.nonzero(rk)[0], device=dev)
            res = res._replace(values=np.asarray(res.values)[rk],
                               vectors=res.vectors[:, sel],
                               residuals=np.asarray(res.residuals)[rk],
                               n_found=int(rk.sum()))
        if res.n_found:
            worst_eps = max(worst_eps, float(np.max(res.residuals)))
            worst_info = max(
                worst_info if worst_info != INFO_NO_EIGENVALUES else 0,
                res.info if res.info != INFO_NO_EIGENVALUES else 0,
            )
            results.append(res)

    if not results:
        n = mat_a.shape[0]
        empty = torch.zeros((n, 0), dtype=mat_a.dtype, device=dev)
        return EigResult(values=np.zeros(0), vectors=empty, n_found=0,
                         iterations=total_loops, epsout=0.0,
                         residuals=np.zeros(0), info=INFO_NO_EIGENVALUES,
                         subspace=empty)

    values = np.concatenate([np.asarray(r.values) for r in results])
    vectors = torch.cat([r.vectors for r in results], dim=1)
    residuals = np.concatenate([np.asarray(r.residuals) for r in results])
    order = np.argsort(values)
    values, residuals = values[order], residuals[order]
    vectors = vectors[:, torch.as_tensor(order, device=dev)]
    keep = _dedup_groups(values, vectors, max(abs(emin), abs(emax), 1.0))
    sel = torch.as_tensor(np.nonzero(keep)[0], device=dev)
    values, residuals, vectors = values[keep], residuals[keep], vectors[:, sel]
    return EigResult(
        values=values, vectors=vectors, n_found=int(values.size),
        iterations=total_loops, epsout=worst_eps, residuals=residuals,
        info=worst_info, subspace=vectors,
    )


def _dedup_groups(values, vectors, scale) -> np.ndarray:
    """Which merged pairs to keep.  An eigenvalue on a cut can come from
    both slices, degenerate ones as different vectors of one eigenspace:
    within each group of values equal to 1e-9 * scale, a vector is kept
    only if it has a substantial component outside the span of those
    already kept."""
    m = values.size
    keep = np.ones(m, dtype=bool)
    j0 = 0
    for j in range(1, m + 1):
        if j < m and abs(values[j] - values[j - 1]) < 1e-9 * scale:
            continue
        if j - j0 > 1:  # group [j0, j) of equal values
            basis: list = []
            for t in range(j0, j):
                v = vectors[:, t].to(torch.complex128)
                v = v / max(float(torch.linalg.vector_norm(v)), 1e-300)
                for bvec in basis:
                    v = v - bvec * torch.vdot(bvec, v)
                nv = float(torch.linalg.vector_norm(v))
                if nv < 0.5:  # numerically inside the kept span: duplicate
                    keep[t] = False
                else:
                    basis.append(v / nv)
        j0 = j
    return keep


def eigsh_sliced(interval, mat_a, m0_max: int = 64,
                 params: FeastParams = FeastParams(), probes: int = 16,
                 max_depth: int = 8, *, device=None) -> EigResult:
    """Standard-problem spectrum slicing (B = I); see ``geigsh_sliced``."""
    return geigsh_sliced(interval, mat_a, None, m0_max=m0_max,
                         params=params, probes=probes, max_depth=max_depth,
                         device=device)
