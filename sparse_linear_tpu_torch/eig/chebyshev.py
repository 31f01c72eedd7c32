"""Chebyshev-filtered subspace iteration on the card: the factorization-free
eigensolver for the LOWEST part of a real symmetric spectrum.

Counterpart of :mod:`sparse_linear_tpu.eig.chebyshev`.  FEAST (``eig.feast``)
filters with rational functions, one sparse factorization per contour node.
For the "k lowest eigenpairs" problem a degree-p Chebyshev polynomial of A
damps the unwanted spectrum [emax, lam_ub] by T_p's growth outside [-1, 1],
and its only access to the operator is SpMM: the route FEAST's pipeline
chooses (``eig.pipeline._structured_op``), kernel A's multi-RHS form
(``dia_spmm_kernel``) for a banded operator and kernel D (``well_spmm``)
for any other.  This is the ChASE/FILTLAN-class method:

* block three-term recurrence with ChASE's sigma-scaling (overflow-safe),
  an eager loop of ``degree`` SpMMs with in-place updates and no host
  sync inside;
* CholeskyQR2 orthonormalization: the Gram in a plain f64 ``torch.matmul``
  on the device, its m0 x m0 Cholesky and inverse on the host;
* Rayleigh-Ritz in plain f64 matmuls with the m0 x m0 ``eigh`` on the host,
  residual-gated convergence, residual-expanded [X | R] passes near the
  floor.

Left out as TPU workarounds: the chunked f64-exact ``dot64`` products, the
plane-major recurrence for operators that prefer it (kernel D reads the
column-major (n, m) block natively) and the ``jit`` / ``closure_convert``
of the filter, which served the JAX runtime's dispatch queue.

Scope, as in the JAX module: real symmetric A (a float32 operator is
applied to float64 blocks, DIA promoting and WELL computing in its own
type, as the JAX package's routes do), B = I, the lowest interval [emin,
emax] with emin at or below the spectrum's floor; a complex operator raises
``TypeError``, as it does there.  Interior intervals need rational filters:
use ``eig.feast.eigsh``.  The JAX module documents, on its TPU, a limit at
scale (the 1M-dof 2D Poisson's 50 lowest pairs stalling near 1e-3, blamed
on CholeskyQR2's Gram floor).  On an NVIDIA H100 the same case stops at
48 of 50 pairs near 1e-3 after the default passes, with every block's
condition number under 1e3: the pairs within ~1e-5 below emax converge
slowly because the filter damps [emax, lam_ub], and a pair delta below
emax gains only cosh(degree * sqrt(4 delta / (lam_ub - emax))) a pass,
whatever m0 (``PERF.md``, ``tools/torch_chebyshev_probe.py``).

Results stay on the operator's device: ``vectors`` and ``subspace`` are
tensors there, ``values`` and ``residuals`` numpy arrays.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from sparse_linear_tpu_torch.dtypes import default_device

__all__ = ["eigsh_filtered", "lanczos_upper_bound", "last_run"]

# What the last eigsh_filtered call used and spent: its route, bound and
# degree, and a row a pass (kind, filter and pass seconds up to a device
# sync, pairs inside the window, epsout).
last_run: dict = {}


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _start_block(n: int, m: int, seed: int, device,
                 dtype=torch.float64) -> torch.Tensor:
    """The random (n, m) start block, drawn on ``device`` from a generator
    seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((n, m), dtype=dtype, device=device, generator=gen)


def lanczos_upper_bound(a_mm, n: int, iters: int = 30, seed: int = 7,
                        dtype=torch.float64, device=None) -> float:
    """Cheap upper bound on lambda_max(A): ``iters`` Lanczos steps plus the
    final residual norm as a safety margin (Parlett's bound).  The start
    vector is drawn on ``device`` (by default the card); the recurrence's
    scalars stay there until the end."""
    v = _start_block(n, 1, seed, default_device(device), dtype)[:, 0]
    v = v / torch.linalg.vector_norm(v)
    alphas, betas = [], []
    v_prev = torch.zeros_like(v)
    beta = 0.0
    tiny = torch.finfo(dtype).tiny
    for _ in range(iters):
        w = a_mm(v[:, None])[:, 0]
        if w.is_complex():
            raise TypeError("lanczos_upper_bound: the operator is complex; "
                            "the bound is for a real symmetric one")
        w = w.to(dtype)
        alpha = torch.dot(v, w)
        w = w - alpha * v - beta * v_prev
        beta_new = torch.linalg.vector_norm(w)
        alphas.append(alpha)
        betas.append(beta_new)
        v_prev = v
        beta = beta_new
        v = w / torch.clamp(beta_new, min=tiny)
    alphas = _host(torch.stack(alphas))
    betas = _host(torch.stack(betas))
    t = np.diag(alphas) + np.diag(betas[:-1], 1) + np.diag(betas[:-1], -1)
    ew, ev = np.linalg.eigh(t)
    # Parlett: lambda_max <= max Ritz value + |last beta * last component|
    bound = float(ew[-1] + abs(betas[-1] * ev[-1, -1]))
    return bound * 1.01 + 1e-12


def _cholqr2(y: torch.Tensor) -> torch.Tensor:
    """CholeskyQR2: orthonormalize a tall block with two Gram/Cholesky
    passes (the Gram an f64 matmul on the block's device; Cholesky and
    inverse on the host, m0 x m0)."""
    for _ in range(2):
        g = _host(y.T @ y)
        # spectral floor guard: a rank-deficient filtered block gets a
        # tiny diagonal shift rather than a Cholesky breakdown
        d = np.diag(g).max()
        try:
            r = np.linalg.cholesky(g + np.eye(g.shape[0]) * d * 1e-15)
        except np.linalg.LinAlgError:
            r = np.linalg.cholesky(g + np.eye(g.shape[0]) * d * 1e-8)
        rinv = np.linalg.inv(r).T  # y @ rinv orthonormalizes
        y = y @ torch.as_tensor(rinv, dtype=y.dtype, device=y.device)
    return y


def _make_filter(a_mm, y_example, deg: int):
    """The degree-``deg`` block filter, ``filt(y, center, half, lam0)``.

    An eager loop of ``deg`` products.  ``center``, ``half``, ``sigma`` and
    ``tau`` are Python floats, so no step waits for the device.  Two blocks
    are carried; each step's product is updated in place into the next
    (``sub_``, ``mul_``, ``sub_``) and the oldest block is dropped, so at a
    steady state torch's caching allocator hands the product the block
    dropped a step before and no step takes new device memory.  ``y`` is
    read, never written.  ``a_mm`` must return a block of its own (not its
    argument).  ``y_example`` is the JAX signature's tracing example, unused
    here."""
    del y_example

    def filt(y, center, half, lam0):
        sigma = half / (center - lam0)
        tau = 2.0 / sigma
        y0 = y
        y1 = a_mm(y).sub_(y, alpha=center).mul_(sigma / half)
        for _ in range(1, deg):
            sn = 1.0 / (tau - sigma)
            y2 = a_mm(y1).sub_(y1, alpha=center).mul_(2.0 * (sn / half))
            y2.sub_(y0, alpha=sigma * sn)
            y0, y1, sigma = y1, y2, sn
        return y1

    return filt


def eigsh_filtered(m0, interval, mat_a, tol: float = 1e-10,
                   degree: int | None = None, max_passes: int = 24,
                   lam_ub: float | None = None, seed: int = 0,
                   dims=None):
    """~All eigenpairs of symmetric ``mat_a`` in the LOWEST interval
    ``[emin, emax]`` by Chebyshev-filtered subspace iteration.

    Factorization-free: the only operator access is the structured SpMM
    (DIA or WELL, through FEAST's operator router), so cost is
    O(degree x passes) SpMMs.  Returns the same ``EigResult`` as ``eigsh``,
    on ``mat_a``'s device.

    ``m0``: subspace block (> expected pair count).  ``degree``: filter
    degree per pass (default: adaptive from the spectral ratio).
    ``lam_ub``: spectrum upper bound (default: Lanczos estimate).
    ``seed``: the start block's.  ``dims`` is accepted for the JAX
    signature and unused, as there.
    """
    from sparse_linear_tpu_torch.eig.feast import (
        EigResult, INFO_NO_EIGENVALUES, INFO_NOT_CONVERGED, INFO_OK,
        INFO_SUBSPACE_TOO_SMALL,
    )
    from sparse_linear_tpu_torch.eig.pipeline import _structured_op, _sync

    emin, emax = float(interval[0]), float(interval[1])
    if emax <= emin:
        raise ValueError("eigsh_filtered: empty interval")
    n = mat_a.shape[0]
    if m0 < 2:
        raise ValueError("eigsh_filtered: m0 must be >= 2")
    if mat_a.dtype.is_complex:
        raise TypeError("eigsh_filtered: complex operator; the filter is "
                        "for real symmetric ones (use eig.feast.eigsh)")
    device = mat_a.data.device
    f64 = torch.float64
    a_op = _structured_op(mat_a)

    def a_mm(x):
        """A x in f64, in a block of its own (the filter updates it in
        place)."""
        return a_op(x).to(f64)

    if lam_ub is None:
        lam_ub = lanczos_upper_bound(a_mm, n, device=device)
    if emax >= lam_ub:
        raise ValueError(
            "eigsh_filtered: interval reaches the spectrum's upper bound — "
            "the polynomial filter needs emax < lambda_max; use eigsh()"
        )
    center = 0.5 * (lam_ub + emax)
    half = 0.5 * (lam_ub - emax)
    if degree is None:
        # damping ~ exp(-2 deg sqrt(gap ratio)): size for ~1e6 per pass
        ratio = max((emax - emin) / max(lam_ub - emin, 1e-300), 1e-12)
        degree = int(np.clip(14.0 / np.sqrt(ratio) / 2.0, 30, 400))

    last_run.clear()
    last_run.update(route=a_op.route, lam_ub=lam_ub, degree=degree,
                    passes=[])
    y = _start_block(n, m0, seed, device)
    lam0 = emin
    tiny = np.finfo(np.float64).tiny
    lam_scale = max(abs(emin), abs(emax), 1.0)
    info = INFO_NOT_CONVERGED
    lam_np = np.zeros((0,))
    res_np = np.zeros((0,))
    x_dev = None
    ax = None
    ew = None
    epsout = np.inf
    passes = 0

    def rayleigh_ritz(basis, m_keep):
        """Orthonormalize, project, solve, return the m_keep lowest Ritz
        pairs with their A-images."""
        q = _cholqr2(basis)
        aq = a_mm(q)
        h = _host(q.T @ aq)
        ew, ev = np.linalg.eigh((h + h.T) / 2)
        sel = torch.as_tensor(np.ascontiguousarray(ev[:, :m_keep]),
                              device=device)
        return ew[:m_keep], q @ sel, aq @ sel

    filt = _make_filter(a_mm, y, degree)
    expand_next = False
    for it in range(max_passes):
        passes = it + 1
        t_pass = time.perf_counter()
        filter_s = 0.0
        kind = "filter" if epsout > 1e-7 or not expand_next else "expanded"
        if kind == "filter":
            # filter pass: high-gain Chebyshev filtering of the block
            x_dev = ax = None  # free last pass's blocks (recomputed below)
            y = filt(y, center, half, lam0)
            _sync(device)
            filter_s = time.perf_counter() - t_pass
            ew, x_dev, ax = rayleigh_ritz(y, m0)
            expand_next = True
        else:
            # near convergence the filter alone floors around 1e-9: its
            # ~1e6 gain disparity aliases roundoff into the weak
            # (near-edge) modes, whose correction directions live just
            # ABOVE the filter edge (where the filter damps).  Alternating
            # a residual-expanded Rayleigh-Ritz ([X | R] basis) with
            # filter passes restores them to the f64 floor.
            rblk = ax - x_dev * torch.as_tensor(ew, device=device)[None, :]
            rn = torch.linalg.vector_norm(rblk, dim=0)
            basis = torch.cat(
                [x_dev, rblk / torch.clamp(rn, min=1e-300)], dim=1)
            # free the dead (n, m0) blocks BEFORE the wide-basis RR: at
            # 1M dof each is 512 MB and the doubled-basis CholeskyQR is
            # the solve's memory peak
            del rblk, rn
            x_dev = ax = y = None
            ew, x_dev, ax = rayleigh_ritz(basis, m0)
            del basis
            expand_next = False
        ew_dev = torch.as_tensor(ew, device=device)[None, :]
        rnorm = _host(torch.linalg.vector_norm(ax - x_dev * ew_dev, dim=0))
        xnorm = _host(torch.linalg.vector_norm(x_dev, dim=0))
        res_all = rnorm / np.maximum(xnorm, tiny) / lam_scale
        inside = (ew >= emin) & (ew <= emax)
        m_found = int(inside.sum())
        epsout = float(res_all[inside].max()) if m_found else float(
            res_all.min()
        )
        lam_np, res_np = ew[inside], res_all[inside]
        last_run["passes"].append(dict(
            kind=kind, filter_s=filter_s, s=time.perf_counter() - t_pass,
            m_found=m_found, epsout=epsout))
        # steer the filter at the current Ritz floor (sharper each pass)
        lam0 = float(min(ew.min(), emin))
        if m_found and epsout <= tol:
            info = INFO_OK
            break
        if m_found == 0 and it >= 2:
            info = INFO_NO_EIGENVALUES
            break
        y = x_dev
    if len(lam_np) == m0:
        info = INFO_SUBSPACE_TOO_SMALL

    if y is None:
        # the residual-expansion branch frees y before its RR; a break in
        # that same pass would otherwise ship subspace=None to warm-restart
        # consumers: the Ritz block is the correct restart subspace
        y = x_dev

    order = np.argsort(lam_np)
    if x_dev is not None and lam_np.size:
        sel = torch.as_tensor(np.nonzero(inside)[0][order], device=device)
        vectors = x_dev[:, sel]
    else:
        vectors = torch.zeros((n, 0), dtype=f64, device=device)
    return EigResult(
        values=lam_np[order],
        vectors=vectors,
        n_found=len(lam_np),
        iterations=passes,
        epsout=epsout,
        residuals=res_np[order],
        info=info,
        subspace=y,
    )
