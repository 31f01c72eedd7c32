"""The port's counterparts of ``__graft_entry__``: ``entry()``, one CG step
on the 2D Poisson operator in DIA format, with the matvec through
``DIA.__matmul__`` (the Hopper kernel on CUDA tensors, the plain version on
CPU tensors), and ``dryrun_multichip(n)``, the multi-device paths on a mesh
of n shards."""

from __future__ import annotations

import numpy as np
import torch

from sparse_linear_tpu_torch.dtypes import default_device
from sparse_linear_tpu_torch.utils.grids import poisson_2d

__all__ = ["entry", "dryrun_multichip"]


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


def entry(device=None, grid: int = 64, dtype=torch.float32):
    """Returns (fn, args): ``fn(*args)`` is one CG step on the ``grid`` x
    ``grid`` Poisson operator (DIA) with b = ones, on ``device``, by default
    the card."""
    device = default_device(device)
    a = poisson_2d(grid, dtype=dtype, fmt="dia", device=device)
    b = torch.ones((grid * grid,), dtype=dtype, device=device)
    return _cg_step, (a, b)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The counterpart of ``__graft_entry__.dryrun_multichip`` on
    ``dist.card_mesh(n_devices, ..., device)`` (by default the cards):

    1. one distributed CG step on ``poisson_2d(max(8, n))`` in f32: the DIA
       row-sharded over the mesh (kernel A on each slab), halo exchange,
       psum'd dot products;
    2. contour-sharded FEAST on 24**2, 8 lowest pairs, checked against the
       analytic spectrum (count 8, epsout <= 1e-8, rtol 1e-8);
    3. a front-sharded Cholesky factor and solve on 8**2 (relative
       residual <= 1e-10).

    Raises ``AssertionError`` if a check fails; prints one line and returns
    its readings."""
    from sparse_linear_tpu_torch.dist import ShardedVector, card_mesh
    from sparse_linear_tpu_torch.dist.spmv import (
        dia_spmv_sharded,
        shard_dia_rows,
    )
    from sparse_linear_tpu_torch.eig.feast import FeastParams, eigsh
    from sparse_linear_tpu_torch.solve import multifrontal as mf

    mesh = card_mesh(n_devices, ("rows",), device)
    base = mesh.shards("rows")[0]
    grid = max(8, n_devices)  # tiny but divisible
    n = grid * grid
    a = shard_dia_rows(poisson_2d(grid, dtype=torch.float32, fmt="dia",
                                  device=base), mesh)
    b = ShardedVector.from_tensor(torch.ones(n, dtype=torch.float32,
                                             device=base), mesh)

    def matvec(v):
        return dia_spmv_sharded(a, v, mesh, exchange="halo")

    x = b.zeros_like()
    r = b - matvec(x)
    p = r
    ap = matvec(p)
    alpha = r.dot(r) / p.dot(ap)
    x = x + alpha * p
    rn = float((r - alpha * ap).norm())

    # FEAST, the contour nodes over the same shards: the result must
    # converge to the analytic 2D Poisson window with the exact count
    cp_mesh = card_mesh(n_devices, ("cp",), device)
    g_eig = 24
    i1 = np.arange(1, g_eig + 1)
    lam1d = 4 * np.sin(i1 * np.pi / (2 * (g_eig + 1))) ** 2
    lam2d = np.sort((lam1d[:, None] + lam1d[None, :]).ravel())
    n_want = 8
    emax = float((lam2d[n_want - 1] + lam2d[n_want]) / 2)
    tol_eig = 1e-8
    res = eigsh(16, (0.0, emax),
                poisson_2d(g_eig, dtype=torch.float64, device=base),
                FeastParams(tol=tol_eig, contour_points=max(4, n_devices),
                            max_loops=8, complex_strategy="native"),
                mesh=cp_mesh)
    if res.n_found != n_want:
        raise AssertionError(
            f"dryrun_multichip: distributed FEAST found {res.n_found} "
            f"pairs, expected {n_want}")
    if not res.epsout <= tol_eig:
        raise AssertionError(
            f"dryrun_multichip: distributed FEAST did not converge "
            f"(epsout {res.epsout:.3e} > tol {tol_eig:.0e})")
    if not np.allclose(np.sort(res.values), lam2d[:n_want], rtol=1e-8):
        raise AssertionError(
            "dryrun_multichip: distributed FEAST eigenvalues do not match "
            "the analytic 2D Poisson spectrum")

    # the direct solver, each bucket's fronts split over the shards
    g2 = 8
    a_mf = poisson_2d(g2, dtype=torch.float64, device=base)
    sym = mf.analyze(a_mf, dims=(g2, g2))
    fac = mf.factor(a_mf, sym, kind="cholesky",
                    mesh=card_mesh(n_devices, ("fronts",), device))
    b_mf = torch.ones(g2 * g2, dtype=torch.float64, device=base)
    x_mf = mf.solve(fac, b_mf)
    rres = float(torch.linalg.vector_norm(a_mf @ x_mf - b_mf)
                 / torch.linalg.vector_norm(b_mf))
    if not rres <= 1e-10:
        raise AssertionError(
            f"dryrun_multichip: sharded multifrontal factor+solve residual "
            f"{rres:.3e} > 1e-10")
    out = {"n_devices": n_devices, "layout": mesh.layout(), "cg_rnorm": rn,
           "x_blocks": x.blocks, "feast_found": res.n_found,
           "feast_epsout": float(res.epsout), "multifrontal_rres": rres}
    print(f"dryrun_multichip({n_devices}): ok on {mesh.layout()}, |r| = "
          f"{rn:.3e}, x in blocks {x.blocks}, feast found {res.n_found} "
          f"pairs (eps {res.epsout:.1e}), multifrontal sharded-factor rel "
          f"res {rres:.1e}")
    return out
