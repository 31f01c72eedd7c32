"""P1 finite elements for -div(grad u) + u = f on a new 2D mesh, made on
the device from a seed.

A mesh: an nx x ny lattice of about ``target`` nodes on a rectangle of
unit area with square cells (aspect ratio drawn log-uniform in
``aspect``), every node moved by a uniform jitter of up to ``jitter`` of
the spacing in each coordinate (boundary nodes along their side only,
corners fixed, so the domain stays the rectangle), each cell split along a
diagonal drawn at random, and the nodes numbered by a random permutation.
A jitter of at most 0.2 keeps every triangle's area at least a fifth of
the unjittered h^2 / 2: no triangle inverts.

The operator A = K + M: K the stiffness matrix in its cotangent form
(K_ij = -cot(theta_k) / 2 for the angle theta_k opposite the edge ij, a
row's diagonal minus the sum of its off-diagonals), M the consistent mass
matrix (area / 6 on the diagonal, area / 12 off it).  Natural boundary
conditions: A is symmetric positive definite.  Its triples come 9 a
triangle, unsorted, each edge's entries once for each of its one or two
triangles and each node's diagonal once for each of its triangles:
summing the duplicates is the port's work.

Everything is drawn from one ``torch.Generator`` on the device, in a fixed
order, so a generator seeded alike gives the same mesh.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import torch


def log_share(lo: float, hi: float, u: float) -> float:
    """The point a share ``u`` of the way from ``lo`` to ``hi`` on a log
    scale: log-uniform in [lo, hi] where ``u`` is uniform in [0, 1)."""
    return math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))


def mesh(target: float, aspect, jitter: float, gen,
         device) -> SimpleNamespace:
    """A jittered lattice triangulation of about ``target`` nodes: ``n``
    nodes, their coordinates ``xy`` (n, 2) float64, triangles ``tris``
    (t, 3) int64 of node numbers, counter-clockwise, and the lattice's
    ``nx``, ``ny``."""
    u = float(torch.rand((), dtype=torch.float64, device=device,
                         generator=gen))
    ratio = log_share(aspect[0], aspect[1], u)
    nx = max(2, round(math.sqrt(target * ratio)))
    ny = max(2, round(target / nx))
    n = nx * ny
    h = 1.0 / math.sqrt((nx - 1) * (ny - 1))  # square cells, unit area
    iy, ix = torch.meshgrid(torch.arange(ny, device=device),
                            torch.arange(nx, device=device), indexing="ij")
    ix, iy = ix.reshape(-1), iy.reshape(-1)
    fx, fy = ix.to(torch.float64), iy.to(torch.float64)
    shake = (2 * torch.rand((2, n), dtype=torch.float64, device=device,
                            generator=gen) - 1) * (jitter * h)
    x = fx * h + shake[0] * ((ix > 0) & (ix < nx - 1))
    y = fy * h + shake[1] * ((iy > 0) & (iy < ny - 1))

    cell = (torch.arange(ny - 1, device=device)[:, None] * nx
            + torch.arange(nx - 1, device=device)[None, :]).reshape(-1)
    a, b, c, d = cell, cell + 1, cell + 1 + nx, cell + nx
    flip = torch.rand(cell.shape, device=device, generator=gen) < 0.5
    # diagonal a-c: (a, b, c), (a, c, d); diagonal b-d: (a, b, d), (b, c, d)
    first = torch.stack([a, b, torch.where(flip, d, c)], 1)
    second = torch.stack([torch.where(flip, b, a), c, d], 1)
    tris = torch.cat([first, second])

    label = torch.randperm(n, device=device, generator=gen)
    xy = torch.empty((n, 2), dtype=torch.float64, device=device)
    xy[label] = torch.stack([x, y], 1)
    return SimpleNamespace(n=n, nx=nx, ny=ny, xy=xy, tris=label[tris])


def local_matrices(xy, tris):
    """(K, M, area): the element stiffness (t, 3, 3) in cotangent form, the
    consistent element mass (t, 3, 3) and the areas (t,), float64."""
    p = xy[tris]  # (t, 3, 2)
    e1, e2 = p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
    twice = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    stiff = torch.zeros((len(tris), 3, 3), dtype=torch.float64,
                        device=xy.device)
    for k in range(3):
        i, j = (k + 1) % 3, (k + 2) % 3
        u, v = p[:, i] - p[:, k], p[:, j] - p[:, k]
        # -cot(theta_k) / 2, cot = (u . v) / |u x v|
        off = -0.5 * (u * v).sum(1) / twice
        stiff[:, i, j] = off
        stiff[:, j, i] = off
    stiff -= torch.diag_embed(stiff.sum(2))
    area = 0.5 * twice
    eye = torch.eye(3, dtype=torch.float64, device=xy.device)
    mass = (area / 12)[:, None, None] * (1 + eye)
    return stiff, mass, area


def triples(m):
    """(rows, cols, vals) of A = K + M on the mesh ``m``, 9 a triangle,
    float64, duplicates left in."""
    stiff, mass, _ = local_matrices(m.xy, m.tris)
    rows = m.tris[:, :, None].expand(-1, 3, 3)
    cols = m.tris[:, None, :].expand(-1, 3, 3)
    return (rows.reshape(-1), cols.reshape(-1),
            (stiff + mass).reshape(-1))


def request(config, size: float, gen, device):
    """(n, rows, cols, vals, b) of one request: a new mesh whose node count
    lies a share ``size`` of the way, on a log scale, across the
    configuration's ``nodes``, its operator's triples and a random b,
    float64."""
    lo, hi = config["nodes"]
    m = mesh(log_share(lo, hi, size), config["aspect"],
             float(config["jitter"]), gen, device)
    rows, cols, vals = triples(m)
    b = torch.randn(m.n, dtype=torch.float64, device=device, generator=gen)
    return m.n, rows, cols, vals, b
