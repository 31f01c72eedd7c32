"""Multi-device walkthrough on the PyTorch port: a mesh of shards on the
cards.

The counterpart of ``distributed.py``: the three distribution layers
(SURVEY.md §2.4 P1-P5), row-sharded SpMV with the halo exchange,
contour-sharded FEAST, and front-sharded multifrontal factorization, plus
FEAST on a ("cp", "rows") mesh whose rows axis also row-shards the
subspace.  The port's layer is single-controller, as the JAX one is: one
process drives every shard of a ``dist.Mesh``.  By default the shards go
round-robin on the CUDA cards (``card_mesh``: one card holds all of them,
four cards one each); ``--device cpu`` puts them all on the CPU.

    python examples/torch_distributed.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import numpy as np
import torch

import sparse_linear_tpu_torch as st
from sparse_linear_tpu_torch.dist import ShardedVector, card_mesh
from sparse_linear_tpu_torch.dist.spmv import dia_spmv_sharded, shard_dia_rows
from sparse_linear_tpu_torch.eig import pipeline
from sparse_linear_tpu_torch.eig.feast import FeastParams, eigsh
from sparse_linear_tpu_torch.solve import multifrontal as mf
from sparse_linear_tpu_torch.utils.grids import laplacian_1d, poisson_2d


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="put every shard here (e.g. cpu); by default the "
                         "shards go round-robin on the CUDA cards")
    device = ap.parse_args(argv).device
    mesh = card_mesh(4, ("rows",), device)
    base = mesh.shards("rows")[0]
    name = (torch.cuda.get_device_name(base) if base.type == "cuda"
            else "host")
    print(f"device: {base} ({name}); mesh {mesh.layout()}")

    # P1: row-partitioned SpMV with the halo exchange (kernel A a slab)
    g = 32
    a = shard_dia_rows(poisson_2d(g, dtype=torch.float32, fmt="dia",
                                  device=base), mesh)
    x = ShardedVector.from_tensor(torch.ones(g * g, dtype=torch.float32,
                                             device=base), mesh)
    y = dia_spmv_sharded(a, x, mesh, exchange="halo")
    print("sharded SpMV:", y.length, "rows in blocks", y.blocks, "on",
          sorted({str(d) for d in y.devices}))

    # P3: FEAST with the contour-node axis sharded over the mesh
    cp_mesh = card_mesh(4, ("cp",), device)
    a_eig = laplacian_1d(64, dtype=torch.float64, device=base)
    p = FeastParams(tol=1e-10, contour_points=8)
    res = eigsh(16, (0.05, 0.5), a_eig, p, mesh=cp_mesh)
    print(f"distributed FEAST: {res.n_found} pairs, eps {res.epsout:.1e}, "
          f"contour {pipeline.last_run['why']}")

    # P4: a ("cp", "rows") mesh: the contour nodes over "cp", and every
    # (n, m0) subspace block row-sharded over "rows" (halo products on
    # kernel A's multi-RHS form, psum'd Grams)
    cr_mesh = card_mesh((2, 2), ("cp", "rows"), device)
    res2 = eigsh(16, (0.05, 0.5), a_eig, p, mesh=cr_mesh)
    run = pipeline.last_run
    print(f"(cp, rows) FEAST: {res2.n_found} pairs, eps {res2.epsout:.1e}, "
          f"{len(run['shards'])} contour shards, {len(run['rows_shards'])} "
          f"rows shards of {run['rows_local']} rows; eigenvalues within "
          f"{float(np.max(np.abs(res2.values - res.values))):.1e} of the "
          "contour-sharded run")
    assert res2.n_found == res.n_found and res2.epsout <= 1e-10

    # multi-device multifrontal: each bucket's independent fronts are split
    # over the mesh; the children's updates are gathered where their
    # parents are assembled
    fr_mesh = card_mesh(4, ("fronts",), device)
    g2 = 16
    a_mf = poisson_2d(g2, dtype=torch.float64, device=base)
    sym = mf.analyze(a_mf, dims=(g2, g2))
    fac = mf.factor(a_mf, sym, kind="cholesky", mesh=fr_mesh)
    b = torch.ones(g2 * g2, dtype=torch.float64, device=base)
    x_mf = mf.solve(fac, b)
    print("sharded factor solve residual:",
          float(torch.linalg.vector_norm(st.spmv(a_mf, x_mf) - b)
                / torch.linalg.vector_norm(b)))


if __name__ == "__main__":
    main()
