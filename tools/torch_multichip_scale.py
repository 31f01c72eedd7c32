#!/usr/bin/env python
"""Scale rehearsal of the PyTorch port's row-partitioned SpMV on 16 shards.

The counterpart of ``tools/multichip_scale.py``: the row-partitioned SpMV
paths of ``sparse_linear_tpu_torch.dist.spmv`` (the DIA halo exchange, the
ELL / BSR (8, 16) / WELL column-window ring exchange) on the 24**3
Poisson operator (13,824 dof) over 16 shards, recording for each format
the x elements a shard receives against the all-gather's and the max abs
error against the scipy product.  The port's plans are the JAX package's
element for element, so the shipped counts are those of
``MULTICHIP_SCALE.json``, except where ``dist.spmv._covers`` refuses a
plan that leaves a slab's columns outside its window (the format then
all-gathers, and its entry says so).  Writes ``MULTICHIP_SCALE_TORCH.json``
at the repo root; it holds no times.

    python tools/torch_multichip_scale.py [--shards 16] [--nx 24]
        [--device cpu] [--out PATH]

By default the shards go round-robin on the CUDA cards (``card_mesh``);
``--device cpu`` puts all of them on the CPU.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np
import scipy.sparse as sp
import torch


def scale_rehearsal(n_shards: int = 16, nx: int = 24, device=None) -> dict:
    """The rehearsal's record (the fields of ``MULTICHIP_SCALE.json``, plus
    the mesh layout and each format's exchange)."""
    from sparse_linear_tpu_torch.dist import card_mesh
    from sparse_linear_tpu_torch.dist.spmv import (
        dia_spmv_sharded,
        shard_bsr_rows,
        shard_dia_rows,
        shard_ell_rows,
        shard_well_rows,
        spmv_sharded,
        window_exchange_elements,
    )
    from sparse_linear_tpu_torch.utils.grids import poisson_3d

    mesh = card_mesh(n_shards, ("rows",), device)
    base = mesh.shards("rows")[0]
    n = nx ** 3
    if n % n_shards:
        raise ValueError(f"{n} rows do not divide by {n_shards} shards")
    rows = n // n_shards
    allgather = (n_shards - 1) * rows
    a = poisson_3d(nx, dtype=torch.float64, device=base)
    x_np = np.random.default_rng(3).standard_normal(n)
    ref = sp.csr_matrix((a.data.cpu().numpy(), a.indices.cpu().numpy(),
                         a.indptr.cpu().numpy()), shape=a.shape) @ x_np
    x = torch.as_tensor(x_np, device=base)
    out = {"n_devices": n_shards, "layout": mesh.layout(),
           "operator": f"3d_poisson_{nx}^3", "n": n, "nnz": int(a.nnz),
           "rows_per_device": rows,
           "allgather_elements_per_device": allgather, "formats": {}}

    def record(name, shipped, y, exchange):
        err = float(np.abs(y.full().cpu().numpy() - ref).max())
        out["formats"][name] = {
            "shipped_elements_per_device": int(shipped),
            "vs_allgather": round(shipped / allgather, 4),
            "exchange": exchange, "max_abs_err": err,
            "ok": bool(err < 1e-10)}

    # DIA halo: a shard receives its neighbours' halo segments, one each way
    dia = shard_dia_rows(poisson_3d(nx, dtype=torch.float64, fmt="dia",
                                    device=base), mesh)
    record("dia_halo", 2 * dia.halo,
           dia_spmv_sharded(dia, x, mesh, exchange="halo"), "halo")
    for name, sh in (
            ("ell", shard_ell_rows(a, mesh)),
            ("bsr", shard_bsr_rows(a, mesh, block_shape=(8, 16))),
            ("well", shard_well_rows(a, mesh))):
        if sh.xplan is None:
            record(name + "_window", allgather, spmv_sharded(sh, x, mesh),
                   "allgather: the window plan was refused by "
                   "dist.spmv._covers or shipped no less")
        else:
            record(name + "_window", window_exchange_elements(sh.xplan),
                   spmv_sharded(sh, x, mesh), "window")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shards", type=int, default=16)
    ap.add_argument("--nx", type=int, default=24)
    ap.add_argument("--device", default=None)
    ap.add_argument("--out",
                    default=os.path.join(ROOT, "MULTICHIP_SCALE_TORCH.json"))
    args = ap.parse_args(argv)
    out = scale_rehearsal(args.shards, args.nx, args.device)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
