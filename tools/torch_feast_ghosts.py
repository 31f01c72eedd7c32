#!/usr/bin/env python3
"""How the spurious Ritz pairs of an interior FEAST window move, loop by loop.

    python3 tools/torch_feast_ghosts.py [--grids 32 64] [--seeds 0 1 2]
        [--device cuda] [--out ghosts.json]

Runs the PyTorch port's ``eigsh`` on the grid**2 Poisson operator over the
interior window [lambda_100, lambda_150) (m0 = 80, tol 1e-10, multifrontal
with grid dims; one run a seed) and reads ``eig.pipeline.last_run``: for
each loop the genuine count, epsout and the (Ritz value, residual) of each
rejected pair.  Each rejected pair is matched with the previous loop's
rejected pair nearest in Ritz value, as ``pipeline._ghost_converged``
matches them, and the ratio of their residuals is printed.  This ratio is
what ``pipeline._GHOST_PROGRESS`` is set against: a ghost's residual
wanders, a genuine pair's falls by its filter ratio.  Prints one line a
run and, last, one JSON line with every loop and the ratios' range, which
``--out`` also keeps.  ``--device cpu`` runs on the host.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grids", type=int, nargs="+", default=[32, 64])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from sparse_linear_tpu_torch.eig import pipeline
    from sparse_linear_tpu_torch.eig.feast import FeastParams, eigsh
    from sparse_linear_tpu_torch.utils.grids import poisson_2d

    dev = torch.device(args.device)
    runs = []
    for g in args.grids:
        lam1 = 4 * np.sin(np.arange(1, g + 1) * np.pi / (2 * (g + 1))) ** 2
        lam = np.sort((lam1[:, None] + lam1[None, :]).ravel())
        lo = float((lam[99] + lam[100]) / 2)
        hi = float((lam[149] + lam[150]) / 2)
        a = poisson_2d(g, dtype=torch.float64, device=dev)
        for seed in args.seeds:
            t0 = time.perf_counter()
            res = eigsh(80, (lo, hi), a, FeastParams(
                tol=1e-10, dims=(g, g), backend="multifrontal", seed=seed))
            wall = time.perf_counter() - t0
            loops = [{"genuine": lp["genuine"], "epsout": lp["epsout"],
                      "ghosts": lp["ghosts"]}
                     for lp in pipeline.last_run["loops"]]
            ratios = []
            for prev, cur in zip(loops, loops[1:]):
                for v, r in cur["ghosts"]:
                    if prev["ghosts"]:
                        _, pr = min(prev["ghosts"], key=lambda t: abs(t[0] - v))
                        ratios.append(r / pr)
            runs.append({"grid": g, "seed": seed, "info": res.info,
                         "loops": loops, "n_found": res.n_found,
                         "ratios": ratios, "s": wall})
            print(f"{g}^2 seed {seed}: info {res.info}, {res.n_found} pairs, "
                  f"{len(loops)} loops, {wall:.3f} s; ghost residual ratios "
                  f"{[round(x, 3) for x in ratios]}", flush=True)
    every = [x for r in runs for x in r["ratios"]]
    out = {"device": str(dev), "runs": runs,
           "ratio_min": min(every) if every else None,
           "ratio_max": max(every) if every else None}
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
