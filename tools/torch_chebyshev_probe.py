#!/usr/bin/env python3
"""How the Chebyshev-filtered eigensolver converges on the lowest window of
the 2D Poisson operator, pass by pass.

    python3 tools/torch_chebyshev_probe.py [--grid 1024] [--pairs 50]
        [--runs 64:60 96:40 128:30] [--degree N] [--device cuda]
        [--out probe.json]

Runs the PyTorch port's ``eig.chebyshev.eigsh_filtered`` on the grid**2
operator over the ``pairs`` lowest eigenvalues (emax the midpoint of
lambda_pairs and the next), once for each ``m0:max_passes`` of ``--runs``
(default degree unless ``--degree``), and reads ``chebyshev.last_run``:
for each pass its kind (filter or residual-expanded), seconds, the pairs
inside the window and epsout.  ``_cholqr2`` is wrapped to record, for
each CholeskyQR2 call, the condition number of the block it is given
(from the eigenvalues of its Gram) and whether the first Cholesky failed,
so that the JAX module's diagnosis of its 1M-dof stall (CholeskyQR2's Gram
floor) can be read off the run.  Prints one line a pass and a summary a
run, with how many of the wanted eigenvalues came back within 1e-10 of
the analytic ones; last, one JSON line of every run, which ``--out`` also
keeps.  On the card the ``nvidia-smi`` name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grid", type=int, default=1024)
    ap.add_argument("--pairs", type=int, default=50)
    ap.add_argument("--runs", nargs="+", default=["64:60", "96:40", "128:30"],
                    help="m0:max_passes of each run")
    ap.add_argument("--degree", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from sparse_linear_tpu_torch.eig import chebyshev
    from sparse_linear_tpu_torch.utils.grids import poisson_2d

    dev = torch.device(args.device)
    card = "cpu"
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(card, flush=True)
    g, k = args.grid, args.pairs
    lam1 = 4 * np.sin(np.arange(1, g + 1) * np.pi / (2 * (g + 1))) ** 2
    lam = np.sort((lam1[:, None] + lam1[None, :]).ravel())
    interval = (0.0, float((lam[k - 1] + lam[k]) / 2))
    a = poisson_2d(g, dtype=torch.float64, device=dev)

    grams = []
    plain_cholqr2 = chebyshev._cholqr2

    def observed_cholqr2(y):
        """``_cholqr2`` with the block's condition number and whether its
        first, lightly shifted Cholesky broke down, recorded."""
        gram = (y.T @ y).cpu().numpy()
        ew = np.linalg.eigvalsh(gram)
        d = np.diag(gram).max()
        try:
            np.linalg.cholesky(gram + np.eye(gram.shape[0]) * d * 1e-15)
            fallback = False
        except np.linalg.LinAlgError:
            fallback = True
        grams.append({"cond": float(np.sqrt(ew[-1] / max(ew[0], 1e-300))),
                      "fallback": fallback, "width": int(y.shape[1])})
        return plain_cholqr2(y)

    chebyshev._cholqr2 = observed_cholqr2
    runs = []
    try:
        for spec in args.runs:
            m0, max_passes = (int(v) for v in spec.split(":"))
            grams.clear()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = chebyshev.eigsh_filtered(m0, interval, a,
                                           degree=args.degree,
                                           max_passes=max_passes)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            run = dict(chebyshev.last_run)
            got = np.sort(np.asarray(res.values))
            exact = int(sum(np.min(np.abs(lam[:k] - v)) <= 1e-10
                            for v in got))
            # one CholeskyQR2 a pass, on the filtered (or expanded) block
            for i, p in enumerate(run["passes"]):
                gr = grams[i] if i < len(grams) else {}
                print(f"[{card}] m0 {m0} pass {i}: {p['kind']}, "
                      f"{p['s']:.4f} s, {p['m_found']} inside, epsout "
                      f"{p['epsout']:.3e}; block condition "
                      f"{gr.get('cond', float('nan')):.3e}, shifted "
                      f"fallback {gr.get('fallback')}", flush=True)
                p.update(gr)
            row = {"grid": g, "pairs": k, "m0": m0, "max_passes": max_passes,
                   "degree": run["degree"], "lam_ub": run["lam_ub"],
                   "info": res.info, "n_found": res.n_found,
                   "exact_within_1e-10": exact, "epsout": res.epsout,
                   "passes": run["passes"], "wall_s": wall,
                   "fallbacks": sum(gr["fallback"] for gr in grams)}
            runs.append(row)
            print(f"[{card}] {g}^2, {k} lowest, m0 {m0}, degree "
                  f"{row['degree']}: info {res.info}, {res.n_found} found, "
                  f"{exact} of them within 1e-10 of the analytic values, "
                  f"epsout {res.epsout:.3e}, {res.iterations} passes in "
                  f"{wall:.3f} s, {row['fallbacks']} shifted-Cholesky "
                  f"fallbacks", flush=True)
            del res
    finally:
        chebyshev._cholqr2 = plain_cholqr2
    line = json.dumps({"chebyshev_probe": runs, "card": card})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
