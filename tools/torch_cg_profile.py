#!/usr/bin/env python3
"""Where a CG iteration's device time goes, on the card: the DIA CG of
``chip_smoke.py`` phases 4 and 9 (the grid**2 Poisson operator in f64 and
the gauge-transformed one, complex Hermitian, in c128).

    python3 tools/torch_cg_profile.py [--grid 2048] [--iters 200]
        [--out cg_profile.json]

For each type: CG through ``DIA @ x`` (kernel A) warms up for 20
iterations, then runs ``--iters`` iterations (tolerance 0, so it runs them
all) under ``torch.profiler``.  Device time is summed by kernel name, the
idle share is 1 - (union of the kernels' intervals) / (host wall of the
window, synchronised at both ends), and a row gives each kernel's time
and launches per iteration.  Prints the card line, the tables and one
JSON line, which ``--out`` also keeps.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grid", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("torch_cg_profile: no CUDA device")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    from chip_smoke import THETA, gauge_kron, gauge_phases
    from sparse_linear_tpu_torch.formats.structured import csr_to_dia
    from sparse_linear_tpu_torch.solve.cg import cg
    from sparse_linear_tpu_torch.utils.grids import poisson_2d
    from torch_direct_profile import busy_us

    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    g = args.grid
    gen = torch.Generator(device=dev).manual_seed(0)
    b = torch.randn(g * g, dtype=torch.float64, device=dev, generator=gen)
    cases = {"float64": (poisson_2d(g, dtype=torch.float64, fmt="dia",
                                    device=dev), b),
             "complex128": (csr_to_dia(gauge_kron(g, THETA, dev)),
                            gauge_phases(g, THETA, dev) * b)}
    rows = {}
    for label, (a, rhs) in cases.items():
        cg(a.__matmul__, rhs, tol=0.0, maxiter=20)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = cg(a.__matmul__, rhs, tol=0.0, maxiter=args.iters)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        its = res.iterations
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        by_name = defaultdict(lambda: [0.0, 0])
        for e in kernels:
            by_name[e.name][0] += e.time_range.end - e.time_range.start
            by_name[e.name][1] += 1
        busy = busy_us([(e.time_range.start, e.time_range.end)
                        for e in kernels])
        print(f"[{card}] cg {label} {g}^2 through DIA, {its} iterations: "
              f"{wall_us / its / 1e3:.4f} ms an iteration (host wall), "
              f"device busy {busy / its / 1e3:.4f} ms an iteration, idle "
              f"share {1 - busy / wall_us:.3f}", flush=True)
        table = []
        for name, (us, cnt) in sorted(by_name.items(),
                                      key=lambda kv: -kv[1][0])[:12]:
            table.append({"kernel": name[:120], "ms_per_iteration":
                          us / its / 1e3, "launches_per_iteration":
                          cnt / its})
            print(f"  {us / its / 1e3:8.4f} ms {cnt / its:5.2f}x an "
                  f"iteration  {name[:110]}")
        rows[label] = {"iterations": its,
                       "wall_ms_per_iteration": wall_us / its / 1e3,
                       "busy_ms_per_iteration": busy / its / 1e3,
                       "idle_share": 1 - busy / wall_us, "kernels": table}
        del a, rhs, res
        torch.cuda.empty_cache()
    out = {"card": card, "grid": g, "iters": args.iters, "cg": rows}
    print(json.dumps(out))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
