#!/usr/bin/env python3
"""Where the device time of one multifrontal factorization goes, on the card.

    python3 tools/torch_direct_profile.py [--grid 1024] [--kind cholesky]
        [--dtype float32] [--out direct_profile.json]

Analyzes the grid**2 Poisson operator of the PyTorch port (nested
dissection), factors it once to build the index maps and warm up, then
factors it again under ``torch.profiler`` and sums the device time of its
kernels by kind: potrf (Cholesky of the pivot blocks), getrf (LU), trsm
(triangular solves), gemm (Schur complements), extend-add scatter
(``index_add_``), gather (``index_select`` and indexing), other.  The idle
share is 1 - (union of the kernels' intervals) / (host wall of the
factorization, synchronised at both ends).  The host-side ``analyze`` runs
under ``cProfile`` first, and its largest functions by own time are
listed (cProfile's per-call cost inflates the Python-heavy ones).  Prints
the card line, a table of the largest kernels and one JSON line, which
``--out`` also keeps.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

KINDS = (("potrf", ("potrf", "getrf_wo_pivot")),
         ("getrf", ("getrf", "getf2", "laswp")),
         ("trsm", ("trsm", "trsv")),
         ("gemm", ("gemm", "xmma", "cutlass")),
         ("extend-add scatter", ("indexfunc",)),
         ("gather", ("indexselect", "index_elementwise", "gather")))


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grid", type=int, default=1024)
    ap.add_argument("--kind", default="cholesky", choices=("cholesky", "lu"))
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("torch_direct_profile: no CUDA device")
    sys.path.insert(0, str(ROOT))
    from sparse_linear_tpu_torch.solve import multifrontal as mf
    from sparse_linear_tpu_torch.utils.grids import poisson_2d

    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    g = args.grid
    a = poisson_2d(g, dtype=getattr(torch, args.dtype), device=dev)
    t0 = time.perf_counter()
    mf.analyze(a, dims=(g, g))
    analyze_s = time.perf_counter() - t0
    prof_host = cProfile.Profile()
    sym = prof_host.runcall(mf.analyze, a, dims=(g, g))
    stats = pstats.Stats(prof_host)
    host_top = sorted(
        ((f"{Path(fn).name}:{line}:{name}", tt, ct)
         for (fn, line, name), (_, _, tt, ct, _) in stats.stats.items()),
        key=lambda r: -r[1])[:12]
    print(f"[{card}] analyze {g}^2: {analyze_s:.3f} s; under cProfile, "
          f"largest own times:", flush=True)
    for where, tt, ct in host_top:
        print(f"  {tt:8.3f} s own {ct:8.3f} s cumulative  {where}")
    mf.factor(a, sym, kind=args.kind)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mf.factor(a, sym, kind=args.kind)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = defaultdict(lambda: [0.0, 0])
    by_kind = defaultdict(float)
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        by_name[e.name][0] += dur
        by_name[e.name][1] += 1
        by_kind[kind_of(e.name)] += dur
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    device_us = sum(by_kind.values())
    print(f"[{card}] factor {g}^2 {args.kind} {args.dtype}: host wall "
          f"{wall_us / 1e3:.3f} ms, kernels {len(kernels)}, device busy "
          f"{busy / 1e3:.3f} ms, idle share {1 - busy / wall_us:.3f}",
          flush=True)
    for name, (us, cnt) in sorted(by_name.items(),
                                  key=lambda kv: -kv[1][0])[:30]:
        print(f"  {us / 1e3:10.3f} ms {cnt:6d}x  [{kind_of(name)}] "
              f"{name[:110]}")
    out = {"card": card, "grid": g, "kind": args.kind, "dtype": args.dtype,
           "buckets": len(sym.schedule["flat"]), "analyze_s": analyze_s,
           "analyze_own_s": {w: tt for w, tt, _ in host_top},
           "wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
           "idle_share": 1 - busy / wall_us, "kernels": len(kernels),
           "device_ms_by_kind": {k: v / 1e3 for k, v in sorted(
               by_kind.items(), key=lambda kv: -kv[1])},
           "share_by_kind": {k: v / device_us for k, v in sorted(
               by_kind.items(), key=lambda kv: -kv[1])}}
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
