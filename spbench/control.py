#!/usr/bin/env python3
"""Run a cell's control: the port in the precision below the one the
configuration states (float32 operator and solves; complex64 contour
factors), judged by the same reference and limits, on several seeds in
one process.  Each run must come out not correct; the benchmark's own runs
never run it.

    python3 spbench/control.py --workload cg-grid --seconds 10 --seeds 11 12 13

Prints one JSON line a seed: the seed, ``correct``, the requests and each
number compared beside its limit.
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    import argparse

    sys.path.insert(0, str(ROOT))
    from spbench import harness

    ap = argparse.ArgumentParser(prog="spbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        res = harness.run_cell(ROOT, args.workload, seed, args.seconds,
                               False, "cuda:0", control=True)
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "attempted": res["attempted"],
                          "failed": res["failed"], "checks": res["checks"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
