#!/usr/bin/env python3
"""Run one cell of the benchmark on the GPU and print its result line.

    python3 spbench/run.py --workload cg-grid --seed 7 --seconds 45 --trace 0

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``, each number compared beside its limit).
Without a CUDA device, or with fewer than the cell asks for, it prints no
result and exits with 1.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    sys.path.insert(0, str(ROOT))
    from spbench import harness

    return harness.main(sys.argv[1:], T_START, ROOT)


if __name__ == "__main__":
    sys.exit(main())
