"""Bytes a sparse product needs, and its share of the card's roofline.

The bytes are counted from the operator and the vectors, not from the
format that implements the product, so a kernel that packs the operator
differently is held to the same work:

* each nonzero's value is read once, and with it its column index where
  the format has to store one (4 bytes: the port's indices are int32;
  a DIA product finds the column from the diagonal's offset);
* x is read once and y is written once.

A share of the roofline is the least time the card could take (these
bytes at the HBM peak of ``peaks.json``; a product of 2 operations a
nonzero is bound by bytes, not by operations) over the measured time.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json")
                   .read_text())
INDEX_BYTES = 4


def spmv_bytes(n_rows: int, n_cols: int, nnz: int, itemsize: int,
               indexed: bool) -> int:
    """Bytes of y = A x: the nonzeros (with their columns if ``indexed``),
    x read once, y written once."""
    per_nonzero = itemsize + (INDEX_BYTES if indexed else 0)
    return nnz * per_nonzero + (n_rows + n_cols) * itemsize


def roofline_pct(nbytes: int, seconds_per_call: float) -> float:
    """Per cent of the HBM roofline that one call reaches."""
    return 100.0 * nbytes / PEAKS["hbm_bytes_per_s"] / seconds_per_call
