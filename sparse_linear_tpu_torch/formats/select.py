"""Automatic fast-format selection.

Counterpart of :mod:`sparse_linear_tpu.formats.select`, with its rule: a
pattern on at most ``max_diags`` distinct diagonals (a stencil) goes to DIA,
any other pattern to WELL.  The diagonals are counted with ``torch.unique``
on the matrix's device.  ELL and BSR are not ported yet (ROADMAP.md queue 1
item 6), and the rule never names them.
"""

from __future__ import annotations

import torch

from sparse_linear_tpu_torch.formats.structured import csr_to_dia
from sparse_linear_tpu_torch.formats.well import csr_to_well
from sparse_linear_tpu_torch.ops.build import trim

__all__ = ["to_fast_format", "recommend_format"]


def recommend_format(mat, max_diags: int = 32,
                     ell_slack: float = 2.0) -> str:
    """Inspect the pattern and name the best structured format: ``"dia"``
    or ``"well"``.  ``ell_slack`` is accepted for the JAX signature, which
    does not read it either."""
    mat = trim(mat.tocsr())
    if mat.nnz == 0:
        return "dia"
    diff = mat.indices.to(torch.int64) - mat.row_ids().to(torch.int64)
    ndiags = int(torch.unique(diff).shape[0])
    return "dia" if ndiags <= max_diags else "well"


def to_fast_format(mat, **opts):
    """Convert to the recommended structured format, on the matrix's
    device."""
    kind = recommend_format(mat, **opts)
    mat = mat.tocsr()
    if kind == "dia":
        return csr_to_dia(mat, max_diags=2 ** 31)
    return csr_to_well(mat)
