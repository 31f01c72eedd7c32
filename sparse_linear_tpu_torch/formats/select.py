"""Automatic fast-format selection.

Counterpart of :mod:`sparse_linear_tpu.formats.select`, with its rule: a
pattern on at most ``max_diags`` distinct diagonals (a stencil) goes to DIA,
any other pattern to WELL, real or complex alike.  The diagonals are
counted with ``torch.unique`` on the matrix's device.  ``to_fast_format``
keeps the JAX function's branches for ELL and BSR, which the rule never
names, as the JAX rule does not.

``to_fast_format(mat)`` returns an equivalent structured matrix whose ``@``
runs the corresponding kernel: on the card, kernel A (DIA) or kernel C
(WELL), in float32, float64, complex64 or complex128.
"""

from __future__ import annotations

import torch

from sparse_linear_tpu_torch.formats.structured import (
    csr_to_bsr,
    csr_to_dia,
    csr_to_ell,
)
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
    if kind == "well":
        return csr_to_well(mat)
    if kind == "ell":
        return csr_to_ell(mat)
    return csr_to_bsr(mat, block_shape=(8, 128))
