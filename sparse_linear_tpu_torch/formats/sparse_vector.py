"""Sparse vector format.

Counterpart of :mod:`sparse_linear_tpu.formats.sparse_vector`, the
reference's ``Data.Vector.Sparse``: a length, sorted unique int32 indices,
and values, as a frozen dataclass of tensors on one device.  Every
operation runs on the vector's device.

Semantics kept from the JAX package:
  * ``from_pairs`` deduplicates by summation, with the same error texts;
  * ``+`` / ``-`` / elementwise ``*`` go through the generalized linear
    combination ``glin`` over the union pattern (a position either operand
    stores stays, even where the fold gives zero);
  * concatenation is the **direct sum**: the right operand's indices are
    offset by the left length (the reference Monoid), not elementwise
    addition.
"""

from __future__ import annotations

import numpy as np
import torch

from sparse_linear_tpu_torch.dtypes import (
    as_torch_dtype,
    conj as _conj,
    default_device,
    index_dtype,
)
from sparse_linear_tpu_torch.formats.base import TensorFields, tensor_dataclass

__all__ = ["SparseVector", "from_pairs", "glin", "lin", "concat"]


@tensor_dataclass
class SparseVector(TensorFields):
    indices: torch.Tensor  # (nnz,) int32, sorted, unique
    data: torch.Tensor     # (nnz,)
    length: int

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    def todense(self):
        out = torch.zeros((self.length,), dtype=self.data.dtype,
                          device=self.data.device)
        return out.index_add_(0, self.indices.long(), self.data)

    def map_values(self, f):
        """Reference ``cmap``."""
        return SparseVector(indices=self.indices, data=f(self.data),
                            length=self.length)

    def conj(self):
        return self.map_values(_conj)

    def to_pairs(self):
        """Nonzero iteration as host pairs (reference ``iforM_``)."""
        return list(zip(self.indices.tolist(),
                        self.data.resolve_conj().tolist()))

    # -- algebra (reference Num instance) -----------------------------------

    def __add__(self, other):
        return glin(0, lambda c, a: c + a, self, lambda c, b: c + b, other)

    def __sub__(self, other):
        return glin(0, lambda c, a: c + a, self, lambda c, b: c - b, other)

    def __mul__(self, other):
        if isinstance(other, SparseVector):
            # reference semantics: scatter A with (+), then fold B with (*)
            # over the union pattern
            return glin(0, lambda c, a: c + a, self, lambda c, b: c * b,
                        other)
        return self.map_values(lambda v: v * other)

    def __rmul__(self, other):
        return self.map_values(lambda v: other * v)

    def __neg__(self):
        return self.map_values(torch.negative)


def _as_tensor(x, device, dtype=None):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def from_pairs(length: int, indices, values, dtype=None, *, device=None):
    """Build from (index, value) pairs, summing duplicates (reference
    ``fromPairs``), on ``device``: by default the device of a tensor
    argument, else the card.  Duplicates are summed in index order, on the
    CPU in input order as the JAX package's ``np.add.at``."""
    from sparse_linear_tpu_torch.ops.build import _sort_dedup

    device = default_device(device, indices, values)
    indices = _as_tensor(indices, device)
    values = _as_tensor(values, device,
                        None if dtype is None else as_torch_dtype(dtype))
    if indices.shape != values.shape or indices.ndim != 1:
        raise ValueError("indices and values must be 1-D of equal length")
    bad = torch.nonzero((indices < 0) | (indices >= length))
    if bad.shape[0]:
        b = int(bad[0, 0])
        raise ValueError(
            f"index out of bounds at position {b}: "
            f"{int(indices[b])} not in [0, {length})"
        )
    zeros = torch.zeros_like(indices)
    _, idx, data = _sort_dedup(zeros, indices, values, 1, int(length))
    return SparseVector(indices=idx, data=data, length=int(length))


def glin(c0, add_a, a: SparseVector, add_b, b: SparseVector):
    """Generalized combination over the union pattern, with the reference's
    fold semantics (``glin``): a workspace initialized to ``c0``, entries of
    ``a`` folded in with ``c := add_a(c, av)``, then entries of ``b`` with
    ``c := add_b(c, bv)``; the union pattern is kept."""
    if a.length != b.length:
        raise ValueError(f"length mismatch: {a.length} != {b.length}")
    union = torch.unique(torch.cat([a.indices, b.indices]), sorted=True)
    dtype = torch.promote_types(a.data.dtype, b.data.dtype)
    c = torch.full(union.shape, c0, dtype=dtype, device=union.device)
    for vec, add in ((a, add_a), (b, add_b)):
        pos = torch.searchsorted(union, vec.indices)
        occ = torch.zeros(union.shape, dtype=torch.bool, device=union.device)
        occ[pos] = True
        val = torch.zeros(union.shape, dtype=vec.data.dtype,
                          device=union.device)
        val[pos] = vec.data
        new = add(c, val)
        c = torch.where(occ, new, c.to(new.dtype))
    return SparseVector(indices=union.to(index_dtype), data=c,
                        length=a.length)


def lin(alpha, a: SparseVector, beta, b: SparseVector):
    """alpha*a + beta*b (reference ``lin``)."""
    return glin(
        0, lambda c, x: c + alpha * x, a, lambda c, y: c + beta * y, b
    )


def concat(a: SparseVector, b: SparseVector):
    """Direct-sum concatenation (the reference Monoid): indices of ``b`` are
    offset by ``a.length``."""
    return SparseVector(
        indices=torch.cat([a.indices,
                           (b.indices + a.length).to(a.indices.dtype)]),
        data=torch.cat([a.data, b.data]),
        length=a.length + b.length,
    )
