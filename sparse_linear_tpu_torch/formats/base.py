"""Shared plumbing for the sparse-format dataclasses.

Counterpart of :mod:`sparse_linear_tpu.formats.base`.  Where the JAX package
registers each format as a pytree with static shape metadata, here a format
is a plain frozen dataclass that holds tensors (:func:`tensor_dataclass`),
with a ``.to(device)`` method that moves every tensor field.  PyTorch runs
eagerly, so host-side constructors always produce exact-size canonical
arrays; buffers with padding past the valid entries are still accepted, as
the JAX package's jitted producers emit them.

Indices are int32; sort keys that can exceed 2**31 are int64.
"""

from __future__ import annotations

import dataclasses

import torch

from sparse_linear_tpu_torch.dtypes import index_dtype

__all__ = [
    "tensor_dataclass",
    "TensorFields",
    "expand_indptr",
    "compute_indptr",
]


class TensorFields:
    """``.to(device)`` and ``.device`` for a dataclass whose tensor fields
    all live on one device."""

    def to(self, device):
        moved = {
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }
        return dataclasses.replace(self, **moved)

    @property
    def device(self) -> torch.device:
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                return v.device
        raise TypeError(f"{type(self).__name__} holds no tensor")


def tensor_dataclass(cls):
    """A frozen dataclass without value equality (tensors do not compare to
    a single bool)."""
    return dataclasses.dataclass(frozen=True, eq=False)(cls)


def expand_indptr(indptr: torch.Tensor, nnz: int) -> torch.Tensor:
    """Pointer array -> per-entry segment ids (CSC "decompress").

    Given ``indptr`` of length nseg+1, the k-th entry of the result is the
    segment that entry k belongs to.  Entries at positions >= indptr[-1]
    (padding) receive segment id ``nseg``.
    """
    nseg = indptr.shape[0] - 1
    if nnz == 0:
        return torch.zeros((0,), dtype=index_dtype, device=indptr.device)
    pos = torch.arange(nnz, dtype=indptr.dtype, device=indptr.device)
    ids = torch.searchsorted(indptr, pos, right=True,
                             out_int32=indptr.dtype == torch.int32) - 1
    return ids.clamp_(0, nseg).to(index_dtype)


def compute_indptr(segment_ids: torch.Tensor, nseg: int) -> torch.Tensor:
    """Histogram + exclusive prefix sum => pointer array.

    ``segment_ids`` must be in [0, nseg]; id == nseg counts as padding and
    is excluded from the histogram.
    """
    counts = torch.bincount(segment_ids.to(torch.int64), minlength=nseg + 1)
    indptr = torch.zeros((nseg + 1,), dtype=torch.int64,
                         device=segment_ids.device)
    torch.cumsum(counts[:nseg], 0, out=indptr[1:])
    return indptr.to(index_dtype)
