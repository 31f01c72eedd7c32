"""Carry matrices between the JAX package and the port as numpy arrays.

A JAX format's leaves (``np.asarray(a.data)``, ``a.offsets``, ``a.shape``,
``indptr``/``indices``/``data``, ``row``/``col``) go in as host arrays and
come out as the port's format on ``device``, and back.  Only numpy arrays
cross, so this module never imports JAX.

``from_arrays(*to_arrays(m), device=...)`` rebuilds ``m``.
"""

from __future__ import annotations

import numpy as np
import torch

from sparse_linear_tpu_torch.dtypes import index_dtype
from sparse_linear_tpu_torch.formats.matrix import COO, CSC, CSR
from sparse_linear_tpu_torch.formats.structured import DIA

__all__ = ["from_arrays", "to_arrays", "KINDS"]

# leaf names per format kind, in the JAX package's field order
KINDS = {
    "coo": ("row", "col", "data"),
    "csr": ("indptr", "indices", "data"),
    "csc": ("indptr", "indices", "data"),
    "dia": ("data",),
}
_INDEX_LEAVES = {"row", "col", "indptr", "indices"}


def from_arrays(kind: str, arrays, shape, offsets=None, *, device="cpu"):
    """The port's ``kind`` format from a mapping of leaf name -> array."""
    if kind not in KINDS:
        raise ValueError(f"unknown format kind {kind!r}; one of {sorted(KINDS)}")
    missing = [n for n in KINDS[kind] if n not in arrays]
    if missing:
        raise ValueError(f"from_arrays({kind!r}): missing leaves {missing}")
    leaves = {
        n: torch.as_tensor(
            np.array(arrays[n]),  # a copy: JAX hands out read-only views
            dtype=index_dtype if n in _INDEX_LEAVES else None,
            device=device,
        )
        for n in KINDS[kind]
    }
    nr, nc = (int(s) for s in shape)
    if kind == "dia":
        if offsets is None:
            raise ValueError("from_arrays('dia'): offsets are required")
        return DIA(data=leaves["data"], shape=(nr, nc),
                   offsets=tuple(int(o) for o in offsets))
    if kind == "coo":
        # sentinel padding (row == nrows) means the valid count is unknown
        padded = bool((leaves["row"] >= nr).any())
        return COO(**leaves, shape=(nr, nc),
                   nnz=None if padded else int(leaves["row"].shape[0]))
    cls = CSR if kind == "csr" else CSC
    return cls(**leaves, shape=(nr, nc))


def to_arrays(mat):
    """(kind, {leaf: numpy array}, shape, offsets) of a port format."""
    if isinstance(mat, DIA):
        kind = "dia"
    elif isinstance(mat, COO):
        kind = "coo"
    elif isinstance(mat, CSR):
        kind = "csr"
    elif isinstance(mat, CSC):
        kind = "csc"
    else:
        raise TypeError(f"to_arrays: unknown format {type(mat).__name__}")
    arrays = {n: getattr(mat, n).cpu().numpy() for n in KINDS[kind]}
    offsets = mat.offsets if kind == "dia" else None
    return kind, arrays, tuple(mat.shape), offsets
