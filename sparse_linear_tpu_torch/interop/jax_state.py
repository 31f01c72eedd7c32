"""Carry matrices between the JAX package and the port as numpy arrays.

A JAX format's leaves (``np.asarray(a.data)``, ``a.offsets``, ``a.shape``,
``indptr``/``indices``/``data``, ``row``/``col``) go in as host arrays and
come out as the port's format on ``device`` (by default the card), and
back.  Only numpy arrays cross, so this module never imports JAX.

``from_arrays(*to_arrays(m), device=...)`` rebuilds ``m``.

Kinds ``"well"`` and ``"well64"`` carry a JAX WELL packing across, one way:
its chunk planes (``bases``, ``idx``, ``vals`` and ``vals_im``, or the
double-float ``vals_lo``) are decoded to triples with numpy, hi + lo summed
in f64, and the port builds its own WELL (or WELL64) from their CSR.  The
two then compute the same y.
"""

from __future__ import annotations

import numpy as np
import torch

from sparse_linear_tpu_torch.dtypes import default_device, index_dtype
from sparse_linear_tpu_torch.formats.matrix import COO, CSC, CSR, from_triples
from sparse_linear_tpu_torch.formats.structured import DIA
from sparse_linear_tpu_torch.formats.well import csr_to_well
from sparse_linear_tpu_torch.kernels.spmv_well64 import csr_to_well64

__all__ = ["from_arrays", "to_arrays", "KINDS"]

# leaf names per format kind, in the JAX package's field order
KINDS = {
    "coo": ("row", "col", "data"),
    "csr": ("indptr", "indices", "data"),
    "csc": ("indptr", "indices", "data"),
    "dia": ("data",),
    # JAX WELL chunk planes; "well" also takes an optional "vals_im"
    "well": ("bases", "idx", "vals"),
    "well64": ("bases", "idx", "vals", "vals_lo"),
}
_INDEX_LEAVES = {"row", "col", "indptr", "indices"}
_VREG_ROWS = 1024  # the JAX WELL's output vreg: 8 sublanes x 128 lanes
_LANES = 128


def _well_triples(arrays, shape):
    """(rows, cols, vals) of the entries of a JAX WELL packing: the loop of
    the JAX ``WELL.todense`` over (vreg, chunk), vectorised.  Slot (i, j) of
    chunk c of vreg v holds row ``1024 v + 128 i + j`` and column
    ``128 (bases[v, c] + r) + l``, with ``l = idx & 127`` and the sublane
    ``r`` read from the r' plane at lane l."""
    nr, nc = shape
    bases = np.asarray(arrays["bases"], dtype=np.int64)
    idx = np.asarray(arrays["idx"], dtype=np.int64)
    vals = np.asarray(arrays["vals"])
    if arrays.get("vals_lo") is not None:
        vals = vals.astype(np.float64) + np.asarray(arrays["vals_lo"],
                                                    dtype=np.float64)
    elif arrays.get("vals_im") is not None:
        vals = (vals + 1j * np.asarray(arrays["vals_im"])).astype(
            np.result_type(vals.dtype, np.complex64))
    lane = idx & (_LANES - 1)
    sub = np.take_along_axis(idx >> 7, lane, axis=3)
    cols = (bases[:, :, None, None] + sub) * _LANES + lane
    rows = np.broadcast_to(
        np.arange(bases.shape[0], dtype=np.int64)[:, None, None, None]
        * _VREG_ROWS
        + np.arange(8)[:, None] * _LANES + np.arange(_LANES),
        idx.shape)
    keep = (vals != 0) & (rows < nr) & (cols < nc)
    return rows[keep], cols[keep], vals[keep]


def from_arrays(kind: str, arrays, shape, offsets=None, *, device=None):
    """The port's ``kind`` format from a mapping of leaf name -> array, on
    ``device``, by default the device of a tensor leaf, else the card."""
    device = default_device(device, *arrays.values())
    if kind not in KINDS:
        raise ValueError(f"unknown format kind {kind!r}; one of {sorted(KINDS)}")
    missing = [n for n in KINDS[kind] if n not in arrays]
    if missing:
        raise ValueError(f"from_arrays({kind!r}): missing leaves {missing}")
    if kind in ("well", "well64"):
        shape = tuple(int(s) for s in shape)
        rows, cols, vals = _well_triples(arrays, shape)
        csr = from_triples(shape, rows, cols, vals, device=device).tocsr()
        return csr_to_well64(csr) if kind == "well64" else csr_to_well(csr)
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
