"""Interchange with host-side ecosystems: scipy.sparse and raw arrays.

Counterpart of :mod:`sparse_linear_tpu.interop.scipy_io`.  Export copies
the canonical arrays to the host; import re-runs normalization (sort +
dedup-by-sum, ``from_triples``) like the reference's ``fromForeign``, on
``device`` (by default the card).

scipy is optional: import errors are raised lazily, only when the scipy
functions are actually used.
"""

from __future__ import annotations

import numpy as np

from sparse_linear_tpu_torch.formats.matrix import COO, CSC, CSR, from_triples
from sparse_linear_tpu_torch.ops.build import trim

__all__ = ["to_scipy", "from_scipy", "to_arrays", "from_arrays"]


def _require_scipy():
    try:
        import scipy.sparse as sp
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "scipy is required for scipy interop; install scipy or use "
            "to_arrays/from_arrays"
        ) from e
    return sp


def _host(t):
    return t.detach().cpu().numpy()


def to_scipy(mat):
    """Export to the matching scipy.sparse class (csr/csc/coo)."""
    sp = _require_scipy()
    if not isinstance(mat, (CSR, CSC, COO)):
        raise TypeError(f"unsupported matrix type: {type(mat)}")
    mat = trim(mat)
    if isinstance(mat, CSR):
        return sp.csr_matrix(
            (_host(mat.data), _host(mat.indices), _host(mat.indptr)),
            shape=mat.shape)
    if isinstance(mat, CSC):
        return sp.csc_matrix(
            (_host(mat.data), _host(mat.indices), _host(mat.indptr)),
            shape=mat.shape)
    return sp.coo_matrix(
        (_host(mat.data), (_host(mat.row), _host(mat.col))), shape=mat.shape)


def from_scipy(sp_mat, fmt: str | None = None, *, device=None):
    """Import any scipy.sparse matrix, re-normalizing (sort + dedup-by-sum).
    ``fmt`` overrides the output format; default mirrors the input
    (csr/csc/coo)."""
    _require_scipy()
    coo = sp_mat.tocoo()
    out = from_triples((int(coo.shape[0]), int(coo.shape[1])),
                       coo.row, coo.col, coo.data, device=device)
    fmt = fmt or getattr(sp_mat, "format", "coo")
    if fmt == "coo":
        return out
    if fmt == "csr":
        return out.tocsr()
    if fmt == "csc":
        return out.tocsc()
    raise ValueError(f"unknown format: {fmt}")


def to_arrays(mat):
    """Export to raw host arrays: {"format", "shape", arrays...}, without a
    scipy dependency."""
    if not isinstance(mat, (CSR, CSC, COO)):
        raise TypeError(f"unsupported matrix type: {type(mat)}")
    mat = trim(mat)
    kind = {CSR: "csr", CSC: "csc", COO: "coo"}[type(mat)]
    names = (("row", "col", "data") if kind == "coo"
             else ("indptr", "indices", "data"))
    out = {"format": kind, "shape": mat.shape}
    out.update((n, _host(getattr(mat, n))) for n in names)
    return out


def from_arrays(d, *, device=None):
    """Inverse of :func:`to_arrays`; re-normalizes on import."""
    fmt = d["format"]
    shape = tuple(d["shape"])
    if fmt == "coo":
        return from_triples(shape, d["row"], d["col"], d["data"],
                            device=device)
    if fmt not in ("csr", "csc"):
        raise ValueError(f"unknown format: {fmt}")
    indptr = np.asarray(d["indptr"])
    major = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    if fmt == "csr":
        return from_triples(shape, major, d["indices"], d["data"],
                            device=device).tocsr()
    return from_triples(shape, d["indices"], major, d["data"],
                        device=device).tocsc()
