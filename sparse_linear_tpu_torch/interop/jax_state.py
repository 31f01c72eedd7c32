"""Carry matrices between the JAX package and the port as numpy arrays.

A JAX format's leaves (``np.asarray(a.data)``, ``a.offsets``, ``a.shape``,
``indptr``/``indices``/``data``, ``row``/``col``) go in as host arrays and
come out as the port's format on ``device`` (by default the card), and
back.  Only numpy arrays cross, so this module never imports JAX.

``from_arrays(*to_arrays(m), device=...)`` rebuilds ``m``.  Kinds
``"ell"`` (``cols``, ``vals``), ``"bsr"`` (``indptr``, ``indices``,
``blocks``; the block shape is ``blocks.shape[1:]``) and
``"sparse_vector"`` (``indices``, ``data``; the shape is ``(length,)``)
cross both ways like the interchange formats.

Kinds ``"well"`` and ``"well64"`` carry a JAX WELL packing across, one way:
its chunk planes (``bases``, ``idx``, ``vals`` and ``vals_im``, or the
double-float ``vals_lo``) are decoded to triples with numpy, hi + lo summed
in f64, and the port builds its own WELL (or WELL64) from their CSR.  The
two then compute the same y.

Kinds ``"sharded_dia"``, ``"sharded_ell"``, ``"sharded_bsr"`` and
``"sharded_well"`` carry the JAX package's row-sharded packings
(``dist/spmv.py``) onto a port ``dist.mesh.Mesh`` (``from_arrays(...,
mesh=, axis=)``): the stacked numpy arrays, one slice a shard (``data`` of
a sharded DIA whole), with ``col_lo`` and ``xplan`` (None without a window
plan).  ``sharded_well`` decodes each slab's chunk planes as kind
``"well"`` does and repacks it as the port's own WELL on its shard, one
way; the other three cross both ways.

Kinds ``"mf_symbolic"`` and ``"mf_factors"`` carry the direct solver's
artifacts across.  A symbolic artifact travels as its ``perm`` and
``relax`` = (relax_small, relax_frac): the port re-derives the identical
schedule with ``multifrontal.analyze(mat, perm=...)``, so ``from_arrays``
takes the pattern's matrix as ``mat=``.  A factor artifact travels as its
per-bucket blocks, leaves named ``lu.<b>``, ``perm.<b>``, ``g21.<b>`` and
``g12.<b>`` for bucket b, plus ``n_flag``, ``rscale`` (when equilibrated),
``kind`` and ``batch`` (None unless batched); ``from_arrays`` takes the
port's symbolic artifact of the same schedule as ``symbolic=``.  With
these the port's solves run on the JAX package's own factors.
"""

from __future__ import annotations

import numpy as np
import torch

from sparse_linear_tpu_torch.dtypes import default_device, index_dtype
from sparse_linear_tpu_torch.formats.matrix import COO, CSC, CSR, from_triples
from sparse_linear_tpu_torch.formats.sparse_vector import SparseVector
from sparse_linear_tpu_torch.formats.structured import BSR, DIA, ELL
from sparse_linear_tpu_torch.formats.well import csr_to_well
from sparse_linear_tpu_torch.kernels.spmv_well64 import csr_to_well64

__all__ = ["from_arrays", "to_arrays", "KINDS", "MF_BLOCK_LEAVES"]

# leaf names per format kind, in the JAX package's field order
KINDS = {
    "coo": ("row", "col", "data"),
    "csr": ("indptr", "indices", "data"),
    "csc": ("indptr", "indices", "data"),
    "dia": ("data",),
    "ell": ("cols", "vals"),
    "bsr": ("indptr", "indices", "blocks"),
    "sparse_vector": ("indices", "data"),
    # JAX WELL chunk planes; "well" also takes an optional "vals_im"
    "well": ("bases", "idx", "vals"),
    "well64": ("bases", "idx", "vals", "vals_lo"),
    "sharded_dia": ("data",),
    "sharded_ell": ("cols", "vals", "col_lo", "xplan"),
    "sharded_bsr": ("brow", "indices", "blocks", "col_lo", "xplan"),
    # JAX ShardedWELL planes; also takes an optional "vals_im"
    "sharded_well": ("bases", "idx", "vals", "col_lo", "xplan"),
    "mf_symbolic": ("perm", "relax"),
    "mf_factors": ("n_flag", "kind", "batch"),
}
# per-bucket leaves of "mf_factors", named f"{leaf}.{bucket}"
MF_BLOCK_LEAVES = ("lu", "perm", "g21", "g12")
_INDEX_LEAVES = {"row", "col", "indptr", "indices", "cols"}
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


def _mf_factors(arrays, symbolic, device):
    """MFFactors from per-bucket numpy leaves on ``device``."""
    from sparse_linear_tpu_torch.solve.multifrontal import MFFactors

    if symbolic is None:
        raise ValueError("from_arrays('mf_factors'): pass symbolic= (the "
                         "port's analyze of the same pattern and perm)")

    def dev(a):
        return torch.as_tensor(np.array(a), device=device)

    blocks = {}
    for bidx in range(len(symbolic.schedule["flat"])):
        blocks[bidx] = {n: dev(arrays[f"{n}.{bidx}"])
                        for n in MF_BLOCK_LEAVES}
    blocks[-1] = {"n_flag": dev(arrays["n_flag"]).to(torch.int64)}
    if arrays.get("rscale") is not None:
        blocks[-2] = {"rscale": dev(arrays["rscale"])}
    batch = arrays["batch"]
    return MFFactors(symbolic, blocks, blocks[0]["lu"].dtype,
                     kind=str(arrays["kind"]),
                     batch=None if batch is None else int(batch))


def _host(t) -> np.ndarray:
    return t.detach().resolve_conj().cpu().numpy()


def _sharded(kind, arrays, shape, offsets, mesh, axis):
    """The port's row-sharded matrix of a JAX packing on ``mesh[axis]``."""
    from sparse_linear_tpu_torch.dist import spmv as ds

    if mesh is None:
        raise ValueError(f"from_arrays({kind!r}): pass mesh=")
    nr, nc = (int(s) for s in shape)
    if kind == "sharded_dia":
        if offsets is None:
            raise ValueError("from_arrays('sharded_dia'): offsets are "
                             "required")
        dia = DIA(data=torch.as_tensor(np.array(arrays["data"])),
                  shape=(nr, nc), offsets=tuple(int(o) for o in offsets))
        return ds.shard_dia_rows(dia, mesh, axis)
    devices = mesh.shards(axis)
    col_lo, xplan = arrays["col_lo"], arrays["xplan"]
    win = {} if xplan is None else {
        "col_lo": np.asarray(col_lo, dtype=np.int32),
        "xplan": tuple(int(v) for v in xplan)}

    def per_shard(name, dtype=None):
        return [torch.as_tensor(np.array(arrays[name][d]), dtype=dtype,
                                device=dev) for d, dev in enumerate(devices)]

    if kind == "sharded_ell":
        return ds.ShardedELL(cols=per_shard("cols", index_dtype),
                             vals=per_shard("vals"), shape=(nr, nc),
                             axis=axis, mesh=mesh, **win)
    if kind == "sharded_bsr":
        blocks = per_shard("blocks")
        return ds.ShardedBSR(
            brow=per_shard("brow", index_dtype),
            indices=per_shard("indices", index_dtype), blocks=blocks,
            shape=(nr, nc), block_shape=tuple(blocks[0].shape[1:]),
            axis=axis, mesh=mesh, **win)
    rows_local = ds._well_rows_local(nr, len(devices))
    ncl = nc if xplan is None else win["xplan"][5]
    wells = []
    for d, dev in enumerate(devices):
        slab = {n: arrays[n][d] for n in ("bases", "idx", "vals")}
        if arrays.get("vals_im") is not None:
            slab["vals_im"] = arrays["vals_im"][d]
        rows, cols, vals = _well_triples(slab, (rows_local, ncl))
        wells.append(csr_to_well(from_triples(
            (rows_local, ncl), rows, cols, vals, device=dev).tocsr()))
    return ds.ShardedWELL(wells=wells, shape=(nr, nc),
                          c_max=max(w.c_max for w in wells), axis=axis,
                          mesh=mesh, **win)


def from_arrays(kind: str, arrays, shape, offsets=None, *, device=None,
                mat=None, symbolic=None, mesh=None, axis: str = "rows"):
    """The port's ``kind`` format from a mapping of leaf name -> array, on
    ``device``, by default the device of a tensor leaf, else the card.
    ``mat`` (kind ``"mf_symbolic"``), ``symbolic`` (kind ``"mf_factors"``)
    and ``mesh``/``axis`` (the sharded kinds, placed on the mesh's shards)
    are described in the module docstring."""
    if kind == "mf_symbolic":
        device = default_device(device, mat.data if mat is not None
                                else None)
    else:
        device = default_device(device, *arrays.values())
    if kind not in KINDS:
        raise ValueError(f"unknown format kind {kind!r}; one of {sorted(KINDS)}")
    missing = [n for n in KINDS[kind] if n not in arrays]
    if missing:
        raise ValueError(f"from_arrays({kind!r}): missing leaves {missing}")
    if kind == "mf_symbolic":
        from sparse_linear_tpu_torch.solve.multifrontal import analyze

        if mat is None:
            raise ValueError("from_arrays('mf_symbolic'): pass mat= (the "
                             "matrix of the analysed pattern)")
        relax_small, relax_frac = arrays["relax"]
        return analyze(mat.to(device), perm=np.asarray(arrays["perm"]),
                       relax_small=int(relax_small),
                       relax_frac=float(relax_frac))
    if kind == "mf_factors":
        return _mf_factors(arrays, symbolic, device)
    if kind.startswith("sharded_"):
        return _sharded(kind, arrays, shape, offsets, mesh, axis)
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
    if kind == "sparse_vector":
        (length,) = (int(s) for s in shape)
        return SparseVector(**leaves, length=length)
    nr, nc = (int(s) for s in shape)
    if kind == "ell":
        return ELL(**leaves, shape=(nr, nc))
    if kind == "bsr":
        return BSR(**leaves, shape=(nr, nc),
                   block_shape=tuple(int(b) for b in leaves["blocks"].shape[1:]))
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
    """(kind, {leaf: numpy array}, shape, offsets) of a port format or of
    a multifrontal artifact."""
    from sparse_linear_tpu_torch.dist import spmv as ds
    from sparse_linear_tpu_torch.solve.multifrontal import (
        MFFactors,
        MFSymbolic,
    )

    if isinstance(mat, ds.ShardedDIA):
        return ("sharded_dia", {"data": _host(mat.full().data)},
                tuple(mat.shape), mat.offsets)
    if isinstance(mat, (ds.ShardedELL, ds.ShardedBSR)):
        kind = "sharded_" + ("ell" if isinstance(mat, ds.ShardedELL)
                             else "bsr")
        arrays = {n: np.stack([_host(t) for t in getattr(mat, n)])
                  for n in KINDS[kind][:-2]}
        arrays.update(col_lo=mat.col_lo, xplan=mat.xplan)
        return kind, arrays, tuple(mat.shape), None
    if isinstance(mat, MFSymbolic):
        return ("mf_symbolic", {"perm": np.asarray(mat.perm),
                                "relax": mat.relax}, (mat.n, mat.n), None)
    if isinstance(mat, MFFactors):
        arrays = {f"{n}.{bidx}": _host(blk[n])
                  for bidx, blk in mat.blocks.items() if bidx >= 0
                  for n in MF_BLOCK_LEAVES}
        arrays.update(n_flag=_host(mat.blocks[-1]["n_flag"]),
                      kind=mat.kind, batch=mat.batch)
        if mat.row_scale is not None:
            arrays["rscale"] = _host(mat.row_scale)
        return "mf_factors", arrays, (mat.n, mat.n), None
    if isinstance(mat, SparseVector):
        arrays = {n: _host(getattr(mat, n)) for n in KINDS["sparse_vector"]}
        return "sparse_vector", arrays, (mat.length,), None
    if isinstance(mat, DIA):
        kind = "dia"
    elif isinstance(mat, ELL):
        kind = "ell"
    elif isinstance(mat, BSR):
        kind = "bsr"
    elif isinstance(mat, COO):
        kind = "coo"
    elif isinstance(mat, CSR):
        kind = "csr"
    elif isinstance(mat, CSC):
        kind = "csc"
    else:
        raise TypeError(f"to_arrays: unknown format {type(mat).__name__}")
    arrays = {n: _host(getattr(mat, n)) for n in KINDS[kind]}
    offsets = mat.offsets if kind == "dia" else None
    return kind, arrays, tuple(mat.shape), offsets
