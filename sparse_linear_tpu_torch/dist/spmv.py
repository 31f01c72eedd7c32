"""Multi-device SpMV: row-partitioned matrices over a :class:`.mesh.Mesh`.

Counterpart of :mod:`sparse_linear_tpu.dist.spmv`, with the same names.
Rows of the matrix (and of y) are cut into one slab a shard along a mesh
axis; x lives in one segment a shard and is exchanged with the collectives
of :mod:`.collectives`, then each shard runs the single-device product on
its slab:

* **DIA** (:func:`shard_dia_rows`, :func:`dia_spmv_sharded`): ``"halo"``
  ships each shard's boundary segments to its two ring neighbours (O(halo)
  traffic; the JAX rule falls back to ``"allgather"`` when the band is
  wider than a slab), ``"allgather"`` gathers the whole x on every shard;
  either way one concatenation a shard builds its x.
  The local product is **kernel A** (``kernels.spmv_dia.dia_spmv_kernel``;
  its plain version on CPU tensors), where the JAX package runs a plain
  XLA loop (``_local_dia_spmv``): shard d's slab is a rectangular DIA over
  the halo-extended or the gathered x, built once by
  :func:`shard_dia_rows`.  Every row sums its diagonals in the stored order,
  so the result is the unsharded kernel A's, bitwise.
* **ELL, BSR** (:func:`shard_ell_rows`, :func:`shard_bsr_rows`) and
  **WELL** (:func:`shard_well_rows`): any pattern, packed slab by slab on
  the host as the JAX package packs it.  ``exchange="window"`` ships each
  shard only the x interval its rows touch, by ring shifts of the static
  plan :func:`_col_window_plan` (copied from the JAX package, so the plans
  are equal element for element); ``"allgather"`` gathers x; ``"auto"``
  takes the window when it ships fewer elements.  ELL's and BSR's local
  products stay plain PyTorch (XLA forms in the JAX package); WELL's is
  **kernel C** (``kernels.spmv_well.well_spmv``), where the JAX package
  runs its Pallas ``well_spmv`` per shard.  Each WELL slab is the port's
  own sliced ELL, packed once on its shard's device; complex values run
  complex kernel C directly, and a real WELL times a complex x runs the
  real kernel on the real block.

The products return a :class:`.sharded.ShardedVector` (the JAX functions
return a row-sharded array) and take a plain tensor x too (the JAX
functions take a replicated one).  :func:`spmm_sharded` is the multi-RHS
form, on an (n, m) X and a :class:`.sharded.ShardedBlock`, with the same
exchanges on (rows, m) pieces: **kernel A's multi-RHS form**
(``kernels.spmv_dia.dia_spmm_kernel``) a DIA slab, **kernel D**
(``kernels.spmv_well.well_spmm``) a WELL slab, and the plain ELL / BSR
products.  Slabs are launched in shard order from
one process; on one card four shards make four launches of a quarter of the
rows each.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from sparse_linear_tpu_torch.dist.collectives import all_gather, ppermute
from sparse_linear_tpu_torch.dist.sharded import (
    ShardedBlock,
    ShardedDIA,
    ShardedVector,
    split,
)
from sparse_linear_tpu_torch.formats.base import compute_indptr
from sparse_linear_tpu_torch.formats.matrix import CSR
from sparse_linear_tpu_torch.formats.structured import BSR, DIA, ELL

__all__ = [
    "shard_dia_rows", "dia_spmv_sharded",
    "ShardedELL", "ShardedBSR", "shard_ell_rows", "shard_bsr_rows",
    "shard_rows", "spmv_sharded", "spmm_sharded", "ShardedWELL",
    "shard_well_rows", "window_exchange_elements",
]


def _host(t) -> np.ndarray:
    return t.detach().resolve_conj().cpu().numpy()


def _on(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def _segments(x, mesh, axis: str, block: int, n: int, ndim: int = 1) -> list:
    """x as ``mesh[axis]`` segments of ``block`` rows on the shards'
    devices: a ShardedVector (or ShardedBlock) already in that layout as it
    is, any other x (a tensor, numpy, or one in another layout, gathered
    first) split and copied to the shards.  ``ndim``: 1 for a vector, 2 for
    an (n, m) block."""
    devices = mesh.shards(axis)
    if isinstance(x, ShardedVector):
        if (x.length == n and x.blocks == (block,) * len(devices)
                and x.devices == devices):
            return x.pieces
        x = x.full()
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x), device=devices[0])
    if x.ndim != ndim or x.shape[0] != n:
        raise ValueError(f"x of shape {tuple(x.shape)}, expected ({n}"
                         f"{',' if ndim == 1 else ', m'})")
    return split(x, devices, block)


# ---------------------------------------------------------------------- DIA


def shard_dia_rows(dia: DIA, mesh, axis: str = "rows",
                   pad: bool = False) -> ShardedDIA:
    """Place a DIA matrix with its data row-sharded over ``mesh[axis]``:
    each shard's slab, contiguous on its device, and its local operators
    (see :class:`.sharded.ShardedDIA`), built once here.  Rows that the
    shards do not divide raise, as the JAX package's do; with ``pad`` a
    square operator is zero-padded to ceil(n / shards) rows a slab instead
    (its padded rows and columns are zero, so the products of its first n
    rows are the unpadded ones, bitwise)."""
    nr, nc = dia.shape
    n_dev = mesh.shape[axis]
    if nr % n_dev and not (pad and nr == nc):
        raise ValueError(
            f"shard_dia_rows: shape {dia.shape} not divisible by mesh "
            f"axis size {n_dev}")
    n_local = -(-nr // n_dev)
    ncols = max(nc, n_local * n_dev)
    halo = max((abs(o) for o in dia.offsets), default=0)
    full = dia.data
    if n_local * n_dev > nr:
        full = torch.nn.functional.pad(full, (0, n_local * n_dev - nr))
    data = [full[:, d * n_local:(d + 1) * n_local].to(dev, copy=True)
            .contiguous() for d, dev in enumerate(mesh.shards(axis))]
    halo_slabs = None
    if nr == nc and halo <= n_local:
        halo_slabs = [DIA(data=p, shape=(n_local, n_local + 2 * halo),
                          offsets=tuple(o + halo for o in dia.offsets))
                      for p in data]
    gather_slabs = [DIA(data=p, shape=(n_local, ncols),
                        offsets=tuple(o + d * n_local for o in dia.offsets))
                    for d, p in enumerate(data)]
    for slab in gather_slabs + (halo_slabs or []):
        slab.offsets_tensor  # made once, on the slab's device
    return ShardedDIA(data=data, shape=tuple(dia.shape),
                      offsets=tuple(dia.offsets), axis=axis, mesh=mesh,
                      halo=halo, halo_slabs=halo_slabs,
                      gather_slabs=gather_slabs)


def dia_spmv_sharded(dia, x, mesh, axis: str = "rows",
                     exchange: str = "halo") -> ShardedVector:
    """y = A @ x with A row-sharded and x/y sharded over ``mesh[axis]``.

    Matrices with nrows and ncols divisible by the axis size (the halo
    exchange: square ones), or square ones sharded with
    ``shard_dia_rows(pad=True)``.  ``dia`` is a :class:`ShardedDIA` from
    :func:`shard_dia_rows` (an unsharded DIA is sharded first, every call).
    The ring wrap-around at the global edge is harmless: a DIA stores 0 in
    ``data[d, i]`` wherever i + off falls outside the matrix
    (``csr_to_dia``, ``pad_dia``, the grid constructors), so the wrapped x
    values are multiplied by zero.  An (n, m) x, or a ShardedBlock, is the
    multi-RHS product on kernel A's multi-RHS form (:func:`spmm_sharded`)."""
    from sparse_linear_tpu_torch.kernels.spmv_dia import dia_spmm_kernel

    nr, nc = dia.shape
    n_dev = mesh.shape[axis]
    padded = isinstance(dia, ShardedDIA) and dia.n_local * n_dev != nr
    if (nr % n_dev or nc % n_dev) and not padded:
        raise ValueError(
            f"dia_spmv_sharded: shape {dia.shape} not divisible by mesh "
            f"axis size {n_dev}")
    if not isinstance(dia, ShardedDIA):
        dia = shard_dia_rows(dia, mesh, axis)
    elif dia.axis != axis or dia.mesh.key != mesh.key:
        raise ValueError("dia_spmv_sharded: the matrix is sharded over "
                         "another mesh or axis")
    # x's segments: the padded slabs' rows, else ncols / shards
    n_local = dia.n_local if padded else nc // n_dev
    halo = dia.halo
    if exchange == "halo" and halo > n_local:
        exchange = "allgather"
    if exchange not in ("halo", "allgather"):
        raise ValueError(f"unknown exchange strategy: {exchange}")
    if exchange == "halo" and nr != nc:
        raise ValueError("dia_spmv_sharded: the halo exchange needs a "
                         "square matrix")
    block = isinstance(x, ShardedBlock) or getattr(x, "ndim", 1) == 2
    xs = _segments(x, mesh, axis, n_local, nc, 2 if block else 1)
    if exchange == "allgather":
        ys = [dia_spmm_kernel(slab, xf)
              for slab, xf in zip(dia.gather_slabs, all_gather(xs))]
    else:
        if halo == 0:
            x_ext = xs
        else:
            # the ring shifts of the boundary segments (the JAX package's
            # two ppermutes) fused with the concatenation: shard i's
            # extended x is its left neighbour's tail, its own segment and
            # its right neighbour's head, copied into one new tensor on its
            # device (a neighbour on another card is copied over first)
            x_ext = [torch.cat([xs[(i - 1) % n_dev][-halo:].to(p.device),
                                p, xs[(i + 1) % n_dev][:halo].to(p.device)])
                     for i, p in enumerate(xs)]
        ys = [dia_spmm_kernel(slab, xe)
              for slab, xe in zip(dia.halo_slabs, x_ext)]
    return (ShardedBlock if block else ShardedVector)(mesh, axis, ys, nr)


# ------------------------------------------------------------------ generic
# Row-sharded unstructured SpMV (ELL / BSR / WELL shards of any CSR
# pattern), with the per-shard column-window ring exchange of the JAX
# package (sparse_linear_tpu/dist/spmv.py:149-243, copied).


def _col_window_plan(lo, hi, L, ndev, nc_pad, align: int = 1):
    """Static ring-exchange plan for per-device column windows.

    Device d's row slab touches columns [lo[d], hi[d]); x lives sharded in
    ``ndev`` segments of length ``L``.  The plan ships, per device, the tail
    of segment d+j_lo (length ``a``), full segments d+j_lo+1 .. d+j_hi-1,
    and the head of segment d+j_hi (length ``b``) — a contiguous coverage
    from which each device slices its width-``W`` window.  All slice bounds
    are static (identical across devices), so the exchange is j_hi-j_lo
    ring shifts.

    ``align`` forces lo and W to multiples (BSR block width).  Returns a
    dict with the static plan, the final per-device ``lo`` (int32), and
    ``shipped`` — the exchanged elements per device (the all_gather
    alternative ships (ndev-1)*L)."""
    lo = np.asarray(lo, dtype=np.int64).copy()
    hi = np.asarray(hi, dtype=np.int64)
    # slabs with no entries (row padding beyond nr): pin their window to
    # their own segment so they never widen the hop range
    empty = hi <= lo
    lo[empty] = (np.arange(ndev, dtype=np.int64) * L)[empty]
    hi = np.where(empty, lo, hi)
    W = int(max((hi - lo).max(), 1))
    W = -(-W // align) * align
    if W > nc_pad:
        return None
    lo = np.clip(np.minimum(lo, nc_pad - W), 0, None)
    lo = (lo // align) * align
    d = np.arange(ndev, dtype=np.int64)
    j_lo = int((lo // L - d).min())
    j_hi = int(((lo + W - 1) // L - d).max())
    a = int(np.clip(((d + j_lo + 1) * L - lo).max(), 0, L))
    b = int(np.clip((lo + W - (d + j_hi) * L).max(), 0, L))
    shipped = sum(
        (b if j == j_hi else L) - ((L - a) if j == j_lo else 0)
        for j in range(j_lo, j_hi + 1)
        if j != 0 and (b if j == j_hi else L) > ((L - a) if j == j_lo else 0)
    )
    return {
        "plan": (j_lo, j_hi, a, b, L, W),
        "lo": lo.astype(np.int32),
        "shipped": int(shipped),
    }


def _slab_col_ranges(indptr, indices, vals, ndev, rows_per_dev):
    """Per-device [lo, hi) of columns carrying a nonzero in its row slab."""
    lo = np.zeros(ndev, dtype=np.int64)
    hi = np.zeros(ndev, dtype=np.int64)
    nr_pad = ndev * rows_per_dev
    for dd in range(ndev):
        r0, r1 = dd * rows_per_dev, (dd + 1) * rows_per_dev
        s, e = indptr[min(r0, nr_pad)], indptr[min(r1, nr_pad)]
        cix = indices[s:e]
        if vals is not None:
            cix = cix[vals[s:e] != 0]
        if cix.size:
            lo[dd], hi[dd] = int(cix.min()), int(cix.max()) + 1
    return lo, hi


def window_exchange_elements(xplan) -> int:
    """Elements of x shipped per device per SpMV under ``xplan`` (the
    all_gather alternative ships (ndev-1) * L)."""
    j_lo, j_hi, a, b, L, W = xplan
    return sum(
        (b if j == j_hi else L) - ((L - a) if j == j_lo else 0)
        for j in range(j_lo, j_hi + 1)
        if j != 0 and (b if j == j_hi else L) > ((L - a) if j == j_lo else 0)
    )


def _covers(win, lo, hi) -> bool:
    """Whether every nonempty slab's columns [lo, hi) lie inside its window
    [lo_d, lo_d + W).  The JAX plan rounds ``lo`` down to the alignment
    after sizing W, so with ``align`` > 1 a window can end before its
    slab's last column (BSR in (8, 128) blocks on the 1024**2 Poisson
    operator over 4 devices: the JAX product then gathers a clamped block
    and is wrong).  The port keeps the plan as the JAX package computes it
    and does not use one that fails this test."""
    W = win["plan"][5]
    nonempty = hi > lo
    lo_d = win["lo"].astype(np.int64)
    return bool(np.all((lo_d <= lo)[nonempty] & (hi <= lo_d + W)[nonempty]))


def _exchange_cols(segments, col_lo, plan) -> list:
    """Each shard's width-W x window, assembled from the sharded segments
    with the plan's ring shifts (:func:`_col_window_plan`): shard i
    receives the slice of segment (i + j) mod ndev for each hop j != 0 and
    keeps its own for j = 0.  The start inside the coverage is clamped to
    it, as the JAX ``dynamic_slice_in_dim`` clamps."""
    j_lo, j_hi, a, b, L, W = plan
    ndev = len(segments)
    parts: list = [[] for _ in range(ndev)]
    first = None
    for j in range(j_lo, j_hi + 1):
        s = (L - a) if j == j_lo else 0
        e = b if j == j_hi else L
        if e <= s:
            continue
        if first is None:
            first = (j, s)
        sl = [seg[s:e] for seg in segments]
        if j != 0:
            sl = ppermute(sl, [((i + j) % ndev, i) for i in range(ndev)])
        for i in range(ndev):
            parts[i].append(sl[i])
    out = []
    for d in range(ndev):
        cov = parts[d][0] if len(parts[d]) == 1 else torch.cat(parts[d])
        start = int(col_lo[d]) - ((d + first[0]) * L + first[1])
        start = min(max(start, 0), cov.shape[0] - W)
        out.append(cov[start:start + W])
    return out


def _sharded_x(a, x, mesh, ndim: int = 1):
    """Each shard's x (``ndim`` 2: its (rows, m) block): its column window
    under a plan, else the gathered x, from x's segments of
    L = ceil(nc / shards) rows."""
    nr, nc = a.shape
    ndev = mesh.shape[a.axis]
    if a.mesh.key != mesh.key:
        raise ValueError("spmv_sharded: the matrix is sharded over another "
                         "mesh")
    length = x.length if isinstance(x, ShardedVector) else len(x)
    if length != nc:
        raise ValueError(f"spmv_sharded: dimension mismatch {a.shape} @ "
                         f"{(length,)}")
    xs = _segments(x, mesh, a.axis, -(-nc // ndev), nc, ndim)
    if a.xplan is not None:
        return _exchange_cols(xs, a.col_lo, a.xplan)
    return all_gather(xs)


def _host_csr(mat):
    """(indptr, indices, data) of the trimmed CSR as host arrays."""
    from sparse_linear_tpu_torch.ops.build import trim

    csr = trim(mat.tocsr())
    return csr, _host(csr.indptr), _host(csr.indices), _host(csr.data)


def _pad_indptr(indptr, nr_pad):
    if nr_pad + 1 > indptr.size:
        indptr = np.concatenate(
            [indptr, np.full(nr_pad + 1 - indptr.size, indptr[-1],
                             indptr.dtype)])
    return indptr


def _window(indptr, cix, vals, ndev, rows_per_dev, L, nc_pad, exchange,
            name, align=1):
    """The window plan of an ``exchange`` choice, or None (all-gather)."""
    if exchange not in ("auto", "window", "allgather"):
        raise ValueError(f"unknown exchange strategy: {exchange}")
    if exchange == "allgather":
        return None
    lo, hi = _slab_col_ranges(indptr, cix, vals, ndev, rows_per_dev)
    win = _col_window_plan(lo, hi, L, ndev, nc_pad, align=align)
    if win is not None and not _covers(win, lo, hi):
        win = None
    if win is not None and exchange == "auto" and (
            win["shipped"] >= (ndev - 1) * L):
        win = None  # the window ships no less than the all_gather
    if win is None and exchange == "window":
        raise ValueError(f"{name}: no usable window plan")
    return win


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedELL:
    """Row-partitioned ELL: shard d owns rows [d nr_local, (d+1) nr_local).

    ``cols[d]`` / ``vals[d]`` are shard d's (nr_local, K) slabs on its
    device (the JAX package's (ndev, nr_local, K) arrays, one slice a
    shard); padded rows hold (col 0, val 0).  With a column-window plan
    (``xplan``, and ``col_lo`` the (ndev,) int32 window starts) ``cols``
    are WINDOW-LOCAL (global col - col_lo[d])."""

    cols: list
    vals: list
    shape: tuple
    axis: str
    col_lo: np.ndarray | None = None
    xplan: tuple | None = None
    mesh: object = None

    @functools.cached_property
    def local(self) -> list:
        """Each shard's slab as an ELL over its x (the window, or the
        gathered x of ndev * ceil(nc / ndev) entries)."""
        ndev = len(self.cols)
        ncl = (self.xplan[5] if self.xplan is not None
               else -(-self.shape[1] // ndev) * ndev)
        return [ELL(cols=c, vals=v, shape=(int(c.shape[0]), ncl))
                for c, v in zip(self.cols, self.vals)]


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedBSR:
    """Row-partitioned BSR: one block slab a shard, zero-padded to the
    largest shard's block count.  ``brow[d]`` holds the (sorted) local block
    row of every block, ``indices[d]`` its block column (window-local under
    a plan, whose ``col_lo`` is block-aligned), ``blocks[d]`` the (maxnb, bm,
    bn) blocks."""

    brow: list
    indices: list
    blocks: list
    shape: tuple
    block_shape: tuple
    axis: str
    col_lo: np.ndarray | None = None
    xplan: tuple | None = None
    mesh: object = None

    @functools.cached_property
    def local(self) -> list:
        """Each shard's slab as a BSR over its x (the window, or x padded to
        whole blocks)."""
        bm, bn = self.block_shape
        nr, nc = self.shape
        ndev = len(self.brow)
        nbr_local = -(-(-(-nr // bm)) // ndev)
        ncl = (self.xplan[5] if self.xplan is not None
               else -(-nc // bn) * bn)
        return [BSR(indptr=compute_indptr(br, nbr_local), indices=ix,
                    blocks=bl, shape=(nbr_local * bm, ncl),
                    block_shape=(bm, bn))
                for br, ix, bl in zip(self.brow, self.indices, self.blocks)]


def shard_ell_rows(mat, mesh, axis: str = "rows", width: int | None = None,
                   exchange: str = "auto") -> ShardedELL:
    """Partition a CSR matrix's rows over ``mesh[axis]`` as ELL, packed on
    the host as the JAX package packs it, each slab then on its shard.

    ``exchange``: "auto" localizes each slab to its column window and plans
    the ring exchange when it ships fewer elements than the all_gather;
    "allgather" / "window" pin a strategy."""
    csr, indptr, cix, vals = _host_csr(mat)
    nr, nc = csr.shape
    ndev = mesh.shape[axis]
    nr_local = -(-nr // ndev)
    nr_pad = nr_local * ndev
    indptr = _pad_indptr(indptr, nr_pad)
    row_nnz = np.diff(indptr)
    k = int(row_nnz.max()) if width is None else int(width)
    k = max(k, 1)
    if row_nnz.max() > k:
        raise ValueError(
            f"shard_ell_rows: max row nnz {int(row_nnz.max())} exceeds "
            f"width {k}")
    nc_pad = -(-nc // ndev) * ndev
    win = _window(indptr, cix, vals, ndev, nr_local, nc_pad // ndev, nc_pad,
                  exchange, "shard_ell_rows")
    cols = np.zeros((nr_pad, k), dtype=np.int32)
    vs = np.zeros((nr_pad, k), dtype=vals.dtype)
    pos = np.arange(len(cix)) - np.repeat(indptr[:-1], row_nnz)
    rows = np.repeat(np.arange(nr_pad), row_nnz)
    cols[rows, pos] = cix
    vs[rows, pos] = vals
    if win is not None:
        # window-local columns; padding slots (val 0) clamp to 0
        lo_per_row = np.repeat(win["lo"], nr_local)[:, None]
        cols = np.maximum(cols - lo_per_row, 0).astype(np.int32)
    devices = mesh.shards(axis)
    cols = cols.reshape(ndev, nr_local, k)
    vs = vs.reshape(ndev, nr_local, k)
    return ShardedELL(
        cols=[_on(cols[d], dev) for d, dev in enumerate(devices)],
        vals=[_on(vs[d], dev) for d, dev in enumerate(devices)],
        shape=(nr, nc), axis=axis,
        col_lo=None if win is None else win["lo"],
        xplan=None if win is None else win["plan"], mesh=mesh)


def shard_bsr_rows(mat, mesh, axis: str = "rows", block_shape=(8, 128),
                   exchange: str = "auto") -> ShardedBSR:
    """Partition a CSR matrix's rows over ``mesh[axis]`` as BSR, packed on
    the host as the JAX package packs it.  ``exchange`` as in
    :func:`shard_ell_rows` (window plans are block-column aligned)."""
    csr, indptr, cix, vals = _host_csr(mat)
    nr, nc = csr.shape
    bm, bn = block_shape
    ndev = mesh.shape[axis]
    # pad the block-row grid so every device owns the same slab height
    nbr_local = -(-(-(-nr // bm)) // ndev)
    nr_pad = nbr_local * ndev * bm
    nc_pad = -(-nc // bn) * bn
    indptr = _pad_indptr(indptr, nr_pad)
    # the exchange works on the x-shard grid (ceil(nc / ndev) segments);
    # block alignment keeps window-local block columns exact
    ncs_pad = -(-nc // ndev) * ndev
    win = _window(indptr, cix, vals, ndev, nbr_local * bm, ncs_pad // ndev,
                  ncs_pad, exchange, "shard_bsr_rows", align=bn)
    rows = np.repeat(np.arange(nr_pad), np.diff(indptr))
    br, bc = rows // bm, cix // bn
    dev = br // nbr_local
    nbc = nc_pad // bn
    key = (dev.astype(np.int64) * (nr_pad // bm) + br) * nbc + bc
    uniq, inv = np.unique(key, return_inverse=True)
    blocks_flat = np.zeros((uniq.size, bm, bn), dtype=vals.dtype)
    np.add.at(blocks_flat, (inv, rows % bm, cix % bn), vals)
    u_dev = (uniq // nbc) // (nr_pad // bm)
    u_brow_local = (uniq // nbc) % (nr_pad // bm) % nbr_local
    u_bc = (uniq % nbc).astype(np.int32)
    counts = np.bincount(u_dev, minlength=ndev)
    maxnb = max(int(counts.max()), 1)
    brow = np.full((ndev, maxnb), nbr_local - 1, dtype=np.int32)
    indices = np.zeros((ndev, maxnb), dtype=np.int32)
    blocks = np.zeros((ndev, maxnb, bm, bn), dtype=vals.dtype)
    # uniq is sorted by (dev, brow, bcol): per-device runs are contiguous
    # and brow stays nondecreasing after the split
    starts = np.concatenate([[0], np.cumsum(counts)])
    for d in range(ndev):
        s, e = starts[d], starts[d + 1]
        m = e - s
        brow[d, :m] = u_brow_local[s:e]
        # padding keeps brow nondecreasing: pad value is the max block row
        if m:
            brow[d, m:] = max(nbr_local - 1, int(u_brow_local[e - 1]))
        indices[d, :m] = u_bc[s:e]
        if win is not None:
            indices[d, :m] -= np.int32(win["lo"][d] // bn)
        blocks[d, :m] = blocks_flat[s:e]
    devices = mesh.shards(axis)
    return ShardedBSR(
        brow=[_on(brow[d], dv) for d, dv in enumerate(devices)],
        indices=[_on(indices[d], dv) for d, dv in enumerate(devices)],
        blocks=[_on(blocks[d], dv) for d, dv in enumerate(devices)],
        shape=(nr, nc), block_shape=(int(bm), int(bn)), axis=axis,
        col_lo=None if win is None else win["lo"],
        xplan=None if win is None else win["plan"], mesh=mesh)


# --------------------------------------------------------------------- WELL


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedWELL:
    """Row-partitioned WELL: ``wells[d]`` is shard d's slab packed as the
    port's sliced ELL (``formats.well.WELL``) on its device, of shape
    (rows_local, W) over its column window under a plan (``xplan``,
    ``col_lo``), else (rows_local, ncols).  ``rows_local`` is a whole
    multiple of 1024 rows, the JAX package's slab height, so that the
    window plans are the JAX package's.  ``c_max`` is the widest slab's
    slots a row."""

    wells: list
    shape: tuple
    c_max: int
    axis: str
    col_lo: np.ndarray | None = None
    xplan: tuple | None = None
    mesh: object = None


def _well_rows_local(nr: int, ndev: int) -> int:
    return max(-(-(-(-nr // 1024)) // ndev), 1) * 1024


def shard_well_rows(mat, mesh, axis: str = "rows",
                    exchange: str = "auto") -> ShardedWELL:
    """Partition a CSR matrix's rows over ``mesh[axis]``, packing each slab
    as WELL on its shard's device.  Slab heights are multiples of 1024 rows
    (the JAX package's vreg granularity, kept so that the plans match).
    ``exchange`` as in :func:`shard_ell_rows`; the window ignores entries
    whose value is zero, as the JAX package's does."""
    from sparse_linear_tpu_torch.formats.well import csr_to_well

    csr, indptr, cix, data = _host_csr(mat)
    nr, nc = csr.shape
    ndev = mesh.shape[axis]
    rows_local = _well_rows_local(nr, ndev)
    nc_pad = -(-nc // ndev) * ndev
    win = _window(_pad_indptr(indptr, ndev * rows_local), cix, np.abs(data),
                  ndev, rows_local, nc_pad // ndev, nc_pad, exchange,
                  "shard_well_rows")
    ncl = nc if win is None else win["plan"][5]
    wells = []
    for d, dev in enumerate(mesh.shards(axis)):
        r0 = min(d * rows_local, nr)
        r1 = min(r0 + rows_local, nr)
        # the slab's rows of the CSR on the matrix's device: pointers
        # rebased and padded with empty rows, columns window-local
        lp = csr.indptr[r0:r1 + 1].to(torch.int64)
        s, e = int(indptr[r0]), int(indptr[r1])
        lp = torch.cat([lp - s, torch.full((rows_local - (r1 - r0),), e - s,
                                           dtype=torch.int64,
                                           device=lp.device)])
        six = csr.indices[s:e]
        if win is not None:
            six = torch.clamp_min(six - int(win["lo"][d]), 0)
        local = CSR(indptr=lp.to(csr.indptr.dtype), indices=six,
                    data=csr.data[s:e], shape=(rows_local, ncl))
        wells.append(csr_to_well(local.to(dev)))
    return ShardedWELL(
        wells=wells, shape=(nr, nc), c_max=max(w.c_max for w in wells),
        axis=axis, col_lo=None if win is None else win["lo"],
        xplan=None if win is None else win["plan"], mesh=mesh)


# ------------------------------------------------------------ entry points


def shard_rows(mat, mesh, axis: str = "rows", fmt: str = "auto", **kw):
    """Partition any CSR/COO/CSC matrix's rows over a mesh axis.

    fmt: "dia" | "ell" | "bsr" | "well" | "auto" (the port's
    ``formats.select.recommend_format`` picks the local format)."""
    csr = mat.tocsr()
    if fmt == "auto":
        from sparse_linear_tpu_torch.formats.select import recommend_format

        fmt = recommend_format(csr)
        if fmt not in ("dia", "ell", "bsr", "well"):
            fmt = "ell"
    if fmt == "dia":
        from sparse_linear_tpu_torch.formats.structured import csr_to_dia

        return shard_dia_rows(csr_to_dia(csr), mesh, axis)
    if fmt == "well":
        return shard_well_rows(csr, mesh, axis, **kw)
    if fmt == "ell":
        return shard_ell_rows(csr, mesh, axis, **kw)
    if fmt == "bsr":
        return shard_bsr_rows(csr, mesh, axis, **kw)
    raise ValueError(f"unknown fmt: {fmt}")


def spmv_sharded(a, x, mesh) -> ShardedVector:
    """y = A @ x for a row-sharded matrix; y comes back sharded over the
    same axis, in the layout of :meth:`.ShardedVector.from_tensor`
    (ceil(nrows / shards) entries a shard), so that it adds to vectors
    split that way.  x may be a plain tensor (split over the shards here)
    or a ShardedVector."""
    from sparse_linear_tpu_torch.kernels.spmv import bsr_spmv, ell_spmv
    from sparse_linear_tpu_torch.kernels.spmv_well import well_spmv

    if isinstance(a, (DIA, ShardedDIA)):
        return dia_spmv_sharded(a, x, mesh,
                                a.axis if isinstance(a, ShardedDIA)
                                else "rows")
    if not isinstance(a, (ShardedELL, ShardedBSR, ShardedWELL)):
        raise TypeError(f"spmv_sharded: unsupported type {type(a)}")
    nr, nc = a.shape
    xw = _sharded_x(a, x, mesh)
    if isinstance(a, ShardedWELL):
        ncl = a.xplan[5] if a.xplan is not None else nc
        ys = [well_spmv(w, xd[:ncl]) for w, xd in zip(a.wells, xw)]
    elif isinstance(a, ShardedELL):
        ys = [ell_spmv(loc, xd) for loc, xd in zip(a.local, xw)]
    else:
        # the gathered x is cut to ncols and padded to whole blocks; a
        # window is block-aligned already
        ncl = a.local[0].shape[1]
        cut = nc if a.xplan is None else ncl
        ys = [bsr_spmv(loc, _padded(xd[:cut], ncl))
              for loc, xd in zip(a.local, xw)]
    return ShardedVector(mesh, a.axis, _recut(ys, -(-nr // len(ys)), nr), nr)


def spmm_sharded(a, x, mesh) -> ShardedBlock:
    """Y = A @ X for a row-sharded matrix and an (n, m) X: the multi-RHS
    form of :func:`spmv_sharded`, with the same exchanges on (rows, m)
    pieces.  Y comes back as a :class:`.sharded.ShardedBlock` in the layout
    of :meth:`.ShardedBlock.from_tensor` (for a padded DIA, its slabs').
    X may be a plain (n, m) tensor or a ShardedBlock.  Each DIA slab runs
    kernel A's multi-RHS form on its halo-extended (or gathered) block, each
    WELL slab kernel D on its window (or the gathered block); ELL and BSR
    run their plain products."""
    from sparse_linear_tpu_torch.kernels.spmv import bsr_spmm
    from sparse_linear_tpu_torch.kernels.spmv_well import well_spmm

    if isinstance(a, (DIA, ShardedDIA)):
        if not (isinstance(x, ShardedBlock) or getattr(x, "ndim", 0) == 2):
            raise ValueError("spmm_sharded: X must be (n, m)")
        return dia_spmv_sharded(a, x, mesh,
                                a.axis if isinstance(a, ShardedDIA)
                                else "rows")
    if not isinstance(a, (ShardedELL, ShardedBSR, ShardedWELL)):
        raise TypeError(f"spmm_sharded: unsupported type {type(a)}")
    nr, nc = a.shape
    xw = _sharded_x(a, x, mesh, ndim=2)
    if isinstance(a, ShardedWELL):
        ncl = a.xplan[5] if a.xplan is not None else nc
        ys = [well_spmm(w, xd[:ncl]) for w, xd in zip(a.wells, xw)]
    elif isinstance(a, ShardedELL):
        ys = [(loc.vals[..., None] * xd[loc.cols.long()]).sum(dim=1)
              for loc, xd in zip(a.local, xw)]
    else:
        ncl = a.local[0].shape[1]
        cut = nc if a.xplan is None else ncl
        ys = [bsr_spmm(loc, _padded(xd[:cut], ncl))
              for loc, xd in zip(a.local, xw)]
    return ShardedBlock(mesh, a.axis, _recut(ys, -(-nr // len(ys)), nr), nr)


def _recut(ys: list, block: int, n: int) -> list:
    """The slabs' outputs ``ys`` (rows_local rows each: WELL's 1024-row
    and BSR's whole-block slab heights) re-cut into pieces of ``block``
    rows on the same devices, the first ``n`` rows kept and the rest
    zero.  Slabs already ``block`` long are returned as they are."""
    rows = ys[0].shape[0]
    if rows == block:
        return ys
    out = []
    for i, dev in enumerate(y.device for y in ys):
        lo, hi = min(i * block, n), min((i + 1) * block, n)
        p = torch.zeros((block,) + tuple(ys[0].shape[1:]), dtype=ys[0].dtype,
                        device=dev)
        for d in range(lo // rows, -(-hi // rows)):
            s, e = max(lo, d * rows), min(hi, (d + 1) * rows)
            p[s - lo:e - lo] = ys[d][s - d * rows:e - d * rows].to(dev)
        out.append(p)
    return out


def _padded(x: torch.Tensor, n: int) -> torch.Tensor:
    """x cut or zero-padded to n rows (the gathered x to whole blocks)."""
    if x.shape[0] >= n:
        return x[:n]
    return torch.nn.functional.pad(
        x, (0, 0) * (x.ndim - 1) + (0, n - x.shape[0]))
