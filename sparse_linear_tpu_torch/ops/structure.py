"""Structural algebra: concatenation, block assembly, Kronecker products.

Counterpart of :mod:`sparse_linear_tpu.ops.structure`, with its names,
size inference and error texts (reference: sparse-linear/src/Data/Matrix/
Sparse.hs: ``hcat`` :500-521, ``vcat`` :523-557, ``fromBlocks`` :559-585,
``fromBlocksDiag`` :587-595 (cyclic), ``kronecker`` :597-638, ``takeDiag``
:640-650, ``blockDiag`` :661-667, ``outer`` :331-355, ``subMatrix``
:704-729, whose intent, contiguous block extraction, is what is
implemented).

Every function runs on its operands' device with tensor ops and returns
exact-size canonical matrices.  ``kron`` builds the 2D Poisson operator and
its complex gauge-transformed form on the card from 1D factors.
"""

from __future__ import annotations

import torch

from sparse_linear_tpu_torch.dtypes import index_dtype
from sparse_linear_tpu_torch.formats.matrix import COO, CSC, CSR, zeros
from sparse_linear_tpu_torch.formats.sparse_vector import SparseVector
from sparse_linear_tpu_torch.ops.build import coo_to_csr, trim

__all__ = [
    "to_columns",
    "from_columns",
    "to_rows",
    "from_rows",
    "vcat",
    "hcat",
    "from_blocks",
    "from_blocks_diag",
    "block_diag",
    "kron",
    "take_diag",
    "outer",
    "submatrix",
]


def vcat(mats):
    """Vertical concatenation (reference ``vcat``/``vjoin``).  Returns
    CSR."""
    mats = [m.tocsr() for m in mats]
    if not mats:
        raise ValueError("vcat: empty list")
    nc = mats[0].shape[1]
    for m in mats:
        if m.shape[1] != nc:
            raise ValueError(
                f"vcat: column count mismatch: {m.shape[1]} != {nc}"
            )
    mats = [trim(m) for m in mats]
    indptrs = [mats[0].indptr.to(torch.int64)]
    offset = mats[0].nnz
    for m in mats[1:]:
        indptrs.append(m.indptr[1:].to(torch.int64) + offset)
        offset += m.nnz
    return CSR(
        indptr=torch.cat(indptrs).to(index_dtype),
        indices=torch.cat([m.indices for m in mats]),
        data=torch.cat([m.data for m in mats]),
        shape=(sum(m.shape[0] for m in mats), nc),
    )


def hcat(mats):
    """Horizontal concatenation (reference ``hcat``/``hjoin``).  Returns
    CSC."""
    return vcat([m.tocsc().T for m in mats]).T


def from_blocks(rows):
    """Block assembly from a grid of ``Matrix | None`` (reference
    ``fromBlocks``), with the same size inference: ``None`` blocks take
    their dimensions from siblings; errors on underspecified or
    incompatible heights/widths.  The result lies on the first block's
    device."""
    if not rows or not rows[0]:
        raise ValueError("from_blocks: empty grid")
    ncols_grid = len(rows[0])
    if any(len(r) != ncols_grid for r in rows):
        raise ValueError("from_blocks: ragged grid")

    heights = []
    for row in rows:
        hs = {m.shape[0] for m in row if m is not None}
        if not hs:
            raise ValueError("from_blocks: underspecified heights")
        if len(hs) > 1:
            raise ValueError("from_blocks: incompatible heights")
        heights.append(hs.pop())
    widths = []
    for j in range(ncols_grid):
        ws = {rows[i][j].shape[1] for i in range(len(rows))
              if rows[i][j] is not None}
        if not ws:
            raise ValueError("from_blocks: underspecified widths")
        if len(ws) > 1:
            raise ValueError("from_blocks: incompatible widths")
        widths.append(ws.pop())

    given = [m for row in rows for m in row if m is not None]
    dtype = given[0].dtype
    for m in given[1:]:
        dtype = torch.promote_types(dtype, m.dtype)
    device = given[0].data.device
    filled = [
        [
            m if m is not None else zeros((heights[i], widths[j]),
                                          dtype=dtype, device=device)
            for j, m in enumerate(row)
        ]
        for i, row in enumerate(rows)
    ]
    return vcat([hcat(row) for row in filled])


def from_blocks_diag(blocks):
    """Cyclic block-diagonal assembly (reference ``fromBlocksDiag``):
    ``blocks[d][i]`` is placed at block position ``(i, (i + d) mod n)``
    where n = len(blocks)."""
    n = len(blocks)
    padded = [list(b) + [None] * (n - len(b)) for b in blocks]
    grid = [
        [padded[(j - i) % n][i] for j in range(n)]
        for i in range(n)
    ]
    return from_blocks(grid)


def block_diag(mats):
    """Plain block-diagonal (reference ``blockDiag``)."""
    n = len(mats)
    return from_blocks_diag(
        [[m for m in mats]] + [[None] * n for _ in range(n - 1)]
    )


def kron(a, b):
    """Kronecker product (reference ``kronecker``): entry (i, j) of ``a``
    times entry (k, l) of ``b`` lands at (i nrb + k, j ncb + l); sentinel
    padding of either operand stays out of range and is dropped.  Returns
    CSR on the operands' device."""
    a = a.tocoo()
    b = b.tocoo()
    (nra, nca), (nrb, ncb) = a.shape, b.shape
    ar, ac = a.row.to(torch.int64), a.col.to(torch.int64)
    br, bc = b.row.to(torch.int64), b.col.to(torch.int64)
    nr, nc = nra * nrb, nca * ncb
    pad = ((ar[:, None] >= nra) | (br[None, :] >= nrb)).reshape(-1)
    rows = (ar[:, None] * nrb + br[None, :]).reshape(-1)
    cols = (ac[:, None] * ncb + bc[None, :]).reshape(-1)
    data = (a.data[:, None] * b.data[None, :]).reshape(-1)
    rows = torch.where(pad, nr, rows)
    cols = torch.where(pad, nc, cols)
    return coo_to_csr(COO(row=rows, col=cols, data=data, shape=(nr, nc)))


def take_diag(mat):
    """Main diagonal as a dense vector; absent entries are 0 (reference
    ``takeDiag``)."""
    from sparse_linear_tpu_torch.ops.linalg import _valid_coords

    rows, cols, vals = _valid_coords(mat)
    n = min(mat.shape)
    on = rows == cols
    out = torch.zeros((n,), dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, rows[on].long(), vals[on])


def outer(col_vec: SparseVector, row_vec: SparseVector):
    """Sparse outer product col . row^T: result[i, j] = col[i] * row[j]
    (reference ``outer``, with its documented column-vector-first order)."""
    rows = col_vec.indices[:, None].expand(-1, row_vec.nnz).reshape(-1)
    cols = row_vec.indices[None, :].expand(col_vec.nnz, -1).reshape(-1)
    data = (col_vec.data[:, None] * row_vec.data[None, :]).reshape(-1)
    return coo_to_csr(COO(row=rows, col=cols, data=data,
                          shape=(col_vec.length, row_vec.length),
                          nnz=int(rows.shape[0])))


def submatrix(mat, r0: int, r1: int, c0: int, c1: int):
    """Contiguous block extraction: mat[r0:r1, c0:c1]."""
    coo = trim(mat.tocoo())
    r, c = coo.row, coo.col
    keep = (r >= r0) & (r < r1) & (c >= c0) & (c < c1)
    return coo_to_csr(COO(
        row=(r[keep] - r0).to(index_dtype),
        col=(c[keep] - c0).to(index_dtype),
        data=coo.data[keep],
        shape=(r1 - r0, c1 - c0),
        nnz=int(keep.sum()),
    ))


def to_columns(mat):
    """Matrix -> list of sparse column vectors (reference ``toColumns``)."""
    csc = trim(mat.tocsc())
    ptr = csc.indptr.tolist()
    return [SparseVector(indices=csc.indices[ptr[j]:ptr[j + 1]],
                         data=csc.data[ptr[j]:ptr[j + 1]],
                         length=csc.shape[0])
            for j in range(csc.shape[1])]


def from_columns(cols):
    """List of sparse column vectors -> CSC (reference
    ``unsafeFromColumns``), on the columns' device, in their dtype."""
    if not cols:
        raise ValueError("from_columns: empty list")
    nr = cols[0].length
    if any(c.length != nr for c in cols):
        raise ValueError("from_columns: column length mismatch")
    device = cols[0].data.device
    counts = torch.tensor([c.nnz for c in cols], dtype=torch.int64,
                          device=device)
    indptr = torch.zeros((len(cols) + 1,), dtype=torch.int64, device=device)
    torch.cumsum(counts, 0, out=indptr[1:])
    return CSC(
        indptr=indptr.to(index_dtype),
        indices=torch.cat([c.indices for c in cols]).to(index_dtype),
        data=torch.cat([c.data for c in cols]),
        shape=(nr, len(cols)),
    )


def to_rows(mat):
    """Matrix -> list of sparse row vectors (CSR dual of ``to_columns``)."""
    return to_columns(mat.tocsr().T)


def from_rows(rows):
    """List of sparse row vectors -> CSR."""
    return from_columns(rows).T
