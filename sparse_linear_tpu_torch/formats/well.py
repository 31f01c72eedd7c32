"""WELL: the port's format for *unstructured* sparse matrices, a sliced ELL.

Counterpart of :mod:`sparse_linear_tpu.formats.well`.  The JAX package's
WELL packs entries into (8, 128) chunks that each read one aligned x window
through two in-register gathers, because the TPU has no scattered loads.
Hopper gathers natively, so the port keeps the name, the constructor and
the ``@`` of WELL, and stores the matrix in a layout made for a warp:

* rows are cut into **slices of 32** (one warp), and each slice is padded
  to its longest row: ``w_s`` slots per row;
* entries are stored **slot-major** inside a slice: the k-th entry of row
  ``32 s + lane`` sits at ``slice_ptr[s] + 32 k + lane``, so lane i of a
  warp reads row i's k-th entry and a warp's loads of ``vals``/``cols`` are
  coalesced;
* ``slice_ptr`` is int64 (capacity can pass 2**31 on skewed patterns),
  ``cols`` int32; a padding slot holds value 0 and column 0;
* a complex matrix keeps one complex ``vals`` tensor.

The layout is built from the CSR on the matrix's own device with tensor
ops: no host pass and no native packer.  ``W @ x`` runs
:func:`kernels.spmv_well.well_spmv`: the hand-written Hopper kernel on CUDA
tensors, its plain version on CPU tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sparse_linear_tpu_torch.formats.base import TensorFields, tensor_dataclass
from sparse_linear_tpu_torch.formats.matrix import _scatter_dense

__all__ = ["WELL", "csr_to_well", "SLICE_ROWS"]

SLICE_ROWS = 32  # rows per slice: one warp


@tensor_dataclass
class WELL(TensorFields):
    """Sliced-ELL storage of an (nr, nc) matrix; see the module docstring.

    ``c_max`` is the widest slice, in slots per row.  ``fill`` is
    nnz / padded capacity (the JAX field, here the share of slots that hold
    an entry)."""

    slice_ptr: torch.Tensor  # (ceil(nr / 32) + 1,) int64
    cols: torch.Tensor       # (capacity,) int32
    vals: torch.Tensor       # (capacity,) values; padding slots hold 0
    shape: tuple
    c_max: int
    fill: float

    @property
    def is_complex(self) -> bool:
        return self.vals.is_complex()

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def n_slices(self) -> int:
        return int(self.slice_ptr.shape[0]) - 1

    @functools.cached_property
    def slot_rows(self) -> torch.Tensor:
        """Row of every slot (int64), made once per matrix for the plain
        versions; the padding lanes of a last, partial slice get rows
        >= nr."""
        cap = int(self.cols.shape[0])
        dev = self.cols.device
        slots = self.slice_ptr[1:] - self.slice_ptr[:-1]
        slice_of = torch.repeat_interleave(
            torch.arange(self.n_slices, device=dev), slots, output_size=cap)
        lane = (torch.arange(cap, device=dev) - self.slice_ptr[slice_of]) \
            % SLICE_ROWS
        return slice_of * SLICE_ROWS + lane

    @functools.cached_property
    def slots_in_bounds(self) -> bool:
        """Whether ``slice_ptr`` ends at the capacity and every column lies
        in [0, ncols).  The kernels index without bounds checks, so their
        wrappers ask this once per matrix (one device sync)."""
        cap = int(self.cols.shape[0])
        if int(self.slice_ptr[-1]) != cap:
            return False
        return cap == 0 or (int(self.cols.min()) >= 0
                            and int(self.cols.max()) < self.shape[1])

    def todense(self):
        return _scatter_dense(self.shape, self.slot_rows, self.cols, self.vals)

    def __matmul__(self, x):
        from sparse_linear_tpu_torch.kernels.spmv_well import well_spmv

        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x), device=self.vals.device)
        return well_spmv(self, x)


def csr_to_well(mat, c_max: int | None = None) -> WELL:
    """CSR -> WELL on the matrix's device.

    Raises ``ValueError`` if a slice needs more than ``c_max`` slots per
    row (one long row pads its whole slice: then the pattern is too skewed
    for this layout at that cap).  Empty matrices and empty rows are fine.
    """
    from sparse_linear_tpu_torch.ops.build import trim

    csr = trim(mat.tocsr())
    nr, nc = csr.shape
    dev = csr.data.device
    indptr = csr.indptr.to(torch.int64)
    n_slices = -(-nr // SLICE_ROWS)
    row_len = torch.zeros((n_slices * SLICE_ROWS,), dtype=torch.int64,
                          device=dev)
    row_len[:nr] = indptr[1:] - indptr[:-1]
    width = row_len.view(n_slices, SLICE_ROWS).amax(dim=1)
    del row_len
    needed = int(width.max()) if n_slices else 0
    if c_max is not None and needed > c_max:
        raise ValueError(
            f"csr_to_well: pattern needs {needed} slots/row in a slice > "
            f"c_max={c_max}"
        )
    slice_ptr = torch.zeros((n_slices + 1,), dtype=torch.int64, device=dev)
    torch.cumsum(width * SLICE_ROWS, 0, out=slice_ptr[1:])
    del width
    capacity = int(slice_ptr[-1])

    nnz = csr.nnz
    rows = csr.row_ids().to(torch.int64)
    pos = torch.arange(nnz, dtype=torch.int64, device=dev)
    pos -= indptr[rows]                   # k: rank of the entry in its row
    pos *= SLICE_ROWS
    pos += slice_ptr[rows // SLICE_ROWS] + rows % SLICE_ROWS
    del rows
    cols = torch.zeros((capacity,), dtype=torch.int32, device=dev)
    cols[pos] = csr.indices.to(torch.int32)
    vals = torch.zeros((capacity,), dtype=csr.data.dtype, device=dev)
    vals[pos] = csr.data
    return WELL(slice_ptr=slice_ptr, cols=cols, vals=vals, shape=(nr, nc),
                c_max=needed, fill=float(nnz / max(capacity, 1)))
