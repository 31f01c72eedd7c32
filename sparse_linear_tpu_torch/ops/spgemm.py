"""SpGEMM: sparse x sparse matrix multiply.

Counterpart of :mod:`sparse_linear_tpu.ops.spgemm`, with its two forms:

* **sort-based** (:func:`spgemm_plan` / :func:`spgemm_apply` /
  :func:`spgemm`): for every entry (i, k) of A, row k of B contributes
  ``row_nnz_B[k]`` products; the plan is the exclusive scan of those
  counts, and the numeric phase makes all T products with two gathers,
  then sorts and sums duplicates into canonical CSR (``ops.build``).
* **staged** (:func:`spgemm_plan_well` / :func:`spgemm_apply_well`): for a
  fixed pair of patterns the numeric phase is three fixed gathers around
  one multiply, and a fixed gather is an SpMV with a 0/1 matrix.  The plan
  holds three 0/1 WELL operators and C's pattern; the numeric phase is
  three :func:`well_spmv` calls (kernel C on the card) and one multiply.

The JAX package builds its plans with numpy on the host; here they are
built with torch on the operands' device, where sorting the T products
(26M at the permuted 1024**2 Poisson operator squared) takes milliseconds.
Sort keys ``row * ncols + col`` and product offsets are int64, and each
temporary is freed as soon as it has been used.
"""

from __future__ import annotations

import torch

from sparse_linear_tpu_torch.dtypes import index_dtype, real_of
from sparse_linear_tpu_torch.formats.base import (
    TensorFields,
    compute_indptr,
    tensor_dataclass,
)
from sparse_linear_tpu_torch.formats.matrix import COO, CSR, zeros
from sparse_linear_tpu_torch.formats.well import csr_to_well
from sparse_linear_tpu_torch.kernels.spmv_well import well_spmv
from sparse_linear_tpu_torch.ops.build import coo_to_csr, trim

__all__ = ["SpgemmPlan", "spgemm_plan", "spgemm_apply", "spgemm",
           "SpgemmWellPlan", "spgemm_plan_well", "spgemm_apply_well"]


def _operands(a, b):
    if a.shape[1] != b.shape[0]:
        raise ValueError(
            f"spgemm: inner dimension mismatch {a.shape} x {b.shape}")
    return trim(a.tocsr()), trim(b.tocsr())


def _slot_start(a: CSR, b: CSR) -> torch.Tensor:
    """(nnz_a + 1,) int64 exclusive scan of the products per A entry."""
    b_indptr = b.indptr.to(torch.int64)
    counts = (b_indptr[1:] - b_indptr[:-1])[a.indices.to(torch.int64)]
    slot_start = torch.zeros((counts.shape[0] + 1,), dtype=torch.int64,
                             device=counts.device)
    torch.cumsum(counts, 0, out=slot_start[1:])
    return slot_start


def _expand(slot_start, a: CSR, b: CSR, t: int):
    """Per product: its A entry ``e`` and its B entry ``b_pos`` (int64)."""
    dev = slot_start.device
    counts = slot_start[1:] - slot_start[:-1]
    e = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=dev), counts, output_size=t)
    del counts
    b_pos = torch.arange(t, dtype=torch.int64, device=dev)
    b_pos -= slot_start[e]                  # rank within the B row
    b_pos += b.indptr.to(torch.int64)[a.indices[e].to(torch.int64)]
    return e, b_pos


@tensor_dataclass
class SpgemmPlan(TensorFields):
    """Reusable symbolic expansion plan for a fixed (pattern(A), pattern(B))."""

    slot_start: torch.Tensor  # (nnz_a + 1,) int64
    n_products: int
    shape: tuple


def spgemm_plan(a, b) -> SpgemmPlan:
    """Symbolic phase on the operands' device."""
    a, b = _operands(a, b)
    slot_start = _slot_start(a, b)
    return SpgemmPlan(slot_start=slot_start,
                      n_products=int(slot_start[-1]),
                      shape=(a.shape[0], b.shape[1]))


def spgemm_apply(plan: SpgemmPlan, a: CSR, b: CSR) -> CSR:
    """Numeric phase.  ``a``/``b`` must be canonical and match the plan's
    patterns."""
    t = plan.n_products
    dtype = torch.result_type(a.data, b.data)
    if t == 0:
        return zeros(plan.shape, dtype=dtype, device=a.data.device)
    e, b_pos = _expand(plan.slot_start, a, b, t)
    row = a.row_ids()[e]
    data = a.data[e].to(dtype) * b.data[b_pos].to(dtype)
    del e
    col = b.indices[b_pos]
    del b_pos
    return coo_to_csr(COO(row=row, col=col, data=data, shape=plan.shape,
                          nnz=t))


def spgemm(a, b) -> CSR:
    """C = A @ B (the reference's Num ``*``): plan from the concrete
    patterns, numeric phase, canonical result."""
    a, b = _operands(a, b)
    return trim(spgemm_apply(spgemm_plan(a, b), a, b))


@tensor_dataclass
class SpgemmWellPlan:
    """Per-pattern-pair numeric plan: three 0/1 WELL operators + C's
    pattern."""

    wa: object          # WELL (T, nnz_a): product -> A entry
    wb: object          # WELL (T, nnz_b): product -> B entry
    wc: object          # WELL (nnz_c, T): product accumulation
    c_indptr: torch.Tensor
    c_indices: torch.Tensor
    shape: tuple
    t_products: int
    nnz_out: int


def _unit_well(indices, indptr, shape, dtype):
    """A 0/1 WELL from CSR pattern arrays (data = 1)."""
    ones = torch.ones((indices.shape[0],), dtype=dtype, device=indices.device)
    return csr_to_well(CSR(indptr=indptr, indices=indices.to(index_dtype),
                           data=ones, shape=shape))


def spgemm_plan_well(a, b) -> SpgemmWellPlan:
    """Build the three WELL operators and C's pattern on the operands'
    device (reusable across all value sets with these patterns)."""
    a, b = _operands(a, b)
    nr, nc = a.shape[0], b.shape[1]
    dev = a.data.device
    slot_start = _slot_start(a, b)
    t = int(slot_start[-1])
    if t == 0:
        raise ValueError("spgemm_plan_well: empty product (use spgemm)")
    if t >= 2 ** 31:
        raise ValueError(f"spgemm_plan_well: {t} products do not fit the "
                         "int32 column index of W_c (use spgemm)")
    e, b_pos = _expand(slot_start, a, b, t)
    del slot_start

    # output pattern: sorted unique (row, col); products grouped per output
    key = a.row_ids()[e].to(torch.int64)
    key *= nc
    key += b.indices[b_pos]
    key, order = torch.sort(key, stable=True)
    new = torch.ones((t,), dtype=torch.bool, device=dev)
    torch.ne(key[1:], key[:-1], out=new[1:])
    out_id = torch.cumsum(new, 0)           # 1 + output id per product
    nnz_c = int(out_id[-1])
    key = key[new]
    del new
    c_indptr = compute_indptr(torch.div(key, nc, rounding_mode="floor"), nr)
    c_indices = torch.remainder(key, nc).to(index_dtype)
    del key

    # unit weights carry the computation dtype (real part of the operands)
    rdt = real_of(torch.result_type(a.data, b.data))
    unit_ptr = torch.arange(t + 1, dtype=torch.int64, device=dev)
    wa = _unit_well(e, unit_ptr, (t, a.nnz), rdt)
    del e
    wb = _unit_well(b_pos, unit_ptr, (t, b.nnz), rdt)
    del b_pos, unit_ptr
    # W_c rows = outputs; entries = product ids in output order
    wc_ptr = torch.zeros((nnz_c + 1,), dtype=torch.int64, device=dev)
    wc_ptr[1:] = torch.bincount(out_id - 1, minlength=nnz_c).cumsum(0)
    del out_id
    wc = _unit_well(order, wc_ptr, (nnz_c, t), rdt)
    return SpgemmWellPlan(wa=wa, wb=wb, wc=wc, c_indptr=c_indptr,
                          c_indices=c_indices, shape=(nr, nc),
                          t_products=t, nnz_out=nnz_c)


def spgemm_apply_well(plan: SpgemmWellPlan, a_data, b_data) -> CSR:
    """Numeric phase: three WELL SpMVs + one multiply."""
    av = well_spmv(plan.wa, a_data)
    bv = well_spmv(plan.wb, b_data)
    cd = well_spmv(plan.wc, av * bv)
    return CSR(indptr=plan.c_indptr, indices=plan.c_indices, data=cd,
               shape=plan.shape)
