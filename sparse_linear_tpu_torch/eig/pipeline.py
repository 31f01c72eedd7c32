"""The cached contour pipeline of FEAST on the card.

Counterpart of :mod:`sparse_linear_tpu.eig.real_pipeline`, the JAX
package's accelerator path of ``geigsh``, keeping what is not a TPU
workaround, for real symmetric and complex Hermitian pencils alike:

1. **Pattern-keyed pipeline cache** (``real_pipeline.py:9-14``,
   ``:606-614``).  Keyed by host fingerprints of A and B, the backend, the
   grid dims and the device, a pipeline holds the union pattern's values,
   ONE ``solve.api.analyze`` of that pattern (``dims`` go to the port's
   nested dissection by grid), the structured operators of A and B, and at
   most two cached factor sets (one per contour).

2. **Native complex contour factors.**  The node values z_k B - A over the
   union pattern are factored as complex128 LU (complex64 for f32 input):
   nothing is embedded.  ``refine_solves=None`` means 0 refinement steps on
   complex128 factors and 2 on complex64 ones (from the second loop on, as
   ``real_pipeline.py:670-674`` stages them), with the residual computed in
   the original space through the structured operators
   (``real_pipeline.py:284-320``).

3. **Conjugate-eliminated lower contour for real pencils**
   (``real_pipeline.py:16-20``): q = 2 Re sum_k sigma_k S_k with only the
   upper solves.  A complex Hermitian pencil runs the S solves and the
   ``trans="H"`` solves on the same factors (``feast.py:826-843``).

4. **Three ways to run the contour, chosen by bytes, with the same
   numbers**: "batched" (all ne sets factored in one ``factor_batched``
   and solved in one ``solve_batched``), "per-node" (each node factored
   alone, all ne sets kept resident across loops, the quadrature summed
   node by node so no (ne, n, m) stack is held) and "streaming" (one
   node's factors resident at a time, factored again every loop,
   ``real_pipeline.py:452-577``).  :meth:`_Pipeline.plan` compares the
   port's own byte count with the card's free memory
   (``torch.cuda.mem_get_info``); ``SLT_FEAST_MEMORY_BUDGET`` (bytes)
   overrides that memory, so a test can force streaming.  A fourth mode,
   "sharded" (``geigsh(mesh=)``), splits the nodes into contiguous groups,
   one a shard of the contour axis: each shard factors and solves its
   nodes on its device in the first of the three ways whose bytes fit
   every card, the shards that share a card counted together against that
   card's memory, and the quadrature sums are psum'd onto the subspace's
   device in shard order.  The pipeline (pattern, ``analyze``, operators)
   is shared by every mesh; a contour is cached per (nodes, mode, mesh
   layout).  A mesh whose rows axis has more than one shard also
   row-shards the subspace (the JAX package's ``P(rows_axis, None)``
   blocks): every (n, m0) block is a ``dist.sharded.ShardedBlock``, A and
   B are row-sharded once per rows layout (DIA slabs on kernel A's
   multi-RHS form with the halo exchange, WELL slabs on kernel D with the
   column-window exchange: ``dist.spmv.spmm_sharded``), the right-hand
   side B y is gathered onto each contour shard, and the psum'd quadrature
   sum comes back split into the row pieces.

5. **Rayleigh-Ritz in plain f64/c128 matmuls** (``torch.matmul``): the
   whitening Gram q^H q, qw = q W, the reduced blocks qw^H (A qw) and
   qw^H (B qw) formed in that order (no symmetry of A is assumed), the
   Ritz rotation and the residual norms, one m0-wide block per product
   (row-sharded: one a shard, the Grams and squared norms psum'd).
   Only the m0 x m0 Gram and blocks go to the host, for numpy's eighs.

Left out as TPU workarounds: the real 2n embedding, ``dot64``, the
16-column residual scan, jitted programs with donated buffers and the
queue drains between them.

The solver loop (``real_pipeline.py:617-846``) keeps the stagnation rule,
``INFO_SUBSPACE_TOO_SMALL``, the random refill of dropped columns (a
``torch.Generator`` seeded with ``seed + loop + 1``) and the spurious-pair
rejection, with the reference's ghost-filtered convergence test made
strict (:func:`_ghost_converged`).
"""

from __future__ import annotations

import math
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from sparse_linear_tpu_torch.dtypes import complex_of, real_of

__all__ = ["geigsh_pipeline", "count_pipeline", "clear_pipeline_cache",
           "StructuredOp", "last_run"]

_PIPELINE_CACHE: dict = {}
_PIPELINE_CACHE_MAX = 4
_FACTOR_CACHE_MAX = 2  # contours (factor sets) cached per pipeline
# Copies of one (n, m0) complex block that a contour solve holds at once:
# the right-hand side, its permuted and sentinel-extended copies, the
# result, a refinement residual and its correction.
_SOLVE_COPIES = 6
# A factorization's peak above its stored factors, in its largest fronts.
_FACTOR_TRANSIENT = 4
# (rows, m0) pieces a rows shard holds at once in a row-sharded loop: q,
# qw, x, a product, a residual term and the restart block.
_ROW_COPIES = 6
_BUDGET_SHARE = 0.9  # of the free (and cached) device memory
# A rejected pair whose residual falls below this share of its match in the
# previous loop is converging, and may be genuine.  Ghost residuals of an
# interior window wander by at most a few percent a loop (PERF.md, PR 6),
# while a genuine pair converges by its filter ratio: 0.8 leaves room for
# the wander and catches a genuine pair converging 1.25x a loop or faster.
_GHOST_PROGRESS = 0.8

# What the last geigsh_pipeline call spent where (seconds, bytes, mode).
last_run: dict = {}


def clear_pipeline_cache() -> None:
    """Drop every cached pipeline (symbolic analyses, structured operators
    and the factor sets, which hold GBs of device memory at 1M dof).  The
    device memory is free when this returns: see :func:`_drop`."""
    while _PIPELINE_CACHE:
        _drop(_PIPELINE_CACHE.popitem()[1])


def _drop(pipe) -> None:
    """Release a pipeline's factor sets now.  A contour refers to its
    pipeline and the pipeline to its contours; without this, dropping the
    pipeline leaves the cycle, and the factors on the card, to Python's
    cycle collector, whenever it runs (a second 1M-dof FEAST then found
    48 GB still held and planned its contour as if they were in use).
    The sites on other devices (each refers back to the pipeline) go
    too."""
    pipe.contours.clear()
    pipe.sites.clear()
    pipe.row_sets.clear()


def _fingerprint(mat) -> tuple:
    """Shape, dtype and hashes of host copies of indptr/indices/data
    (``real_pipeline.py:66-76``)."""
    csr = mat.tocsr()
    n = csr.nnz
    leaves = (csr.indptr, csr.indices[:n], csr.data[:n])
    return (tuple(csr.shape), str(csr.dtype)) + tuple(
        hash(t.detach().resolve_conj().cpu().numpy().tobytes())
        for t in leaves)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host(t) -> np.ndarray:
    return t.detach().resolve_conj().cpu().numpy()


class StructuredOp:
    """Y = M X for one operator M of the pencil, X of shape (ncols, m) on
    M's device (the subspace is held as (n, m) throughout).

    Precondition: it computes M X and only that.  It does not assume M
    symmetric, so Rayleigh-Ritz forms X^H (M X) in that order; the JAX
    package's plane-major ``rr_blocks`` formed (M X)^T X, which equals
    X^T M X only for a symmetric M (``real_pipeline.py:357-371``).

    ``route``: "identity" (no product), "dia" (kernel A's multi-RHS form,
    ``dia_spmm_kernel``: every banded operator) or "well" (kernel D,
    ``well_spmm``: every other one, long padded rows included), real and
    complex alike.  A complex X on a real M runs the real kernel on the
    (ncols, 2m) block ``torch.view_as_real(X)`` inside the wrapper; a
    complex M runs the complex kernel."""

    def __init__(self, route: str, fn=None, mat=None):
        self.route = route
        self.fn = fn
        self.mat = mat  # the DIA, or the CSR packed as WELL

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.route == "identity":
            return x
        return self.fn(x)


def _structured_op(mat) -> StructuredOp:
    """The operator's route, chosen once (``real_pipeline.py:106-185``):
    a banded operator (at most 64 diagonals) to DIA, any other to WELL,
    real or complex.  The JAX BSR route for f64 and complex exists because
    the TPU emulates f64, and kernel D in f64, complex64 or complex128
    takes its place.  The reference's 1/64 WELL fill floor is a TPU
    capacity choice: kernel D computes any WELL, so an operator that is not
    banded always runs on it."""
    from sparse_linear_tpu_torch.eig.feast import _is_identity
    from sparse_linear_tpu_torch.formats.structured import csr_to_dia
    from sparse_linear_tpu_torch.formats.well import csr_to_well
    from sparse_linear_tpu_torch.kernels.spmv_dia import dia_spmm_kernel
    from sparse_linear_tpu_torch.kernels.spmv_well import well_spmm
    from sparse_linear_tpu_torch.ops.build import trim

    if _is_identity(mat):
        return StructuredOp("identity")
    csr = trim(mat.tocsr())
    try:
        dia = csr_to_dia(csr, max_diags=64)
    except ValueError:
        dia = None
    if dia is not None:
        return StructuredOp("dia", lambda x: dia_spmm_kernel(dia, x), dia)
    well = csr_to_well(csr)
    return StructuredOp("well", lambda x: well_spmm(well, x), csr)


def _row_op(op: StructuredOp, mesh) -> StructuredOp:
    """``op`` row-sharded over ``mesh["rows"]`` on its own route: DIA slabs
    (zero-padded where the shards do not divide the rows) or WELL slabs,
    taking and returning ShardedBlocks; the identity stays the identity."""
    from sparse_linear_tpu_torch.dist.spmv import (
        shard_dia_rows,
        shard_well_rows,
        spmm_sharded,
    )

    if op.route == "identity":
        return op
    if op.route == "dia":
        sharded = shard_dia_rows(op.mat, mesh, "rows", pad=True)
    else:
        sharded = shard_well_rows(op.mat, mesh, "rows")
    return StructuredOp(op.route, lambda x: spmm_sharded(sharded, x, mesh),
                        sharded)


def _budget(device, held: float = 0.0) -> float:
    """Bytes a contour may hold: ``SLT_FEAST_MEMORY_BUDGET`` if set, else a
    share of the card's free memory and of what torch's allocator holds
    unused, plus ``held`` (bytes of cached factor sets that may be
    dropped); unbounded on the CPU."""
    env = os.environ.get("SLT_FEAST_MEMORY_BUDGET")
    if env is not None:
        return float(env)
    if device.type != "cuda":
        return math.inf
    free, _ = torch.cuda.mem_get_info(device)
    cached = (torch.cuda.memory_reserved(device)
              - torch.cuda.memory_allocated(device))
    return _BUDGET_SHARE * (free + cached) + held


class _Pipeline:
    """All pattern- and value-dependent state for one (A, B, backend,
    dims) on one device."""

    def __init__(self, mat_a, mat_b, backend: str, dims):
        from sparse_linear_tpu_torch.eig.feast import _union_shift_stack
        from sparse_linear_tpu_torch.solve import api

        t0 = time.perf_counter()
        self.n = mat_a.shape[0]
        self.device = mat_a.data.device
        self.wdtype = torch.promote_types(mat_a.dtype, mat_b.dtype)
        self.real = not self.wdtype.is_complex
        self.cdtype = complex_of(self.wdtype)
        # values(z): the (len(z), nnz) node values z_k B - A
        self.pattern, _, self.values = _union_shift_stack(mat_a, mat_b)
        opts = {"dims": tuple(dims)} if dims is not None else {}
        self.symbolic = api.analyze(self.pattern, backend=backend, **opts)
        self.a_op = _structured_op(mat_a)
        self.b_op = _structured_op(mat_b)
        self.mats = (mat_a, mat_b)
        _sync(self.device)
        self.analyze_s = time.perf_counter() - t0
        self.contours: dict = {}
        self.sites: dict = {}
        self.row_sets: dict = {}

    def row_ops(self, mesh) -> tuple:
        """(A, B) row-sharded over ``mesh["rows"]``, built once a layout."""
        if mesh.key not in self.row_sets:
            self.row_sets[mesh.key] = (_row_op(self.a_op, mesh),
                                       _row_op(self.b_op, mesh))
        return self.row_sets[mesh.key]

    def site(self, device) -> "_Pipeline | _Site":
        """What a shard on ``device`` factors and solves with: the
        pipeline itself on its own device, else a copy of the pattern (and,
        for refinement, of the operators) made there once."""
        device = torch.device(device)
        if device == self.device:
            return self
        if device not in self.sites:
            self.sites[device] = _Site(self, device)
        return self.sites[device]

    # -- bytes -------------------------------------------------------------

    def set_bytes(self) -> tuple[int, int]:
        """(stored bytes of one node's factors, bytes of its largest
        front): the ``artifact_f32_bytes`` formula of
        ``real_pipeline.py:239-247`` (lu, g21, g12 of every bucket) at the
        factor's item size; a dense n x n stands in without a schedule."""
        item = torch.empty((), dtype=self.cdtype).element_size()
        sched = getattr(self.symbolic, "schedule", None)
        if sched is None:
            return item * self.n ** 2, item * self.n ** 2
        stored = sum(b["sup_ids"].shape[0]
                     * (b["Ns"] ** 2 + 2 * b["Ns"] * b["Us"])
                     for b in sched["flat"])
        front = max(b["sup_ids"].shape[0] * (b["Ns"] + b["Us"]) ** 2
                    for b in sched["flat"])
        return item * stored, item * front

    def needs(self, ne, m: int) -> dict:
        """Bytes each contour mode holds at its peak on one card for ne
        nodes and m right-hand sides.  ``ne`` may be a list: the node
        counts of the shards that share the card, which run one after
        another, so their stored sets add up and one transient is held at
        a time."""
        ks = [ne] if isinstance(ne, int) else list(ne)
        fac, front = self.set_bytes()
        stack = (self.n * m * torch.empty((), dtype=self.cdtype)
                 .element_size() * _SOLVE_COPIES)
        trans = front * _FACTOR_TRANSIENT
        return {"batched": sum(ks) * fac + max(ks) * (trans + stack),
                "per-node": sum(ks) * fac + trans + stack,
                "streaming": fac + trans + stack}

    def plan(self, ne: int, m: int, batching: str, held: float = 0.0):
        """(mode, why): "vmap" and "loop" force batched and per-node;
        "auto" takes the first of batched, per-node and streaming whose
        bytes fit the budget plus ``held`` (bytes of cached factor sets that
        may be dropped)."""
        need = self.needs(ne, m)
        if batching == "vmap":
            return "batched", "forced by contour_batching='vmap'"
        if batching == "loop":
            return "per-node", "forced by contour_batching='loop'"
        budget = _budget(self.device, held)
        for mode in ("batched", "per-node"):
            if need[mode] <= budget:
                return mode, (f"{need[mode] / 1e9:.2f} GB fit the budget of "
                              f"{budget / 1e9:.2f} GB")
        return "streaming", (f"per-node {need['per-node'] / 1e9:.2f} GB "
                             f"exceed the budget of {budget / 1e9:.2f} GB")

    def card_needs(self, groups, m: int, rows=()) -> dict:
        """{card: {mode: bytes}} of a sharded contour whose groups are
        ``[(device, node count)]``: each group's solves and its (n, m)
        quadrature sum, held until the psum.  ``rows``: the row pieces of a
        row-sharded subspace, ``[(device, rows)]``, each held
        :data:`_ROW_COPIES` times, and the whole psum'd sum on the first
        rows shard's card before it is split."""
        item = torch.empty((), dtype=self.wdtype).element_size()
        block = self.n * m * item
        cards = dict.fromkeys([d for d, _ in groups] + [d for d, _ in rows])
        out = {}
        for c in cards:
            ks = [k for d, k in groups if d == c]
            need = self.needs(ks, m) if ks else dict.fromkeys(
                ("batched", "per-node", "streaming"), 0)
            extra = len(ks) * block + _ROW_COPIES * m * item * sum(
                r for d, r in rows if d == c)
            if rows and c == rows[0][0]:
                extra += block
            out[c] = {k: v + extra for k, v in need.items()}
        return out

    def plan_sharded(self, groups, m: int, batching: str, held: dict,
                     rows=()):
        """(per-shard mode, why) of a sharded contour, as :meth:`plan` but
        against every card's budget at once."""
        need = self.card_needs(groups, m, rows)
        if batching == "vmap":
            return "batched", "forced by contour_batching='vmap'"
        if batching == "loop":
            return "per-node", "forced by contour_batching='loop'"
        budget = {d: _budget(d, held.get(d, 0.0)) for d in need}
        for mode in ("batched", "per-node", "streaming"):
            if all(need[d][mode] <= budget[d] for d in need):
                break
        return mode, "; ".join(
            f"{d}: {need[d][mode] / 1e9:.2f} GB of a budget of "
            f"{budget[d] / 1e9:.2f} GB" for d in need)

    # -- factors -----------------------------------------------------------

    def factor(self, zk):
        from sparse_linear_tpu_torch.solve import api

        pat = self.pattern
        mat = type(pat)(indptr=pat.indptr, indices=pat.indices,
                        data=self.values([zk])[0], shape=pat.shape)
        return api.factor(mat, self.symbolic)

    def contour(self, z, sigma, m: int, batching: str,
                shards=None, rows=()) -> "_Contour":
        """The contour's factors in the planned mode, cached per (nodes,
        mode, shards); cached sets of other contours are dropped first when
        the plan does not fit beside them.  ``shards``: the devices of a
        mesh's contour axis, one group of contiguous nodes each; ``rows``:
        ``[(device, rows)]`` of a row-sharded subspace, for the byte
        plan."""
        zkey = hash(np.asarray(z).tobytes())
        fac = self.set_bytes()[0]
        held: dict = {}
        for c in self.contours.values():
            for dev, k in c.stored_by_device().items():
                held[dev] = held.get(dev, 0.0) + k * fac
        if shards is None:
            groups = [(self.device, np.arange(len(z)))]
            mode, why = self.plan(len(z), m, batching,
                                  held.get(self.device, 0.0))
            key = (zkey, mode, None)
            fits = self.needs(len(z), m)[mode] <= _budget(self.device)
        else:
            shards = [torch.device(d) for d in shards]
            groups = list(zip(shards, np.array_split(np.arange(len(z)),
                                                     len(shards))))
            sizes = [(d, len(ix)) for d, ix in groups]
            sub, why = self.plan_sharded(sizes, m, batching, held, rows)
            mode = "sharded"
            why = f"{sub} on each of {len(shards)} shards: {why}"
            key = (zkey, mode, sub, tuple(str(d) for d in shards))
            need = self.card_needs(sizes, m, rows)
            fits = all(need[d][sub] <= _budget(d) for d in need)
        if key in self.contours:
            return self.contours[key]
        if held and not fits:
            self.contours.clear()
        while len(self.contours) >= _FACTOR_CACHE_MAX:
            self.contours.pop(next(iter(self.contours)))
        c = _Contour(self, np.asarray(z), np.asarray(sigma), mode, why,
                     groups, None if shards is None else sub)
        self.contours[key] = c
        return c

    def residual(self, rhs, s, zk):
        """rhs - (zk B - A) s, through the structured operators."""
        bs = s if self.b_op.route == "identity" else self.b_op(s)
        return rhs - zk * bs + self.a_op(s)


class _Site:
    """A pipeline's pattern, node values and (made at first use, for
    refinement) operators on another device than its own: where a shard of
    a sharded contour factors and solves."""

    def __init__(self, pipe: _Pipeline, device: torch.device):
        self.pipe, self.device = pipe, device
        self.pattern = pipe.pattern.to(device)
        self.symbolic = pipe.symbolic
        self._ops = None

    def values(self, z):
        return self.pipe.values(z).to(self.device)

    def factor(self, zk):
        return _Pipeline.factor(self, zk)

    def residual(self, rhs, s, zk):
        if self._ops is None:
            self._ops = tuple(_structured_op(m.to(self.device))
                              for m in self.pipe.mats)
        a_op, b_op = self._ops
        bs = s if b_op.route == "identity" else b_op(s)
        return rhs - zk * bs + a_op(s)


class _Contour:
    """One contour's nodes, weights and factors in one mode: one group of
    nodes on the pipeline's device, or under "sharded" one group a shard,
    each in ``shard_mode``."""

    def __init__(self, pipe: _Pipeline, z, sigma, mode: str, why: str,
                 groups, shard_mode=None):
        from sparse_linear_tpu_torch.solve import api

        self.pipe, self.z, self.sigma = pipe, z, sigma
        self.mode, self.why, self.shard_mode = mode, why, shard_mode
        # [(site, node indices, mode, factors)]
        self.groups = []
        t0 = time.perf_counter()
        for dev, idx in groups:
            site = pipe.site(dev)
            gmode = shard_mode or mode
            factors = None
            if gmode == "batched":
                factors = api.factor_batched(site.pattern,
                                             site.values(z[idx]),
                                             pipe.symbolic)
            elif gmode == "per-node":
                factors = [site.factor(z[k]) for k in idx]
            self.groups.append((site, idx, gmode, factors))
        self._sync()
        self.factor_s = time.perf_counter() - t0

    def _sync(self) -> None:
        for dev in dict.fromkeys(g[0].device for g in self.groups):
            _sync(dev)

    def stored_by_device(self) -> dict:
        """{device: factor sets held there}."""
        out: dict = {}
        for site, idx, gmode, factors in self.groups:
            if factors is not None:
                out[site.device] = out.get(site.device, 0) + len(idx)
        return out

    def _accumulate(self, q, s, k, trans) -> None:
        w = np.conj(self.sigma[k]) if trans else self.sigma[k]
        if self.pipe.real:
            # 2 Re(w s): the lower semicircle's conjugate solves, eliminated
            q.add_(s.real, alpha=2.0 * w.real)
            q.add_(s.imag, alpha=-2.0 * w.imag)
        else:
            q.add_(s, alpha=complex(w))

    def apply(self, y, refine_n: int, b_op=None):
        """q = sum_k sigma_k S_k + conj(sigma_k) T_k with S_k and T_k the
        solutions of (z_k B - A) S = B y and (z_k B - A)^H T = B y; for a
        real pencil T_k = conj(S_k) and q = 2 Re sum_k sigma_k S_k.  Under
        "sharded" each shard sums its own nodes on its device (the
        right-hand side goes to it once; it is only read there) and the
        sums are psum'd onto y's device in shard order.  A row-sharded y (a
        ShardedBlock, with ``b_op`` the row-sharded B) has B y gathered
        onto each contour shard's device, once a device, and q comes back
        split into y's row pieces."""
        from sparse_linear_tpu_torch.dist.collectives import gather, psum
        from sparse_linear_tpu_torch.dist.sharded import ShardedBlock, split

        pipe = self.pipe
        by = (b_op or pipe.b_op)(y)
        rows = isinstance(by, ShardedBlock)
        if rows:
            shape, dest = (by.length, by.width), by.device
        else:
            by = by.to(pipe.cdtype)
            shape, dest = tuple(y.shape), y.device
        rhs: dict = {}
        sums = []
        for site, idx, gmode, factors in self.groups:
            if site.device not in rhs:
                rhs[site.device] = (
                    gather(by.pieces, site.device)[:by.length].to(pipe.cdtype)
                    if rows else by.to(site.device))
            q = torch.zeros(shape, dtype=pipe.wdtype, device=site.device)
            self._group_sum(q, rhs[site.device], site, idx, gmode, factors,
                            refine_n)
            sums.append(q)
        del rhs
        q = sums[0] if len(sums) == 1 else psum(sums, dest)
        if not rows:
            return q
        return ShardedBlock(by.mesh, by.axis,
                            split(q, by.devices, by.blocks[0]), by.length)

    def _group_sum(self, q, rhs, site, idx, gmode, factors, refine_n):
        """Add one group's quadrature terms to q, on the group's device."""
        from sparse_linear_tpu_torch.solve import api

        passes = (False,) if self.pipe.real else (False, True)
        if gmode == "batched":
            ne = len(idx)
            for trans in passes:
                zz = np.conj(self.z[idx]) if trans else self.z[idx]
                s = api.solve_batched(factors,
                                      rhs.expand((ne,) + rhs.shape), trans)
                for _ in range(refine_n):
                    r = torch.stack([site.residual(rhs, s[i], complex(zz[i]))
                                     for i in range(ne)])
                    s += api.solve_batched(factors, r, trans)
                    del r
                for i, k in enumerate(idx):
                    self._accumulate(q, s[i], k, trans)
                del s
            return
        for i, k in enumerate(idx):
            zk = self.z[k]
            if gmode == "per-node":
                fac = factors[i]
            else:
                t0 = time.perf_counter()
                fac = site.factor(zk)
                _sync(site.device)
                self.factor_s += time.perf_counter() - t0
            for trans in passes:
                zt = complex(np.conj(zk) if trans else zk)
                s = api.solve(fac, rhs, trans)
                for _ in range(refine_n):
                    s += api.solve(fac, site.residual(rhs, s, zt), trans)
                self._accumulate(q, s, k, trans)
                del s
            del fac


def _get_pipeline(mat_a, mat_b, backend, dims):
    """(the cached pipeline of the pencil, whether this call built it)."""
    key = (_fingerprint(mat_a), _fingerprint(mat_b), backend,
           None if dims is None else tuple(dims), str(mat_a.data.device))
    pipe = _PIPELINE_CACHE.get(key)
    if pipe is not None:
        return pipe, False
    pipe = _Pipeline(mat_a, mat_b, backend, dims)
    if len(_PIPELINE_CACHE) >= _PIPELINE_CACHE_MAX:
        _drop(_PIPELINE_CACHE.pop(next(iter(_PIPELINE_CACHE))))
    _PIPELINE_CACHE[key] = pipe
    return pipe, True


def _refine_default(params, pipe) -> int:
    if params.refine_solves is not None:
        return int(params.refine_solves)
    return 0 if pipe.cdtype == torch.complex128 else 2


class _LoopState(NamedTuple):
    """What one loop leaves for the ghost-filtered convergence test."""

    values: np.ndarray     # genuine eigenvalues inside the interval, sorted
    ghosts: np.ndarray     # Ritz values of the rejected inside pairs
    rejected: np.ndarray   # their residuals, in the same order
    epsout: float          # max residual of the genuine pairs


def _ghost_converged(prev, cur, tol: float, lam_scale: float) -> bool:
    """Whether two consecutive loops show ghost-filtered convergence: both
    rejected spurious pairs, both met ``tol`` on their genuine pairs, the
    two genuine eigenvalue sets have the same size and agree within
    ``tol * lam_scale``, and no rejected pair's residual decreased between
    them.  Each rejected pair of ``cur`` is matched with the previous
    loop's rejected pair nearest in Ritz value, and "decreased" means fell
    below :data:`_GHOST_PROGRESS` of it.  The reference accepted equal
    COUNTS of genuine pairs alone (``real_pipeline.py:802-810``), which can
    drop a slowly converging genuine pair in silence."""
    if prev is None or not len(cur.rejected) or not len(prev.rejected):
        return False
    if cur.epsout > tol or prev.epsout > tol:
        return False
    if not len(cur.values) or len(cur.values) != len(prev.values):
        return False
    if np.max(np.abs(cur.values - prev.values)) > tol * lam_scale:
        return False
    near = np.abs(cur.ghosts[:, None] - prev.ghosts[None, :]).argmin(axis=1)
    return bool(np.all(cur.rejected >= _GHOST_PROGRESS * prev.rejected[near]))


def _gram(p, q) -> np.ndarray:
    """p^H q on the host: one product, or on row-sharded blocks one a shard
    psum'd in shard order.  The seconds from the end of the work queued
    before it to the host copy add up in ``_gram.seconds``."""
    from sparse_linear_tpu_torch.dist.sharded import ShardedBlock

    sharded = isinstance(p, ShardedBlock)
    _sync_all(p.devices if sharded else [p.device])
    t0 = time.perf_counter()
    out = _host(p.gram(q) if sharded else p.mH @ q)
    _gram.seconds += time.perf_counter() - t0
    return out


_gram.seconds = 0.0


def _times(q, mat: np.ndarray):
    """q @ mat for a small host matrix, on q's device(s)."""
    from sparse_linear_tpu_torch.dist.sharded import ShardedBlock

    if isinstance(q, ShardedBlock):
        return q @ mat
    return q @ torch.as_tensor(mat, dtype=q.dtype, device=q.device)


def _col_norms(x) -> torch.Tensor:
    from sparse_linear_tpu_torch.dist.sharded import ShardedBlock

    if isinstance(x, ShardedBlock):
        return x.col_norms()
    return torch.linalg.vector_norm(x, dim=0)


def _restart(x, fill, m0: int):
    """The warm-restart block: x's columns, then ``fill`` (the whole
    (n, m0 - m) random refill, or None), row-sharded like x when x is."""
    from sparse_linear_tpu_torch.dist.sharded import ShardedBlock, split

    sharded = isinstance(x, ShardedBlock)
    pieces, fills = (x.pieces, [None] * len(x.pieces)) if sharded else (
        [x], [fill])
    if sharded and fill is not None:
        fills = split(fill, x.devices, x.blocks[0])
    out = []
    for p, f in zip(pieces, fills):
        y = torch.empty((p.shape[0], m0), dtype=p.dtype, device=p.device)
        y[:, :p.shape[1]] = p
        if f is not None:
            y[:, p.shape[1]:] = f
        out.append(y)
    return x._like(out) if sharded else out[0]


def _reduced_blocks(a_op, b_op, qw):
    """The Rayleigh-Ritz blocks qw^H (A qw) and qw^H (B qw) on the host,
    each product formed in that order: right for any A, symmetric or not
    (the fault of ``real_pipeline.py:357-371`` is not copied)."""
    return _gram(qw, a_op(qw)), _gram(qw, b_op(qw))


def _sync_all(devices) -> None:
    for d in dict.fromkeys(devices):
        _sync(d)


def _initial_subspace(guess, n, m0, pipe, seed):
    if guess is not None:
        # np.array copies: a JAX array's numpy view is read-only
        y = guess if isinstance(guess, torch.Tensor) else torch.as_tensor(
            np.array(guess))
        if tuple(y.shape) != (n, m0):
            raise ValueError(f"geigsh: guess must have shape {(n, m0)}")
        return y.to(device=pipe.device, dtype=pipe.wdtype)
    gen = torch.Generator(device=pipe.device).manual_seed(seed)
    return torch.randn((n, m0), dtype=pipe.wdtype, device=pipe.device,
                       generator=gen)


def geigsh_pipeline(m0, interval, mat_a, mat_b, params, guess=None,
                    shards=None, rows=None):
    """The FEAST solver loop over the cached pipeline (mirrors the RCI event
    sequence, Feast.hs:220-232, with the loop owned natively).  Returns an
    ``EigResult``; fills :data:`last_run`.  ``shards``: the devices of a
    mesh's contour axis (the "sharded" contour), or None; ``rows``: the
    devices of its rows axis when it has more than one shard (the
    row-sharded subspace), or None.  The random blocks are drawn whole on
    the pipeline's device, as without ``rows``, and then split, so both
    runs start from the same subspace."""
    from sparse_linear_tpu_torch.dist.mesh import Mesh
    from sparse_linear_tpu_torch.dist.sharded import ShardedBlock
    from sparse_linear_tpu_torch.eig.feast import (
        INFO_NO_EIGENVALUES, INFO_NOT_CONVERGED, INFO_OK,
        INFO_SUBSPACE_TOO_SMALL, EigResult, _contour, _reduced_geig,
        _whiten_mat,
    )

    emin, emax = float(interval[0]), float(interval[1])
    n = mat_a.shape[0]
    pipe, fresh = _get_pipeline(mat_a, mat_b, params.backend, params.dims)
    dev = pipe.device
    a_op, b_op = pipe.a_op, pipe.b_op
    row_mesh, row_sizes = None, ()
    if rows:
        row_mesh = Mesh(list(rows), ("rows",))
        a_op, b_op = pipe.row_ops(row_mesh)
        row_sizes = [(d, -(-n // len(rows))) for d in row_mesh.shards("rows")]
    z, sigma = _contour(emin, emax, params.contour_points,
                        kind=params.quadrature)
    contour = pipe.contour(z, sigma, m0, params.contour_batching, shards,
                           row_sizes)
    refine_n = _refine_default(params, pipe)
    run = {"mode": contour.mode, "why": contour.why,
           "shard_mode": contour.shard_mode,
           "shards": [str(g[0].device) for g in contour.groups],
           "rows_shards": [str(d) for d, _ in row_sizes],
           "rows_local": row_sizes[0][1] if row_sizes else n,
           "analyze_s": pipe.analyze_s if fresh else 0.0,
           "factor_s": contour.factor_s, "loops": [],
           "needs_gb": {k: v / 1e9 for k, v in pipe.needs(len(z), m0).items()},
           "routes": (pipe.a_op.route, pipe.b_op.route)}
    last_run.clear()
    last_run.update(run)
    streamed_s = contour.factor_s
    if params.debug:
        print(f"feast(torch) contour {contour.mode}: {contour.why}")

    y = _initial_subspace(guess, n, m0, pipe, params.seed)
    sub_devices = [dev]
    if row_mesh is not None:
        y = ShardedBlock.from_tensor(y, row_mesh, "rows")
        sub_devices = list(dict.fromkeys([dev] + y.devices))
    rdt = real_of(pipe.wdtype)
    lam_scale = max(abs(emin), abs(emax), 1.0)
    tiny = np.finfo(np.float64).tiny
    info = INFO_NOT_CONVERGED
    epsout = np.inf
    eps_prev = np.inf
    lam_np = res_np = np.zeros((0,))
    sel = np.zeros((0,), dtype=np.int64)
    loops_done = stalls = 0
    prev = None
    b_ident = b_op.route == "identity"

    for loop in range(params.max_loops):
        loops_done = loop + 1
        gram0 = _gram.seconds
        t0 = time.perf_counter()
        # ---- contour filter (ijob=10/11); loop 0 is filter-limited, so
        # refinement starts with the second loop (real_pipeline.py:670)
        q = contour.apply(y, 0 if loop == 0 else refine_n, b_op)
        y = None
        _sync_all(sub_devices)
        t1 = time.perf_counter()
        # ---- whitening and reduced blocks: plain matmuls on the card,
        # the m0 x m0 eighs on the host
        g = _gram(q, q)
        t2 = time.perf_counter()
        wmat = _whiten_mat(g)
        t3 = time.perf_counter()
        qw = _times(q, wmat)
        del q
        aq, bq = _reduced_blocks(a_op, b_op, qw)
        t4 = time.perf_counter()
        lam, coeff = _reduced_geig(aq, bq)
        t5 = time.perf_counter()
        m_kept = int(coeff.shape[1])
        x = _times(qw, coeff)
        del qw
        lam_k = np.real(lam)[:m_kept]
        bx = x if b_ident else b_op(x)
        lam_t = torch.as_tensor(lam_k, dtype=rdt, device=dev)
        rn = _col_norms(a_op(x) - bx * lam_t[None, :])
        del bx
        norms = _host(torch.stack([rn, _col_norms(x)]))
        # ---- warm-restart subspace: kept Ritz columns + random refill
        fill = None
        if m_kept < m0:
            gen = torch.Generator(device=dev).manual_seed(
                params.seed + loop + 1)
            fill = torch.randn((n, m0 - m_kept), dtype=pipe.wdtype,
                               device=dev, generator=gen)
        y = _restart(x, fill, m0)
        del x, fill
        res_k = norms[0] / np.maximum(norms[1], tiny) / lam_scale
        _sync_all(sub_devices)
        t6 = time.perf_counter()
        gram_s = _gram.seconds - gram0
        products_s = (t2 - t1) + (t4 - t3) + (t6 - t5) - gram_s
        split = {"solve_s": t1 - t0 - (contour.factor_s - streamed_s),
                 "factor_s": contour.factor_s - streamed_s,
                 "rr_s": products_s + gram_s, "products_s": products_s,
                 "gram_s": gram_s, "eigh_s": (t3 - t2) + (t5 - t4)}
        streamed_s = contour.factor_s

        inside_k = (lam_k >= emin) & (lam_k <= emax)
        m_inside = int(inside_k.sum())
        eps_inside = float(res_k[inside_k].max()) if m_inside else (
            float(res_k.max()) if m_kept else np.inf)
        # ---- spurious-pair rejection (real_pipeline.py:771-800): a pair is
        # spurious only under a separation test (>= 1e6 x the 25th
        # percentile of inside residuals AND above 10 tol)
        genuine_k = inside_k.copy()
        if m_inside >= 4:
            thr = max(float(np.quantile(res_k[inside_k], 0.25)) * 1e6,
                      params.tol * 10.0)
            genuine_k &= res_k <= thr
        m_found = int(genuine_k.sum())
        epsout = float(res_k[genuine_k].max()) if m_found else eps_inside
        ghost_k = inside_k & ~genuine_k
        state = _LoopState(np.sort(lam_k[genuine_k]), lam_k[ghost_k],
                           res_k[ghost_k], epsout)
        n_spur = m_inside - m_found
        last_run["loops"].append(dict(
            split, genuine=m_found, rejected=n_spur, epsout=epsout,
            ghosts=[[float(v), float(r)] for v, r in
                    zip(state.ghosts, state.rejected)]))
        if params.debug:
            print(f"feast(torch) loop {loop}: m={m_found}, "
                  f"epsout={epsout:.3e}"
                  + (f" (+{n_spur} spurious rejected)" if n_spur else ""))
        lam_np, res_np = lam_k[genuine_k], res_k[genuine_k]
        sel = np.nonzero(genuine_k)[0]

        if m_found and eps_inside <= params.tol:
            info = INFO_OK  # every inside pair converged: no ghosts
            break
        if _ghost_converged(prev, state, params.tol, lam_scale):
            info = INFO_OK  # stable ghost-filtered convergence
            break
        prev = state
        if m_found == 0 and loop >= 2:
            info = INFO_NO_EIGENVALUES
            break
        # stagnation: two loops without meaningful progress mean the
        # solver-accuracy floor has been reached
        if loop >= 2 and epsout > 0.5 * eps_prev:
            stalls += 1
            if stalls >= 2:
                break
        else:
            stalls = 0
        eps_prev = min(eps_prev, epsout)

    if len(lam_np) == m0:
        # every Ritz pair inside: the subspace is (or may be) too small to
        # hold the invariant subspace (Feast.hs:252-257)
        info = INFO_SUBSPACE_TOO_SMALL
    order = np.argsort(lam_np)
    if isinstance(y, ShardedBlock):
        y = y.full(dev)
    vectors = y[:, torch.as_tensor(sel[order], device=dev)]
    return EigResult(values=lam_np[order], vectors=vectors,
                     n_found=len(lam_np), iterations=loops_done,
                     epsout=epsout, residuals=res_np[order], info=info,
                     subspace=y)


def count_pipeline(interval, mat_a, mat_b, params, x_np) -> float:
    """(1/s) Re sum_i x_i^H q_i with q one filter application to the s
    probes ``x_np`` (n, s), on the pencil's cached contour factors."""
    from sparse_linear_tpu_torch.eig.feast import _contour

    pipe, _ = _get_pipeline(mat_a, mat_b, params.backend, params.dims)
    z, sigma = _contour(float(interval[0]), float(interval[1]),
                        params.contour_points, kind=params.quadrature)
    s = x_np.shape[1]
    contour = pipe.contour(z, sigma, s, params.contour_batching)
    x = torch.as_tensor(x_np, device=pipe.device).to(pipe.wdtype)
    q = contour.apply(x, _refine_default(params, pipe))
    return float(torch.sum(x.conj() * q).real) / s
