"""Supernodal multifrontal sparse LU / Cholesky on the card.

Counterpart of :mod:`sparse_linear_tpu.solve.multifrontal`: staged symbolic
analysis / numeric factorization / triangular solves with reusable
artifacts, the capability the reference binds from UMFPACK (reference:
suitesparse/src/Numeric/LinearAlgebra/Umfpack/Internal.hs:69-148,
Umfpack.hs:38-102).

* ``analyze`` is numpy on the host, as in the JAX package, and given the
  same matrix and options produces the identical schedule: supernodes at
  the same tree level are grouped into **buckets** of identical padded
  shape (pivot class Ns x update class Us).  The supernode forest comes
  from the port's own host library (``utils/native.py``).
* ``factor`` runs each bucket as a few batched dense calls on the matrix's
  device: assembly by ``index_add_`` into the flattened fronts, partial
  factorization by ``torch.linalg.cholesky_ex`` / ``lu_factor_ex`` and
  ``solve_triangular``, the Schur complement by one ``baddbmm``.  These are
  XLA ops in the JAX package, not Pallas kernels, so here they are cuSOLVER
  and cuBLAS calls.  The loop runs eagerly with no host synchronisation;
  diagnostics stay device tensors until asked for.
* ``solve`` runs the level-batched forward and backward substitutions with
  the same calls.
* The level loops of both are steppers, generators that yield after each
  bucket's launches; every entry point runs them whole, except
  ``factor_batched_steps`` and ``solve_batched_steps``, which hand the
  steps to a caller that advances several cards' loops in turn (FEAST's
  sharded contour, ``eig/pipeline.py``).
* Spans (``utils.profiling.annotate``): ``slt.mf.analyze`` and its five
  stages (whose host seconds ``analyze`` also records on the symbolic it
  returns, ``MFSymbolic.stats``, with the schedule's counts),
  ``slt.mf.factor`` with ``slt.mf.factor.level`` a tree level,
  ``slt.mf.solve`` with ``slt.mf.solve.level`` a level of each pass; on
  the replay path (below) ``slt.mf.capture`` around a capture and
  ``slt.mf.factor.replay`` / ``slt.mf.solve.replay`` around a replay, which
  open no level span.

Front layout (per supernode, padded to its bucket's classes):

        Ns (pivot class)   Us (update class)
      +------------------+------------------+
   Ns |  F11 (pivots)    |  F12 (U block)   |    rows 0..ns-1   : pivot rows
      +------------------+------------------+    rows ns..Ns-1  : identity pad
   Us |  F21 (L block)   |  F22 (Schur)     |    rows Ns..Ns+us : update rows
      +------------------+------------------+

What differs from the JAX package, and why:

* The extend-add drops padding on the host side of the schedule, once per
  (symbolic, device): each (parent bucket, child bucket) pair keeps one
  source and one destination index per real entry, and one ``index_add_``
  places a whole child bucket.  (The JAX package places updates with
  one-hot matmuls, a TPU workaround.)  On CUDA ``index_add_`` sums
  duplicates with atomics, so factors agree with the JAX package to
  rounding, not bit for bit, and two factorizations may differ in the last
  bit.
* A child bucket's Schur updates are freed as soon as every parent bucket
  that reads them has been assembled.
* Local pivots: ``lu_factor_ex`` returns LAPACK's 1-based sequential swaps;
  they become the 0-based permutation the solves read (``A[perm] = L U``
  within the pivot block) through ``torch.lu_unpack``, on the device.
* Cholesky breakdown: ``cholesky_ex`` reports ``info > 0`` and a finite
  partial factor; such fronts are filled with NaN and counted, so
  ``breakdown`` and the solves behave as in the JAX package (which counts
  non-finite diagonal entries: the count differs, the contract does not).
* f32 products run in full f32 whatever the caller's
  ``torch.set_float32_matmul_precision`` (TF32 gave 2e-2 residuals at 1M
  dof in the JAX package's reduced-precision equivalent); the caller's
  setting is restored afterwards.
* No compiled-program cache and no f64-LU fail-fast: the H100 has native
  f64 and complex LU.
* ``factor(mesh=)`` splits each bucket's fronts over a mesh of shards from
  one process (``dist/``), where the JAX package lets XLA shard the batch
  axis and insert the extend-add collectives.
* Replay.  One pattern refactored with new values launches the same ~4,000
  small kernels every time (2,843 a factor, 1,223 a solve at 1M dof), and
  the card waits on the Python that launches them.  So ``factor(mat,
  symbolic, kind="cholesky")`` on a CUDA tensor with no mesh runs eagerly
  the first time for a (device, dtype, scale), and the second time
  captures its level loop as a CUDA graph (``torch.cuda.graphs``' recipe:
  one eager pass on a side stream, then the capture) and replays it, as
  every later call does: a one-shot factor, or a new pattern a call, pays
  nothing for a graph.  ``solve(factors, b)`` (not ``trans``) on the
  factors of the latest replay captures its graph when it repeats the
  previous solve's RHS (width, dtype) and replays it while the width
  repeats; a plan keeps one solve graph, the latest width's, and solves
  other widths eagerly on the same blocks.  The kernels, their order and
  their arithmetic are the eager path's.  The plan (:class:`_Plan`) is
  cached on the symbolic and holds a static value buffer, the graphs and
  their memory pools (about the eager factor's peak, freed with the
  symbolic), and the static output blocks, which each replay rewrites.
  Ownership: the factors a replay returns hold those blocks and are
  tracked by a weakref; if they are still referenced at the next replay,
  their blocks are copied first (a detach) and they solve eagerly from
  then on.  A replayed solve and ``row_scale`` return copies; a tensor
  taken out of ``blocks`` directly is the plan's until the detach (``to``
  copies it).  A lock serialises a plan's factors and solves, so threads
  that share a symbolic take turns.  Everything else runs eagerly as
  before: LU (FEAST's contour), ``factor_batched``/``solve_batched``,
  ``solve_part``, ``trans`` solves, the mesh path and CPU tensors.
  ``replay_counts()`` reads the path's counters.
"""

from __future__ import annotations

import contextlib
import threading
import time
import weakref

import numpy as np
import torch

from sparse_linear_tpu_torch.dtypes import default_device
from sparse_linear_tpu_torch.formats.matrix import from_triples
from sparse_linear_tpu_torch.ops.build import trim
from sparse_linear_tpu_torch.utils.profiling import annotate

__all__ = ["analyze", "factor", "factor_batched", "factor_batched_steps",
           "solve", "solve_batched", "solve_batched_steps", "solve_part",
           "slogdet", "rcond", "get_factors", "lunz", "replay_counts",
           "MFSymbolic", "MFFactors"]


def _class_of(x: int, lo: int = 8) -> int:
    c = lo
    while c < x:
        c *= 2
    return c


def _np(t) -> np.ndarray:
    """Host copy of a tensor (conjugate views resolved)."""
    if isinstance(t, torch.Tensor):
        return t.detach().resolve_conj().cpu().numpy()
    return np.asarray(t)


@contextlib.contextmanager
def _full_f32():
    """Full-precision f32 products (no TF32) inside, the caller's setting
    restored after."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _drain(steps):
    """Run the stepper ``steps`` (a generator) to its end; its return
    value."""
    while True:
        try:
            next(steps)
        except StopIteration as stop:
            return stop.value


def _f32_steps(steps):
    """The stepper ``steps`` with each of its steps run under
    :func:`_full_f32`, the setting restored between steps: steppers
    advanced in turn on one thread then never restore one another's
    setting in the middle of a step.  Its return value is ``steps``'."""
    while True:
        with _full_f32():
            try:
                next(steps)
            except StopIteration as stop:
                return stop.value
        yield


class MFSymbolic:
    """Symbolic artifact: ordering + supernode forest + bucket schedule.

    Host object of numpy arrays, reused across numeric factorizations with
    the same pattern; its device index maps are built once per device
    (``_device_maps``), its replay plans once per (device, dtype, scale)
    (:class:`_Plan`).

    ``stats``, filled by ``analyze`` (empty on a symbolic built otherwise):
    the host seconds of its five stages, ``order_s``, ``symmetrize_s``,
    ``symbolic_s``, ``schedule_s`` and ``maps_s`` (host clock, no device
    synchronisation), and the schedule's ``supernodes``, ``buckets`` and
    ``levels``.  It lives on the artifact, so threads that analyze at once
    keep their records apart."""

    backend = "multifrontal"

    def __init__(self, n, perm, schedule, pattern_key, a_entry_maps):
        self.n = n
        self.perm = perm              # elimination order (np.int32)
        self.iperm = np.empty_like(perm)
        self.iperm[perm] = np.arange(n, dtype=perm.dtype)
        self.schedule = schedule      # flat buckets + level lists
        self.pattern_key = pattern_key  # (nnz, hash) for cheap validation
        self.a_entry_maps = a_entry_maps  # per-bucket A-entry scatter arrays
        self._dev_maps = {}
        self._plans = {}
        self.stats = {}


class MFFactors:
    """Numeric artifact: per-bucket dense factor blocks on the device.

    ``blocks[bidx]`` holds ``lu`` (nb, Ns, Ns), ``perm`` (nb, Ns), ``g21``
    (nb, Us, Ns) and ``g12`` (nb, Ns, Us), with a leading (ne,) axis for
    ``factor_batched``; ``blocks[-1]["n_flag"]`` the diagnostic count per
    value-set, ``blocks[-2]["rscale"]`` the equilibration vector."""

    backend = "multifrontal"

    def __init__(self, symbolic: MFSymbolic, blocks, dtype, kind="lu",
                 batch=None):
        self.symbolic = symbolic
        self.blocks = blocks
        self.n = symbolic.n
        self.dtype = dtype
        self.kind = kind  # "lu" (restricted partial pivoting) | "cholesky"
        self.batch = batch
        self._plan = None  # the _Plan whose static blocks these are

    @property
    def device(self) -> torch.device:
        return self.blocks[-1]["n_flag"].device

    def _mapped(self, fn) -> dict:
        """The blocks with ``fn`` applied to each stored tensor; a
        Cholesky g21 stays the view g12^H."""
        blocks = {k: {name: fn(t) for name, t in blk.items()
                      if not (self.kind == "cholesky" and name == "g21")}
                  for k, blk in self.blocks.items()}
        if self.kind == "cholesky":
            for k, blk in blocks.items():
                if k >= 0:
                    blk["g21"] = blk["g12"].mH
        return blocks

    def to(self, device) -> "MFFactors":
        """The same factors on ``device``; a replay's static blocks are
        copied even to their own device, so the result owns its blocks."""
        copy = self._plan is not None
        return MFFactors(self.symbolic,
                         self._mapped(lambda t: t.to(device, copy=copy)),
                         self.dtype, self.kind, self.batch)

    @property
    def n_flagged(self) -> int:
        """LU: number of statically perturbed pivots (0 = exact partial
        pivoting inside every pivot block); Cholesky: number of fronts
        whose factorization broke down (> 0 = the matrix was NOT positive
        definite).  Host sync on access."""
        d = self.blocks.get(-1)
        return 0 if d is None else int(d["n_flag"].sum())

    @property
    def breakdown(self) -> bool:
        """True when the Cholesky path hit a non-SPD pivot (those fronts
        hold NaN, and solves return NaNs)."""
        return self.kind == "cholesky" and self.n_flagged > 0

    @property
    def row_scale(self):
        """Equilibration vector (UMFPACK's R) when factored with ``scale=``,
        else None; original row coordinates."""
        sc = self.blocks.get(-2)
        if sc is None:
            return None
        # a replay's vector is rewritten by the plan's next factor
        return sc["rscale"] if self._plan is None else sc["rscale"].clone()


# ---------------------------------------------------------------------------
# symbolic / schedule construction (host)
# ---------------------------------------------------------------------------


def _pattern_key(mat):
    step = max(1, mat.nnz // 97)
    return (int(mat.nnz), int(mat.indices[::step].to(torch.int64).sum()))


def _below_index(nsuper, n, rows_ptr, rows, nc_arr):
    """Global search structure over all below-pivot frontal rows: a single
    sorted key array (supernode-major, row-minor) enabling ONE vectorized
    searchsorted for every locate query."""
    seg_ids = np.repeat(np.arange(nsuper), np.diff(rows_ptr))
    pos_in_seg = np.arange(rows.shape[0]) - rows_ptr[seg_ids]
    mask = pos_in_seg >= nc_arr[seg_ids]
    below_rows = rows[mask]
    below_seg = seg_ids[mask]
    below_ptr = np.zeros(nsuper + 1, dtype=np.int64)
    np.add.at(below_ptr, below_seg + 1, 1)
    below_ptr = np.cumsum(below_ptr)
    gkey = below_seg * np.int64(n + 1) + below_rows
    return below_ptr, below_rows, below_seg, gkey


def _locate_vec(sup_ids, rowvals, sup_start, nc_arr, below_ptr, gkey, n):
    """Vectorized local front coordinates: pivot rows by offset, below rows
    by one global searchsorted over the supernode-major key array."""
    c0 = sup_start[sup_ids]
    c1 = sup_start[sup_ids + 1]
    is_piv = rowvals < c1
    q = sup_ids * np.int64(n + 1) + rowvals
    below_pos = np.searchsorted(gkey, q) - below_ptr[sup_ids]
    return np.where(is_piv, rowvals - c0, nc_arr[sup_ids] + below_pos)


def analyze(mat, ordering: str = "auto", dims=None,
            relax_small: int = 16, relax_frac: float = 0.25,
            perm=None, engine: str = "native") -> MFSymbolic:
    """Symbolic analysis: ordering, supernode forest, bucket schedule.

    ``dims``: grid dimensions when the matrix is a structured-grid operator
    — enables geometric nested dissection.  Otherwise AMD (native C++).
    ``perm``: explicit elimination order (overrides ``ordering``) — used to
    re-derive a schedule from a carried-over symbolic artifact.
    ``engine``: "native" (the host library) or "python" (the plain
    version, ``solve/symbolic_py.py``; small problems and tests only), for
    the symmetrized pattern and the symbolic analysis.
    Host work on numpy arrays: the matrix's pattern is copied to the host
    once.  The call is the span ``slt.mf.analyze``, its stages the spans
    ``slt.mf.analyze.order``, ``.symmetrize``, ``.symbolic``, ``.schedule``
    and ``.maps``, whose host seconds the result's ``stats`` records.  The
    pattern of A + A^T + I is built in ``symmetrize`` under the ordering,
    and in ``order`` unpermuted, as the span
    ``slt.mf.analyze.order.symmetrize``, where a general-graph ordering
    needs it."""
    with annotate("slt.mf.analyze"):
        return _analyze(mat, ordering, dims, relax_small, relax_frac, perm,
                        engine)


@contextlib.contextmanager
def _stage(stats: dict, name: str):
    """The stage ``name`` of ``analyze``: its span, and its host seconds
    into ``stats[name + "_s"]``."""
    with annotate("slt.mf.analyze." + name):
        t0 = time.perf_counter()
        yield
        stats[name + "_s"] = time.perf_counter() - t0


def _analyze(mat, ordering, dims, relax_small, relax_frac, perm, engine):
    from sparse_linear_tpu_torch.solve import ordering as ord_mod
    from sparse_linear_tpu_torch.solve.symbolic_py import (python_symbolic,
                                                           python_symmetrize)
    from sparse_linear_tpu_torch.utils.native import (native_symbolic,
                                                      native_symmetrize)

    mat = trim(mat.tocsr())
    n = mat.shape[0]
    if mat.shape[0] != mat.shape[1]:
        raise ValueError("analyze: matrix must be square")
    if engine not in ("native", "python"):
        raise ValueError(f"unknown symbolic engine: {engine!r}")
    native = engine == "native"
    symmetrize = native_symmetrize if native else python_symmetrize
    indptr = _np(mat.indptr).astype(np.int64)
    indices = _np(mat.indices)
    stats = {}

    with _stage(stats, "order"):
        if perm is None:
            if ordering == "auto":
                ordering = "nd" if dims is not None else "amd"
            if ordering in ("nd", "nested-dissection") and dims is not None:
                perm = ord_mod.nested_dissection_grid(dims)
            elif ordering in ("nd", "nested-dissection", "rcm", "amd"):
                with annotate("slt.mf.analyze.order.symmetrize"):
                    sp_ip, sp_ix = symmetrize(
                        n, indptr, indices, np.arange(n, dtype=np.int32))
                fn = {"rcm": ord_mod.rcm, "amd": ord_mod.amd}.get(
                    ordering, ord_mod.nested_dissection)
                perm = fn(sp_ip, sp_ix, n)
            elif ordering == "natural":
                perm = ord_mod.natural(n)
            else:
                raise ValueError(f"unknown ordering: {ordering}")
        perm = np.asarray(perm, dtype=np.int32)
        if perm.shape != (n,):
            raise ValueError(f"analyze: perm must have shape ({n},)")

    with _stage(stats, "symmetrize"):
        ip, ix = symmetrize(n, indptr, indices, perm)
    with _stage(stats, "symbolic"):
        symbolic = native_symbolic if native else python_symbolic
        sym = symbolic(n, ip, ix, relax_small, relax_frac)

    with _stage(stats, "schedule"):
        nsuper = sym["nsuper"]
        sup_start = sym["sup_start"].astype(np.int64)
        sup_parent = sym["sup_parent"]
        sup_level = sym["sup_level"]
        rows_ptr = sym["rows_ptr"].astype(np.int64)
        rows = sym["rows"].astype(np.int64)

        sup_of = np.repeat(np.arange(nsuper, dtype=np.int64),
                           np.diff(sup_start))
        nc_arr = np.diff(sup_start)
        fs_arr = np.diff(rows_ptr)
        us_arr = fs_arr - nc_arr

        # ---- bucket assignment: (level, Ns class, Us class)
        ns_class = np.array([_class_of(int(c)) for c in nc_arr])
        us_class = np.array([_class_of(int(u)) if u > 0 else 8
                             for u in us_arr])
        height = sym["height"]

        buckets = {}  # (lvl, Ns, Us) -> list of sup ids
        for s in range(nsuper):
            key = (int(sup_level[s]), int(ns_class[s]), int(us_class[s]))
            buckets.setdefault(key, []).append(s)
        # canonical bucket ordering per level
        level_buckets = [[] for _ in range(height + 1)]
        bucket_of_sup = np.empty(nsuper, dtype=np.int64)  # flat bucket index
        slot_of_sup = np.empty(nsuper, dtype=np.int64)
        flat = []
        for (lvl, nsc, usc), ids in sorted(buckets.items()):
            bidx = len(flat)
            flat.append({"level": lvl, "Ns": nsc, "Us": usc,
                         "sup_ids": np.asarray(ids, dtype=np.int64)})
            level_buckets[lvl].append(bidx)
            bucket_of_sup[ids] = bidx
            slot_of_sup[ids] = np.arange(len(ids))

    with _stage(stats, "maps"):
        # ---- global locate structure (one searchsorted serves every query)
        below_ptr, below_rows, below_seg, gkey = _below_index(
            nsuper, n, rows_ptr, rows, nc_arr)

        def locate_padded(s_ids, rowvals):
            loc = _locate_vec(s_ids, rowvals, sup_start, nc_arr, below_ptr,
                              gkey, n)
            nc_s = nc_arr[s_ids]
            return np.where(loc < nc_s, loc, loc - nc_s + ns_class[s_ids])

        # ---- A-entry scatter maps (permuted entries -> (bucket, slot, r, c))
        e_rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        e_cols = indices.astype(np.int64)
        iperm = np.empty(n, dtype=np.int64)
        iperm[perm] = np.arange(n)
        pr, pc = iperm[e_rows], iperm[e_cols]
        owner = sup_of[np.minimum(pr, pc)]
        pad_r = locate_padded(owner, pr)
        pad_c = locate_padded(owner, pc)

        a_entry_maps = {}
        owner_bucket = bucket_of_sup[owner]
        for bidx in range(len(flat)):
            in_b = owner_bucket == bidx
            a_entry_maps[bidx] = {
                "src": np.nonzero(in_b)[0].astype(np.int32),
                "slot": slot_of_sup[owner[in_b]].astype(np.int32),
                "r": pad_r[in_b].astype(np.int32),
                "c": pad_c[in_b].astype(np.int32),
            }

        # ---- child extend-add maps: ONE global locate for all update rows,
        # then vectorized padded-map assembly per (parent bucket, child bucket)
        has_parent = (sup_parent >= 0) & (us_arr > 0)
        child_ids = np.nonzero(has_parent)[0]
        parent_of = sup_parent[child_ids].astype(np.int64)
        q_sup = np.repeat(parent_of, us_arr[child_ids])
        # below_rows is supernode-major, so the children's update rows (in
        # ascending child id order) are exactly the masked selection
        q_mask = has_parent[below_seg]
        q_rows = below_rows[q_mask]
        located = locate_padded(q_sup, q_rows) if q_rows.size else q_rows

        child_groups = {}
        # group (child, parent) pairs by bucket pair
        pair_key = (bucket_of_sup[parent_of] * len(flat)
                    + bucket_of_sup[child_ids])
        order_p = np.argsort(pair_key, kind="stable")
        sorted_keys = pair_key[order_p]
        # offsets of each child's located block within `located`
        loc_ofs = np.zeros(child_ids.shape[0] + 1, dtype=np.int64)
        np.cumsum(us_arr[child_ids], out=loc_ofs[1:])
        for key in np.unique(pair_key):
            sel = order_p[np.searchsorted(sorted_keys, key):
                          np.searchsorted(sorted_keys, key, side="right")]
            pb = int(key) // len(flat)
            cb = int(key) % len(flat)
            cs = child_ids[sel]
            uc = flat[cb]["Us"]
            m_idx = loc_ofs[sel][:, None] + np.arange(uc)[None, :]
            valid = np.arange(uc)[None, :] < us_arr[cs][:, None]
            maps = np.where(valid,
                            located[np.minimum(m_idx,
                                               located.shape[0] - 1)], -1)
            child_groups.setdefault(pb, {})[cb] = {
                "cslot": slot_of_sup[cs].astype(np.int32),
                "pslot": slot_of_sup[sup_parent[cs]].astype(np.int32),
                "maps": maps.astype(np.int32),
            }

        # ---- per-bucket solve row maps (padded with sentinel n), vectorized
        for bidx, b in enumerate(flat):
            ids = b["sup_ids"]
            ns_c, us_c = b["Ns"], b["Us"]
            ar_ns = np.arange(ns_c)[None, :]
            ar_us = np.arange(us_c)[None, :]
            nc_b = nc_arr[ids][:, None]
            us_b = us_arr[ids][:, None]
            rows_piv = np.where(ar_ns < nc_b,
                                sup_start[ids][:, None] + ar_ns, n)
            bidx_mat = below_ptr[ids][:, None] + ar_us
            rows_upd = np.where(
                ar_us < us_b,
                below_rows[np.minimum(bidx_mat, below_rows.shape[0] - 1)]
                if below_rows.size
                else n,
                n,
            )
            b["rows_piv"] = rows_piv.astype(np.int32)
            b["rows_upd"] = rows_upd.astype(np.int32)
            b["ns_real"] = nc_arr[ids].astype(np.int32)
            b["children"] = child_groups.get(bidx, {})

    schedule = {
        "flat": flat,
        "level_buckets": level_buckets,
        "height": height,
        "nsuper": nsuper,
    }
    out = MFSymbolic(n, perm, schedule, _pattern_key(mat), a_entry_maps)
    out.relax = (int(relax_small), float(relax_frac))
    # entry coordinates in canonical CSR order — lets factor()/
    # factor_batched() equilibrate value-sets without re-deriving them
    out.entry_rows = e_rows.astype(np.int32)
    out.entry_cols = e_cols.astype(np.int32)
    out.stats = dict(stats, supernodes=int(nsuper), buckets=len(flat),
                     levels=len(level_buckets))
    return out


# ---------------------------------------------------------------------------
# device index maps (built once per symbolic and device)
# ---------------------------------------------------------------------------


def _narrow(idx: torch.Tensor) -> torch.Tensor:
    """int32 where every index fits, else int64 (a sync, once per map)."""
    if idx.numel() == 0 or int(idx.max()) < 2**31:
        return idx.to(torch.int32)
    return idx


def _extend_add_maps(g, fs: int, uc: int, device):
    """(src, dst) flat indices of the REAL entries of one (parent bucket,
    child bucket) pair: entry (a, b) of child i's update, a, b < us_i, is
    read at ``src`` of the child bucket's flattened updates and added at
    ``dst`` of the parent bucket's flattened fronts.  Padding is dropped
    here, once.  Built with torch on ``device`` (at 1M dof a pair can hold
    tens of millions of entries)."""
    us_np = (g["maps"] >= 0).sum(axis=1).astype(np.int64)
    cnt_np = us_np * us_np
    total = int(cnt_np.sum())

    def dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    cslot, pslot, maps = dev(g["cslot"]), dev(g["pslot"]), dev(g["maps"])
    us, cnt = dev(us_np), dev(cnt_np)
    i = torch.repeat_interleave(torch.arange(us.shape[0], device=device),
                                cnt, output_size=total)
    start = torch.cumsum(cnt, 0) - cnt
    local = torch.arange(total, device=device) - start[i]
    usi = us[i]
    a = torch.div(local, usi, rounding_mode="floor")
    b = local - a * usi
    del local, usi, start
    src = (cslot[i] * uc + a) * uc + b
    dst = (pslot[i] * fs + maps[i, a]) * fs + maps[i, b]
    return _narrow(src), _narrow(dst)


def _device_maps(symbolic: MFSymbolic, device):
    """Schedule index maps as device tensors (built once per device,
    cached on the symbolic)."""
    device = torch.device(device)
    key = str(device)
    if key in symbolic._dev_maps:
        return symbolic._dev_maps[key]
    flat = symbolic.schedule["flat"]

    def dev(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    dm = {"a": {}, "children": {}, "rows_piv": {}, "rows_upd": {},
          "pad": {}, "readers": {},
          "perm": dev(symbolic.perm), "iperm": dev(symbolic.iperm),
          "entry_rows": dev(symbolic.entry_rows),
          "entry_cols": dev(symbolic.entry_cols)}
    for bidx, b in enumerate(flat):
        am = symbolic.a_entry_maps[bidx]
        ns_c, fs = b["Ns"], b["Ns"] + b["Us"]
        flat_rc = ((am["slot"].astype(np.int64) * fs + am["r"]) * fs
                   + am["c"])
        dm["a"][bidx] = {"src": dev(am["src"]),
                         "dst": _narrow(dev(flat_rc))}
        dm["children"][bidx] = [
            (cb, *_extend_add_maps(g, fs, flat[cb]["Us"], device))
            for cb, g in sorted(b["children"].items())]
        for cb in b["children"]:
            dm["readers"][cb] = dm["readers"].get(cb, 0) + 1
        dm["rows_piv"][bidx] = dev(b["rows_piv"])
        dm["rows_upd"][bidx] = dev(b["rows_upd"])
        dm["pad"][bidx] = dev(np.arange(ns_c)[None, :]
                              >= b["ns_real"][:, None], torch.bool)
    symbolic._dev_maps[key] = dm
    return dm


# ---------------------------------------------------------------------------
# numeric factorization (device)
# ---------------------------------------------------------------------------


def _bucket_factor_cholesky(front, ns_class, pivot_eps=0.0):
    """Batched Cholesky partial factorization of assembled SPD fronts
    (E*nb, fs, fs).  g21 = g12^H is kept as a view.  Returns (lu, perm,
    g21, g12, schur, n_bad) with n_bad (E*nb,) the fronts that broke
    down, whose factors are set to NaN."""
    f11 = front[:, :ns_class, :ns_class]
    f12 = front[:, :ns_class, ns_class:]
    f22 = front[:, ns_class:, ns_class:]
    low, info = torch.linalg.cholesky_ex(f11)
    bad = info > 0
    low.masked_fill_(bad[:, None, None], float("nan"))
    g12 = torch.linalg.solve_triangular(low, f12, upper=False)
    g21 = g12.mH
    schur = torch.baddbmm(f22, g21, g12, alpha=-1)
    perm = torch.arange(ns_class, dtype=torch.int32,
                        device=front.device).expand(front.shape[0], ns_class)
    return low, perm, g21, g12, schur, bad


def _nonneg(d):
    """d >= 0, with complex numbers ordered lexicographically (real part,
    then imaginary) as the JAX package compares them."""
    if not d.is_complex():
        return d >= 0
    return (d.real > 0) | ((d.real == 0) & (d.imag >= 0))


def _lu_factor(f11):
    """``torch.linalg.lu_factor_ex`` of a bucket's pivot blocks, on the
    card under torch's cuSOLVER backend (the caller's choice restored
    after): getrf a block from 512 on, cuBLAS's batched getrf below.  The
    default backend sends every batch of blocks above 128 to MAGMA's
    batched getrf, which launches several kernels a column of every block
    (132,088 launches for two 68^3 complex128 node factors), and on an
    H100 took 2.20 s there against cuSOLVER's 1.63 s, and 0.145 s against
    0.097 s for one 1024^2 node."""
    if f11.device.type != "cuda":
        return torch.linalg.lu_factor_ex(f11)
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        return torch.linalg.lu_factor_ex(f11)
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def _bucket_factor(front, ns_class, pivot_eps: float = 0.0):
    """Batched partial factorization with partial pivoting inside each
    pivot block.  Returns (lu, perm, g21, g12, schur, npert).

    ``pivot_eps`` > 0 enables **static pivot perturbation** (the
    SuperLU-dist/MUMPS "GESP" strategy): after the in-block partial-pivoted
    LU, any |U_ii| below pivot_eps * max|front| is bumped to that threshold
    (sign preserved); ``npert`` (E*nb,) counts the perturbed pivots."""
    f11 = front[:, :ns_class, :ns_class]
    f12 = front[:, :ns_class, ns_class:]
    f21 = front[:, ns_class:, :ns_class]
    f22 = front[:, ns_class:, ns_class:]
    lu, pivots, _ = _lu_factor(f11)
    # LAPACK's 1-based sequential swaps -> the permutation with
    # f11[perm] = L U: column i of P (f11 = P L U) has its one in row perm[i]
    p_mat = torch.lu_unpack(lu, pivots, unpack_data=False)[0]
    permutation = torch.argmax(torch.real(p_mat), dim=-2)
    del p_mat
    npert = torch.zeros(front.shape[0], dtype=torch.int64,
                        device=front.device)
    if pivot_eps:
        diag = torch.diagonal(lu, dim1=-2, dim2=-1)
        scale = torch.amax(torch.abs(front), dim=(1, 2))
        thresh = pivot_eps * torch.clamp_min(
            scale, torch.finfo(scale.dtype).tiny)[:, None]
        small = torch.abs(diag) < thresh
        sgn = torch.where(_nonneg(diag), 1.0, -1.0).to(diag.dtype)
        diag.copy_(torch.where(small, sgn * thresh.to(diag.dtype), diag))
        npert = small.sum(dim=1)
    # L^{-1} P F12
    pf12 = torch.gather(
        f12, 1, permutation[:, :, None].expand(-1, -1, f12.shape[2]))
    g12 = torch.linalg.solve_triangular(lu, pf12, upper=False,
                                        unitriangular=True)
    # F21 U^{-1}
    g21 = torch.linalg.solve_triangular(lu, f21, upper=True, left=False)
    schur = torch.baddbmm(f22, g21, g12, alpha=-1)
    return lu, permutation.to(torch.int32), g21, g12, schur, npert


def _mesh_parts(symbolic: MFSymbolic, dm, devices):
    """How a mesh of ``devices`` splits each bucket: None for a bucket whose
    front count does not divide by the shard count (it stays whole on
    ``devices[0]``, where the JAX package replicates it), else one part a
    shard, (device, A-entry src, dst, [(child bucket, src, dst)], pad), for
    a contiguous group of its fronts.  The maps are the whole bucket's
    (``dm``, on ``devices[0]``) cut to the group's destination range and
    rebased, in their order; built once per (symbolic, devices)."""
    key = ("mesh",) + tuple(str(d) for d in devices)
    if key in symbolic._dev_maps:
        return symbolic._dev_maps[key]
    ndev = len(devices)
    parts = {}
    for bidx, b in enumerate(symbolic.schedule["flat"]):
        nb = b["sup_ids"].shape[0]
        if nb % ndev:
            parts[bidx] = None
            continue
        nbl = nb // ndev
        fs = b["Ns"] + b["Us"]
        span = nbl * fs * fs
        parts[bidx] = []
        for g, dev in enumerate(devices):
            lo = g * span

            def cut(src, dst):
                keep = (dst >= lo) & (dst < lo + span)
                return src[keep].to(dev), (dst[keep] - lo).to(dev)

            am = dm["a"][bidx]
            parts[bidx].append((
                dev, *cut(am["src"], am["dst"]),
                [(cb, *cut(src, dst)) for cb, src, dst in
                 dm["children"][bidx]],
                dm["pad"][bidx][g * nbl:(g + 1) * nbl].to(dev)))
    symbolic._dev_maps[key] = parts
    return parts


def _by_level(level_buckets, span: str, down: bool = False,
              direction: str | None = None):
    """The flat bucket indices level by level, bottom-up (top-down with
    ``down``), each level inside the span ``span``, whose args are the
    level (and ``direction``)."""
    lvls = range(len(level_buckets))
    for lvl in (reversed(lvls) if down else lvls):
        with annotate(span, lvl if direction is None else (lvl, direction)):
            yield from level_buckets[lvl]


def _factor_run(symbolic: MFSymbolic, dm, a_data, kind: str,
                pivot_eps: float, parts=None):
    """The level/bucket loop over E value-sets ``a_data`` (E, nnz), as a
    stepper: a generator that yields after each bucket's launches and
    returns the blocks (:func:`_drain` runs it whole).

    Blocks come out (E, nb, ...) on ``a_data``'s device.  No host
    synchronisation inside: the diagnostic count stays a device tensor
    (E,).  ``parts`` (:func:`_mesh_parts`) splits buckets over a mesh: each
    part is assembled and factored on its shard's device, a child bucket's
    updates are gathered in shard order to each device that assembles a
    parent part (once a device, whatever the parts there) before the
    extend-add reads them, and a split bucket's blocks are gathered back to
    ``a_data``'s device."""
    from sparse_linear_tpu_torch.dist.collectives import fresh, gather

    flat = symbolic.schedule["flat"]
    bucket_fn = (_bucket_factor_cholesky if kind == "cholesky"
                 else _bucket_factor)
    ne = a_data.shape[0]
    dtype, device = a_data.dtype, a_data.device
    a_on = {device: a_data}
    blocks = {}
    updates = {}  # bucket -> its Schur updates: (E, nb_part, Us, Us) a part
    pending = dict(dm["readers"])
    n_flag = torch.zeros(ne, dtype=torch.int64, device=device)
    for bidx in _by_level(symbolic.schedule["level_buckets"],
                          "slt.mf.factor.level"):
        b = flat[bidx]
        nb = b["sup_ids"].shape[0]
        ns_c, us_c = b["Ns"], b["Us"]
        fs = ns_c + us_c
        split = None if parts is None else parts[bidx]
        if split is None:
            am = dm["a"][bidx]
            split = [(device, am["src"], am["dst"], dm["children"][bidx],
                      dm["pad"][bidx])]
        fronts = []
        got = {}  # (child bucket, device): its updates gathered there
        for dev, a_src, a_dst, children, pad in split:
            if dev not in a_on:
                a_on[dev] = fresh(a_data, dev)
            nbp = pad.shape[0]
            front = torch.zeros((ne, nbp * fs * fs), dtype=dtype,
                                device=dev)
            if a_src.shape[0]:
                front.index_add_(1, a_dst,
                                 a_on[dev].index_select(1, a_src))
            for cb, src, dst in children:
                if (cb, dev) not in got:
                    u = updates[cb]
                    got[cb, dev] = (
                        u[0] if len(u) == 1 and u[0].device == dev
                        else gather(u, dev, dim=1)).reshape(ne, -1)
                front.index_add_(1, dst,
                                 got[cb, dev].index_select(1, src))
            front = front.view(ne, nbp, fs, fs)
            torch.diagonal(front, dim1=2, dim2=3)[..., :ns_c] += \
                pad.to(dtype)
            fronts.append(front)
        del got
        for cb, _, _ in dm["children"][bidx]:
            pending[cb] -= 1
            if pending[cb] == 0:
                del updates[cb]
        out = []
        while fronts:
            front = fronts.pop(0)
            nbp = front.shape[1]
            out.append((nbp,) + bucket_fn(front.view(ne * nbp, fs, fs),
                                          ns_c, pivot_eps))
            del front

        def joined(i, shape):
            ts = [o[i].reshape((ne, o[0]) + shape) for o in out]
            if len(ts) == 1:
                return ts[0]
            # gathered in the unsharded layout (torch.linalg's
            # column-major blocks), so that a solve runs the same BLAS
            # paths on them, bitwise
            order = sorted(range(ts[0].ndim),
                           key=lambda d: -ts[0].stride(d))
            back = [order.index(d) for d in range(len(order))]
            return gather([t.permute(order) for t in ts], device,
                          dim=order.index(1)).permute(back)

        for o in out:
            n_flag += o[6].view(ne, o[0]).sum(dim=1).to(device)
        blocks[bidx] = {
            "lu": joined(1, (ns_c, ns_c)),
            "perm": joined(2, (ns_c,)),
            "g21": joined(3, (us_c, ns_c)),
            "g12": joined(4, (ns_c, us_c)),
        }
        if kind == "cholesky" and len(out) > 1:
            # the unsharded views: the identity permutation expanded
            # and g21 = g12^H
            blk = blocks[bidx]
            blk["perm"] = blk["perm"][:1, :1].expand(ne, nb, ns_c)
            blk["g21"] = blk["g12"].mH
        if pending.get(bidx):
            updates[bidx] = [o[5].view(ne, o[0], us_c, us_c)
                             for o in out]
        del out
        yield
    blocks[-1] = {"n_flag": n_flag}
    return blocks


def _equilibrate(a_data, symbolic: MFSymbolic, dm, kind: str, scale: str):
    """Scale the value-set(s) ``a_data`` (..., nnz) before factorization —
    UMFPACK's default strategy (UMFPACK_SCALE_SUM / UMFPACK_SCALE_MAX,
    umfpack.h: each row is divided by its absolute sum or max).

    LU kind: row scaling M = R A.  Cholesky kind: symmetric scaling
    M = S A S with S = 1/sqrt(row measure), which keeps positive
    definiteness.  Returns (scaled data, scale vector (..., n) in ORIGINAL
    row coordinates).  Empty rows scale by 1."""
    n = symbolic.n
    rows, cols = dm["entry_rows"], dm["entry_cols"]
    mag = torch.abs(a_data)
    meas = torch.zeros(a_data.shape[:-1] + (n,), dtype=mag.dtype,
                       device=mag.device)
    if scale == "sum":
        meas.index_add_(-1, rows, mag)
    elif scale == "max":
        meas.scatter_reduce_(-1, rows.expand_as(mag), mag, "amax")
    else:
        raise ValueError(f"unknown scale mode: {scale!r} "
                         "(expected 'sum', 'max', or 'none')")
    r = torch.where(meas > 0,
                    1.0 / torch.clamp_min(meas, torch.finfo(mag.dtype).tiny),
                    1.0)
    if kind == "cholesky":
        s = torch.sqrt(r)
        return a_data * (s[..., rows] * s[..., cols]).to(a_data.dtype), s
    return a_data * r[..., rows].to(a_data.dtype), r


def factor(mat, symbolic: MFSymbolic, kind: str = "lu",
           mesh=None, batch_axis: str | None = None,
           pivot_eps: float | None = None,
           scale: str = "none") -> MFFactors:
    """Numeric factorization over the symbolic schedule, on the matrix's
    device.

    ``kind``: "lu" (default — restricted partial pivoting, general
    matrices) or "cholesky" (SPD matrices; a front that is not positive
    definite is reported by ``breakdown`` and holds NaN).

    ``scale``: "sum" or "max" enables equilibration before factorization
    (UMFPACK's row scaling; symmetric sqrt scaling for Cholesky); solves
    unscale transparently.  ``pivot_eps``: static pivot perturbation (LU).

    ``mesh`` (a ``dist.mesh.Mesh``): each bucket's independent fronts are
    split over ``mesh.shards(batch_axis or mesh.axis_names[0])``: a bucket
    whose front count divides by the shard count is assembled and factored
    in contiguous groups, one a shard, on the shard's device; any other
    bucket stays whole on the first shard (the JAX package replicates it).
    The factor blocks come back gathered on the first shard's device, in
    the layout every solve and query takes.  On the CPU they are bitwise
    the unsharded factorization's."""
    with annotate("slt.mf.factor"):
        mat = trim(mat.tocsr())
        n = symbolic.n
        if mat.shape != (n, n):
            raise ValueError("factor: matrix shape does not match symbolic")
        if _pattern_key(mat) != symbolic.pattern_key:
            raise ValueError(
                "factor: matrix pattern does not match the symbolic analysis "
                "(analyze once per pattern, factor per value set)"
            )
        a_data = mat.data
        if mesh is None and kind == "cholesky" and _captures(a_data.device):
            key = (str(a_data.device), a_data.dtype, scale)
            if key in symbolic._plans:
                return symbolic._plans[key].factor(symbolic, a_data)
            # the first factor of a key runs eagerly; the second captures
            symbolic._plans[key] = _Plan(scale)
        devices = None
        if mesh is not None:
            devices = mesh.shards(batch_axis or mesh.axis_names[0])
            a_data = a_data.to(devices[0])
        dm = _device_maps(symbolic, a_data.device)
        parts = None if devices is None else _mesh_parts(symbolic, dm, devices)
        peps = float(pivot_eps) if pivot_eps else 0.0
        blocks = _factor_blocks(symbolic, dm, a_data, kind, scale, peps, parts)
        return MFFactors(symbolic, blocks, a_data.dtype, kind=kind)


def _factor_blocks(symbolic: MFSymbolic, dm, a_data, kind: str, scale: str,
                   pivot_eps: float = 0.0, parts=None) -> dict:
    """The blocks of one value-set ``a_data`` (nnz,): equilibration, the
    level loop, the value-set axis dropped."""
    rscale = None
    if scale != "none":
        a_data, rscale = _equilibrate(a_data, symbolic, dm, kind, scale)
    with _full_f32():
        blocks = _drain(_factor_run(symbolic, dm, a_data[None], kind,
                                    pivot_eps, parts))
    blocks = {k: {name: t[0] for name, t in blk.items()}
              for k, blk in blocks.items()}
    if rscale is not None:
        blocks[-2] = {"rscale": rscale}  # scaling pseudo-bucket
    return blocks


def factor_batched(data_stack, symbolic: MFSymbolic,
                   kind: str = "lu", scale: str = "none",
                   *, device=None) -> MFFactors:
    """Batched numeric factorization: ``data_stack`` (ne, nnz) holds ne
    value-sets over the SAME pattern (e.g. FEAST's shifted matrices
    z_k B - A).  The ne sets fold into each bucket's batch dimension, so
    every bucket is still one call per step.  A host array goes to
    ``device`` (by default the card); a tensor keeps its device."""
    return _drain(factor_batched_steps(data_stack, symbolic, kind, scale,
                                       device=device))


def factor_batched_steps(data_stack, symbolic: MFSymbolic,
                         kind: str = "lu", scale: str = "none",
                         *, device=None):
    """:func:`factor_batched` as a stepper: a generator that yields after
    each bucket's launches and returns the factors, so that one host thread
    can keep several cards' factorizations queued by advancing them in
    turn.  Each step runs under full f32 products (:func:`_f32_steps`)."""
    with annotate("slt.mf.factor"):
        if not isinstance(data_stack, torch.Tensor):
            data_stack = torch.as_tensor(np.asarray(data_stack),
                                         device=default_device(device))
        if data_stack.ndim != 2:
            raise ValueError("factor_batched: expected (ne, nnz) data stack")
        dm = _device_maps(symbolic, data_stack.device)
        rscale = None
        if scale != "none":
            data_stack, rscale = _equilibrate(data_stack, symbolic, dm, kind,
                                              scale)
        blocks = yield from _f32_steps(
            _factor_run(symbolic, dm, data_stack, kind, 0.0))
        if rscale is not None:
            blocks[-2] = {"rscale": rscale}  # (ne, n) per-set scaling
        return MFFactors(symbolic, blocks, data_stack.dtype, kind=kind,
                         batch=int(data_stack.shape[0]))


# ---------------------------------------------------------------------------
# triangular solves (device, level-batched)
# ---------------------------------------------------------------------------


def _solve_run(factors: MFFactors, b, trans: bool, phase: str = "both"):
    """Level-batched substitutions on ``b`` (E, n, k), E value-sets of
    (E, nb, ...) blocks, as a stepper: a generator that yields after each
    bucket's launches of each pass and returns x (:func:`_drain` runs it
    whole).

    ``phase`` selects a half of the pipeline: ``"both"`` — the full A / A^H
    solve (entry fill-order gather, forward + backward loops, exit inverse
    gather, scaling); ``"forward"`` / ``"backward"`` — ONE loop only, in
    fill-slot coordinates (no permutation, no scaling): the building blocks
    of ``solve_part``."""
    sym = factors.symbolic
    flat = sym.schedule["flat"]
    level_buckets = sym.schedule["level_buckets"]
    n = sym.n
    dm = _device_maps(sym, b.device)
    # Cholesky factors store L (non-unit lower) with U = L^H implicit and
    # identity local permutations
    chol = factors.kind == "cholesky"
    do_fwd = phase in ("both", "forward")
    do_bwd = phase in ("both", "backward")
    full = phase == "both"
    ne, _, k = b.shape
    blocks = factors.blocks

    def blk(bidx):
        """(lu, perm, g21, g12) of a bucket with the value-sets folded into
        the batch, in the solve's dtype."""
        d = blocks[bidx]
        nb = flat[bidx]["sup_ids"].shape[0]
        out = []
        for name in ("lu", "perm", "g21", "g12"):
            t = d[name].reshape((ne * nb,) + tuple(d[name].shape[-2:])
                                if name != "perm" else (ne * nb, -1))
            out.append(t if name == "perm" else t.to(b.dtype))
        return out

    # equilibrated factors: the factorization is of M = R A (LU) or
    # M = S A S (Cholesky), so A x = b becomes M x = R b / M (S^-1 x) = S b,
    # and A^H x = b becomes M^H y = b with x = R y
    sc = blocks.get(-2)
    rs = None if sc is None else sc["rscale"].reshape(ne, n, 1).to(b.dtype)
    if full and rs is not None and (chol or not trans):
        b = b * rs
    # y carries an extra sentinel row (index n) absorbing padded gathers
    y = torch.cat([b[:, dm["perm"]] if full else b,
                   torch.zeros((ne, 1, k), dtype=b.dtype, device=b.device)],
                  dim=1)

    def gather(rows):
        return y[:, rows].reshape(-1, rows.shape[1], k)

    def put(rows, v):
        y[:, rows] = v.reshape(ne, rows.shape[0], rows.shape[1], k)

    def add(rows, v):
        y.index_add_(1, rows.view(-1), v.reshape(ne, -1, k))

    tri = torch.linalg.solve_triangular
    span = "slt.mf.solve.level"
    up_levels = _by_level(level_buckets, span, False, "forward")
    down_levels = _by_level(level_buckets, span, True, "backward")
    if not trans:
        # forward: z_s = L^{-1} P y_piv ; y_upd -= G21 z_s
        for bidx in up_levels if do_fwd else ():
            lu, lp, g21, _ = blk(bidx)
            piv, upd = dm["rows_piv"][bidx], dm["rows_upd"][bidx]
            z = gather(piv)
            if not chol:
                z = torch.gather(z, 1, lp.long()[:, :, None].expand(-1, -1, k))
            z = tri(lu, z, upper=False, unitriangular=not chol)
            put(piv, z)
            add(upd, -torch.bmm(g21, z))
            yield
        # backward: x_piv = U^{-1} (z_piv - G12 x_upd)
        for bidx in down_levels if do_bwd else ():
            lu, _, _, g12 = blk(bidx)
            piv, upd = dm["rows_piv"][bidx], dm["rows_upd"][bidx]
            rhs = gather(piv) - torch.bmm(g12, gather(upd))
            put(piv, tri(lu.mH if chol else lu, rhs, upper=True))
            yield
    else:
        # A'^H = U^H L^H P:
        # forward (bottom-up): w = U^{-H} y_piv ; y_upd -= G12^H w
        for bidx in up_levels if do_fwd else ():
            lu, _, _, g12 = blk(bidx)
            piv, upd = dm["rows_piv"][bidx], dm["rows_upd"][bidx]
            w = tri(lu if chol else lu.mH, gather(piv), upper=False)
            put(piv, w)
            add(upd, -torch.bmm(g12.mH, w))
            yield
        # backward (top-down): v = L^{-H}(w - G21^H v_upd); x = P^T v
        for bidx in down_levels if do_bwd else ():
            lu, lp, g21, _ = blk(bidx)
            piv, upd = dm["rows_piv"][bidx], dm["rows_upd"][bidx]
            rhs = gather(piv) - torch.bmm(g21.mH, gather(upd))
            v = tri(lu.mH, rhs, upper=True, unitriangular=not chol)
            if not chol:
                v = torch.zeros_like(v).scatter_(
                    1, lp.long()[:, :, None].expand(-1, -1, k), v)
            put(piv, v)
            yield

    x = y[:, :n][:, dm["iperm"]] if full else y[:, :n]
    if full and rs is not None and (chol or trans):
        x = x * rs
    return x


def _as_rhs(factors: MFFactors, b, what: str):
    """``b`` as a tensor on the factors' device, (n, k), and whether it was
    1-D."""
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(np.asarray(b))
    b = b.to(factors.device)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    if b.shape[0] != factors.n:
        raise ValueError(
            f"{what}: rhs has {b.shape[0]} rows, expected {factors.n}")
    return b, squeeze


def _solve_dtype(factors: MFFactors, b):
    """The solve's dtype: the factors' and the rhs' promoted together, as
    the JAX package's solves promote (f32 factors solve an f64 rhs in
    f64)."""
    return torch.promote_types(factors.dtype, b.dtype)


def solve(factors: MFFactors, b, trans: bool = False):
    """Solve A x = b (or A^H x = b with ``trans``) with the multifrontal
    factors (reference ``linearSolve_`` modes, Umfpack.hs:85-102).
    ``b``: (n,) or (n, k); the RHS batch is one pass over the buckets."""
    with annotate("slt.mf.solve"):
        if factors.batch is not None:
            raise ValueError("solve: batched factors — use solve_batched")
        b, squeeze = _as_rhs(factors, b, "solve")
        b = b.to(_solve_dtype(factors, b))
        plan = factors._plan
        if plan is not None and not trans:
            x = plan.solve(factors, b)
        else:
            x = _solve_one(factors, b, bool(trans))
        return x[:, 0] if squeeze else x


def _solve_one(factors: MFFactors, b, trans: bool):
    """The full solve of ``b`` (n, k), in ``b``'s dtype."""
    with _full_f32():
        return _drain(_solve_run(factors, b[None], trans))[0]


def solve_batched(factors: MFFactors, b_stack, trans: bool = False):
    """Batched solves on batched factors: ``b_stack`` (ne, n, k) ->
    (ne, n, k)."""
    return _drain(solve_batched_steps(factors, b_stack, trans))


def solve_batched_steps(factors: MFFactors, b_stack, trans: bool = False):
    """:func:`solve_batched` as a stepper: a generator that yields after
    each bucket's launches of each pass and returns x, as
    :func:`factor_batched_steps`."""
    with annotate("slt.mf.solve"):
        if not isinstance(b_stack, torch.Tensor):
            b_stack = torch.as_tensor(np.asarray(b_stack))
        if factors.batch is not None:
            b_stack = b_stack.to(factors.device)
        if b_stack.ndim != 3 or b_stack.shape[0] != (factors.batch or -1):
            raise ValueError(
                f"solve_batched: expected ({factors.batch or '?'}, n, k) rhs "
                "stack")
        return (yield from _f32_steps(_solve_run(
            factors, b_stack.to(_solve_dtype(factors, b_stack)),
            bool(trans))))


# ---------------------------------------------------------------------------
# replay: a pattern's Cholesky factor and solves as CUDA graphs
# ---------------------------------------------------------------------------


def _cuda_graph(run, device):
    """Capture ``run()`` on ``device`` as a CUDA graph, as
    ``torch.cuda.graphs`` advises: one eager pass on a side stream first
    (cuBLAS workspaces and the allocator's blocks for that stream exist
    before the capture), then the capture on the same stream into the
    graph's own memory pool.  Returns (the captured call's outputs, the
    graph's replay)."""
    with torch.cuda.device(device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = run()
    return out, graph.replay


def _captures(device) -> bool:
    """Whether the replay path engages on ``device``: CUDA only."""
    return device.type == "cuda"


_COUNTS = dict.fromkeys(("captures", "solve_captures", "factor_replays",
                         "solve_replays", "detaches"), 0)


def replay_counts() -> dict:
    """The replay path's counters since the process started: ``captures``
    (factor graphs, one a plan), ``solve_captures`` (one each time a plan
    records a solve for a new RHS width or dtype), ``factor_replays`` and
    ``solve_replays`` (one a call on the path, the capturing call's
    included), ``detaches`` (factors whose blocks were copied before a
    replay overwrote them)."""
    return dict(_COUNTS)


class _Plan:
    """One symbolic's Cholesky factor for a (device, dtype, scale),
    captured at its second call and replayed for each later value set, and
    one solve on its outputs, captured for the latest RHS (width, dtype)
    that repeated.

    ``a`` is the static value buffer the factor graph reads; ``blocks`` the
    static outputs every replay rewrites.  ``holder`` is a weakref to the
    MFFactors last handed those blocks.  ``lock`` keeps one thread at a
    time between a value set's copy in and its factors' detach.  The plan
    holds no reference to its symbolic, which holds it: dropping the
    symbolic frees the graphs and their pools at once."""

    def __init__(self, scale: str):
        self.scale = scale
        self.lock = threading.Lock()
        self.a = self.blocks = self.replay = None  # set by the capture
        self.holder = None
        self.last_solve = None  # (k, dtype) of the previous solve
        self.solve_graph = None  # ((k, dtype), static b, static x, replay)

    def factor(self, symbolic: MFSymbolic, a_data) -> MFFactors:
        """Replay on ``a_data``, capturing first if no graph is recorded;
        the factors of the previous replay, if still referenced, first get
        copies of their blocks."""
        with self.lock:
            held = self.holder and self.holder()
            if held is not None:
                held.blocks = held._mapped(torch.clone)
                held._plan = None
                _COUNTS["detaches"] += 1
            if self.replay is None:
                self.a = a_data.clone()
                dm = _device_maps(symbolic, a_data.device)
                with annotate("slt.mf.capture"):
                    self.blocks, self.replay = _cuda_graph(
                        lambda: _factor_blocks(symbolic, dm, self.a,
                                               "cholesky", self.scale),
                        a_data.device)
                _COUNTS["captures"] += 1
            else:
                self.a.copy_(a_data)
            with annotate("slt.mf.factor.replay"):
                self.replay()
            _COUNTS["factor_replays"] += 1
            out = MFFactors(symbolic, {k: dict(blk) for k, blk in
                                       self.blocks.items()}, a_data.dtype,
                            "cholesky")
            out._plan = self
            self.holder = weakref.ref(out)
            return out

    def solve(self, factors: MFFactors, b):
        """x (n, k) for ``b`` (n, k) in the solve's dtype, as a tensor the
        caller owns: replayed on ``factors`` if they are still the latest
        replay's and the width repeats, eagerly otherwise."""
        key = (b.shape[1], b.dtype)
        with self.lock:
            if factors._plan is not self:  # detached since the check
                return _solve_one(factors, b, False)
            repeat, self.last_solve = key == self.last_solve, key
            if self.solve_graph is None or self.solve_graph[0] != key:
                if not repeat:
                    return _solve_one(factors, b, False)
                self.solve_graph = None  # the previous width's pool goes
                static_b = b.clone()
                view = MFFactors(factors.symbolic, self.blocks,
                                 factors.dtype, "cholesky")
                with annotate("slt.mf.capture"):
                    x, replay = _cuda_graph(
                        lambda: _solve_one(view, static_b, False), b.device)
                _COUNTS["solve_captures"] += 1
                self.solve_graph = (key, static_b, x, replay)
            _, static_b, x, replay = self.solve_graph
            static_b.copy_(b)
            with annotate("slt.mf.solve.replay"):
                replay()
            _COUNTS["solve_replays"] += 1
            return x.clone()


# ---------------------------------------------------------------------------
# host-side queries
# ---------------------------------------------------------------------------


def _perm_sign(perm_rows, k: int) -> float:
    """Product of permutation parities over ``perm_rows`` (m, k) — each row
    is one front's local pivot permutation (identity rows skipped fast)."""
    p = np.asarray(perm_rows).reshape(-1, k)
    ar = np.arange(k)
    nontrivial = p[(p != ar[None, :]).any(axis=1)]
    sign = 1.0
    for row in nontrivial:
        visited = np.zeros(k, dtype=bool)
        for i in range(k):
            if visited[i] or row[i] == i:
                visited[i] = True
                continue
            j, clen = i, 0
            while not visited[j]:
                visited[j] = True
                j = row[j]
                clen += 1
            if clen % 2 == 0:
                sign = -sign
    return sign


def _real_buckets(factors: MFFactors):
    return [(bidx, factors.blocks[bidx])
            for bidx in sorted(k for k in factors.blocks if k >= 0)]


def _diag(blk):
    """Host copy of a bucket's factor diagonals (..., nb, Ns)."""
    return _np(torch.diagonal(blk["lu"], dim1=-2, dim2=-1))


def slogdet(factors: MFFactors):
    """(sign, logabsdet) of the factored operator — UMFPACK's
    ``umfpack_*_get_determinant`` capability (umfpack.h).

    The fill-reducing ordering is applied symmetrically (P A P^T), so it
    contributes no sign; every front's pivot-block U diagonal carries the
    global pivots, identity padding contributes exactly 1, and the local
    partial-pivot permutations contribute their parities.  Cholesky factors
    give det = prod(diag L)^2.  With ``pivot_eps`` static perturbation the
    result is the determinant of the PERTURBED factorization.  Host-side
    query; batched factors return (ne,) arrays."""
    ne = factors.batch
    chol = factors.kind == "cholesky"
    logabs = np.zeros(() if ne is None else (ne,))
    sign = np.ones(() if ne is None else (ne,),
                   dtype=(np.complex128 if factors.dtype.is_complex
                          else np.float64))
    for _, blk in _real_buckets(factors):
        d = _diag(blk)
        # padded pivot rows are exact identity -> diag 1, log 0, sign +1
        with np.errstate(invalid="ignore", divide="ignore"):
            logabs = logabs + np.sum(np.log(np.abs(d)), axis=(-2, -1))
            unit = np.where(d == 0, 1.0, d / np.abs(d))
        if chol:
            continue
        sign = sign * np.prod(unit, axis=(-2, -1))
        perm = _np(blk["perm"])
        k = perm.shape[-1]
        if ne is None:
            sign = sign * _perm_sign(perm, k)
        else:
            sign = sign * np.array(
                [_perm_sign(perm[e], k) for e in range(ne)])
    if chol:
        logabs = 2.0 * logabs
    sc = factors.blocks.get(-2)
    if sc is not None:
        # factors are of R A (LU) or S A S (Cholesky), R/S positive
        # diagonal: det A = det M / det(R or S^2)
        corr = np.sum(np.log(_np(sc["rscale"])), axis=-1)
        logabs = logabs - (2.0 * corr if chol else corr)
    # numpy slogdet convention: singular -> sign 0 (complex included)
    sign = np.where(logabs == -np.inf, 0.0 * sign, sign)
    return sign, logabs


def rcond(factors: MFFactors):
    """Cheap reciprocal-condition estimate min|U_ii| / max|U_ii| — exactly
    UMFPACK's ``Info[UMFPACK_RCOND]`` (umfpack.h).  Identity padding is
    masked out via each bucket's ``ns_real``.  Cholesky factors square the
    ratio (A = L L^H).  Batched factors return (ne,) arrays."""
    flat = factors.symbolic.schedule["flat"]
    ne = factors.batch
    dmin = np.full(() if ne is None else (ne,), np.inf)
    dmax = np.zeros(() if ne is None else (ne,))
    for bidx, blk in _real_buckets(factors):
        d = np.abs(_diag(blk))
        ns_real = flat[bidx]["ns_real"]  # (nb,)
        mask = np.arange(d.shape[-1])[None, :] < ns_real[:, None]
        masked_min = np.where(mask, d, np.inf)
        masked_max = np.where(mask, d, 0.0)
        dmin = np.minimum(dmin, masked_min.min(axis=(-2, -1)))
        dmax = np.maximum(dmax, masked_max.max(axis=(-2, -1)))
    r = np.where(dmax > 0, dmin / np.maximum(dmax, np.finfo(np.float64).tiny),
                 0.0)
    if factors.kind == "cholesky":
        r = r * r
    return r


def _elim_fill(factors: MFFactors, pull) -> np.ndarray:
    """Fill slot -> final elimination position (n + 1 entries, the last the
    sentinel): the composition of the in-front partial-pivot permutations.
    Fill row piv[t, lp[t, i]] is eliminated at position piv[t, i] (the
    solve gathers y[piv] then applies the local perm).  Identity for
    Cholesky."""
    sym = factors.symbolic
    eindex = np.arange(sym.n + 1, dtype=np.int64)
    if factors.kind != "cholesky":
        for bidx, b in enumerate(sym.schedule["flat"]):
            lp = pull(factors.blocks[bidx]["perm"]).astype(np.int64)
            piv = b["rows_piv"].astype(np.int64)
            real = np.arange(lp.shape[1])[None, :] < b["ns_real"][:, None]
            src = np.take_along_axis(piv, lp, axis=1)
            eindex[src[real]] = piv[real]
    return eindex


def get_factors(factors: MFFactors, index: int | None = None):
    """Export the global sparse triangular factors — the capability of
    UMFPACK's ``umfpack_*_get_numeric`` (umfpack.h).

    Returns ``(L, U, row_perm, col_perm)``, L and U canonical CSR on the
    factors' device and the permutations numpy arrays, such that

        (L @ U).todense() == A.todense()[np.ix_(row_perm, col_perm)]

    up to factorization rounding.  For ``kind="lu"`` L is unit lower
    triangular (explicit unit diagonal stored) and U upper triangular with
    the pivots; for ``kind="cholesky"`` L is the (non-unit) Cholesky factor
    and U = L^H.  ``col_perm`` is the fill-reducing order; ``row_perm``
    composes it with the in-front partial-pivot permutations.  Padding
    never leaks: masking by each bucket's real sizes recovers the true
    factors.  ``index`` selects one value-set of a ``factor_batched``
    artifact.  Equilibrated factorizations export the factors of the
    SCALED operator (compose with ``factors.row_scale``).  Host-side
    export: an introspection/interop API, not a solver path."""
    sym = factors.symbolic
    n = sym.n
    chol = factors.kind == "cholesky"
    ne = factors.batch
    if ne is not None and index is None:
        raise ValueError(
            "get_factors: batched factors — pass index=<contour set> "
            f"in [0, {ne})"
        )
    flat = sym.schedule["flat"]

    def pull(x):
        return _np(x[index] if ne is not None else x)

    eindex = _elim_fill(factors, pull)

    rL, cL, vL = [], [], []
    rU, cU, vU = [], [], []
    for bidx, b in enumerate(flat):
        blk = factors.blocks[bidx]
        lu = pull(blk["lu"])
        g12 = pull(blk["g12"])
        g21 = pull(blk["g21"])
        piv = b["rows_piv"].astype(np.int64)   # (nb, Ns): fill == elim slots
        upd = b["rows_upd"].astype(np.int64)   # (nb, Us), sentinel n
        nsr = b["ns_real"].astype(np.int64)
        nb, Ns = piv.shape
        Us = upd.shape[1]
        ar = np.arange(Ns)
        rmask = ar[None, :] < nsr[:, None]     # (nb, Ns) real pivot slots
        umask = upd < n                        # (nb, Us) real update rows

        # L11: strict lower + explicit unit diag (LU) / lower incl diag (chol)
        li, lj = np.tril_indices(Ns, 0 if chol else -1)
        m = rmask[:, li] & rmask[:, lj]
        v = lu[:, li, lj]
        m &= v != 0
        rL.append(piv[:, li][m])
        cL.append(piv[:, lj][m])
        vL.append(v[m])
        if not chol:
            rL.append(piv[rmask])
            cL.append(piv[rmask])
            vL.append(np.ones(int(rmask.sum()), dtype=lu.dtype))

        # U11: upper incl diag (LU) / L11^H transposed (chol)
        ui, uj = np.triu_indices(Ns) if not chol else (lj, li)
        m = rmask[:, ui] & rmask[:, uj]
        v = lu[:, uj, ui] if chol else lu[:, ui, uj]
        if chol:
            v = np.conj(v)
        m &= v != 0
        rU.append(piv[:, ui][m])
        cU.append(piv[:, uj][m])
        vU.append(v[m])

        if Us and g21.size:
            # L21: rows are update rows -> final elimination positions
            ii, jj = np.indices((Us, Ns))
            m = umask[:, ii] & rmask[:, jj]
            v = g21[:, ii, jj]
            m &= v != 0
            rL.append(eindex[np.clip(upd, 0, n)][:, ii][m])
            cL.append(piv[:, jj][m])
            vL.append(v[m])
            # U12: columns are update rows (fill positions; columns are
            # never permuted)
            m = rmask[:, jj.T] & umask[:, ii.T]
            v = g12[:, jj.T, ii.T]
            m &= v != 0
            rU.append(piv[:, jj.T][m])
            cU.append(upd[:, ii.T][m])
            vU.append(v[m])

    def cat(xs):
        return np.concatenate(xs) if xs else np.zeros(0, dtype=np.int64)

    device = factors.device
    L = from_triples((n, n), cat(rL), cat(cL), cat(vL), device=device).tocsr()
    U = from_triples((n, n), cat(rU), cat(cU), cat(vU), device=device).tocsr()
    perm = np.asarray(sym.perm, dtype=np.int64)
    einv = np.empty(n, dtype=np.int64)
    einv[eindex[:n]] = np.arange(n)
    return L, U, perm[einv], perm.copy()


def lunz(factors: MFFactors, index: int | None = None):
    """(lnz, unz): stored entries of the exported L and U factors —
    UMFPACK's ``umfpack_*_get_lunz`` (umfpack.h)."""
    L, U, _, _ = get_factors(factors, index=index)
    return int(L.nnz), int(U.nnz)


def _elim_index(factors: MFFactors) -> np.ndarray:
    """Fill slot -> final elimination position (host, cached on the factor
    object), as ``get_factors`` uses it to place L21 rows."""
    cached = getattr(factors, "_eindex", None)
    if cached is None:
        cached = factors._eindex = _elim_fill(factors, _np)[:factors.n]
    return cached


_PART_SYS = ("Pt_L", "L", "Lt_P", "Lat_P", "Lt", "Lat",
             "U_Qt", "U", "Ut_Q", "Uat_Q", "Ut", "Uat")


def solve_part(factors: MFFactors, b, sys: str):
    """Partial solves with the stored factors — UMFPACK's remaining solve
    subsystems (``umfpack_*_solve`` sys codes UMFPACK_Pt_L .. UMFPACK_Uat,
    umfpack.h).

    ``sys`` names the system solved in terms of ``get_factors``'s exported
    (L, U, row_perm, col_perm) with ``A[row_perm][:, col_perm] == L @ U``;
    P gathers rows by ``row_perm`` (P b = b[row_perm]) and Q gathers
    columns by ``col_perm``:

    ========  ====================  =========================
    sys       system                UMFPACK constant
    ========  ====================  =========================
    "Pt_L"    P^T L x = b           UMFPACK_Pt_L
    "L"       L x = b               UMFPACK_L
    "Lt_P"    L^H P x = b           UMFPACK_Lt_P
    "Lat_P"   L^T P x = b           UMFPACK_Lat_P
    "Lt"      L^H x = b             UMFPACK_Lt
    "Lat"     L^T x = b             UMFPACK_Lat
    "U_Qt"    U Q^T x = b           UMFPACK_U_Qt
    "U"       U x = b               UMFPACK_U
    "Ut_Q"    U^H Q x = b           UMFPACK_Ut_Q
    "Uat_Q"   U^T Q x = b           UMFPACK_Uat_Q
    "Ut"      U^H x = b             UMFPACK_Ut
    "Uat"     U^T x = b             UMFPACK_Uat
    ========  ====================  =========================

    Like UMFPACK, partial solves use the factors AS STORED (no
    equilibration scaling).  Runs one phase of the level-batched
    substitution pipeline on the device."""
    if sys not in _PART_SYS:
        raise ValueError(
            f"solve_part: unknown sys {sys!r} (expected one of {_PART_SYS})")
    if factors.batch is not None:
        raise ValueError(
            "solve_part: batched factors are not supported — factor the "
            "value-set you need (or index it out) first")
    b, squeeze = _as_rhs(factors, b, "solve_part")

    # conjugate-transpose systems reduce to the Hermitian ones; b was already
    # expanded to (n, k), so re-apply the 1-D squeeze on the way out
    if sys in ("Lat", "Lat_P", "Uat", "Uat_Q"):
        xc = solve_part(factors, torch.conj(b),
                        {"Lat": "Lt", "Lat_P": "Lt_P", "Uat": "Ut",
                         "Uat_Q": "Ut_Q"}[sys])
        xc = torch.conj(xc).resolve_conj()
        return xc[:, 0] if squeeze else xc

    trans, phase = {
        "Pt_L": (False, "forward"), "L": (False, "forward"),
        "U": (False, "backward"), "U_Qt": (False, "backward"),
        "Ut": (True, "forward"), "Ut_Q": (True, "forward"),
        "Lt": (True, "backward"), "Lt_P": (True, "backward"),
    }[sys]
    sym = factors.symbolic
    eindex = _elim_index(factors)
    perm, iperm = np.asarray(sym.perm), np.asarray(sym.iperm)
    # fill-slot input/output conventions of the two phase pipelines (see
    # _solve_run): forward takes c[s] = b_elim[eindex[s]] and returns
    # elim-direct; backward takes elim-direct and returns fill-column x;
    # trans-forward takes fill-column direct and returns elim-direct;
    # trans-backward takes elim-direct and returns y[s] = v_elim[eindex[s]].
    pre = {"Pt_L": perm, "L": eindex}.get(sys)
    ein = np.empty_like(eindex)
    ein[eindex] = np.arange(sym.n)
    post = {"U_Qt": iperm, "Ut_Q": perm, "Lt": ein, "Lt_P": iperm}.get(sys)
    if pre is not None:
        b = b[torch.as_tensor(pre, dtype=torch.int64, device=b.device)]
    with _full_f32():
        x = _drain(_solve_run(factors, b.to(_solve_dtype(factors, b))[None],
                              trans, phase=phase))[0]
    if post is not None:
        x = x[torch.as_tensor(post, dtype=torch.int64, device=x.device)]
    return x[:, 0] if squeeze else x
