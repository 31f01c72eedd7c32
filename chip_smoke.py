#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``sparse_linear_tpu_torch``) on one
NVIDIA GPU:

    python3 chip_smoke.py [--seed N]

1. Card: the card's name and power limit from ``nvidia-smi``.
2. Build: the Hopper kernels in ``sparse_linear_tpu_torch/csrc`` are built
   with nvcc from the checkout's sources.
3. Kernel parity: each kernel against its plain PyTorch version on the card,
   at the shapes the main paths use and at harder ones (unaligned,
   rectangular, 3D with +-46,656 offsets; for WELL a 3,000,000 x 2,000,000
   matrix with skewed rows; kernel D at m = 5, 16, 17, 33, 40 and 80 on
   both operators in both types, and at m = 8, 32, 64, 80, 96, 168 in both
   layouts on the permuted one; at m = 16 and 80 every column of kernel D
   bitwise kernel C on that column, a second call bitwise the first, and a
   digest of the result to compare two builds).  Max relative error
   max|y - y_plain| / max|y_plain| <= 1e-5 in f32 and 1e-12 in f64 for the
   SpMV and SpMM kernels and the 7-step f64 chain, <= 1e-4 for 50 chained
   f32 steps; the f64 WELL SpMV also meets ||y - y_csr|| / ||y_csr|| <=
   1e-13 against the plain CSR SpMV at 1448**2.  Kernel A's multi-RHS form
   (``dia_spmm_kernel``, ``dia_spmm_planes_kernel``) at m = 1, 2, 5, 8,
   16, 33, 80, 96, 160 in both layouts and types on 2048**2, 1448**2,
   216**3 and the 3M x 2M DIA (1e-5 / 1e-12), at m = 16, 80 and 160 every
   column bitwise kernel A on that column, with a digest of each result;
   at m = 1100 on 512**2 (both types), the 3M x 2M DIA at m = 768 in f32
   (nr * m past 2**31), and an X that is not 16-byte aligned.  The
   complex64 / complex128 instantiations (``complex_parity``, 1e-5 /
   1e-12): kernel A on phase 9's gauge operator at 2048**2, phased
   1448**2 and 216**3 and a complex 3M x 2M DIA; its multi-RHS form at
   m = 1, 16, 80, 96 in both layouts (m <= 16 on the two largest), every
   column bitwise complex kernel A at m = 16 and 80, an X one element off
   its aligned start; kernels C and D on the permuted gauge operator and
   a complex skewed 3M x 2M WELL, D at m = 1, 16, 80, 96 in both layouts,
   every column bitwise C, an offset X; a real operator times a complex x
   or X, each part bitwise the real kernel; each result bitwise on a
   second call.
4. Main path at full size, with the kernels' launch counts set to 0 before
   and read after.  First CG's three vector kernels (``cg_step``), each
   against its plain version from one state, in f32, f64, c64 and c128 at
   2048**2 and in f64 at 216**3 (``cg_step_parity``: scalars and vectors
   within 1e-5 / 1e-12 relative, iteration and stop flag exact).  Then
   2048**2 Poisson triples on the card -> from_triples ->
   tocsr -> check_matrix -> csr_to_dia; the top of the spectrum by power
   iteration through the one-launch chain (against the analytic value); CG
   in f64 to 1e-10 (its vector steps the three ``cg_step`` kernels, each
   launched once an iteration queued; the iterations queued and the host's
   reads printed beside the count), with
   the true residual through the plain CSR SpMV <= 1e-9; the entry step at
   grid 2048 in f32 against the plain version.
5. Times: each kernel, its plain version and the one PyTorch call that
   computes the same function (cuSPARSE through a torch sparse CSR tensor
   of the same operator; none for the chain) from CUDA events (median of
   24, L2 flushed before each call), in f32 and f64, with GB/s, beside the
   card's name and power limit, and each kernel's bound: the larger of its
   bytes (each input read once, each output written once) over 3.35 TB/s
   and its flops over 67 (f32) or 34 (f64) TFLOP/s.  CG's three vector
   kernels in f64 at 216**3 (cg-grid's length).  Kernel D also at
   FEAST's m = 80 and on the stencil-order 2048**2 operator packed as WELL
   (each with its plain version, cuSPARSE SpMM, well_spmm_planes'
   ``planes_ms``, the copy of X that it holds, and, printed, the gather
   floor of a numbering without reuse), and at m = 1, 5, 8 and 96 in both
   layouts; and kernel D under the geometry ``_spmm_plan`` picks against
   another on the same X (the scalar lanes against the widest, plane-major
   m = 80 at two chunks a lane against one pass), bitwise equal; kernel
   C's gather floor (x read once a slot), printed.  Kernel A's
   multi-RHS form at FEAST's m = 80 and at m = 16 on 1024**2 and 2048**2,
   and at m = 160 on 1024**2, both types and layouts, beside its plain
   version, its bytes bound (the diagonals, X and Y once), cuSPARSE SpMM
   and the previous design's times (``PREVIOUS_MS``).  The complex
   instantiations on phase 9's operators, complex64 and complex128 (8
   flops a complex term): kernel A on the gauge operator at 2048**2, its
   multi-RHS form at 1024**2 and m = 80 in both layouts, kernels C and D
   (m = 16; m = 80 in c128, under the plan's five chunks a lane and under
   four, bitwise equal) on the permuted gauge operator, each with its
   plain version, bound and cuSPARSE (or why torch refused it).
6. Slice-2 main path at full size, with the WELL kernels' launch counts set
   to 0 before and read after: the 2048**2 triples with their unknowns
   relabelled by a seeded permutation (an unstructured numbering) ->
   from_triples -> tocsr -> check_matrix -> recommend_format ("well") ->
   to_fast_format; CG in f64 to 1e-10 through W @ x, with the true residual
   through the plain CSR SpMV <= 1e-9; a 16-RHS f64 block through
   well_spmm_planes against the plain version; the staged SpGEMM A @ A of
   the permuted 1024**2 operator against the sort-based one (identical
   pattern, values within 1e-12); the peak device memory.
7. Direct solver at full size (``solve.api``, multifrontal backend), from
   its own random stream: the 1024**2 Poisson operator analyzed once
   (nested dissection) and factored as f32 Cholesky and f32 LU with
   ``pivot_eps=1e-10`` (each twice, the second timed; ``solve_refined``
   with f64 residuals to <= 1e-10 in at most 4 steps) and as f64 Cholesky
   (direct residual <= 1e-10); on those f64 factors, solves at k = 1 and
   80, ``trans="H"``, ``solve_part`` "L" then "U" against the full solve
   (<= 1e-12), ``slogdet`` against the analytic log-determinant (<= 1e-10
   relative), ``rcond``, and whether two factorizations are bitwise equal;
   the 64**3 operator as f32 Cholesky refined to <= 1e-10; FEAST's contour
   shape at 192**2, ``factor_batched`` of 8 complex z_k I - A and
   ``solve_batched`` with 80 RHS each (residuals <= 1e-10); the phase's
   peak device memory (< 40 GB).
8. FEAST at full size (``eig.feast``, multifrontal backend), from its own
   random stream, with the launch counts of kernel A's multi-RHS form set
   to 0 before and read after: the 50 lowest pairs of the 192**2 operator
   (cold, then the best of 3 warm calls), then on that window each other
   contour mode forced (batched, per-node, streaming: the same eigenvalues
   within 1e-12, each timed the same way), the same operator permuted by a
   seeded relabelling without grid dims (through WELL and kernel D, whose
   launches are counted around that run), ``count_eigenvalues`` on that
   window (16 probes), ``eigsh_sliced`` over about 100 pairs of 64**2 with
   ``m0_max=64``, and at 1,048,576 dof the 50 lowest pairs (cold, then
   warm) and the interior window [lambda_100, lambda_150) on the warm
   pipeline; each against the analytic spectrum (<= 1e-10 on the
   interval's scale, epsout <= 1e-10), with its contour mode and why, the
   split of its time, the Ritz values and residuals of the spurious pairs
   each loop rejected, and the phase's peak device memory (< 75 GB).
9. Complex Hermitian at full size (``complex_phase``), from its own random
   stream, each kernel's launch count set to 0 before its run and read
   after: the gauge-transformed 2048**2 operator (phase e^{0.3 i} on the
   x-links: D A_0 D^H, Poisson's spectrum) built on the card with
   ``kron`` and held bitwise against the same operator from triples; CG
   in c128 to 1e-10 through DIA (complex kernel A) on b = D b_4 (phase 4's
   b), then on the operator permuted by a seeded relabelling through
   ``recommend_format`` -> WELL (complex kernel C), each with its true
   residual <= 1e-9 and its iterations beside phases 4 and 6; FEAST's 50
   lowest pairs of the 1,048,576-dof gauge operator (the DIA route, the
   complex multi-RHS form; cold and warm) and of the permuted 192**2 one
   (the WELL route, complex kernel D), with ``ops.linalg.spmm`` made to
   raise, each against the analytic spectrum (<= 1e-10, epsout <=
   1e-10), peak < 75 GB.
10. Chebyshev at full size (``chebyshev_phase``, ``eig.chebyshev.
   eigsh_filtered`` in f64 with its default degree and passes), from its
   own random stream, the launch counts of kernel A's multi-RHS form and
   of kernel D set to 0 before and read after, ``ops.linalg.spmm`` made to
   raise: the 20 lowest pairs of the 65,536-dof operator (m0 = 40) in
   stencil order (the DIA route) and relabelled by a seeded permutation
   (the WELL route), cold and warm, each INFO_OK with every eigenvalue
   within 1e-10 of the analytic spectrum and every residual through the
   plain CSR product <= 1e-8; the 50 lowest pairs at 1,048,576 dof (m0 =
   64), recorded as they come (the JAX module documents a stall near 1e-3
   there on its TPU) and held to an honest result: finite, INFO_OK or
   INFO_NOT_CONVERGED, reported residuals within 1e-3 relative of the
   recomputed ones, each value within its residual of an analytic
   eigenvalue (and the full checks if INFO_OK); a line a pass with its
   time and epsout; each run's kernel launched at least degree x filter
   passes times; after each run its kernel against the plain version
   (``dia_spmm`` / ``well_spmm_planes_plain``) on the operator the route
   builds, at the widths the solver gives it (1 for the Lanczos bound, m0
   for the filter and Rayleigh-Ritz, 2 m0 for the [X | R] pass), max rel
   err <= 1e-12, these launches left out of the counts; peak < 75 GB.
11. Checkpoints and profiling (``checkpoint_phase``), every file in a
   temporary directory removed after: phase 7's f32 Cholesky factors of
   the 2D operator saved and loaded (load re-derives the schedule with
   ``analyze``, timed apart), every block and a solve bitwise the
   originals' (under torch's deterministic algorithms); a dense-backend
   f64 LU at n = 4096, solve bitwise; phase 6's permuted 2048**2 WELL,
   fields and SpMV bitwise, load time beside ``csr_to_well``'s; phase 8's
   lowest-50 subspace, bitwise, then ``eigsh(..., guess=loaded)`` INFO_OK
   in no more loops than the cold run; one filter pass of phase 10's first
   case under ``profiling.trace`` in ``profiling.annotate``, the trace
   file naming the span and ``dia_spmm_kernel``, its wall with and without
   the profiler and ``op_timings``.  File bytes, save and load seconds.
12. Multi-device paths (``multidevice_phase``, ``dist/``), from its own
   random stream, on ``card_mesh(4)`` (four shards on one card, or one a
   card on four; the layout is printed), the launch counts of kernel A,
   its multi-RHS form and kernel C set to 0 before (a) and read after (f),
   the launches made to hold or time a kernel against its reference taken
   back out: (a) the row-sharded 2048**2 DIA in f32 and f64, halo and
   all-gather, against the unsharded kernel A (bitwise expected; max rel
   err <= 1e-5 / 1e-12), each timed in turns with it (median of 24, L2
   flushed), with the x elements a shard receives; (b) CG in f64 to 1e-10
   on phase 4's b with sharded vectors and psum'd dots, true residual <=
   1e-9, iterations and ms an iteration beside phase 4's; (c) the
   stencil-order 2048**2 operator through ``shard_well_rows`` (a window
   plan; elements shipped against the all-gather's) and phase 6's
   permuted one (all-gather), each within 1e-12 of the unsharded kernel C
   and timed beside it, then WELL CG on the permuted one to 1e-10 on
   phase 6's b; (d) ``shard_ell_rows`` / ``shard_bsr_rows`` at 1024**2
   against the unsharded ELL / BSR products (1e-12); (e) phase 7's 1024**2
   f32 Cholesky with its fronts over the shards, the second call timed
   beside an unsharded one and phase 7's, blocks within 1e-5 of phase 7's,
   the refined solve <= 1e-10, then f64, direct residual <= 1e-10; (f)
   contour-sharded FEAST on phase 8's lowest-50 windows of 192**2 and
   1,048,576 dof (cold and warm; INFO_OK, epsout and the analytic spectrum
   <= 1e-10, phase 8's loops, phase 8's eigenvalues within 1e-12 on the
   interval's scale, peak < 75 GB); (g) ``entry.dryrun_multichip(4)``;
   (h) the row-sharded FEAST subspace on ``card_mesh((2, 2), ("cp",
   "rows"))``, each window run right after (f)'s on the same operator (the
   pipeline's host analyze shared): the lowest 50 of 192**2 (DIA route),
   phase 8's permuted 192**2 without dims (WELL route, kernel D slabs) and
   1,048,576 dof, m0 = 80, 8 Gauss nodes, cold and warm, with the launch
   counts of kernel A's multi-RHS form and kernel D set to 0 before each
   window and read after (INFO_OK, epsout and the analytic spectrum <=
   1e-10, phase 8's loops and eigenvalues within 1e-12, 2 contour and 2
   rows shards, peak < 75 GB, each kernel launched), the row-sharded
   product of A at (n, 80) held against the unsharded kernel (DIA slabs
   bitwise) and the plain version (1e-12); printed: cold and warm s, the
   contour mode and why, rows a shard, the elements of X a shard receives
   a product against the all-gather's, the warm split into solves,
   products, Grams and host eighs.
13. Walkthroughs (``walkthrough_phase``): ``examples/torch_*.py``, each in
   its own process on the card, one after another: exit code 0 and a
   first line naming a CUDA device; each one's wall time.

Prints one JSON line of phase 13 (``walkthroughs``), one of phase 12
(``multidevice``, (h) under ``row_sharded_feast``), one of the Chebyshev
runs of phase 10 (``chebyshev``),
one of phase 11 (``checkpoints``), one JSON line of the FEAST runs of
phases 8 and 9 (``feast``: wall cold / warm,
loops, epsout, errors, mode, split, peak GB), one JSON line of the direct
solver's cases (``direct``: analyze s,
factor s, solve ms, refinement steps, residual, peak GB, levels, buckets,
fronts), one JSON line of the kernels (``ms``, ``plain_ms``, ``bound_ms``,
``bound_by``, ``bound_share`` = bound_ms / ms, ``library_ms``, null where
no library call computes the function, ``launches`` from the main paths,
``max_abs_err``; the four complex128 instantiations as ``dia_spmv_c128``,
``dia_spmm_c128``, ``well_spmv_c128`` and ``well_spmm_c128``, launches from
phase 9; ``launches_phase10`` beside the f64 ``dia_spmm`` and
``well_spmm`` entries' own; ``launches_phase12`` beside the ``dia_spmv``
(f32), f64 ``well_spmv`` and f64 ``dia_spmm`` entries', and
``launches_phase12h`` (phase 12 (h)) beside the f64 ``dia_spmm`` and
``well_spmm`` entries'; ``cg_pq``, ``cg_update`` and ``cg_direction`` timed
at 216**3 in f64, launches from phase 4's CG), then as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises: the exit code
is then non-zero and the last line is not printed.  Without a CUDA device,
or without the package beside this script, it fails before any result.
"""

from __future__ import annotations

import argparse
import cmath
import contextlib
import dataclasses
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SPMV_SOURCE = "sparse_linear_tpu_torch/csrc/dia_spmv.cu"
WELL_SOURCE = "sparse_linear_tpu_torch/csrc/well_spmv.cu"
CG_SOURCE = "sparse_linear_tpu_torch/csrc/cg_step.cu"
XLA_SPMV = "sparse_linear_tpu/kernels/spmv.py"
PALLAS = "sparse_linear_tpu/kernels/spmv_pallas.py"
JAX_CG = "sparse_linear_tpu/solve/cg.py"
PALLAS_WELL = "sparse_linear_tpu/kernels/spmv_well.py"
PALLAS_WELL64 = "sparse_linear_tpu/kernels/spmv_well64.py"

# bound_ms: H100 SXM peaks from NVIDIA's data sheet, at the full 700 W
HBM_BYTES_PER_S = 3.35e12
# times of the previous designs of the kernels redesigned since
# (PERF.md §6: measured by this script before the redesign, on an NVIDIA
# H100 80GB HBM3 at 700.00 W), printed beside this run's
PREVIOUS_MS = {"well_spmv torch.float32": 0.1704, "well_spmv torch.float64": 0.3070,
               "dia_spmv_chain torch.float32": 2.6613,
               "well_spmm torch.float32": 1.1720,
               "well_spmm torch.float64": 2.0543,
               # kernel A's multi-RHS form, the first design: (column-major,
               # plane-major); m = 160 from this script run on its tree
               "dia_spmm poisson_2d(1024) m=80 torch.float32": (0.9435, 0.6798),
               "dia_spmm poisson_2d(1024) m=80 torch.float64": (1.1111, 0.7582),
               "dia_spmm poisson_2d(1024) m=16 torch.float32": (0.1991, 0.1431),
               "dia_spmm poisson_2d(1024) m=16 torch.float64": (0.2200, 0.1619),
               "dia_spmm poisson_2d(1024) m=160 torch.float32": (1.9250, 1.3620),
               "dia_spmm poisson_2d(1024) m=160 torch.float64": (2.3628, 1.5723),
               "dia_spmm poisson_2d(2048) m=80 torch.float32": (3.9796, 2.8949),
               "dia_spmm poisson_2d(2048) m=80 torch.float64": (4.6425, 3.2248),
               "dia_spmm poisson_2d(2048) m=16 torch.float32": (0.7845, 0.5865),
               "dia_spmm poisson_2d(2048) m=16 torch.float64": (0.8639, 0.6349)}


# phase 9: the phase e^{i THETA} on the x-links of the gauge operator
THETA = 0.3


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    require(out, "nvidia-smi printed nothing")
    return out.splitlines()[0]


def max_err(y, ref):
    """(max |y - ref|, max |y - ref| / max |ref|) as floats."""
    err = float((y - ref).abs().max())
    return err, err / max(float(ref.abs().max()), 1e-300)


def digest(t) -> str:
    """A hash of a tensor's bytes: equal digests from two runs with the
    same seed mean bitwise equal results."""
    import torch

    data = t.detach().contiguous().view(-1).view(torch.uint8).cpu()
    return hashlib.blake2b(data.numpy(), digest_size=8).hexdigest()


def cg_step_vectors(dev, gen, n, dtype, scale=1.0):
    """x, r, p and q = scale D p (D a random positive diagonal, so that
    Re(p^H q) sums positive terms), and a state that never stops (target
    0), for the ``cg_step`` kernels on card vectors of length n."""
    import torch

    from sparse_linear_tpu_torch.dtypes import real_of
    from sparse_linear_tpu_torch.kernels import cg_step

    x, r, p = (torch.randn(n, dtype=dtype, device=dev, generator=gen)
               for _ in range(3))
    d = 1 + torch.rand(n, dtype=real_of(dtype), device=dev, generator=gen)
    state = cg_step.cg_state(r, torch.zeros((), dtype=torch.float64,
                                            device=dev))
    return x, r, p, p * (scale * d), state


def cg_step_parity(dev, gen, n, dtype) -> dict:
    """Each of the three ``cg_step`` kernels against its plain version on
    card vectors of length n, from the same state: the scalars and
    vectors it writes within 1e-5 (f32, c64) or 1e-12 (f64, c128) of the
    plain ones, relative to their largest, the iteration count and the
    stop flag exact.  Returns {kernel: max abs err over the vectors it
    writes and alpha or beta}; gamma, a sum of n terms, is held to the
    relative tolerance alone."""
    import torch

    from sparse_linear_tpu_torch.kernels import cg_step as cs

    rtol = 1e-5 if dtype in (torch.float32, torch.complex64) else 1e-12
    x, r, p, q, state = cg_step_vectors(dev, gen, n, dtype)
    ref = state.clone()
    errs = {}

    def compare(kernel, pairs):
        worst = 0.0
        for what, got, want in pairs:
            err, rel = max_err(got, want)
            require(rel <= rtol, f"{kernel} {dtype} n={n}: {what} max rel "
                    f"err {rel:.3e} > {rtol}")
            if what != "gamma":
                worst = max(worst, err)
        errs[kernel] = worst

    cs.cg_pq(p, q, state)
    cs.cg_pq_plain(p, q, ref)
    compare("cg_pq", [("alpha", state[cs.ALPHA], ref[cs.ALPHA])])
    ref[cs.ALPHA] = state[cs.ALPHA]
    xk, rk = x.clone(), r.clone()
    cs.cg_update(xk, rk, p, q, state)
    cs.cg_update_plain(x, r, p, q, ref)
    compare("cg_update", [("x", xk, x), ("r", rk, r),
                          ("gamma", state[cs.GAMMA], ref[cs.GAMMA]),
                          ("beta", state[cs.BETA], ref[cs.BETA])])
    require([float(state[s]) for s in (cs.ITER, cs.STOP)] == [1.0, 0.0]
            == [float(ref[s]) for s in (cs.ITER, cs.STOP)],
            f"cg_update {dtype} n={n}: iteration or stop flag")
    ref[cs.BETA] = state[cs.BETA]
    pk = p.clone()
    cs.cg_direction(pk, r, state)
    cs.cg_direction_plain(p, r, ref)
    compare("cg_direction", [("p", pk, p)])
    print(f"phase 4 parity cg_step {dtype} n={n}: max abs err " + ", ".join(
        f"{k} {v:.3e}" for k, v in errs.items()) + f" (rtol {rtol})",
        flush=True)
    return errs


def direct_solver_phase(dev, card: str, seed: int,
                        grids=(1024, 64, 192), keep=None) -> list:
    """Phase 7: the multifrontal direct solver through ``solve.api`` at
    full width: ``grids`` are the 2D operator's, the 3D one's and the
    contour's.  Returns the rows of the ``direct`` JSON line; any failed
    check raises.  With ``keep`` (a dict) the 2D f32 Cholesky factors are
    copied to the host into ``keep["cholesky"]``, with their grid, for
    phase 11."""
    import torch

    import sparse_linear_tpu_torch as st
    from sparse_linear_tpu_torch.solve import api
    from sparse_linear_tpu_torch.utils import native
    from sparse_linear_tpu_torch.utils.grids import poisson_2d, poisson_3d

    f32, f64, c128 = torch.float32, torch.float64, torch.complex128
    # its own stream: phases 4 and 6 keep their draws
    dgen = torch.Generator(device=dev).manual_seed(seed + 3)
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    rows, peaks = [], []

    def wall(f):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = f()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def events_ms(f, reps=5):
        """Median ms of ``reps`` calls from CUDA events, after a warm-up."""
        f()
        pairs = []
        for _ in range(reps):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            f()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)

    def rel_res(a, x, b):
        ax = st.spmm(a, x) if x.ndim == 2 else st.spmv(a, x)
        return float(torch.linalg.vector_norm(ax - b)
                     / torch.linalg.vector_norm(b))

    def shape_of(sym):
        flat = sym.schedule["flat"]
        return {"levels": sym.schedule["height"] + 1, "buckets": len(flat),
                "fronts": sum(b["sup_ids"].shape[0] for b in flat)}

    def gflop(sym, kind, dtype, ne=1):
        """GFLOP the factorization executes on its padded fronts: per front
        potrf Ns^3/3 (getrf 2 Ns^3/3), the triangular solves Ns^2 Us (two
        for LU), the Schur product 2 Ns Us^2; four times that in complex."""
        per = 1 if kind == "cholesky" else 2
        tot = sum(b["sup_ids"].shape[0] * (per * (b["Ns"] ** 3 / 3
                                                  + b["Ns"] ** 2 * b["Us"])
                                           + 2 * b["Ns"] * b["Us"] ** 2)
                  for b in sym.schedule["flat"])
        return ne * tot * (4 if dtype.is_complex else 1) / 1e9

    def row(name, n, kind, dtype, sym, analyze_s, factor_s, solve_ms,
            steps, residual, ne=1):
        peaks.append(torch.cuda.max_memory_allocated(dev) / 1e9)
        work = gflop(sym, kind, dtype, ne)
        rows.append({"name": name, "n": n, "kind": kind,
                     "dtype": str(dtype).replace("torch.", ""),
                     "analyze_s": analyze_s, "factor_s": factor_s,
                     "solve_ms": solve_ms, "refine_steps": steps,
                     "residual": residual, "peak_gb": peaks[-1],
                     **shape_of(sym), "factor_gflop": work})
        print(f"phase 7 [{card}] {name}: n {n}, {kind} {rows[-1]['dtype']}, "
              f"analyze {analyze_s:.3f} s, factor {factor_s:.3f} s (second "
              f"call; {work:.2f} GFLOP on padded fronts, "
              f"{work / factor_s:.1f} GFLOP/s), solve k=1 {solve_ms:.3f} ms, "
              f"{steps} refinement "
              f"steps, residual {residual:.3e}, peak {peaks[-1]:.3f} GB, "
              f"{rows[-1]['levels']} levels / {rows[-1]['buckets']} buckets /"
              f" {rows[-1]['fronts']} fronts", flush=True)
        torch.cuda.reset_peak_memory_stats(dev)

    def factored(a, sym, **kw):
        """Factor twice; the factors and the second call's wall time."""
        wall(lambda: api.factor(a, sym, backend="multifrontal", **kw))
        return wall(lambda: api.factor(a, sym, backend="multifrontal", **kw))

    def refined_case(name, a32, a64, sym, analyze_s, **kw):
        """f32 factors, f64 refinement (tol 1e-10, at most 4 steps)."""
        f, factor_s = factored(a32, sym, **kw)
        n = a64.shape[0]
        b = torch.randn(n, dtype=f64, device=dev, generator=dgen)
        (x, info), _ = wall(lambda: api.solve_refined(
            f, a64, b, tol=1e-10, max_iter=4))
        res = rel_res(a64, x, b)
        require(x.shape == (n,) and bool(torch.isfinite(x).all()),
                f"{name}: solution")
        require(info.converged and res <= 1e-10,
                f"{name}: refined residual {res} (info {info})")
        solve_ms = events_ms(lambda: api.solve(f, b.to(f32)))
        row(name, n, kw.get("kind", "lu"), f32, sym, analyze_s, factor_s,
            solve_ms, info.refinement_steps, res)
        return f

    # the host library (symbolic analysis, orderings) is built from the
    # checkout's sources at first use: built here, outside analyze's time
    _, build_s = wall(native.load)
    print(f"phase 7 host library: {native.library_path().relative_to(ROOT)}"
          f" built or loaded in {build_s:.2f} s (g++ "
          f"{' '.join(native.GXX_FLAGS)})", flush=True)

    # ---- 1-3, 5, 7: the 1024**2 operator, one analyze
    g = grids[0]
    n = g * g
    a32 = poisson_2d(g, dtype=f32, device=dev)
    a64 = poisson_2d(g, dtype=f64, device=dev)
    sym, analyze_s = wall(lambda: api.analyze(a32, backend="multifrontal",
                                              dims=(g, g)))
    f = refined_case("2d cholesky f32", a32, a64, sym, analyze_s,
                     kind="cholesky")
    if keep is not None:
        keep["cholesky"] = {"grid": g, "factors": f.to("cpu")}
    del f
    torch.cuda.empty_cache()
    refined_case("2d lu f32 pivot_eps=1e-10", a32, a64, sym, analyze_s,
                 kind="lu", pivot_eps=1e-10)
    torch.cuda.empty_cache()
    f_first, _ = wall(lambda: api.factor(a64, sym, backend="multifrontal",
                                         kind="cholesky"))
    f, factor_s = wall(lambda: api.factor(a64, sym, backend="multifrontal",
                                          kind="cholesky"))
    b = torch.randn(n, dtype=f64, device=dev, generator=dgen)
    x = api.solve(f, b)
    res = rel_res(a64, x, b)
    require(not f.breakdown and res <= 1e-10,
            f"2d cholesky f64: direct residual {res}")
    solve_ms = events_ms(lambda: api.solve(f, b))
    row("2d cholesky f64", n, "cholesky", f64, sym, analyze_s, factor_s,
        solve_ms, 0, res)

    # 5. solve throughput on the f64 Cholesky factors
    b80 = torch.randn((n, 80), dtype=f64, device=dev, generator=dgen)
    x80 = api.solve(f, b80)
    res80 = rel_res(a64, x80, b80)
    ms80 = events_ms(lambda: api.solve(f, b80))
    xh = api.solve(f, b, trans="H")
    res_h = rel_res(a64.ctrans().tocsr(), xh, b)
    ms_h = events_ms(lambda: api.solve(f, b, trans="H"))
    # Cholesky: row_perm = col_perm = the fill-reducing order, so
    # x = Q U^-1 L^-1 P b is solve_part "L" of b[perm], then "U", then
    # scattered back through perm
    perm = torch.as_tensor(sym.perm, dtype=torch.int64, device=dev)
    ms_l = events_ms(lambda: api.solve_part(f, b[perm], "L"))
    z = api.solve_part(f, b[perm], "L")
    ms_u = events_ms(lambda: api.solve_part(f, z, "U"))
    xp = torch.empty_like(b)
    xp[perm] = api.solve_part(f, z, "U")
    part_rel = float(torch.linalg.vector_norm(xp - x)
                     / torch.linalg.vector_norm(x))
    print(f"phase 7 [{card}] solve 2d cholesky f64: k=1 {solve_ms:.3f} ms, "
          f"k=80 {ms80:.3f} ms (residual {res80:.3e}), trans=H k=1 "
          f"{ms_h:.3f} ms (residual {res_h:.3e}); solve_part L {ms_l:.3f} ms"
          f" + U {ms_u:.3f} ms, against the full solve {part_rel:.3e} (tol "
          f"1e-12)", flush=True)
    require(res80 <= 1e-10 and res_h <= 1e-10,
            f"k=80 / trans=H residuals {res80}, {res_h}")
    require(part_rel <= 1e-12, f"solve_part L then U: {part_rel}")
    rows[-1].update(solve_k80_ms=ms80, solve_h_ms=ms_h,
                    solve_part_l_ms=ms_l, solve_part_u_ms=ms_u)

    # 7. checks on the f64 Cholesky factors
    sign, logdet = api.slogdet(f)
    lam = (2.0 - 2.0 * torch.cos(torch.arange(1, g + 1, dtype=f64)
                                 * math.pi / (g + 1)))
    exact = float(torch.log(lam[:, None] + lam[None, :]).sum())
    det_rel = abs(float(logdet) - exact) / abs(exact)
    rc = float(api.rcond(f))

    def blocks_digest(fac):
        return digest(torch.cat([fac.blocks[k][name].reshape(-1)
                                 for k in sorted(fac.blocks) if k >= 0
                                 for name in ("lu", "g12")]))

    d1, d2 = blocks_digest(f_first), blocks_digest(f)
    print(f"phase 7 [{card}] 2d cholesky f64: slogdet sign {float(sign)}, "
          f"log|det| {float(logdet):.12f} vs analytic {exact:.12f} (rel "
          f"{det_rel:.3e}, tol 1e-10), rcond {rc:.6e}; two factorizations' "
          f"digests {d1} {d2}, bitwise equal: {str(d1 == d2).lower()}",
          flush=True)
    require(float(sign) == 1.0 and det_rel <= 1e-10,
            f"slogdet {float(logdet)} vs {exact}")
    del f, f_first, a32, a64, x, x80, b80, xh, xp, z, sym
    torch.cuda.empty_cache()

    # ---- 4. the 64**3 operator
    g3 = grids[1]
    a32 = poisson_3d(g3, dtype=f32, device=dev)
    a64 = poisson_3d(g3, dtype=f64, device=dev)
    sym, analyze_s = wall(lambda: api.analyze(a32, backend="multifrontal",
                                              dims=(g3, g3, g3)))
    refined_case("3d cholesky f32", a32, a64, sym, analyze_s,
                 kind="cholesky")
    del a32, a64, sym
    torch.cuda.empty_cache()

    # ---- 6. FEAST's contour shape: 8 shifted complex factorizations
    gf = grids[2]
    nf = gf * gf
    a = poisson_2d(gf, dtype=f64, device=dev)
    sym, analyze_s = wall(lambda: api.analyze(a, backend="multifrontal",
                                              dims=(gf, gf)))
    diag = (a.row_ids() == a.indices).to(c128)
    theta = (2 * torch.arange(8, dtype=f64) + 1) * math.pi / 16
    z = 0.3 + 0.2 * torch.exp(1j * theta).to(c128)
    data = z[:, None].to(dev) * diag[None, :] - a.data.to(c128)[None, :]
    wall(lambda: api.factor_batched(a, data, sym))
    fb, factor_s = wall(lambda: api.factor_batched(a, data, sym))
    rhs = torch.randn((8, nf, 80), dtype=c128, device=dev, generator=dgen)
    xb, solve_s = wall(lambda: api.solve_batched(fb, rhs))
    res_b = [rel_res(dataclasses.replace(a, data=data[k]), xb[k], rhs[k])
             for k in range(8)]
    print(f"phase 7 [{card}] contour 192^2: factor_batched 8 x c128 "
          f"{factor_s:.3f} s, solve_batched (8, {nf}, 80) "
          f"{solve_s * 1e3:.3f} ms, residuals max {max(res_b):.3e} (tol "
          f"1e-10)", flush=True)
    require(max(res_b) <= 1e-10, f"contour residuals {res_b}")
    solve_ms = events_ms(lambda: api.solve_batched(fb, rhs[:, :, :1]))
    row("contour 192^2 factor_batched x8", nf, "lu", c128, sym, analyze_s,
        factor_s, solve_ms, 0, max(res_b), ne=8)
    rows[-1]["solve_k80_ms"] = solve_s * 1e3
    del fb, xb, rhs, data, a, sym
    torch.cuda.empty_cache()

    peak = max(peaks)
    print(f"phase 7 direct solver: {time.perf_counter() - t_phase:.3f} s "
          f"wall, peak device memory {peak:.3f} GB (tol 40)", flush=True)
    require(peak < 40.0, f"phase 7 peak device memory {peak} GB")
    return rows


def spectrum_2d(g):
    """The g**2 five-point operator's eigenvalues, ascending (numpy)."""
    import numpy as np

    lam1 = 4 * np.sin(np.arange(1, g + 1) * np.pi / (2 * (g + 1))) ** 2
    return np.sort((lam1[:, None] + lam1[None, :]).ravel())


def dia_spmm_parity(dev, gen, random_dia, parity_abs) -> None:
    """Phase 3, kernel A's multi-RHS form: both layouts against the plain
    versions at m = 1, 2, 5, 8, 16, 33, 80, 96, 160; at m = 16, 80 and 160
    on the 2D operators every column bitwise kernel A on it, with a digest;
    m = 1100 on poisson_2d(512); the 3M x 2M DIA at m = 768 in f32 (nr * m
    past 2**31); and an X that is not 16-byte aligned."""
    import torch

    from sparse_linear_tpu_torch.kernels.spmv import dia_spmm, dia_spmm_planes
    from sparse_linear_tpu_torch.kernels.spmv_dia import (
        dia_spmm_kernel,
        dia_spmm_planes_kernel,
        dia_spmv_kernel,
    )
    from sparse_linear_tpu_torch.utils.grids import poisson_2d, poisson_3d

    tol = {torch.float32: 1e-5, torch.float64: 1e-12}

    def slabbed_err(y, x, a, planes, width=32):
        """(max abs err, max rel err) of y against the plain version,
        taken ``width`` right-hand sides at a time (the plain version pads
        all of X along the offsets and writes a Y of its own: at m = 160
        on 216**3 in f64 that is 26 GB beside the kernels' 52 GB)."""
        err = top = 0.0
        m = x.shape[0] if planes else x.shape[1]
        for t in range(0, m, width):
            if planes:
                ref = dia_spmm_planes(a, x[t:t + width])
                got = y[t:t + width]
            else:
                ref = dia_spmm(a, x[:, t:t + width])
                got = y[:, t:t + width]
            err = max(err, float((got - ref).abs().max()))
            top = max(top, float(ref.abs().max()))
            del ref, got
        return err, err / max(top, 1e-300)

    def check_large(label, a, m):
        """Both layouts at a large m, one at a time (X, Y and a slab of
        the plain version held at once)."""
        dtype = a.data.dtype
        x = torch.randn((a.shape[1], m), dtype=dtype, device=dev,
                        generator=gen)
        y = dia_spmm_kernel(a, x)
        err, rel = slabbed_err(y, x, a, False)
        del y
        xp = x.T.contiguous()
        del x
        yp = dia_spmm_planes_kernel(a, xp)
        errp, relp = slabbed_err(yp, xp, a, True)
        torch.cuda.synchronize()
        del xp, yp
        torch.cuda.empty_cache()
        print(f"phase 3 parity dia_spmm {label} {dtype} m={m} (nr * m = "
              f"{a.shape[0] * m}): max rel err column-major {rel:.3e}, "
              f"plane-major {relp:.3e} (max abs {max(err, errp):.3e}, tol "
              f"{tol[dtype]:.0e})", flush=True)
        require(rel <= tol[dtype] and relp <= tol[dtype],
                f"dia_spmm {label} {dtype} m={m} disagrees: {rel}, {relp}")
        parity_abs[f"dia_spmm {label} {dtype} m={m}"] = max(err, errp)
    ops = [("poisson_2d(2048)", lambda dt: poisson_2d(
               2048, dtype=dt, fmt="dia", device=dev)),
           ("poisson_2d(1448)", lambda dt: poisson_2d(
               1448, dtype=dt, fmt="dia", device=dev)),
           ("poisson_3d(216)", lambda dt: poisson_3d(
               216, dtype=dt, fmt="dia", device=dev)),
           ("rectangular 3000000x2000000", lambda dt: random_dia(
               (3_000_000, 2_000_000), (-1_000_000, -5, 0, 3, 1_500_000), dt,
               gen))]
    for dtype in (torch.float32, torch.float64):
        for label, make in ops:
            a = make(dtype)
            nc = a.shape[1]
            for m in (1, 2, 5, 8, 16, 33, 80, 96, 160):
                x = torch.randn((nc, m), dtype=dtype, device=dev,
                                generator=gen)
                y = dia_spmm_kernel(a, x)
                err, rel = slabbed_err(y, x, a, False)
                xp = x.T.contiguous()
                yp = dia_spmm_planes_kernel(a, xp)
                errp, relp = slabbed_err(yp, xp, a, True)
                torch.cuda.synchronize()
                print(f"phase 3 parity dia_spmm {label} {dtype} m={m}: max rel "
                      f"err column-major {rel:.3e}, plane-major {relp:.3e} "
                      f"(max abs {max(err, errp):.3e}, tol {tol[dtype]:.0e})",
                      flush=True)
                require(rel <= tol[dtype] and relp <= tol[dtype],
                        f"dia_spmm {label} {dtype} m={m} disagrees: {rel}, "
                        f"{relp}")
                parity_abs[f"dia_spmm {label} {dtype} m={m}"] = max(err, errp)
                if m in (16, 80, 160) and label.startswith("poisson_2d"):
                    same = all(
                        torch.equal(y[:, t], col) and torch.equal(yp[t], col)
                        for t in range(m)
                        for col in (dia_spmv_kernel(a, x[:, t].contiguous()),))
                    again = torch.equal(dia_spmm_kernel(a, x), y)
                    print(f"phase 3 dia_spmm {label} {dtype} m={m}: every "
                          f"column of both layouts bitwise dia_spmv {same}, "
                          f"repeated call bitwise equal {again}, digests "
                          f"{digest(y)} {digest(yp)}", flush=True)
                    require(same, f"dia_spmm {label} m={m} differs from "
                            "dia_spmv")
                    require(again, f"dia_spmm {label} m={m} not repeatable")
                del x, y, xp, yp
            del a
            torch.cuda.empty_cache()
        # m past the four chunks a lane holds, tiled 9 (f32) / 18 (f64)
        # times; X and Y 2.3 GB each in f64
        check_large("poisson_2d(512)", poisson_2d(512, dtype=dtype,
                                                   fmt="dia", device=dev),
                    1100)
    # nr * m = 2.3e9 > 2**31: every flat index into Y must be 64-bit
    check_large("rectangular 3000000x2000000", random_dia(
        (3_000_000, 2_000_000), (-1_000_000, -5, 0, 3, 1_500_000),
        torch.float32, gen), 768)

    # an X that starts one element past a 16-byte boundary (a contiguous
    # view at storage offset 1, NaN around it) takes the scalar lanes:
    # bitwise the aligned call, and nothing outside the view is read
    a = poisson_2d(1448, dtype=torch.float64, fmt="dia", device=dev)
    n = a.shape[1]
    for m in (16, 80):
        x = torch.randn((n, m), dtype=torch.float64, device=dev,
                        generator=gen)
        flat = torch.full((n * m + 8,), float("nan"), dtype=torch.float64,
                          device=dev)
        xm = flat[1:1 + n * m].view(n, m)
        xm.copy_(x)
        y = dia_spmm_kernel(a, xm)
        same = torch.equal(y, dia_spmm_kernel(a, x))
        err, rel = max_err(y, dia_spmm(a, x))
        torch.cuda.synchronize()
        print(f"phase 3 parity dia_spmm poisson_2d(1448) float64 m={m} X at "
              f"data_ptr % 16 = {xm.data_ptr() % 16}: finite "
              f"{bool(torch.isfinite(y).all())}, bitwise the aligned call "
              f"{same}, max rel err {rel:.3e} (tol 1e-12)", flush=True)
        require(same and rel <= 1e-12 and bool(torch.isfinite(y).all()),
                f"dia_spmm misaligned X m={m}")
        parity_abs[f"dia_spmm misaligned float64 m={m}"] = err
        del x, flat, xm, y
    del a
    torch.cuda.empty_cache()


def timed(f):
    """(f(), wall seconds), the card synchronised before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = f()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def feast_errors(res, want, interval):
    """(max |dlambda| / max(|emin|, |emax|, 1), max elementwise relative
    error) of an eigsh result against the analytic values."""
    import numpy as np

    got = np.sort(np.asarray(res.values))
    require(got.shape == want.shape,
            f"found {got.shape[0]} pairs, expected {want.shape[0]}")
    scale = max(abs(interval[0]), abs(interval[1]), 1.0)
    d = np.abs(got - want)
    return float(d.max() / scale), float((d / np.abs(want)).max())


def feast_solve(rows, phase, dev, card, name, a, interval, want, params,
                warm=1, rel=False, launches_of=None):
    """One ``eigsh(80, interval, a, params)`` timed cold, then the best of
    ``warm`` warm calls, held to INFO_OK, epsout <= 1e-10 and the analytic
    spectrum ``want`` within 1e-10 on the interval's scale (elementwise too
    if ``rel``); appends its row to ``rows``, prints it with the split of
    the cold run a loop, and returns the result.  ``launches_of`` (a
    wrapper) adds its launches during the run to the row."""
    import torch

    from sparse_linear_tpu_torch.eig import pipeline
    from sparse_linear_tpu_torch.eig.feast import INFO_OK, eigsh

    before = None if launches_of is None else launches_of.launches
    res, cold_s = timed(lambda: eigsh(80, interval, a, params))
    split = {k: v for k, v in pipeline.last_run.items()}
    warm_s = None
    for _ in range(warm):
        res = None
        res, w = timed(lambda: eigsh(80, interval, a, params))
        warm_s = w if warm_s is None else min(warm_s, w)
    err, err_rel = feast_errors(res, want, interval)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    row = {"name": name, "n": a.shape[0], "m0": 80,
           "interval": list(interval), "cold_s": cold_s,
           "warm_s": warm_s, "loops": res.iterations,
           "epsout": res.epsout, "n_found": res.n_found,
           "info": res.info, "max_err_scaled": err,
           "max_rel_err": err_rel, "mode": split["mode"],
           "why": split["why"], "routes": list(split["routes"]),
           "analyze_s": split["analyze_s"],
           "factor_s": split["factor_s"], "split": split["loops"],
           "peak_gb": peak}
    if launches_of is not None:
        row["launches"] = launches_of.launches - before
    rows.append(row)
    solves = sum(lp["solve_s"] for lp in split["loops"])
    rr = sum(lp["rr_s"] for lp in split["loops"])
    eighs = sum(lp["eigh_s"] for lp in split["loops"])
    warm_txt = "" if warm_s is None else f", warm {warm_s:.3f} s"
    print(f"{phase} [{card}] {name}: n {a.shape[0]}, cold "
          f"{cold_s:.3f} s{warm_txt}; {res.iterations} loops, "
          f"{res.n_found} pairs, epsout {res.epsout:.3e}, info "
          f"{res.info}; against the analytic spectrum {err:.3e} on the "
          f"interval's scale, {err_rel:.3e} elementwise relative (tol "
          f"1e-10); contour {split['mode']} ({split['why']}), routes "
          f"{split['routes']}; cold split: analyze "
          f"{split['analyze_s']:.3f} s, factor {split['factor_s']:.3f} s,"
          f" solves {solves:.3f} s, Rayleigh-Ritz products {rr:.3f} s, "
          f"host eighs {eighs:.3f} s over {len(split['loops'])} loops; "
          f"peak {peak:.3f} GB", flush=True)
    for i, lp in enumerate(split["loops"]):
        ghosts = ", ".join(f"{v:.9f}: {r:.4e}" for v, r in lp["ghosts"])
        print(f"{phase} [{card}] {name} cold loop {i}: solves "
              f"{lp['solve_s']:.3f} s (streamed factors "
              f"{lp['factor_s']:.3f} s), products {lp['rr_s']:.3f} s, "
              f"eighs {lp['eigh_s']:.4f} s; {lp['genuine']} genuine "
              f"pairs at {lp['epsout']:.3e}, {lp['rejected']} spurious "
              f"rejected (Ritz value: residual {{{ghosts}}})", flush=True)
    require(res.info == INFO_OK, f"{name}: info {res.info}")
    require(res.epsout <= 1e-10, f"{name}: epsout {res.epsout}")
    require(err <= 1e-10, f"{name}: eigenvalue error {err}")
    if rel:
        require(err_rel <= 1e-10, f"{name}: relative error {err_rel}")
    vec = res.vectors
    require(tuple(vec.shape) == (a.shape[0], res.n_found)
            and vec.device.type == "cuda"
            and bool(torch.isfinite(vec).all()), f"{name}: vectors")
    return res


def gauge_chain(g, theta, dev):
    """The 1D operator with 2 on its diagonal, -e^{i theta} above it and
    -e^{-i theta} below, complex128, built from triples on the card."""
    import torch

    import sparse_linear_tpu_torch as st

    c128 = torch.complex128
    i = torch.arange(g, device=dev)
    ph = cmath.exp(1j * theta)
    vals = torch.cat([torch.full((g,), 2.0, dtype=c128, device=dev),
                      torch.full((g - 1,), -ph, dtype=c128, device=dev),
                      torch.full((g - 1,), -ph.conjugate(), dtype=c128,
                                 device=dev)])
    return st.from_triples((g, g), torch.cat([i, i[:-1], i[1:]]),
                           torch.cat([i, i[1:], i[:-1]]), vals).tocsr()


def gauge_kron(g, theta, dev):
    """The g**2 gauge-transformed five-point operator, kron(I, T_theta) +
    kron(T_0, I), built on the card with the port's ``kron``: A[p, p + e_x]
    = -e^{i theta}, A[p + e_x, p] = -e^{-i theta}, the rest as in
    ``poisson_2d``.  It is D A_0 D^H with D = diag(e^{i theta x_p}) unitary:
    complex Hermitian, banded (5 diagonals), with Poisson's spectrum."""
    import torch

    import sparse_linear_tpu_torch as st

    eye = st.eye(g, dtype=torch.complex128, device=dev)
    return (st.kron(eye, gauge_chain(g, theta, dev))
            + st.kron(gauge_chain(g, 0.0, dev), eye))


def gauge_triples(g, theta, dev):
    """(rows, cols, values) of the same operator, written out."""
    import torch

    c128 = torch.complex128
    p = torch.arange(g * g, device=dev)
    right, up = p[p % g < g - 1], p[p < g * g - g]
    ph = cmath.exp(1j * theta)

    def full(k, v):
        return torch.full((k,), v, dtype=c128, device=dev)

    return (torch.cat([p, right, right + 1, up, up + g]),
            torch.cat([p, right + 1, right, up + g, up]),
            torch.cat([full(g * g, 4.0), full(right.shape[0], -ph),
                       full(right.shape[0], -ph.conjugate()),
                       full(2 * up.shape[0], -1.0)]))


def gauge_phases(g, theta, dev):
    """The diagonal of D, e^{i theta x_p} for p = x + g y."""
    import torch

    x = (torch.arange(g * g, device=dev) % g).to(torch.float64)
    return torch.polar(torch.ones_like(x), theta * x)


def permuted(csr, gen):
    """``csr`` with rows and columns relabelled by one seeded permutation,
    and the permutation."""
    import torch

    import sparse_linear_tpu_torch as st

    n = csr.shape[0]
    coo = csr.tocoo()
    perm = torch.randperm(n, device=csr.data.device, generator=gen)
    return st.from_triples((n, n), perm[coo.row.long()],
                           perm[coo.col.long()], coo.data).tocsr(), perm


@contextlib.contextmanager
def no_csr_spmm():
    """``ops.linalg.spmm`` (the plain gather / ``index_add_`` product)
    raises while the block runs: a path that reaches it fails."""
    from sparse_linear_tpu_torch.ops import linalg

    kept = linalg.spmm

    def refuse(*args, **kwargs):
        raise RuntimeError("chip_smoke: ops.linalg.spmm reached on the "
                           "card")

    linalg.spmm = refuse
    try:
        yield
    finally:
        linalg.spmm = kept


def complex_parity(dev, gen, parity_abs, grid=2048, odd=1448, cube=216,
                   rect=(3_000_000, 2_000_000)) -> None:
    """Phase 3, the complex instantiations of kernels A (and its multi-RHS
    form), C and D against their plain versions, complex64 (1e-5) and
    complex128 (1e-12): kernel A on the gauge operator at 2048**2, a
    phased 1448**2 and 216**3 and a complex 3M x 2M DIA; the multi-RHS
    form at m = 1, 16, 80, 96 in both layouts on those (m <= 16 on the
    216**3 and 3M x 2M ones), every column bitwise complex kernel A at
    m = 16 and 80 on 1448**2, an X one element off its aligned start; a
    real operator times a complex x and X, each part bitwise the real
    kernel; kernels C and D on the permuted gauge operator at 2048**2 and a
    complex skewed 3M x 2M WELL, D at m = 1, 16, 80, 96 in both layouts,
    every column bitwise C at m = 16 and 80, with an X one element off its
    aligned start; every result again bitwise on a second call, with a
    digest of each SpMV and of the m = 16 results.  The sizes are
    keywords, so that a probe can call it small."""
    import torch

    import sparse_linear_tpu_torch as st
    from sparse_linear_tpu_torch.formats.structured import DIA, csr_to_dia
    from sparse_linear_tpu_torch.kernels.spmv import (
        dia_spmm,
        dia_spmm_planes,
        dia_spmv,
    )
    from sparse_linear_tpu_torch.kernels.spmv_dia import (
        dia_spmm_kernel,
        dia_spmm_planes_kernel,
        dia_spmv_kernel,
    )
    from sparse_linear_tpu_torch.kernels.spmv_well import (
        well_spmm,
        well_spmm_planes,
        well_spmm_planes_plain,
        well_spmv,
        well_spmv_plain,
    )
    from sparse_linear_tpu_torch.utils.grids import poisson_2d, poisson_3d

    c64, c128, f64 = torch.complex64, torch.complex128, torch.float64
    tol = {c64: 1e-5, c128: 1e-12}

    def crandn(shape, dtype):
        return torch.randn(shape, dtype=dtype, device=dev, generator=gen)

    def phased(a, dtype):
        """A DIA's values turned by seeded random phases (zeros stay 0)."""
        turn = torch.polar(torch.ones(a.data.shape, dtype=f64, device=dev),
                           2 * math.pi * torch.rand(
                               a.data.shape, dtype=f64, device=dev,
                               generator=gen))
        return DIA(data=(a.data.to(c128) * turn).to(dtype), shape=a.shape,
                   offsets=a.offsets)

    def check(label, dtype, y, ref, again=None):
        """Parity with the plain version; ``again``: whether a second call
        gave bitwise the same result.  A digest of y is printed for a 1-D
        y (the SpMVs); the multi-RHS results are digested at m = 16 in the
        column checks (hashing every GB-sized Y on the host took most of
        this phase's time)."""
        err, rel = max_err(y, ref)
        rep = "" if again is None else f", repeated call bitwise equal " \
            f"{again}" + (f", digest {digest(y)}" if y.ndim == 1 else "")
        print(f"phase 3 parity {label} {dtype}: max rel err {rel:.3e} (max "
              f"abs {err:.3e}, tol {tol[dtype]:.0e}){rep}", flush=True)
        require(rel <= tol[dtype], f"{label} {dtype} disagrees: {rel}")
        require(again is None or again, f"{label} {dtype} not repeatable")
        parity_abs[f"{label} {dtype}"] = err

    def slabbed(plain, x, planes, width=32):
        """The plain version ``width`` right-hand sides at a time."""
        m = x.shape[0] if planes else x.shape[1]
        parts = [plain(x[t:t + width] if planes else x[:, t:t + width])
                 for t in range(0, m, width)]
        return torch.cat(parts, 0 if planes else 1)

    nr_r, nc_r = rect
    t0 = time.perf_counter()
    gauge = gauge_kron(grid, THETA, dev)
    for dtype in (c64, c128):
        ops = [(f"gauge {grid}^2", csr_to_dia(gauge.map_values(
                    lambda v: v.to(dtype))), (1, 16, 80, 96)),
               (f"phased poisson_2d({odd})", phased(poisson_2d(
                   odd, dtype=f64, fmt="dia", device=dev), dtype),
                (1, 16, 80, 96)),
               (f"phased poisson_3d({cube})", phased(poisson_3d(
                   cube, dtype=f64, fmt="dia", device=dev), dtype), (1, 16)),
               (f"complex {nr_r}x{nc_r}", phased(DIA(
                   data=torch.randn((5, nr_r), dtype=f64, device=dev,
                                    generator=gen),
                   shape=(nr_r, nc_r),
                   offsets=(-(nc_r // 2), -5, 0, 3, nc_r * 3 // 4)), dtype),
                (1, 16))]
        for label, a, ms in ops:
            t_op = time.perf_counter()
            nr, nc = a.shape
            i = torch.arange(nr, device=dev)
            for d, off in enumerate(a.offsets):  # zeros off the matrix
                a.data[d].masked_fill_((i + off < 0) | (i + off >= nc), 0)
            x = crandn(nc, dtype)
            y = dia_spmv_kernel(a, x)
            check(f"dia_spmv {label}", dtype, y, dia_spmv(a, x),
                  torch.equal(dia_spmv_kernel(a, x), y))
            for m in ms:
                x = crandn((nc, m), dtype)
                y = dia_spmm_kernel(a, x)
                check(f"dia_spmm {label} m={m}", dtype, y,
                      slabbed(lambda s: dia_spmm(a, s), x, False),
                      torch.equal(dia_spmm_kernel(a, x), y))
                xp = x.T.contiguous()
                del x, y
                yp = dia_spmm_planes_kernel(a, xp)
                check(f"dia_spmm_planes {label} m={m}", dtype, yp,
                      slabbed(lambda s: dia_spmm_planes(a, s), xp, True),
                      torch.equal(dia_spmm_planes_kernel(a, xp), yp))
                del xp, yp
                torch.cuda.empty_cache()
            if label.startswith("phased poisson_2d"):
                for m in (16, 80):
                    x = crandn((nc, m), dtype)
                    y = dia_spmm_kernel(a, x)
                    yp = dia_spmm_planes_kernel(a, x.T.contiguous())
                    same = all(torch.equal(y[:, t], col)
                               and torch.equal(yp[t], col)
                               for t in range(m)
                               for col in (dia_spmv_kernel(
                                   a, x[:, t].contiguous()),))
                    flat = torch.full((nc * m + 4,), complex("nan+nanj"),
                                      dtype=dtype, device=dev)
                    xm = flat[1:1 + nc * m].view(nc, m)
                    xm.copy_(x)
                    off = dia_spmm_kernel(a, xm)
                    off_same = torch.equal(off, y)
                    torch.cuda.synchronize()
                    digests = f"; digests {digest(y)} {digest(yp)}" \
                        if m == 16 else ""
                    print(f"phase 3 dia_spmm {label} {dtype} m={m}: every "
                          f"column of both layouts bitwise dia_spmv {same}; "
                          f"X at data_ptr % 16 = {xm.data_ptr() % 16} "
                          f"bitwise the aligned call {off_same}{digests}",
                          flush=True)
                    require(same, f"complex dia_spmm {label} m={m} differs "
                            "from dia_spmv")
                    require(off_same, f"complex dia_spmm {label} m={m} "
                            "offset X")
                    del x, y, yp, flat, xm, off
            del a
            torch.cuda.empty_cache()
            print(f"phase 3 complex {label} {dtype}: "
                  f"{time.perf_counter() - t_op:.1f} s", flush=True)

    # a real operator times a complex x / X: the real kernels on the real
    # block, each part bitwise the real kernel on it
    a = poisson_2d(odd, dtype=f64, fmt="dia", device=dev)
    x = crandn((a.shape[1], 16), c128)
    y, yv = dia_spmm_kernel(a, x), dia_spmv_kernel(a, x[:, 0].contiguous())
    parts = (torch.equal(y.real, dia_spmm_kernel(a, x.real.contiguous()))
             and torch.equal(y.imag, dia_spmm_kernel(a, x.imag.contiguous()))
             and torch.equal(yv.real, dia_spmv_kernel(
                 a, x[:, 0].real.contiguous())))
    check("dia_spmm real operator complex X m=16", c128, y, dia_spmm(a, x))
    print(f"phase 3 dia real operator, complex x and X: each part bitwise "
          f"the real kernel {parts}", flush=True)
    require(parts, "real DIA times complex x: parts differ")
    del a, x, y, yv

    # kernels C and D on the permuted gauge operator and a skewed WELL
    t_dia = time.perf_counter() - t0
    pgen = torch.Generator(device=dev).manual_seed(7)
    pg, _ = permuted(gauge, pgen)
    del gauge
    nr_s, nc_s = rect
    lens = torch.randint(1, 65, (nr_s,), device=dev, generator=gen)
    lens[torch.randint(0, nr_s, (4,), device=dev, generator=gen)] = min(
        4096, nc_s)
    rows = torch.repeat_interleave(torch.arange(nr_s, device=dev), lens)
    skew = st.from_triples((nr_s, nc_s), rows, torch.randint(
        0, nc_s, rows.shape, device=dev, generator=gen),
        crandn(rows.shape[0], c128)).tocsr()
    del rows, lens
    t_build = time.perf_counter() - t0 - t_dia
    for dtype in (c64, c128):
        t_well = time.perf_counter()
        for label, csr, ms in ((f"permuted gauge {grid}^2", pg,
                                (1, 16, 80, 96)),
                               (f"skewed {nr_s}x{nc_s}", skew, (16,))):
            w = st.csr_to_well(csr.map_values(lambda v: v.to(dtype)))
            x = crandn(w.shape[1], dtype)
            y = well_spmv(w, x)
            check(f"well_spmv {label}", dtype, y, well_spmv_plain(w, x),
                  torch.equal(well_spmv(w, x), y))
            for m in ms:
                xp = crandn((m, w.shape[1]), dtype)
                y = well_spmm_planes(w, xp)
                ref = torch.cat([well_spmm_planes_plain(w, xp[t:t + 4])
                                 for t in range(0, m, 4)])
                check(f"well_spmm_planes {label} m={m}", dtype, y, ref,
                      torch.equal(well_spmm_planes(w, xp), y))
                yc = well_spmm(w, xp.T.contiguous())
                check(f"well_spmm {label} m={m}", dtype, yc.T, ref,
                      torch.equal(well_spmm(w, xp.T.contiguous()), yc))
                if m in (16, 80):
                    same = all(torch.equal(yc[:, t], well_spmv(w, xp[t]))
                               for t in range(m))
                    # X one element past its aligned start (the scalar
                    # lanes for complex64), NaN around it
                    nc = w.shape[1]
                    flat = torch.full((nc * m + 4,), complex("nan+nanj"),
                                      dtype=dtype, device=dev)
                    xm = flat[1:1 + nc * m].view(nc, m)
                    xm.copy_(xp.T)
                    off_same = torch.equal(well_spmm(w, xm), yc)
                    digests = f"; digest {digest(yc)}" if m == 16 else ""
                    print(f"phase 3 well_spmm {label} {dtype} m={m}: every "
                          f"column bitwise well_spmv {same}; X at data_ptr "
                          f"% 16 = {xm.data_ptr() % 16} bitwise the aligned "
                          f"call {off_same}{digests}", flush=True)
                    require(same, f"complex well_spmm {label} m={m} differs "
                            "from well_spmv")
                    require(off_same, f"complex well_spmm {label} m={m} "
                            "offset X")
                    del flat, xm
                del xp, y, ref, yc
                torch.cuda.empty_cache()
            del w
            print(f"phase 3 complex {label} {dtype}: "
                  f"{time.perf_counter() - t_well:.1f} s", flush=True)
            t_well = time.perf_counter()
    wr = st.csr_to_well(pg.map_values(lambda v: v.real.contiguous()))
    x = crandn((pg.shape[1], 16), c128)
    y = well_spmm(wr, x)
    parts = (torch.equal(y.real, well_spmm(wr, x.real.contiguous()))
             and torch.equal(y.imag, well_spmm(wr, x.imag.contiguous())))
    check("well_spmm real operator complex X m=16", c128, y,
          well_spmm_planes_plain(wr, x.T).T)
    print(f"phase 3 well real operator, complex X: each part bitwise the "
          f"real kernel {parts}", flush=True)
    require(parts, "real WELL times complex X: parts differ")
    del wr, x, y, pg, skew
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"phase 3 complex parity: {time.perf_counter() - t0:.1f} s (DIA "
          f"{t_dia:.1f} s, the skewed WELL's build {t_build:.1f} s)",
          flush=True)


def complex_phase(dev, card, seed, b_real, dia_its, well_its,
                  grids=(2048, 1024, 192)):
    """Phase 9: complex Hermitian operators on the card, through the
    complex kernels, at full width.  The gauge operator (``gauge_kron``)
    built with ``kron`` at ``grids[0]``**2, held bitwise against the same
    operator from triples; (a) CG on it through DIA (complex kernel A) with
    b = D b_real, phase 4's right-hand side turned by D; (b) CG on it
    permuted by a seeded relabelling, through ``recommend_format`` ->
    WELL (complex kernel C); (c) FEAST's 50 lowest pairs at
    ``grids[1]``**2 (the DIA route, complex kernel A's multi-RHS form); (d)
    the permuted operator at ``grids[2]``**2 (AMD, the WELL route, complex
    kernel D); ``ops.linalg.spmm`` raises throughout (c) and (d).  Returns
    (rows of the ``feast`` JSON line, launches by kernel, CG counts)."""
    import torch

    import sparse_linear_tpu_torch as st
    from sparse_linear_tpu_torch.eig import pipeline
    from sparse_linear_tpu_torch.eig.feast import FeastParams
    from sparse_linear_tpu_torch.formats.structured import DIA
    from sparse_linear_tpu_torch.kernels.spmv_dia import (
        dia_spmm_kernel,
        dia_spmv_kernel,
    )
    from sparse_linear_tpu_torch.kernels.spmv_well import well_spmm, well_spmv
    from sparse_linear_tpu_torch.solve.cg import cg

    c128 = torch.complex128
    cgen = torch.Generator(device=dev).manual_seed(seed + 6)
    rows, launches, counts = [], {}, {}
    t_phase = time.perf_counter()
    pipeline.clear_pipeline_cache()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)

    g = grids[0]
    n = g * g
    a, kron_s = timed(lambda: gauge_kron(g, THETA, dev))
    ref = st.from_triples((n, n), *gauge_triples(g, THETA, dev)).tocsr()
    same = (torch.equal(a.indptr, ref.indptr)
            and torch.equal(a.indices, ref.indices)
            and digest(a.data) == digest(ref.data))
    herm = a.is_hermitian()
    print(f"phase 9 gauge operator {g}^2 (theta {THETA}): kron(I, T_theta) + "
          f"kron(T, I) on the card in {kron_s:.3f} s, nnz {a.nnz}, bitwise "
          f"the operator from triples {same}, Hermitian {herm}", flush=True)
    require(same, "kron-built gauge operator differs from the triples")
    require(herm, "gauge operator is not Hermitian")
    del ref

    def run_cg(label, op, b, csr, counter, phase_its):
        counter.launches = 0
        res, cg_s = timed(lambda: cg(op, b, tol=1e-10, maxiter=40_000))
        bnorm = float(torch.linalg.vector_norm(b))
        true_res = float(torch.linalg.vector_norm(
            b - st.spmv(csr, res.x))) / bnorm
        print(f"phase 9 cg c128 {label}: {res.iterations} iterations "
              f"({phase_its}; {res.launched} queued, {res.host_reads} host "
              f"reads), true residual (CSR spmv) {true_res:.3e} "
              f"(tol 1e-9), {cg_s:.3f} s, "
              f"{cg_s / max(res.iterations, 1) * 1e3:.4f} ms/iteration, "
              f"{counter.__name__} launches {counter.launches}", flush=True)
        require(res.converged, f"cg {label} did not converge")
        require(bool(torch.isfinite(res.x).all()), f"cg {label}: non-finite")
        require(true_res <= 1e-9, f"cg {label}: true residual {true_res}")
        require(counter.launches >= res.iterations,
                f"cg {label}: {counter.__name__} launches "
                f"{counter.launches} < {res.iterations} iterations")
        return res.iterations, counter.launches

    # ---- (a) DIA: complex kernel A
    kind = st.recommend_format(a)
    dia = st.to_fast_format(a)
    require(kind == "dia" and isinstance(dia, DIA) and dia.dtype == c128,
            f"gauge operator: recommend_format {kind!r}, {type(dia)}")
    b = gauge_phases(g, THETA, dev) * b_real.to(dev)
    counts["dia_cg"], launches["dia_spmv complex"] = run_cg(
        f"gauge {g}^2 through DIA", dia.__matmul__, b, a, dia_spmv_kernel,
        f"real phase 4: {dia_its}")
    del dia

    # ---- (b) permuted, through WELL: complex kernel C
    ap, perm = permuted(a, cgen)
    del a
    kind = st.recommend_format(ap)
    w = st.to_fast_format(ap)
    require(kind == "well" and isinstance(w, st.WELL) and w.dtype == c128,
            f"permuted gauge operator: recommend_format {kind!r}")
    bp = torch.empty_like(b)
    bp[perm] = b
    del b, perm
    counts["well_cg"], launches["well_spmv complex"] = run_cg(
        f"permuted gauge {g}^2 through WELL", w.__matmul__, bp, ap,
        well_spmv, f"DIA above: {counts['dia_cg']}; real phase 6: "
        f"{well_its}")
    del w, ap, bp
    torch.cuda.empty_cache()

    # ---- (c) FEAST at grids[1]**2: the DIA route, complex multi-RHS form
    gb = grids[1]
    a_b = gauge_kron(gb, THETA, dev)
    lam = spectrum_2d(gb)
    emax = float((lam[49] + lam[50]) / 2)
    torch.cuda.reset_peak_memory_stats(dev)
    dia_spmm_kernel.launches = 0
    with no_csr_spmm():
        feast_solve(rows, "phase 9", dev, card, f"gauge lowest 50 of {gb}^2",
                    a_b, (0.0, emax), lam[:50], FeastParams(
                        tol=1e-10, dims=(gb, gb), backend="multifrontal"),
                    warm=1)
    launches["dia_spmm complex"] = dia_spmm_kernel.launches
    require(rows[-1]["routes"][0] == "dia"
            and launches["dia_spmm complex"] >= 1,
            f"gauge FEAST routes {rows[-1]['routes']}, dia_spmm launches "
            f"{launches['dia_spmm complex']}")
    del a_b
    pipeline.clear_pipeline_cache()
    torch.cuda.empty_cache()

    # ---- (d) the permuted operator at grids[2]**2: the WELL route
    gs = grids[2]
    a_s, _ = permuted(gauge_kron(gs, THETA, dev), cgen)
    lam = spectrum_2d(gs)
    emax = float((lam[49] + lam[50]) / 2)
    torch.cuda.reset_peak_memory_stats(dev)
    well_spmm.launches = 0
    with no_csr_spmm():
        feast_solve(rows, "phase 9", dev, card,
                    f"permuted gauge lowest 50 of {gs}^2", a_s, (0.0, emax),
                    lam[:50], FeastParams(tol=1e-10, backend="multifrontal"),
                    warm=0, launches_of=well_spmm)
    launches["well_spmm complex"] = well_spmm.launches
    require(rows[-1]["routes"][0] == "well"
            and launches["well_spmm complex"] >= 1,
            f"permuted gauge FEAST routes {rows[-1]['routes']}, well_spmm "
            f"launches {launches['well_spmm complex']}")
    del a_s
    pipeline.clear_pipeline_cache()
    torch.cuda.empty_cache()
    peak = max(r["peak_gb"] for r in rows)
    print(f"phase 9 complex Hermitian: {time.perf_counter() - t_phase:.3f} s "
          f"wall, launches {launches}, peak device memory {peak:.3f} GB (tol "
          f"75)", flush=True)
    require(peak < 75.0, f"phase 9 peak device memory {peak} GB")
    return rows, launches, counts


def feast_phase(dev, card: str, seed: int, grids=(192, 1024, 64),
                keep=None) -> list:
    """Phase 8: FEAST through ``eig.feast`` at full size: ``grids`` are the
    36,864-dof operator's, the 1,048,576-dof one's and the slicing one's.
    Returns the rows of the ``feast`` JSON line; any failed check raises.
    With ``keep`` (a dict) the subspace of the 1,048,576-dof lowest-50
    window is copied to the host for phase 11 with its grid, window,
    parameters and the loops of its cold run (``keep["subspace"]``), and the
    eigenvalues and loops of the lowest-50 windows by grid
    (``keep["feast"]``, for phase 12), with the permuted operator's under
    ``"permuted"`` beside the operator on the host."""
    import numpy as np
    import torch

    import sparse_linear_tpu_torch as st
    from sparse_linear_tpu_torch.eig import pipeline
    from sparse_linear_tpu_torch.eig.feast import (
        FeastParams,
        count_eigenvalues,
        eigsh_sliced,
    )
    from sparse_linear_tpu_torch.kernels.spmv_dia import dia_spmm_kernel
    from sparse_linear_tpu_torch.kernels.spmv_well import well_spmm
    from sparse_linear_tpu_torch.utils.grids import poisson_2d

    f64 = torch.float64
    pgen = torch.Generator(device=dev).manual_seed(seed + 5)
    rows = []
    t_phase = time.perf_counter()
    pipeline.clear_pipeline_cache()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    dia_spmm_kernel.launches = 0

    def solve(name, a, interval, want, params, warm=1, rel=False,
              launches_of=None):
        return feast_solve(rows, "phase 8", dev, card, name, a, interval,
                           want, params, warm, rel, launches_of)

    # ---- 1. the 50 lowest pairs at 192**2 (bench.py:723-789)
    g = grids[0]
    lam = spectrum_2d(g)
    emax = float((lam[49] + lam[50]) / 2)
    a = poisson_2d(g, dtype=f64, device=dev)
    p = FeastParams(tol=1e-10, dims=(g, g), backend="multifrontal")
    res = solve(f"lowest 50 of {g}^2", a, (0.0, emax), lam[:50], p, warm=3,
                rel=True)
    if keep is not None:
        keep.setdefault("feast", {})[g] = (np.sort(np.asarray(res.values)),
                                           res.iterations)
    # each other contour mode forced on the same window: the same numbers,
    # and its time beside the planned mode's (streaming under a 1-byte
    # budget, as the tests force it)
    planned = rows[-1]["mode"]
    for mode, batching in (("batched", "vmap"), ("per-node", "loop"),
                           ("streaming", "auto")):
        if mode == planned:
            continue
        budget = pipeline._budget
        if mode == "streaming":
            pipeline._budget = lambda device, held=0.0: 1.0
        try:
            other = solve(f"lowest 50 of {g}^2, {mode} forced", a,
                          (0.0, emax), lam[:50], dataclasses.replace(
                              p, contour_batching=batching), warm=3,
                          rel=True)
        finally:
            pipeline._budget = budget
        d = float(np.max(np.abs(np.asarray(other.values)
                                - np.asarray(res.values))
                         / np.asarray(res.values)))
        rows[-1]["vs_planned_rel"] = d
        print(f"phase 8 [{card}] {mode} against {planned}: eigenvalues "
              f"within {d:.3e} relative (tol 1e-12)", flush=True)
        require(rows[-1]["mode"] == mode, f"forced {mode}: {rows[-1]}")
        require(d <= 1e-12, f"{mode} eigenvalues differ by {d}")
        del other

    # ---- 3a. count_eigenvalues on that window (16 probes)
    est, count_s = timed(lambda: count_eigenvalues(
        (0.0, emax), a, probes=16, params=p))
    print(f"phase 8 [{card}] count_eigenvalues lowest window of {g}^2: "
          f"estimate {est:.3f} for 50 (|est - 50| < 12.5) in {count_s:.3f} s",
          flush=True)
    require(abs(est - 50) < 12.5, f"count_eigenvalues {est}")
    rows.append({"name": f"count_eigenvalues lowest window of {g}^2",
                 "estimate": est, "exact": 50, "s": count_s})

    # ---- 2. the same operator permuted, no dims: WELL and kernel D
    coo = a.tocoo()
    perm = torch.randperm(g * g, device=dev, generator=pgen)
    ap = st.from_triples((g * g, g * g), perm[coo.row.long()],
                         perm[coo.col.long()], coo.data).tocsr()
    del coo, perm, a
    pipeline.clear_pipeline_cache()
    pp = FeastParams(tol=1e-10, backend="multifrontal")
    res = solve(f"lowest 50 of {g}^2 permuted", ap, (0.0, emax), lam[:50],
                pp, warm=0, launches_of=well_spmm)
    require(rows[-1]["routes"][0] == "well" and rows[-1]["launches"] >= 1,
            f"permuted run: routes {rows[-1]['routes']}, well_spmm "
            f"launches {rows[-1]['launches']}")
    if keep is not None:
        keep.setdefault("feast", {})["permuted"] = (
            np.sort(np.asarray(res.values)), res.iterations, ap.to("cpu"))
    del ap, res
    pipeline.clear_pipeline_cache()

    # ---- 3b. eigsh_sliced over about 100 pairs of 64**2
    gs = grids[2]
    lam_s = spectrum_2d(gs)
    emax_s = float((lam_s[99] + lam_s[100]) / 2)
    a_s = poisson_2d(gs, dtype=f64, device=dev)
    res, sliced_s = timed(lambda: eigsh_sliced(
        (0.0, emax_s), a_s, m0_max=64,
        params=FeastParams(tol=1e-10, dims=(gs, gs), backend="multifrontal")))
    err, err_rel = feast_errors(res, lam_s[:100], (0.0, emax_s))
    print(f"phase 8 [{card}] eigsh_sliced 100 lowest of {gs}^2, m0_max=64: "
          f"{res.n_found} pairs in {sliced_s:.3f} s, {res.iterations} loops "
          f"over the slices, worst residual {res.epsout:.3e}, against the "
          f"analytic spectrum {err:.3e} (tol 1e-10), elementwise {err_rel:.3e}",
          flush=True)
    require(err <= 1e-10, f"eigsh_sliced error {err}")
    rows.append({"name": f"eigsh_sliced 100 lowest of {gs}^2",
                 "n_found": res.n_found, "s": sliced_s,
                 "loops": res.iterations, "epsout": res.epsout,
                 "max_err_scaled": err, "max_rel_err": err_rel})
    del a_s, res
    pipeline.clear_pipeline_cache()
    torch.cuda.empty_cache()

    # ---- 4. 1,048,576 dof: the 50 lowest (bench.py:792-858), then the
    # interior window on the warm pipeline (bench.py:861-922)
    gb = grids[1]
    lam_b = spectrum_2d(gb)
    a_b = poisson_2d(gb, dtype=f64, device=dev)
    pb = FeastParams(tol=1e-10, dims=(gb, gb), backend="multifrontal")
    torch.cuda.reset_peak_memory_stats(dev)
    emax_b = float((lam_b[49] + lam_b[50]) / 2)
    res = solve(f"lowest 50 of {gb}^2", a_b, (0.0, emax_b), lam_b[:50], pb,
                warm=1)
    if keep is not None:
        keep.setdefault("feast", {})[gb] = (np.sort(np.asarray(res.values)),
                                            res.iterations)
        keep["subspace"] = {"grid": gb, "subspace": res.subspace.cpu(),
                            "interval": (0.0, emax_b), "params": pb,
                            "cold_loops": len(rows[-1]["split"])}
    del res
    lo = float((lam_b[99] + lam_b[100]) / 2)
    hi = float((lam_b[149] + lam_b[150]) / 2)
    solve(f"interior [lambda_100, lambda_150) of {gb}^2", a_b, (lo, hi),
          lam_b[100:150], pb, warm=0)
    peak = max(r.get("peak_gb", 0.0) for r in rows)
    launches = dia_spmm_kernel.launches
    print(f"phase 8 FEAST: {time.perf_counter() - t_phase:.3f} s wall, "
          f"dia_spmm launches {launches}, peak device memory {peak:.3f} GB "
          f"(tol 75)", flush=True)
    require(peak < 75.0, f"phase 8 peak device memory {peak} GB")
    require(launches >= 1, "the FEAST path launched no dia_spmm")
    del a_b
    pipeline.clear_pipeline_cache()
    torch.cuda.empty_cache()
    return rows


def chebyshev_phase(dev, card: str, seed: int, parity_abs: dict,
                    grids=(256, 1024),
                    windows=((20, 40), (50, 64))) -> tuple:
    """Phase 10: the Chebyshev-filtered eigensolver
    (``eig.chebyshev.eigsh_filtered``, f64) at full size.  ``grids`` are
    the 65,536-dof operator's and the 1,048,576-dof one's, ``windows`` the
    (pairs, m0) of each.  (a) the lowest window of the stencil-order
    operator (kernel A's multi-RHS form), (b) the same operator relabelled
    by a seeded permutation (kernel D), each cold and warm; (c) the lowest
    window at 1M dof, recorded as it comes (the JAX module documents a
    stall near 1e-3 there on its TPU), held to an honest result.  After
    each run the route's kernel is held against its plain version at the
    run's widths (max abs errors into ``parity_abs``).  Returns (rows of
    the ``chebyshev`` JSON line, {wrapper name: launches}); any failed
    check raises."""
    import numpy as np
    import torch

    import sparse_linear_tpu_torch as st
    from sparse_linear_tpu_torch.eig import chebyshev
    from sparse_linear_tpu_torch.eig.feast import INFO_NOT_CONVERGED, INFO_OK
    from sparse_linear_tpu_torch.formats.structured import csr_to_dia
    from sparse_linear_tpu_torch.kernels.spmv import dia_spmm
    from sparse_linear_tpu_torch.kernels.spmv_dia import dia_spmm_kernel
    from sparse_linear_tpu_torch.kernels.spmv_well import (
        well_spmm,
        well_spmm_planes_plain,
    )
    from sparse_linear_tpu_torch.ops.build import trim
    from sparse_linear_tpu_torch.utils.grids import poisson_2d

    f64 = torch.float64
    cgen = torch.Generator(device=dev).manual_seed(seed + 6)
    # the parity blocks draw from their own stream: the runs see the
    # permutation and start blocks they saw without them
    xgen = torch.Generator(device=dev).manual_seed(seed + 9)
    rows = []
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    dia_spmm_kernel.launches = 0
    well_spmm.launches = 0

    def residuals(a, res):
        """Each pair's ||A x - lambda x|| / ||x|| through the plain CSR
        product (``ops.linalg.spmm``), independent of the solver's."""
        x = res.vectors
        lam = torch.as_tensor(res.values, device=dev)
        r = torch.linalg.vector_norm(st.spmm(a, x) - x * lam[None, :], dim=0)
        return (r / torch.linalg.vector_norm(x, dim=0)).cpu().numpy()

    def kernel_parity(name, a, route, ms):
        """The route's kernel against its plain version on the operator
        the route builds (``eig.pipeline._structured_op``: trimmed, then
        DIA at up to 64 diagonals, else WELL), at widths ``ms`` of the
        column-major blocks the solver gives it.  The launches made here
        are taken back out of the wrapper's count.  Returns {m: max rel
        err}."""
        csr = trim(a.tocsr())
        if route == "dia":
            op, kern, plain = csr_to_dia(csr, max_diags=64), \
                dia_spmm_kernel, dia_spmm
        else:
            op, kern = st.csr_to_well(csr), well_spmm

            def plain(w, x):
                return well_spmm_planes_plain(w, x.T).T
        del csr
        saved = kern.launches
        out = {}
        for m in ms:
            x = torch.randn((a.shape[1], m), dtype=f64, device=dev,
                            generator=xgen)
            err, rel = max_err(kern(op, x), plain(op, x))
            out[m] = rel
            parity_abs[f"{kern.__name__} phase 10 {name} {f64} m={m}"] = err
            print(f"phase 10 parity {kern.__name__} {name} {f64} m={m}: "
                  f"max rel err {rel:.3e} (max abs {err:.3e}, tol 1e-12)",
                  flush=True)
            require(rel <= 1e-12, f"{kern.__name__} {name} m={m} disagrees "
                    f"with its plain version: {rel}")
            del x
        kern.launches = saved
        del op
        torch.cuda.empty_cache()
        return out

    def run(name, a, g, k, m0, wrapper, warm=True, converge=True):
        lam = spectrum_2d(g)
        interval = (0.0, float((lam[k - 1] + lam[k]) / 2))
        scale = max(abs(interval[0]), abs(interval[1]), 1.0)
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev) / 1e9
        before = wrapper.launches
        with no_csr_spmm():
            res, cold_s = timed(lambda: chebyshev.eigsh_filtered(
                m0, interval, a))
            split = dict(chebyshev.last_run)
            launched = wrapper.launches - before
            warm_s = None
            if warm:
                res = None
                res, warm_s = timed(lambda: chebyshev.eigsh_filtered(
                    m0, interval, a))
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        vals = np.asarray(res.values)
        finite = bool(np.isfinite(vals).all()
                      and np.isfinite(res.residuals).all()
                      and torch.isfinite(res.vectors).all())
        r_abs = residuals(a, res) if res.n_found else np.zeros(0)
        # distance of each returned value to the nearest analytic one
        i = np.clip(np.searchsorted(lam, vals), 1, lam.size - 1)
        near = np.minimum(np.abs(vals - lam[i - 1]), np.abs(vals - lam[i]))
        err = float(np.abs(np.sort(vals) - lam[:k]).max() / scale) \
            if res.n_found == k else math.inf
        filt = [p["filter_s"] for p in split["passes"]
                if p["kind"] == "filter"]
        row = {"name": name, "n": a.shape[0], "pairs": k, "m0": m0,
               "interval": list(interval), "route": split["route"],
               "lam_ub": split["lam_ub"], "degree": split["degree"],
               "passes": res.iterations, "info": res.info,
               "n_found": res.n_found, "epsout": res.epsout,
               "cold_s": cold_s, "warm_s": warm_s,
               "filter_pass_s": statistics.median(filt) if filt else None,
               "filter_passes": len(filt), "launches": launched,
               "max_err_scaled": err,
               "max_residual": float(r_abs.max()) if r_abs.size else None,
               "peak_gb": peak, "held_gb": held}
        rows.append(row)
        warm_txt = "" if warm_s is None else f", warm {warm_s:.3f} s"
        print(f"phase 10 [{card}] {name}: n {a.shape[0]}, route "
              f"{row['route']}, lam_ub {row['lam_ub']:.9f}, degree "
              f"{row['degree']}; {res.iterations} passes ({len(filt)} "
              f"filter, median {row['filter_pass_s'] or 0:.4f} s a filter "
              f"pass), info {res.info}, {res.n_found} of {k} pairs, epsout "
              f"{res.epsout:.3e}, against the analytic spectrum {err:.3e} "
              f"(tol 1e-10), residual through the CSR product "
              f"{row['max_residual'] or 0:.3e} (tol 1e-8); cold "
              f"{cold_s:.3f} s{warm_txt}; {wrapper.__name__} launches "
              f"{launched} (cold run); peak {peak:.3f} GB ({held:.3f} GB "
              f"of it held before the run)", flush=True)
        for i, p in enumerate(split["passes"]):
            print(f"phase 10 [{card}] {name} cold pass {i}: {p['kind']}, "
                  f"{p['s']:.4f} s (filter {p['filter_s']:.4f} s), "
                  f"{p['m_found']} pairs inside, epsout {p['epsout']:.3e}",
                  flush=True)
        require(finite, f"{name}: non-finite result")
        # a filter pass is ``degree`` products; the bound, Rayleigh-Ritz
        # and the [X | R] passes add theirs
        require(launched >= row["degree"] * row["filter_passes"] >= 1,
                f"{name}: {wrapper.__name__} launched {launched} times, "
                f"{row['filter_passes']} filter passes of degree "
                f"{row['degree']}")
        require(res.vectors.device.type == "cuda", f"{name}: vectors")
        if not converge:
            # a run recorded as it comes is held to an honest report
            require(res.info in (INFO_OK, INFO_NOT_CONVERGED),
                    f"{name}: info {res.info}")
            # the two residuals round apart by up to a few eps ||A|| m0
            # (A X rotated by the Ritz vectors, against A x): a pair at
            # that floor is compared with the floor, any other within 1e-3
            floor = 64 * np.finfo(float).eps * row["lam_ub"]
            rel = np.abs(np.asarray(res.residuals) * scale - r_abs) \
                / np.maximum(r_abs, floor / 1e-3)
            row["reported_vs_recomputed"] = float(rel.max()) if rel.size \
                else 0.0
            # a unit x with ||A x - lambda x|| = r has an eigenvalue within
            # r of lambda (A symmetric); 8 eps ||A|| covers the rounding of
            # the analytic values
            slack = 8 * np.finfo(float).eps * row["lam_ub"]
            row["eigenvalue_within_residual"] = bool(
                np.all(near <= r_abs + slack))
            print(f"phase 10 [{card}] {name}: reported residuals against "
                  f"the recomputed ones {row['reported_vs_recomputed']:.3e} "
                  f"(tol 1e-3 relative above {floor:.1e}); every value "
                  f"within its residual "
                  f"of an analytic eigenvalue: "
                  f"{row['eigenvalue_within_residual']}", flush=True)
            require(row["reported_vs_recomputed"] <= 1e-3,
                    f"{name}: reported residuals disagree")
            require(row["eigenvalue_within_residual"],
                    f"{name}: a value is farther than its residual from "
                    "the spectrum")
        if converge or res.info == INFO_OK:
            require(res.info == INFO_OK and res.n_found == k,
                    f"{name}: info {res.info}, {res.n_found} pairs")
            require(err <= 1e-10, f"{name}: eigenvalue error {err}")
            require(float(r_abs.max()) <= 1e-8,
                    f"{name}: residual {r_abs.max()}")
        row["kernel_parity"] = kernel_parity(name, a, row["route"],
                                             (1, m0, 2 * m0))
        return row

    # ---- (a) 65,536 dof, stencil order: DIA, kernel A's multi-RHS form
    g = grids[0]
    k, m0 = windows[0]
    a = poisson_2d(g, dtype=f64, device=dev)
    row = run(f"lowest {k} of {g}^2", a, g, k, m0, dia_spmm_kernel)
    require(row["route"] == "dia", f"route {row['route']}")
    # ---- (b) the same operator relabelled: WELL, kernel D
    ap, _ = permuted(a, cgen)
    row = run(f"lowest {k} of {g}^2 permuted", ap, g, k, m0, well_spmm)
    require(row["route"] == "well", f"route {row['route']}")
    del a, ap
    torch.cuda.empty_cache()
    # ---- (c) 1,048,576 dof, default degree and passes: a record
    gb = grids[1]
    k, m0 = windows[1]
    a = poisson_2d(gb, dtype=f64, device=dev)
    run(f"lowest {k} of {gb}^2", a, gb, k, m0, dia_spmm_kernel, warm=False,
        converge=False)
    del a
    torch.cuda.empty_cache()
    launches = {"dia_spmm": dia_spmm_kernel.launches,
                "well_spmm": well_spmm.launches}
    peak = max(r["peak_gb"] for r in rows)
    print(f"phase 10 Chebyshev: {time.perf_counter() - t_phase:.3f} s wall, "
          f"launches {launches}, peak device memory {peak:.3f} GB (tol 75)",
          flush=True)
    require(peak < 75.0, f"phase 10 peak device memory {peak} GB")
    return rows, launches


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms while the block runs (the
    multifrontal solve's ``index_add_`` sums in a fixed order then), the
    previous setting restored after."""
    import torch

    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def device_us(e) -> float:
    """Device microseconds of a ``key_averages()`` row."""
    return e.self_device_time_total


def checkpoint_phase(dev, card: str, seed: int, kept: dict, well_csr,
                     cheb_rows: list, dense_grid: int = 64) -> list:
    """Phase 11: checkpoints (``utils.serialize``) and profiling
    (``utils.profiling``) at full size, every file in a temporary
    directory removed at the end.  ``kept`` holds phase 7's f32 Cholesky
    factors and phase 8's subspace on the host; ``well_csr()`` rebuilds
    phase 6's permuted operator from its random state; ``cheb_rows`` are
    phase 10's rows: one filter pass of the first is traced and checked,
    one of the last is traced for its device time by kernel.  Returns the
    rows of the ``checkpoints`` JSON line; any failed check raises."""
    import glob
    import shutil
    import tempfile

    import torch

    import sparse_linear_tpu_torch as st
    from sparse_linear_tpu_torch.eig import chebyshev
    from sparse_linear_tpu_torch.eig.feast import INFO_OK, eigsh
    from sparse_linear_tpu_torch.eig.pipeline import (
        _structured_op,
        clear_pipeline_cache,
    )
    from sparse_linear_tpu_torch.kernels.spmv_well import well_spmv
    from sparse_linear_tpu_torch.solve import api
    from sparse_linear_tpu_torch.solve import multifrontal as mf
    from sparse_linear_tpu_torch.utils import profiling, serialize
    from sparse_linear_tpu_torch.utils.grids import poisson_2d

    f32, f64 = torch.float32, torch.float64
    kgen = torch.Generator(device=dev).manual_seed(seed + 7)
    rows = []
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    analyze_s = []
    kept_analyze = mf.analyze

    def timed_analyze(*args, **kwargs):
        out, s = timed(lambda: kept_analyze(*args, **kwargs))
        analyze_s.append(s)
        return out

    def record(name, path, save_s, load_s, **more):
        row = {"name": name, "bytes": os.path.getsize(path),
               "save_s": save_s, "load_s": load_s, **more}
        rows.append(row)
        extra = ", ".join(f"{k} {v:.3f}" if isinstance(v, float)
                          else f"{k} {v}" for k, v in more.items())
        print(f"phase 11 [{card}] {name}: {row['bytes']} bytes, save "
              f"{save_s:.3f} s, load {load_s:.3f} s; {extra}", flush=True)

    try:
        # ---- factors: phase 7's f32 Cholesky of the 2D operator
        chol = kept.pop("cholesky")
        g = chol["grid"]
        f = chol["factors"].to(dev)
        del chol
        a = poisson_2d(g, dtype=f32, device=dev)
        b = torch.randn(g * g, dtype=f32, device=dev, generator=kgen)
        path = os.path.join(tmp, "cholesky.npz")
        _, save_s = timed(lambda: serialize.save_factors(path, f))
        mf.analyze = timed_analyze
        try:
            loaded, load_s = timed(lambda: serialize.load_factors(path,
                                                                  mat=a))
        finally:
            mf.analyze = kept_analyze
        same_blocks = all(torch.equal(loaded.blocks[i][name], t)
                          for i, blk in f.blocks.items()
                          for name, t in blk.items())
        plain_same = torch.equal(api.solve(f, b), api.solve(f, b))
        with deterministic():
            same = torch.equal(api.solve(loaded, b), api.solve(f, b))
        record(f"multifrontal cholesky f32 {g}^2", path, save_s, load_s,
               analyze_s=analyze_s[-1], blocks_bitwise=same_blocks,
               solve_bitwise=same, repeat_bitwise_default=plain_same)
        require(loaded.symbolic.schedule["height"]
                == f.symbolic.schedule["height"], "re-derived schedule")
        require(same_blocks, "loaded factor blocks differ")
        require(same, "solve on the loaded factors is not bitwise the "
                "solve on the saved ones")
        del f, loaded, a, b
        torch.cuda.empty_cache()

        # ---- factors: the dense backend at n = dense_grid**2, f64
        a = poisson_2d(dense_grid, dtype=f64, device=dev)
        n = a.shape[0]
        f = api.factor(a)
        b = torch.randn(n, dtype=f64, device=dev, generator=kgen)
        path = os.path.join(tmp, "dense.npz")
        _, save_s = timed(lambda: serialize.save_factors(path, f))
        loaded, load_s = timed(lambda: serialize.load_factors(path))
        same = torch.equal(api.solve(loaded, b), api.solve(f, b))
        record(f"dense lu f64 n={n}", path, save_s, load_s,
               solve_bitwise=same,
               pivots_equal=torch.equal(loaded.payload[1], f.payload[1]))
        require(loaded.payload[0].device.type == "cuda", "dense on the card")
        require(same, "dense solve on the loaded factors differs")
        del f, loaded, a, b

        # ---- WELL: phase 6's permuted 2048**2 f64 operator
        csr = well_csr()
        w, pack_s = timed(lambda: st.csr_to_well(csr))
        x = torch.randn(csr.shape[1], dtype=f64, device=dev, generator=kgen)
        path = os.path.join(tmp, "well.npz")
        _, save_s = timed(lambda: serialize.save_well(path, w))
        loaded, load_s = timed(lambda: serialize.load_well(path))
        same_fields = all(torch.equal(getattr(loaded, name), getattr(w, name))
                          for name in ("slice_ptr", "cols", "vals"))
        same = torch.equal(well_spmv(loaded, x), well_spmv(w, x))
        record(f"well f64 permuted {int(math.isqrt(csr.shape[0]))}^2", path,
               save_s, load_s, csr_to_well_s=pack_s, nnz=csr.nnz,
               fields_bitwise=same_fields, spmv_bitwise=same)
        require(same_fields and same, "loaded WELL differs")
        del csr, w, x, loaded
        torch.cuda.empty_cache()

        # ---- subspace: phase 8's lowest-50 window, as a warm start
        sub = kept.pop("subspace")
        gs = sub["grid"]
        a = poisson_2d(gs, dtype=f64, device=dev)
        path = os.path.join(tmp, "subspace.npz")
        _, save_s = timed(lambda: serialize.save_subspace(path,
                                                          sub["subspace"]))
        loaded, load_s = timed(lambda: serialize.load_subspace(path))
        same = torch.equal(loaded.cpu(), sub["subspace"])
        clear_pipeline_cache()
        res, warm_s = timed(lambda: eigsh(80, sub["interval"], a,
                                          sub["params"], guess=loaded))
        record(f"subspace lowest 50 of {gs}^2", path, save_s, load_s,
               bitwise=same, info=res.info, loops=res.iterations,
               cold_loops=sub["cold_loops"], eigsh_guess_s=warm_s)
        require(loaded.device.type == "cuda" and same, "loaded subspace")
        require(res.info == INFO_OK
                and res.iterations <= sub["cold_loops"],
                f"warm start: info {res.info}, {res.iterations} loops "
                f"against {sub['cold_loops']} cold")
        del a, loaded, res, sub
        clear_pipeline_cache()
        torch.cuda.empty_cache()

        # ---- profiling: one filter pass of phase 10 (a) under the trace,
        # then one of phase 10 (c) for where its time goes
        def filter_pass(row):
            """One filter pass of a phase-10 row's case: (the filter, its
            arguments), its operator rebuilt."""
            g = int(math.isqrt(row["n"]))
            a = poisson_2d(g, dtype=f64, device=dev)
            lam_ub, (emin, emax) = row["lam_ub"], row["interval"]
            filt = chebyshev._make_filter(_structured_op(a), None,
                                          row["degree"])
            y = torch.randn((a.shape[0], row["m0"]), dtype=f64, device=dev,
                            generator=kgen)
            return filt, (y, 0.5 * (lam_ub + emax), 0.5 * (lam_ub - emax),
                          emin)

        def traced(filt, args, trace_dir):
            """(profile, wall) of one pass under the trace, the file."""
            def run():
                with profiling.trace(trace_dir) as prof:
                    with profiling.annotate("chebyshev:filter"):
                        filt(*args)
                    torch.cuda.synchronize()
                return prof
            prof, wall_s = timed(run)
            files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
            require(len(files) == 1, f"trace files {files}")
            return prof, wall_s, files[0]

        row_a = cheb_rows[0]
        filt, args = filter_pass(row_a)
        filt(*args)  # warm-up
        _, plain_s = timed(lambda: filt(*args))
        prof, traced_s, path = traced(filt, args, os.path.join(tmp, "t1"))
        with open(path) as fh:
            text = fh.read()
        named = {"span": '"chebyshev:filter"' in text,
                 "kernel": "dia_spmm_kernel" in text}
        device_ms = sum(device_us(e) for e in prof.key_averages()
                        if "dia_spmm_kernel" in e.key) / 1e3
        first_s, steady_s = profiling.op_timings(filt, *args, iters=3)
        g = int(math.isqrt(row_a["n"]))
        row = {"name": f"profiling: one filter pass of {g}^2, degree "
                       f"{row_a['degree']}, m0 {row_a['m0']}",
               "bytes": os.path.getsize(path), "plain_s": plain_s,
               "traced_s": traced_s, "names": named,
               "dia_spmm_device_ms": device_ms, "op_timings_first_s": first_s,
               "op_timings_steady_s": steady_s}
        rows.append(row)
        print(f"phase 11 [{card}] {row['name']}: wall {plain_s:.4f} s, "
              f"under the profiler {traced_s:.4f} s; trace "
              f"{row['bytes']} bytes names the span {named['span']} and "
              f"dia_spmm_kernel {named['kernel']}; dia_spmm_kernel device "
              f"time {device_ms:.3f} ms; op_timings first {first_s:.4f} s, "
              f"steady {steady_s:.4f} s", flush=True)
        require(named["span"] and named["kernel"],
                f"the trace does not name {named}")
        del filt, args, prof

        row_c = cheb_rows[-1]
        filt, args = filter_pass(row_c)
        _, plain_s = timed(lambda: filt(*args))
        prof, traced_s, _ = traced(filt, args, os.path.join(tmp, "t2"))
        # the span itself shows as a device range too: kernels only
        kernels = sorted(((device_us(e) / 1e3, e.count, e.key)
                          for e in prof.key_averages()
                          if str(getattr(e, "device_type", "")).endswith(
                              "CUDA") and e.key != "chebyshev:filter"),
                         reverse=True)
        busy_ms = sum(k[0] for k in kernels)
        g = int(math.isqrt(row_c["n"]))
        row = {"name": f"profiling: one filter pass of {g}^2, degree "
                       f"{row_c['degree']}, m0 {row_c['m0']}",
               "plain_s": plain_s, "traced_s": traced_s,
               "device_busy_ms": busy_ms,
               "kernels": [{"ms": ms, "count": c, "name": k[:120]}
                           for ms, c, k in kernels[:6]]}
        rows.append(row)
        print(f"phase 11 [{card}] {row['name']}: wall {plain_s:.4f} s, "
              f"under the profiler {traced_s:.4f} s; kernels "
              f"{busy_ms:.1f} ms ({busy_ms / 1e3 / plain_s:.1%} of the "
              f"wall without the profiler)", flush=True)
        for ms, c, k in kernels[:6]:
            print(f"phase 11 [{card}]   {ms:9.3f} ms in {c:5d} launches: "
                  f"{k[:120]}", flush=True)
        del filt, args, prof
        torch.cuda.empty_cache()
    finally:
        mf.analyze = kept_analyze
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 11 checkpoints and profiling: "
          f"{time.perf_counter() - t_phase:.3f} s wall", flush=True)
    return rows


def multidevice_phase(dev, card: str, seed: int, refs: dict,
                      parity_abs: dict, grids=(2048, 1024, 192),
                      n_shards: int = 4) -> dict:
    """Phase 12: the multi-device paths (``dist/``) at full width on a
    ``card_mesh(n_shards)``.  ``refs`` holds what the earlier phases left:
    ``b4`` and ``b6`` (phases 4 and 6's right-hand sides, on the host),
    ``cg_its``/``cg_ms`` and ``well_its``/``well_ms`` (their CG iterations
    and ms an iteration), ``well_csr`` (rebuilds phase 6's operator),
    ``cholesky`` (phase 7's f32 Cholesky factors on the host) and
    ``factor_s`` (their second factor's wall), ``feast`` (phase 8's
    eigenvalues and loops by window).  ``grids``: the SpMV / CG grid, the
    ELL / BSR grid and the small FEAST grid; the 1M-dof FEAST runs on
    phase 7's grid.  Every sharded product of kernels A and C is held
    against the plain version on the same x (max abs errors into
    ``parity_abs``) and against the unsharded kernel.  Returns the readings
    of the ``multidevice`` JSON line and the launch counts; any failed
    check raises."""
    import numpy as np
    import torch

    import sparse_linear_tpu_torch as st
    from sparse_linear_tpu_torch.dist import ShardedVector, card_mesh
    from sparse_linear_tpu_torch.dist import spmv as ds
    from sparse_linear_tpu_torch.eig import pipeline
    from sparse_linear_tpu_torch.eig.feast import INFO_OK, FeastParams, eigsh
    from sparse_linear_tpu_torch.entry import dryrun_multichip
    from sparse_linear_tpu_torch.formats.structured import (
        csr_to_bsr,
        csr_to_ell,
    )
    from sparse_linear_tpu_torch.kernels.spmv import (
        bsr_spmv,
        dia_spmv,
        ell_spmv,
    )
    from sparse_linear_tpu_torch.kernels.spmv_dia import (
        dia_spmm_kernel,
        dia_spmv_kernel,
    )
    from sparse_linear_tpu_torch.kernels.spmv_well import (
        well_spmv,
        well_spmv_plain,
    )
    from sparse_linear_tpu_torch.solve import api
    from sparse_linear_tpu_torch.solve import multifrontal as mf
    from sparse_linear_tpu_torch.solve.cg import cg
    from sparse_linear_tpu_torch.utils.grids import poisson_2d

    f32, f64 = torch.float32, torch.float64
    tol = {f32: 1e-5, f64: 1e-12}
    # its own stream: the earlier phases keep their draws
    mgen = torch.Generator(device=dev).manual_seed(seed + 6)
    t_phase = time.perf_counter()
    mesh = card_mesh(n_shards, ("rows",))
    print(f"phase 12 mesh: {mesh.layout()}", flush=True)
    require(all(d.type == "cuda" for d in mesh.devices.flat),
            f"mesh {mesh.layout()}")
    out = {"layout": mesh.layout(), "shards": n_shards}
    kernels = (dia_spmv_kernel, dia_spmm_kernel, well_spmv)
    for k in kernels:
        k.launches = 0

    @contextlib.contextmanager
    def uncounted():
        """Launches made here to hold or time a kernel against its
        reference are taken back out of the counts."""
        saved = [k.launches for k in kernels]
        try:
            yield
        finally:
            for k, s in zip(kernels, saved):
                k.launches = s

    flush_buf = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    cards = sorted({d.index for d in mesh.devices.flat})
    out["timing"] = ("CUDA events" if len(cards) == 1 else
                     "host clock, every card synchronised")

    def samples_ms(f, reps=12):
        """ms of each call: CUDA events on one card; on several, the host
        clock between synchronisations of every card (events on one card
        would not wait for the others' launches)."""
        for _ in range(3):
            f()
        if len(cards) > 1:
            out = []
            for _ in range(reps):
                flush_buf.zero_()
                for c in cards:
                    torch.cuda.synchronize(c)
                t0 = time.perf_counter()
                f()
                for c in cards:
                    torch.cuda.synchronize(c)
                out.append((time.perf_counter() - t0) * 1e3)
            return out
        events = []
        for _ in range(reps):
            flush_buf.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            f()
            e.record()
            events.append((s, e))
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in events]

    def in_turns(first, second):
        """first, second, second, first: the median of each over its 24
        calls (CUDA events, L2 flushed before each)."""
        a = samples_ms(first)
        b = samples_ms(second) + samples_ms(second)
        a += samples_ms(first)
        return statistics.median(a), statistics.median(b)

    def rnd(n, dtype):
        return torch.randn(n, dtype=dtype, device=dev, generator=mgen)

    # ---- (a) sharded kernel A, halo and all-gather, against the plain
    # product and the unsharded kernel A on the same x
    g = grids[0]
    n = g * g
    out["spmv"] = []
    for dtype in (f32, f64):
        a = poisson_2d(g, dtype=dtype, fmt="dia", device=dev)
        sh, shard_s = timed(lambda: ds.shard_dia_rows(a, mesh))
        x = rnd(n, dtype)
        xs = ShardedVector.from_tensor(x, mesh)
        for ex in ("halo", "allgather"):
            y = ds.dia_spmv_sharded(sh, xs, mesh, exchange=ex)
            plain_abs, plain_rel = max_err(y.full(), dia_spmv(a, x))
            parity_abs[f"phase 12 dia_spmv_sharded {ex} {dtype}"] = plain_abs
            with uncounted():
                ref = dia_spmv_kernel(a, x)
                bitwise = torch.equal(y.full(), ref)
                _, rel = max_err(y.full(), ref)
                one_ms, ms = in_turns(
                    lambda: dia_spmv_kernel(a, x),
                    lambda: ds.dia_spmv_sharded(sh, xs, mesh, exchange=ex))
            recv = 2 * sh.halo if ex == "halo" else (n_shards - 1) * (
                n // n_shards)
            row = {"name": f"dia_spmv_sharded {ex} poisson_2d({g})",
                   "dtype": str(dtype), "ms": ms, "unsharded_ms": one_ms,
                   "received_per_shard": recv, "bitwise": bitwise,
                   "max_rel_err": rel, "plain_max_abs_err": plain_abs,
                   "plain_max_rel_err": plain_rel, "shard_s": shard_s}
            out["spmv"].append(row)
            print(f"phase 12 [{card}] {row['name']} {dtype}: {ms:.4f} ms "
                  f"against unsharded kernel A {one_ms:.4f} ms (median of "
                  f"24, L2 flushed, {out['timing']}); a shard receives "
                  f"{recv} elements of x; "
                  f"against the plain product max rel err {plain_rel:.3e} "
                  f"(max abs {plain_abs:.3e}), against kernel A bitwise "
                  f"{str(bitwise).lower()}, max rel err {rel:.3e} "
                  f"(tol {tol[dtype]:.0e})", flush=True)
            require(plain_rel <= tol[dtype],
                    f"sharded kernel A {ex} {dtype} against plain: "
                    f"{plain_rel}")
            require(rel <= tol[dtype], f"sharded kernel A {ex} {dtype}: {rel}")
            require(all(p.device.type == "cuda" for p in y.pieces),
                    "sharded y on the card")
        del a, sh, x, xs, y, ref

    # ---- (b) sharded CG in f64 on phase 4's right-hand side
    a = poisson_2d(g, dtype=f64, fmt="dia", device=dev)
    csr = poisson_2d(g, dtype=f64, device=dev)
    sh = ds.shard_dia_rows(a, mesh)
    b = ShardedVector.from_tensor(refs["b4"].to(dev), mesh)
    res, cg_s = timed(lambda: cg(
        lambda v: ds.dia_spmv_sharded(sh, v, mesh), b, tol=1e-10,
        maxiter=40_000))
    bf = b.full()
    true_res = float(torch.linalg.vector_norm(bf - st.spmv(csr, res.x.full()))
                     / torch.linalg.vector_norm(bf))
    cg_ms = cg_s / max(res.iterations, 1) * 1e3
    out["cg"] = {"iterations": res.iterations, "phase4_iterations":
                 refs["cg_its"], "s": cg_s, "ms_per_iteration": cg_ms,
                 "phase4_ms_per_iteration": refs["cg_ms"],
                 "true_residual": true_res}
    print(f"phase 12 [{card}] sharded cg f64 {g}^2 (halo, psum'd dots): "
          f"{res.iterations} iterations (phase 4: {refs['cg_its']}), true "
          f"residual (CSR spmv) {true_res:.3e} (tol 1e-9), {cg_s:.3f} s, "
          f"{cg_ms:.4f} ms/iteration (phase 4: {refs['cg_ms']:.4f})",
          flush=True)
    require(res.converged and true_res <= 1e-9,
            f"sharded cg: converged {res.converged}, residual {true_res}")
    require(all(p.device.type == "cuda" for p in res.x.pieces),
            "sharded cg x on the card")
    del a, sh, b, bf, res

    # ---- (c) sharded kernel C: the stencil order (a window plan) and
    # phase 6's permuted operator (all-gather), then WELL CG on the latter
    out["well"] = []
    L = n // n_shards
    permuted = refs["well_csr"]()
    for name, mat, want_plan in (("stencil order", csr, True),
                                 ("permuted (phase 6)", permuted, False)):
        sw, shard_s = timed(lambda: ds.shard_well_rows(mat, mesh))
        require((sw.xplan is not None) == want_plan,
                f"{name}: xplan {sw.xplan}")
        shipped = (ds.window_exchange_elements(sw.xplan) if want_plan
                   else (n_shards - 1) * L)
        x = rnd(n, f64)
        xs = ShardedVector.from_tensor(x, mesh)
        y = ds.spmv_sharded(sw, xs, mesh)
        w = st.csr_to_well(mat)
        plain_abs, plain_rel = max_err(y.full(), well_spmv_plain(w, x))
        parity_abs[f"phase 12 sharded well_spmv {name} {f64}"] = plain_abs
        with uncounted():
            ref = well_spmv(w, x)
            _, rel = max_err(y.full(), ref)
            one_ms, ms = in_turns(lambda: well_spmv(w, x),
                                  lambda: ds.spmv_sharded(sw, xs, mesh))
        row = {"name": f"sharded well_spmv {name} {g}^2 f64", "ms": ms,
               "unsharded_ms": one_ms, "xplan": sw.xplan,
               "shipped_per_shard": shipped,
               "allgather_per_shard": (n_shards - 1) * L,
               "max_rel_err": rel, "plain_max_abs_err": plain_abs,
               "plain_max_rel_err": plain_rel, "shard_s": shard_s,
               "c_max": sw.c_max}
        out["well"].append(row)
        print(f"phase 12 [{card}] {row['name']}: {ms:.4f} ms against "
              f"unsharded kernel C {one_ms:.4f} ms; plan {sw.xplan}, "
              f"shipped {shipped} elements a shard (all-gather "
              f"{(n_shards - 1) * L}); max rel err against the plain "
              f"product {plain_rel:.3e} (max abs {plain_abs:.3e}), against "
              f"kernel C {rel:.3e} (tol 1e-12); packed in {shard_s:.3f} s",
              flush=True)
        require(plain_rel <= 1e-12,
                f"sharded kernel C {name} against plain: {plain_rel}")
        require(rel <= 1e-12, f"sharded kernel C {name}: {rel}")
        del w, ref, x, xs, y
    b = ShardedVector.from_tensor(refs["b6"].to(dev), mesh)
    res, cg_s = timed(lambda: cg(lambda v: ds.spmv_sharded(sw, v, mesh), b,
                                 tol=1e-10, maxiter=40_000))
    bf = b.full()
    true_res = float(torch.linalg.vector_norm(
        bf - st.spmv(permuted, res.x.full())) / torch.linalg.vector_norm(bf))
    cg_ms = cg_s / max(res.iterations, 1) * 1e3
    out["well_cg"] = {"iterations": res.iterations, "phase6_iterations":
                      refs["well_its"], "s": cg_s, "ms_per_iteration": cg_ms,
                      "phase6_ms_per_iteration": refs["well_ms"],
                      "true_residual": true_res}
    print(f"phase 12 [{card}] sharded WELL cg f64 permuted {g}^2 "
          f"(all-gather): {res.iterations} iterations (phase 6: "
          f"{refs['well_its']}), true residual {true_res:.3e} (tol 1e-9), "
          f"{cg_s:.3f} s, {cg_ms:.4f} ms/iteration (phase 6: "
          f"{refs['well_ms']:.4f})", flush=True)
    require(res.converged and true_res <= 1e-9,
            f"sharded WELL cg: converged {res.converged}, residual {true_res}")
    del sw, b, bf, res, csr, permuted
    torch.cuda.empty_cache()

    # ---- (d) ELL and BSR shards (plain PyTorch products)
    g1 = grids[1]
    c1 = poisson_2d(g1, dtype=f64, device=dev)
    x1 = rnd(g1 * g1, f64)
    out["ell_bsr"] = []
    for name, shard, plain in (
            ("ell", lambda: ds.shard_ell_rows(c1, mesh),
             lambda: ell_spmv(csr_to_ell(c1), x1)),
            ("bsr", lambda: ds.shard_bsr_rows(c1, mesh),
             lambda: bsr_spmv(csr_to_bsr(c1, (8, 128)), x1))):
        s, shard_s = timed(shard)
        _, rel = max_err(ds.spmv_sharded(s, x1, mesh).full(), plain())
        out["ell_bsr"].append({"name": name, "xplan": s.xplan,
                               "max_rel_err": rel, "shard_s": shard_s})
        print(f"phase 12 [{card}] sharded {name} poisson_2d({g1}) f64: plan "
              f"{s.xplan}, max rel err against the unsharded {name} "
              f"{rel:.3e} (tol 1e-12), packed on the host in {shard_s:.3f} s",
              flush=True)
        require(rel <= 1e-12, f"sharded {name}: {rel}")
        del s
    del c1, x1

    # ---- (e) the front-sharded direct solver: phase 7's 1024**2 Cholesky
    chol = refs["cholesky"]
    g7, host = chol["grid"], chol["factors"]
    sym = host.symbolic
    fmesh = card_mesh(n_shards, ("fronts",))
    a32 = poisson_2d(g7, dtype=f32, device=dev)
    a64 = poisson_2d(g7, dtype=f64, device=dev)
    opts = dict(backend="multifrontal", kind="cholesky")
    parts = sum(p is not None for p in mf._mesh_parts(
        sym, mf._device_maps(sym, dev), fmesh.shards("fronts")).values())
    timed(lambda: api.factor(a32, sym, mesh=fmesh, batch_axis="fronts",
                             **opts))
    fs, fs_s = timed(lambda: api.factor(a32, sym, mesh=fmesh,
                                        batch_axis="fronts", **opts))
    timed(lambda: api.factor(a32, sym, **opts))
    f1, f1_s = timed(lambda: api.factor(a32, sym, **opts))
    del f1
    block_rel = max(
        max_err(fs.blocks[k][name].cpu(), t)[1]
        for k, blk in host.blocks.items() if k >= 0
        for name, t in blk.items() if name != "perm")
    b64 = rnd(g7 * g7, f64)
    (x, info), _ = timed(lambda: api.solve_refined(fs, a64, b64, tol=1e-10,
                                                    max_iter=4))
    res32 = float(torch.linalg.vector_norm(st.spmv(a64, x) - b64)
                  / torch.linalg.vector_norm(b64))
    f64s, f64_s = timed(lambda: api.factor(a64, sym, mesh=fmesh,
                                           batch_axis="fronts", **opts))
    x = api.solve(f64s, b64)
    res64 = float(torch.linalg.vector_norm(st.spmv(a64, x) - b64)
                  / torch.linalg.vector_norm(b64))
    nbuckets = len(sym.schedule["flat"])
    out["multifrontal"] = {
        "grid": g7, "split_buckets": parts, "buckets": nbuckets,
        "factor_f32_s": fs_s, "unsharded_factor_f32_s": f1_s,
        "phase7_factor_f32_s": refs["factor_s"], "blocks_max_rel": block_rel,
        "refined_residual": res32, "refine_steps": info.refinement_steps,
        "factor_f64_s": f64_s, "f64_residual": res64}
    print(f"phase 12 [{card}] front-sharded cholesky {g7}^2 over "
          f"{fmesh.layout()}: {parts} of {nbuckets} buckets split; f32 "
          f"factor {fs_s:.3f} s (second call) against unsharded {f1_s:.3f} s "
          f"(phase 7: {refs['factor_s']:.3f} s); blocks within "
          f"{block_rel:.3e} of phase 7's (tol 1e-5); refined solve residual "
          f"{res32:.3e} in {info.refinement_steps} steps (tol 1e-10); f64 "
          f"factor {f64_s:.3f} s, direct residual {res64:.3e} (tol 1e-10)",
          flush=True)
    require(parts >= 1, "no bucket split over the shards")
    require(block_rel <= 1e-5, f"front-sharded blocks: {block_rel}")
    require(info.converged and res32 <= 1e-10, f"refined residual {res32}")
    require(res64 <= 1e-10 and not f64s.breakdown, f"f64 residual {res64}")
    del fs, f64s, x, a32, a64, b64, host, sym
    torch.cuda.empty_cache()

    # ---- (h) the row-sharded subspace: FEAST on a (cp, rows) mesh (each
    # window run right after (f)'s on the same operator, so the pipeline's
    # host analyze is not paid twice)
    h_mesh = card_mesh((2, 2), ("cp", "rows"))
    out["row_sharded_feast"] = []
    # (h)'s kernels, counted apart from (a)-(f)
    h_counts = {"dia_spmm_kernel": 0, "well_spmm": 0}
    print(f"phase 12 (h) mesh: {h_mesh.layout()}; contour shards on "
          f"{[str(d) for d in h_mesh.shards('cp')]}, rows shards on "
          f"{[str(d) for d in h_mesh.shards('rows')]}", flush=True)

    def row_sharded(*args):
        row = row_sharded_feast(dev, card, h_mesh, *args, gen=mgen,
                                parity_abs=parity_abs)
        out["row_sharded_feast"].append(row)
        for k, c in row["launches"].items():
            h_counts[k] += c
        return row

    # ---- (f) contour-sharded FEAST: phase 8's lowest windows, each
    # followed by (h) on the same operator
    pipeline.clear_pipeline_cache()
    cp = card_mesh(n_shards, ("cp",))
    out["feast"] = []
    peaks = []
    for gf in (grids[2], g7):
        lam = spectrum_2d(gf)
        emax = float((lam[49] + lam[50]) / 2)
        af = poisson_2d(gf, dtype=f64, device=dev)
        p = FeastParams(tol=1e-10, dims=(gf, gf), backend="multifrontal")
        torch.cuda.reset_peak_memory_stats(dev)
        res, cold_s = timed(lambda: eigsh(80, (0.0, emax), af, p, mesh=cp))
        run = dict(pipeline.last_run)
        res, warm_s = timed(lambda: eigsh(80, (0.0, emax), af, p, mesh=cp))
        peaks.append(torch.cuda.max_memory_allocated(dev) / 1e9)
        err, err_rel = feast_errors(res, lam[:50], (0.0, emax))
        ref_vals, ref_loops = refs["feast"][gf]
        d8 = float(np.max(np.abs(np.sort(res.values) - ref_vals)))
        row = {"name": f"lowest 50 of {gf}^2 over {n_shards} shards",
               "n": gf * gf, "cold_s": cold_s, "warm_s": warm_s,
               "loops": res.iterations, "phase8_loops": ref_loops,
               "epsout": res.epsout, "max_err_scaled": err,
               "vs_phase8": d8, "mode": run["mode"],
               "shard_mode": run["shard_mode"], "why": run["why"],
               "analyze_s": run["analyze_s"], "factor_s": run["factor_s"],
               "solve_s": sum(lp["solve_s"] for lp in run["loops"]),
               "rr_s": sum(lp["rr_s"] for lp in run["loops"]),
               "peak_gb": peaks[-1]}
        out["feast"].append(row)
        print(f"phase 12 [{card}] contour-sharded FEAST {row['name']}: "
              f"cold {cold_s:.3f} s, warm {warm_s:.3f} s; {res.iterations} "
              f"loops (phase 8: {ref_loops}), epsout {res.epsout:.3e}, "
              f"against the analytic spectrum {err:.3e} on the interval's "
              f"scale, against phase 8 {d8:.3e} (tol 1e-12); contour "
              f"{run['mode']} ({run['why']}); cold split: analyze "
              f"{run['analyze_s']:.3f} s, factor {run['factor_s']:.3f} s, "
              f"solves {row['solve_s']:.3f} s, products {row['rr_s']:.3f} s;"
              f" peak {peaks[-1]:.3f} GB (tol 75)", flush=True)
        require(res.info == INFO_OK and res.epsout <= 1e-10 and err <= 1e-10,
                f"sharded FEAST {gf}^2: info {res.info}, epsout "
                f"{res.epsout}, err {err}")
        require(run["mode"] == "sharded" and len(run["shards"]) == n_shards,
                f"contour {run['mode']} on {run['shards']}")
        require(res.iterations == ref_loops,
                f"{res.iterations} loops, phase 8 {ref_loops}")
        require(d8 <= 1e-12, f"against phase 8: {d8}")
        require(peaks[-1] < 75.0, f"peak {peaks[-1]} GB")
        del res
        hrow = row_sharded(f"lowest 50 of {gf}^2", af, (0.0, emax), lam[:50],
                           refs["feast"][gf], p, "dia")
        peaks.append(hrow["peak_gb"])
        del af
        pipeline.clear_pipeline_cache()
        torch.cuda.empty_cache()
        if gf == grids[2]:
            # phase 8's permuted operator, no dims: the WELL route
            pvals, ploops, pcsr = refs["feast"]["permuted"]
            hrow = row_sharded(
                f"lowest 50 of {gf}^2 permuted", pcsr.to(dev), (0.0, emax),
                lam[:50], (pvals, ploops),
                FeastParams(tol=1e-10, backend="multifrontal"), "well")
            peaks.append(hrow["peak_gb"])
            pipeline.clear_pipeline_cache()
            torch.cuda.empty_cache()

    launches = {k.__name__: k.launches for k in kernels}
    out["launches"] = launches
    out["launches_h"] = h_counts
    print(f"phase 12 launches over (a)-(f): {launches}; over (h): "
          f"{h_counts}", flush=True)
    require(all(v >= 1 for v in launches.values()),
            f"a kernel of the multi-device path was not launched: "
            f"{launches}")
    require(all(v >= 1 for v in h_counts.values()),
            f"a kernel of the row-sharded FEAST path was not launched: "
            f"{h_counts}")

    # ---- (g) the multi-device dry run on the card
    dry, dry_s = timed(lambda: dryrun_multichip(n_shards))
    out["dryrun"] = dict(dry, s=dry_s)
    require(dry["feast_found"] == 8, f"dry run {dry}")
    out["s"] = time.perf_counter() - t_phase
    print(f"phase 12 multi-device: {out['s']:.3f} s wall (budget 150 s), "
          f"peak device memory {max(peaks):.3f} GB", flush=True)
    return out


def row_sharded_feast(dev, card: str, mesh, name, a, interval, want, ref,
                      params, route, gen, parity_abs: dict) -> dict:
    """Phase 12 (h), one window: FEAST's 50 lowest pairs (m0 = 80) on the
    ("cp", "rows") ``mesh``, cold then warm, with the launch counts of
    kernel A's multi-RHS form and kernel D set to 0 before and read after
    (the counts the caller had are restored); then the row-sharded product
    of A at (n, 80) (a block drawn from ``gen``) held against the unsharded
    kernel and the plain version, those launches left out.  ``ref``:
    phase 8's (sorted eigenvalues, loops) on the window; ``route``: the
    route A must take ("dia" or "well").  Returns the row of the
    ``row_sharded_feast`` list, with the launches under ``launches``; any
    failed check raises."""
    import numpy as np
    import torch

    from sparse_linear_tpu_torch.dist import Mesh, ShardedBlock
    from sparse_linear_tpu_torch.dist import spmv as ds
    from sparse_linear_tpu_torch.eig import pipeline
    from sparse_linear_tpu_torch.eig.feast import INFO_OK, eigsh
    from sparse_linear_tpu_torch.formats.well import csr_to_well
    from sparse_linear_tpu_torch.kernels.spmv import dia_spmm
    from sparse_linear_tpu_torch.kernels.spmv_dia import (
        dia_spmm_kernel,
        dia_spmv_kernel,
    )
    from sparse_linear_tpu_torch.kernels.spmv_well import (
        well_spmm,
        well_spmm_planes_plain,
        well_spmv,
    )

    h_kernels = (dia_spmm_kernel, well_spmm)
    every = h_kernels + (dia_spmv_kernel, well_spmv)
    cards = sorted({d for d in mesh.devices.flat}, key=str)
    rows_mesh = Mesh(mesh.shards("rows"), ("rows",))
    ref_vals, ref_loops = ref[:2]
    saved = [k.launches for k in every]
    for k in h_kernels:
        k.launches = 0
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    res, cold_s = timed(lambda: eigsh(80, interval, a, params, mesh=mesh))
    cold = dict(pipeline.last_run)
    res, warm_s = timed(lambda: eigsh(80, interval, a, params, mesh=mesh))
    warm = dict(pipeline.last_run)
    peaks = {str(c): torch.cuda.max_memory_allocated(c) / 1e9 for c in cards}
    peak = max(peaks.values())
    counts = {k.__name__: k.launches for k in h_kernels}
    err, _ = feast_errors(res, want, interval)
    scale = max(abs(interval[0]), abs(interval[1]), 1.0)
    d8 = float(np.max(np.abs(np.sort(res.values) - ref_vals))) / scale
    n = a.shape[0]
    # the products the loop ran, held against the unsharded kernel and the
    # plain version on one (n, 80) block
    sop = pipeline._structured_op(a)
    rop = pipeline._row_op(sop, rows_mesh)
    x = torch.randn((n, 80), dtype=torch.float64, device=dev, generator=gen)
    y = rop(ShardedBlock.from_tensor(x, rows_mesh)).full(dev)
    whole = sop(x)
    shards = len(rows_mesh.shards("rows"))
    gathered = (shards - 1) * -(-n // shards) * 80
    if route == "dia":
        plain = dia_spmm(sop.mat, x)
        exchange, shipped = (("halo", 2 * rop.mat.halo * 80)
                             if rop.mat.halo_slabs is not None
                             else ("all-gather", gathered))
    else:
        plain = well_spmm_planes_plain(csr_to_well(sop.mat), x.T).T
        exchange, shipped = (
            ("window", ds.window_exchange_elements(rop.mat.xplan) * 80)
            if rop.mat.xplan is not None else ("all-gather", gathered))
    same = bool(torch.equal(y, whole))
    torch.cuda.synchronize()
    unsh_abs, unsh_rel = max_err(y, whole)
    plain_abs, plain_rel = max_err(y, plain)
    for k, c in zip(every, saved):
        k.launches = c
    parity_abs[f"phase 12 (h) spmm_sharded {route} {name}"] = plain_abs
    r_local = warm["rows_local"]
    split = {k: sum(lp[k] for lp in warm["loops"])
             for k in ("solve_s", "products_s", "gram_s", "eigh_s")}
    row = {"name": f"{name} on (cp, rows) (2, 2)", "n": n, "route": route,
           "layout": mesh.layout(), "cold_s": cold_s, "warm_s": warm_s,
           "loops": res.iterations, "phase8_loops": ref_loops,
           "epsout": res.epsout, "max_err_scaled": err, "vs_phase8": d8,
           "mode": warm["mode"], "shard_mode": warm["shard_mode"],
           "why": warm["why"], "contour_shards": warm["shards"],
           "rows_shards": warm["rows_shards"], "rows_local": r_local,
           "exchange": exchange, "received_per_product": shipped,
           "allgather_per_product": gathered,
           "cold_analyze_s": cold["analyze_s"],
           "cold_factor_s": cold["factor_s"], "warm_split": split,
           "products_vs_unsharded_rel": unsh_rel,
           "products_bitwise_unsharded": same,
           "products_vs_plain_rel": plain_rel, "launches": counts,
           "peak_gb": peak, "peak_gb_by_card": peaks}
    print(f"phase 12 [{card}] (h) row-sharded FEAST {row['name']}: cold "
          f"{cold_s:.3f} s (analyze {cold['analyze_s']:.3f} s, factor "
          f"{cold['factor_s']:.3f} s), warm {warm_s:.3f} s; "
          f"{res.iterations} loops (phase 8: {ref_loops}), epsout "
          f"{res.epsout:.3e}, against the analytic spectrum {err:.3e} and "
          f"phase 8 {d8:.3e} on the interval's scale (tol 1e-10, 1e-12); "
          f"peak {peak:.3f} GB (tol 75; by card {peaks})", flush=True)
    print(f"phase 12 [{card}] (h) {name}: contour {warm['mode']} "
          f"({warm['why']}) on {warm['shards']}; route {route}, rows shards "
          f"{warm['rows_shards']} of {r_local} rows; a shard receives "
          f"{shipped} elements of X a product ({exchange}) against the "
          f"all-gather's {gathered}; warm split: solves "
          f"{split['solve_s']:.3f} s, products {split['products_s']:.3f} s, "
          f"Grams {split['gram_s']:.3f} s, host eighs {split['eigh_s']:.3f} "
          f"s; launches {counts}", flush=True)
    print(f"phase 12 [{card}] (h) {name}: row-sharded product of A at "
          f"(n, 80) against the unsharded kernel: max rel err "
          f"{unsh_rel:.3e}, bitwise {same}; against the plain version "
          f"{plain_rel:.3e} (tol 1e-12)", flush=True)
    require(res.info == INFO_OK and res.epsout <= 1e-10 and err <= 1e-10,
            f"row-sharded FEAST {name}: info {res.info}, epsout "
            f"{res.epsout}, err {err}")
    require(warm["mode"] == "sharded" and len(warm["shards"]) == 2
            and len(warm["rows_shards"]) == 2,
            f"(h) {name}: contour {warm['mode']} on {warm['shards']}, rows "
            f"on {warm['rows_shards']}")
    require(warm["routes"][0] == route, f"(h) {name}: {warm['routes']}")
    require(res.iterations == ref_loops,
            f"(h) {name}: {res.iterations} loops, phase 8 {ref_loops}")
    require(d8 <= 1e-12, f"(h) {name} against phase 8: {d8}")
    require(peak < 75.0, f"(h) {name}: peak {peak} GB")
    require(res.vectors.device == a.data.device
            and tuple(res.subspace.shape) == (n, 80),
            f"(h) {name}: vectors on {res.vectors.device}")
    require(unsh_rel <= 1e-12 and plain_rel <= 1e-12,
            f"(h) {name}: sharded product {unsh_rel}, {plain_rel}")
    require(route != "dia" or same,
            f"(h) {name}: DIA slabs not bitwise the unsharded kernel")
    kernel = {"dia": "dia_spmm_kernel", "well": "well_spmm"}[route]
    require(counts[kernel] >= 1,
            f"(h) {name}: the route's kernel was not launched: {counts}")
    return row

WALKTHROUGHS = ("torch_poisson_direct.py", "torch_eigensolve.py",
                "torch_distributed.py", "torch_kernels_f64.py")


def walkthrough_phase(card: str, timeout_s: float = 300.0) -> list:
    """Phase 13: the port's walkthroughs (``examples/torch_*.py``), each in
    its own process on the card (their default), one after another: exit
    code 0 and a first line naming a CUDA device, and the wall time of
    each.  Returns the rows of the ``walkthroughs`` JSON line; any failed
    check raises."""
    rows = []
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    for script in WALKTHROUGHS:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "examples" / script)], cwd=ROOT,
            env=env, capture_output=True, text=True, timeout=timeout_s)
        wall = time.perf_counter() - t0
        lines = proc.stdout.splitlines()
        first = lines[0] if lines else ""
        rows.append({"script": f"examples/{script}", "rc": proc.returncode,
                     "wall_s": wall, "device_line": first,
                     "last_line": lines[-1] if lines else ""})
        print(f"phase 13 [{card}] examples/{script}: rc {proc.returncode} "
              f"in {wall:.3f} s wall; {first!r}; last line "
              f"{rows[-1]['last_line']!r}", flush=True)
        require(proc.returncode == 0,
                f"examples/{script} exited {proc.returncode}: "
                f"{proc.stderr[-2000:]}")
        require(first.startswith("device: cuda"),
                f"examples/{script} ran on {first!r}")
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    sys.path.insert(0, str(ROOT))
    import sparse_linear_tpu_torch as st
    from sparse_linear_tpu_torch.entry import entry
    from sparse_linear_tpu_torch.formats.structured import DIA, csr_to_dia
    from sparse_linear_tpu_torch.kernels import _build, cg_step
    from sparse_linear_tpu_torch.kernels import spmv_well as spmv_well_module
    from sparse_linear_tpu_torch.kernels.spmv import (
        dia_spmm,
        dia_spmm_planes,
        dia_spmv,
    )
    from sparse_linear_tpu_torch.kernels.spmv_dia import (
        dia_spmm_kernel,
        dia_spmm_planes_kernel,
        dia_spmv_chain,
        dia_spmv_kernel,
    )
    from sparse_linear_tpu_torch.kernels.spmv_well import (
        well_spmm,
        well_spmm_planes,
        well_spmm_planes_plain,
        well_spmv,
        well_spmv_plain,
    )
    from sparse_linear_tpu_torch.kernels.spmv_well64 import csr_to_well64
    from sparse_linear_tpu_torch.ops.spgemm import (
        spgemm,
        spgemm_apply_well,
        spgemm_plan_well,
    )
    from sparse_linear_tpu_torch.solve.cg import cg
    from sparse_linear_tpu_torch.utils.grids import poisson_2d, poisson_3d

    cg_steps = (cg_step.cg_pq, cg_step.cg_update, cg_step.cg_direction)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    # the WELL phases draw from their own stream, so that the slice-1
    # phases see the same random numbers as before them
    wgen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    # checks added after a stream was in use draw from a third one, so that
    # the main paths keep the draws (and CG iteration counts) they had
    xgen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    # kernel A's multi-RHS form draws from a fourth (phase 7 has seed + 3,
    # phase 8 seed + 5)
    fgen = torch.Generator(device=dev).manual_seed(args.seed + 4)
    f32, f64 = torch.float32, torch.float64

    def randn(n, dtype, generator=gen):
        return torch.randn(n, dtype=dtype, device=dev, generator=generator)

    def poisson_triples(g, generator=gen):
        """The g**2 5-point operator as shuffled f64 triples on the card;
        the diagonal is split into two duplicates of 2 that dedup-by-sum
        must restore to 4."""
        n = g * g
        i = torch.arange(n, dtype=torch.int32, device=dev)
        ix = i % g
        rows, cols = [i, i], [i, i]
        for off, ok in ((-g, i >= g), (g, i < n - g), (-1, ix > 0),
                        (1, ix < g - 1)):
            rows.append(i[ok])
            cols.append(i[ok] + off)
        vals = torch.cat([torch.full((2 * n,), 2.0, dtype=f64, device=dev),
                          torch.full((sum(r.shape[0] for r in rows[2:]),),
                                     -1.0, dtype=f64, device=dev)])
        rows, cols = torch.cat(rows), torch.cat(cols)
        perm = torch.randperm(rows.shape[0], device=dev, generator=generator)
        return rows[perm], cols[perm], vals[perm]

    def permuted_csr(g, dtype):
        """The g**2 5-point operator with its unknowns relabelled by a
        seeded permutation (rows and columns through the same one): the
        spectrum of the stencil, the numbering of an unstructured mesh."""
        coo = poisson_2d(g, dtype=dtype, device=dev).tocoo()
        perm = torch.randperm(g * g, device=dev, generator=wgen)
        return st.from_triples((g * g, g * g), perm[coo.row.long()],
                               perm[coo.col.long()], coo.data).tocsr()

    # ---------------------------------------------------------- 1. card
    card = card_line()
    print(card)
    print(f"phase 1 card: {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} | CUDA {torch.version.cuda}", flush=True)

    # --------------------------------------------------------- 2. build
    lib_path = _build.library_path()
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    print(f"phase 2 build: {lib_path.relative_to(ROOT)} "
          f"{'built' if build_s > 0.5 else 'loaded'} in {build_s:.2f} s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})", flush=True)

    # ------------------------------------------------ 3. kernel parity
    t_parts = {"phase 3": time.perf_counter()}
    tol = {f32: 1e-5, f64: 1e-12}
    parity_abs = {}

    def check_spmv(label, a, alpha=None):
        x = randn(a.shape[1], a.dtype)
        y = dia_spmv_kernel(a, x, alpha=alpha)
        ref = dia_spmv(a, x)
        if alpha is not None:
            ref = ref * alpha
        torch.cuda.synchronize()
        err, rel = max_err(y, ref)
        print(f"phase 3 parity dia_spmv {label}: shape {a.shape} ndiag "
              f"{len(a.offsets)} max rel err {rel:.3e} (max abs {err:.3e}, "
              f"tol {tol[a.dtype]:.0e})", flush=True)
        require(rel <= tol[a.dtype], f"dia_spmv {label} disagrees: {rel}")
        parity_abs[label] = err

    def random_dia(shape, offsets, dtype, generator=gen):
        nr, nc = shape
        i = torch.arange(nr, device=dev)
        data = torch.randn((len(offsets), nr), dtype=dtype, device=dev,
                           generator=generator)
        for d, off in enumerate(offsets):
            data[d].masked_fill_((i + off < 0) | (i + off >= nc), 0)
        return DIA(data=data, shape=shape, offsets=tuple(offsets))

    for dtype in (f32, f64):
        check_spmv(f"poisson_2d(2048) {dtype}",
                   poisson_2d(2048, dtype=dtype, fmt="dia", device=dev))
        check_spmv(f"poisson_2d(1448) {dtype}",
                   poisson_2d(1448, dtype=dtype, fmt="dia", device=dev))
    check_spmv("poisson_2d(2048) f32 alpha=0.37",
               poisson_2d(2048, dtype=f32, fmt="dia", device=dev), alpha=0.37)
    check_spmv("rectangular 3000000x2000000 f32",
               random_dia((3_000_000, 2_000_000),
                          (-1_000_000, -5, 0, 3, 1_500_000), f32))
    check_spmv("rectangular 2000000x3000000 f64",
               random_dia((2_000_000, 3_000_000),
                          (-1_500_000, -7, 0, 1, 2_000_000), f64))
    check_spmv("poisson_3d(216) f32",
               poisson_3d(216, dtype=f32, fmt="dia", device=dev))

    a32 = poisson_2d(2048, dtype=f32, fmt="dia", device=dev)
    x = randn(a32.shape[1], f32)
    y = dia_spmv_chain(a32, x, 50, alpha=0.125)
    ref = x
    for _ in range(50):
        ref = dia_spmv(a32, ref) * 0.125
    torch.cuda.synchronize()
    chain_abs, chain_rel = max_err(y, ref)
    print(f"phase 3 parity dia_spmv_chain poisson_2d(2048) f32 k=50 "
          f"alpha=0.125: max rel err {chain_rel:.3e} (max abs "
          f"{chain_abs:.3e}, tol 1e-4)", flush=True)
    require(chain_rel <= 1e-4, f"dia_spmv_chain disagrees: {chain_rel}")
    # kernels B and C sum in a fixed order with no atomics: a launch
    # repeated on the same input gives bitwise the same result
    same = all(torch.equal(dia_spmv_chain(a32, x, 50, alpha=0.125), y)
               for _ in range(10))
    print(f"phase 3 dia_spmv_chain f32 k=50 repeated 10 times: bitwise "
          f"equal {same}", flush=True)
    require(same, "dia_spmv_chain is not repeatable")
    # f64 at an unaligned size (the power iteration of phase 4 is f64)
    a64 = poisson_2d(1448, dtype=f64, fmt="dia", device=dev)
    x = randn(a64.shape[1], f64, xgen)
    y = dia_spmv_chain(a64, x, 7, alpha=0.125)
    ref = x
    for _ in range(7):
        ref = dia_spmv(a64, ref) * 0.125
    torch.cuda.synchronize()
    _, chain64_rel = max_err(y, ref)
    print(f"phase 3 parity dia_spmv_chain poisson_2d(1448) f64 k=7 "
          f"alpha=0.125: max rel err {chain64_rel:.3e} (tol 1e-12)",
          flush=True)
    require(chain64_rel <= 1e-12, f"dia_spmv_chain f64 disagrees: "
            f"{chain64_rel}")
    del a32, a64, x, y, ref
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t_parts["phase 3 dia_spmm"] = time.perf_counter()
    dia_spmm_parity(dev, fgen, random_dia, parity_abs)
    t_parts["phase 3 well"] = time.perf_counter()

    # WELL kernels C (SpMV) and D (SpMM) against their plain versions
    def check_well_spmv(label, w, generator=wgen):
        x = randn(w.shape[1], w.dtype, generator)
        y = well_spmv(w, x)
        ref = well_spmv_plain(w, x)
        torch.cuda.synchronize()
        err, rel = max_err(y, ref)
        print(f"phase 3 parity well_spmv {label}: shape {w.shape} capacity "
              f"{w.cols.shape[0]} fill {w.fill:.4f} c_max {w.c_max} max rel "
              f"err {rel:.3e} (max abs {err:.3e}, tol {tol[w.dtype]:.0e})",
              flush=True)
        require(rel <= tol[w.dtype], f"well_spmv {label} disagrees: {rel}")
        require(all(torch.equal(well_spmv(w, x), y) for _ in range(3)),
                f"well_spmv {label} is not repeatable")
        parity_abs[f"well_spmv {label}"] = err
        return x, y

    def check_well_spmm(label, w, m, column_major=False, generator=wgen):
        xp = randn(m * w.shape[1], w.dtype, generator).reshape(m, w.shape[1])
        if column_major:
            y = well_spmm(w, xp.T.contiguous()).T
        else:
            y = well_spmm_planes(w, xp)
        # the plain version four planes at a time bounds its memory
        ref = torch.cat([well_spmm_planes_plain(w, xp[t:t + 4])
                         for t in range(0, m, 4)])
        torch.cuda.synchronize()
        err, rel = max_err(y, ref)
        form = "well_spmm (column-major)" if column_major else \
            "well_spmm_planes"
        print(f"phase 3 parity {form} {label} m={m}: max rel err {rel:.3e} "
              f"(max abs {err:.3e}, tol {tol[w.dtype]:.0e})", flush=True)
        require(rel <= tol[w.dtype], f"{form} {label} m={m} disagrees: {rel}")
        parity_abs[f"well_spmm {label} m={m}"
                   + (" column-major" if column_major else "")] = err

    def check_columns(label, w, m):
        """Kernel D sums each entry over its row's slots in slot order from
        zero, as kernel C does: column t of well_spmm(w, X) is bitwise
        well_spmv(w, X[:, t]), and a second call is bitwise the first.
        The digest of Y's bytes tells two builds' results apart."""
        x = randn(m * w.shape[1], w.dtype, xgen).reshape(w.shape[1], m)
        y = well_spmm(w, x)
        same = all(torch.equal(y[:, t], well_spmv(w, x[:, t]))
                   for t in range(m))
        again = torch.equal(well_spmm(w, x), y)
        print(f"phase 3 well_spmm {label} m={m}: every column bitwise "
              f"well_spmv {same}, repeated call bitwise equal {again}, "
              f"digest {digest(y)}", flush=True)
        require(same, f"well_spmm {label} m={m} differs from well_spmv")
        require(again, f"well_spmm {label} m={m} is not repeatable")

    # m on both sides of kernel D's lane-group and tile widths (16 f64 /
    # 32 f32 values a 128-byte run), up to FEAST's 80 and past the five
    # chunks a lane holds (96 and 168 in f64, 168 in f32: m tiled).  The m
    # of the earlier checks draw from wgen as before, the rest from xgen.
    spmm_ms = (5, 16, 17, 33, 40)
    wide_ms = (8, 32, 64, 80, 96, 168)
    for dtype in (f32, f64):
        w = st.csr_to_well(permuted_csr(2048, dtype))
        check_well_spmv(f"permuted 2048^2 {dtype}", w)
        first = (16, 5) if dtype == f32 else (16,)
        for m in first:
            check_well_spmm(f"permuted 2048^2 {dtype}", w, m)
        check_well_spmm(f"permuted 2048^2 {dtype}", w, 16, column_major=True)
        for m in spmm_ms:
            if m not in first:
                check_well_spmm(f"permuted 2048^2 {dtype}", w, m,
                                generator=xgen)
        for m in wide_ms:
            for column_major in (False, True):
                check_well_spmm(f"permuted 2048^2 {dtype}", w, m,
                                column_major=column_major, generator=xgen)
        for m in (16, 80):
            check_columns(f"permuted 2048^2 {dtype}", w, m)
        del w

    # K7's contract: f64 WELL against f64 CSR SpMV, norm-wise
    csr = poisson_2d(1448, dtype=f64, device=dev)
    w = csr_to_well64(csr)
    x, y = check_well_spmv("poisson_2d(1448) csr_to_well64", w)
    ref = st.spmv(csr, x)
    k7_rel = float(torch.linalg.vector_norm(y - ref)
                   / torch.linalg.vector_norm(ref))
    print(f"phase 3 parity well_spmv64 poisson_2d(1448) against CSR spmv: "
          f"||y - y_csr|| / ||y_csr|| {k7_rel:.3e} (tol 1e-13)", flush=True)
    require(k7_rel <= 1e-13, f"well_spmv64 misses 1e-13: {k7_rel}")
    del csr, w, x, y, ref

    # skewed rectangular: 0-64 entries a row, ~1 % of rows empty, four rows
    # of 4096 entries that pad their slices
    nr_s, nc_s = 3_000_000, 2_000_000
    lens = torch.randint(1, 65, (nr_s,), device=dev, generator=wgen)
    lens[torch.rand(nr_s, device=dev, generator=wgen) < 0.01] = 0
    lens[torch.randint(0, nr_s, (4,), device=dev, generator=wgen)] = 4096
    rows = torch.repeat_interleave(
        torch.arange(nr_s, dtype=torch.int32, device=dev), lens)
    cols = torch.randint(0, nc_s, rows.shape, dtype=torch.int32, device=dev,
                         generator=wgen)
    skew = st.from_triples((nr_s, nc_s), rows, cols,
                           randn(rows.shape[0], f32, wgen)).tocsr()
    del rows, cols, lens
    row_len = skew.indptr[1:] - skew.indptr[:-1]
    n_empty, longest = int((row_len == 0).sum()), int(row_len.max())
    print(f"phase 3 skewed {nr_s}x{nc_s}: nnz {skew.nnz}, {n_empty} "
          f"empty rows, longest row {longest}", flush=True)
    # (duplicate columns of a long row are summed, so it may come out a
    # few entries short of 4096)
    require(n_empty > 0 and longest > 64, "skewed matrix lost its shape")
    w32 = st.csr_to_well(skew)
    del skew, row_len
    check_well_spmv(f"skewed {nr_s}x{nc_s} {f32}", w32)
    check_well_spmm(f"skewed {nr_s}x{nc_s} {f32}", w32, 5)
    for dtype in (f32, f64):
        w = w32 if dtype == f32 else dataclasses.replace(
            w32, vals=w32.vals.to(f64))
        if dtype == f64:
            check_well_spmv(f"skewed {nr_s}x{nc_s} {dtype}", w, xgen)
        for m in spmm_ms + (80,):
            if (dtype, m) != (f32, 5):
                check_well_spmm(f"skewed {nr_s}x{nc_s} {dtype}", w, m,
                                generator=xgen)
        for m in (16, 80):
            check_columns(f"skewed {nr_s}x{nc_s} {dtype}", w, m)
        del w
    del w32
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # the complex instantiations, from their own random stream
    t_parts["phase 3 complex"] = time.perf_counter()
    complex_parity(dev, torch.Generator(device=dev).manual_seed(
        args.seed + 7), parity_abs)
    t_parts["phase 4"] = time.perf_counter()

    # ------------------------------------------- 4. main path, full size
    g = 2048
    n = g * g
    # CG's three vector kernels against their plain versions at the CG
    # phases' length (4 and 6 in f64, 9 in c128) and at 216**3 (cg-grid's)
    sgen = torch.Generator(device=dev).manual_seed(args.seed + 10)
    cg_step_abs = {}
    for length, dtype in ((n, f32), (n, f64), (n, torch.complex64),
                          (n, torch.complex128), (216 ** 3, f64)):
        for kernel, err in cg_step_parity(dev, sgen, length, dtype).items():
            cg_step_abs[kernel] = max(cg_step_abs.get(kernel, 0.0), err)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    dia_spmv_kernel.launches = 0
    dia_spmv_chain.launches = 0
    t_main = time.perf_counter()

    rows, cols, vals = poisson_triples(g)
    n_triples = rows.shape[0]
    t0 = time.perf_counter()
    coo = st.from_triples((n, n), rows, cols, vals)
    del rows, cols, vals
    csr = coo.tocsr()
    del coo
    require(st.check_matrix(csr), "check_matrix")
    dia = csr_to_dia(csr)
    torch.cuda.synchronize()
    assemble_s = time.perf_counter() - t0
    require(dia.offsets == (-g, -1, 0, 1, g), f"offsets {dia.offsets}")
    want = poisson_2d(g, dtype=f64, fmt="dia", device=dev)
    require(torch.equal(dia.data, want.data),
            "assembled DIA differs from poisson_2d")
    del want
    print(f"phase 4 assemble: {n_triples} triples -> CSR nnz {csr.nnz} -> "
          f"DIA {dia.offsets} in {assemble_s:.3f} s", flush=True)

    # top of the spectrum: power iteration through the one-launch chain
    # (alpha = 1/8 keeps (alpha A)^k bounded), Rayleigh quotient at the end
    lam_exact = 8 * math.sin(g * math.pi / (2 * (g + 1))) ** 2
    v = randn(n, f64)
    v /= torch.linalg.vector_norm(v)
    t0 = time.perf_counter()
    for _ in range(40):
        v = dia_spmv_chain(dia, v, 50, alpha=0.125)
        v /= torch.linalg.vector_norm(v)
    lam = float(torch.dot(v, dia @ v))
    power_s = time.perf_counter() - t0
    lam_rel = abs(lam - lam_exact) / lam_exact
    print(f"phase 4 power iteration: 2000 steps in 40 chain launches, "
          f"lambda_max {lam:.9f} vs analytic {lam_exact:.9f} (rel "
          f"{lam_rel:.2e}, tol 1e-2) in {power_s:.3f} s", flush=True)
    require(lam_rel <= 1e-2 and lam <= lam_exact * (1 + 1e-12),
            f"power iteration lambda {lam} vs {lam_exact}")

    b = randn(n, f64)
    b_phase4 = b.cpu()  # phase 9 turns it by the gauge phases
    for wrapper in cg_steps:
        wrapper.launches = 0
    t0 = time.perf_counter()
    res = cg(dia.__matmul__, b, tol=1e-10, maxiter=40_000)
    torch.cuda.synchronize()
    cg_s = time.perf_counter() - t0
    cg_launches = {w.__name__: w.launches for w in cg_steps}
    bnorm = float(torch.linalg.vector_norm(b))
    true_res = float(torch.linalg.vector_norm(b - st.spmv(csr, res.x))) / bnorm
    cg_res = float(res.residual_norm) / bnorm
    print(f"phase 4 cg f64 2048^2: {res.iterations} iterations ("
          f"{res.launched} queued, {res.host_reads} host reads), recursive "
          f"residual {cg_res:.3e}, true residual (CSR spmv) {true_res:.3e} "
          f"(tol 1e-9), {cg_s:.3f} s, {cg_s / max(res.iterations, 1) * 1e3:.4f}"
          f" ms/iteration, launches {cg_launches}", flush=True)
    require(res.converged, "cg did not converge")
    require(set(cg_launches.values()) == {res.launched},
            f"cg_step launches {cg_launches}, {res.launched} queued")
    require(bool(torch.isfinite(res.x).all()), "cg returned non-finite x")
    require(true_res <= 1e-9, f"true residual {true_res}")
    cg_its = res.iterations
    cg_ms4 = cg_s / max(cg_its, 1) * 1e3  # phase 12 prints it
    del b, res, csr, dia, v

    fn, fargs = entry(dev, grid=g, dtype=f32)
    x_e, rn_e = fn(*fargs)
    a_e = fargs[0]

    class PlainDIA:
        def __matmul__(self, vec):
            return dia_spmv(a_e, vec)

    x_p, rn_p = fn(PlainDIA(), fargs[1])
    torch.cuda.synchronize()
    _, entry_rel = max_err(x_e, x_p)
    rn_rel = abs(float(rn_e) - float(rn_p)) / float(rn_p)
    print(f"phase 4 entry(grid=2048, f32): |r_new| {float(rn_e):.6f} vs plain "
          f"{float(rn_p):.6f}, x max rel err {entry_rel:.2e} (rtol 1e-5)",
          flush=True)
    require(x_e.shape == (n,) and bool(torch.isfinite(x_e).all()), "entry x")
    require(entry_rel <= 1e-5 and rn_rel <= 1e-5, "entry disagrees")
    del x_e, x_p, fargs, a_e
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t_main
    launches = {"dia_spmv": dia_spmv_kernel.launches,
                "dia_spmv_chain": dia_spmv_chain.launches}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"phase 4 main path: {main_s:.3f} s wall, launches {launches}, "
          f"peak device memory {peak_gb:.3f} GB", flush=True)
    require(launches["dia_spmv_chain"] >= 1, "main path launched no chain")
    require(launches["dia_spmv"] >= cg_its,
            f"dia_spmv launches {launches['dia_spmv']} < {cg_its} iterations")
    require(peak_gb < 2.0, f"peak device memory {peak_gb} GB")
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ 5. times
    t_parts["phase 5"] = time.perf_counter()
    flush_buf = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)

    def samples_ms(f, reps=12):
        """ms of each of ``reps`` calls from CUDA events, L2 flushed before
        each, after a warm-up."""
        for _ in range(3):
            f()
        events = []
        for _ in range(reps):
            flush_buf.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            f()
            e.record()
            events.append((s, e))
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in events]

    def in_turns(plain, kernel, library=None):
        """Plain, library, kernel, kernel, library, plain: the median of each
        over its 24 calls in both turns (library None where there is no
        library call)."""
        p = samples_ms(plain)
        lib = samples_ms(library) if library else []
        k = samples_ms(kernel) + samples_ms(kernel)
        lib += samples_ms(library) if library else []
        p += samples_ms(plain)
        return (statistics.median(k), statistics.median(p),
                statistics.median(lib) if lib else None)

    # outside the tensor cores (NVIDIA's data sheet, H100 SXM)
    c64, c128 = torch.complex64, torch.complex128
    peak_flops = {f32: 67e12, f64: 34e12, c64: 67e12, c128: 34e12}

    def term_flops(dtype):
        """Flops of one multiply-add term: 2, or 8 for complex (four real
        fmas)."""
        return 8 if dtype.is_complex else 2

    def library_call(lib, x):
        """(the library call on x, what it is), or (None, why) where torch
        refuses it (as for a dtype cuSPARSE is not given)."""
        try:
            lib @ x
        except (RuntimeError, NotImplementedError) as exc:
            return None, f"torch refused it: {str(exc).splitlines()[0]}"
        return (lambda: lib @ x), "cuSPARSE through torch.sparse_csr_tensor"

    def bound(nbytes, flops, dtype):
        """The least time the card could take: the larger of the bytes over
        the HBM rate and the flops over the peak rate of the type, and
        which of the two it is."""
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / peak_flops[dtype] * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")

    def library_csr(csr):
        """The same operator as a torch sparse CSR tensor: ``@`` on it is
        the one PyTorch call (cuSPARSE) that computes the kernel's
        function.  Built and timed here only; the port never calls it."""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            return torch.sparse_csr_tensor(
                csr.indptr.to(torch.int32), csr.indices.to(torch.int32),
                csr.data, csr.shape)

    def record(name, dtype, k_ms, p_ms, lib_ms, nbytes, flops, library):
        b_ms, b_by = bound(nbytes, flops, dtype)
        times[f"{name} {dtype}"] = {
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bound_share": b_ms / k_ms, "library_ms": lib_ms,
            "library": library}
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        prev = PREVIOUS_MS.get(f"{name} {dtype}")
        prev = "" if prev is None else \
            f"; previous design (PERF.md): {prev:.4f} ms"
        print(f"phase 5 time [{card}] {name} {dtype}: kernel {k_ms:.4f} ms "
              f"({nbytes / k_ms / 1e6:.1f} GB/s), bound {b_ms:.4f} ms by "
              f"{b_by} ({b_ms / k_ms:.1%} of it reached), plain "
              f"{p_ms:.4f} ms, library {lib}{prev}", flush=True)

    times = {}
    for dtype in (f32, f64):
        csr = poisson_2d(g, dtype=dtype, device=dev)
        a = csr_to_dia(csr)
        lib_a = library_csr(csr)
        nnz = csr.nnz
        del csr
        x = randn(n, dtype)
        nbytes = (len(a.offsets) + 2) * n * a.data.element_size()
        k_ms, p_ms, l_ms = in_turns(lambda: dia_spmv(a, x),
                                    lambda: dia_spmv_kernel(a, x),
                                    lambda: lib_a @ x)
        record("dia_spmv", dtype, k_ms, p_ms, l_ms, nbytes, 2 * nnz,
               "torch.sparse_csr_tensor @ x (cuSPARSE SpMV), stencil order")
        del lib_a

        def plain_chain():
            y = x
            for _ in range(50):
                y = dia_spmv(a, y) * 0.125
            return y

        # one launch reads the operator, x and y once: the bound of the
        # whole chain, not of a step
        c_ms, pc_ms, _ = in_turns(
            plain_chain, lambda: dia_spmv_chain(a, x, 50, alpha=0.125))
        record("dia_spmv_chain", dtype, c_ms, pc_ms, None, nbytes,
               50 * (2 * nnz + n), "none")
        print(f"phase 5 time [{card}] dia_spmv_chain {dtype} k=50: "
              f"{c_ms / 50:.4f} ms/step (previous design (PERF.md), f32: "
              f"0.0532 ms/step)", flush=True)
        del a, x

    # CG's vector kernels at cg-grid's length in f64, each in turns with
    # its plain version, on a state that never stops (target 0); bytes:
    # the vectors each reads and writes once
    n_c = 216 ** 3
    xc, rc, pc, qc, sc = cg_step_vectors(dev, sgen, n_c, f64)
    for name, kernel, plain, passes, flops in (
            ("cg_pq", lambda: cg_step.cg_pq(pc, qc, sc),
             lambda: cg_step.cg_pq_plain(pc, qc, sc), 2, 2),
            ("cg_update", lambda: cg_step.cg_update(xc, rc, pc, qc, sc),
             lambda: cg_step.cg_update_plain(xc, rc, pc, qc, sc), 6, 6),
            ("cg_direction", lambda: cg_step.cg_direction(pc, rc, sc),
             lambda: cg_step.cg_direction_plain(pc, rc, sc), 3, 2)):
        k_ms, p_ms, _ = in_turns(plain, kernel)
        record(name, f64, k_ms, p_ms, None, passes * n_c * 8, flops * n_c,
               "none")
    require(not sc[cg_step.STOP] and all(
        bool(torch.isfinite(v).all()) for v in (xc, rc, pc)),
        "cg_step timing left the state stopped or non-finite")
    del xc, rc, pc, qc, sc

    def median_ms(f):
        return statistics.median(samples_ms(f) + samples_ms(f))

    # kernel A's multi-RHS form at FEAST's m = 80, at m = 16 and, at
    # 1024**2, at m = 160 (FEAST's complex refinement residual as a real
    # block), both layouts; bytes: the diagonals, X and Y once.  The
    # 1024**2 f64 m = 80 column-major reading is FEAST's shape and goes to
    # the JSON line.
    dia_spmm_readings = []
    for g_s in (1024, 2048):
        for dtype in (f32, f64):
            csr = poisson_2d(g_s, dtype=dtype, device=dev)
            a = csr_to_dia(csr)
            lib_a = library_csr(csr)
            nnz = csr.nnz
            del csr
            n_s = g_s * g_s
            item = a.data.element_size()
            for m in (80, 16, 160) if g_s == 1024 else (80, 16):
                x = randn(n_s * m, dtype, fgen).reshape(n_s, m)
                xp = x.T.contiguous()
                nbytes = (len(a.offsets) * n_s + 2 * n_s * m) * item
                k_ms, p_ms, l_ms = in_turns(lambda: dia_spmm(a, x),
                                            lambda: dia_spmm_kernel(a, x),
                                            lambda: lib_a @ x)
                kp_ms, pp_ms, _ = in_turns(
                    lambda: dia_spmm_planes(a, xp),
                    lambda: dia_spmm_planes_kernel(a, xp))
                b_ms, b_by = bound(nbytes, 2 * nnz * m, dtype)
                case = f"poisson_2d({g_s}) m={m} {dtype}"
                dia_spmm_readings.append({
                    "case": case, "ms": k_ms,
                    "plain_ms": p_ms, "planes_ms": kp_ms,
                    "planes_plain_ms": pp_ms, "library_ms": l_ms,
                    "bound_ms": b_ms, "bound_by": b_by})
                prev = PREVIOUS_MS.get(f"dia_spmm {case}")
                prev = "not measured" if prev is None else \
                    f"column-major {prev[0]:.4f} ms, plane-major {prev[1]:.4f} ms"
                print(f"phase 5 time [{card}] dia_spmm poisson_2d({g_s}) "
                      f"{dtype} m={m}: column-major {k_ms:.4f} ms "
                      f"({nbytes / k_ms / 1e6:.1f} GB/s, plain {p_ms:.4f}), "
                      f"plane-major {kp_ms:.4f} ms (plain {pp_ms:.4f}), bound "
                      f"{b_ms:.4f} ms by {b_by} ({b_ms / k_ms:.1%} of it "
                      f"reached column-major, {b_ms / kp_ms:.1%} plane-major),"
                      f" library (cuSPARSE SpMM, X (n, {m}) row-major) "
                      f"{l_ms:.4f} ms; previous design (PERF.md): {prev}",
                      flush=True)
                if (g_s, m) == (1024, 80):
                    record("dia_spmm", dtype, k_ms, p_ms, l_ms, nbytes,
                           2 * nnz * m, f"torch.sparse_csr_tensor @ X "
                           f"(cuSPARSE SpMM), X (n, {m}) row-major")
                del x, xp
            del a, lib_a
            torch.cuda.empty_cache()

    def time_spmm(name, label, w, lib, nnz, xp):
        """Kernel D on one operator and X: the column-major well_spmm is
        kernel D alone (it reads X (nc, m) and writes Y (nr, m) as they
        lie); well_spmm_planes (planes_ms) adds the copy of its (m, nc)
        planes to that layout.  The library is cuSPARSE SpMM with X (n, m)
        row- and column-major, the faster.  Bytes: the A stream once
        (slots (itemsize + 4) + slice_ptr), X and Y; the gather floor of a
        numbering without reuse counts X once per slot instead."""
        m, item = xp.shape[0], w.vals.element_size()
        xc = xp.T.contiguous()
        xcm = xp.T  # (n, m) with column-major strides
        lib_row, note = library_call(lib, xc)
        lib_col, _ = library_call(lib, xcm)
        k_ms, p_ms, l_row = in_turns(lambda: well_spmm_planes_plain(w, xp),
                                     lambda: well_spmm(w, xc), lib_row)
        l_col = None if lib_col is None else median_ms(lib_col)
        planes_ms = median_ms(lambda: well_spmm_planes(w, xp))
        copy_ms = median_ms(lambda: xp.T.contiguous())
        a_bytes = w.cols.shape[0] * (item + 4) + w.slice_ptr.numel() * 8
        mbytes = a_bytes + (w.shape[0] + w.shape[1]) * m * item
        gather_ms = (a_bytes + w.cols.shape[0] * m * item
                     + w.shape[0] * m * item) / HBM_BYTES_PER_S * 1e3
        libs = [v for v in (l_row, l_col) if v is not None]
        record(name, w.dtype, k_ms, p_ms, min(libs) if libs else None,
               mbytes, term_flops(w.dtype) * nnz * m,
               f"torch.sparse_csr_tensor @ X (cuSPARSE SpMM), X (n, {m}) "
               f"{'row' if l_col is None or l_row <= l_col else 'column'}"
               f"-major, the faster" if libs else note)
        t = times[f"{name} {w.dtype}"]
        t.update(planes_ms=planes_ms, copy_ms=copy_ms,
                 case=f"{label} m={m} {w.dtype}")
        print(f"phase 5 well_spmm {label} {w.dtype} m={m}: well_spmm_planes (X "
              f"copied to (nc, m), then kernel D) {planes_ms:.4f} ms, of "
              f"which the copy alone {copy_ms:.4f} ms; "
              f"library X row-major {l_row}, column-major {l_col} ms "
              f"({note}); {mbytes / 1e6:.1f} MB per call; gather "
              f"floor (X once a slot) {gather_ms:.4f} ms", flush=True)
        return t

    @contextlib.contextmanager
    def geometry(lanes, chunks):
        """Kernel D launched with (lanes a row, chunks a lane) in place of
        the geometry _spmm_plan picks."""
        chosen = spmv_well_module._spmm_plan
        spmv_well_module._spmm_plan = lambda *_: (lanes, chunks)
        try:
            yield
        finally:
            spmv_well_module._spmm_plan = chosen

    def time_geometry(w):
        """Kernel D under _spmm_plan's geometry and under another, on the
        same X, in turns, bitwise equal: each lane width of the scalar path
        (one value a lane, m * itemsize not a multiple of 16) against the
        widest, one 128-byte run a row, which could serve every such m with
        the rest of m tiled; and plane-major m = 80 at its cap of two chunks
        a lane against five, one pass."""
        plan = getattr(spmv_well_module, "_spmm_plan", None)
        if plan is None:
            print("phase 5 geometry: the package picks no geometry by m "
                  "(no _spmm_plan); skipped", flush=True)
            return
        item = w.vals.element_size()
        widest = 128 // item
        cases = [(m, False, (widest, 1)) for m in (1, 2, 3, 5, 13, 31)
                 if m * item % 16 and m <= widest]
        cases.append((80, True, (8, -(-80 * item // 128))))
        for m, planes, other in cases:
            xp = randn(m * n, w.dtype, xgen).reshape(m, n)
            xc = None if planes else xp.T.contiguous()

            def run():
                return well_spmm_planes(w, xp) if planes else well_spmm(w, xc)

            def run_other():
                with geometry(*other):
                    return run()

            chosen = plan(m, item, m * item % 16 == 0, planes)
            form = "planes" if planes else "column-major"
            if chosen == other:
                print(f"phase 5 geometry [{card}] well_spmm {form} {w.dtype} "
                      f"m={m}: _spmm_plan (lanes, chunks) {chosen}, the "
                      f"widest, {median_ms(run):.4f} ms", flush=True)
                continue
            same = torch.equal(run(), run_other())
            a = samples_ms(run)
            b = samples_ms(run_other) + samples_ms(run_other)
            a += samples_ms(run)
            print(f"phase 5 geometry [{card}] well_spmm {form} {w.dtype} "
                  f"m={m}: _spmm_plan (lanes, chunks) {chosen} "
                  f"{statistics.median(a):.4f} ms, {other} "
                  f"{statistics.median(b):.4f} ms, bitwise equal {same}",
                  flush=True)
            require(same, f"kernel D m={m} differs between geometries")

    # kernels C and D on the permuted 2048**2 operator.  Bytes: the stored
    # slots (value + int32 column) + slice_ptr + x + y, for D the A stream
    # once plus X and Y; nnz (itemsize + 4) is printed beside them so the
    # padding's share shows.  Kernel D also at FEAST's m = 80, at small m,
    # and on the stencil-order operator packed as WELL, with inputs from
    # xgen so that phase 6 keeps its draws.
    m_rhs, m_wide = 16, 80
    readings, more_m = [], {}
    for dtype in (f32, f64):
        csr = permuted_csr(g, dtype)
        w = st.csr_to_well(csr)
        lib_c = library_csr(csr)
        nnz = csr.nnz
        del csr
        item = w.vals.element_size()
        a_bytes = w.cols.shape[0] * (item + 4) + w.slice_ptr.numel() * 8
        x = randn(n, dtype, wgen)
        nbytes = a_bytes + 2 * n * item
        k_ms, p_ms, l_ms = in_turns(lambda: well_spmv_plain(w, x),
                                    lambda: well_spmv(w, x),
                                    lambda: lib_c @ x)
        record("well_spmv", dtype, k_ms, p_ms, l_ms, nbytes, 2 * nnz,
               "torch.sparse_csr_tensor @ x (cuSPARSE SpMV), permuted")
        # kernel D's gather floor at m = 1: x read once a slot (a numbering
        # without reuse), computed, not measured
        floor_ms = (a_bytes + w.cols.shape[0] * item + n * item) \
            / HBM_BYTES_PER_S * 1e3
        print(f"phase 5 well_spmv {dtype}: {nbytes / 1e6:.1f} MB per call "
              f"(slots {a_bytes / 1e6:.1f} MB, nnz * (itemsize + 4) "
              f"{nnz * (item + 4) / 1e6:.1f} MB); gather floor (x once a "
              f"slot) {floor_ms:.4f} ms, {floor_ms / k_ms:.1%} of it reached",
              flush=True)
        del x
        xp = randn(m_rhs * n, dtype, wgen).reshape(m_rhs, n)
        time_spmm("well_spmm", "permuted", w, lib_c, nnz, xp)
        del xp
        xp = randn(m_wide * n, dtype, xgen).reshape(m_wide, n)
        readings.append(dict(time_spmm(f"well_spmm m={m_wide}", "permuted",
                                       w, lib_c, nnz, xp)))
        del xp
        torch.cuda.empty_cache()
        # small m, and m = 96, past the five chunks a lane holds in f64
        for m in (1, 5, 8, 96):
            xp = randn(m * n, dtype, xgen).reshape(m, n)
            xc = xp.T.contiguous()
            col_ms = median_ms(lambda: well_spmm(w, xc))
            planes_ms = median_ms(lambda: well_spmm_planes(w, xp))
            more_m[f"permuted m={m} {dtype}"] = {"ms": col_ms,
                                                 "planes_ms": planes_ms}
            print(f"phase 5 time [{card}] well_spmm permuted {dtype} m={m}: "
                  f"kernel {col_ms:.4f} ms, well_spmm_planes {planes_ms:.4f} "
                  f"ms", flush=True)
            del xp, xc
        time_geometry(w)
        del w, lib_c
        csr = poisson_2d(g, dtype=dtype, device=dev)
        w = st.csr_to_well(csr)
        lib_s = library_csr(csr)
        nnz = csr.nnz
        del csr
        xp = randn(m_rhs * n, dtype, xgen).reshape(m_rhs, n)
        readings.append(dict(time_spmm("well_spmm stencil", "stencil order",
                                       w, lib_s, nnz, xp)))
        del w, lib_s, xp
        torch.cuda.empty_cache()

    t_parts["phase 5 complex"] = time.perf_counter()
    # the complex instantiations, on phase 9's operators: kernel A on the
    # gauge operator at 2048**2, its multi-RHS form at 1024**2 and m = 80
    # (FEAST's shape), kernels C and D on the gauge operator permuted at
    # 2048**2 (D at m = 16, and at m = 80 in c128 under two geometries);
    # bytes at the complex item size, 8 flops a complex term
    cgen = torch.Generator(device=dev).manual_seed(args.seed + 8)

    def crandn(shape, dtype):
        return torch.randn(shape, dtype=dtype, device=dev, generator=cgen)

    gauge = gauge_kron(g, THETA, dev)
    pgauge, _ = permuted(gauge, cgen)
    for dtype in (c64, c128):
        csr = gauge.map_values(lambda v: v.to(dtype))
        a, lib_a, nnz = csr_to_dia(csr), library_csr(csr), csr.nnz
        del csr
        item = a.data.element_size()
        x = crandn(n, dtype)
        lib_call, note = library_call(lib_a, x)
        k_ms, p_ms, l_ms = in_turns(lambda: dia_spmv(a, x),
                                    lambda: dia_spmv_kernel(a, x), lib_call)
        record("dia_spmv", dtype, k_ms, p_ms, l_ms,
               (len(a.offsets) + 2) * n * item, 8 * nnz,
               f"torch.sparse_csr_tensor @ x (cuSPARSE SpMV), gauge "
               f"operator ({note})")
        del a, lib_a, x
        g_s, m = 1024, 80
        n_s = g_s * g_s
        csr = gauge_kron(g_s, THETA, dev).map_values(lambda v: v.to(dtype))
        a, lib_a, nnz = csr_to_dia(csr), library_csr(csr), csr.nnz
        del csr
        x = crandn((n_s, m), dtype)
        xp = x.T.contiguous()
        lib_call, note = library_call(lib_a, x)
        nbytes = (len(a.offsets) * n_s + 2 * n_s * m) * item
        k_ms, p_ms, l_ms = in_turns(lambda: dia_spmm(a, x),
                                    lambda: dia_spmm_kernel(a, x), lib_call)
        kp_ms, pp_ms, _ = in_turns(lambda: dia_spmm_planes(a, xp),
                                   lambda: dia_spmm_planes_kernel(a, xp))
        record("dia_spmm", dtype, k_ms, p_ms, l_ms, nbytes, 8 * nnz * m,
               f"torch.sparse_csr_tensor @ X (cuSPARSE SpMM), X (n, {m}) "
               f"row-major ({note})")
        b_ms = times[f"dia_spmm {dtype}"]["bound_ms"]
        print(f"phase 5 time [{card}] dia_spmm gauge {g_s}^2 {dtype} m={m}: "
              f"plane-major {kp_ms:.4f} ms ({b_ms / kp_ms:.1%} of the bound; "
              f"plain {pp_ms:.4f} ms)", flush=True)
        del a, lib_a, x, xp
        csr = pgauge.map_values(lambda v: v.to(dtype))
        w, lib_c, nnz = st.csr_to_well(csr), library_csr(csr), csr.nnz
        del csr
        a_bytes = w.cols.shape[0] * (item + 4) + w.slice_ptr.numel() * 8
        x = crandn(n, dtype)
        lib_call, note = library_call(lib_c, x)
        k_ms, p_ms, l_ms = in_turns(lambda: well_spmv_plain(w, x),
                                    lambda: well_spmv(w, x), lib_call)
        record("well_spmv", dtype, k_ms, p_ms, l_ms, a_bytes + 2 * n * item,
               8 * nnz, f"torch.sparse_csr_tensor @ x (cuSPARSE SpMV), "
               f"permuted gauge operator ({note})")
        del x
        time_spmm("well_spmm", "permuted gauge", w, lib_c, nnz,
                  crandn((m_rhs, n), dtype))
        if dtype == c128:
            # five chunks a lane (the plan at m = 80) spill 20 bytes under
            # -Xptxas -v at 128 registers; four do not: both, in turns
            time_spmm(f"well_spmm m={m_wide}", "permuted gauge", w, lib_c,
                      nnz, crandn((m_wide, n), dtype))
            xc = crandn((n, m_wide), dtype)

            def run():
                return well_spmm(w, xc)

            def run_other():
                with geometry(8, 4):
                    return run()

            chosen = spmv_well_module._spmm_plan(m_wide, 16, True, False)
            same = torch.equal(run(), run_other())
            t_a = samples_ms(run)
            t_b = samples_ms(run_other) + samples_ms(run_other)
            t_a += samples_ms(run)
            print(f"phase 5 geometry [{card}] well_spmm column-major {dtype} "
                  f"m={m_wide}: _spmm_plan (lanes, chunks) {chosen} "
                  f"{statistics.median(t_a):.4f} ms, (8, 4) "
                  f"{statistics.median(t_b):.4f} ms, bitwise equal {same}",
                  flush=True)
            require(same, "complex kernel D differs between geometries")
            del xc
        del w, lib_c
        torch.cuda.empty_cache()
    del gauge, pgauge
    torch.cuda.empty_cache()

    # ------------------------------------ 6. slice-2 main path, full size
    t_parts["phase 6"] = time.perf_counter()
    marks = list(t_parts.items())
    print("phases 3-5 wall: " + ", ".join(
        f"{name} {t1 - t0:.1f} s" for (name, t0), (_, t1)
        in zip(marks, marks[1:])), flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    well_spmv.launches = 0
    well_spmm.launches = 0
    # phase 11 rebuilds this phase's operator from the same draws
    wgen_state = wgen.get_state()
    t_main = time.perf_counter()
    rows, cols, vals = poisson_triples(g, wgen)
    perm = torch.randperm(n, device=dev, generator=wgen).to(torch.int32)
    rows, cols = perm[rows], perm[cols]
    del perm
    n_triples = rows.shape[0]
    t0 = time.perf_counter()
    csr = st.from_triples((n, n), rows, cols, vals).tocsr()
    del rows, cols, vals
    require(st.check_matrix(csr), "check_matrix (permuted)")
    kind = st.recommend_format(csr)
    require(kind == "well", f"recommend_format said {kind!r}, not 'well'")
    w = st.to_fast_format(csr)
    torch.cuda.synchronize()
    assemble_s = time.perf_counter() - t0
    require(isinstance(w, st.WELL) and w.dtype == f64, "to_fast_format")
    print(f"phase 6 assemble: {n_triples} permuted triples -> CSR nnz "
          f"{csr.nnz} -> recommend_format {kind!r} -> WELL capacity "
          f"{w.cols.shape[0]} fill {w.fill:.4f} c_max {w.c_max} in "
          f"{assemble_s:.3f} s", flush=True)
    require(csr.nnz == 5 * n - 4 * g, f"permuted operator nnz {csr.nnz}")

    b = randn(n, f64, wgen)
    t0 = time.perf_counter()
    res = cg(w.__matmul__, b, tol=1e-10, maxiter=40_000)
    torch.cuda.synchronize()
    cg_s = time.perf_counter() - t0
    bnorm = float(torch.linalg.vector_norm(b))
    true_res = float(torch.linalg.vector_norm(b - st.spmv(csr, res.x))) / bnorm
    cg_res = float(res.residual_norm) / bnorm
    well_its = res.iterations
    print(f"phase 6 cg f64 permuted 2048^2 through WELL: {well_its} "
          f"iterations (DIA, phase 4: {cg_its}; {res.launched} queued, "
          f"{res.host_reads} host reads), recursive residual "
          f"{cg_res:.3e}, true residual (CSR spmv) {true_res:.3e} (tol 1e-9), "
          f"{cg_s:.3f} s, {cg_s / max(well_its, 1) * 1e3:.4f} ms/iteration",
          flush=True)
    require(res.converged, "cg (WELL) did not converge")
    require(bool(torch.isfinite(res.x).all()), "cg (WELL) returned non-finite")
    require(true_res <= 1e-9, f"true residual (WELL) {true_res}")
    b_phase6 = b.cpu()  # phase 12 solves it again over a mesh
    well_ms6 = cg_s / max(well_its, 1) * 1e3
    del b, res

    xp = randn(m_rhs * n, f64, wgen).reshape(m_rhs, n)
    t0 = time.perf_counter()
    y = well_spmm_planes(w, xp)
    torch.cuda.synchronize()
    spmm_s = time.perf_counter() - t0
    ref = torch.cat([well_spmm_planes_plain(w, xp[t:t + 4])
                     for t in range(0, m_rhs, 4)])
    _, spmm_rel = max_err(y, ref)
    print(f"phase 6 well_spmm_planes f64 m={m_rhs}: {spmm_s * 1e3:.3f} ms "
          f"(first call), max rel err against plain {spmm_rel:.3e} (tol "
          f"1e-12), digest {digest(y)}", flush=True)
    require(y.shape == (m_rhs, n) and spmm_rel <= 1e-12, "16-RHS block")
    del xp, y, ref, w, csr

    # staged SpGEMM A @ A of the permuted 1024**2 operator: three launches
    # of kernel C per numeric phase, against the sort-based form
    a1 = permuted_csr(1024, f64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = spgemm_plan_well(a1, a1)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    c = spgemm_apply_well(plan, a1.data, a1.data)
    torch.cuda.synchronize()
    numeric_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    c_ref = spgemm(a1, a1)
    torch.cuda.synchronize()
    sort_s = time.perf_counter() - t0
    same = (torch.equal(c.indptr.long(), c_ref.indptr.long())
            and torch.equal(c.indices, c_ref.indices))
    _, sg_rel = max_err(c.data, c_ref.data)
    print(f"phase 6 staged spgemm permuted 1024^2 A @ A: {plan.t_products} "
          f"products -> nnz {plan.nnz_out}; plan {plan_s:.3f} s, numeric "
          f"{numeric_s * 1e3:.3f} ms (3 well_spmv launches), sort-based "
          f"spgemm {sort_s * 1e3:.3f} ms; same pattern {same}, max rel err "
          f"{sg_rel:.3e} (tol 1e-12)", flush=True)
    require(same, "staged spgemm pattern differs from the sort-based one")
    require(sg_rel <= 1e-12, f"staged spgemm values disagree: {sg_rel}")
    require(st.check_matrix(c), "check_matrix (spgemm)")
    del a1, plan, c, c_ref
    torch.cuda.synchronize()
    main2_s = time.perf_counter() - t_main
    launches["well_spmv"] = well_spmv.launches
    launches["well_spmm"] = well_spmm.launches
    peak2_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"phase 6 main path: {main2_s:.3f} s wall, launches "
          f"well_spmv {launches['well_spmv']} well_spmm "
          f"{launches['well_spmm']}, peak device memory {peak2_gb:.3f} GB",
          flush=True)
    require(launches["well_spmv"] >= well_its + 3,
            f"well_spmv launches {launches['well_spmv']} < {well_its} "
            "iterations + 3")
    require(launches["well_spmm"] >= 1, "main path launched no well_spmm")
    require(peak2_gb < 5.0, f"peak device memory {peak2_gb} GB")
    torch.cuda.empty_cache()

    # ------------------------------------------- 7. direct solver, full size
    # artifacts phases 7 and 8 keep on the host for phase 11's checkpoints
    kept = {}
    direct = direct_solver_phase(dev, card, args.seed, keep=kept)

    # ------------------------------------------------- 8. FEAST, full size
    feast = feast_phase(dev, card, args.seed, keep=kept)
    launches["dia_spmm"] = dia_spmm_kernel.launches

    # --------------------------------------- 9. complex Hermitian, full size
    complex_rows, complex_launches, _ = complex_phase(
        dev, card, args.seed, b_phase4, cg_its, well_its)
    launches.update(complex_launches)

    # ------------------------------------------ 10. Chebyshev, full size
    cheb_rows, cheb_launches = chebyshev_phase(dev, card, args.seed,
                                               parity_abs)

    # ----------------------------------- 11. checkpoints and profiling
    def phase6_operator():
        """Phase 6's permuted operator, from phase 6's random state."""
        g6 = torch.Generator(device=dev)
        g6.set_state(wgen_state)
        rows, cols, vals = poisson_triples(g, g6)
        perm = torch.randperm(n, device=dev, generator=g6).to(torch.int32)
        return st.from_triples((n, n), perm[rows], perm[cols], vals).tocsr()

    # phase 11 takes phase 7's factors out of ``kept``; phase 12 reads them
    cholesky = kept["cholesky"]
    ckpt_rows = checkpoint_phase(dev, card, args.seed, kept, phase6_operator,
                                 cheb_rows)

    # ---------------------------------------------- 12. multi-device paths
    multi = multidevice_phase(dev, card, args.seed, {
        "b4": b_phase4, "cg_its": cg_its, "cg_ms": cg_ms4, "b6": b_phase6,
        "well_its": well_its, "well_ms": well_ms6,
        "well_csr": phase6_operator, "cholesky": cholesky,
        "factor_s": direct[0]["factor_s"], "feast": kept["feast"]},
        parity_abs)
    del cholesky

    # ------------------------------------------------- 13. walkthroughs
    torch.cuda.empty_cache()
    walkthroughs = walkthrough_phase(card)

    def entry_of(name, dtype, replaces, launches_of, err, shape, also=(),
                 label=None):
        t = times[f"{name} {dtype}"]
        out = {"name": label or name, "route": "cuda",
               "source": SPMV_SOURCE if name.startswith("dia") else
               WELL_SOURCE, "replaces": replaces}
        if also:
            out["also_replaces"] = list(also)
        out.update({"launches": launches[launches_of], "max_abs_err": err,
                    "ms": t["ms"], "plain_ms": t["plain_ms"],
                    "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                    "bound_share": t["bound_share"],
                    "library_ms": t["library_ms"], "library": t["library"],
                    "shape": shape})
        if "planes_ms" in t:
            out["planes_ms"] = t["planes_ms"]
            out["copy_ms"] = t["copy_ms"]
        return out

    spmm_entry = entry_of(
        "well_spmm", f64, f"{PALLAS_WELL}:335", "well_spmm",
        max(v for k, v in parity_abs.items()
            if k == f"well_spmm permuted 2048^2 {f64} m=16"
            or k.startswith("phase 12 (h) spmm_sharded well")),
        "permuted poisson 2048^2 f64, m=16, kernel D alone (column-major "
        "X); planes_ms adds well_spmm_planes' copy, L2 flushed; "
        "max_abs_err also over phase 12 (h)'s WELL slabs at m=80",
        (f"{PALLAS_WELL}:385", f"{PALLAS_WELL64}:284"))
    spmm_entry["readings"] = readings
    spmm_entry["more_m"] = more_m
    spmm_entry["launches_phase10"] = cheb_launches["well_spmm"]
    spmm_entry["launches_phase12h"] = multi["launches_h"]["well_spmm"]

    spmm_dia_entry = entry_of(
        "dia_spmm", f64, f"{XLA_SPMV}:45", "dia_spmm",
        max(v for k, v in parity_abs.items()
            if k.startswith("dia_spmm") and "float64" in k
            or k.startswith("phase 12 (h) spmm_sharded dia")),
        "poisson_2d(1024) f64, m=80 column-major X (FEAST's shape), L2 "
        "flushed; launches from the FEAST path (phase 8); max_abs_err also "
        "over phase 12 (h)'s DIA slabs; the XLA forms dia_spmm / "
        "dia_spmm_planes are not pallas_call sites",
        (f"{XLA_SPMV}:68",))
    spmm_dia_entry["readings"] = dia_spmm_readings
    spmm_dia_entry["launches_phase10"] = cheb_launches["dia_spmm"]
    spmm_dia_entry["launches_phase12"] = multi["launches"]["dia_spmm_kernel"]
    spmm_dia_entry["launches_phase12h"] = (
        multi["launches_h"]["dia_spmm_kernel"])

    def cg_entry(name):
        """A ``cg_step`` kernel's entry: its time at cg-grid's length,
        its launches in phase 4's CG."""
        t = times[f"{name} {f64}"]
        return {"name": name, "route": "cuda", "source": CG_SOURCE,
                "replaces": f"{JAX_CG}:76", "launches": cg_launches[name],
                "max_abs_err": cg_step_abs[name],
                **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                     "bound_share", "library_ms",
                                     "library")},
                "shape": "216^3 f64 vectors (cg-grid's length), L2 flushed; "
                         "launches from phase 4's CG; max_abs_err over "
                         "f32, f64, c64 and c128 at 2048^2 and f64 at "
                         "216^3; the JAX package's CG is one lax.while_loop "
                         "that XLA fuses"}

    def with12(entry, wrapper):
        """The entry with its kernel's launches on phase 12's path."""
        entry["launches_phase12"] = multi["launches"][wrapper]
        return entry

    print(f"chip_smoke.py: {time.perf_counter() - t_start:.1f} s wall, "
          f"build included", flush=True)
    print(json.dumps({"walkthroughs": walkthroughs, "card": card}))
    print(json.dumps({"multidevice": multi, "card": card}))
    print(json.dumps({"chebyshev": cheb_rows, "card": card}))
    print(json.dumps({"checkpoints": ckpt_rows, "card": card}))
    print(json.dumps({"feast": feast + complex_rows, "card": card}))
    print(json.dumps({"direct": direct, "card": card}))
    print(json.dumps({"kernels": [
        with12(entry_of("dia_spmv", f32, f"{PALLAS}:133", "dia_spmv",
                        max(parity_abs[f"poisson_2d(2048) {f32}"],
                            parity_abs[f"phase 12 dia_spmv_sharded halo "
                                       f"{f32}"],
                            parity_abs[f"phase 12 dia_spmv_sharded "
                                       f"allgather {f32}"]),
                        "poisson_2d(2048) f32, L2 flushed; max_abs_err also "
                        "over phase 12's sharded slabs",
                        (f"{PALLAS}:234",)), "dia_spmv_kernel"),
        entry_of("dia_spmv_chain", f32, f"{PALLAS}:370", "dia_spmv_chain",
                 chain_abs, "poisson_2d(2048) f32, k=50 per launch, bound "
                 "of one launch, L2 flushed"),
        with12(entry_of("well_spmv", f64, f"{PALLAS_WELL}:116", "well_spmv",
                        max(v for k, v in parity_abs.items()
                            if k == f"well_spmv permuted 2048^2 {f64}"
                            or k.startswith("phase 12 sharded well_spmv")),
                        "permuted poisson 2048^2 f64, L2 flushed; "
                        "max_abs_err also over phase 12's sharded slabs",
                        (f"{PALLAS_WELL64}:195",)), "well_spmv"),
        spmm_entry,
        spmm_dia_entry,
        entry_of("dia_spmv", c128, f"{XLA_SPMV}:29", "dia_spmv complex",
                 parity_abs[f"dia_spmv gauge 2048^2 {c128}"],
                 "gauge operator 2048^2 c128, L2 flushed; launches from "
                 "phase 9's DIA CG; the JAX package runs complex DIA through "
                 "this XLA form, not a pallas_call", label="dia_spmv_c128"),
        entry_of("dia_spmm", c128, f"{XLA_SPMV}:45", "dia_spmm complex",
                 max(v for k, v in parity_abs.items()
                     if k.startswith("dia_spmm") and k.endswith(str(c128))),
                 "gauge operator 1024^2 c128, m=80 column-major X (FEAST's "
                 "shape), L2 flushed; launches from phase 9's 1M-dof FEAST",
                 (f"{XLA_SPMV}:68",), label="dia_spmm_c128"),
        entry_of("well_spmv", c128, f"{PALLAS_WELL}:116", "well_spmv complex",
                 parity_abs[f"well_spmv permuted gauge 2048^2 {c128}"],
                 "permuted gauge operator 2048^2 c128, L2 flushed; launches "
                 "from phase 9's WELL CG (the JAX package: real plane "
                 "passes of this kernel)", (f"{PALLAS_WELL}:515",),
                 label="well_spmv_c128"),
        entry_of("well_spmm", c128, f"{PALLAS_WELL}:335", "well_spmm complex",
                 parity_abs[f"well_spmm permuted gauge 2048^2 m=16 {c128}"],
                 "permuted gauge operator 2048^2 c128, m=16, kernel D alone "
                 "(column-major X), L2 flushed; launches from phase 9's "
                 "192^2 WELL-route FEAST",
                 (f"{PALLAS_WELL}:385", f"{PALLAS_WELL}:515"),
                 label="well_spmm_c128"),
        cg_entry("cg_pq"),
        cg_entry("cg_update"),
        cg_entry("cg_direction"),
    ], "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
