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
   matrix with skewed rows).  Max relative error
   max|y - y_plain| / max|y_plain| <= 1e-5 in f32 and 1e-12 in f64 for the
   SpMV and SpMM kernels, <= 1e-4 for 50 chained f32 steps; the f64 WELL
   SpMV also meets ||y - y_csr|| / ||y_csr|| <= 1e-13 against the plain CSR
   SpMV at 1448**2.
4. Main path at full size, with the kernels' launch counts set to 0 before
   and read after: 2048**2 Poisson triples on the card -> from_triples ->
   tocsr -> check_matrix -> csr_to_dia; the top of the spectrum by power
   iteration through the one-launch chain (against the analytic value); CG
   in f64 to 1e-10, with the true residual through the plain CSR SpMV
   <= 1e-9; the entry step at grid 2048 in f32 against the plain version.
5. Times: each kernel and its plain version from CUDA events (median of 24,
   L2 flushed before each call), with GB/s, beside the card's name and
   power limit.
6. Slice-2 main path at full size, with the WELL kernels' launch counts set
   to 0 before and read after: the 2048**2 triples with their unknowns
   relabelled by a seeded permutation (an unstructured numbering) ->
   from_triples -> tocsr -> check_matrix -> recommend_format ("well") ->
   to_fast_format; CG in f64 to 1e-10 through W @ x, with the true residual
   through the plain CSR SpMV <= 1e-9; a 16-RHS f64 block through
   well_spmm_planes against the plain version; the staged SpGEMM A @ A of
   the permuted 1024**2 operator against the sort-based one (identical
   pattern, values within 1e-12); the peak device memory.

Prints one JSON line of the kernels, then as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises: the exit code
is then non-zero and the last line is not printed.  Without a CUDA device,
or without the package beside this script, it fails before any result.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SPMV_SOURCE = "sparse_linear_tpu_torch/csrc/dia_spmv.cu"
WELL_SOURCE = "sparse_linear_tpu_torch/csrc/well_spmv.cu"
PALLAS = "sparse_linear_tpu/kernels/spmv_pallas.py"
PALLAS_WELL = "sparse_linear_tpu/kernels/spmv_well.py"
PALLAS_WELL64 = "sparse_linear_tpu/kernels/spmv_well64.py"


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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    sys.path.insert(0, str(ROOT))
    import sparse_linear_tpu_torch as st
    from sparse_linear_tpu_torch.entry import entry
    from sparse_linear_tpu_torch.formats.structured import DIA, csr_to_dia
    from sparse_linear_tpu_torch.kernels import _build
    from sparse_linear_tpu_torch.kernels.spmv import dia_spmv
    from sparse_linear_tpu_torch.kernels.spmv_dia import (
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

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    # the WELL phases draw from their own stream, so that the slice-1
    # phases see the same random numbers as before them
    wgen = torch.Generator(device=dev).manual_seed(args.seed + 1)
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

    def random_dia(shape, offsets, dtype):
        nr, nc = shape
        i = torch.arange(nr, device=dev)
        data = torch.randn((len(offsets), nr), dtype=dtype, device=dev,
                           generator=gen)
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
    del a32, x, y, ref
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # WELL kernels C (SpMV) and D (SpMM) against their plain versions
    def check_well_spmv(label, w):
        x = randn(w.shape[1], w.dtype, wgen)
        y = well_spmv(w, x)
        ref = well_spmv_plain(w, x)
        torch.cuda.synchronize()
        err, rel = max_err(y, ref)
        print(f"phase 3 parity well_spmv {label}: shape {w.shape} capacity "
              f"{w.cols.shape[0]} fill {w.fill:.4f} c_max {w.c_max} max rel "
              f"err {rel:.3e} (max abs {err:.3e}, tol {tol[w.dtype]:.0e})",
              flush=True)
        require(rel <= tol[w.dtype], f"well_spmv {label} disagrees: {rel}")
        parity_abs[f"well_spmv {label}"] = err
        return x, y

    def check_well_spmm(label, w, m, column_major=False):
        xp = randn(m * w.shape[1], w.dtype, wgen).reshape(m, w.shape[1])
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

    for dtype in (f32, f64):
        w = st.csr_to_well(permuted_csr(2048, dtype))
        check_well_spmv(f"permuted 2048^2 {dtype}", w)
        for m in ((16, 5) if dtype == f32 else (16,)):
            check_well_spmm(f"permuted 2048^2 {dtype}", w, m)
        check_well_spmm(f"permuted 2048^2 {dtype}", w, 16, column_major=True)
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
    print(f"phase 3 skewed {nr_s}x{nc_s} f32: nnz {skew.nnz}, {n_empty} "
          f"empty rows, longest row {longest}", flush=True)
    # (duplicate columns of a long row are summed, so it may come out a
    # few entries short of 4096)
    require(n_empty > 0 and longest > 64, "skewed matrix lost its shape")
    w = st.csr_to_well(skew)
    del skew, row_len
    check_well_spmv(f"skewed {nr_s}x{nc_s} f32", w)
    check_well_spmm(f"skewed {nr_s}x{nc_s} f32", w, 5)
    del w
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ------------------------------------------- 4. main path, full size
    g = 2048
    n = g * g
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
    t0 = time.perf_counter()
    res = cg(dia.__matmul__, b, tol=1e-10, maxiter=40_000)
    torch.cuda.synchronize()
    cg_s = time.perf_counter() - t0
    bnorm = float(torch.linalg.vector_norm(b))
    true_res = float(torch.linalg.vector_norm(b - st.spmv(csr, res.x))) / bnorm
    cg_res = float(res.residual_norm) / bnorm
    print(f"phase 4 cg f64 2048^2: {res.iterations} iterations, recursive "
          f"residual {cg_res:.3e}, true residual (CSR spmv) {true_res:.3e} "
          f"(tol 1e-9), {cg_s:.3f} s, {cg_s / max(res.iterations, 1) * 1e3:.4f}"
          f" ms/iteration", flush=True)
    require(res.converged, "cg did not converge")
    require(bool(torch.isfinite(res.x).all()), "cg returned non-finite x")
    require(true_res <= 1e-9, f"true residual {true_res}")
    cg_its = res.iterations
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

    def in_turns(plain, kernel):
        """Plain, kernel, kernel, plain: the median of each over its 24
        calls in both turns."""
        p = samples_ms(plain)
        k = samples_ms(kernel) + samples_ms(kernel)
        p += samples_ms(plain)
        return statistics.median(k), statistics.median(p)

    times = {}
    for dtype in (f32, f64):
        a = poisson_2d(g, dtype=dtype, fmt="dia", device=dev)
        x = randn(n, dtype)
        nbytes = (len(a.offsets) + 2) * n * a.data.element_size()
        k_ms, p_ms = in_turns(lambda: dia_spmv(a, x),
                              lambda: dia_spmv_kernel(a, x))
        times[f"dia_spmv {dtype}"] = (k_ms, p_ms)
        print(f"phase 5 time [{card}] dia_spmv poisson_2d(2048) {dtype}: "
              f"kernel {k_ms:.4f} ms ({nbytes / k_ms / 1e6:.1f} GB/s), plain "
              f"{p_ms:.4f} ms ({nbytes / p_ms / 1e6:.1f} GB/s), "
              f"{nbytes / 1e6:.1f} MB per call", flush=True)
        if dtype == f32:
            def plain_chain():
                y = x
                for _ in range(50):
                    y = dia_spmv(a, y) * 0.125
                return y

            c_ms, pc_ms = in_turns(
                plain_chain, lambda: dia_spmv_chain(a, x, 50, alpha=0.125))
            times["dia_spmv_chain"] = (c_ms, pc_ms)
            print(f"phase 5 time [{card}] dia_spmv_chain poisson_2d(2048) "
                  f"f32 k=50: kernel {c_ms:.4f} ms per launch "
                  f"({c_ms / 50:.4f} ms/step, "
                  f"{50 * nbytes / c_ms / 1e6:.1f} GB/s), plain 50 steps "
                  f"{pc_ms:.4f} ms ({pc_ms / 50:.4f} ms/step, "
                  f"{50 * nbytes / pc_ms / 1e6:.1f} GB/s)", flush=True)
        del a, x

    # kernels C and D on the permuted 2048**2 operator.  Bytes: the stored
    # slots (value + int32 column) + slice_ptr + x + y, for D the A stream
    # once plus m (x + y); nnz (itemsize + 4) is printed beside them so the
    # padding's share shows.
    m_rhs = 16
    for dtype in (f32, f64):
        w = st.csr_to_well(permuted_csr(g, dtype))
        item = w.vals.element_size()
        a_bytes = w.cols.shape[0] * (item + 4) + w.slice_ptr.numel() * 8
        nnz_bytes = int((w.vals != 0).sum()) * (item + 4)
        x = randn(n, dtype, wgen)
        nbytes = a_bytes + 2 * n * item
        k_ms, p_ms = in_turns(lambda: well_spmv_plain(w, x),
                              lambda: well_spmv(w, x))
        times[f"well_spmv {dtype}"] = (k_ms, p_ms)
        print(f"phase 5 time [{card}] well_spmv permuted 2048^2 {dtype}: "
              f"kernel {k_ms:.4f} ms ({nbytes / k_ms / 1e6:.1f} GB/s), plain "
              f"{p_ms:.4f} ms ({nbytes / p_ms / 1e6:.1f} GB/s), "
              f"{nbytes / 1e6:.1f} MB per call (slots {a_bytes / 1e6:.1f} MB,"
              f" nnz * (itemsize + 4) {nnz_bytes / 1e6:.1f} MB)", flush=True)
        xp = randn(m_rhs * n, dtype, wgen).reshape(m_rhs, n)
        xc = xp.T.contiguous()
        mbytes = a_bytes + 2 * m_rhs * n * item
        k_ms, p_ms = in_turns(lambda: well_spmm_planes_plain(w, xp),
                              lambda: well_spmm_planes(w, xp))
        c_ms = statistics.median(samples_ms(lambda: well_spmm(w, xc))
                                 + samples_ms(lambda: well_spmm(w, xc)))
        times[f"well_spmm {dtype}"] = (k_ms, p_ms)
        print(f"phase 5 time [{card}] well_spmm_planes permuted 2048^2 "
              f"{dtype} m={m_rhs} (X copied to (nc, m), then kernel D): "
              f"{k_ms:.4f} ms ({mbytes / k_ms / 1e6:.1f} GB/s, "
              f"{k_ms / m_rhs:.4f} ms/RHS), plain {p_ms:.4f} ms "
              f"({mbytes / p_ms / 1e6:.1f} GB/s); column-major well_spmm "
              f"(kernel D alone) {c_ms:.4f} ms ({mbytes / c_ms / 1e6:.1f} "
              f"GB/s); {mbytes / 1e6:.1f} MB per call", flush=True)
        del w, x, xp, xc
    torch.cuda.empty_cache()

    # ------------------------------------ 6. slice-2 main path, full size
    torch.cuda.reset_peak_memory_stats(dev)
    well_spmv.launches = 0
    well_spmm.launches = 0
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
          f"iterations (DIA, phase 4: {cg_its}), recursive residual "
          f"{cg_res:.3e}, true residual (CSR spmv) {true_res:.3e} (tol 1e-9), "
          f"{cg_s:.3f} s, {cg_s / max(well_its, 1) * 1e3:.4f} ms/iteration",
          flush=True)
    require(res.converged, "cg (WELL) did not converge")
    require(bool(torch.isfinite(res.x).all()), "cg (WELL) returned non-finite")
    require(true_res <= 1e-9, f"true residual (WELL) {true_res}")
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
          f"1e-12)", flush=True)
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

    k32, p32 = times[f"dia_spmv {f32}"]
    kc, pc = times["dia_spmv_chain"]
    kw, pw = times[f"well_spmv {f64}"]
    km, pm = times[f"well_spmm {f64}"]
    print(json.dumps({"kernels": [
        {"name": "dia_spmv", "route": "cuda", "source": SPMV_SOURCE,
         "replaces": f"{PALLAS}:133",
         "also_replaces": [f"{PALLAS}:234"],
         "launches": launches["dia_spmv"],
         "max_abs_err": parity_abs[f"poisson_2d(2048) {f32}"],
         "ms": k32, "plain_ms": p32,
         "shape": "poisson_2d(2048) f32, L2 flushed"},
        {"name": "dia_spmv_chain", "route": "cuda", "source": SPMV_SOURCE,
         "replaces": f"{PALLAS}:370",
         "launches": launches["dia_spmv_chain"],
         "max_abs_err": chain_abs,
         "ms": kc, "plain_ms": pc,
         "shape": "poisson_2d(2048) f32, k=50 per launch, L2 flushed"},
        {"name": "well_spmv", "route": "cuda", "source": WELL_SOURCE,
         "replaces": f"{PALLAS_WELL}:116",
         "also_replaces": [f"{PALLAS_WELL64}:195"],
         "launches": launches["well_spmv"],
         "max_abs_err": parity_abs[f"well_spmv permuted 2048^2 {f64}"],
         "ms": kw, "plain_ms": pw,
         "shape": "permuted poisson 2048^2 f64, L2 flushed"},
        {"name": "well_spmm", "route": "cuda", "source": WELL_SOURCE,
         "replaces": f"{PALLAS_WELL}:335",
         "also_replaces": [f"{PALLAS_WELL}:385", f"{PALLAS_WELL64}:284"],
         "launches": launches["well_spmm"],
         "max_abs_err": parity_abs[f"well_spmm permuted 2048^2 {f64} m=16"],
         "ms": km, "plain_ms": pm,
         "shape": "permuted poisson 2048^2 f64, m=16 plane-major, "
                  "L2 flushed"},
    ], "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
