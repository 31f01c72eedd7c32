#!/usr/bin/env python3
"""Design probe for the port's Hopper kernels B, C and D on one NVIDIA GPU:

    python3 tools/torch_kernel_probe.py --out OUT_DIR/kernel_probe.json

Builds variants of the kernels with nvcc (``-Xptxas -v`` is written beside
the output) and times each against the port's own kernel on the same
inputs, in turns, with CUDA events, L2 flushed before each call (median of
24; 12 for the 50-step chains).  Every variant must give bitwise the port
kernel's result (it sums in the same order); the probe reports that too.

* Kernel C (WELL SpMV), permuted 2048**2 Poisson operator: which lever
  keeps the x gathers in L2 -- an ``evict_last`` policy on the gathers, an
  ``evict_first`` / ``L1::no_allocate`` policy or ``__ldcs`` on the
  ``vals``/``cols`` stream, ``__stcs`` on y -- and whether eight slots
  loaded before their gathers (more gathers in flight) add to it.
* Kernel D (WELL SpMM): one warp per 32-row slice with the lanes across a
  tile of TW right-hand sides, each row's (col, val) broadcast by
  ``__shfl_sync``, at m = 5, 16, 33.
* Kernel B (DIA chain, k = 50, 2048**2 Poisson): the earlier one row a thread,
  rows a thread loaded together, grid-stride or contiguous ranges per
  block, with and without the first rows of each range in shared memory.
* The library column: ``@`` on a ``torch.sparse_csr_tensor`` (cuSPARSE) of
  the stencil-order and the permuted operator, X row- and column-major.

Prints the card's name and power limit first.  Needs a CUDA device and
nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SRC = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>
namespace cg = cooperative_groups;

__device__ __forceinline__ uint64_t pol_first() {
  uint64_t p; asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p)); return p; }
__device__ __forceinline__ uint64_t pol_last() {
  uint64_t p; asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p)); return p; }
__device__ __forceinline__ int ld_first(const int* a, uint64_t p) {
  int v; asm("ld.global.nc.L1::no_allocate.L2::cache_hint.b32 %0, [%1], %2;" : "=r"(v) : "l"(a), "l"(p)); return v; }
__device__ __forceinline__ float ld_first(const float* a, uint64_t p) {
  float v; asm("ld.global.nc.L1::no_allocate.L2::cache_hint.f32 %0, [%1], %2;" : "=f"(v) : "l"(a), "l"(p)); return v; }
__device__ __forceinline__ double ld_first(const double* a, uint64_t p) {
  double v; asm("ld.global.nc.L1::no_allocate.L2::cache_hint.f64 %0, [%1], %2;" : "=d"(v) : "l"(a), "l"(p)); return v; }
__device__ __forceinline__ float ld_last(const float* a, uint64_t p) {
  float v; asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;" : "=f"(v) : "l"(a), "l"(p)); return v; }
__device__ __forceinline__ double ld_last(const double* a, uint64_t p) {
  double v; asm("ld.global.nc.L2::cache_hint.f64 %0, [%1], %2;" : "=d"(v) : "l"(a), "l"(p)); return v; }

static unsigned blocks_for(int64_t rows) {
  int sms = 0; cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  long long want = (rows + 255) / 256, cap = (long long)sms * 16;
  return (unsigned)(want < cap ? want : cap);
}

// C.  MODE bits: 1 x under evict_last; 2 vals/cols under evict_first and
// L1::no_allocate; 4 vals/cols by __ldcs; 8 y by __stcs.  B slots of a row
// are loaded before their gathers (B = 1: the earlier one-slot loop).
template <typename T, int MODE, int B>
__global__ void __launch_bounds__(256) spmv(const int64_t* __restrict__ sp,
    const int32_t* __restrict__ cols, const T* __restrict__ vals,
    const T* __restrict__ x, T* __restrict__ y, int64_t nr) {
  const uint64_t pf = (MODE & 2) ? pol_first() : 0;
  const uint64_t pl = (MODE & 1) ? pol_last() : 0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nr; i += stride) {
    const int64_t b0 = __ldg(sp + i / 32);
    const int w = (int)((__ldg(sp + i / 32 + 1) - b0) / 32);
    const int64_t base = b0 + i % 32;
    T acc = T(0);
    for (int k0 = 0; k0 < w; k0 += B) {
      int c[B]; T v[B], xv[B];
#pragma unroll
      for (int j = 0; j < B; ++j) {
        c[j] = 0; v[j] = T(0);
        if (k0 + j < w) {
          const int64_t p = base + 32 * (int64_t)(k0 + j);
          if (MODE & 2) { c[j] = ld_first(cols + p, pf); v[j] = ld_first(vals + p, pf); }
          else if (MODE & 4) { c[j] = __ldcs(cols + p); v[j] = __ldcs(vals + p); }
          else { c[j] = __ldg(cols + p); v[j] = __ldg(vals + p); }
        }
      }
#pragma unroll
      for (int j = 0; j < B; ++j) {
        xv[j] = T(0);
        if (k0 + j < w) xv[j] = (MODE & 1) ? ld_last(x + c[j], pl) : __ldg(x + c[j]);
      }
#pragma unroll
      for (int j = 0; j < B; ++j) if (k0 + j < w) acc += v[j] * xv[j];
    }
    if (MODE & 8) __stcs(y + i, acc); else y[i] = acc;
  }
}

// D: one warp per slice, lane l on right-hand side l % TW of row group l / TW.
template <typename T, int TW>
__global__ void __launch_bounds__(256) spmm(const int64_t* __restrict__ sp,
    const int32_t* __restrict__ cols, const T* __restrict__ vals,
    const T* __restrict__ x, T* __restrict__ y, int64_t nr, int64_t m,
    int64_t y_row, int64_t y_rhs) {
  constexpr int R = 32 / TW;
  const uint64_t pf = pol_first();
  const int lane = threadIdx.x & 31, t = lane % TW, h = lane / TW;
  const int64_t ns = (nr + 31) / 32;
  const int64_t warps = (int64_t)gridDim.x * (blockDim.x / 32);
  for (int64_t s = (int64_t)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32; s < ns; s += warps) {
    const int64_t b0 = __ldg(sp + s);
    const int w = (int)((__ldg(sp + s + 1) - b0) / 32);
    const int64_t base = b0 + lane;
    for (int64_t t0 = 0; t0 < m; t0 += TW) {
      const bool on = t0 + t < m;
      const T* xt = x + t0 + t;
      T acc[TW];
#pragma unroll
      for (int q = 0; q < TW; ++q) acc[q] = T(0);
      int c = 0; T v = T(0);
      if (w > 0) { c = ld_first(cols + base, pf); v = ld_first(vals + base, pf); }
      for (int k = 0; k < w; ++k) {
        int cn = 0; T vn = T(0);
        if (k + 1 < w) {
          const int64_t p = base + 32 * (int64_t)(k + 1);
          cn = ld_first(cols + p, pf); vn = ld_first(vals + p, pf);
        }
#pragma unroll
        for (int q = 0; q < TW; ++q) {
          const int cq = __shfl_sync(0xffffffffu, c, q * R + h);
          const T vq = __shfl_sync(0xffffffffu, v, q * R + h);
          if (on) acc[q] += vq * __ldg(xt + (int64_t)cq * m);
        }
        c = cn; v = vn;
      }
#pragma unroll
      for (int q = 0; q < TW; ++q) {
        const int64_t row = s * 32 + q * R + h;
        if (on && row < nr) y[row * y_row + (t0 + t) * y_rhs] = acc[q];
      }
    }
  }
}

// B, grid-stride: tiles of NT * R rows; thread t takes rows t, t + NT, ...
// and loads them for one diagonal together.  STREAM bit 1: operator by
// __ldcs; bit 2: x and the ping-pong vectors by __ldcg (L2 only, no L1).
template <typename T, int NT, int STREAM, int R, int MINB>
__global__ void __launch_bounds__(NT, MINB) chain_gs(const T* __restrict__ data,
    const int64_t* __restrict__ offsets, const T* x, T* buf0, T* buf1,
    int64_t ndiag, int64_t n, int k, T alpha, int64_t chunk, int64_t rs) {
  cg::grid_group grid = cg::this_grid();
  const T* src = x;
  for (int s = 0; s < k; ++s) {
    T* dst = (s & 1) ? buf1 : buf0;
    for (int64_t i0 = (int64_t)blockIdx.x * NT * R + threadIdx.x; i0 < n; i0 += (int64_t)gridDim.x * NT * R) {
      T acc[R];
#pragma unroll
      for (int q = 0; q < R; ++q) acc[q] = T(0);
      for (int64_t d = 0; d < ndiag; ++d) {
        const int64_t off = __ldg(offsets + d);
        T a[R], xv[R]; bool ok[R];
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const int64_t i = i0 + (int64_t)q * NT, j = i + off;
          ok[q] = i < n && j >= 0 && j < n;
          a[q] = T(0); xv[q] = T(0);
          if (ok[q]) { a[q] = (STREAM & 1) ? __ldcs(data + d * n + i) : __ldg(data + d * n + i); xv[q] = (STREAM & 2) ? __ldcg(src + j) : src[j]; }
        }
#pragma unroll
        for (int q = 0; q < R; ++q) if (ok[q]) acc[q] += a[q] * xv[q];
      }
#pragma unroll
      for (int q = 0; q < R; ++q) { const int64_t i = i0 + (int64_t)q * NT; if (i < n) dst[i] = alpha * acc[q]; }
    }
    if (s + 1 < k) grid.sync();
    src = dst;
  }
}

// B, contiguous: block b takes rows [b chunk, (b + 1) chunk); the first rs of
// them keep their diagonals in shared memory across all k steps.
template <typename T, int NT, int STREAM, int R, int MINB>
__global__ void __launch_bounds__(NT, MINB) chain_chunk(const T* __restrict__ data,
    const int64_t* __restrict__ offsets, const T* x, T* buf0, T* buf1,
    int64_t ndiag, int64_t n, int k, T alpha, int64_t chunk, int64_t rs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ds = reinterpret_cast<T*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  const int64_t row0 = (int64_t)blockIdx.x * chunk;
  const int64_t row1 = row0 + chunk < n ? row0 + chunk : n;
  const int64_t nres = rs < row1 - row0 ? rs : (row1 > row0 ? row1 - row0 : 0);
  for (int64_t d = 0; d < ndiag; ++d)
    for (int64_t r = threadIdx.x; r < nres; r += NT) ds[d * rs + r] = __ldcs(data + d * n + row0 + r);
  __syncthreads();
  const T* src = x;
  for (int s = 0; s < k; ++s) {
    T* dst = (s & 1) ? buf1 : buf0;
    for (int64_t i0 = row0 + threadIdx.x; i0 < row1; i0 += (int64_t)NT * R) {
      T acc[R];
#pragma unroll
      for (int q = 0; q < R; ++q) acc[q] = T(0);
      for (int64_t d = 0; d < ndiag; ++d) {
        const int64_t off = __ldg(offsets + d);
        T a[R], xv[R]; bool ok[R];
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const int64_t i = i0 + (int64_t)q * NT, j = i + off;
          ok[q] = i < row1 && j >= 0 && j < n;
          a[q] = T(0); xv[q] = T(0);
          if (ok[q]) {
            a[q] = i - row0 < nres ? ds[d * rs + i - row0]
                 : ((STREAM & 1) ? __ldcs(data + d * n + i) : __ldg(data + d * n + i));
            xv[q] = (STREAM & 2) ? __ldcg(src + j) : src[j];
          }
        }
#pragma unroll
        for (int q = 0; q < R; ++q) if (ok[q]) acc[q] += a[q] * xv[q];
      }
#pragma unroll
      for (int q = 0; q < R; ++q) { const int64_t i = i0 + (int64_t)q * NT; if (i < row1) dst[i] = alpha * acc[q]; }
    }
    if (s + 1 < k) grid.sync();
    src = dst;
  }
}

// CHUNKED 0: grid-stride over occupancy x SMs blocks; 1: one contiguous range
// per block, blocks_per_sm per SM, shared memory split between them if SMEM.
template <typename T, int NT, int STREAM, int R, int MINB, int CHUNKED, int SMEM>
int launch_chain(const void* data, const void* offsets, const void* x, void* b0, void* b1,
                 long long ndiag, long long n, int k, double alpha, void* stream) {
  int sms = 0, smem_sm = 0, optin = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaDeviceGetAttribute(&smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, 0);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, 0);
  auto kern = CHUNKED ? chain_chunk<T, NT, STREAM, R, MINB> : chain_gs<T, NT, STREAM, R, MINB>;
  long long blocks = (long long)sms * MINB, chunk = 0, rs = 0;
  size_t bytes = 0;
  if (CHUNKED) {
    if (blocks > n) blocks = n;
    chunk = (n + blocks - 1) / blocks;
    long long per_block = smem_sm / MINB - 1024;
    if (per_block > optin) per_block = optin;
    rs = SMEM ? (per_block & ~15LL) / (ndiag * (long long)sizeof(T)) : 0;
    if (rs > chunk) rs = chunk;
    bytes = rs * ndiag * sizeof(T);
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err) return err;
  }
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, bytes);
  if (err) return err;
  if (per_sm < MINB) return cudaErrorLaunchOutOfResources;
  if (!CHUNKED) {
    blocks = (long long)sms * per_sm;
    long long want = (n + (long long)NT * R - 1) / ((long long)NT * R);
    if (blocks > want) blocks = want;
  }
  const T* dp = (const T*)data; const int64_t* op = (const int64_t*)offsets; const T* xp = (const T*)x;
  T* p0 = (T*)b0; T* p1 = (T*)b1; int64_t nd = ndiag, nn = n, ch = chunk, r = rs; int kk = k; T al = (T)alpha;
  void* args[] = {&dp, &op, &xp, &p0, &p1, &nd, &nn, &kk, &al, &ch, &r};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3((unsigned)blocks), dim3(NT), args, bytes, (cudaStream_t)stream);
  if (err) return err;
  return cudaGetLastError();
}
"""

C_VARIANTS = {  # name: (MODE, B)
    "one_slot_loop": (0, 1), "x_evict_last": (1, 1),
    "x_evict_last+a_evict_first": (3, 1), "a_ldcs": (4, 1),
    "batch8": (0, 8), "batch8+a_evict_first": (2, 8),
    "batch8+a_ldcs+y_stcs": (12, 8),
}
D_VARIANTS = {"warp_slice_tw8": 8, "warp_slice_tw16": 16, "warp_slice_tw32": 32}
B_VARIANTS = {  # name: (NT, STREAM bits, R, MINB = blocks per SM, CHUNKED, SMEM)
    "one_row_a_thread": (256, 0, 1, 1, 0, 0),
    "gs_r2_256x4": (256, 1, 2, 4, 0, 0),
    "gs_r4_256x4": (256, 1, 4, 4, 0, 0),
    "gs_r4_256x4_ldcg": (256, 3, 4, 4, 0, 0),
    "gs_r4_1024x1": (1024, 1, 4, 1, 0, 0),
    "chunk_r1_1024x1": (1024, 1, 1, 1, 1, 0),
    "chunk_r1_1024x1_smem": (1024, 1, 1, 1, 1, 1),
    "chunk_r4_1024x1": (1024, 1, 4, 1, 1, 0),
    "chunk_r4_1024x1_smem": (1024, 1, 4, 1, 1, 1),
    "chunk_r4_1024x1_smem_ldcg": (1024, 3, 4, 1, 1, 1),
}


def source() -> str:
    out = [SRC, 'extern "C" {']
    for t, suf in (("float", "f32"), ("double", "f64")):
        for i, (mode, b) in enumerate(C_VARIANTS.values()):
            out.append(
                f"int c{i}_{suf}(const void* sp, const void* c, const void* v, "
                f"const void* x, void* y, long long nr, void* st) {{ spmv<{t}, "
                f"{mode}, {b}><<<blocks_for(nr), 256, 0, (cudaStream_t)st>>>("
                f"(const int64_t*)sp, (const int32_t*)c, (const {t}*)v, "
                f"(const {t}*)x, ({t}*)y, nr); return cudaGetLastError(); }}")
        for i, tw in enumerate(D_VARIANTS.values()):
            out.append(
                f"int d{i}_{suf}(const void* sp, const void* c, const void* v, "
                f"const void* x, void* y, long long nr, long long m, long long "
                f"yr, long long yc, void* st) {{ spmm<{t}, {tw}><<<blocks_for("
                f"nr), 256, 0, (cudaStream_t)st>>>((const int64_t*)sp, "
                f"(const int32_t*)c, (const {t}*)v, (const {t}*)x, ({t}*)y, "
                f"nr, m, yr, yc); return cudaGetLastError(); }}")
        for i, (nt, stream, r, minb, chunked, smem) in enumerate(
                B_VARIANTS.values()):
            out.append(
                f"int b{i}_{suf}(const void* d, const void* o, const void* x, "
                f"void* b0, void* b1, long long nd, long long n, int k, double "
                f"a, void* st) {{ return launch_chain<{t}, {nt}, {stream}, {r}, "
                f"{minb}, {chunked}, {smem}>(d, o, x, b0, b1, nd, n, k, a, st); }}")
    out.append("}")
    return "\n".join(out)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True,
                    help="JSON output; -Xptxas -v output goes beside it")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_probe: no CUDA device")
    sys.path.insert(0, str(ROOT))
    import sparse_linear_tpu_torch as st
    from sparse_linear_tpu_torch.formats.structured import csr_to_dia
    from sparse_linear_tpu_torch.kernels import _build
    from sparse_linear_tpu_torch.kernels.spmv_dia import dia_spmv_chain
    from sparse_linear_tpu_torch.kernels.spmv_well import well_spmm, well_spmv
    from sparse_linear_tpu_torch.utils.grids import poisson_2d

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    _build.load_library()
    tmp = Path(tempfile.mkdtemp())
    (tmp / "probe.cu").write_text(source())
    p = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-Xptxas", "-v",
         "-o", str(tmp / "probe.so"), str(tmp / "probe.cu")],
        capture_output=True, text=True)
    out_path.with_suffix(".ptxas.txt").write_text(p.stdout + p.stderr)
    if p.returncode:
        raise SystemExit(f"nvcc failed:\n{(p.stdout + p.stderr)[-4000:]}")
    lib = ctypes.CDLL(str(tmp / "probe.so"))
    stream = torch.cuda.current_stream(dev).cuda_stream
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)

    def samples(f, reps):
        for _ in range(3):
            f()
        ev = []
        for _ in range(reps):
            flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            f()
            e.record()
            ev.append((s, e))
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in ev]

    def in_turns(fs, reps=12):
        """Each function in order, then in reverse: median ms of each."""
        got = {k: [] for k in fs}
        for k in list(fs) + list(fs)[::-1]:
            got[k] += samples(fs[k], reps)
        return {k: statistics.median(v) for k, v in got.items()}

    def launcher(name, argtypes, *ptrs_then_ints):
        fn = getattr(lib, name)
        fn.argtypes = argtypes

        def call():
            code = fn(*ptrs_then_ints, stream)
            if code:
                raise RuntimeError(f"{name}: CUDA error {code}")
        return call

    def agreement(outs, want):
        """Whether each variant's result is bitwise the port's, and the
        largest difference relative to max |port|."""
        scale = max(float(want.abs().max()), 1e-300)
        return {"bitwise_equal": {k: bool(torch.equal(v, want))
                                  for k, v in outs.items()},
                "max_rel_diff": {k: float((v - want).abs().max()) / scale
                                 for k, v in outs.items()}}

    def sparse(csr):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            return torch.sparse_csr_tensor(
                csr.indptr.to(torch.int32), csr.indices.to(torch.int32),
                csr.data, csr.shape)

    P = ctypes.c_void_p
    I64 = ctypes.c_longlong
    gen = torch.Generator(device=dev).manual_seed(1)
    g, n = 2048, 2048 * 2048
    res = {"card": card}
    for dtype in (torch.float32, torch.float64):
        suf = "f32" if dtype == torch.float32 else "f64"
        x = torch.randn(n, dtype=dtype, device=dev, generator=gen)

        # ---- kernel B (and kernel A's library column)
        csr = poisson_2d(g, dtype=dtype, device=dev)
        dia = csr_to_dia(csr)
        lib_a = sparse(csr)
        del csr
        y0 = dia_spmv_chain(dia, x, 50, alpha=0.125)
        fs = {"port": lambda: dia_spmv_chain(dia, x, 50, alpha=0.125)}
        outs = {}
        for i, name in enumerate(B_VARIANTS):
            bufs = (torch.empty_like(x), torch.empty_like(x))
            outs[name] = bufs[1]  # k = 50: the last step writes buf1
            fs[name] = launcher(
                f"b{i}_{suf}", [P] * 5 + [I64, I64, ctypes.c_int,
                                          ctypes.c_double, P],
                dia.data.data_ptr(), dia.offsets_tensor.data_ptr(),
                x.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(),
                len(dia.offsets), n, 50, 0.125)
        t = in_turns(fs, reps=6)
        torch.cuda.synchronize()
        res[f"B k=50 {suf}"] = {"ms": t, **agreement(outs, y0)}
        res[f"A library {suf}"] = in_turns({"cusparse": lambda: lib_a @ x})
        print(json.dumps({f"B k=50 {suf}": res[f"B k=50 {suf}"],
                          f"A library {suf}": res[f"A library {suf}"]}),
              flush=True)
        del dia, lib_a, y0, outs, fs

        # ---- kernels C and D on the permuted operator
        coo = poisson_2d(g, dtype=dtype, device=dev).tocoo()
        perm = torch.randperm(n, device=dev, generator=gen)
        pcsr = st.from_triples((n, n), perm[coo.row.long()],
                               perm[coo.col.long()], coo.data).tocsr()
        del coo, perm
        w = st.csr_to_well(pcsr)
        lib_p = sparse(pcsr)
        del pcsr
        wptrs = (w.slice_ptr.data_ptr(), w.cols.data_ptr(),
                 w.vals.data_ptr())
        y0 = well_spmv(w, x)
        fs = {"port": lambda: well_spmv(w, x), "cusparse": lambda: lib_p @ x}
        outs = {}
        for i, name in enumerate(C_VARIANTS):
            outs[name] = torch.empty_like(y0)
            fs[name] = launcher(f"c{i}_{suf}", [P] * 5 + [I64, P], *wptrs,
                                x.data_ptr(), outs[name].data_ptr(), n)
        t = in_turns(fs)
        torch.cuda.synchronize()
        res[f"C {suf}"] = {"ms": t, **agreement(outs, y0)}
        print(json.dumps({f"C {suf}": res[f"C {suf}"]}), flush=True)
        for m in (16, 5, 33):
            xm = torch.randn((n, m), dtype=dtype, device=dev, generator=gen)
            y0 = well_spmm(w, xm)
            fs = {"port": lambda: well_spmm(w, xm)}
            if m == 16:
                xcm = xm.T.contiguous().T
                fs["cusparse_row_major"] = lambda: lib_p @ xm
                fs["cusparse_column_major"] = lambda: lib_p @ xcm
            outs = {}
            for i, name in enumerate(D_VARIANTS):
                outs[name] = torch.empty_like(y0)
                fs[name] = launcher(
                    f"d{i}_{suf}", [P] * 5 + [I64] * 4 + [P], *wptrs,
                    xm.data_ptr(), outs[name].data_ptr(), n, m, m, 1)
            t = in_turns(fs)
            torch.cuda.synchronize()
            res[f"D m={m} {suf}"] = {"ms": t, **agreement(outs, y0)}
            print(json.dumps({f"D m={m} {suf}": res[f"D m={m} {suf}"]}),
                  flush=True)
            del xm, y0, outs, fs
        del w, lib_p, x
        torch.cuda.empty_cache()
    out_path.write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
