// DIA SpMV kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// Kernel A, dia_spmv: y[i] = alpha * sum_d data[d, i] * x[i + off_d] over
// 0 <= i < nr, counting only terms with 0 <= i + off_d < nc.  It replaces
// both branches of the TPU dispatcher sparse_linear_tpu/kernels/
// spmv_pallas.py:dia_spmv_pallas: the blocked-halo kernel (_blocked_kernel /
// _dia_spmv_blocked) and the streaming kernel (_stream_kernel /
// _dia_spmv_streamed).  Their split is a VMEM and (8, 128)-tiling artefact;
// here one kernel takes any shape, any alignment and any offset width.  The
// TPU kernels clamp out-of-range halo reads and rely on zeros stored off the
// matrix; this kernel masks the column index instead, which matches the
// zero padding of the plain version (kernels/spmv.py:dia_spmv).
//
// Kernel B, dia_spmv_chain: y = (alpha A)^k x for a square A in one launch.
// It replaces spmv_pallas.py:_chain_kernel / dia_spmv_chain.  A persistent
// cooperative grid walks the k steps with a grid-wide barrier between them
// and two ping-pong vectors; step s reads x (s == 0) or the vector written
// by step s-1 and writes buf[s % 2].  The TPU kernel keeps the operator in
// its 128 MB VMEM; the H100 has no such scratchpad, and its 50 MB L2 holds
// a 4.2M-row f32 Poisson operator (84 MB) only in part, so every step
// streams most of the operator from HBM.  Kernel B runs one block of
// kChainThreads per SM, each over a contiguous range of rows; the
// diagonals of the first rows of its range (as many as the SM's shared
// memory holds: 227 KB, about 30 MB of the 84 MB over 132 SMs) are loaded
// once and stay resident across all k steps, and the rest is read as a
// stream read once per step (__ldcs, evict-first), which leaves L2 to the
// two vectors.  Fewer bytes alone did not help: one row a thread, a
// diagonal at a time, leaves each thread one load pair outstanding and an
// in-order warp stalls on the first FMA.  So a thread takes kChainRows rows
// at once and loads their entries of one diagonal together.  Each row still
// sums its diagonals in the stored order, so the result is bitwise that of
// one row at a time.  (Measured on an NVIDIA H100 80GB HBM3 at 700.00 W,
// 2048^2 Poisson, k = 50, tools/torch_kernel_probe.py: f32 2.43 ms a
// launch one row a thread, 2.19 ms with four rows a thread, 1.97 ms with
// the resident rows too and 2.08 ms with the vectors read at L2 as
// below; f64 4.04 / 4.11 / 3.99 / 4.03 ms.  The loaded values are zeroed
// before the guarded loads: without that nvcc spent more registers on the
// loop and the gain was gone.)
//
// Kernel A's multi-RHS form, dia_spmm: Y[i, t] = sum_d data[d, i] *
// X[i + off_d, t] for m right-hand sides, counting only 0 <= i + off_d < nc,
// with X and Y column-major ((nc, m) and (nr, m), row-major storage) or
// plane-major ((m, nc) and (m, nr)).  It replaces the XLA forms that the
// JAX package's FEAST runs on a banded operator, sparse_linear_tpu/kernels/
// spmv.py:45-90 (dia_spmm, dia_spmm_planes), called through eig/
// real_pipeline.py:124-132 (_structured_op).  What bounds it is memory: an
// entry of Y takes 2 flops a diagonal against at least 2 * itemsize bytes
// of X and Y (1.38 GB at 1024^2, 5 diagonals, m = 80 in f64: 0.41 ms at
// 3.35 TB/s).  X is read once from device memory only if L2 serves the
// re-reads: each row of X is wanted by ndiag rows of Y, the +-1 neighbours
// from the same tile of rows and the +-g ones from tiles g rows away.
//
// The first design (one thread an entry of Y, a 32-bit division and 64-bit
// index arithmetic per entry and diagonal, one scalar load pair in flight
// per fma) ran at 22-37 % of that bound, slower than cuSPARSE in f32.  The
// design here, against each cost:
//  * A block owns a tile of R consecutive rows.  Per chunk of up to
//    kDiagChunk diagonals it stages, once, the tile's data[d, row0:row0+R]
//    in shared memory (read under __ldcs, evict-first, so that L2 keeps X)
//    and, per diagonal, X's element index of the tile's first row and the
//    range [lo, hi) of the tile's rows whose column i + off_d lies in
//    [0, nc), as block-local ints: the per-row test is two int compares, and
//    no integer division runs anywhere (R is a power of two).
//  * Column-major: a group of G lanes takes one row of X as a coalesced run
//    of 16-byte vectors (float4 / double2) where m * itemsize is a multiple
//    of 16 and X and Y are 16-byte aligned, else one value a lane; a lane
//    holds up to four chunks, and m is tiled past G * V * C.  A thread
//    starts all its loads of one diagonal before their multiply-adds,
//    accumulators in registers: two rows at one or two chunks a lane, one
//    row at three or four.  Registers, not instructions, set the limit:
//    two rows at five chunks took 124 registers (two blocks an SM) and ran
//    0.715 ms at 1024^2, m = 80, f64, where one row at four took 0.553 ms.
//    Y is written once, as the same vectors, under __stcs.
//  * Plane-major: one thread a row (coalesced along i), TP planes at once:
//    data[d, i] and the offset test are read once from the staged tile for
//    the TP planes, whose loads are in flight together.  Four planes beat
//    eight (62 registers in f64) and two at every shape the probe timed but
//    one.
// Measured (NVIDIA H100 80GB HBM3 at 700.00 W, L2 flushed, 1024^2, m = 80,
// f32 / f64; tools/torch_dia_spmm_probe.py, this geometry): column-major
// 0.294 / 0.553 ms (70 % / 75 % of the bytes bound), plane-major 0.432 /
// 0.593 ms; the first design 0.944 / 1.111 and 0.680 / 0.758 ms and
// cuSPARSE SpMM 0.628 / 1.291 ms (chip_smoke.py phase 5).  Plane-major f32
// stays under half its bound: its X loads are 4-byte scalars along i,
// misaligned by the odd offsets, so vectors do not apply.
//  * Each entry sums its diagonals in stored order from zero with one fma
//    each (chunks of diagonals continue the same accumulator), as kernel A's
//    dia_row does, so every column of the result is bitwise kernel A on that
//    column, whatever the geometry.
//  * All flat indices into X and Y are 64-bit (nr * m passes 2^31 at 3M
//    rows and m = 768).  The launcher asks the runtime for the SM count and
//    occupancy once per (device, instantiation) and keeps them.
// The geometry (V, G, C; TP) is the wrapper's: spmv_dia._dia_spmm_plan.
//
// What bounds them: memory.  Kernel A moves (ndiag + 2) * nr * itemsize
// bytes (117 MB for f32 at 2048^2) for 2 * ndiag flops per row, far below
// the card's balance point, so wgmma and TMA do not apply.  The design is
// the simple one that is right: one thread per output row in a grid-stride
// loop, so that a warp reads 32 consecutive entries of data[d, :] and of
// x[i + off_d] (both coalesced), with alpha fused into the store.  Shared
// memory x tiles and L2 reuse across steps are later work.
//
// Complex values.  Kernel A and its multi-RHS form are also instantiated
// for complex64 and complex128, stored as float2 / double2 (the layout of a
// torch complex tensor: real part, then imaginary).  Every term is one
// cfma, the same four real fmas in the same order (fma_t below), so the
// multi-RHS form's column t is still bitwise kernel A on column t; alpha
// stays real and scales both parts.  A vector access is still 16 bytes:
// two complex64 values or one complex128.  What bounds them is still bytes:
// a complex entry is 8 flops against twice the bytes of a real one, far
// below the card's balance point.  The column-major form's registers per
// 16-byte chunk are those of the real types (a chunk holds fewer columns),
// so the wrapper's chunk cap is the same; a complex128 tile staged for two
// rows a thread at one lane a row would take 64 KB of static shared
// memory, so that geometry takes one row a thread (spmm_rows).  Kernel B
// stays real: no main path chains a complex operator.
//
// The kernels launch on the caller's stream, allocate nothing, and return
// cudaGetLastError() after the launch (0 on success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kChainThreads = 1024;  // kernel B: one block per SM
constexpr int kChainRows = 4;        // rows a thread of kernel B takes at once
constexpr int kSpmmThreads = 256;    // dia_spmm: threads a block
// column-major: a thread takes two rows while a lane holds at most this
// many chunks, one row past that (registers: see the note above)
constexpr int kTwoRowChunks = 2;
constexpr int kDiagChunk = 8;        // dia_spmm: diagonals staged at a time
constexpr int kMaxDevices = 64;

// The element types: float, double, and complex64 / complex128 as float2 /
// double2.  Part<T> is the type of one part of T, and of alpha.
template <typename T>
struct Part {
  using type = T;
};
template <>
struct Part<float2> {
  using type = float;
};
template <>
struct Part<double2> {
  using type = double;
};

template <typename T>
__device__ __forceinline__ T zero_t() {
  return T(0);
}
template <>
__device__ __forceinline__ float2 zero_t<float2>() {
  return make_float2(0.0f, 0.0f);
}
template <>
__device__ __forceinline__ double2 zero_t<double2>() {
  return make_double2(0.0, 0.0);
}

// a * b + c rounded once: the one fma of every term of kernel A and of its
// multi-RHS form (written out, so that no two loops contract differently)
__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}
// complex a * b + c (cfma): always these four real fmas in this order
__device__ __forceinline__ float2 fma_t(float2 a, float2 b, float2 c) {
  c.x = fmaf(a.x, b.x, c.x);
  c.x = fmaf(-a.y, b.y, c.x);
  c.y = fmaf(a.x, b.y, c.y);
  c.y = fmaf(a.y, b.x, c.y);
  return c;
}
__device__ __forceinline__ double2 fma_t(double2 a, double2 b, double2 c) {
  c.x = fma(a.x, b.x, c.x);
  c.x = fma(-a.y, b.y, c.x);
  c.y = fma(a.x, b.y, c.y);
  c.y = fma(a.y, b.x, c.y);
  return c;
}

// alpha * v for a real alpha: both parts of a complex v
__device__ __forceinline__ float scale_t(float a, float v) { return a * v; }
__device__ __forceinline__ double scale_t(double a, double v) { return a * v; }
__device__ __forceinline__ float2 scale_t(float a, float2 v) {
  return make_float2(a * v.x, a * v.y);
}
__device__ __forceinline__ double2 scale_t(double a, double2 v) {
  return make_double2(a * v.x, a * v.y);
}

// One output row of kernel A.  No thread writes x during the launch.
template <typename T>
__device__ __forceinline__ T dia_row(const T* __restrict__ data,
                                     const int64_t* __restrict__ offsets,
                                     const T* x, int64_t ndiag, int64_t nr,
                                     int64_t nc, int64_t i) {
  T acc = zero_t<T>();
  for (int64_t d = 0; d < ndiag; ++d) {
    const int64_t j = i + __ldg(offsets + d);
    if (j >= 0 && j < nc) acc = fma_t(__ldg(data + d * nr + i), x[j], acc);
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dia_spmv_kernel(const T* __restrict__ data,
                    const int64_t* __restrict__ offsets, const T* x, T* y,
                    int64_t ndiag, int64_t nr, int64_t nc,
                    typename Part<T>::type alpha) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < nr; i += stride) {
    y[i] = scale_t(alpha, dia_row(data, offsets, x, ndiag, nr, nc, i));
  }
}

// V consecutive values of a row of X or Y: one 16-byte access, or one
// value.  X is read through the read-only path, Y written under __stcs.
template <typename T, int V>
struct Vec;

template <typename T>
struct Vec<T, 1> {
  __device__ static void load(const T* p, T (&v)[1]) { v[0] = __ldg(p); }
  __device__ static void store(T* p, const T (&v)[1]) { __stcs(p, v[0]); }
};

template <>
struct Vec<float, 4> {
  __device__ static void load(const float* p, float (&v)[4]) {
    const float4 d = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = d.x;
    v[1] = d.y;
    v[2] = d.z;
    v[3] = d.w;
  }
  __device__ static void store(float* p, const float (&v)[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};

template <>
struct Vec<float2, 2> {
  __device__ static void load(const float2* p, float2 (&v)[2]) {
    const float4 d = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = make_float2(d.x, d.y);
    v[1] = make_float2(d.z, d.w);
  }
  __device__ static void store(float2* p, const float2 (&v)[2]) {
    __stcs(reinterpret_cast<float4*>(p),
           make_float4(v[0].x, v[0].y, v[1].x, v[1].y));
  }
};

template <>
struct Vec<double, 2> {
  __device__ static void load(const double* p, double (&v)[2]) {
    const double2 d = __ldg(reinterpret_cast<const double2*>(p));
    v[0] = d.x;
    v[1] = d.y;
  }
  __device__ static void store(double* p, const double (&v)[2]) {
    __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
  }
};

// One staged diagonal of a tile of rows [row0, row0 + rows): X's element
// index of row row0 + off_d (times the row stride), and the tile's rows r
// in [lo, hi) are those with 0 <= row0 + r + off_d < nc.
struct __align__(16) DiagTile {
  int64_t xbase;
  int lo;
  int hi;
};

// Stages diagonals d0 .. d0 + dn - 1 of the tile: each one's DiagTile in
// meta[k] and data[d0 + k, row0 + r] in sd[k * R + r] for r < rows.  R is a
// power of two (the split of e is a shift).  Both barriers are the block's:
// the previous chunk has been read before it is overwritten, and this one
// is written before it is read.
template <typename T, int R>
__device__ __forceinline__ void stage_tile(const T* __restrict__ data,
                                           const int64_t* __restrict__ offsets,
                                           DiagTile* meta, T* sd, int64_t d0,
                                           int dn, int64_t nr, int64_t nc,
                                           int64_t stride, int64_t row0,
                                           int rows) {
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < dn) {
    const int64_t off = __ldg(offsets + d0 + threadIdx.x);
    const int64_t lo = -off - row0;
    const int64_t hi = nc - off - row0;
    DiagTile t;
    t.xbase = (row0 + off) * stride;
    t.lo = static_cast<int>(lo < 0 ? 0 : (lo > rows ? rows : lo));
    t.hi = static_cast<int>(hi < 0 ? 0 : (hi > rows ? rows : hi));
    meta[threadIdx.x] = t;
  }
  for (int e = threadIdx.x; e < dn * R; e += blockDim.x) {
    const int k = e / R;
    const int r = e % R;
    if (r < rows) sd[e] = __ldcs(data + (d0 + k) * nr + row0 + r);
  }
  __syncthreads();
}

// Rows a thread of the column-major dia_spmm takes at C chunks a lane of G
// lanes a row: two at one or two chunks, one past that, and one where two
// rows' staged tile would pass 32 KB of static shared memory (complex128
// at one lane a row).
template <typename T, int G, int C>
__host__ __device__ constexpr int spmm_rows() {
  return C <= kTwoRowChunks &&
                 kDiagChunk * 2 * (kSpmmThreads / G) * sizeof(T) <= 32768
             ? 2
             : 1;
}

// Column-major dia_spmm: X (nc, m), Y (nr, m), both row-major.  A group of
// G lanes takes a row, V values a lane (V > 1: one 16-byte vector; then
// m % V == 0 and X and Y are 16-byte aligned), C chunks of G * V columns a
// pass over m; a thread takes Q = spmm_rows<T, G, C>() rows, P rows apart.
template <typename T, int V, int G, int C>
__global__ void __launch_bounds__(kSpmmThreads)
    dia_spmm_kernel(const T* __restrict__ data,
                    const int64_t* __restrict__ offsets,
                    const T* __restrict__ x, T* __restrict__ y, int64_t ndiag,
                    int64_t nr, int64_t nc, int64_t m) {
  constexpr int Q = spmm_rows<T, G, C>();
  constexpr int P = kSpmmThreads / G;  // rows a pass of the block
  constexpr int R = P * Q;             // rows a tile
  constexpr int W = G * V;             // columns a chunk
  constexpr int kTile = C * W;         // columns a pass over m
  __shared__ DiagTile meta[kDiagChunk];
  __shared__ T sd[kDiagChunk * R];
  const int h = threadIdx.x / G;
  const int tv = (threadIdx.x % G) * V;
  const bool restage = ndiag > kDiagChunk;
  const int64_t tiles = (nr + R - 1) / R;
  // this thread's rows' element offsets from a tile's first row
  int64_t rm[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    rm[q] = static_cast<int64_t>(h + q * P) * m + tv;
  }
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t row0 = tile * R;
    const int rows = static_cast<int>(nr - row0 < R ? nr - row0 : R);
    for (int64_t t0 = 0; t0 < m; t0 += kTile) {
      const int nt = static_cast<int>(m - t0 < kTile ? m - t0 : kTile);
      T acc[Q][C][V];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
#pragma unroll
          for (int v = 0; v < V; ++v) acc[q][c][v] = zero_t<T>();
        }
      }
      for (int64_t d0 = 0; d0 < ndiag; d0 += kDiagChunk) {
        const int dn = static_cast<int>(
            ndiag - d0 < kDiagChunk ? ndiag - d0 : kDiagChunk);
        if (t0 == 0 || restage) {
          stage_tile<T, R>(data, offsets, meta, sd, d0, dn, nr, nc, m, row0,
                           rows);
        }
        for (int k = 0; k < dn; ++k) {
          const DiagTile g = meta[k];
          const int64_t base = g.xbase + t0;
          T a[Q];
          bool ok[Q];
          T xv[Q][C][V];
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            const int r = h + q * P;
            ok[q] = r >= g.lo && r < g.hi;
            a[q] = sd[k * R + r];
            const T* xr = x + (base + rm[q]);
#pragma unroll
            for (int c = 0; c < C; ++c) {
              if (ok[q] && c * W + tv < nt) {
                Vec<T, V>::load(xr + c * W, xv[q][c]);
              }
            }
          }
#pragma unroll
          for (int q = 0; q < Q; ++q) {
#pragma unroll
            for (int c = 0; c < C; ++c) {
              if (ok[q] && c * W + tv < nt) {
#pragma unroll
                for (int v = 0; v < V; ++v) {
                  acc[q][c][v] = fma_t(a[q], xv[q][c][v], acc[q][c][v]);
                }
              }
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if (h + q * P < rows) {
          T* yr = y + (row0 * m + t0 + rm[q]);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            if (c * W + tv < nt) Vec<T, V>::store(yr + c * W, acc[q][c]);
          }
        }
      }
    }
  }
}

// Plane-major dia_spmm: X (m, nc), Y (m, nr).  One thread a row of a tile
// of kSpmmThreads rows, TP planes at a time.
template <typename T, int TP>
__global__ void __launch_bounds__(kSpmmThreads)
    dia_spmm_planes_kernel(const T* __restrict__ data,
                           const int64_t* __restrict__ offsets,
                           const T* __restrict__ x, T* __restrict__ y,
                           int64_t ndiag, int64_t nr, int64_t nc, int64_t m) {
  constexpr int R = kSpmmThreads;
  __shared__ DiagTile meta[kDiagChunk];
  __shared__ T sd[kDiagChunk * R];
  const int r = threadIdx.x;
  const bool restage = ndiag > kDiagChunk;
  const int64_t tiles = (nr + R - 1) / R;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t row0 = tile * R;
    const int rows = static_cast<int>(nr - row0 < R ? nr - row0 : R);
    for (int64_t t0 = 0; t0 < m; t0 += TP) {
      const int np = static_cast<int>(m - t0 < TP ? m - t0 : TP);
      const T* xt = x + t0 * nc;
      T acc[TP];
#pragma unroll
      for (int p = 0; p < TP; ++p) acc[p] = zero_t<T>();
      for (int64_t d0 = 0; d0 < ndiag; d0 += kDiagChunk) {
        const int dn = static_cast<int>(
            ndiag - d0 < kDiagChunk ? ndiag - d0 : kDiagChunk);
        if (t0 == 0 || restage) {
          stage_tile<T, R>(data, offsets, meta, sd, d0, dn, nr, nc, 1, row0,
                           rows);
        }
        for (int k = 0; k < dn; ++k) {
          const DiagTile g = meta[k];
          const bool ok = r >= g.lo && r < g.hi;
          const T a = sd[k * R + r];
          const T* xr = xt + (g.xbase + r);
          T xv[TP];
#pragma unroll
          for (int p = 0; p < TP; ++p) {
            if (ok && p < np) xv[p] = __ldg(xr + p * nc);
          }
#pragma unroll
          for (int p = 0; p < TP; ++p) {
            if (ok && p < np) acc[p] = fma_t(a, xv[p], acc[p]);
          }
        }
      }
      if (r < rows) {
        T* yr = y + (t0 * nr + row0 + r);
#pragma unroll
        for (int p = 0; p < TP; ++p) {
          if (p < np) __stcs(yr + p * nr, acc[p]);
        }
      }
    }
  }
}

// Block b takes rows [b chunk, (b + 1) chunk); thread t takes rows t,
// t + kChainThreads, ... of it, kChainRows at a time.  The first ``resident``
// rows keep their diagonals in shared memory, ds[d * resident + r].  x and
// the ping-pong vectors are read at L2 (__ldcg), never from the SM's L1:
// other blocks write them between grid barriers.  (A variant of this loop
// that read them with ordinary loads gave results 1.5e-2 off, the same in
// every run, where __ldcg gave them exactly; tools/torch_kernel_probe.py,
// gs_r4_256x4.)
template <typename T>
__global__ void __launch_bounds__(kChainThreads, 1)
    dia_chain_kernel(const T* __restrict__ data,
                     const int64_t* __restrict__ offsets, const T* x, T* buf0,
                     T* buf1, int64_t ndiag, int64_t n, int k, T alpha,
                     int64_t chunk, int64_t resident) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ds = reinterpret_cast<T*>(smem);
  cg::grid_group grid = cg::this_grid();
  const int64_t row0 = blockIdx.x * chunk;
  const int64_t row1 = row0 + chunk < n ? row0 + chunk : n;
  const int64_t held = row1 - row0 < resident ? row1 - row0 : resident;
  for (int64_t d = 0; d < ndiag; ++d) {
    for (int64_t r = threadIdx.x; r < held; r += kChainThreads) {
      ds[d * resident + r] = __ldcs(data + d * n + row0 + r);
    }
  }
  __syncthreads();
  const T* src = x;
  for (int s = 0; s < k; ++s) {
    T* dst = (s & 1) ? buf1 : buf0;
    for (int64_t i0 = row0 + threadIdx.x; i0 < row1;
         i0 += kChainThreads * kChainRows) {
      T acc[kChainRows];
#pragma unroll
      for (int q = 0; q < kChainRows; ++q) acc[q] = T(0);
      for (int64_t d = 0; d < ndiag; ++d) {
        const int64_t off = __ldg(offsets + d);
        bool ok[kChainRows];
        T a[kChainRows], xv[kChainRows];
#pragma unroll
        for (int q = 0; q < kChainRows; ++q) {
          const int64_t i = i0 + q * kChainThreads;
          const int64_t j = i + off;
          ok[q] = i < row1 && j >= 0 && j < n;
          a[q] = T(0);
          xv[q] = T(0);
          if (ok[q]) {
            a[q] = i - row0 < held ? ds[d * resident + i - row0]
                                   : __ldcs(data + d * n + i);
            xv[q] = __ldcg(src + j);
          }
        }
#pragma unroll
        for (int q = 0; q < kChainRows; ++q) {
          if (ok[q]) acc[q] += a[q] * xv[q];
        }
      }
#pragma unroll
      for (int q = 0; q < kChainRows; ++q) {
        const int64_t i = i0 + q * kChainThreads;
        if (i < row1) dst[i] = alpha * acc[q];
      }
    }
    if (s + 1 < k) grid.sync();
    src = dst;
  }
}

cudaError_t sm_count(int device, int* sms) {
  *sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && *sms <= 0) err = cudaErrorInvalidDevice;
  return err;
}

template <typename T>
int launch_spmv(const void* data, const void* offsets, const void* x, void* y,
                long long ndiag, long long nr, long long nc, double alpha,
                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  const long long want = (nr + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * 16;
  const unsigned blocks = static_cast<unsigned>(want < cap ? want : cap);
  dia_spmv_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int64_t*>(offsets),
      static_cast<const T*>(x), static_cast<T*>(y), ndiag, nr, nc,
      static_cast<typename Part<T>::type>(alpha));
  return cudaGetLastError();
}

template <typename T>
using SpmmKernel = void (*)(const T*, const int64_t*, const T*, T*, int64_t,
                            int64_t, int64_t, int64_t);

// A dia_spmm instantiation as a persistent grid: as many blocks as fit on
// the card at once (fewer for a small matrix), each walking tiles of `rows`
// rows grid-stride.  The runtime is asked for that count once per (device,
// instantiation), on the first launch, and `kept` holds it for the later
// ones; two threads racing on a first launch ask twice and keep the same
// count.
template <typename T>
int launch_tiles(SpmmKernel<T> kernel, std::atomic<long long>* kept,
                 long long rows, const void* data, const void* offsets,
                 const void* x, void* y, long long ndiag, long long nr,
                 long long nc, long long m, int device, void* stream) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  long long cap = kept[device].load(std::memory_order_relaxed);
  if (cap <= 0) {
    int sms = 0;
    int per_sm = 0;
    err = sm_count(device, &sms);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kSpmmThreads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm <= 0) return cudaErrorLaunchOutOfResources;
    cap = static_cast<long long>(sms) * per_sm;
    kept[device].store(cap, std::memory_order_relaxed);
  }
  const long long want = (nr + rows - 1) / rows;
  const unsigned blocks = static_cast<unsigned>(want < cap ? want : cap);
  kernel<<<blocks, kSpmmThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int64_t*>(offsets),
      static_cast<const T*>(x), static_cast<T*>(y), ndiag, nr, nc, m);
  return cudaGetLastError();
}

template <typename T, int V, int G, int C>
int launch_spmm_as(const void* data, const void* offsets, const void* x,
                   void* y, long long ndiag, long long nr, long long nc,
                   long long m, int device, void* stream) {
  static std::atomic<long long> kept[kMaxDevices];  // 0s
  return launch_tiles<T>(dia_spmm_kernel<T, V, G, C>, kept,
                         spmm_rows<T, G, C>() * (kSpmmThreads / G), data,
                         offsets,
                         x, y,
                         ndiag, nr, nc, m, device, stream);
}

template <typename T, int TP>
int launch_planes_as(const void* data, const void* offsets, const void* x,
                     void* y, long long ndiag, long long nr, long long nc,
                     long long m, int device, void* stream) {
  static std::atomic<long long> kept[kMaxDevices];  // 0s
  return launch_tiles<T>(dia_spmm_planes_kernel<T, TP>, kept, kSpmmThreads,
                         data, offsets, x, y, ndiag, nr, nc, m, device,
                         stream);
}

// The wrapper chooses the geometry (spmv_dia._dia_spmm_plan).  Column-major:
// vector lanes take G in {1, 2, 4, 8} with one chunk or G = 8 with two to
// four; scalar lanes one chunk of G in {1, ..., 128 / itemsize}.  A vector
// is 16 bytes: four floats, two doubles or complex64s, one complex128.
// Plane-major: lanes 1, TP = chunks in {1, 2, 4} planes at a time.
template <typename T>
int launch_spmm(const void* data, const void* offsets, const void* x, void* y,
                long long ndiag, long long nr, long long nc, long long m,
                int planes, int vec, int lanes, int chunks, int device,
                void* stream) {
  constexpr int VX = 16 / sizeof(T);
#define SLT_SPMM(V, G, C)                                                  \
  return launch_spmm_as<T, V, G, C>(data, offsets, x, y, ndiag, nr, nc, m, \
                                    device, stream)
#define SLT_PLANES(TP)                                                    \
  return launch_planes_as<T, TP>(data, offsets, x, y, ndiag, nr, nc, m,  \
                                 device, stream)
  if (planes) {
    if (lanes == 1) {
      switch (chunks) {
        case 1: SLT_PLANES(1);
        case 2: SLT_PLANES(2);
        case 4: SLT_PLANES(4);
      }
    }
  } else if (vec && chunks == 1) {
    switch (lanes) {
      case 1: SLT_SPMM(VX, 1, 1);
      case 2: SLT_SPMM(VX, 2, 1);
      case 4: SLT_SPMM(VX, 4, 1);
      case 8: SLT_SPMM(VX, 8, 1);
    }
  } else if (vec && lanes == 8) {
    switch (chunks) {
      case 2: SLT_SPMM(VX, 8, 2);
      case 3: SLT_SPMM(VX, 8, 3);
      case 4: SLT_SPMM(VX, 8, 4);
    }
  } else if (!vec && chunks == 1) {
    switch (lanes) {
      case 1: SLT_SPMM(1, 1, 1);
      case 2: SLT_SPMM(1, 2, 1);
      case 4: SLT_SPMM(1, 4, 1);
      case 8: SLT_SPMM(1, 8, 1);
      case 16:
        if constexpr (sizeof(T) <= 8) SLT_SPMM(1, 16, 1);
        break;
      case 32:
        if constexpr (sizeof(T) == 4) SLT_SPMM(1, 32, 1);
    }
  }
#undef SLT_SPMM
#undef SLT_PLANES
  return cudaErrorInvalidValue;
}

template <typename T>
int launch_chain(const void* data, const void* offsets, const void* x,
                 void* buf0, void* buf1, long long ndiag, long long n, int k,
                 double alpha, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  int sms = 0;
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  int smem_sm = 0;
  int smem_block = 0;
  err = cudaDeviceGetAttribute(
      &smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(
      &smem_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  // one block per SM, each over a contiguous range of rows; the SM keeps
  // 1 KB of its shared memory for the block
  const long long blocks = n < sms ? n : sms;
  const long long chunk = (n + blocks - 1) / blocks;
  long long bytes = smem_sm - 1024LL < smem_block ? smem_sm - 1024LL
                                                  : smem_block;
  long long resident =
      ndiag > 0 ? bytes / (ndiag * static_cast<long long>(sizeof(T))) : 0;
  if (resident > chunk) resident = chunk;
  bytes = resident * ndiag * static_cast<long long>(sizeof(T));
  err = cudaFuncSetAttribute(dia_chain_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, dia_chain_kernel<T>, kChainThreads, static_cast<size_t>(bytes));
  if (err != cudaSuccess) return err;
  if (per_sm < 1 || blocks < 1) return cudaErrorLaunchOutOfResources;

  const T* data_p = static_cast<const T*>(data);
  const int64_t* offsets_p = static_cast<const int64_t*>(offsets);
  const T* x_p = static_cast<const T*>(x);
  T* buf0_p = static_cast<T*>(buf0);
  T* buf1_p = static_cast<T*>(buf1);
  int64_t ndiag_v = ndiag;
  int64_t n_v = n;
  int k_v = k;
  T alpha_v = static_cast<T>(alpha);
  int64_t chunk_v = chunk;
  int64_t resident_v = resident;
  void* args[] = {&data_p, &offsets_p, &x_p, &buf0_p,  &buf1_p,    &ndiag_v,
                  &n_v,    &k_v,       &alpha_v, &chunk_v, &resident_v};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(dia_chain_kernel<T>),
      dim3(static_cast<unsigned>(blocks)), dim3(kChainThreads), args,
      static_cast<size_t>(bytes), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int slt_dia_spmv_f32(const void* data, const void* offsets, const void* x,
                     void* y, long long ndiag, long long nr, long long nc,
                     double alpha, int device, void* stream) {
  return launch_spmv<float>(data, offsets, x, y, ndiag, nr, nc, alpha, device,
                            stream);
}

int slt_dia_spmv_f64(const void* data, const void* offsets, const void* x,
                     void* y, long long ndiag, long long nr, long long nc,
                     double alpha, int device, void* stream) {
  return launch_spmv<double>(data, offsets, x, y, ndiag, nr, nc, alpha, device,
                             stream);
}

int slt_dia_spmm_f32(const void* data, const void* offsets, const void* x,
                     void* y, long long ndiag, long long nr, long long nc,
                     long long m, int planes, int vec, int lanes, int chunks,
                     int device, void* stream) {
  return launch_spmm<float>(data, offsets, x, y, ndiag, nr, nc, m, planes,
                            vec, lanes, chunks, device, stream);
}

int slt_dia_spmm_f64(const void* data, const void* offsets, const void* x,
                     void* y, long long ndiag, long long nr, long long nc,
                     long long m, int planes, int vec, int lanes, int chunks,
                     int device, void* stream) {
  return launch_spmm<double>(data, offsets, x, y, ndiag, nr, nc, m, planes,
                             vec, lanes, chunks, device, stream);
}

int slt_dia_spmv_c64(const void* data, const void* offsets, const void* x,
                     void* y, long long ndiag, long long nr, long long nc,
                     double alpha, int device, void* stream) {
  return launch_spmv<float2>(data, offsets, x, y, ndiag, nr, nc, alpha, device,
                             stream);
}

int slt_dia_spmv_c128(const void* data, const void* offsets, const void* x,
                      void* y, long long ndiag, long long nr, long long nc,
                      double alpha, int device, void* stream) {
  return launch_spmv<double2>(data, offsets, x, y, ndiag, nr, nc, alpha,
                              device, stream);
}

int slt_dia_spmm_c64(const void* data, const void* offsets, const void* x,
                     void* y, long long ndiag, long long nr, long long nc,
                     long long m, int planes, int vec, int lanes, int chunks,
                     int device, void* stream) {
  return launch_spmm<float2>(data, offsets, x, y, ndiag, nr, nc, m, planes,
                             vec, lanes, chunks, device, stream);
}

int slt_dia_spmm_c128(const void* data, const void* offsets, const void* x,
                      void* y, long long ndiag, long long nr, long long nc,
                      long long m, int planes, int vec, int lanes, int chunks,
                      int device, void* stream) {
  return launch_spmm<double2>(data, offsets, x, y, ndiag, nr, nc, m, planes,
                              vec, lanes, chunks, device, stream);
}

int slt_dia_chain_f32(const void* data, const void* offsets, const void* x,
                      void* buf0, void* buf1, long long ndiag, long long n,
                      int k, double alpha, int device, void* stream) {
  return launch_chain<float>(data, offsets, x, buf0, buf1, ndiag, n, k, alpha,
                             device, stream);
}

int slt_dia_chain_f64(const void* data, const void* offsets, const void* x,
                      void* buf0, void* buf1, long long ndiag, long long n,
                      int k, double alpha, int device, void* stream) {
  return launch_chain<double>(data, offsets, x, buf0, buf1, ndiag, n, k, alpha,
                              device, stream);
}

const char* slt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
