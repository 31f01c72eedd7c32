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
// real_pipeline.py:124-132 (_structured_op).  What should bound it is
// memory: an entry of Y takes 2 flops a diagonal against at least
// 2 * itemsize bytes of X and Y (1.38 GB at 1024^2, 5 diagonals, m = 80 in
// f64: 0.41 ms at 3.35 TB/s).  Measured (NVIDIA H100 80GB HBM3 at 700.00 W,
// chip_smoke.py phase 5, 1024^2, m = 80) it is bound by its instructions:
// column-major 1.11 ms f64 and 0.94 ms f32 (37 % and 22 % of the bound:
// a 32-bit division and 64-bit index arithmetic per entry and diagonal),
// plane-major 0.76 / 0.68 ms.  The design is the simple one that is right
// (a row-per-warp form without the division is later work).  Column-major:
// a block takes a few consecutive rows and its threads walk their (rows, m)
// entries in storage order, so a warp's loads of X (at e + off_d * m) and
// its stores of Y are coalesced whatever m, and data[d, i] is one broadcast
// load for the threads of a row; the +-g offsets re-read rows of X that a
// block g rows away read, which L2 serves.  Plane-major: one thread takes a
// row and loops over the m planes, coalesced along i.  Each entry sums its
// diagonals in stored order from zero with one fma each, as kernel A's
// dia_row does, so every column of the result is bitwise kernel A on that
// column.  wgmma, TMA and shared-memory X tiles are later work.
//
// What bounds them: memory.  Kernel A moves (ndiag + 2) * nr * itemsize
// bytes (117 MB for f32 at 2048^2) for 2 * ndiag flops per row, far below
// the card's balance point, so wgmma and TMA do not apply.  The design is
// the simple one that is right: one thread per output row in a grid-stride
// loop, so that a warp reads 32 consecutive entries of data[d, :] and of
// x[i + off_d] (both coalesced), with alpha fused into the store.  Shared
// memory x tiles and L2 reuse across steps are later work.
//
// The kernels launch on the caller's stream, allocate nothing, and return
// cudaGetLastError() after the launch (0 on success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kChainThreads = 1024;  // kernel B: one block per SM
constexpr int kChainRows = 4;        // rows a thread of kernel B takes at once
constexpr int kSpmmEntries = 1024;   // entries of Y a dia_spmm block takes

// a * b + c rounded once: the one fma of every term of kernel A and of its
// multi-RHS form (written out, so that no two loops contract differently)
__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// One output row of kernel A.  No thread writes x during the launch.
template <typename T>
__device__ __forceinline__ T dia_row(const T* __restrict__ data,
                                     const int64_t* __restrict__ offsets,
                                     const T* x, int64_t ndiag, int64_t nr,
                                     int64_t nc, int64_t i) {
  T acc = T(0);
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
                    int64_t ndiag, int64_t nr, int64_t nc, T alpha) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < nr; i += stride) {
    y[i] = alpha * dia_row(data, offsets, x, ndiag, nr, nc, i);
  }
}

// Column-major dia_spmm: a block takes rows_per_block rows at a time and
// its threads walk their rows * m entries e in storage order (row e / m,
// right-hand side e % m).  rows_per_block * m fits 32 bits (the launcher
// keeps it near kSpmmEntries).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dia_spmm_kernel(const T* __restrict__ data,
                    const int64_t* __restrict__ offsets,
                    const T* __restrict__ x, T* __restrict__ y, int64_t ndiag,
                    int64_t nr, int64_t nc, int64_t m,
                    int64_t rows_per_block) {
  const unsigned um = static_cast<unsigned>(m);
  const int64_t step = static_cast<int64_t>(gridDim.x) * rows_per_block;
  for (int64_t row0 = blockIdx.x * rows_per_block; row0 < nr; row0 += step) {
    const int64_t rows =
        nr - row0 < rows_per_block ? nr - row0 : rows_per_block;
    const unsigned count = static_cast<unsigned>(rows) * um;
    const T* xb = x + row0 * m;
    T* yb = y + row0 * m;
    for (unsigned e = threadIdx.x; e < count; e += blockDim.x) {
      const int64_t i = row0 + e / um;
      T acc = T(0);
      for (int64_t d = 0; d < ndiag; ++d) {
        const int64_t off = __ldg(offsets + d);
        const int64_t j = i + off;
        if (j >= 0 && j < nc) {
          acc = fma_t(__ldg(data + d * nr + i),
                      xb[static_cast<int64_t>(e) + off * m], acc);
        }
      }
      yb[e] = acc;
    }
  }
}

// Plane-major dia_spmm: one thread a row i, looping over the m planes; X is
// (m, nc), Y (m, nr).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dia_spmm_planes_kernel(const T* __restrict__ data,
                           const int64_t* __restrict__ offsets,
                           const T* __restrict__ x, T* __restrict__ y,
                           int64_t ndiag, int64_t nr, int64_t nc, int64_t m) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < nr; i += stride) {
    for (int64_t t = 0; t < m; ++t) {
      const T* xt = x + t * nc;
      T acc = T(0);
      for (int64_t d = 0; d < ndiag; ++d) {
        const int64_t j = i + __ldg(offsets + d);
        if (j >= 0 && j < nc) {
          acc = fma_t(__ldg(data + d * nr + i), xt[j], acc);
        }
      }
      y[t * nr + i] = acc;
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
      static_cast<T>(alpha));
  return cudaGetLastError();
}

template <typename T>
int launch_spmm(const void* data, const void* offsets, const void* x, void* y,
                long long ndiag, long long nr, long long nc, long long m,
                int planes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  const long long cap = static_cast<long long>(sms) * 16;
  const T* data_p = static_cast<const T*>(data);
  const int64_t* offsets_p = static_cast<const int64_t*>(offsets);
  const T* x_p = static_cast<const T*>(x);
  T* y_p = static_cast<T*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (planes) {
    const long long want = (nr + kThreads - 1) / kThreads;
    const unsigned blocks = static_cast<unsigned>(want < cap ? want : cap);
    dia_spmm_planes_kernel<T><<<blocks, kThreads, 0, s>>>(
        data_p, offsets_p, x_p, y_p, ndiag, nr, nc, m);
  } else {
    const long long rows = m < kSpmmEntries ? kSpmmEntries / m : 1;
    const long long want = (nr + rows - 1) / rows;
    const unsigned blocks = static_cast<unsigned>(want < cap ? want : cap);
    dia_spmm_kernel<T><<<blocks, kThreads, 0, s>>>(
        data_p, offsets_p, x_p, y_p, ndiag, nr, nc, m, rows);
  }
  return cudaGetLastError();
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
                     long long m, int planes, int device, void* stream) {
  return launch_spmm<float>(data, offsets, x, y, ndiag, nr, nc, m, planes,
                            device, stream);
}

int slt_dia_spmm_f64(const void* data, const void* offsets, const void* x,
                     void* y, long long ndiag, long long nr, long long nc,
                     long long m, int planes, int device, void* stream) {
  return launch_spmm<double>(data, offsets, x, y, ndiag, nr, nc, m, planes,
                             device, stream);
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
