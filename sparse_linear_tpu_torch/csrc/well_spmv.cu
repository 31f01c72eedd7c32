// Unstructured SpMV / SpMM kernels for Hopper (sm_90a), bound to Python with
// ctypes, over the port's sliced-ELL WELL layout (formats/well.py):
//
//   rows are cut into slices of 32 (one warp); slice s is padded to its
//   longest row, w_s slots per row, and stored slot-major: the k-th entry of
//   row 32 s + lane sits at slice_ptr[s] + 32 k + lane.  slice_ptr is int64
//   (capacity can pass 2^31 on skewed patterns), cols int32; a padding slot
//   holds value 0 and column 0.
//
// Kernel C, well_spmv: y[i] = sum_k vals[p_k(i)] * x[cols[p_k(i)]].  It
// replaces the TPU kernels sparse_linear_tpu/kernels/spmv_well.py:
// _kernel / _well_spmv_real (f32, two in-register gathers per (8, 128)
// chunk) and spmv_well64.py: _kernel_df64 / _well_spmv_df64 (f64 from hi/lo
// f32 planes with TwoProd/TwoSum).  The TPU packs chunks of one aligned x
// window because it has no scattered loads; Hopper gathers natively, and
// has native f64, so one template instantiated for float and double takes
// the place of both.
//
// Kernel D, well_spmm: Y = A X for m right-hand sides, kTile of them per
// pass, held in registers.  It replaces spmv_well.py: _spmm_kernel /
// _spmm_resident and _spmm_kernel_win / _spmm_windowed (one op with two VMEM
// plans on the TPU) and spmv_well64.py: _kernel_spmm_df64 /
// _well_spmm_df64.  As on the TPU, each (val, col) slot is loaded once and
// used for the whole tile, so the A stream is read once per tile and not
// once per column.  X is read as (nc, m) row-major: the m values that one
// slot gathers are contiguous, one 64-128 B run, where the plane-major
// (m, nc) layout pays one 32 B sector per value (measured on an NVIDIA
// H100 80GB HBM3 at 700.00 W, permuted 2048^2 Poisson operator, m = 16,
// f64: 8.8 ms plane-major against 2.2 ms row-major).  Y is written through
// strides (y_row, y_rhs), so the plane-major (m, nr) and the column-major
// (nr, m) result take no transpose.
//
// What bounds them: memory.  Kernel C moves capacity * (itemsize + 4) bytes
// of A plus the x gathers and y, for 2 flops per slot.  One thread per row
// over the slot-major slices makes a warp's loads of vals and cols
// coalesced.  On an unstructured numbering each slot gathers x at random,
// one 32 B sector for an 8 B value, so what decides the time is whether x
// stays in L2 while A streams past it.  Kernel C therefore reads vals and
// cols as a stream read once (__ldcs: evict-first, no L1 allocation) and
// stores y the same way (__stcs), so that neither pushes x out of L2; x is
// read through the read-only path (__ldg) at normal priority.  A row loads
// kBatch slots (vals, cols) before it gathers x for them, which keeps
// several gathers of one thread in flight; a wider slice runs the same
// batch again.  Each row still sums its slots in slot order from zero, so
// y is bitwise what the one-slot-at-a-time loop gave.  (Measured on an
// NVIDIA H100 80GB HBM3 at 700.00 W, permuted 2048^2 operator, f64, L2
// flushed, tools/torch_kernel_probe.py: the stream hint took the kernel
// from 0.295 to 0.250 ms; the batch alone to 0.278 ms and nothing more on
// top of the hint; an evict_last policy on the x gathers made it slower,
// 0.311 ms.)  Sorting rows by length (SELL-C-sigma) and shared-memory x
// tiles are later work.
//
// Both kernels launch on the caller's stream, allocate nothing, and return
// cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // a multiple of 32: a warp is one slice
constexpr int kSlice = 32;
constexpr int kTile = 16;  // right-hand sides held in registers per pass
constexpr int kBatch = 8;  // slots of a row loaded before their gathers

template <typename T>
__global__ void __launch_bounds__(kThreads)
    well_spmv_kernel(const int64_t* __restrict__ slice_ptr,
                     const int32_t* __restrict__ cols,
                     const T* __restrict__ vals, const T* __restrict__ x,
                     T* __restrict__ y, int64_t nr) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < nr; i += stride) {
    const int64_t s = i / kSlice;
    const int64_t begin = __ldg(slice_ptr + s);
    const int64_t width = (__ldg(slice_ptr + s + 1) - begin) / kSlice;
    const int64_t base = begin + i % kSlice;
    T acc = T(0);
    for (int64_t k0 = 0; k0 < width; k0 += kBatch) {
      int32_t c[kBatch];
      T v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (k0 + j < width) {
          c[j] = __ldcs(cols + base + (k0 + j) * kSlice);
          v[j] = __ldcs(vals + base + (k0 + j) * kSlice);
        }
      }
      T xv[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (k0 + j < width) xv[j] = __ldg(x + c[j]);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (k0 + j < width) acc += v[j] * xv[j];
      }
    }
    __stcs(y + i, acc);
  }
}

// x: (nc, m) row-major.  y_row / y_rhs: element strides of Y between rows
// of A and between right-hand sides.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    well_spmm_kernel(const int64_t* __restrict__ slice_ptr,
                     const int32_t* __restrict__ cols,
                     const T* __restrict__ vals, const T* __restrict__ x,
                     T* __restrict__ y, int64_t nr, int64_t m, int64_t y_row,
                     int64_t y_rhs) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < nr; i += stride) {
    const int64_t s = i / kSlice;
    const int64_t begin = __ldg(slice_ptr + s) + i % kSlice;
    const int64_t end = __ldg(slice_ptr + s + 1);
    for (int64_t t0 = 0; t0 < m; t0 += kTile) {
      const int nt = static_cast<int>(m - t0 < kTile ? m - t0 : kTile);
      const T* xt = x + t0;
      T acc[kTile];
#pragma unroll
      for (int t = 0; t < kTile; ++t) acc[t] = T(0);
      for (int64_t p = begin; p < end; p += kSlice) {
        const T v = __ldg(vals + p);
        const T* xc = xt + static_cast<int64_t>(__ldg(cols + p)) * m;
#pragma unroll
        for (int t = 0; t < kTile; ++t) {
          if (t < nt) acc[t] += v * __ldg(xc + t);
        }
      }
      T* yt = y + i * y_row + t0 * y_rhs;
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        if (t < nt) yt[t * y_rhs] = acc[t];
      }
    }
  }
}

cudaError_t grid_for(int device, int64_t nr, unsigned* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (sms <= 0) return cudaErrorInvalidDevice;
  const long long want = (nr + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * 16;
  *blocks = static_cast<unsigned>(want < cap ? want : cap);
  return cudaSuccess;
}

template <typename T>
int launch_spmv(const void* slice_ptr, const void* cols, const void* vals,
                const void* x, void* y, long long nr, int device,
                void* stream) {
  unsigned blocks = 0;
  cudaError_t err = grid_for(device, nr, &blocks);
  if (err != cudaSuccess) return err;
  well_spmv_kernel<T><<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(slice_ptr),
      static_cast<const int32_t*>(cols), static_cast<const T*>(vals),
      static_cast<const T*>(x), static_cast<T*>(y), nr);
  return cudaGetLastError();
}

template <typename T>
int launch_spmm(const void* slice_ptr, const void* cols, const void* vals,
                const void* x, void* y, long long nr, long long m,
                long long y_row, long long y_rhs, int device, void* stream) {
  unsigned blocks = 0;
  cudaError_t err = grid_for(device, nr, &blocks);
  if (err != cudaSuccess) return err;
  well_spmm_kernel<T><<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(slice_ptr),
      static_cast<const int32_t*>(cols), static_cast<const T*>(vals),
      static_cast<const T*>(x), static_cast<T*>(y), nr, m, y_row, y_rhs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int slt_well_spmv_f32(const void* slice_ptr, const void* cols,
                      const void* vals, const void* x, void* y, long long nr,
                      int device, void* stream) {
  return launch_spmv<float>(slice_ptr, cols, vals, x, y, nr, device, stream);
}

int slt_well_spmv_f64(const void* slice_ptr, const void* cols,
                      const void* vals, const void* x, void* y, long long nr,
                      int device, void* stream) {
  return launch_spmv<double>(slice_ptr, cols, vals, x, y, nr, device, stream);
}

int slt_well_spmm_f32(const void* slice_ptr, const void* cols,
                      const void* vals, const void* x, void* y, long long nr,
                      long long m, long long y_row, long long y_rhs,
                      int device, void* stream) {
  return launch_spmm<float>(slice_ptr, cols, vals, x, y, nr, m, y_row, y_rhs,
                            device, stream);
}

int slt_well_spmm_f64(const void* slice_ptr, const void* cols,
                      const void* vals, const void* x, void* y, long long nr,
                      long long m, long long y_row, long long y_rhs,
                      int device, void* stream) {
  return launch_spmm<double>(slice_ptr, cols, vals, x, y, nr, m, y_row,
                             y_rhs, device, stream);
}

}  // extern "C"
