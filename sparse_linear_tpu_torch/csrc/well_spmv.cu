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
// Kernel D, well_spmm: Y = A X for m right-hand sides.  It replaces
// spmv_well.py: _spmm_kernel / _spmm_resident and _spmm_kernel_win /
// _spmm_windowed (one op with two VMEM plans on the TPU) and
// spmv_well64.py: _kernel_spmm_df64 / _well_spmm_df64.  X is read as
// (nc, m) row-major, so that the m values one slot gathers are one
// contiguous run (the plane-major (m, nc) layout pays one 32 B sector per
// value: 8.8 ms against 2.2 ms, permuted 2048^2 operator, m = 16, f64, on
// an NVIDIA H100 80GB HBM3 at 700.00 W); Y is written through strides
// (y_row, y_rhs), plane-major (m, nr) or column-major (nr, m).
//
// What bounds it, on an NVIDIA H100 80GB HBM3 at 700.00 W (3.35 TB/s):
// bytes.  Counted once (A's slots, X, Y), the permuted 2048^2 operator
// (20.96M slots) moves 1326 MB at m = 16 in f64 (0.396 ms) and 5621 MB at
// m = 80 (1.678 ms).  On a numbering without locality each slot gathers
// its own run of m * itemsize bytes of X at a random row and X is ten
// times the 50 MB L2, so the gathers alone move 20.96M * m * itemsize
// bytes: the floor of such a numbering is about 1.04 ms at m = 16 and
// 4.9 ms at m = 80 (f64).  The bytes-once bound is reachable only where
// the numbering gives locality (stencil order: neighbouring rows gather
// the same lines of X from L2).  The design, against each cost:
//  * A is read from device memory once per call, whatever m.  One warp
//    takes one slice: its slots (ks per row at a time, a staging loop for
//    long rows) are copied into shared memory by cp.async, coalesced,
//    under an L2 evict_first policy (the stream hint that made kernel C
//    fast), and every tile of right-hand sides reads them from there.
//  * The lanes lie across the right-hand sides: a group of G lanes takes
//    one row, each lane V values (one 16-byte vector, or one value where
//    m * itemsize is not a multiple of 16 or X is not 16-byte aligned), so
//    a row's gather is one coalesced run of up to 128 bytes, and a warp
//    takes R = 32 / G rows at a time (G shrinks with m, so small m keeps
//    all 32 lanes busy).  A lane holds C such chunks in registers (up to
//    five: m = 80 in f64, 160 in f32, in one pass), all loaded together,
//    with several slots' loads issued before their multiply-adds.
//  * Y column-major: each row's values go out as the same runs.  Y
//    plane-major: the 32 rows x tile block is staged in shared memory and
//    each plane's 32 rows go out as one contiguous run (the tile is at
//    most two chunks, which bounds the stage; at m = 80 one pass of five
//    ran within 0.5 % of it, on the card above).
//  * Each entry of Y is summed over its row's slots in slot order from
//    zero, acc += v * x (one fma), as kernel C sums: column t of the
//    result is bitwise kernel C on column t of X.  Rows longer than ks
//    slots carry their partial sums through Y between staging rounds,
//    exactly.  No atomics.
//
// What bounds kernel C: memory.  It moves capacity * (itemsize + 4) bytes
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
// Complex values.  Both kernels are also instantiated for complex64 and
// complex128, stored as float2 / double2 (the layout of a torch complex
// tensor).  Every term is one cfma, the same four real fmas in the same
// order (fma_t below), in kernel C and in kernel D alike, so column t of
// kernel D is still bitwise kernel C on column t.  A vector access stays 16
// bytes (two complex64 values or one complex128), so kernel D's registers
// per chunk are those of the real types; a staged complex128 slot is one
// 16-byte cp.async, which doubles f64's staging footprint (kMaxStage slots
// of 16 + 4 bytes a lane).  The JAX package runs a complex WELL as real
// plane passes of its Pallas kernels; here one pass reads the complex
// values once.
//
// Both kernels launch on the caller's stream, allocate nothing, and return
// cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // a multiple of 32: a warp is one slice
constexpr int kSlice = 32;
constexpr int kBatch = 8;  // slots of a row loaded before their gathers
constexpr int kSpmmWarps = 4;  // kernel D: warps a block, one slice each
constexpr int kStagePad = kSlice + 1;  // Y stage row stride (no bank clash)
constexpr int kMaxStage = 32;  // kernel D: most slots a row staged at a time
constexpr int kMaxDevices = 64;

// The element types: float, double, and complex64 / complex128 as float2 /
// double2.
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

// a * b + c rounded once: the one fma of every slot of kernels C and D
// (written out, so that the two kernels cannot contract differently)
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
    T acc = zero_t<T>();
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
        if (k0 + j < width) acc = fma_t(v[j], xv[j], acc);
      }
    }
    __stcs(y + i, acc);
  }
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

// One element from device to shared memory, asynchronously, under an L2
// cache policy.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         uint64_t policy) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global.L2::cache_hint [%0], [%1], %2, %3;"
               :
               : "r"(dst), "l"(gmem), "n"(kBytes), "l"(policy)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// V consecutive values of a row of X or Y: one 16-byte access, or one value.
// X is read through the read-only path; Y's partial sums, which the kernel
// itself wrote, are read back by plain loads.
template <typename T, int V>
struct Run;

template <typename T>
struct Run<T, 1> {
  __device__ static void load(const T* p, T (&v)[1]) { v[0] = __ldg(p); }
  __device__ static void reload(const T* p, T (&v)[1]) { v[0] = *p; }
  __device__ static void store(T* p, const T (&v)[1]) { __stcs(p, v[0]); }
};

template <>
struct Run<double, 2> {
  __device__ static void load(const double* p, double (&v)[2]) {
    const double2 d = __ldg(reinterpret_cast<const double2*>(p));
    v[0] = d.x;
    v[1] = d.y;
  }
  __device__ static void reload(const double* p, double (&v)[2]) {
    const double2 d = *reinterpret_cast<const double2*>(p);
    v[0] = d.x;
    v[1] = d.y;
  }
  __device__ static void store(double* p, const double (&v)[2]) {
    __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
  }
};

template <>
struct Run<float2, 2> {
  __device__ static void load(const float2* p, float2 (&v)[2]) {
    const float4 d = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = make_float2(d.x, d.y);
    v[1] = make_float2(d.z, d.w);
  }
  __device__ static void reload(const float2* p, float2 (&v)[2]) {
    const float4 d = *reinterpret_cast<const float4*>(p);
    v[0] = make_float2(d.x, d.y);
    v[1] = make_float2(d.z, d.w);
  }
  __device__ static void store(float2* p, const float2 (&v)[2]) {
    __stcs(reinterpret_cast<float4*>(p),
           make_float4(v[0].x, v[0].y, v[1].x, v[1].y));
  }
};

template <>
struct Run<float, 4> {
  __device__ static void load(const float* p, float (&v)[4]) {
    const float4 d = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = d.x;
    v[1] = d.y;
    v[2] = d.z;
    v[3] = d.w;
  }
  __device__ static void reload(const float* p, float (&v)[4]) {
    const float4 d = *reinterpret_cast<const float4*>(p);
    v[0] = d.x;
    v[1] = d.y;
    v[2] = d.z;
    v[3] = d.w;
  }
  __device__ static void store(float* p, const float (&v)[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};

// Shared memory of one warp of kernel D: the staged slots (ks a row:
// values, then columns) and, plane-major, the Y stage of `tile` columns x
// 32 rows; a multiple of 16 bytes.
__host__ __device__ inline size_t spmm_warp_bytes(size_t item, int ks,
                                                  int tile) {
  const size_t bytes = static_cast<size_t>(ks) * kSlice * (item + 4) +
                       static_cast<size_t>(tile) * kStagePad * item;
  return (bytes + 15) / 16 * 16;
}

// x: (nc, m) row-major.  y_row / y_rhs: element strides of Y between rows
// of A and between right-hand sides; y_row == 1 is plane-major, staged.
// A group of G lanes takes one row, V values a lane (V > 1: one 16-byte
// vector; then m % V == 0, x is 16-byte aligned and, column-major,
// y_rhs == 1), C chunks of G * V columns a pass; ks slots a row are staged
// at a time.
template <typename T, int V, int G, int C>
__global__ void __launch_bounds__(kSpmmWarps * kSlice)
    well_spmm_kernel(const int64_t* __restrict__ slice_ptr,
                     const int32_t* __restrict__ cols,
                     const T* __restrict__ vals, const T* __restrict__ x,
                     T* __restrict__ y, int64_t nr, int64_t m, int64_t y_row,
                     int64_t y_rhs, int ks) {
  constexpr int R = kSlice / G;  // rows a warp takes at a time
  constexpr int W = G * V;       // columns of a chunk
  constexpr int B = C == 1 ? kBatch : (C == 2 ? 4 : 2);  // slots a batch
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / kSlice;
  const int lane = threadIdx.x % kSlice;
  const int h = lane / G;
  const int tv = (lane % G) * V;  // this lane's first column in a chunk
  const bool planes = y_row == 1;
  const int tile = C * W;
  T* sv = reinterpret_cast<T*>(
      smem + warp * spmm_warp_bytes(sizeof(T), ks, planes ? tile : 0));
  int32_t* sc = reinterpret_cast<int32_t*>(sv + ks * kSlice);
  T* sy = reinterpret_cast<T*>(sc + ks * kSlice);
  const uint64_t policy = evict_first_policy();
  const int64_t n_slices = (nr + kSlice - 1) / kSlice;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kSpmmWarps;
  for (int64_t s = static_cast<int64_t>(blockIdx.x) * kSpmmWarps + warp;
       s < n_slices; s += warps) {
    const int64_t begin = __ldg(slice_ptr + s);
    const int width = static_cast<int>((__ldg(slice_ptr + s + 1) - begin) /
                                       kSlice);
    const int64_t row0 = s * kSlice;
    // staging rounds of ks slots; an empty slice takes one, of none
    for (int k0 = 0; k0 == 0 || k0 < width; k0 += ks) {
      const int kn = width - k0 < ks ? width - k0 : ks;
      const bool first = k0 == 0;
      __syncwarp();  // the slots of the previous round are read
      for (int k = 0; k < kn; ++k) {
        const int64_t p = begin + static_cast<int64_t>(k0 + k) * kSlice + lane;
        cp_async<sizeof(T)>(sv + k * kSlice + lane, vals + p, policy);
        cp_async<4>(sc + k * kSlice + lane, cols + p, policy);
      }
      cp_async_wait_all();
      __syncwarp();
      for (int64_t t0 = 0; t0 < m; t0 += tile) {
        const int nt = static_cast<int>(m - t0 < tile ? m - t0 : tile);
        if (planes && !first) {  // this round continues the sums in Y
          for (int j = 0; j < nt; ++j) {
            sy[j * kStagePad + lane] =
                row0 + lane < nr ? y[(t0 + j) * y_rhs + row0 + lane]
                                 : zero_t<T>();
          }
          __syncwarp();
        }
        for (int r = h; r < kSlice; r += R) {
          const int64_t row = row0 + r;
          T acc[C][V];
#pragma unroll
          for (int c = 0; c < C; ++c) {
#pragma unroll
            for (int v = 0; v < V; ++v) acc[c][v] = zero_t<T>();
            const int col = c * W + tv;
            if (!first && col < nt) {
              if (planes) {
#pragma unroll
                for (int v = 0; v < V; ++v) {
                  acc[c][v] = sy[(col + v) * kStagePad + r];
                }
              } else if (row < nr) {
                Run<T, V>::reload(y + row * y_row + (t0 + col) * y_rhs,
                                  acc[c]);
              }
            }
          }
          const T* xr = x + t0 + tv;
          for (int k = 0; k < kn; k += B) {
            T vv[B];
            T xv[B][C][V];
#pragma unroll
            for (int j = 0; j < B; ++j) {
              if (k + j < kn) {
                const int q = (k + j) * kSlice + r;
                vv[j] = sv[q];
                const T* xc = xr + static_cast<int64_t>(sc[q]) * m;
#pragma unroll
                for (int c = 0; c < C; ++c) {
                  if (c * W + tv < nt) Run<T, V>::load(xc + c * W, xv[j][c]);
                }
              }
            }
#pragma unroll
            for (int j = 0; j < B; ++j) {
              if (k + j < kn) {
#pragma unroll
                for (int c = 0; c < C; ++c) {
                  if (c * W + tv < nt) {
#pragma unroll
                    for (int v = 0; v < V; ++v) {
                      acc[c][v] = fma_t(vv[j], xv[j][c][v], acc[c][v]);
                    }
                  }
                }
              }
            }
          }
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const int col = c * W + tv;
            if (col < nt) {
              if (planes) {
#pragma unroll
                for (int v = 0; v < V; ++v) {
                  sy[(col + v) * kStagePad + r] = acc[c][v];
                }
              } else if (row < nr) {
                Run<T, V>::store(y + row * y_row + (t0 + col) * y_rhs,
                                 acc[c]);
              }
            }
          }
        }
        if (planes) {  // each plane's 32 rows as one run
          __syncwarp();
          if (row0 + lane < nr) {
            for (int j = 0; j < nt; ++j) {
              __stcs(y + (t0 + j) * y_rhs + row0 + lane,
                     sy[j * kStagePad + lane]);
            }
          }
          __syncwarp();
        }
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

// Blocks of kernel D on the whole card at once, for one instantiation at
// `ks` staged slots and one layout of Y.  The runtime is asked once per
// (device, ks, layout), on the first launch, which also raises the
// instantiation's dynamic shared-memory limit to the most any ks takes;
// later launches read the count kept.  Two threads racing on a first
// launch ask twice and keep the same count.
template <typename T, int V, int G, int C>
cudaError_t spmm_resident_blocks(int device, int ks, bool planes,
                                 size_t smem, long long* blocks) {
  static std::atomic<long long> kept[kMaxDevices][kMaxStage][2];  // 0s
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::atomic<long long>& slot = kept[device][ks - 1][planes];
  long long n = slot.load(std::memory_order_relaxed);
  if (n > 0) {
    *blocks = n;
    return cudaSuccess;
  }
  auto kernel = well_spmm_kernel<T, V, G, C>;
  const size_t most = kSpmmWarps * spmm_warp_bytes(sizeof(T), kMaxStage,
                                                   C * G * V);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(most));
  if (err != cudaSuccess) return err;
  int sms = 0;
  int per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kSpmmWarps * kSlice, smem);
  if (err != cudaSuccess) return err;
  if (sms <= 0 || per_sm <= 0) return cudaErrorLaunchOutOfResources;
  n = static_cast<long long>(sms) * per_sm;
  slot.store(n, std::memory_order_relaxed);
  *blocks = n;
  return cudaSuccess;
}

// Kernel D as a persistent grid: as many blocks as fit on the card at
// once (fewer for a small matrix), each warp walking slices grid-stride.
template <typename T, int V, int G, int C>
int launch_spmm_as(const void* slice_ptr, const void* cols, const void* vals,
                   const void* x, void* y, long long nr, long long m,
                   long long y_row, long long y_rhs, int ks, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto kernel = well_spmm_kernel<T, V, G, C>;
  const bool planes = y_row == 1;
  const size_t smem =
      kSpmmWarps * spmm_warp_bytes(sizeof(T), ks, planes ? C * G * V : 0);
  long long cap = 0;
  err = spmm_resident_blocks<T, V, G, C>(device, ks, planes, smem, &cap);
  if (err != cudaSuccess) return err;
  const long long want = ((nr + kSlice - 1) / kSlice + kSpmmWarps - 1) /
                         kSpmmWarps;
  const unsigned blocks = static_cast<unsigned>(want < cap ? want : cap);
  kernel<<<blocks, kSpmmWarps * kSlice, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(slice_ptr),
      static_cast<const int32_t*>(cols), static_cast<const T*>(vals),
      static_cast<const T*>(x), static_cast<T*>(y), nr, m, y_row, y_rhs, ks);
  return cudaGetLastError();
}

// The wrapper chooses the geometry (spmv_well._spmm_plan): vector or
// scalar lanes, G lanes a row and C chunks a lane.  Vector lanes take
// G in {1, 2, 4} with one chunk or G = 8 with one to five; scalar lanes
// one chunk of G in {1, ..., 128 / itemsize}.  A vector is 16 bytes: four
// floats, two doubles or complex64s, one complex128.
template <typename T>
int launch_spmm(const void* slice_ptr, const void* cols, const void* vals,
                const void* x, void* y, long long nr, long long m,
                long long y_row, long long y_rhs, int vec, int lanes,
                int chunks, int ks, int device, void* stream) {
  constexpr int VX = 16 / sizeof(T);
  if (ks < 1 || ks > kMaxStage) return cudaErrorInvalidValue;
#define SLT_SPMM(V, G, C)                                                   \
  return launch_spmm_as<T, V, G, C>(slice_ptr, cols, vals, x, y, nr, m,    \
                                    y_row, y_rhs, ks, device, stream)
  if (vec && chunks == 1) {
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
      case 5: SLT_SPMM(VX, 8, 5);
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
  return cudaErrorInvalidValue;
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
                      long long m, long long y_row, long long y_rhs, int vec,
                      int lanes, int chunks, int ks, int device,
                      void* stream) {
  return launch_spmm<float>(slice_ptr, cols, vals, x, y, nr, m, y_row, y_rhs,
                            vec, lanes, chunks, ks, device, stream);
}

int slt_well_spmm_f64(const void* slice_ptr, const void* cols,
                      const void* vals, const void* x, void* y, long long nr,
                      long long m, long long y_row, long long y_rhs, int vec,
                      int lanes, int chunks, int ks, int device,
                      void* stream) {
  return launch_spmm<double>(slice_ptr, cols, vals, x, y, nr, m, y_row,
                             y_rhs, vec, lanes, chunks, ks, device, stream);
}

int slt_well_spmv_c64(const void* slice_ptr, const void* cols,
                      const void* vals, const void* x, void* y, long long nr,
                      int device, void* stream) {
  return launch_spmv<float2>(slice_ptr, cols, vals, x, y, nr, device, stream);
}

int slt_well_spmv_c128(const void* slice_ptr, const void* cols,
                       const void* vals, const void* x, void* y, long long nr,
                       int device, void* stream) {
  return launch_spmv<double2>(slice_ptr, cols, vals, x, y, nr, device, stream);
}

int slt_well_spmm_c64(const void* slice_ptr, const void* cols,
                      const void* vals, const void* x, void* y, long long nr,
                      long long m, long long y_row, long long y_rhs, int vec,
                      int lanes, int chunks, int ks, int device,
                      void* stream) {
  return launch_spmm<float2>(slice_ptr, cols, vals, x, y, nr, m, y_row, y_rhs,
                             vec, lanes, chunks, ks, device, stream);
}

int slt_well_spmm_c128(const void* slice_ptr, const void* cols,
                       const void* vals, const void* x, void* y, long long nr,
                       long long m, long long y_row, long long y_rhs, int vec,
                       int lanes, int chunks, int ks, int device,
                       void* stream) {
  return launch_spmm<double2>(slice_ptr, cols, vals, x, y, nr, m, y_row,
                              y_rhs, vec, lanes, chunks, ks, device, stream);
}

}  // extern "C"
