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
// a 4.2M-row f32 Poisson operator (84 MB) only in part.
//
// What bounds them: memory.  Kernel A moves (ndiag + 2) * nr * itemsize
// bytes (117 MB for f32 at 2048^2) for 2 * ndiag flops per row, far below
// the card's balance point, so wgmma and TMA do not apply.  The design is
// the simple one that is right: one thread per output row in a grid-stride
// loop, so that a warp reads 32 consecutive entries of data[d, :] and of
// x[i + off_d] (both coalesced), with alpha fused into the store.  Shared
// memory x tiles and L2 reuse across steps are later work.
//
// Both kernels launch on the caller's stream, allocate nothing, and return
// cudaGetLastError() after the launch (0 on success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

// One output row.  x is read with ordinary loads: in the chain it is a
// vector that other blocks wrote during this launch, which the read-only
// (non-coherent) path must not serve.
template <typename T>
__device__ __forceinline__ T dia_row(const T* __restrict__ data,
                                     const int64_t* __restrict__ offsets,
                                     const T* x, int64_t ndiag, int64_t nr,
                                     int64_t nc, int64_t i) {
  T acc = T(0);
  for (int64_t d = 0; d < ndiag; ++d) {
    const int64_t j = i + __ldg(offsets + d);
    if (j >= 0 && j < nc) acc += __ldg(data + d * nr + i) * x[j];
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dia_chain_kernel(const T* __restrict__ data,
                     const int64_t* __restrict__ offsets, const T* x, T* buf0,
                     T* buf1, int64_t ndiag, int64_t n, int k, T alpha) {
  cg::grid_group grid = cg::this_grid();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const T* src = x;
  for (int s = 0; s < k; ++s) {
    T* dst = (s & 1) ? buf1 : buf0;
    for (int64_t i = first; i < n; i += stride) {
      dst[i] = alpha * dia_row(data, offsets, src, ndiag, n, n, i);
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
int launch_chain(const void* data, const void* offsets, const void* x,
                 void* buf0, void* buf1, long long ndiag, long long n, int k,
                 double alpha, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, dia_chain_kernel<T>, kThreads, 0);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  const long long resident = static_cast<long long>(per_sm) * sms;
  const long long want = (n + kThreads - 1) / kThreads;
  const long long blocks = want < resident ? want : resident;
  if (blocks < 1) return cudaErrorLaunchOutOfResources;

  const T* data_p = static_cast<const T*>(data);
  const int64_t* offsets_p = static_cast<const int64_t*>(offsets);
  const T* x_p = static_cast<const T*>(x);
  T* buf0_p = static_cast<T*>(buf0);
  T* buf1_p = static_cast<T*>(buf1);
  int64_t ndiag_v = ndiag;
  int64_t n_v = n;
  int k_v = k;
  T alpha_v = static_cast<T>(alpha);
  void* args[] = {&data_p, &offsets_p, &x_p,  &buf0_p, &buf1_p,
                  &ndiag_v, &n_v,      &k_v, &alpha_v};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(dia_chain_kernel<T>),
      dim3(static_cast<unsigned>(blocks)), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
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
