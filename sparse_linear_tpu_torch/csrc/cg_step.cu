// CG's vector work for Hopper (sm_90a), bound to Python with ctypes: the
// three passes of one unpreconditioned conjugate-gradient iteration, with
// every scalar of the iteration and the stop test kept in device memory.
//
// They replace no TPU kernel: the JAX package's solve/cg.py runs its
// iteration under lax.while_loop, which XLA fuses and keeps on the chip.
// The port's first loop (solve/cg.py) ran the same steps as separate
// PyTorch calls (addcmul_, dot, mul_, add_: about 1.2 GB of vector passes
// an iteration at 10M unknowns in f64) and read ||r||^2 on the host every
// iteration, so the card idled while Python queued the next product.  These
// kernels take A p from the caller's product (kernel A or C) and do the
// rest:
//
//   cg_pq:        pq = Re(p^H q);  alpha = gamma / pq          reads p, q
//   cg_update:    x += alpha p;  r -= alpha q;  g = Re(r^H r) in the same
//                 pass; beta = g / gamma; gamma = g; iter += 1; stop once
//                 not (g > target)          reads x, p, r, q; writes x, r
//   cg_direction: p = r + beta p                 reads r, p; writes p
//
// 11 vector passes of n values an iteration against about 15 before
// (880 MB at 10M unknowns in f64), in three launches.  What bounds them:
// bytes.  Each element takes a few flops against 16-48 bytes, far below the
// card's balance point, so the design is the plain one: one thread an
// element in a grid-stride loop, neighbouring threads on neighbouring
// addresses, as many blocks as fill the card (the wrapper's `blocks`).
//
// The state (float64, the wrapper's cg_state): slots kGamma .. kTicket,
// then one partial sum a block.  The scalars are doubles for every element
// type (a float is widened exactly); alpha and beta are read back in the
// part type of T.
//
// Reductions are in a fixed order, with no floating-point atomics, so two
// runs give bitwise the same sums: each thread sums its elements in index
// order, a block sums its threads with a fixed shuffle tree, each block
// stores its partial in its own slot, and the last block to finish (an
// unsigned-int ticket counted with atomicAdd) sums the partials with the
// same fixed tree and writes the scalars.  The sums are taken in double for
// every element type.  The ticket is an unsigned int in slot kTicket's
// bytes, zero between launches (the last block resets it).
//
// Stop contract: every kernel reads the stop flag first and does nothing
// once it is set, so x, r and p at the end are bitwise the state of the
// iteration that set it, however many iterations are queued after it.  The
// flag is written only by cg_update's last block, after every block of that
// launch has read it, so all blocks of a launch see the same flag.
//
// Complex values (complex64 / complex128 as float2 / double2): alpha and
// beta stay real (Re of the inner products, for a Hermitian operator), and
// scale both parts with one fma each.
//
// The kernels launch on the caller's stream, allocate nothing, and return
// cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// slots of the state, in doubles; the wrapper (kernels/cg_step.py) names
// the same slots
constexpr int kGamma = 0;   // Re(r^H r) of the current r
constexpr int kAlpha = 1;   // gamma / Re(p^H A p)
constexpr int kBeta = 2;    // gamma_new / gamma_old
constexpr int kTarget = 3;  // (tol * ||b||)^2
constexpr int kStop = 4;    // 1 once not (gamma > target)
constexpr int kIter = 5;    // iterations done
constexpr int kTicket = 7;  // the last-block ticket (unsigned int bytes)
constexpr int kSlots = 8;   // partial sums start here

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

// Re(conj(a) b), in double
__device__ __forceinline__ double re_dot(float a, float b) {
  return static_cast<double>(a) * static_cast<double>(b);
}
__device__ __forceinline__ double re_dot(double a, double b) { return a * b; }
__device__ __forceinline__ double re_dot(float2 a, float2 b) {
  return fma(static_cast<double>(a.x), static_cast<double>(b.x),
             static_cast<double>(a.y) * static_cast<double>(b.y));
}
__device__ __forceinline__ double re_dot(double2 a, double2 b) {
  return fma(a.x, b.x, a.y * b.y);
}

// s * a + c for a real s, rounded once a part
__device__ __forceinline__ float axpy(float s, float a, float c) {
  return fmaf(s, a, c);
}
__device__ __forceinline__ double axpy(double s, double a, double c) {
  return fma(s, a, c);
}
__device__ __forceinline__ float2 axpy(float s, float2 a, float2 c) {
  return make_float2(fmaf(s, a.x, c.x), fmaf(s, a.y, c.y));
}
__device__ __forceinline__ double2 axpy(double s, double2 a, double2 c) {
  return make_double2(fma(s, a.x, c.x), fma(s, a.y, c.y));
}

// The block's sum of v, in thread 0: a fixed shuffle tree in each warp, then
// over the warps.  Callers separate two calls by a __syncthreads.
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0.0;
  if (warp == 0) {
    if (lane < kWarps) v = warp_sums[lane];
#pragma unroll
    for (int o = kWarps / 2; o > 0; o >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// The grid's sum of v.  Every block stores its partial; true in thread 0 of
// the last block to finish, with the total in *total.  All threads of every
// block must call it.
__device__ __forceinline__ bool grid_sum(double v, double* state,
                                         double* total) {
  __shared__ bool last;
  double* partials = state + kSlots;
  unsigned int* ticket = reinterpret_cast<unsigned int*>(state + kTicket);
  v = block_sum(v);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = v;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  double s = 0.0;
  for (unsigned b = threadIdx.x; b < gridDim.x; b += blockDim.x)
    s += __ldcg(partials + b);
  s = block_sum(s);
  if (threadIdx.x != 0) return false;
  *ticket = 0u;
  *total = s;
  return true;
}

__device__ __forceinline__ bool stopped(const double* state) {
  return state[kStop] != 0.0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    cg_pq_kernel(const T* __restrict__ p, const T* __restrict__ q,
                 double* state, int64_t n) {
  if (stopped(state)) return;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  double acc = 0.0;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride)
    acc += re_dot(p[i], q[i]);
  double pq;
  if (grid_sum(acc, state, &pq)) state[kAlpha] = state[kGamma] / pq;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    cg_update_kernel(T* __restrict__ x, T* __restrict__ r,
                     const T* __restrict__ p, const T* __restrict__ q,
                     double* state, int64_t n) {
  using P = typename Part<T>::type;
  if (stopped(state)) return;
  const P alpha = static_cast<P>(state[kAlpha]);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  double acc = 0.0;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const T ri = axpy(-alpha, q[i], r[i]);
    x[i] = axpy(alpha, p[i], x[i]);
    r[i] = ri;
    acc += re_dot(ri, ri);
  }
  double g;
  if (grid_sum(acc, state, &g)) {
    state[kBeta] = g / state[kGamma];
    state[kGamma] = g;
    state[kIter] += 1.0;
    if (!(g > state[kTarget])) state[kStop] = 1.0;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    cg_direction_kernel(T* __restrict__ p, const T* __restrict__ r,
                        const double* state, int64_t n) {
  using P = typename Part<T>::type;
  if (stopped(state)) return;
  const P beta = static_cast<P>(state[kBeta]);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride)
    p[i] = axpy(beta, p[i], r[i]);
}

template <typename T>
int launch_pq(const void* p, const void* q, void* state, long long n,
              int blocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cg_pq_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(p), static_cast<const T*>(q),
      static_cast<double*>(state), n);
  return cudaGetLastError();
}

template <typename T>
int launch_update(void* x, void* r, const void* p, const void* q, void* state,
                  long long n, int blocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cg_update_kernel<T>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<T*>(x), static_cast<T*>(r), static_cast<const T*>(p),
          static_cast<const T*>(q), static_cast<double*>(state), n);
  return cudaGetLastError();
}

template <typename T>
int launch_direction(void* p, const void* r, const void* state, long long n,
                     int blocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cg_direction_kernel<T>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<T*>(p), static_cast<const T*>(r),
          static_cast<const double*>(state), n);
  return cudaGetLastError();
}

}  // namespace

#define SLT_CG_STEP(SUFFIX, T)                                                \
  int slt_cg_pq_##SUFFIX(const void* p, const void* q, void* state,          \
                         long long n, int blocks, int device, void* stream) { \
    return launch_pq<T>(p, q, state, n, blocks, device, stream);             \
  }                                                                           \
  int slt_cg_update_##SUFFIX(void* x, void* r, const void* p, const void* q, \
                             void* state, long long n, int blocks,           \
                             int device, void* stream) {                     \
    return launch_update<T>(x, r, p, q, state, n, blocks, device, stream);   \
  }                                                                           \
  int slt_cg_direction_##SUFFIX(void* p, const void* r, const void* state,   \
                                long long n, int blocks, int device,         \
                                void* stream) {                              \
    return launch_direction<T>(p, r, state, n, blocks, device, stream);      \
  }

extern "C" {

SLT_CG_STEP(f32, float)
SLT_CG_STEP(f64, double)
SLT_CG_STEP(c64, float2)
SLT_CG_STEP(c128, double2)

}  // extern "C"
