// Fused RMSNorm for Hopper (sm_90a): out = x * rsqrt(mean(x^2) + eps) * w
// row by row, computed in fp32 and cast back to x's dtype.
// x (rows, d) fp32 or bf16; w (d,) fp32 or x's dtype; out (rows, d) in x's
// dtype.
//
// Replaces: the Pallas `rmsnorm` kernel, src/repro/kernels/rmsnorm.py
// (`_rmsnorm_kernel` :19-23, launched by `rmsnorm` :27-47), which computes
// exactly the function every JAX model layer calls
// (src/repro/models/layers.py:27-31): the port's decoder runs it for both
// norms of every layer and for the final norm.
//
// Bound on the card: bytes.  A row does 4 d operations on 2 d values, far
// below the 295 operations per byte at which compute would bind, so the
// least time is (x + out + w) bytes over HBM3's 3.35 TB/s: 0.002507 ms for a
// 1024 x 2048 bf16 prefill slab.  A decode step's 1-4 rows are launch-bound.
//
// Design: the TPU kernel streams (block_rows, d) tiles through VMEM with the
// weight resident, so x crosses HBM once each way.  Here a row is owned by
// WPR warps, the fewest (1, 2, 4 or 8) that keep each lane at kMaxVec or
// fewer 16-byte vectors (8 bf16 or 4 fp32): one warp at d <= 2048 bf16 or
// 1024 fp32.  Up to kFewRows rows (a decode step), which would leave most
// SMs idle, a row gets 8 warps where every lane still holds a vector, so
// its loads start from more SMs at once.  WPR is a template parameter,
// picked from d and the row count at launch.  Each lane issues every load
// it needs before it waits on any: first w's vectors for its columns (read
// through L2 with an evict-last policy: every row reads the same w), then
// its row's x vectors with the streaming hint (`.cs`: x is read once).
// Then it sums its squares in fp32, and the row reduces them by shuffles
// alone where one warp owns it, or through shared memory and a named
// barrier of the row's warps.  Then it scales its cached vectors, (x * r) *
// w in fp32, and stores them once (`.cs` again).  A block holds R rows, R
// from the row count so that the grid covers the SMs once (R = 8 and 128
// blocks at 1024 rows, R = 2 at 256, R = 1 below 133): no block barrier
// anywhere.
//
// Chosen by timing (kernel_bench.py against variant trees, H100 at 700 W):
// w staged in shared memory by cp.async behind one block barrier ran
// 0.0004-0.0006 ms slower at 4, 256 and 1024 rows; w read without the L2
// policy 0.0001-0.0005 slower; a warp owning two rows and reading w once
// for both 0.003-0.004 slower; one warp a row at 4 rows about 0.0002 slower
// than 8.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::sm_count;

using bf16 = __nv_bfloat16;

constexpr int kMaxThreads = 256;  // a block: up to 8 warps
constexpr int kMaxVec = 8;        // 16-byte vectors of x a lane caches
constexpr int kMaxWarpsPerRow = 8;
constexpr int kFewRows = 32;      // up to this many rows, 8 warps a row

template <typename T>
struct Vec {  // values of T in 16 bytes
  static constexpr int n = 16 / sizeof(T);
};

__device__ inline void to_float(const uint4& raw, float* f, float) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}

__device__ inline void to_float(const uint4& raw, float* f, bf16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ inline uint4 from_float(const float* f, float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

__device__ inline uint4 from_float(const float* f, bf16) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return raw;
}

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// an L2 policy that keeps the lines it loads past streaming traffic
__device__ inline uint64_t evict_last_policy() {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

__device__ inline uint4 load_evict_last(const uint4* p, uint64_t policy) {
  uint4 v;
  asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

// TX is x's and out's type, TW w's; a row is owned by WPR warps, and the
// block holds blockDim.x / (32 WPR) rows.  d is a multiple of Vec<TX>::n and
// Vec<TX>::n a multiple of Vec<TW>::n (the wrapper takes w in fp32 or TX).
template <typename TX, typename TW, int WPR>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_rows(const TX* __restrict__ x, const TW* __restrict__ w,
             TX* __restrict__ out, int rows, int d, float eps) {
  constexpr int N = Vec<TX>::n;
  constexpr int WV = N / Vec<TW>::n;  // w vectors under one x vector
  constexpr int T = 32 * WPR;         // threads of a row
  const int n_vec = d / N;
  const int t = threadIdx.x % T;
  const int row_in_block = threadIdx.x / T;
  const int row = blockIdx.x * (blockDim.x / T) + row_in_block;
  if (row >= rows) return;  // a whole row's warps leave together

  const uint4* wv = reinterpret_cast<const uint4*>(w);
  const uint4* xr = reinterpret_cast<const uint4*>(x + (int64_t)row * d);
  uint4* orow = reinterpret_cast<uint4*>(out + (int64_t)row * d);

  // every load before the first wait: w's vectors, then x's
  const uint64_t policy = evict_last_policy();
  uint4 wc[kMaxVec][WV], xc[kMaxVec];
#pragma unroll
  for (int j = 0; j < kMaxVec; ++j) {
    const int i = t + j * T;
    if (i < n_vec) {
#pragma unroll
      for (int c = 0; c < WV; ++c) wc[j][c] = load_evict_last(wv + i * WV + c, policy);
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxVec; ++j) {
    const int i = t + j * T;
    if (i < n_vec) xc[j] = __ldcs(xr + i);
  }

  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxVec; ++j) {
    if (t + j * T < n_vec) {
      float f[N];
      to_float(xc[j], f, TX());
#pragma unroll
      for (int k = 0; k < N; ++k) ss = fmaf(f[k], f[k], ss);
    }
  }
  ss = warp_sum(ss);
  if constexpr (WPR > 1) {
    // the row's warps meet at their own barrier (ids 1.., 0 is the block's)
    __shared__ float partial[kMaxThreads / 32];
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) partial[warp] = ss;
    asm volatile("bar.sync %0, %1;" ::"r"(1 + row_in_block), "r"(T));
    ss = 0.f;
#pragma unroll
    for (int k = 0; k < WPR; ++k) ss += partial[warp - warp % WPR + k];
  }
  const float r = rsqrtf(ss / (float)d + eps);

#pragma unroll
  for (int j = 0; j < kMaxVec; ++j) {
    const int i = t + j * T;
    if (i < n_vec) {
      float f[N], wf[N];
      to_float(xc[j], f, TX());
#pragma unroll
      for (int c = 0; c < WV; ++c) to_float(wc[j][c], wf + c * (N / WV), TW());
#pragma unroll
      for (int k = 0; k < N; ++k) f[k] = (f[k] * r) * wf[k];
      __stcs(orow + i, from_float(f, TX()));
    }
  }
}

template <typename TX, typename TW, int WPR>
cudaError_t launch_rows(const void* x, const void* w, void* out, int rows,
                        int d, float eps, int device, cudaStream_t s) {
  constexpr int T = 32 * WPR;
  // rows a block: enough that the grid covers the SMs about once
  const int sms = sm_count(device);
  int per_block = (rows + sms - 1) / sms;
  if (per_block > kMaxThreads / T) per_block = kMaxThreads / T;
  const int blocks = (rows + per_block - 1) / per_block;
  rmsnorm_rows<TX, TW, WPR><<<blocks, per_block * T, 0, s>>>(
      (const TX*)x, (const TW*)w, (TX*)out, rows, d, eps);
  return cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, void* out, int rows, int d,
                   float eps, int device, cudaStream_t s) {
  if (d <= 0 || d % Vec<TX>::n) return cudaErrorInvalidValue;
  const int n_vec = d / Vec<TX>::n;
  const int per_warp = 32 * kMaxVec;
  // few rows leave most SMs idle: spread each over 8 warps where every
  // lane still holds a vector
  if (rows <= kFewRows && n_vec >= 32 * kMaxWarpsPerRow)
    return launch_rows<TX, TW, 8>(x, w, out, rows, d, eps, device, s);
  if (n_vec <= per_warp)
    return launch_rows<TX, TW, 1>(x, w, out, rows, d, eps, device, s);
  if (n_vec <= 2 * per_warp)
    return launch_rows<TX, TW, 2>(x, w, out, rows, d, eps, device, s);
  if (n_vec <= 4 * per_warp)
    return launch_rows<TX, TW, 4>(x, w, out, rows, d, eps, device, s);
  if (n_vec <= kMaxWarpsPerRow * per_warp)
    return launch_rows<TX, TW, 8>(x, w, out, rows, d, eps, device, s);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The two halves of a norm whose row is split across ranks (the model's
// partial-sum path): each rank's sum of squares over its own columns, an
// all-reduce of those (rows,) fp32 sums outside, then the scale of its own
// columns by the whole row's r.  A row is owned by one warp, which loops
// over its 16-byte vectors kUnroll at a time (every load of a round before
// the first use), 8 rows a block.  Both are bytes-bound, like the whole-row
// kernel: sumsq reads x once and writes 4 bytes a row; scale reads x, w and
// the totals once and writes the row once.  sumsq reads x through L2 with
// the default policy (the scale reads it again right after); the scale's x
// and out take the streaming hint, w the evict-last policy.

constexpr int kUnroll = 4;  // vectors a lane has in flight

template <typename TX>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_sumsq_rows(const TX* __restrict__ x, float* __restrict__ out,
                   int rows, int d) {
  constexpr int N = Vec<TX>::n;
  const int n_vec = d / N;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (int64_t)row * d);
  float ss = 0.f;
  for (int i0 = lane; i0 < n_vec; i0 += 32 * kUnroll) {
    uint4 xc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i0 + 32 * u < n_vec) xc[u] = xr[i0 + 32 * u];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i0 + 32 * u < n_vec) {
        float f[N];
        to_float(xc[u], f, TX());
#pragma unroll
        for (int k = 0; k < N; ++k) ss = fmaf(f[k], f[k], ss);
      }
    }
  }
  ss = warp_sum(ss);
  if (lane == 0) out[row] = ss;
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_scale_rows(const TX* __restrict__ x, const TW* __restrict__ w,
                   const float* __restrict__ total, TX* __restrict__ out,
                   int rows, int d, int d_full, float eps) {
  constexpr int N = Vec<TX>::n;
  constexpr int WV = N / Vec<TW>::n;  // w vectors under one x vector
  const int n_vec = d / N;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  // the whole-row kernel's arithmetic: rsqrt(sum / d + eps), (x * r) * w
  const float r = rsqrtf(total[row] / (float)d_full + eps);
  const uint4* wv = reinterpret_cast<const uint4*>(w);
  const uint4* xr = reinterpret_cast<const uint4*>(x + (int64_t)row * d);
  uint4* orow = reinterpret_cast<uint4*>(out + (int64_t)row * d);
  const uint64_t policy = evict_last_policy();
  for (int i0 = lane; i0 < n_vec; i0 += 32 * kUnroll) {
    uint4 xc[kUnroll], wc[kUnroll][WV];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + 32 * u;
      if (i < n_vec) {
#pragma unroll
        for (int c = 0; c < WV; ++c) wc[u][c] = load_evict_last(wv + i * WV + c, policy);
        xc[u] = __ldcs(xr + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + 32 * u;
      if (i < n_vec) {
        float f[N], wf[N];
        to_float(xc[u], f, TX());
#pragma unroll
        for (int c = 0; c < WV; ++c) to_float(wc[u][c], wf + c * (N / WV), TW());
#pragma unroll
        for (int k = 0; k < N; ++k) f[k] = (f[k] * r) * wf[k];
        __stcs(orow + i, from_float(f, TX()));
      }
    }
  }
}

constexpr int kRowsPerBlock = kMaxThreads / 32;  // a warp a row

template <typename TX>
cudaError_t launch_sumsq(const void* x, void* out, int rows, int d,
                         cudaStream_t s) {
  if (d <= 0 || d % Vec<TX>::n) return cudaErrorInvalidValue;
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  rmsnorm_sumsq_rows<TX><<<blocks, kMaxThreads, 0, s>>>(
      (const TX*)x, (float*)out, rows, d);
  return cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t launch_scale(const void* x, const void* w, const void* total,
                         void* out, int rows, int d, int d_full, float eps,
                         cudaStream_t s) {
  if (d <= 0 || d % Vec<TX>::n || d_full < d) return cudaErrorInvalidValue;
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  rmsnorm_scale_rows<TX, TW><<<blocks, kMaxThreads, 0, s>>>(
      (const TX*)x, (const TW*)w, (const float*)total, (TX*)out, rows, d,
      d_full, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16.  Pairs (x, w): (0, 0), (1, 1), (1, 0).
extern "C" int repro_rmsnorm(const void* x, const void* w, void* out,
                             int rows, int d, int x_dtype, int w_dtype,
                             float eps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0 && w_dtype == 0)
    return (int)launch<float, float>(x, w, out, rows, d, eps, device, s);
  if (x_dtype == 1 && w_dtype == 1)
    return (int)launch<bf16, bf16>(x, w, out, rows, d, eps, device, s);
  if (x_dtype == 1 && w_dtype == 0)
    return (int)launch<bf16, float>(x, w, out, rows, d, eps, device, s);
  return (int)cudaErrorInvalidValue;
}

// out (rows,) fp32: the sum of squares of each row of x (rows, d), fp32 or
// bf16, over its d local columns.
extern "C" int repro_rmsnorm_sumsq(const void* x, void* out, int rows, int d,
                                   int x_dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0) return (int)launch_sumsq<float>(x, out, rows, d, s);
  if (x_dtype == 1) return (int)launch_sumsq<bf16>(x, out, rows, d, s);
  return (int)cudaErrorInvalidValue;
}

// out (rows, d) in x's dtype: x * rsqrt(total / d_full + eps) * w in fp32,
// x (rows, d) a row's local columns, w (d,) their weights, total (rows,)
// fp32 each whole row's sum of squares over its d_full columns.
extern "C" int repro_rmsnorm_scale(const void* x, const void* w,
                                   const void* total, void* out, int rows,
                                   int d, int d_full, int x_dtype,
                                   int w_dtype, float eps, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0 && w_dtype == 0)
    return (int)launch_scale<float, float>(x, w, total, out, rows, d, d_full,
                                           eps, s);
  if (x_dtype == 1 && w_dtype == 1)
    return (int)launch_scale<bf16, bf16>(x, w, total, out, rows, d, d_full,
                                         eps, s);
  if (x_dtype == 1 && w_dtype == 0)
    return (int)launch_scale<bf16, float>(x, w, total, out, rows, d, d_full,
                                          eps, s);
  return (int)cudaErrorInvalidValue;
}
