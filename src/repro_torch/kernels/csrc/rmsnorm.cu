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
// weight resident, so x crosses HBM once each way.  Here one block of up to
// 256 threads owns one row.  Each thread loads its share of the row as
// 16-byte vectors (8 bf16 or 4 fp32), keeps them in registers (at most
// kMaxVec vectors, so d <= 16384 bf16 or 8192 fp32), accumulates its sum of
// squares in fp32, and the block reduces it with warp shuffles and one
// shared-memory step.  Then every thread scales its cached vectors by
// rsqrtf(ms + eps) and by w, and writes them once: one read and one write of
// the row.  w (8 KB at d = 2048 fp32) is read by every row and stays in L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxThreads = 256;
constexpr int kMaxVec = 8;  // 16-byte vectors a thread caches

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

// TX is x's and out's type, TW w's.  d is a multiple of Vec<TX>::n and
// Vec<TX>::n a multiple of Vec<TW>::n (the wrapper takes w in fp32 or TX).
template <typename TX, typename TW>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_rows(const TX* __restrict__ x, const TW* __restrict__ w,
             TX* __restrict__ out, int d, float eps) {
  constexpr int N = Vec<TX>::n;
  constexpr int NW = Vec<TW>::n;
  const int n_vec = d / N;
  const int64_t base = (int64_t)blockIdx.x * d;
  const uint4* xr = reinterpret_cast<const uint4*>(x + base);
  uint4* orow = reinterpret_cast<uint4*>(out + base);

  uint4 cache[kMaxVec];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxVec; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    if (i < n_vec) {
      cache[j] = xr[i];
      float f[N];
      to_float(cache[j], f, TX());
#pragma unroll
      for (int k = 0; k < N; ++k) ss = fmaf(f[k], f[k], ss);
    }
  }

  __shared__ float partial[kMaxThreads / 32];
  __shared__ float scale;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ss = warp_sum(ss);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < (int)(blockDim.x >> 5) ? partial[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) scale = rsqrtf(t / (float)d + eps);
  }
  __syncthreads();
  const float r = scale;

#pragma unroll
  for (int j = 0; j < kMaxVec; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    if (i < n_vec) {
      float f[N], wf[N];
      to_float(cache[j], f, TX());
      const uint4* wv = reinterpret_cast<const uint4*>(w + (int64_t)i * N);
#pragma unroll
      for (int c = 0; c < N / NW; ++c) to_float(wv[c], wf + c * NW, TW());
#pragma unroll
      for (int k = 0; k < N; ++k) f[k] = (f[k] * r) * wf[k];
      orow[i] = from_float(f, TX());
    }
  }
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, void* out, int rows, int d,
                   float eps, cudaStream_t s) {
  if (d % Vec<TX>::n) return cudaErrorInvalidValue;
  const int n_vec = d / Vec<TX>::n;
  int threads = (n_vec + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (n_vec <= 0 || (n_vec + threads - 1) / threads > kMaxVec)
    return cudaErrorInvalidValue;
  rmsnorm_rows<TX, TW><<<rows, threads, 0, s>>>(
      (const TX*)x, (const TW*)w, (TX*)out, d, eps);
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
    return (int)launch<float, float>(x, w, out, rows, d, eps, s);
  if (x_dtype == 1 && w_dtype == 1)
    return (int)launch<bf16, bf16>(x, w, out, rows, d, eps, s);
  if (x_dtype == 1 && w_dtype == 0)
    return (int)launch<bf16, float>(x, w, out, rows, d, eps, s);
  return (int)cudaErrorInvalidValue;
}
