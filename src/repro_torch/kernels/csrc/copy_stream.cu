// Streaming kernels for Hopper (sm_90a): the copy, out = x into a new
// buffer, and the STREAM triad, out = a * x + y.
//
// Replaces: the Pallas `copy` kernel, src/repro/kernels/copy_stream.py
// (`_copy_kernel` :23, launched by `copy` :32-47), the paper's memory-bound
// TAO class.
//
// Bound on the card: bytes.  The copy does no arithmetic; each byte is read
// once and written once, so the least time is 2 * nbytes over HBM3's
// 3.35 TB/s.  The main path's chunk (16384 x 1024 fp32, 64 MiB each way) is
// larger than the 50 MB L2, so the cache cannot serve it.
//
// Design: the TPU kernel streams (block_rows, cols) tiles through VMEM.  On
// the card the copy is flat over bytes, so one kernel serves every element
// size (bf16, fp32, int32) and is bit-exact.  Each thread moves 16-byte
// vectors (uint4), the widest load a thread can issue, with neighbouring
// threads on neighbouring addresses, so every warp request covers whole
// 128-byte lines.  Each thread keeps kUnroll independent loads in flight to
// hide HBM latency.  When the two pointers are not both 16-byte aligned the
// whole copy takes the byte loop; otherwise only the last nbytes % 16 bytes
// do.
//
// Triad replaces: the Pallas `triad` kernel, src/repro/kernels/copy_stream.py
// (`_triad_kernel` :27-28, launched by `triad` :51-74), which has no caller
// outside the tests in either package.  out = a * x + y with `a` cast to x's
// dtype (src/repro/kernels/ref.py:19-20); fp32 or bf16.  Bound: bytes, two
// reads and one write, 3 * nbytes over 3.35 TB/s (0.0601 ms at 16384 x 1024
// fp32).  The TPU kernel prefetches `a` to SMEM ahead of the grid; here it is
// a kernel argument, in a register of every thread.  The same 16-byte vector
// pass as the copy, with the tail (and unaligned buffers) on an element
// loop.  The product and the sum are rounded one at a time, as PyTorch's
// `a * x + y` rounds them (no fused multiply-add), so the kernel is
// bit-exact against its plain version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kThreads)
copy_vec16(const uint4* __restrict__ src, uint4* __restrict__ dst,
           int64_t n_vec) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n_vec; i += kUnroll * stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = src[i + u * stride];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) dst[i + u * stride] = v[u];
  }
  for (; i < n_vec; i += stride) dst[i] = src[i];
}

__global__ void __launch_bounds__(kThreads)
copy_bytes(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
           int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    dst[i] = src[i];
}

int grid_for(int64_t work, int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      sms <= 0)
    sms = 132;
  const int64_t want = (work + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * 8;  // 8 blocks of 256 threads per SM
  return (int)(want < cap ? (want > 0 ? want : 1) : cap);
}

__device__ inline float triad_one(float a, float x, float y, float) {
  return __fadd_rn(__fmul_rn(a, x), y);
}

__device__ inline __nv_bfloat16 triad_one(float a, float x, float y,
                                          __nv_bfloat16) {
  const float ax = __bfloat162float(__float2bfloat16_rn(__fmul_rn(a, x)));
  return __float2bfloat16_rn(__fadd_rn(ax, y));
}

__device__ inline float load_f(float v) { return v; }
__device__ inline float load_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
triad_vec16(float a, const uint4* __restrict__ x, const uint4* __restrict__ y,
            uint4* __restrict__ out, int64_t n_vec) {
  constexpr int N = 16 / sizeof(T);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_vec;
       i += stride) {
    const uint4 xv = x[i], yv = y[i];
    uint4 ov;
    const T* xs = reinterpret_cast<const T*>(&xv);
    const T* ys = reinterpret_cast<const T*>(&yv);
    T* os = reinterpret_cast<T*>(&ov);
#pragma unroll
    for (int k = 0; k < N; ++k)
      os[k] = triad_one(a, load_f(xs[k]), load_f(ys[k]), T());
    out[i] = ov;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
triad_elems(float a, const T* __restrict__ x, const T* __restrict__ y,
            T* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = triad_one(a, load_f(x[i]), load_f(y[i]), T());
}

template <typename T>
cudaError_t triad(float a, const void* x, const void* y, void* out,
                  int64_t n, int device, cudaStream_t s) {
  constexpr int N = 16 / sizeof(T);
  int64_t done = 0;
  if ((((uintptr_t)x | (uintptr_t)y | (uintptr_t)out) & 15) == 0) {
    const int64_t n_vec = n / N;
    if (n_vec > 0) {
      triad_vec16<T><<<grid_for(n_vec, device), kThreads, 0, s>>>(
          a, (const uint4*)x, (const uint4*)y, (uint4*)out, n_vec);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    done = n_vec * N;
  }
  if (done < n)
    triad_elems<T><<<grid_for(n - done, device), kThreads, 0, s>>>(
        a, (const T*)x + done, (const T*)y + done, (T*)out + done, n - done);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16.  `a` is already x's dtype's value.
extern "C" int repro_triad(const void* x, const void* y, void* out,
                           int64_t n, int dtype, float a, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)triad<float>(a, x, y, out, n, device, s);
  if (dtype == 1)
    return (int)triad<__nv_bfloat16>(a, x, y, out, n, device, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int repro_copy(const void* src, void* dst, int64_t nbytes,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nbytes <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* s8 = (const uint8_t*)src;
  uint8_t* d8 = (uint8_t*)dst;
  int64_t done = 0;
  if ((((uintptr_t)src | (uintptr_t)dst) & 15) == 0) {
    const int64_t n_vec = nbytes / 16;
    if (n_vec > 0) {
      copy_vec16<<<grid_for(n_vec / kUnroll, device), kThreads, 0, s>>>(
          (const uint4*)src, (uint4*)dst, n_vec);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    done = n_vec * 16;
  }
  if (done < nbytes) {
    const int64_t rest = nbytes - done;
    copy_bytes<<<grid_for(rest, device), kThreads, 0, s>>>(s8 + done,
                                                           d8 + done, rest);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
