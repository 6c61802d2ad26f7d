// Streaming kernels for Hopper (sm_90a): the copy, out = x into a new
// buffer, and the STREAM triad, out = a * x + y.
//
// Replaces: the Pallas `copy` kernel, src/repro/kernels/copy_stream.py
// (`_copy_kernel` :23, launched by `copy` :32-47), the paper's memory-bound
// TAO class.
//
// Bound on the card: bytes.  The copy does no arithmetic; each byte is read
// once and written once, so the least time is 2 * nbytes over HBM3's
// 3.35 TB/s (0.0401 ms for the main path's 16384 x 1024 fp32 chunk, 0.0801
// for the zoo's 4096 x 16384 bf16 KV slab).  Both are larger than the 50 MB
// L2, so the cache cannot serve them.
//
// Design: the TPU kernel streams (block_rows, cols) tiles through VMEM.  On
// the card the copy is flat over bytes, so one kernel serves every element
// size (bf16, fp32, int32) and is bit-exact.  The grid is persistent, four
// blocks of 256 threads on each SM.  The 16-byte vectors (uint4, the widest
// load a thread can make) are cut into units of 256, one vector a thread,
// and each block owns a contiguous run of units, the floor or the ceiling of
// units / blocks, so every thread moves the same number of vectors to
// within one.  A thread starts a batch of kBatch loads, neighbouring threads
// on neighbouring addresses, before the batch's first store; the ragged end
// of a block's run is predicated inside its last batch.  Loads and stores
// carry the streaming hint (`ld.global.cs` / `st.global.cs`): neither side
// is read again.  The last nbytes % 16 bytes are copied by the last block's
// first threads in the same launch.  When the two pointers are not both
// 16-byte aligned the whole copy takes the byte loop.
//
// Triad replaces: the Pallas `triad` kernel, src/repro/kernels/copy_stream.py
// (`_triad_kernel` :27-28, launched by `triad` :51-74), which has no caller
// outside the tests in either package.  out = a * x + y with `a` cast to x's
// dtype (src/repro/kernels/ref.py:19-20); fp32 or bf16.  Bound: bytes, two
// reads and one write, 3 * nbytes over 3.35 TB/s (0.0601 ms at 16384 x 1024
// fp32).  The TPU kernel prefetches `a` to SMEM ahead of the grid; here it is
// a kernel argument, in a register of every thread.  The geometry is that of
// PyTorch's vectorized elementwise kernels, not the copy's persistent one: a
// one-shot grid with no loop, each block owning kTriadVecs * 256 16-byte
// vectors, each thread kTriadVecs of x and as many of y (neighbouring
// threads on neighbouring vectors), every load issued before the first
// store.  The tail (and unaligned buffers) goes to an element loop.  The
// product and the sum are rounded one at a time, as PyTorch's `a * x + y`
// rounds them (no fused multiply-add), so the kernel is bit-exact against
// its plain version.  Chosen by timing (kernel_bench.py at 16384 x 1024
// fp32, H100 at 700 W): 2 vectors a thread ran within 0.3% of 4; the copy's
// persistent geometry (4 blocks an SM, balanced spans) 5% slower, as the
// first kernel's grid-stride loop was.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::sm_count;

constexpr int kThreads = 256;
constexpr int kBatch = 8;          // 16-byte loads a thread has in flight
constexpr int kCopyBlocksPerSM = 4;
constexpr int kTriadVecs = 4;      // 16-byte vectors of x (and of y) a thread

__global__ void __launch_bounds__(kThreads, kCopyBlocksPerSM)
copy_vec16(const uint4* __restrict__ src, uint4* __restrict__ dst,
           int64_t n_vec, int tail) {
  const int64_t units = (n_vec + kThreads - 1) / kThreads;
  const int64_t lo = units * blockIdx.x / gridDim.x * kThreads;
  const int64_t end = units * (blockIdx.x + 1) / gridDim.x * kThreads;
  const int64_t hi = end < n_vec ? end : n_vec;
  for (int64_t i = lo + threadIdx.x; i < hi; i += kBatch * kThreads) {
    uint4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (i + u * kThreads < hi) v[u] = __ldcs(src + i + u * kThreads);
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (i + u * kThreads < hi) __stcs(dst + i + u * kThreads, v[u]);
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x < tail) {
    const uint8_t* s8 = reinterpret_cast<const uint8_t*>(src + n_vec);
    reinterpret_cast<uint8_t*>(dst + n_vec)[threadIdx.x] = s8[threadIdx.x];
  }
}

__global__ void __launch_bounds__(kThreads)
copy_bytes(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
           int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    dst[i] = src[i];
}

// the grid of the triad's element loop and of the byte loop: a block for
// every 256 items of work, at most 8 on each SM
int grid_for(int64_t work, int device) {
  const int sms = sm_count(device);
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
  const int64_t base =
      (int64_t)blockIdx.x * kThreads * kTriadVecs + threadIdx.x;
  uint4 xv[kTriadVecs], yv[kTriadVecs];
#pragma unroll
  for (int u = 0; u < kTriadVecs; ++u) {
    const int64_t i = base + u * kThreads;
    if (i < n_vec) {
      xv[u] = x[i];
      yv[u] = y[i];
    }
  }
#pragma unroll
  for (int u = 0; u < kTriadVecs; ++u) {
    const int64_t i = base + u * kThreads;
    if (i < n_vec) {
      uint4 ov;
      const T* xs = reinterpret_cast<const T*>(&xv[u]);
      const T* ys = reinterpret_cast<const T*>(&yv[u]);
      T* os = reinterpret_cast<T*>(&ov);
#pragma unroll
      for (int k = 0; k < N; ++k)
        os[k] = triad_one(a, load_f(xs[k]), load_f(ys[k]), T());
      out[i] = ov;
    }
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
      const int64_t per_block = (int64_t)kThreads * kTriadVecs;
      triad_vec16<T><<<(n_vec + per_block - 1) / per_block, kThreads, 0, s>>>(
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
  const int64_t n_vec = nbytes / 16;
  if ((((uintptr_t)src | (uintptr_t)dst) & 15) == 0 && n_vec > 0) {
    const int64_t units = (n_vec + kThreads - 1) / kThreads;
    const int64_t cap = (int64_t)sm_count(device) * kCopyBlocksPerSM;
    copy_vec16<<<(int)(units < cap ? units : cap), kThreads, 0, s>>>(
        (const uint4*)src, (uint4*)dst, n_vec, (int)(nbytes % 16));
  } else {
    copy_bytes<<<grid_for(nbytes, device), kThreads, 0, s>>>(
        (const uint8_t*)src, (uint8_t*)dst, nbytes);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
