// Streaming copy for Hopper (sm_90a): out = x into a new buffer.
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

}  // namespace

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
