// Bitonic row sort for Hopper (sm_90a): each row of a (rows, n) array
// sorted ascending, n a power of two.
//
// Replaces: the Pallas `sort_rows` kernel, src/repro/kernels/sort_bitonic.py
// (`_sort_kernel` :45 and `_bitonic_stage` :27, launched at :62), the paper's
// data-reuse TAO class.
//
// Bound on the card: bytes.  Each row is read once and written once (2 * 16
// KB for a 4096-element fp32 row); the log2(n) * (log2(n) + 1) / 2 stages of
// n / 2 compare-exchanges (78 stages for n = 4096) are a few fp32 operations
// per element per stage, far under the 67 TFLOP/s of the CUDA cores.  The
// data reuse is the point of the class: every stage reads what the stage
// before wrote.
//
// Design: one block sorts one row, and the whole row stays in shared memory
// across all stages, so device memory sees the row twice whatever the number
// of stages (on the TPU the row block stays in VMEM for the same reason).
// The network is the TPU kernel's, in the same order: k outer, j inner from
// k down to 0, compare distance 2^j, ascending where bit k+1 of the lane
// index is 0.  __syncthreads() separates the stages.  A compare-exchange
// swaps two values only when they are out of order, so the output is always
// a permutation of the input, and on finite inputs it is bit-identical to
// torch.sort / np.sort.  The order of -0.0 and +0.0, and NaN, are out of
// scope: both compare equal or unordered here, and stay where the network
// leaves them.  Rows up to the block's dynamic shared memory (227 KB: 32768
// fp32) are taken; above 48 KB the launch raises the block's limit with
// cudaFuncSetAttribute first.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
sort_rows_kernel(const T* __restrict__ x, T* __restrict__ out, int n,
                 int log2n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int64_t base = (int64_t)blockIdx.x * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = x[base + i];
  __syncthreads();
  const int half = n >> 1;
  for (int k = 0; k < log2n; ++k) {
    for (int j = k; j >= 0; --j) {
      const int d = 1 << j;
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        // p-th pair of the stage: lanes i and i + d, i in a 2d-aligned group
        const int i = ((p >> j) << (j + 1)) | (p & (d - 1));
        const T a = s[i];
        const T b = s[i + d];
        const bool ascending = ((i >> (k + 1)) & 1) == 0;
        if (ascending ? (b < a) : (a < b)) {
          s[i] = b;
          s[i + d] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[base + i] = s[i];
}

template <typename T>
int launch(const void* x, void* out, int rows, int n, cudaStream_t stream) {
  int log2n = 0;
  while ((1 << log2n) < n) ++log2n;
  const size_t smem = (size_t)n * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sort_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int threads = n / 2;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (threads < 32) threads = 32;
  sort_rows_kernel<T><<<rows, threads, smem, stream>>>(
      (const T*)x, (T*)out, n, log2n);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 2 = int32 (the codes the Python wrapper passes)
extern "C" int repro_sort_rows(const void* x, void* out, int rows, int n,
                               int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows <= 0 || n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, out, rows, n, s);
  if (dtype == 2) return launch<int32_t>(x, out, rows, n, s);
  return (int)cudaErrorInvalidValue;
}
