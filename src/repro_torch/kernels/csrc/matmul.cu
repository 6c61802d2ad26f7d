// Tiled matmul for Hopper (sm_90a): out = x @ y, x (m, k), y (k, n), fp32
// accumulation, out in fp32 or bf16.
//
// Replaces: the Pallas `matmul` kernel, src/repro/kernels/matmul.py
// (`_matmul_kernel` :25, launched by `matmul` :39-77), the paper's
// compute-bound TAO class.
//
// Bound on the card: operations.  A product of 2048 x 2048 matrices does
// 2 * 2048^3 = 17.2 GFLOP on 25 MB of bf16 operands and output, 683 FLOP per
// byte, above the 295 FLOP per byte at which the tensor cores (989 TFLOP/s
// bf16) and not HBM set the limit.
//
// Design: the TPU kernel walks a sequential k grid and carries the fp32 sum
// in VMEM scratch from step to step.  Blocks of the card run in no order, so
// each block owns one output tile and loops over k itself, with the fp32 sum
// in registers; nothing is carried between blocks.  Each k step stages one
// tile of x and one of y in shared memory, where every warp of the block
// reuses them.
//   * bf16 inputs go through the tensor cores with warp-level
//     nvcuda::wmma (mma.sync): a 128 x 128 tile per block of 8 warps, each
//     warp a 64 x 32 slab of 4 x 2 fragments of 16 x 16, k in steps of 32.
//     Tiles are loaded as 16-byte vectors, so rows of x and y must be
//     multiples of 8 elements and 16-byte aligned; the wrapper checks that.
//     The fp32 sum leaves through a per-warp staging tile in shared memory,
//     where it is rounded to the output type.
//   * fp32 inputs take the CUDA cores with fmaf: a 64 x 64 tile per block of
//     256 threads, 4 x 4 outputs per thread.  No TF32 anywhere, so the result
//     matches a float32 product at "highest" precision up to summation order.
// Both kernels guard every load and store, so the edges of shapes that are
// not multiples of the tile are zero-filled and clipped.
// This is the first, simple version: no cp.async or TMA pipeline and no
// wgmma, which a later version needs to come near the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// ---------------------------------------------------------------- bf16 ----
constexpr int TBM = 128, TBN = 128, TBK = 32;
constexpr int A_LD = TBK + 8;  // shared-memory row strides, padded against
constexpr int B_LD = TBN + 8;  // bank conflicts; both keep 32-byte alignment
constexpr int kWarps = 8;

template <typename OutT>
__global__ void __launch_bounds__(kWarps * 32)
bf16_matmul_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y,
                   OutT* __restrict__ out, int m, int n, int k) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 xs[TBM * A_LD];
  __shared__ __align__(128) bf16 ys[TBK * B_LD];
  __shared__ __align__(128) float stage[kWarps][16 * 16];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / 4;  // 2 x 4 warps: a 64-row, 32-column slab each
  const int wn = warp % 4;
  const int row0 = blockIdx.y * TBM;
  const int col0 = blockIdx.x * TBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < k; k0 += TBK) {
    // x tile: 128 rows of 32 -> 512 vectors of 8; y tile: 32 rows of 128
    for (int v = threadIdx.x; v < TBM * TBK / 8; v += blockDim.x) {
      const int r = v / (TBK / 8), c = (v % (TBK / 8)) * 8;
      const int gr = row0 + r, gc = k0 + c;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gr < m && gc < k)
        val = *reinterpret_cast<const uint4*>(x + (int64_t)gr * k + gc);
      *reinterpret_cast<uint4*>(&xs[r * A_LD + c]) = val;
    }
    for (int v = threadIdx.x; v < TBK * TBN / 8; v += blockDim.x) {
      const int r = v / (TBN / 8), c = (v % (TBN / 8)) * 8;
      const int gr = k0 + r, gc = col0 + c;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gr < k && gc < n)
        val = *reinterpret_cast<const uint4*>(y + (int64_t)gr * n + gc);
      *reinterpret_cast<uint4*>(&ys[r * B_LD + c]) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], &xs[(wm * 64 + i * 16) * A_LD + kk],
                               A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &ys[kk * B_LD + wn * 32 + j * 16], B_LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* st = stage[warp];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gr = row0 + wm * 64 + i * 16 + e / 16;
        const int gc = col0 + wn * 32 + j * 16 + e % 16;
        if (gr < m && gc < n) store_out(out + (int64_t)gr * n + gc, st[e]);
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------- fp32 ----
constexpr int SBM = 64, SBN = 64, SBK = 16;

template <typename OutT>
__global__ void __launch_bounds__(256)
f32_matmul_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  OutT* __restrict__ out, int m, int n, int k) {
  __shared__ float xs[SBK][SBM + 1];  // x tile stored k-major
  __shared__ float ys[SBK][SBN];
  const int tx = threadIdx.x % 16;  // 16 x 16 threads, 4 x 4 outputs each,
  const int ty = threadIdx.x / 16;  // strided by 16 across the tile
  const int row0 = blockIdx.y * SBM;
  const int col0 = blockIdx.x * SBN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += SBK) {
    for (int e = threadIdx.x; e < SBM * SBK; e += blockDim.x) {
      const int r = e / SBK, c = e % SBK;
      const int gr = row0 + r, gc = k0 + c;
      xs[c][r] = (gr < m && gc < k) ? x[(int64_t)gr * k + gc] : 0.0f;
    }
    for (int e = threadIdx.x; e < SBK * SBN; e += blockDim.x) {
      const int r = e / SBN, c = e % SBN;
      const int gr = k0 + r, gc = col0 + c;
      ys[r][c] = (gr < k && gc < n) ? y[(int64_t)gr * n + gc] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ys[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gr = row0 + ty + 16 * i, gc = col0 + tx + 16 * j;
      if (gr < m && gc < n) store_out(out + (int64_t)gr * n + gc, acc[i][j]);
    }
  }
}

template <typename InT, typename OutT>
void launch(const void* x, const void* y, void* out, int m, int n, int k,
            cudaStream_t s);

template <>
void launch<bf16, float>(const void* x, const void* y, void* out, int m,
                         int n, int k, cudaStream_t s) {
  dim3 grid((n + TBN - 1) / TBN, (m + TBM - 1) / TBM);
  bf16_matmul_kernel<float><<<grid, kWarps * 32, 0, s>>>(
      (const bf16*)x, (const bf16*)y, (float*)out, m, n, k);
}
template <>
void launch<bf16, bf16>(const void* x, const void* y, void* out, int m,
                        int n, int k, cudaStream_t s) {
  dim3 grid((n + TBN - 1) / TBN, (m + TBM - 1) / TBM);
  bf16_matmul_kernel<bf16><<<grid, kWarps * 32, 0, s>>>(
      (const bf16*)x, (const bf16*)y, (bf16*)out, m, n, k);
}
template <>
void launch<float, float>(const void* x, const void* y, void* out, int m,
                          int n, int k, cudaStream_t s) {
  dim3 grid((n + SBN - 1) / SBN, (m + SBM - 1) / SBM);
  f32_matmul_kernel<float><<<grid, 256, 0, s>>>(
      (const float*)x, (const float*)y, (float*)out, m, n, k);
}
template <>
void launch<float, bf16>(const void* x, const void* y, void* out, int m,
                         int n, int k, cudaStream_t s) {
  dim3 grid((n + SBN - 1) / SBN, (m + SBM - 1) / SBM);
  f32_matmul_kernel<bf16><<<grid, 256, 0, s>>>(
      (const float*)x, (const float*)y, (bf16*)out, m, n, k);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (the codes the Python wrapper passes)
extern "C" int repro_matmul(const void* x, const void* y, void* out, int m,
                            int n, int k, int in_dtype, int out_dtype,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (m <= 0 || n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (in_dtype == 1 && out_dtype == 1) launch<bf16, bf16>(x, y, out, m, n, k, s);
  else if (in_dtype == 1 && out_dtype == 0) launch<bf16, float>(x, y, out, m, n, k, s);
  else if (in_dtype == 0 && out_dtype == 0) launch<float, float>(x, y, out, m, n, k, s);
  else if (in_dtype == 0 && out_dtype == 1) launch<float, bf16>(x, y, out, m, n, k, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
