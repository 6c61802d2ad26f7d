// Matmul for Hopper (sm_90a): out = x @ y, x (m, k), y (k, n), fp32
// accumulation, out in fp32 or bf16.
//
// Replaces: the Pallas `matmul` kernel, src/repro/kernels/matmul.py
// (`_matmul_kernel` :25, launched by `matmul` :39-77), the paper's
// compute-bound TAO class and the serving zoo's projection and decode GEMV.
//
// Bound on the card.  At 2048^3 operations: 17.2 GFLOP on 25 MB of bf16,
// 683 FLOP per byte, above the 295 at which the tensor cores (989 TFLOP/s
// bf16) and not HBM set the limit: 0.0174 ms.  At m = 1 (the zoo's decode
// GEMV, (1, 2048) @ (2048, 2048)) bytes: 8.4 MB of y read once, 0.0025 ms
// at 3.35 TB/s.
//
// Design.  The TPU kernel walks a sequential k grid and carries the fp32 sum
// in VMEM scratch.  Blocks of the card run in no order, so each block owns
// its output columns and loops over k itself with the sum in registers.  The
// bf16 path takes one of two kernels on m, inside `repro_matmul`:
//   * m > 16: `wgmma` fed by TMA.  A block of three warpgroups owns a
//     128 x BN output tile.  Warpgroup 0 is the producer: one thread keeps a
//     ring of STAGES shared-memory stages full, each an x tile (128 x 64,
//     K-major) and a y tile (64 x BN, N-major, as BN / 64 boxes of 64 x 64),
//     loaded by `cp.async.bulk.tensor` with the 128-byte swizzle and signalled
//     on the stage's full mbarrier.  Warpgroups 1 and 2 each own 64 rows:
//     they wait for a stage, issue four `wgmma.mma_async` m64nBNk16 (A K-major,
//     B transposed, i.e. N-major, both read from the swizzled stage through
//     a descriptor), keep one wgmma group in flight and release the stage
//     before it on its empty mbarrier.  `setmaxnreg` moves registers from the
//     producer (40) to the consumers (232).  The fp32 accumulator leaves the
//     registers straight to device memory, rounded to the output type, with
//     every store guarded.  TMA zero-fills the boxes past m, n and k, so
//     the main loop has no edge branch; TMA needs 16-byte row strides, which
//     the wrapper's rule (k and n multiples of 8) gives.
//     Tile: BN = 256 (128 tiles, one wave at 2048^3; 192 KB of 4 stages)
//     where that still puts a tile on three quarters of the SMs, else
//     BN = 128 (6 stages), which gives the zoo's 1024 x 2048 projection 128
//     tiles in place of 64.
//     The tensor maps hold the operands' addresses, so the host encodes two
//     per call (`cuTensorMapEncodeTiled`, a driver function reached through
//     `cudaGetDriverEntryPoint`, so the library links no -lcuda) and passes
//     them as `__grid_constant__` parameters.
//   * m <= 16: a memory-bound kernel, not the tiled one.  Each block owns
//     16 columns (two 16-byte vectors of a row of y) and all of k; its 8
//     warps read 16 rows each per pass, all loads of a chunk issued before
//     any is used, so the grid (128 blocks at n = 2048) streams y once.  x is
//     staged in shared memory a chunk at a time.  The partial sums of a
//     pass's 128 rows are reduced by shuffles and then across warps in
//     shared memory in a fixed order: one launch, no atomics, no workspace,
//     the same bits on every call.
// fp32 inputs take the CUDA cores with fmaf: a 64 x 64 tile per block of 256
// threads, 4 x 4 outputs per thread, no TF32, so the result matches a float32
// product at "highest" precision up to summation order.  That kernel is the
// first, simple version, kept as it was: no main path runs it
// (`mixed_mode.DTYPES` and the zoo are bf16).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::allow_smem;
using repro::sm_count;
using repro::smem_u32;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store_out2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_out2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ------------------------------------------------- Hopper primitives ----
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// one box of a 2-d tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}
// wgmma shared-memory descriptor of a tile in the 128-byte swizzle: start
// address, leading and stride byte offsets (in 16-byte units), layout 1
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator reads or writes across a wgmma
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F16(i) F4(i), F4(i + 4), F4(i + 8), F4(i + 12)
#define F64(i) F16(i), F16(i + 16), F16(i + 32), F16(i + 48)
#define F128(i) F64(i), F64(i + 64)

// d (64 x N, fp32, the warpgroup's accumulator layout) += A (64 x 16, K-major,
// descriptor a) . B (16 x N, N-major, descriptor b): scale-d 1, no negation,
// A not transposed, B transposed
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : F64(0)
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : F128(0)
      : "l"(a), "l"(b), "r"(1));
}

// ------------------------------------------------ bf16, m > 16: wgmma ----
constexpr int BM = 128;  // rows of a block: two consumer warpgroups of 64
constexpr int BK = 64;   // k depth of a stage: 128-byte rows of bf16
constexpr int kBox = 64;  // columns of one y box (128 bytes, the swizzle span)

template <int BN>
struct Tile {
  static constexpr int stages = BN == 256 ? 4 : 6;
  static constexpr int x_elems = BM * BK;
  static constexpr int y_elems = BK * BN;
  static constexpr uint32_t stage_bytes = (x_elems + y_elems) * sizeof(bf16);
  // stages, their full and empty barriers, and slack to align to 1024
  static constexpr int smem = stages * stage_bytes + 2 * stages * 8 + 1024;
};

template <int BN>
struct Acc;
template <>
struct Acc<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a,
                                             uint64_t b) {
    wgmma_n128(d, a, b);
  }
};
template <>
struct Acc<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t a,
                                             uint64_t b) {
    wgmma_n256(d, a, b);
  }
};

template <int BN, typename OutT>
__global__ void __launch_bounds__(384, 1)
wgmma_matmul_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap ymap,
                    OutT* __restrict__ out, int m, int n, int k) {
  using T = Tile<BN>;
  constexpr int S = T::stages;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the stages to it
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ys = xs + S * T::x_elems;
  uint64_t* full = reinterpret_cast<uint64_t*>(ys + S * T::y_elems);
  uint64_t* empty = full + S;

  const int ktiles = (k + BK - 1) / BK;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrival, plus the bytes
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: the registers go to the consumers; one thread issues
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % S;
        // the stage's previous use must be released (passes at once on the
        // first round: the phase before the first counts as complete)
        mbar_wait(&empty[s], ((kt / S) & 1) ^ 1);
        mbar_expect_tx(&full[s], T::stage_bytes);
        tma_load(xs + s * T::x_elems, &xmap, &full[s], kt * BK, m0);
#pragma unroll
        for (int c = 0; c < BN / kBox; ++c)
          tma_load(ys + s * T::y_elems + c * BK * kBox, &ymap, &full[s],
                   n0 + c * kBox, kt * BK);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;  // this warpgroup's 64 rows of the tile
    float d[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = 0.0f;
    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % S;
      mbar_wait(&full[s], (kt / S) & 1);
      const bf16* xt = xs + s * T::x_elems + cw * 64 * BK;
      const bf16* yt = ys + s * T::y_elems;
      fence_regs(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // x: 64 rows of 128 bytes, 8-row groups 1024 bytes apart; a k step
        // of 16 moves 32 bytes along the row.  y: 16 k rows of 64-column
        // boxes, 8-row groups 1024 bytes apart, boxes BK * 128 bytes apart
        const uint64_t a = sw128_desc(xt + kk * 16, 16, 1024);
        const uint64_t b = sw128_desc(yt + kk * 16 * kBox, BK * kBox * 2,
                                      1024);
        Acc<BN>::mma(d, a, b);
      }
      wgmma_commit();
      fence_regs(d);
      // the group before this one is done: release its stage
      wgmma_wait<1>();
      if (kt > 0 && threadIdx.x % 128 == 0)
        mbar_arrive(&empty[(kt - 1) % S]);
    }
    wgmma_wait<0>();
    fence_regs(d);

    const int t = threadIdx.x % 128;
    const int row = m0 + cw * 64 + (t / 32) * 16 + (t % 32) / 4;
    const int col0 = n0 + (t % 4) * 2;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = col0 + j * 8;  // n is even, so col < n covers col + 1
      if (col < n) {
        if (row < m)
          store_out2(out + (int64_t)row * n + col, d[4 * j], d[4 * j + 1]);
        if (row + 8 < m)
          store_out2(out + (int64_t)(row + 8) * n + col, d[4 * j + 2],
                     d[4 * j + 3]);
      }
    }
  }
}

// ------------------------------------------- bf16, m <= 16: streaming ----
constexpr int kSmallM = 16;       // the largest m this kernel takes
constexpr int kColsPerBlock = 16;  // two 16-byte vectors of a row
constexpr int kStreamThreads = 256;
constexpr int kRowsPerPass = kStreamThreads / 2;

// MB: m rounded up to a power of two.  U: passes of 128 rows whose loads are
// all in flight before the first is used.
template <int MB, typename OutT>
__global__ void __launch_bounds__(kStreamThreads)
small_m_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y,
               OutT* __restrict__ out, int m, int n, int k) {
  constexpr int U = MB <= 4 ? 16 : 8;
  constexpr int kChunk = U * kRowsPerPass;  // rows of y per chunk
  constexpr int kWarps = kStreamThreads / 32;
  __shared__ __align__(16) bf16 xs[kChunk * MB];  // x^T of the chunk
  __shared__ float red[kWarps][MB][kColsPerBlock];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = lane & 1;                     // which vector of the 16
  const int rsub = warp * 16 + (lane >> 1);      // row within a pass
  const int col = blockIdx.x * kColsPerBlock + half * 8;
  const bool col_ok = col < n;  // n is a multiple of 8: all 8 or none

  float acc[MB][8];
#pragma unroll
  for (int i = 0; i < MB; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int c0 = 0; c0 < k; c0 += kChunk) {
    uint4 yv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = c0 + u * kRowsPerPass + rsub;
      yv[u] = make_uint4(0, 0, 0, 0);
      if (col_ok && r < k)
        yv[u] = __ldg(reinterpret_cast<const uint4*>(y + (int64_t)r * n +
                                                     col));
    }
    __syncthreads();  // every warp is done with the previous chunk's x
    for (int e = threadIdx.x; e < kChunk * MB; e += kStreamThreads) {
      const int r = e / MB, i = e % MB;
      xs[e] = (i < m && c0 + r < k) ? x[(int64_t)i * k + c0 + r]
                                    : __float2bfloat16(0.0f);
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bf16* xr = xs + (u * kRowsPerPass + rsub) * MB;
      const __nv_bfloat162* yp =
          reinterpret_cast<const __nv_bfloat162*>(&yv[u]);
      float yf[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(yp[j]);
        yf[2 * j] = f.x;
        yf[2 * j + 1] = f.y;
      }
#pragma unroll
      for (int i = 0; i < MB; ++i) {
        const float xi = __bfloat162float(xr[i]);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xi, yf[j], acc[i][j]);
      }
    }
  }

  // sum the 16 rows of the warp (lanes of one `half`), then the 8 warps in
  // order: the same order on every call
#pragma unroll
  for (int i = 0; i < MB; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = acc[i][j];
#pragma unroll
      for (int off = 2; off < 32; off <<= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      acc[i][j] = v;
    }
  if (lane < 2) {
#pragma unroll
    for (int i = 0; i < MB; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) red[warp][i][half * 8 + j] = acc[i][j];
  }
  __syncthreads();
  if (threadIdx.x < MB * kColsPerBlock) {
    const int i = threadIdx.x / kColsPerBlock;
    const int c = blockIdx.x * kColsPerBlock + threadIdx.x % kColsPerBlock;
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w][i][threadIdx.x %
                                                    kColsPerBlock];
    if (i < m && c < n) store_out(out + (int64_t)i * n + c, v);
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

// ------------------------------------------------------------- launch ----
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime: no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    return (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a (rows, cols) row-major bf16 matrix read in (box_rows, 64) boxes, the
// 128-byte swizzle, zeros past the edges
bool bf16_map(CUtensorMap* map, const void* base, int rows, int cols,
              int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)kBox, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, typename OutT>
cudaError_t launch_wgmma(const void* x, const void* y, void* out, int m,
                         int n, int k, int device, cudaStream_t s) {
  constexpr auto kernel = wgmma_matmul_kernel<BN, OutT>;
  cudaError_t err = allow_smem<kernel>(Tile<BN>::smem, device);
  if (err != cudaSuccess) return err;
  CUtensorMap xmap, ymap;
  if (!bf16_map(&xmap, x, m, k, BM) || !bf16_map(&ymap, y, k, n, BK))
    return cudaErrorInvalidValue;
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  kernel<<<grid, 384, Tile<BN>::smem, s>>>(xmap, ymap, (OutT*)out, m, n, k);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_bf16(const void* x, const void* y, void* out, int m, int n,
                        int k, int device, cudaStream_t s) {
  const bf16* xb = (const bf16*)x;
  const bf16* yb = (const bf16*)y;
  const dim3 cols((n + kColsPerBlock - 1) / kColsPerBlock);
  if (m <= 1)
    small_m_kernel<1, OutT><<<cols, kStreamThreads, 0, s>>>(xb, yb,
                                                           (OutT*)out, m, n, k);
  else if (m <= 2)
    small_m_kernel<2, OutT><<<cols, kStreamThreads, 0, s>>>(xb, yb,
                                                           (OutT*)out, m, n, k);
  else if (m <= 4)
    small_m_kernel<4, OutT><<<cols, kStreamThreads, 0, s>>>(xb, yb,
                                                           (OutT*)out, m, n, k);
  else if (m <= 8)
    small_m_kernel<8, OutT><<<cols, kStreamThreads, 0, s>>>(xb, yb,
                                                           (OutT*)out, m, n, k);
  else if (m <= kSmallM)
    small_m_kernel<16, OutT><<<cols, kStreamThreads, 0, s>>>(
        xb, yb, (OutT*)out, m, n, k);
  else {
    // BN = 256 while its tiles still cover three quarters of the SMs
    const int64_t tiles256 = (int64_t)((n + 255) / 256) * ((m + BM - 1) / BM);
    if (4 * tiles256 >= 3 * (int64_t)sm_count(device))
      return launch_wgmma<256, OutT>(x, y, out, m, n, k, device, s);
    return launch_wgmma<128, OutT>(x, y, out, m, n, k, device, s);
  }
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_f32(const void* x, const void* y, void* out, int m, int n,
                       int k, cudaStream_t s) {
  dim3 grid((n + SBN - 1) / SBN, (m + SBM - 1) / SBM);
  f32_matmul_kernel<OutT><<<grid, 256, 0, s>>>(
      (const float*)x, (const float*)y, (OutT*)out, m, n, k);
  return cudaGetLastError();
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
  if (in_dtype == 1 && out_dtype == 1)
    err = launch_bf16<bf16>(x, y, out, m, n, k, device, s);
  else if (in_dtype == 1 && out_dtype == 0)
    err = launch_bf16<float>(x, y, out, m, n, k, device, s);
  else if (in_dtype == 0 && out_dtype == 0)
    err = launch_f32<float>(x, y, out, m, n, k, s);
  else if (in_dtype == 0 && out_dtype == 1)
    err = launch_f32<bf16>(x, y, out, m, n, k, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
