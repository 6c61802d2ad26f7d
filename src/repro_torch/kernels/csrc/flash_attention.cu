// Flash attention forward for Hopper (sm_90a): online-softmax attention with
// grouped-query heads, a causal mask and a sliding window.
// q (B, Hq, S, D), k and v (B, Hkv, Sk, D), out (B, Hq, S, D) in q's dtype;
// fp32 or bf16, D in {32, 64, 80, 128}.
//
// Replaces: the Pallas `flash_attention` kernel,
// src/repro/kernels/flash_attention.py (`_flash_kernel` :33-93, launched by
// `flash_attention` :98-146), the serving zoo's prefill slab and the port's
// decoder's prefill attention.
//
// What it computes, as the TPU kernel does: s = (q . k^T) * sm_scale with an
// fp32 sum; masks on absolute, top-left indices (causal is col <= row, the
// window col > row - window, S != Sk allowed); kv head = q head / (Hq / Hkv),
// by indexing, with no repeated heads in memory; the softmax state (running
// max m, sum l, accumulator) in fp32; output in q's dtype.  kv tiles that no
// row of the q tile can see are skipped, so causal attention does about half
// the work and a window O(S * window); only the tiles that cross the
// diagonal, the window's edge or Sk test each score against the masks.
//
// Rows that see no key output 0, as the oracle does (ref.py:58-61), also
// when they sit inside a visited kv tile.  Here this departs from the TPU
// kernel, which fills masked scores with the finite -1e30: a row with no
// visible key in a visited tile gets p = 1 on every masked column there and
// outputs the mean of v (ROADMAP.md, Queue 3).  This kernel fills masked
// scores with -inf and exponentiates against max(m, 0) while the row has
// seen nothing, so a masked column always contributes exactly 0 and l > 0
// exactly when the row saw a key.
//
// Bound on the card: operations at the serving shape (q (1, 32, 1024, 64),
// causal): 4 * D * Hq * S * (S + 1) / 2 = 4.30 GFLOP over the visible pairs
// on 10.5 MB, 410 FLOP per byte, above the 295 at which the bf16 tensor
// cores and not HBM set the limit: 0.0043 ms.
//
// Design.  The TPU kernel carries acc, m and l in VMEM from one step of a
// sequential kv grid axis to the next.  Blocks of the card run in no order,
// so one block owns one (batch, head, 64-row q tile), loops over the kv
// tiles itself with the softmax state in registers, and writes its output
// once.  Four warps own 16 q rows each; a kv tile holds 64 keys.  64-row q
// tiles give the zoo's shape 512 blocks (3.9 waves on 132 SMs) and the
// model's prefill (4, 32, 64, 64) 128; serving the 4 q heads of a kv group
// from one block would cut those to 128 and 32, and the K/V it would save
// re-reading come from L2 anyway (256 KB per kv head at the zoo's shape).
// Causal tiles further down do more work, so they start first.
//   * bf16, the FlashAttention-2 arrangement on mma.sync m16n8k16, both
//     products on the tensor cores.  q stays in registers as A fragments.
//     S = q . k^T leaves each warp's 16 x 64 scores in the accumulator
//     layout: lane (g, t) = (lane / 4, lane % 4) holds rows g and g + 8,
//     columns 8 n + 2 t and 8 n + 2 t + 1.  Masking, the running max and the
//     exponentials work on that layout, the row's quad of lanes reduced by
//     shuffles.  The accumulator layout of two neighbouring 8-column blocks
//     is the A-fragment layout of a 16-key step, so P goes from the scores
//     to the A operand of P . V in registers, with no trip through shared
//     memory.  V is the B operand, read with ldmatrix.trans from a padded
//     tile (rows of D + 8, no bank conflicts).  K and V tiles are double-
//     buffered: cp.async loads tile j + 1 (zero-filled past Sk) while tile j
//     computes.
//     D = 80 (hubert's 1280 / 16) is not a multiple of 32: q . k^T takes
//     five 16-column steps, four in pairs from ldmatrix.x4 and the last from
//     ldmatrix.x2; P . V steps over the output 16 columns at a time, as at
//     every D.  Rows of 88 elements (176 bytes) stay 16-byte aligned, and
//     ldmatrix's 8 rows fall on 8 distinct 4-bank groups (176 / 4 = 44
//     words, 44 r mod 32 for r = 0..7).
//     Numerics: the products of bf16 values are exact in fp32, so S matches
//     the TPU's fp32 dot up to summation order.  The TPU kernel multiplies
//     fp32 p by fp32 v; the tensor cores take p in bf16.  One bf16 p would
//     err by up to 2^-9 of each weight, which on a row that sees two or
//     three keys moves the output by up to ~4e-3 (over the 2e-3 atol it is
//     held to), so p is split into a bf16 high part and a bf16 low part, two
//     products: p is carried to 2^-17, V is exact, and the sum is fp32.  The
//     row sum l adds the fp32 p.
//   * fp32: the first, simple version, kept as it was: q . k^T and P . V
//     with fmaf on the CUDA cores (never TF32), P through a per-warp slice
//     of shared memory, tiles loaded synchronously.  No main path runs it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::allow_smem;
using repro::smem_u32;
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;   // q rows per block
constexpr int kKeys = 64;   // keys per kv tile
constexpr int kWarps = 4;   // 16 q rows each
constexpr int kThreads = kWarps * 32;
constexpr int kPLd = kKeys + 4;  // row stride of a warp's P slice (floats)

__device__ __forceinline__ float neg_inf() {
  return __uint_as_float(0xff800000u);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// the kv tiles [begin, end) some row of the q tile at q0 can see
struct KvRange {
  int begin, end;
};
__device__ __forceinline__ KvRange kv_range(int q0, int seq_q, int seq_k,
                                            int causal, int has_window,
                                            int window) {
  const int row_hi = min(q0 + kRows - 1, seq_q - 1);
  int end = (seq_k + kKeys - 1) / kKeys;
  if (causal) end = min(end, row_hi / kKeys + 1);
  int begin = 0;
  if (has_window) {
    const int col_lo = q0 - window + 1;  // row q0's first visible column
    begin = col_lo > 0 ? col_lo / kKeys : 0;
  }
  return {begin, end};
}

// ------------------------------------------------------------- bf16 ----
template <int D>
struct Bf16Layout {
  static constexpr int ld = D + 8;  // elements per row: 16-byte aligned rows
                                    // on distinct banks
  static constexpr int tile = kKeys * ld;  // elements of one k or v tile
  static constexpr size_t total = 4 * tile * sizeof(bf16);  // k, v x 2
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a (16 x 16, row-major) . b (16 x 8, column-major), bf16 in, fp32 sum
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices from shared memory, as they are or transposed:
// lanes 8 i to 8 i + 7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2],
                                            const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// 2^x on the special-function unit; 2^-inf = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// rows [row0, row0 + 64) of a (rows, D) matrix into a padded shared tile by
// cp.async, 16 bytes a copy; rows at or past n_rows are zero-filled
template <int D>
__device__ __forceinline__ void load_tile_async(bf16* dst,
                                                const bf16* __restrict__ src,
                                                int row0, int n_rows) {
  constexpr int kPerRow = D / 8;
  for (int e = threadIdx.x; e < kKeys * kPerRow; e += kThreads) {
    const int r = e / kPerRow, c = (e % kPerRow) * 8;
    const bool ok = row0 + r < n_rows;
    const bf16* from = src + (ok ? (int64_t)(row0 + r) * D + c : 0);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst + r * Bf16Layout<D>::ld + c)),
                 "l"(from), "r"(ok ? 16 : 0)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ out, int hq,
                  int hkv, int seq_q, int seq_k, int causal, int has_window,
                  int window, float scale_log2) {
  using L = Bf16Layout<D>;
  constexpr int ld = L::ld;
  constexpr int kN = D / 8;  // 8-column groups of the output
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* tiles = reinterpret_cast<bf16*>(smem);  // k0, k1, v0, v1

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const bf16* qb = q + ((int64_t)b * hq + h) * seq_q * D;
  const int64_t kv_off = ((int64_t)b * hkv + h / (hq / hkv)) * seq_k * D;
  const bf16* kb = k + kv_off;
  const bf16* vb = v + kv_off;
  bf16* ob = out + ((int64_t)b * hq + h) * seq_q * D;
  const KvRange kv = kv_range(q0, seq_q, seq_k, causal, has_window, window);

  if (kv.begin < kv.end) {
    load_tile_async<D>(tiles, kb, kv.begin * kKeys, seq_k);
    load_tile_async<D>(tiles + 2 * L::tile, vb, kv.begin * kKeys, seq_k);
    cp_async_commit();
  }

  const int ra = q0 + warp * 16 + g, rb = ra + 8;  // this lane's two rows
  uint32_t qf[D / 16][4];
  {
    const bf16* pa = qb + (int64_t)ra * D;
    const bf16* pb = qb + (int64_t)rb * D;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      qf[kk][0] = ra < seq_q ? ld32(pa + c) : 0u;
      qf[kk][1] = rb < seq_q ? ld32(pb + c) : 0u;
      qf[kk][2] = ra < seq_q ? ld32(pa + c + 8) : 0u;
      qf[kk][3] = rb < seq_q ? ld32(pb + c + 8) : 0u;
    }
  }

  float o[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m_a = neg_inf(), m_b = neg_inf();  // running max of rows ra, rb
  float l_a = 0.0f, l_b = 0.0f;            // this lane's part of the sums

  // ldmatrix rows of K: key lane % 8 of an 8-key block, columns from
  // 8 (lane / 8): the B fragments of two 16-column steps of q . k^T.
  // ldmatrix.trans rows of V: key (lane % 8) + 8 ((lane / 8) & 1), columns
  // from 8 (lane / 16): matrices 0 and 1 give the B fragment of an 8-column
  // block of P . V, 2 and 3 that of the next
  const int k_row = lane % 8, k_col = 8 * (lane / 8);
  const int v_row = (lane % 8) + 8 * ((lane / 8) & 1);
  const int v_col = 8 * (lane / 16);

  for (int kt = kv.begin; kt < kv.end; ++kt) {
    const int k0 = kt * kKeys;
    const int buf = (kt - kv.begin) & 1;
    __syncthreads();  // every warp is done with the other buffer
    if (kt + 1 < kv.end) {
      load_tile_async<D>(tiles + (buf ^ 1) * L::tile, kb, k0 + kKeys, seq_k);
      load_tile_async<D>(tiles + (2 + (buf ^ 1)) * L::tile, vb, k0 + kKeys,
                         seq_k);
      cp_async_commit();
      cp_async_wait<1>();  // this tile's group has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = tiles + buf * L::tile;
    const bf16* vs = tiles + (2 + buf) * L::tile;

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk + 1 < D / 16; kk += 2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, ks + (n * 8 + k_row) * ld + kk * 16 + k_col);
        mma_bf16(s[n], qf[kk], kf[0], kf[1]);
        mma_bf16(s[n], qf[kk + 1], kf[2], kf[3]);
      }
      if constexpr ((D / 16) % 2 == 1) {
        // an odd count of 16-column steps (D = 80): the last step alone,
        // from two 8 x 8 matrices that lanes 0-15 address
        constexpr int kk = D / 16 - 1;
        uint32_t kf[2];
        ldmatrix_x2(kf, ks + (n * 8 + k_row) * ld + kk * 16 + (k_col & 8));
        mma_bf16(s[n], qf[kk], kf[0], kf[1]);
      }
    }

    // scale into log2 units; test the masks only on a tile that crosses
    // the diagonal, the window's edge or Sk
    const bool edge = k0 + kKeys > seq_k ||
                      (causal && k0 + kKeys - 1 > q0) ||
                      (has_window && k0 <= q0 + kRows - 1 - window);
    float mx_a = neg_inf(), mx_b = neg_inf();
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int row = e < 2 ? ra : rb;
          const int col = k0 + n * 8 + 2 * t + (e & 1);
          const bool vis = col < seq_k && (!causal || col <= row) &&
                           (!has_window || col > row - window);
          x = vis ? x : neg_inf();
        }
        s[n][e] = x;
        if (e < 2) mx_a = fmaxf(mx_a, x);
        else mx_b = fmaxf(mx_b, x);
      }
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    // while a row has seen nothing its max is -inf: exponentiate against 0,
    // so masked columns give exp2(-inf) = 0 and never 1
    const float base_a = mn_a == neg_inf() ? 0.0f : mn_a;
    const float base_b = mn_b == neg_inf() ? 0.0f : mn_b;
    const float alpha_a = ex2(m_a - base_a), alpha_b = ex2(m_b - base_b);
    m_a = mn_a;
    m_b = mn_b;
    l_a *= alpha_a;
    l_b *= alpha_b;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      o[n][0] *= alpha_a;
      o[n][1] *= alpha_a;
      o[n][2] *= alpha_b;
      o[n][3] *= alpha_b;
    }

    // P in registers: the scores of 8-column blocks 2 j and 2 j + 1 are the
    // A fragment of keys [16 j, 16 j + 16), high and low bf16 parts
#pragma unroll
    for (int j = 0; j < kKeys / 16; ++j) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        // r: 0 (row a, block 2j), 1 (row b, 2j), 2 (row a, 2j+1), 3 (b, 2j+1)
        const int n = 2 * j + (r >> 1), e = 2 * (r & 1);
        const float base = (r & 1) ? base_b : base_a;
        const float p0 = ex2(s[n][e] - base);
        const float p1 = ex2(s[n][e + 1] - base);
        if (r & 1) l_b += p0 + p1;
        else l_a += p0 + p1;
        hi[r] = pack(p0, p1);
        const __nv_bfloat162 h2 = *reinterpret_cast<const __nv_bfloat162*>(
            &hi[r]);
        const float2 hf = __bfloat1622float2(h2);
        lo[r] = pack(p0 - hf.x, p1 - hf.y);
      }
#pragma unroll
      for (int nn = 0; nn < D / 16; ++nn) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vs + (j * 16 + v_row) * ld + nn * 16 + v_col);
        mma_bf16(o[2 * nn], hi, vf[0], vf[1]);
        mma_bf16(o[2 * nn], lo, vf[0], vf[1]);
        mma_bf16(o[2 * nn + 1], hi, vf[2], vf[3]);
        mma_bf16(o[2 * nn + 1], lo, vf[2], vf[3]);
      }
    }
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float inv_a = l_a > 0.0f ? 1.0f / l_a : 0.0f;  // no key seen: 0
  const float inv_b = l_b > 0.0f ? 1.0f / l_b : 0.0f;
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    const int c = n * 8 + 2 * t;
    if (ra < seq_q)
      store2(ob + (int64_t)ra * D + c, o[n][0] * inv_a, o[n][1] * inv_a);
    if (rb < seq_q)
      store2(ob + (int64_t)rb * D + c, o[n][2] * inv_b, o[n][3] * inv_b);
  }
}

// ------------------------------------------------------------- fp32 ----
// Shared-memory layout of one block, in bytes: [q tile] [k tile] [v tile]
// [P slices].  Rows are padded so that the lanes of a warp fall on distinct
// banks and every row starts 16-byte aligned.
template <int D>
struct F32Layout {
  static constexpr int ld = D + 4;  // elements per row
  static constexpr size_t tile_bytes = kRows * ld * sizeof(float);
  static constexpr size_t p_bytes = kWarps * 16 * kPLd * sizeof(float);
  static constexpr size_t total = 3 * tile_bytes + p_bytes;
};

// rows [row0, row0 + 64) of a (rows, D) matrix into shared memory, as 16-byte
// vectors; rows at or past n_rows are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int n_rows) {
  constexpr int kPerRow = D / 4;
  constexpr int ld = F32Layout<D>::ld;
  for (int e = threadIdx.x; e < 64 * kPerRow; e += kThreads) {
    const int r = e / kPerRow, c = (e % kPerRow) * 4;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + r < n_rows)
      val = *reinterpret_cast<const float4*>(src + (int64_t)(row0 + r) * D +
                                             c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int hq,
                 int hkv, int seq_q, int seq_k, int causal, int has_window,
                 int window, float scale_log2) {
  using L = F32Layout<D>;
  constexpr int ld = L::ld;
  constexpr int kN = D / 8;  // 8-column groups of the output
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = reinterpret_cast<float*>(smem + L::tile_bytes);
  float* vs = reinterpret_cast<float*>(smem + 2 * L::tile_bytes);
  float* ps = reinterpret_cast<float*>(smem + 3 * L::tile_bytes);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const float* qb = q + ((int64_t)b * hq + h) * seq_q * D;
  const int64_t kv_off = ((int64_t)b * hkv + h / (hq / hkv)) * seq_k * D;
  const float* kb = k + kv_off;
  const float* vb = v + kv_off;
  float* ob = out + ((int64_t)b * hq + h) * seq_q * D;
  float* pw = ps + warp * 16 * kPLd;  // this warp's P slice
  const KvRange kv = kv_range(q0, seq_q, seq_k, causal, has_window, window);

  const int ra = q0 + warp * 16 + g, rb = ra + 8;  // this lane's two rows
  load_tile<D>(qs, qb, q0, seq_q);

  float o[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m_a = neg_inf(), m_b = neg_inf();  // running max of rows ra, rb
  float l_a = 0.0f, l_b = 0.0f;            // this lane's part of the sums

  for (int kt = kv.begin; kt < kv.end; ++kt) {
    const int k0 = kt * kKeys;
    __syncthreads();  // every warp is done with the previous tiles
    load_tile<D>(ks, kb, k0, seq_k);
    load_tile<D>(vs, vb, k0, seq_k);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
    const float* xa = qs + (warp * 16 + g) * ld;
    const float* xb = xa + 8 * ld;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qa = xa[d], qbv = xb[d];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float k_0 = ks[(n * 8 + 2 * t) * ld + d];
        const float k_1 = ks[(n * 8 + 2 * t + 1) * ld + d];
        s[n][0] = fmaf(qa, k_0, s[n][0]);
        s[n][1] = fmaf(qa, k_1, s[n][1]);
        s[n][2] = fmaf(qbv, k_0, s[n][2]);
        s[n][3] = fmaf(qbv, k_1, s[n][3]);
      }
    }

    // scale into log2 units, mask, and take the tile's row maxima
    float mx_a = neg_inf(), mx_b = neg_inf();
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? ra : rb;
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const bool vis = col < seq_k && (!causal || col <= row) &&
                         (!has_window || col > row - window);
        s[n][e] = vis ? s[n][e] * scale_log2 : neg_inf();
        if (e < 2) mx_a = fmaxf(mx_a, s[n][e]);
        else mx_b = fmaxf(mx_b, s[n][e]);
      }
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    // while a row has seen nothing its max is -inf: exponentiate against 0,
    // so masked columns give exp2(-inf) = 0 and never 1
    const float base_a = mn_a == neg_inf() ? 0.0f : mn_a;
    const float base_b = mn_b == neg_inf() ? 0.0f : mn_b;
    const float alpha_a = exp2f(m_a - base_a), alpha_b = exp2f(m_b - base_b);
    m_a = mn_a;
    m_b = mn_b;
    l_a *= alpha_a;
    l_b *= alpha_b;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      o[n][0] *= alpha_a;
      o[n][1] *= alpha_a;
      o[n][2] *= alpha_b;
      o[n][3] *= alpha_b;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float p0 = exp2f(s[n][0] - base_a), p1 = exp2f(s[n][1] - base_a);
      const float p2 = exp2f(s[n][2] - base_b), p3 = exp2f(s[n][3] - base_b);
      l_a += p0 + p1;
      l_b += p2 + p3;
      store2(pw + g * kPLd + n * 8 + 2 * t, p0, p1);
      store2(pw + (g + 8) * kPLd + n * 8 + 2 * t, p2, p3);
    }
    __syncwarp();

    // o += P . V for rows ra, rb and columns 8 n + 2 t, 8 n + 2 t + 1
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      const float pa = pw[g * kPLd + j], pb = pw[(g + 8) * kPLd + j];
      const float* vrow = vs + j * ld + 2 * t;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const float2 vv = *reinterpret_cast<const float2*>(vrow + n * 8);
        o[n][0] = fmaf(pa, vv.x, o[n][0]);
        o[n][1] = fmaf(pa, vv.y, o[n][1]);
        o[n][2] = fmaf(pb, vv.x, o[n][2]);
        o[n][3] = fmaf(pb, vv.y, o[n][3]);
      }
    }
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float inv_a = l_a > 0.0f ? 1.0f / l_a : 0.0f;  // no key seen: 0
  const float inv_b = l_b > 0.0f ? 1.0f / l_b : 0.0f;
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    const int c = n * 8 + 2 * t;
    if (ra < seq_q)
      store2(ob + (int64_t)ra * D + c, o[n][0] * inv_a, o[n][1] * inv_a);
    if (rb < seq_q)
      store2(ob + (int64_t)rb * D + c, o[n][2] * inv_b, o[n][3] * inv_b);
  }
}

struct Args {
  const void *q, *k, *v;
  void* out;
  int batch, hq, hkv, seq_q, seq_k, causal, has_window, window;
  float scale_log2;
  int device;
  cudaStream_t stream;
};

template <typename T, auto Kernel>
cudaError_t launch(const Args& a, size_t smem) {
  if (smem > 48 * 1024) {
    cudaError_t err = allow_smem<Kernel>((int)smem, a.device);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((a.seq_q + kRows - 1) / kRows, a.hq, a.batch);
  Kernel<<<grid, kThreads, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.out, a.hq, a.hkv,
      a.seq_q, a.seq_k, a.causal, a.has_window, a.window, a.scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(int dtype, const Args& a) {
  if (dtype == 0)
    return launch<float, flash_f32_kernel<D>>(a, F32Layout<D>::total);
  if (dtype == 1)
    return launch<bf16, flash_bf16_kernel<D>>(a, Bf16Layout<D>::total);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (the codes the Python wrapper
// passes).  `window` is read only when has_window is 1; the wrapper clamps it
// into [-seq_k, seq_q], which keeps every visibility test unchanged.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int batch,
                                     int q_heads, int kv_heads, int seq_q,
                                     int seq_k, int head_dim, int dtype,
                                     int causal, int has_window, int window,
                                     float sm_scale, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch <= 0 || q_heads <= 0 || kv_heads <= 0 || seq_q <= 0 ||
      seq_k <= 0 || q_heads % kv_heads)
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = sm_scale * 1.4426950408889634f;  // log2(e)
  const Args a{q,       k,     v,      out,        batch,
               q_heads, kv_heads, seq_q, seq_k,    causal,
               has_window, window, scale_log2, device, (cudaStream_t)stream};
  switch (head_dim) {
    case 32: return (int)launch_d<32>(dtype, a);
    case 64: return (int)launch_d<64>(dtype, a);
    case 80: return (int)launch_d<80>(dtype, a);
    case 128: return (int)launch_d<128>(dtype, a);
    default: return (int)cudaErrorInvalidValue;
  }
}
