// Flash attention forward for Hopper (sm_90a): online-softmax attention with
// grouped-query heads, a causal mask and a sliding window.
// q (B, Hq, S, D), k and v (B, Hkv, Sk, D), out (B, Hq, S, D) in q's dtype;
// fp32 or bf16, D in {32, 64, 128}.
//
// Replaces: the Pallas `flash_attention` kernel,
// src/repro/kernels/flash_attention.py (`_flash_kernel` :33-93, launched by
// `flash_attention` :98-146), the serving zoo's prefill slab.
//
// What it computes, as the TPU kernel does: s = (q . k^T) * sm_scale with fp32
// operands and an fp32 sum; masks on absolute, top-left indices (causal is
// col <= row, the window col > row - window, S != Sk allowed); kv head = q
// head / (Hq / Hkv), by indexing, with no repeated heads in memory; the
// softmax state (running max m, sum l, accumulator) in fp32; output in q's
// dtype.  kv tiles that no row of the q tile can see are skipped, so causal
// attention does about half the work and a window O(S * window).
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
// cores and not HBM set the limit.
//
// Design.  The TPU kernel carries acc, m and l in VMEM from one step of a
// sequential kv grid axis to the next.  Blocks of the card run in no order,
// so one block owns one (batch, head, 64-row q tile), loops over the kv
// tiles itself with the softmax state in registers, and writes its output
// once.  Four warps own 16 q rows each.  Each kv tile of 64 keys is staged
// in shared memory, where all four warps reuse it.
//   * Scores.  bf16: q . k^T on the tensor cores with mma.sync m16n8k16
//     (bf16 in, fp32 sum); the products of bf16 values are exact in fp32, so
//     this matches the TPU's fp32 dot up to summation order.  fp32: fmaf on
//     the CUDA cores, never TF32.  Both leave the warp's 16 x 64 scores in
//     registers in the mma accumulator layout: lane (g, t) = (lane / 4,
//     lane % 4) holds rows g and g + 8, columns 8 n + 2 t and 8 n + 2 t + 1.
//     Masking, the running max and the exponentials work on that layout,
//     with the row's quad of lanes reduced by shuffles.
//   * P . V in fp32 on the CUDA cores for both dtypes, as the TPU kernel
//     does (it casts v to fp32): each warp writes its fp32 P tile to its own
//     shared-memory slice and every lane sums p * v for its two rows and D/4
//     columns.  No rounding of P, so the bf16 path adds no rounding beyond
//     the output's.
// This is the first, simple version: no cp.async or TMA pipeline, no wgmma,
// and P . V off the tensor cores, which a later version needs to come near
// the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;   // q rows per block
constexpr int kKeys = 64;   // keys per kv tile
constexpr int kWarps = 4;   // 16 q rows each
constexpr int kThreads = kWarps * 32;
constexpr int kPLd = kKeys + 4;  // row stride of a warp's P slice (floats)

// Shared-memory layout of one block, in bytes: [q tile (fp32 only)] [k tile]
// [v tile] [P slices].  Rows are padded so that the lanes of a warp fall on
// distinct banks and every row starts 16-byte aligned.
template <typename T, int D>
struct Layout {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int ld = D + (kF32 ? 4 : 8);  // elements per row
  static constexpr size_t q_bytes = kF32 ? kRows * ld * sizeof(T) : 0;
  static constexpr size_t kv_bytes = kKeys * ld * sizeof(T);
  static constexpr size_t p_bytes = kWarps * 16 * kPLd * sizeof(float);
  static constexpr size_t total = q_bytes + 2 * kv_bytes + p_bytes;
};

// rows [row0, row0 + 64) of a (rows, D) matrix into shared memory, as 16-byte
// vectors; rows at or past n_rows are zero-filled
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          int row0, int n_rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  constexpr int ld = Layout<T, D>::ld;
  for (int e = threadIdx.x; e < 64 * kPerRow; e += kThreads) {
    const int r = e / kPerRow, c = (e % kPerRow) * kVec;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int hq,
                 int hkv, int seq_q, int seq_k, int causal, int has_window,
                 int window, float scale_log2) {
  using L = Layout<T, D>;
  constexpr int ld = L::ld;
  constexpr int kN = D / 8;  // 8-column groups of the output
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = reinterpret_cast<T*>(smem + L::q_bytes);
  T* vs = reinterpret_cast<T*>(smem + L::q_bytes + L::kv_bytes);
  float* ps = reinterpret_cast<float*>(smem + L::q_bytes + 2 * L::kv_bytes);

  const float neg_inf = __uint_as_float(0xff800000u);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // causal tiles further down do more work: start them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const T* qb = q + ((int64_t)b * hq + h) * seq_q * D;
  const int64_t kv_off = ((int64_t)b * hkv + h / (hq / hkv)) * seq_k * D;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;
  T* ob = out + ((int64_t)b * hq + h) * seq_q * D;
  float* pw = ps + warp * 16 * kPLd;  // this warp's P slice

  // the kv tiles some row of [q0, row_hi] can see
  const int row_hi = min(q0 + kRows - 1, seq_q - 1);
  int kt_end = (seq_k + kKeys - 1) / kKeys;
  if (causal) kt_end = min(kt_end, row_hi / kKeys + 1);
  int kt_begin = 0;
  if (has_window) {
    const int col_lo = q0 - window + 1;  // row q0's first visible column
    kt_begin = col_lo > 0 ? col_lo / kKeys : 0;
  }

  const int ra = q0 + warp * 16 + g, rb = ra + 8;  // this lane's two rows
  uint32_t qf[std::is_same<T, bf16>::value ? D / 16 : 1][4];
  if constexpr (std::is_same<T, bf16>::value) {
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
  } else {
    load_tile<T, D>(qs, qb, q0, seq_q);
  }

  float o[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m_a = neg_inf, m_b = neg_inf;  // running max of rows ra, rb (log2)
  float l_a = 0.0f, l_b = 0.0f;        // this lane's part of the row sums

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kKeys;
    __syncthreads();  // every warp is done with the previous tiles
    load_tile<T, D>(ks, kb, k0, seq_k);
    load_tile<T, D>(vs, vb, k0, seq_k);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
    if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const bf16* krow = ks + (n * 8 + g) * ld + 2 * t;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          mma_bf16(s[n], qf[kk], ld32(krow + kk * 16),
                   ld32(krow + kk * 16 + 8));
      }
    } else {
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
    }

    // scale into log2 units, mask, and take the tile's row maxima
    float mx_a = neg_inf, mx_b = neg_inf;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? ra : rb;
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const bool vis = col < seq_k && (!causal || col <= row) &&
                         (!has_window || col > row - window);
        s[n][e] = vis ? s[n][e] * scale_log2 : neg_inf;
        if (e < 2) mx_a = fmaxf(mx_a, s[n][e]);
        else mx_b = fmaxf(mx_b, s[n][e]);
      }
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    // while a row has seen nothing its max is -inf: exponentiate against 0,
    // so masked columns give exp2(-inf) = 0 and never 1
    const float base_a = mn_a == neg_inf ? 0.0f : mn_a;
    const float base_b = mn_b == neg_inf ? 0.0f : mn_b;
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
      const T* vrow = vs + j * ld + 2 * t;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const float2 vv = load2(vrow + n * 8);
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

constexpr int kMaxDevices = 64;  // devices whose smem attribute is cached

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int batch, int hq, int hkv, int seq_q, int seq_k,
                   int causal, int has_window, int window, float scale_log2,
                   int device, cudaStream_t stream) {
  constexpr size_t smem = Layout<T, D>::total;
  auto kernel = flash_fwd_kernel<T, D>;
  if constexpr (smem > 48 * 1024) {
    // above 48 KB the block's limit must be raised; the size is fixed for
    // each instantiation, so raise it once per device
    static std::atomic<bool> raised[kMaxDevices];
    const bool cached = device < kMaxDevices;
    if (!cached || !raised[device].load(std::memory_order_acquire)) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      if (cached) raised[device].store(true, std::memory_order_release);
    }
  }
  dim3 grid((seq_q + kRows - 1) / kRows, hq, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, hq, hkv, seq_q, seq_k,
      causal, has_window, window, scale_log2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int head_dim, const void* q, const void* k,
                     const void* v, void* out, int batch, int hq, int hkv,
                     int seq_q, int seq_k, int causal, int has_window,
                     int window, float scale_log2, int device,
                     cudaStream_t s) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(q, k, v, out, batch, hq, hkv, seq_q, seq_k, causal,
                           has_window, window, scale_log2, device, s);
    case 64:
      return launch<T, 64>(q, k, v, out, batch, hq, hkv, seq_q, seq_k, causal,
                           has_window, window, scale_log2, device, s);
    case 128:
      return launch<T, 128>(q, k, v, out, batch, hq, hkv, seq_q, seq_k,
                            causal, has_window, window, scale_log2, device, s);
    default:
      return cudaErrorInvalidValue;
  }
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
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    err = launch_d<float>(head_dim, q, k, v, out, batch, q_heads, kv_heads,
                          seq_q, seq_k, causal, has_window, window,
                          scale_log2, device, s);
  else if (dtype == 1)
    err = launch_d<bf16>(head_dim, q, k, v, out, batch, q_heads, kv_heads,
                         seq_q, seq_k, causal, has_window, window, scale_log2,
                         device, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
