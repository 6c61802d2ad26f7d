// Bitonic row sort for Hopper (sm_90a): each row of a (rows, n) array
// sorted ascending, n a power of two from 1 to 32768.
//
// Replaces: the Pallas `sort_rows` kernel, src/repro/kernels/sort_bitonic.py
// (`_sort_kernel` :45 and `_bitonic_stage` :27, launched at :62), the paper's
// data-reuse TAO class.
//
// Bound on the card: bytes.  Each row is read once and written once (2 * 16
// KB for a 4096-element fp32 row: 0.0100 ms for 1024 rows over HBM3's
// 3.35 TB/s).  The network's log2(n) * (log2(n) + 1) / 2 stages of n / 2
// compare-exchanges (78 stages for n = 4096) count as two operations each:
// 0.33 G for 1024 rows, 0.005 ms at the CUDA cores' 67 TFLOP/s.  But a
// compare-exchange is two instructions of the integer/logic pipe, which
// runs 64 lanes a clock on an SM (half the fp32 rate): 0.011 ms at best
// for 1024 rows, and every instruction a stage adds beyond those two (a
// direction test, a select, a shuffle) costs as much again.  So the design
// spends as few instructions as it can on each exchange.
//
// Design: the TPU kernel keeps the row in VMEM across every stage.  Here a
// thread holds E = 2^R contiguous elements of the row in registers (E = 16;
// E = n below 16, and 32 at n = 32768: 1024 threads), the row spread over
// P = n / E threads.
// * Keys: each value becomes an int32 whose signed order is the value's
//   (fp32: the magnitude bits of negatives flipped; int32 as it is), so a
//   compare-exchange is one integer min and one max, which moves values
//   only as a permutation, whatever the bits.
// * Directions: while a merge step's blocks lie inside a thread the
//   direction of each pair is a compile-time constant.  Above that it is a
//   bit of the thread index: the keys of descending blocks are held
//   complemented (~key reverses the order), so every exchange ascends, and
//   each merge step flips the keys whose direction changes (E XORs).
// * Stages of distance 2^j < E run between registers at compile-time
//   indices.  Stages of j >= R go through shared memory: the row is written
//   there once a merge step, then each thread reads back the E elements
//   whose index bits b0 .. b0 + R - 1 vary, runs up to R stages in
//   registers, and writes them back, one barrier a pass.  At n = 4096 a
//   merge step takes one or two passes (78 barriers before, 20 now); no
//   stage shuffles between lanes, which costs three instructions an element
//   beside the shuffle.
// The row is read from and written to device memory once, as 16-byte
// vectors (E contiguous elements a thread; scalars when the input is not
// 16-byte aligned).  The shared-memory layout XORs the low index bits with
// higher ones, so the 16-byte row writes and the scalar reads of every
// transposed pass are free of bank conflicts (n >= 512).  Rows of under 2048
// elements share a block of 128 threads.  Every geometry is a template on
// log2(n), so every register index is a compile-time constant.
//
// The output is always a permutation of the input, and on finite inputs it
// is bit-identical to torch.sort / np.sort.  The order of -0.0 and +0.0
// (here -0.0 first), and NaN (here at the ends, by sign), are out of scope.
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "common.cuh"

namespace {

constexpr int kMaxLog = 15;  // rows of up to 32768 elements

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// log2 of the elements a thread holds, for rows of 2^L elements
__host__ __device__ constexpr int reg_log(int L) {
  return L < 4 ? L : (L < kMaxLog ? 4 : 5);
}

template <int L>
struct Geometry {
  static constexpr int R = reg_log(L);
  static constexpr int E = 1 << R;             // elements a thread holds
  static constexpr int P = 1 << (L - R);       // threads a row
  static constexpr int kThreads = P > 128 ? P : 128;
  static constexpr int kRows = kThreads / P;   // rows a block
  static constexpr bool kShared = L > R;       // a row spans threads
};

// The lowest index bit of the transposed pass that starts at bit `jhi`:
// R bits, none of them register bits while the stage bits allow, all
// inside the row.
__host__ __device__ constexpr int pass_base(int L, int R, int jhi) {
  return cmin(cmax(jhi - R + 1, R), L - R);
}

// The highest stage of merge step k that no transposed pass covers.
__host__ __device__ constexpr int after_passes(int L, int R, int k) {
  while (k >= R) k = pass_base(L, R, k) - 1;
  return k;
}

// An int32 key whose signed order is the order of the value: float bits
// with the magnitude bits of negatives flipped (a total order: -0 < +0,
// NaNs at the ends).  The map is its own inverse.
__device__ __forceinline__ int32_t key_of(uint32_t bits, float) {
  const int32_t b = (int32_t)bits;
  return b ^ ((b >> 31) & 0x7fffffff);
}
__device__ __forceinline__ int32_t key_of(uint32_t bits, int32_t) {
  return (int32_t)bits;
}
__device__ __forceinline__ uint32_t bits_of(int32_t key, float) {
  return (uint32_t)(key ^ ((key >> 31) & 0x7fffffff));
}
__device__ __forceinline__ uint32_t bits_of(int32_t key, int32_t) {
  return (uint32_t)key;
}
__device__ __forceinline__ uint32_t to_bits(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ uint32_t to_bits(int32_t v) { return (uint32_t)v; }
__device__ __forceinline__ void from_bits(uint32_t b, float& v) {
  v = __uint_as_float(b);
}
__device__ __forceinline__ void from_bits(uint32_t b, int32_t& v) {
  v = (int32_t)b;
}

// the smaller key to a, the larger to b: two integer min/max instructions,
// and a permutation whatever the keys
__device__ __forceinline__ void ascend(int32_t& a, int32_t& b) {
  const int32_t lo = min(a, b);
  b = max(a, b);
  a = lo;
}

// Where index i of a row lives in shared memory: bits 2..3 (R = 4) or
// 2..4 (R = 5) XORed with the bits above 5, and for R = 4 bit 4 with bit 8,
// so that the 16-byte writes of the row layout and the scalar reads of
// every transposed pass are free of bank conflicts.
template <int R>
__device__ __forceinline__ int swizzle(int i) {
  if constexpr (R == 4) return i ^ ((i >> 3) & 0xC) ^ ((i >> 4) & 0x10);
  if constexpr (R == 5) return i ^ ((i >> 3) & 0x1C);
  return i;
}

// Row-local thread t's E elements, t * E .. t * E + E - 1, as keys, from
// and to device memory.
template <typename T, int E>
__device__ __forceinline__ void load_row(int32_t (&v)[E], const T* p,
                                         bool vec) {
  if constexpr (E >= 4) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < E / 4; ++q) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + q);
        v[4 * q] = key_of(u.x, T());
        v[4 * q + 1] = key_of(u.y, T());
        v[4 * q + 2] = key_of(u.z, T());
        v[4 * q + 3] = key_of(u.w, T());
      }
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = key_of(to_bits(p[e]), T());
}

template <typename T, int E>
__device__ __forceinline__ void store_row(T* p, const int32_t (&v)[E],
                                          bool vec) {
  if constexpr (E >= 4) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < E / 4; ++q)
        reinterpret_cast<uint4*>(p)[q] = make_uint4(
            bits_of(v[4 * q], T()), bits_of(v[4 * q + 1], T()),
            bits_of(v[4 * q + 2], T()), bits_of(v[4 * q + 3], T()));
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) from_bits(bits_of(v[e], T()), p[e]);
}

// The row layout to and from shared memory (rows that span threads: E >= 16)
template <int R>
__device__ __forceinline__ void to_shared(int32_t* s,
                                          const int32_t (&v)[1 << R], int t) {
#pragma unroll
  for (int q = 0; q < (1 << R) / 4; ++q)
    *reinterpret_cast<int4*>(s + swizzle<R>((t << R) + 4 * q)) =
        make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

template <int R>
__device__ __forceinline__ void from_shared(int32_t (&v)[1 << R],
                                            const int32_t* s, int t) {
#pragma unroll
  for (int q = 0; q < (1 << R) / 4; ++q) {
    const int4 u =
        *reinterpret_cast<const int4*>(s + swizzle<R>((t << R) + 4 * q));
    v[4 * q] = u.x;
    v[4 * q + 1] = u.y;
    v[4 * q + 2] = u.z;
    v[4 * q + 3] = u.w;
  }
}

// Stages J .. 0 between the E registers: every pair ascends.
template <int J, int E>
__device__ __forceinline__ void register_stages(int32_t (&v)[E]) {
#pragma unroll
  for (int j = J; j >= 0; --j) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (!(e & (1 << j))) ascend(v[e], v[e + (1 << j)]);
  }
}

// Merge step K's stages JHI .. B0 on the row in shared memory: thread t
// takes the E elements whose index bits B0 .. B0 + R - 1 are e, the other
// bits t's, runs the stages in registers and writes them back; then the
// next pass down while stages of R and above remain.
template <int L, int JHI>
__device__ __forceinline__ void shared_passes(int32_t* s, int t) {
  constexpr int R = Geometry<L>::R, E = Geometry<L>::E;
  if constexpr (JHI >= R) {
    constexpr int B0 = pass_base(L, R, JHI);
    const int rest = (t & ((1 << B0) - 1)) | ((t >> B0) << (B0 + R));
    int32_t v[E];
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = s[swizzle<R>(rest | (e << B0))];
    register_stages<JHI - B0>(v);
#pragma unroll
    for (int e = 0; e < E; ++e) s[swizzle<R>(rest | (e << B0))] = v[e];
    __syncthreads();
    shared_passes<L, B0 - 1>(s, t);
  }
}

// Merge step K.  While the step's blocks of 2^(K+1) lie inside a thread
// (K + 1 < R) each pair's direction is a compile-time constant.  From
// K = R - 1 on a block's direction is a bit of t: the keys of descending
// blocks are held complemented (~key reverses the order), so every pair
// ascends, and each step flips the keys whose direction changes.
template <int L, int K>
__device__ __forceinline__ void merge_step(int32_t (&v)[Geometry<L>::E],
                                           int32_t* s, int t) {
  using G = Geometry<L>;
  constexpr int R = G::R, E = G::E;
  if constexpr (K + 1 < R) {
#pragma unroll
    for (int j = K; j >= 0; --j) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (e & (1 << j)) continue;
        if ((e >> (K + 1)) & 1)
          ascend(v[e + (1 << j)], v[e]);
        else
          ascend(v[e], v[e + (1 << j)]);
      }
    }
  } else {
    // the held direction moves from index bit K to bit K + 1 (t's bits
    // K - R and K + 1 - R); nothing is held complemented before K = R - 1
    const int flip = K + 1 == R ? t : (t >> (K - R)) ^ (t >> (K + 1 - R));
    const int32_t mask = -(flip & 1);
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] ^= mask;
    if constexpr (K >= R) {
      to_shared<R>(s, v, t);
      __syncthreads();
      shared_passes<L, K>(s, t);
      from_shared<R>(v, s, t);
    }
    register_stages<cmin(after_passes(L, R, K), R - 1)>(v);
  }
}

template <int L, int K>
__device__ __forceinline__ void merge_steps(int32_t (&v)[Geometry<L>::E],
                                            int32_t* s, int t) {
  if constexpr (K < L) {
    merge_step<L, K>(v, s, t);
    merge_steps<L, K + 1>(v, s, t);
  }
}

template <typename T, int L>
__global__ void __launch_bounds__(Geometry<L>::kThreads)
sort_rows_kernel(const T* __restrict__ x, T* __restrict__ out, int rows,
                 bool vec) {
  using G = Geometry<L>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sub = threadIdx.x / G::P;  // the block's row this thread sorts
  const int t = threadIdx.x % G::P;
  const int64_t row = (int64_t)blockIdx.x * G::kRows + sub;
  const bool live = row < rows;  // a short last block's idle rows still
                                 // reach every barrier
  int32_t* s =
      reinterpret_cast<int32_t*>(smem_raw) + (G::kShared ? sub << L : 0);
  const int64_t at = (row << L) + t * G::E;
  int32_t v[G::E];
  if (live) {
    load_row(v, x + at, vec);
  } else {
#pragma unroll
    for (int e = 0; e < G::E; ++e) v[e] = 0;
  }
  merge_steps<L, 0>(v, s, t);
  if (live) store_row(out + at, v, vec);
}

template <typename T, int L>
int launch(const void* x, void* out, int rows, int device,
           cudaStream_t stream) {
  using G = Geometry<L>;
  const int smem = G::kShared ? G::kRows * (int)sizeof(T) << L : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        repro::allow_smem<sort_rows_kernel<T, L>>(smem, device);
    if (err != cudaSuccess) return (int)err;
  }
  const bool vec = (((uintptr_t)x | (uintptr_t)out) & 15) == 0;
  const int64_t blocks = ((int64_t)rows + G::kRows - 1) / G::kRows;
  sort_rows_kernel<T, L><<<(unsigned)blocks, G::kThreads, smem, stream>>>(
      (const T*)x, (T*)out, rows, vec);
  return (int)cudaGetLastError();
}

template <typename T, int... Ls>
int launch_log(int log2n, const void* x, void* out, int rows, int device,
               cudaStream_t stream, std::integer_sequence<int, Ls...>) {
  using Fn = int (*)(const void*, void*, int, int, cudaStream_t);
  static constexpr Fn table[] = {&launch<T, Ls>...};
  return table[log2n](x, out, rows, device, stream);
}

}  // namespace

// dtype: 0 = float32, 2 = int32 (the codes the Python wrapper passes)
extern "C" int repro_sort_rows(const void* x, void* out, int rows, int n,
                               int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows <= 0 || n <= 0) return (int)cudaGetLastError();
  int log2n = 0;
  while ((1 << log2n) < n && log2n <= kMaxLog) ++log2n;
  if ((1 << log2n) != n || log2n > kMaxLog) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const auto logs = std::make_integer_sequence<int, kMaxLog + 1>{};
  if (dtype == 0)
    return launch_log<float>(log2n, x, out, rows, device, s, logs);
  if (dtype == 2)
    return launch_log<int32_t>(log2n, x, out, rows, device, s, logs);
  return (int)cudaErrorInvalidValue;
}
