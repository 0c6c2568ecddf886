// K9 window_gather and K10 onehot_pair: the two TPU probes of the fused
// kernel's gathers, as kernels for Hopper (sm_90a).
//
// Replaces:
// - benchmarks/probe_dyngather_tpu.py:main.make (P7), which times the fused
//   kernel's (chunk, L) row gathers from a banded window of v, as a one-hot
//   MXU product or as Mosaic's dynamic_gather, in f32 and bf16;
// - benchmarks/probe_onehot_dtype_tpu.py:main (P8), which times the fused
//   kernel's one-hot gather (oh^T . band) and scatter (oh . msg) over many
//   rounds for eight pairs of one-hot and value types.
//
// K9 computes, for both variants,
//   out (chunk, L) f32 = sum over r < rounds, c < chunks of f32(v[starts[c] + rel[c, i]])
// summed in that order (rounds outer, chunks inner) from zero.  The TPU
// kernel adds into a VMEM scratch it never zeroes (ROADMAP C10); this one
// keeps its sum in registers from 0.
// - onehot: per chunk the window v[starts[c] : starts[c] + band] is staged in
//   shared memory in 64-row K-slices (a cp.async ring) and multiplied on the
//   tensor cores by the one-hot A[i][k] = (k == rel[c, i]), built in
//   registers (no one-hot goes to memory), into fresh f32 accumulators that
//   are then added to the running sum.  Each row of A has one 1, so the
//   product is the gathered value exactly: bf16 directly (m16n8k16), f32 as
//   three TF32 parts of the window (m16n8k8, one accumulator a part), cut by
//   truncation so that every partial sum of the parts is a bit field of the
//   value and the tensor cores' truncating adds lose nothing.  The kernel
//   gives the plain version's bits.  Bound: the tensor cores, 2 chunk band L chunks rounds
//   operations (the function itself is bound by its bytes).
// - direct: each thread reads 16-byte vectors of its row (ld.global, as K2
//   reads its rows) and adds them in f32.  The rounds x chunks gathers are
//   all made, as the TPU kernel makes them, and not folded into a product by
//   rounds.  Bound: L2, chunks rounds chunk rows (v fits in L2).
// Blocks: K9 onehot tiles out by 64 rows (4 warps of 16) and 16 columns,
// which gives 128 blocks at the probe's shape (chunk 1024, L 128); the
// rounds and chunks loops run inside the block in place of the TPU's
// sequential grid.
//
// K10 computes
//   out (band, L) f32 = sum over t < rounds of (vs_t[:band] + contrib_t),
//   rel_t = (rel + t) mod band, vs_t[i] = cast(band_v)[rel_t[i]],
//   contrib_t[b] = sum over i with rel_t[i] = b of cast(msg)[i]   (f32 sums),
// where cast is the value type.  Both halves are tensor-core products with
// one-hot A fragments built in registers from rel_t; the gather is computed
// for the band rows that reach out, the scatter in full.  Hopper pairs no
// s8 or e4m3 operand with bf16 and nothing with f32, so the probe's eight
// type pairs fall onto three routes by value type (an int8 or e4m3 one-hot
// is exactly the bf16 one built here):
// - bf16 values: mma.sync m16n8k16, one accumulator for each half a round;
// - f32 values: 3xTF32 on m16n8k8, three truncated parts of the value, the
//   scatter in a fresh accumulator per K-step added to its sum in f32;
// - int8 values (int8 one-hot): mma.sync m16n8k32 with s32 accumulators,
//   converted to f32 at the end of a round (exact: integer sums).
// One launch runs every round, as the TPU kernel's unrolled loop does.  The
// block casts its column slice of band_v and msg once into shared memory,
// K-contiguous, and keeps it there for all rounds (the TPU kernel's
// operands stay in VMEM); a warp runs Route::kRounds rounds at a time.
// Bound: the tensor cores, 2 L band (band + chunk) operations a round.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma_tile.cuh"

namespace {

using mgn::Mma;
using mgn::cp_async16;
using mgn::cp_async_commit;
using mgn::cp_async_wait;
using bf16 = __nv_bfloat16;

constexpr uint32_t kOneF32 = 0x3F800000u;  // 1.0f, also 1.0 in TF32
constexpr uint32_t kOneBf16 = 0x3F80u;     // 1.0 in bf16
constexpr int kThreads = 128;              // 4 warps

// x = hi + mid + lo exactly, each part a TF32 value (low 13 bits zero):
// truncation keeps the three parts bit fields of x (same sign, inside x's
// 24-bit significand), so any partial sum of them is exact in f32.
__device__ __forceinline__ void split3(float x, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xFFFFE000u;
  const float r = x - __uint_as_float(hi);
  mid = __float_as_uint(r) & 0xFFFFE000u;
  lo = __float_as_uint(r - __uint_as_float(mid));
}

// The bf16 pair (k, k + 1) of a one-hot row whose 1 sits at k + d.
__device__ __forceinline__ uint32_t onehot_pair(int d) {
  return d == 0 ? kOneBf16 : (d == 1 ? kOneBf16 << 16 : 0u);
}

// The s8 quad (k .. k + 3) of a one-hot row whose 1 sits at k + d.
__device__ __forceinline__ uint32_t onehot_quad(int d) {
  return (d >= 0 && d < 4) ? 1u << (8 * d) : 0u;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// --- K9, onehot -----------------------------------------------------------------

constexpr int kWinRows = 64;  // out rows a block (16 a warp)
constexpr int kWinCols = 16;  // out columns a block
constexpr int kSlice = 64;    // window rows a K-slice
constexpr int kStages = 8;    // K-slices in the ring (a power of 2): 7 in flight

// Row pitch of a slice in shared memory: f32 24 words (the fragment loads'
// 32 lanes on 32 banks); bf16 40 halves, 80 bytes (ldmatrix's 8 rows on 8
// different 16-byte bank groups).
template <typename T> __host__ __device__ constexpr int win_pitch() {
  return sizeof(T) == 4 ? kWinCols + 8 : kWinCols + 24;
}
template <typename T> constexpr size_t win_smem() {
  return static_cast<size_t>(kStages) * kSlice * win_pitch<T>() * sizeof(T);
}
// Accumulators a gather uses: f32 one per TF32 part (three independent
// chains; each part's sum is exact, and so is hi + mid + lo), bf16 one.
template <typename T> __host__ __device__ constexpr int win_parts() {
  return sizeof(T) == 4 ? 3 : 1;
}

// One K-slice (kSlice rows of the window, the block's kWinCols columns)
// copied into a stage, 16 bytes a thread.
template <typename T>
__device__ __forceinline__ void copy_slice(T* stage, const T* __restrict__ v, int L, int row0,
                                           int n0, int tid) {
  constexpr int E = 16 / sizeof(T), CPR = kWinCols / E;
#pragma unroll
  for (int q = tid; q < kSlice * CPR; q += kThreads) {
    const int r = q / CPR, c = (q % CPR) * E;
    cp_async16(stage + r * win_pitch<T>() + c, v + static_cast<size_t>(row0 + r) * L + n0 + c,
               true);
  }
}

// acc (this warp's 16 rows x 16 columns) += A . slice, A[i][k] = (k0 + k == rel_i).
__device__ __forceinline__ void slice_product(float (&acc)[3][2][4], const float* s, int k0,
                                              int r0, int r1, int lane) {
  constexpr int P = win_pitch<float>();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kSlice; kk += 8) {
    const int k = k0 + kk + t;
    const uint32_t a[4] = {k == r0 ? kOneF32 : 0u, k == r1 ? kOneF32 : 0u,
                           k + 4 == r0 ? kOneF32 : 0u, k + 4 == r1 ? kOneF32 : 0u};
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      uint32_t hi[2], mid[2], lo[2];
      split3(s[(kk + t) * P + n * 8 + g], hi[0], mid[0], lo[0]);
      split3(s[(kk + t + 4) * P + n * 8 + g], hi[1], mid[1], lo[1]);
      Mma<float>::one(acc[0][n], a, hi);
      Mma<float>::one(acc[1][n], a, mid);
      Mma<float>::one(acc[2][n], a, lo);
    }
  }
}

__device__ __forceinline__ void slice_product(float (&acc)[1][2][4], const bf16* s, int k0,
                                              int r0, int r1, int lane) {
  using M = Mma<bf16>;
  constexpr int P = win_pitch<bf16>();
  const int t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kSlice; kk += 16) {
    const int k = k0 + kk + 2 * t;
    M::A a;
    a.r[0] = onehot_pair(r0 - k);
    a.r[1] = onehot_pair(r1 - k);
    a.r[2] = onehot_pair(r0 - k - 8);
    a.r[3] = onehot_pair(r1 - k - 8);
    M::B b0, b1;
    M::ldsm_b_n(b0, b1, s, P, 0, kk, lane);
    M::mma(acc[0][0], a, b0);
    M::mma(acc[0][1], a, b1);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    window_onehot_kernel(const T* __restrict__ v, const int* __restrict__ rel,
                         const int* __restrict__ starts, float* __restrict__ out, int L,
                         int chunk, int band, int n_chunks, int rounds) {
  constexpr int kStage = kSlice * win_pitch<T>(), PARTS = win_parts<T>();
  extern __shared__ __align__(16) unsigned char win_smem_raw[];
  T* ring = reinterpret_cast<T*>(win_smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kWinRows + (tid >> 5) * 16;  // this warp's 16 rows
  const int n0 = blockIdx.y * kWinCols;
  const int slices = band / kSlice, total = rounds * n_chunks * slices;
  // the copy cursor runs kStages - 1 slices ahead of the product's; both walk
  // (round, chunk, slice) by counting, with no division in the loop
  int copied = 0, cp_chunk = 0, cp_slice = 0;
  auto copy_next = [&]() {
    if (copied < total) {
      copy_slice(ring + (copied & (kStages - 1)) * kStage, v, L,
                 starts[cp_chunk] + cp_slice * kSlice, n0, tid);
      if (++cp_slice == slices) {
        cp_slice = 0;
        if (++cp_chunk == n_chunks) cp_chunk = 0;
      }
    }
    ++copied;
    cp_async_commit();  // empty past the end: the wait below counts groups
  };
  for (int s = 0; s < kStages - 1; ++s) copy_next();
  float sum[2][4] = {}, acc[PARTS][2][4] = {};
  // rel of rows m0 + g and m0 + g + 8 in chunk c, read a chunk ahead
  auto rel_of = [&](int c, int row) { return row < chunk ? rel[c * chunk + row] : -1; };
  int next0 = rel_of(0, m0 + g), next1 = rel_of(0, m0 + g + 8);
  int j = 0;
  for (int r = 0; r < rounds; ++r) {
    for (int c = 0; c < n_chunks; ++c) {
      const int r0 = next0, r1 = next1, cn = c + 1 < n_chunks ? c + 1 : 0;
      next0 = rel_of(cn, m0 + g);
      next1 = rel_of(cn, m0 + g + 8);
      for (int ks = 0; ks < slices; ++ks, ++j) {
        cp_async_wait<kStages - 2>();
        __syncthreads();  // slice j landed for all; stage (j - 1) % kStages is free
        copy_next();
        slice_product(acc, ring + (j & (kStages - 1)) * kStage, ks * kSlice, r0, r1, lane);
      }
      // the chunk's gather, exact, into the running sum
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = acc[0][n][i];
#pragma unroll
          for (int p = 1; p < PARTS; ++p) x += acc[p][n][i];
          sum[n][i] += x;
#pragma unroll
          for (int p = 0; p < PARTS; ++p) acc[p][n][i] = 0.f;
        }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int col = n0 + n * 8 + 2 * t;
    if (m0 + g < chunk)
      *reinterpret_cast<float2*>(out + static_cast<size_t>(m0 + g) * L + col) =
          make_float2(sum[n][0], sum[n][1]);
    if (m0 + g + 8 < chunk)
      *reinterpret_cast<float2*>(out + static_cast<size_t>(m0 + g + 8) * L + col) =
          make_float2(sum[n][2], sum[n][3]);
  }
}

// --- K9, direct ------------------------------------------------------------------

// 16 bytes from global memory; volatile, so that no load of the rounds loop is
// merged with another round's.
__device__ __forceinline__ uint4 ld16(const void* p) {
  uint4 x;
  asm volatile("ld.global.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x.x), "=r"(x.y), "=r"(x.z), "=r"(x.w)
               : "l"(p));
  return x;
}

__device__ __forceinline__ void add16(float (&acc)[4], uint4 x) {
  acc[0] += __uint_as_float(x.x);
  acc[1] += __uint_as_float(x.y);
  acc[2] += __uint_as_float(x.z);
  acc[3] += __uint_as_float(x.w);
}

__device__ __forceinline__ void add16(float (&acc)[8], uint4 x) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    acc[2 * j] += __uint_as_float(w[j] << 16);
    acc[2 * j + 1] += __uint_as_float(w[j] & 0xFFFF0000u);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    window_direct_kernel(const T* __restrict__ v, const int* __restrict__ rel,
                         const int* __restrict__ starts, float* __restrict__ out, int L,
                         int chunk, int n_chunks, int rounds) {
  constexpr int E = 16 / sizeof(T), U = 4;  // values a vector; gathers in flight
  const int per_row = L / E;
  const int id = blockIdx.x * kThreads + threadIdx.x;
  if (id >= chunk * per_row) return;
  const int i = id / per_row, col = (id % per_row) * E;
  auto src = [&](int c) {
    return v + static_cast<size_t>(starts[c] + rel[c * chunk + i]) * L + col;
  };
  float acc[E] = {};
  for (int r = 0; r < rounds; ++r) {
    int c = 0;
    for (; c + U <= n_chunks; c += U) {
      uint4 x[U];
#pragma unroll
      for (int u = 0; u < U; ++u) x[u] = ld16(src(c + u));
#pragma unroll
      for (int u = 0; u < U; ++u) add16(acc, x[u]);
    }
    for (; c < n_chunks; ++c) add16(acc, ld16(src(c)));
  }
  float4* o = reinterpret_cast<float4*>(out + static_cast<size_t>(i) * L + col);
#pragma unroll
  for (int q = 0; q < E / 4; ++q)
    o[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
}

// --- K10 --------------------------------------------------------------------------

// Value routes: 0 bf16 (m16n8k16), 1 f32 (3xTF32, m16n8k8), 2 int8 (s8 m16n8k32).
// kCols: out columns a block (the block keeps its columns of both operands in
// shared memory for every round, about 48 KB at the probe's shape); kRounds:
// rounds a warp runs together, each B fragment it reads serving kRounds
// independent accumulator chains.
template <int R> struct Route;
template <> struct Route<0> {
  using V = bf16;
  static constexpr int kCols = 16, kPad = 8, kRounds = 4;
  static __device__ __forceinline__ V cast(float x) { return __float2bfloat16_rn(x); }
};
template <> struct Route<1> {
  using V = float;
  static constexpr int kCols = 8, kPad = 4, kRounds = 2;
  static __device__ __forceinline__ V cast(float x) { return x; }
};
template <> struct Route<2> {
  using V = int8_t;
  static constexpr int kCols = 16, kPad = 16, kRounds = 4;
  static __device__ __forceinline__ V cast(float x) {  // toward zero, as astype(int8)
    return static_cast<int8_t>(__float2int_rz(x));
  }
};

constexpr int kPairRows = 64;  // out rows a block (16 a warp)

template <int R> __host__ __device__ constexpr int pair_pitch(int k_total) {
  return k_total + Route<R>::kPad;
}
// Bt's bytes, rounded up to 16 (rel follows it)
template <int R> __host__ __device__ size_t pair_bt_bytes(int k_total) {
  return (static_cast<size_t>(Route<R>::kCols) * pair_pitch<R>(k_total) *
              sizeof(typename Route<R>::V) + 15) & ~static_cast<size_t>(15);
}
template <int R> size_t pair_smem(int band, int chunk) {
  return pair_bt_bytes<R>(band + chunk) + static_cast<size_t>(chunk) * sizeof(int);
}

// One round's one-hot rows for this warp's rows b0 = m0 + g and b1 = b0 + 8:
// rt, the gather's column rel_t[b]; q = (b - t) mod band, so that rel_t[i] ==
// b iff rel[i] == q (the scatter's rows).
struct RoundRows { int rt0, rt1, q0, q1; };

// RR rounds' two products for this warp's 16 rows and the block's kCols
// columns, each B fragment read once for all RR rounds; Bt[n][k] holds
// cast(band_v) for k < band and cast(msg) after, K-contiguous.
template <int R> struct PairRound;

template <> struct PairRound<0> {
  using M = Mma<bf16>;
  static constexpr int NT = Route<0>::kCols / 8;
  template <int RR>
  static __device__ __forceinline__ void run(float (&vs)[RR][NT][4], float (&ct)[RR][NT][4],
                                             const bf16* Bt, int pitch, const int* rel_s,
                                             int band, int chunk, const RoundRows (&w)[RR],
                                             int lane) {
    const int t = lane & 3;
    for (int k0 = 0; k0 < band; k0 += 16) {
      M::B b[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) M::load_b_k(b[n], Bt, pitch, n * 8, k0, lane);
      const int k = k0 + 2 * t;
#pragma unroll
      for (int u = 0; u < RR; ++u) {
        M::A a;
        a.r[0] = onehot_pair(w[u].rt0 - k);
        a.r[1] = onehot_pair(w[u].rt1 - k);
        a.r[2] = onehot_pair(w[u].rt0 - k - 8);
        a.r[3] = onehot_pair(w[u].rt1 - k - 8);
#pragma unroll
        for (int n = 0; n < NT; ++n) M::mma(vs[u][n], a, b[n]);
      }
    }
    for (int k0 = 0; k0 < chunk; k0 += 16) {
      M::B b[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) M::load_b_k(b[n], Bt, pitch, n * 8, band + k0, lane);
      const int2 x0 = *reinterpret_cast<const int2*>(rel_s + k0 + 2 * t);
      const int2 x8 = *reinterpret_cast<const int2*>(rel_s + k0 + 2 * t + 8);
#pragma unroll
      for (int u = 0; u < RR; ++u) {
        const int q0 = w[u].q0, q1 = w[u].q1;
        M::A a;
        a.r[0] = (x0.x == q0 ? kOneBf16 : 0u) | (x0.y == q0 ? kOneBf16 << 16 : 0u);
        a.r[1] = (x0.x == q1 ? kOneBf16 : 0u) | (x0.y == q1 ? kOneBf16 << 16 : 0u);
        a.r[2] = (x8.x == q0 ? kOneBf16 : 0u) | (x8.y == q0 ? kOneBf16 << 16 : 0u);
        a.r[3] = (x8.x == q1 ? kOneBf16 : 0u) | (x8.y == q1 ? kOneBf16 << 16 : 0u);
#pragma unroll
        for (int n = 0; n < NT; ++n) M::mma(ct[u][n], a, b[n]);
      }
    }
  }
};

template <> struct PairRound<1> {
  static constexpr int NT = Route<1>::kCols / 8;
  struct Parts { uint32_t hi[2], mid[2], lo[2]; };
  static __device__ __forceinline__ void b_parts(const float* Bt, int pitch, int n, int k0,
                                                 int lane, Parts& p) {
    const int g = lane >> 2, t = lane & 3;
    const float* q = Bt + (n * 8 + g) * pitch + k0 + t;
    split3(q[0], p.hi[0], p.mid[0], p.lo[0]);
    split3(q[4], p.hi[1], p.mid[1], p.lo[1]);
  }
  template <int RR>
  static __device__ __forceinline__ void run(float (&vs)[RR][NT][4], float (&ct)[RR][NT][4],
                                             const float* Bt, int pitch, const int* rel_s,
                                             int band, int chunk, const RoundRows (&w)[RR],
                                             int lane) {
    const int t = lane & 3;
    for (int k0 = 0; k0 < band; k0 += 8) {  // one 1 a row: exact in one accumulator
      Parts p[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) b_parts(Bt, pitch, n, k0, lane, p[n]);
      const int k = k0 + t;
#pragma unroll
      for (int u = 0; u < RR; ++u) {
        const uint32_t a[4] = {k == w[u].rt0 ? kOneF32 : 0u, k == w[u].rt1 ? kOneF32 : 0u,
                               k + 4 == w[u].rt0 ? kOneF32 : 0u,
                               k + 4 == w[u].rt1 ? kOneF32 : 0u};
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          Mma<float>::one(vs[u][n], a, p[n].hi);
          Mma<float>::one(vs[u][n], a, p[n].mid);
          Mma<float>::one(vs[u][n], a, p[n].lo);
        }
      }
    }
    for (int k0 = 0; k0 < chunk; k0 += 8) {
      Parts p[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) b_parts(Bt, pitch, n, band + k0, lane, p[n]);
      const int x0 = rel_s[k0 + t], x4 = rel_s[k0 + t + 4];
#pragma unroll
      for (int u = 0; u < RR; ++u) {
        const int q0 = w[u].q0, q1 = w[u].q1;
        const uint32_t a[4] = {x0 == q0 ? kOneF32 : 0u, x0 == q1 ? kOneF32 : 0u,
                               x4 == q0 ? kOneF32 : 0u, x4 == q1 ? kOneF32 : 0u};
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          float f[4] = {0.f, 0.f, 0.f, 0.f};  // fresh: the K-step's partial, then one FADD
          Mma<float>::one(f, a, p[n].hi);
          Mma<float>::one(f, a, p[n].mid);
          Mma<float>::one(f, a, p[n].lo);
#pragma unroll
          for (int i = 0; i < 4; ++i) ct[u][n][i] += f[i];
        }
      }
    }
  }
};

template <> struct PairRound<2> {
  static constexpr int NT = Route<2>::kCols / 8;
  static __device__ __forceinline__ void b_frag(const int8_t* Bt, int pitch, int n, int k0,
                                                int lane, uint32_t (&b)[2]) {
    const int g = lane >> 2, t = lane & 3;
    const int8_t* p = Bt + (n * 8 + g) * pitch + k0 + 4 * t;
    b[0] = *reinterpret_cast<const uint32_t*>(p);
    b[1] = *reinterpret_cast<const uint32_t*>(p + 16);
  }
  static __device__ __forceinline__ uint32_t quad(int4 x, int q) {
    return (x.x == q ? 1u : 0u) | (x.y == q ? 1u << 8 : 0u) | (x.z == q ? 1u << 16 : 0u) |
           (x.w == q ? 1u << 24 : 0u);
  }
  template <int RR>
  static __device__ __forceinline__ void run(int (&vs)[RR][NT][4], int (&ct)[RR][NT][4],
                                             const int8_t* Bt, int pitch, const int* rel_s,
                                             int band, int chunk, const RoundRows (&w)[RR],
                                             int lane) {
    const int t = lane & 3;
    for (int k0 = 0; k0 < band; k0 += 32) {
      uint32_t b[NT][2];
#pragma unroll
      for (int n = 0; n < NT; ++n) b_frag(Bt, pitch, n, k0, lane, b[n]);
      const int k = k0 + 4 * t;
#pragma unroll
      for (int u = 0; u < RR; ++u) {
        const uint32_t a[4] = {onehot_quad(w[u].rt0 - k), onehot_quad(w[u].rt1 - k),
                               onehot_quad(w[u].rt0 - k - 16), onehot_quad(w[u].rt1 - k - 16)};
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_s8(vs[u][n], a, b[n]);
      }
    }
    for (int k0 = 0; k0 < chunk; k0 += 32) {
      uint32_t b[NT][2];
#pragma unroll
      for (int n = 0; n < NT; ++n) b_frag(Bt, pitch, n, band + k0, lane, b[n]);
      const int4 x0 = *reinterpret_cast<const int4*>(rel_s + k0 + 4 * t);
      const int4 x16 = *reinterpret_cast<const int4*>(rel_s + k0 + 4 * t + 16);
#pragma unroll
      for (int u = 0; u < RR; ++u) {
        const uint32_t a[4] = {quad(x0, w[u].q0), quad(x0, w[u].q1), quad(x16, w[u].q0),
                               quad(x16, w[u].q1)};
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_s8(ct[u][n], a, b[n]);
      }
    }
  }
};

// Rounds r .. r + RR - 1 of one warp, added to o in round order.
template <int R, int RR>
__device__ __forceinline__ void pair_rounds(float (&o)[Route<R>::kCols / 8][4], int r,
                                            const typename Route<R>::V* Bt, int pitch,
                                            const int* rel_s, int band, int chunk, int b0,
                                            int lane) {
  using Acc = typename std::conditional<R == 2, int, float>::type;
  constexpr int NT = Route<R>::kCols / 8;
  const int b1 = b0 + 8;
  RoundRows w[RR];
#pragma unroll
  for (int u = 0; u < RR; ++u) {
    const int tm = (r + u) % band;
    w[u].rt0 = rel_s[b0] + tm;
    w[u].rt1 = rel_s[b1] + tm;
    w[u].rt0 -= w[u].rt0 >= band ? band : 0;
    w[u].rt1 -= w[u].rt1 >= band ? band : 0;
    w[u].q0 = b0 >= tm ? b0 - tm : b0 - tm + band;
    w[u].q1 = b1 >= tm ? b1 - tm : b1 - tm + band;
  }
  Acc vs[RR][NT][4] = {}, ct[RR][NT][4] = {};
  PairRound<R>::template run<RR>(vs, ct, Bt, pitch, rel_s, band, chunk, w, lane);
#pragma unroll
  for (int u = 0; u < RR; ++u)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        o[n][i] += static_cast<float>(vs[u][n][i]) + static_cast<float>(ct[u][n][i]);
}

template <int R>
__global__ void __launch_bounds__(kThreads)
    onehot_pair_kernel(const int* __restrict__ rel, const float* __restrict__ band_v,
                       const float* __restrict__ msg, float* __restrict__ out, int L, int band,
                       int chunk, int rounds) {
  using Rt = Route<R>;
  using V = typename Rt::V;
  constexpr int NT = Rt::kCols / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int k_total = band + chunk, pitch = pair_pitch<R>(k_total);
  V* Bt = reinterpret_cast<V*>(smem);
  int* rel_s = reinterpret_cast<int*>(smem + pair_bt_bytes<R>(k_total));
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.y * Rt::kCols;
  // the block's columns of cast(band_v) and cast(msg), once, K-contiguous
  for (int idx = tid; idx < k_total * Rt::kCols; idx += kThreads) {
    const int k = idx / Rt::kCols, n = idx % Rt::kCols;
    const float x = k < band ? band_v[static_cast<size_t>(k) * L + n0 + n]
                             : msg[static_cast<size_t>(k - band) * L + n0 + n];
    Bt[n * pitch + k] = Rt::cast(x);
  }
  for (int i = tid; i < chunk; i += kThreads) rel_s[i] = rel[i];
  __syncthreads();
  const int m0 = blockIdx.x * kPairRows + (tid >> 5) * 16;
  if (m0 >= band) return;  // a warp past the last row (band % 64 == 32)
  const int b0 = m0 + g, b1 = b0 + 8;
  float o[NT][4] = {};
  int r = 0;
  for (; r + Rt::kRounds <= rounds; r += Rt::kRounds)
    pair_rounds<R, Rt::kRounds>(o, r, Bt, pitch, rel_s, band, chunk, b0, lane);
  for (; r < rounds; ++r) pair_rounds<R, 1>(o, r, Bt, pitch, rel_s, band, chunk, b0, lane);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n0 + n * 8 + 2 * t;
    *reinterpret_cast<float2*>(out + static_cast<size_t>(b0) * L + col) =
        make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(out + static_cast<size_t>(b1) * L + col) =
        make_float2(o[n][2], o[n][3]);
  }
}

// --- launches --------------------------------------------------------------------

template <typename T>
int launch_window(int variant, const void* v, const int* rel, const int* starts, float* out,
                  int L, int chunk, int band, int n_chunks, int rounds, cudaStream_t s) {
  const T* vt = static_cast<const T*>(v);
  if (variant == 0) {
    if (band % kSlice != 0 || L % kWinCols != 0) return cudaErrorInvalidValue;
    const cudaError_t rc = cudaFuncSetAttribute(
        window_onehot_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(win_smem<T>()));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    const dim3 grid((chunk + kWinRows - 1) / kWinRows, L / kWinCols);
    window_onehot_kernel<T><<<grid, kThreads, win_smem<T>(), s>>>(vt, rel, starts, out, L,
                                                                  chunk, band, n_chunks, rounds);
  } else {
    constexpr int E = 16 / sizeof(T);
    if (L % E != 0) return cudaErrorInvalidValue;
    const long long threads = static_cast<long long>(chunk) * (L / E);
    const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads));
    window_direct_kernel<T><<<grid, kThreads, 0, s>>>(vt, rel, starts, out, L, chunk, n_chunks,
                                                      rounds);
  }
  return 0;
}

template <int R>
int launch_pair(const int* rel, const float* band_v, const float* msg, float* out, int L,
                int band, int chunk, int rounds, cudaStream_t s) {
  if (band % 32 != 0 || chunk % 32 != 0 || L % Route<R>::kCols != 0)
    return cudaErrorInvalidValue;
  const size_t smem = pair_smem<R>(band, chunk);
  const cudaError_t rc = cudaFuncSetAttribute(
      onehot_pair_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((band + kPairRows - 1) / kPairRows, L / Route<R>::kCols);
  onehot_pair_kernel<R><<<grid, kThreads, smem, s>>>(rel, band_v, msg, out, L, band, chunk,
                                                     rounds);
  return 0;
}

int finish(int rc) { return rc != 0 ? rc : static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" {

// K9: out (chunk, L) f32 = sum over rounds and chunks of f32(v[starts[c] +
// rel[c, i]]).  dtype: 0 = float32, 1 = bfloat16 (v); variant: 0 = onehot,
// 1 = direct.  rel (n_chunks, chunk) and starts (n_chunks,) int32; the
// caller has checked 0 <= rel < band and starts[c] + band <= rows of v.
// onehot needs band % 64 == 0 and L % 16 == 0.  Returns cudaGetLastError()
// after the launch (0 on success).
int mgn_window_gather(int dtype, int variant, const void* v, const int* rel, const int* starts,
                      float* out, int latent, int chunk, int band, int n_chunks, int rounds,
                      void* stream) {
  if (chunk <= 0 || band <= 0 || n_chunks <= 0 || rounds <= 0 || latent <= 0 ||
      (variant != 0 && variant != 1) || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return finish(dtype == 0 ? launch_window<float>(variant, v, rel, starts, out, latent, chunk,
                                                  band, n_chunks, rounds, s)
                           : launch_window<bf16>(variant, v, rel, starts, out, latent, chunk,
                                                 band, n_chunks, rounds, s));
}

// K10: out (band, L) f32 = sum over rounds of the one-hot gather of band_v's
// rows rel_t[:band] plus the one-hot scatter of msg's rows onto rel_t,
// rel_t = (rel + t) mod band, values cast to the route's type.  route: 0 =
// bf16, 1 = f32 (3xTF32), 2 = int8.  rel (chunk,) int32 with 0 <= rel <
// band <= chunk; band_v (band, L) and msg (chunk, L) f32.  band and chunk
// must be multiples of 32 and L of the route's 16 (8 for f32) columns;
// a launch whose shared memory (the block's columns of both, cast, and rel)
// exceeds the card's is refused and its error returned.
int mgn_onehot_pair(int route, const int* rel, const float* band_v, const float* msg,
                    float* out, int latent, int band, int chunk, int rounds, void* stream) {
  if (band <= 0 || chunk < band || rounds <= 0 || latent <= 0 || route < 0 || route > 2)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int L = latent;
  if (route == 0) return finish(launch_pair<0>(rel, band_v, msg, out, L, band, chunk, rounds, s));
  if (route == 1) return finish(launch_pair<1>(rel, band_v, msg, out, L, band, chunk, rounds, s));
  return finish(launch_pair<2>(rel, band_v, msg, out, L, band, chunk, rounds, s));
}

const char* mgn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
