// Tensor-core building blocks of K2/K4 (the 64-edge tile, edge_tile.cuh),
// K3 (node_round) and K6 (wgrad): warp matrix products through mma.sync
// with fragments read from shared memory, warpgroup products through wgmma
// (the edge tile's f32 path), and cp.async and bulk copies into shared
// memory.
//
// mma.sync routes, by compute dtype T (K3, K6, and the edge tile in bf16):
// - bf16: mma.sync.m16n8k16 with bf16 operands and f32 accumulators.  A
//   bf16 x bf16 product is exact in f32, so a sum differs from an FFMA sum
//   only in its order.
// - f32: 3xTF32 on mma.sync.m16n8k8.  Each operand is split into a TF32 high
//   part and a TF32 remainder, hi = rna(x), lo = rna(x - hi), and the product
//   is accumulated as lo*hi + hi*lo + hi*hi in f32 (lo*lo, ~2^-22 relative,
//   is dropped), per K-step in a fresh accumulator that is then added to the
//   running sum in round-to-nearest f32 (see Mma<float>::mma).  That keeps
//   f32 accuracy at three times the TF32 work; one TF32 pass keeps only
//   about 11 bits.
//
// Fragment layouts are the PTX ISA's for these shapes (lane = 4 g + t):
//   A (16 x K):  rows g and g+8; columns t, t+4 (tf32) or 2t..2t+1, 2t+8..2t+9 (bf16)
//   B (K x 8):   column g; rows t, t+4 (tf32) or 2t..2t+1, 2t+8..2t+9 (bf16)
//   C (16 x 8):  c[0], c[1] at row g, columns 2t, 2t+1; c[2], c[3] at row g+8
// Each loader reads a fragment from shared memory in one of two layouts, so
// a caller names which of its operands is contiguous along K (only the
// loaders some kernel uses exist).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace mgn {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled where !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Bulk copies (the copy engine TMA drives, here without a tensor map): one
// thread moves a contiguous, 16-byte aligned block global -> shared, and
// the block's arrival completes a shared-memory mbarrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// The mbarrier's one arrival of a phase, which also expects `bytes` of
// copies to complete it.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// One copy towards the bytes a phase expects (any thread may issue it).
__device__ __forceinline__ void bulk_copy_tx(void* dst, const void* src, uint32_t bytes,
                                             uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  mbar_expect_tx(bar, bytes);
  bulk_copy_tx(dst, src, bytes, bar);
}
// Waits until the mbarrier's phase `parity` (0, 1, 0, ... per use) completes.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

template <typename T> struct Mma;

// f32 through 3xTF32, K = 8 per instruction.
template <> struct Mma<float> {
  static constexpr int K = 8;
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t hi[2], lo[2]; };

  // A[m][k] = s[(m0 + m) * pitch + k0 + k]  (K contiguous)
  static __device__ __forceinline__ void load_a_k(A& a, const float* s, int pitch, int m0,
                                                  int k0, int lane) {
    const int g = lane >> 2, t = lane & 3;
    const float* p = s + (m0 + g) * pitch + k0 + t;
    split_tf32(p[0], a.hi[0], a.lo[0]);
    split_tf32(p[8 * pitch], a.hi[1], a.lo[1]);
    split_tf32(p[4], a.hi[2], a.lo[2]);
    split_tf32(p[8 * pitch + 4], a.hi[3], a.lo[3]);
  }
  // A[m][k] = s[(k0 + k) * pitch + m0 + m]  (M contiguous)
  static __device__ __forceinline__ void load_a_m(A& a, const float* s, int pitch, int m0,
                                                  int k0, int lane) {
    const int g = lane >> 2, t = lane & 3;
    const float* p = s + (k0 + t) * pitch + m0 + g;
    split_tf32(p[0], a.hi[0], a.lo[0]);
    split_tf32(p[8], a.hi[1], a.lo[1]);
    split_tf32(p[4 * pitch], a.hi[2], a.lo[2]);
    split_tf32(p[4 * pitch + 8], a.hi[3], a.lo[3]);
  }
  // B[k][n] = s[(k0 + k) * pitch + n0 + n]  (N contiguous)
  static __device__ __forceinline__ void load_b_n(B& b, const float* s, int pitch, int n0,
                                                  int k0, int lane) {
    const int g = lane >> 2, t = lane & 3;
    const float* p = s + (k0 + t) * pitch + n0 + g;
    split_tf32(p[0], b.hi[0], b.lo[0]);
    split_tf32(p[4 * pitch], b.hi[1], b.lo[1]);
  }

  static __device__ __forceinline__ void one(float (&c)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  // The tensor cores add into their accumulator with truncation, not
  // round-to-nearest, so a long sum kept in one MMA accumulator drifts by up
  // to an ulp per instruction (measured: 2.6e-6 relative over a 384-deep
  // product).  So the three products of one K-step go to a fresh
  // accumulator, whose truncation is relative to an 8-term partial, and
  // that partial is added to c by an ordinary (round-to-nearest) FADD.
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a, const B& b) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    one(t, a.lo, b.hi);
    one(t, a.hi, b.lo);
    one(t, a.hi, b.hi);
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] += t[i];
  }
};

// bf16, K = 16 per instruction.
template <> struct Mma<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int K = 16;
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };

  static __device__ __forceinline__ uint32_t pair_k(const T* p) {  // p[0], p[1]
    return *reinterpret_cast<const uint32_t*>(p);
  }
  static __device__ __forceinline__ uint32_t pair_strided(const T* p, int stride) {
    return pack_bf16(p[0], p[stride]);
  }

  static __device__ __forceinline__ void load_a_k(A& a, const T* s, int pitch, int m0, int k0,
                                                  int lane) {
    const int g = lane >> 2, t = lane & 3;
    const T* p = s + (m0 + g) * pitch + k0 + 2 * t;
    a.r[0] = pair_k(p);
    a.r[1] = pair_k(p + 8 * pitch);
    a.r[2] = pair_k(p + 8);
    a.r[3] = pair_k(p + 8 * pitch + 8);
  }
  static __device__ __forceinline__ void load_a_m(A& a, const T* s, int pitch, int m0, int k0,
                                                  int lane) {
    const int g = lane >> 2, t = lane & 3;
    const T* p = s + (k0 + 2 * t) * pitch + m0 + g;
    a.r[0] = pair_strided(p, pitch);
    a.r[1] = pair_strided(p + 8, pitch);
    a.r[2] = pair_strided(p + 8 * pitch, pitch);
    a.r[3] = pair_strided(p + 8 * pitch + 8, pitch);
  }
  static __device__ __forceinline__ void load_b_k(B& b, const T* s, int pitch, int n0, int k0,
                                                  int lane) {
    const int g = lane >> 2, t = lane & 3;
    const T* p = s + (n0 + g) * pitch + k0 + 2 * t;
    b.r[0] = pair_k(p);
    b.r[1] = pair_k(p + 8);
  }
  static __device__ __forceinline__ void load_b_n(B& b, const T* s, int pitch, int n0, int k0,
                                                  int lane) {
    const int g = lane >> 2, t = lane & 3;
    const T* p = s + (k0 + 2 * t) * pitch + n0 + g;
    b.r[0] = pair_strided(p, pitch);
    b.r[1] = pair_strided(p + 8 * pitch, pitch);
  }

  // The same as load_b_n for the two 8-column tiles n0 and n0 + 8 (b0, b1),
  // by one ldmatrix .trans of the four 8 x 8 blocks (rows 16-byte aligned).
  static __device__ __forceinline__ void ldsm_b_n(B& b0, B& b1, const T* s, int pitch, int n0,
                                                  int k0, int lane) {
    const int m = lane >> 3;
    const T* p = s + (k0 + (m & 1) * 8 + (lane & 7)) * pitch + n0 + (m >> 1) * 8;
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(b0.r[0]), "=r"(b0.r[1]), "=r"(b1.r[0]), "=r"(b1.r[1])
                 : "r"(smem_addr(p))
                 : "memory");
  }
  // One 8-column tile (lanes 0-15 give the addresses).
  static __device__ __forceinline__ void ldsm_b_n(B& b0, const T* s, int pitch, int n0, int k0,
                                                  int lane) {
    const T* p = s + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * pitch + n0;
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(b0.r[0]), "=r"(b0.r[1])
                 : "r"(smem_addr(p))
                 : "memory");
  }

  static __device__ __forceinline__ void mma(float (&c)[4], const A& a, const B& b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]), "r"(b.r[1]));
  }
};

// --- wgmma (K4's f32 products) ---------------------------------------------
//
// Hopper's warpgroup MMA at the full TF32 rate: four warps together multiply
// a 64-row A held in registers (each warp its 16 rows, in the m16n8k8 A
// fragment layout above) by an N x 8 K-major B read from shared memory
// through a matrix descriptor, accumulating 64 x N in registers (each warp
// its 16 rows, in the m16n8 C layout above, one 4-float group per 8
// columns).  B is laid out in "core matrices" of 8 rows x 16 bytes, no
// swizzle: core matrix (n / 8, k / 4) of a KC-deep chunk at
// ((n / 8) * (KC / 4) + k / 4) * 128 bytes (tf32_core_offset), so
// neighbours along K are 128 bytes apart (the descriptor's leading byte
// offset) and along N KC * 32 bytes apart (its stride byte offset).

__device__ __forceinline__ int tf32_core_offset(int n, int k, int kc) {
  return ((n >> 3) * (kc >> 2) + (k >> 2)) * 32 + (n & 7) * 4 + (k & 3);
}

__device__ __forceinline__ uint64_t wgmma_desc(const void* smem, int lbo_bytes, int sbo_bytes) {
  const uint64_t a = smem_addr(smem);
  return ((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(sbo_bytes >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (+)= A . B for one m64nNk8 TF32 step; scale_d 0 overwrites d.
template <int N> struct WgmmaTf32;
template <> struct WgmmaTf32<32> {
  static __device__ __forceinline__ void run(float (&d)[4][4], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <> struct WgmmaTf32<64> {
  static __device__ __forceinline__ void run(float (&d)[8][4], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <> struct WgmmaTf32<128> {
  static __device__ __forceinline__ void run(float (&d)[16][4], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

// Row padding (elements) of a K-contiguous operand in shared memory: with
// row lengths that are multiples of 32, the 32 lanes of load_a_k / load_b_k
// then hit 32 different banks (rows 4 words apart).
template <typename T> __host__ __device__ constexpr int smem_pad_k() { return sizeof(T) == 4 ? 4 : 8; }
// The same for an M- or N-contiguous operand (load_a_m / load_b_n): rows 8
// words apart.
template <typename T> __host__ __device__ constexpr int smem_pad_mn() { return sizeof(T) == 4 ? 8 : 16; }

}  // namespace mgn
