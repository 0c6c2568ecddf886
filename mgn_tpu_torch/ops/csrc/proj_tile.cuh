// The projection tile shared by K7 (edge_project, fused_round.cu) and K8
// (first_layer_adjoint, fused_round_bwd.cu): one lone product
//
//   acc = A . B        (A: a block's BM rows of kParts L-wide inputs;
//                       B: an L x CN column slice of one (L, L) weight block)
//
// on the tensor cores, with f32 accumulators.  Neither kernel has a layer
// that reads a whole row, so a block owns a column slice of the output, not
// whole rows (the 16-node tile of node_tile.cuh, which K3's LayerNorm needs,
// streamed every weight block whole into every block):
// - Each block reads only its B slice, and once.  The projection stream
//   (weight_streams_kernel, stream_tile.cuh) holds every (product, slice)
//   as one contiguous L x PB image (rows of CN values, zero-padded to PB),
//   so the block's B arrives as kChunks bulk copies (cp.async.bulk) of KC
//   rows, all issued at the start, each completing its own mbarrier: the
//   product waits on chunk c only, and nothing is reused, so no barrier
//   frees a stage.  Even at L = 256 every slice fits (K8 f32: 213 KB).
// - A (the block's rows, zeros past the last one) is staged once with
//   cp.async while B streams.
// - Warps own 16 rows x 32 columns (NI = 4 fragments of 8 columns) of one
//   product: K7's 64-row tile runs 8 warps; K8's 32-row tile 8 too, four a
//   product, whose two accumulators meet in shared memory at the end
//   (sum_parts).  One block an SM at the cylinder, so the warps' chains of
//   dependent products set the pace: the f32 route interleaves 4 K-steps.
//
// The bits are those of NodeBlock::product (the tile K7 and K8 ran before):
// the tiling changes where an output element is computed, not the sequence
// of tensor-core instructions that makes it.
// - f32 x f32: per 8-deep K-step in K order, a fresh accumulator takes
//   lo*hi + hi*lo + hi*hi on mma.sync m16n8k8 TF32 (both operands split as
//   they are read, split_tf32) and is added to acc in round-to-nearest.
// - bf16 x bf16 (K7 in bf16): mma.sync m16n8k16 into acc from zero, in K
//   order.
// - f32 A x bf16 B (K8 in bf16: G is never rounded to bf16, and a bf16
//   weight is exactly a TF32 value): per 8-deep K-step a fresh accumulator
//   takes lo*b + hi*b, A split as hi = rna(a), lo = rna(a - hi), added to
//   acc in round-to-nearest.
#pragma once

#include "edge_tile.cuh"

namespace mgn {

// The projection stream's layout at latent L (ops/fused.py _PROJ_COLS,
// _PROJ_PAD): per product, L / CN column slices, each an L x PB image.
template <typename T, int L>
struct ProjLayout {
  static constexpr int CN = L < 64 ? L : 64;  // output columns a block owns
  static constexpr int kSlices = L / CN;
  // image row pitch: 8 words apart for load_b_n, rows 16-byte aligned and
  // 16 bytes apart in bank for ldmatrix
  static constexpr int PB = CN + 8;
  static constexpr int kImage = L * PB;  // values of one (product, slice) image
  static constexpr int KC = 32;          // image rows a bulk copy brings
  static constexpr int kChunks = L / KC;
  static constexpr uint32_t kChunkBytes = uint32_t(KC) * PB * sizeof(T);
};

// Shapes of a block: B in T, kParts products each against its own L
// columns of A (TA: T, or f32 for K8), BM rows; each product has its own
// warps.
template <typename T, typename TA, int L, int BM, int kParts>
struct ProjTile : ProjLayout<T, L> {
  using Lay = ProjLayout<T, L>;
  static constexpr int kRows = BM;
  static constexpr int NI = 4;  // 8-column MMA tiles a warp: 32 columns
  static constexpr int kWarpsN = Lay::CN / 32;
  static constexpr int kWarpsPart = (BM / 16) * kWarpsN;  // a product's warps
  static constexpr int kWarps = kParts * kWarpsPart;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int PA = kParts * L + smem_pad_k<TA>();  // A row pitch
  static constexpr int PX = Lay::CN + 8;  // sum_parts' f32 rows: conflict-free 8-byte stores
  static constexpr int kBars = kParts * Lay::kChunks;
  static constexpr size_t kBarBytes = 16 * sizeof(uint64_t);
  static constexpr size_t kB = size_t(kParts) * Lay::kImage * sizeof(T);
  static constexpr size_t kA = size_t(BM) * PA * sizeof(TA);
  static constexpr size_t kX = kParts > 1 ? size_t(BM) * PX * sizeof(float) : 0;
  static constexpr size_t kSmem = kBarBytes + kB + kA + kX;
  static_assert(kBars <= 16, "one mbarrier a chunk");
  static_assert(kSmem <= 232448, "a block's shared memory");
};

// One block: its barriers, B slices, A rows and (kParts > 1) the rows
// sum_parts exchanges in shared memory, and its warp's place; the block's
// rows start at blockIdx.x * BM.
template <typename T, typename TA, int L, int BM, int kParts>
struct ProjBlock {
  using C = ProjTile<T, TA, L, BM, kParts>;
  static constexpr int NI = C::NI, KC = C::KC, PB = C::PB;
  static constexpr int KI = 4;  // K-steps interleaved by the routes on 8-deep steps
  static_assert(KC % (8 * KI) == 0, "a chunk holds whole groups of KI K-steps");
  uint64_t* bar;
  T* B;
  TA* A;
  float* X;
  int tid, lane, g, t, part, m0, nb, row0;

  __device__ __forceinline__ explicit ProjBlock(unsigned char* smem) {
    bar = reinterpret_cast<uint64_t*>(smem);
    B = reinterpret_cast<T*>(smem + C::kBarBytes);
    A = reinterpret_cast<TA*>(smem + C::kBarBytes + C::kB);
    X = reinterpret_cast<float*>(smem + C::kBarBytes + C::kB + C::kA);
    tid = threadIdx.x;
    lane = tid % 32;
    g = lane >> 2;
    t = lane & 3;
    const int warp = tid / 32, w = warp % C::kWarpsPart;
    part = warp / C::kWarpsPart;  // the warp's product
    m0 = (w / C::kWarpsN) * 16;   // its first row in the tile
    nb = (w % C::kWarpsN) * 32;   // its first column in the slice
    row0 = blockIdx.x * C::kRows;
  }

  // Starts the copies of every part's B image (src[p], in the stream),
  // kChunks bulk copies each, one mbarrier a chunk; publishes the barriers'
  // initialisation first.
  __device__ __forceinline__ void issue(const T* const (&src)[kParts]) {
    if (tid < C::kBars) mbar_init(&bar[tid]);
    __syncthreads();
    if (tid == 0) {
#pragma unroll
      for (int p = 0; p < kParts; ++p)
#pragma unroll 1
        for (int c = 0; c < C::kChunks; ++c)
          bulk_copy(B + p * C::kImage + c * KC * PB, src[p] + c * KC * PB, C::kChunkBytes,
                    &bar[p * C::kChunks + c]);
    }
  }

  // A's rows [row0, row0 + BM) = [x[0] | x[1] ...] (each n_rows x L),
  // zeros past the last row, by cp.async; waits and synchronises.
  __device__ __forceinline__ void stage(const TA* const (&x)[kParts], int n_rows) {
    constexpr int V = 16 / int(sizeof(TA)), RG = kParts * L / V;
#pragma unroll 1
    for (int i = tid; i < C::kRows * RG; i += C::kThreads) {
      const int r = i / RG, c = (i % RG) * V, row = row0 + r;
      const bool ok = row < n_rows;
      cp_async16(A + r * C::PA + c, x[c / L] + static_cast<size_t>(ok ? row : 0) * L + c % L, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }

  __device__ __forceinline__ void clear(float (&acc)[NI][4]) {
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;
  }

  // acc += A[:, part L .. (part + 1) L) . B[part] on the warp's 16 x 32
  // tile of its product, chunk by chunk as the copies land.
  __device__ __forceinline__ void product(float (&acc)[NI][4]) {
    const T* img = B + part * C::kImage;
#pragma unroll 1
    for (int c = 0; c < C::kChunks; ++c) {
      mbar_wait(&bar[part * C::kChunks + c], 0);
      const T* Bs = img + c * KC * PB;
      const int k_a = part * L + c * KC;  // the chunk's first column of A
      if constexpr (sizeof(T) == 4) {
        // f32: KI K-steps' products interleaved (independent accumulators),
        // each K-step's partial added to acc in K order.  B is split as it
        // is read (by each of the tile's row warps): on an H100 80GB HBM3
        // at 700 W, a stream pre-split into TF32 planes would save about 1
        // us of K7's 6.2 (f32, cylinder) for twice the bytes copied, where
        // launch, copies and staging alone take 2.9 us
        using M = Mma<float>;
#pragma unroll
        for (int k0 = 0; k0 < KC; k0 += 8 * KI) {
          typename M::A a[KI];
          typename M::B bf[KI][NI];
          float tt[KI][NI][4];
#pragma unroll
          for (int s = 0; s < KI; ++s) {
            M::load_a_k(a[s], A, C::PA, m0, k_a + k0 + 8 * s, lane);
#pragma unroll
            for (int j = 0; j < NI; ++j) {
              M::load_b_n(bf[s][j], Bs, PB, nb + j * 8, k0 + 8 * s, lane);
#pragma unroll
              for (int k = 0; k < 4; ++k) tt[s][j][k] = 0.f;
            }
          }
#pragma unroll
          for (int s = 0; s < KI; ++s)
#pragma unroll
            for (int j = 0; j < NI; ++j) M::one(tt[s][j], a[s].lo, bf[s][j].hi);
#pragma unroll
          for (int s = 0; s < KI; ++s)
#pragma unroll
            for (int j = 0; j < NI; ++j) M::one(tt[s][j], a[s].hi, bf[s][j].lo);
#pragma unroll
          for (int s = 0; s < KI; ++s)
#pragma unroll
            for (int j = 0; j < NI; ++j) M::one(tt[s][j], a[s].hi, bf[s][j].hi);
#pragma unroll
          for (int s = 0; s < KI; ++s)
#pragma unroll
            for (int j = 0; j < NI; ++j)
#pragma unroll
              for (int k = 0; k < 4; ++k) acc[j][k] += tt[s][j][k];
        }
      } else if constexpr (sizeof(TA) == 2) {
        // bf16 x bf16
        using M = Mma<T>;
#pragma unroll
        for (int kk = 0; kk < KC; kk += M::K) {
          typename M::A a;
          M::load_a_k(a, A, C::PA, m0, k_a + kk, lane);
          typename M::B bf[NI];
#pragma unroll
          for (int j = 0; j < NI; j += 2)
            M::ldsm_b_n(bf[j], bf[j + 1], Bs, PB, nb + j * 8, kk, lane);
#pragma unroll
          for (int j = 0; j < NI; ++j) M::mma(acc[j], a, bf[j]);
        }
      } else {
        // f32 A x bf16 B, KI K-steps interleaved as above: B[k][n] =
        // Bs[k * PB + n], rows t and t + 4 of column g, exact in TF32
        using MF = Mma<float>;
#pragma unroll
        for (int k0 = 0; k0 < KC; k0 += 8 * KI) {
          typename MF::A a[KI];
          uint32_t bf[KI][NI][2];
          float tt[KI][NI][4];
#pragma unroll
          for (int s = 0; s < KI; ++s) {
            MF::load_a_k(a[s], A, C::PA, m0, k_a + k0 + 8 * s, lane);
#pragma unroll
            for (int j = 0; j < NI; ++j) {
              const T* p = Bs + (k0 + 8 * s + t) * PB + nb + j * 8 + g;
              bf[s][j][0] = __float_as_uint(to_f<T>(p[0]));
              bf[s][j][1] = __float_as_uint(to_f<T>(p[4 * PB]));
#pragma unroll
              for (int k = 0; k < 4; ++k) tt[s][j][k] = 0.f;
            }
          }
#pragma unroll
          for (int s = 0; s < KI; ++s)
#pragma unroll
            for (int j = 0; j < NI; ++j) MF::one(tt[s][j], a[s].lo, bf[s][j]);
#pragma unroll
          for (int s = 0; s < KI; ++s)
#pragma unroll
            for (int j = 0; j < NI; ++j) MF::one(tt[s][j], a[s].hi, bf[s][j]);
#pragma unroll
          for (int s = 0; s < KI; ++s)
#pragma unroll
            for (int j = 0; j < NI; ++j)
#pragma unroll
              for (int k = 0; k < 4; ++k) acc[j][k] += tt[s][j][k];
        }
      }
    }
  }

  // kParts = 2: the warps of product 0 end with acc = their acc + product
  // 1's accumulator at the same place (f32 addition commutes, so this is
  // acc0 + acc1 to the bit); the others' acc is left as it was.  Every
  // thread of the block calls it.
  __device__ __forceinline__ void sum_parts(float (&acc)[NI][4]) {
    static_assert(kParts == 2, "two products a block");
    float* x = X + (m0 + g) * C::PX + nb + 2 * t;
    if (part == 1) {
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          Pair<float>::store(x + 8 * h * C::PX + j * 8, acc[j][2 * h], acc[j][2 * h + 1]);
    }
    __syncthreads();
    if (part == 0) {
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float a, b;
          Pair<float>::load(x + 8 * h * C::PX + j * 8, a, b);
          acc[j][2 * h] += a;
          acc[j][2 * h + 1] += b;
        }
    }
  }
};

}  // namespace mgn
