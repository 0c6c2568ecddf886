// weight_streams_kernel: the layout of every weight stream of a
// fused_process call, in one launch (launched by fused_round.cu).  It
// replaces no TPU kernel: the TPU kernels read their weights from VMEM as
// they are, while K2, K3 and K7 (and K4, K5 and K8 where a gradient is
// needed) copy theirs into shared memory as whole ring-stage images with
// bulk copies, so each stage's image must lie in device memory already
// laid out (edge_tile.cuh's stage_nk, node_tile.cuh's PW rows,
// proj_tile.cuh's ProjLayout).  The streams are made once a call and never
// cached: training changes the weights at every step.
//
// Bound on this card: bytes.  It does no arithmetic but the TF32 split of
// f32 edge chunks, so its least time is every stream written once plus the
// cast weights read once, at 3.35 TB/s (ops/fused.py _stream_sizes counts
// the streams): at the cylinder (L 128, 3 layers a MLP, 15 rounds) 12.29 MB
// written and 8.85 MB read in f32 serving (6.3 us), 4.85 and 4.42 MB in bf16
// (2.8 us), 24.58 and 8.85 MB for a gradient in the defer_first form (10.0
// us).
//
// Design: a block owns one tile of one (L, L) weight block of one round
// (StreamTile: 32 x 32 in f32, 64 x 64 in bf16): the edge MLP's W0 e, s
// and r row blocks and hidden layers, the node MLP's W0 v and agg row
// blocks and hidden layers (2,160 blocks at the cylinder in f32, 540 in
// bf16).  It reads its tile from device memory once,
// as 16-byte loads into shared memory, and writes from there every image
// the tile feeds, as 16-byte stores, pad columns as zeros in the same
// vectors:
// - W0's e block and every hidden layer of the edge MLP: K2's chunks
//   (B = W) and, with a gradient, K4's (B = W^T);
// - W0's s and r blocks: K7's images (B = W), and with a gradient K8's (B =
//   W^T) and, unless the backward takes the defer_first form, K4's (B =
//   W^T), the last two products of a round's edge stream, so that the
//   defer form's stream is the full one with them cut off;
// - the node MLP's blocks: K3's rows (B = W) and, with a gradient, K5's (B
//   = W^T).
// Every image is rows of a matrix M (W or W^T), each row a slice of CW
// columns zero-padded by 8 (row_image: K3's and K5's rows, CW = L; K7's
// and K8's images, CW = 64; the bf16 edge chunks, M = B^T, CW = KC), except
// the f32 edge chunks: TF32 high and low planes in wgmma's core-matrix
// order (edge_image_f32; the same split_tf32 the tiles run).  A warp's
// stores cover whole 32-byte sectors: 128 bytes a core matrix, 64 or more
// bytes of a row.  Where a store vector is a column of the tile (M = W^T,
// or B = W in a core-matrix chunk), the warp reads across the tile's
// columns: the tile's 16-byte vectors are XOR-swizzled by row (swz), so
// those reads, the row reads and the tile's own writes meet no bank
// conflict at L >= 64: a tile row is a multiple of 32 banks, and the
// swizzle spreads what a pass reads (tests/test_torch_weight_streams.py
// models every access).  Index math is 32-bit over compile-time shapes; a round's base
// is one 64-bit product.
#pragma once

#include <type_traits>

#include "node_tile.cuh"
#include "proj_tile.cuh"

namespace mgn {

// What a launch lays out: the forward products alone, or with a gradient
// K4's, K5's and K8's adjoint products too, in the full form or in the
// defer_first form (K4's products of W0's s and r blocks left out).
enum StreamForm : int { kStreamServing = 0, kStreamAdjoint = 1, kStreamDefer = 2 };

// The tile of a block: f32 32 x 32 with 256 threads, bf16 64 x 64 with 512
// (4 KB and 8 KB; at L = 32 the whole block).  Measured on the card
// (chip_smoke.py --ws-time, PERF.md §6): 32-wide f32 tiles, four
// times the blocks in about two waves, ran the training form faster than
// 64-wide ones and fill the card at one round (the cloth trainer's call),
// where 64-wide tiles lost to the one-thread-an-element kernel before this
// one; 32-wide bf16 tiles were slower in every form.
template <typename T_, int L_>
struct StreamTile {
  using T = T_;
  static constexpr int L = L_;
  using Bits = std::conditional_t<sizeof(T) == 4, uint32_t, uint16_t>;
  static constexpr int kSide = sizeof(T) == 4 ? 32 : 64;
  static constexpr int kT = L < kSide ? L : kSide;  // tile side
  static constexpr int kTiles = L / kT;             // tiles along a side of an (L, L) block
  static constexpr int E = 16 / int(sizeof(T));     // values a 16-byte vector
  static constexpr int kVecs = kT / E;              // vectors a tile row
  static constexpr int kThreads = sizeof(T) == 4 ? 256 : 512;
  static constexpr int kSwz = (kVecs < 8 ? kVecs : 8) - 1;

  // Row r's vectors are stored XOR-swizzled: 8 consecutive rows (from a
  // multiple of 8) take 8 different swizzles, and so do rows r, r + 4,
  // r + 8, r + 12 (f32) or r, r + 8, r + 16, r + 24 (bf16) in their upper
  // two bits.
  static __device__ __forceinline__ int swz(int r) { return (r ^ ((r >> 3) << 1)) & kSwz; }
  // Where tile element (r, c) lies in shared memory.
  static __device__ __forceinline__ int at(int r, int c) {
    return r * kT + (((c / E) ^ swz(r)) * E) + c % E;
  }
};

// Rows of M (kTrans: W^T, else W) as slices of CW columns, each row padded
// to CW + 8 with zeros: slice s starts at img + s L (CW + 8).  The tile
// holds W[tr kT ..][tc kT ..].
template <class S, int CW, bool kTrans>
__device__ __forceinline__ void row_image(typename S::T* img, const typename S::Bits* tile, int tr,
                                          int tc) {
  using T = typename S::T;
  using Bits = typename S::Bits;
  constexpr int L = S::L, kT = S::kT, E = S::E, V = S::kVecs, P = CW + 8;
  static_assert(CW % kT == 0, "a tile lies in one slice");
  const int i0 = (kTrans ? tc : tr) * kT, j0 = (kTrans ? tr : tc) * kT;
  Bits* out = reinterpret_cast<Bits*>(img) + (j0 / CW) * (L * P) + i0 * P + j0 % CW;
  if constexpr (!kTrans) {  // rows of the tile, a vector a lane
    for (int q = threadIdx.x; q < kT * V; q += S::kThreads) {
      const int i = q / V, c = q % V;
      *reinterpret_cast<uint4*>(out + i * P + c * E) =
          *reinterpret_cast<const uint4*>(tile + S::at(i, c * E));
    }
  } else if constexpr (sizeof(T) == 4) {
    // columns of the tile: a warp takes 8 rows of M (columns i of the
    // tile) by 4 vectors, each lane 4 values down column i
    for (int q = threadIdx.x; q < kT * V; q += S::kThreads) {
      const int lane = q & 31, w = q >> 5;
      const int i = (w % (kT / 8)) * 8 + (lane & 7), c = (w / (kT / 8)) * 4 + (lane >> 3);
      uint4 x;
      x.x = tile[S::at(4 * c, i)];
      x.y = tile[S::at(4 * c + 1, i)];
      x.z = tile[S::at(4 * c + 2, i)];
      x.w = tile[S::at(4 * c + 3, i)];
      *reinterpret_cast<uint4*>(out + i * P + 4 * c) = x;
    }
  } else {
    // bf16: a 32-bit word holds columns i and i + 1 of a tile row, so a
    // lane reads 8 words down the pair and writes two rows of M; a warp
    // takes 8 pairs by 4 vectors
    for (int q = threadIdx.x; q < kT * V / 2; q += S::kThreads) {
      const int lane = q & 31, w = q >> 5;
      const int i = (w % (kT / 16)) * 16 + 2 * (lane & 7), c = (w / (kT / 16)) * 4 + (lane >> 3);
      uint32_t d[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = *reinterpret_cast<const uint32_t*>(tile + S::at(8 * c + e, i));
      const uint4 lo = make_uint4(__byte_perm(d[0], d[1], 0x5410), __byte_perm(d[2], d[3], 0x5410),
                                  __byte_perm(d[4], d[5], 0x5410), __byte_perm(d[6], d[7], 0x5410));
      const uint4 hi = make_uint4(__byte_perm(d[0], d[1], 0x7632), __byte_perm(d[2], d[3], 0x7632),
                                  __byte_perm(d[4], d[5], 0x7632), __byte_perm(d[6], d[7], 0x7632));
      *reinterpret_cast<uint4*>(out + i * P + 8 * c) = lo;
      *reinterpret_cast<uint4*>(out + (i + 1) * P + 8 * c) = hi;
    }
  }
  if (j0 % CW + kT == CW) {  // the tile ends its slice's rows: their padding
    constexpr int kPad = 8 / E;
    for (int q = threadIdx.x; q < kT * kPad; q += S::kThreads)
      *reinterpret_cast<uint4*>(out + (q / kPad) * P + kT + (q % kPad) * E) =
          make_uint4(0u, 0u, 0u, 0u);
  }
}

// The f32 edge chunks of one product B (kTransB: W^T, else W): chunk c of
// the product at prod + 2 c L KC, its TF32 high plane, then its low plane,
// element (n, k) at tf32_core_offset(n, k % KC, KC).  A warp takes 32
// consecutive n (four core matrices' rows) at one 4-deep k step, each lane
// the 4 values B[k .. k + 3][n]: a column of the tile where B = W.
template <class S, bool kTransB>
__device__ __forceinline__ void edge_image_f32(float* prod, const uint32_t* tile, int tr, int tc) {
  constexpr int L = S::L, kT = S::kT, KC = EdgeTile<float, L>::KC, KQ = KC / 4, per = L * KC;
  const int k0 = (kTransB ? tc : tr) * kT, n0 = (kTransB ? tr : tc) * kT;
  for (int q = threadIdx.x; q < kT * kT / 4; q += S::kThreads) {
    const int lane = q & 31, w = q >> 5;
    const int kq = w % KQ, n = (w / KQ) % (kT / 32) * 32 + lane, cc = w / (KQ * (kT / 32));
    const int k = cc * KC + 4 * kq;  // the tile's first row (B = W) or column of the 4
    float x[4];
    if constexpr (kTransB) {
      const uint4 v = *reinterpret_cast<const uint4*>(tile + S::at(n, k));
      x[0] = __uint_as_float(v.x), x[1] = __uint_as_float(v.y);
      x[2] = __uint_as_float(v.z), x[3] = __uint_as_float(v.w);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = __uint_as_float(tile[S::at(k + j, n)]);
    }
    uint4 hi, lo;
    split_tf32(x[0], hi.x, lo.x);
    split_tf32(x[1], hi.y, lo.y);
    split_tf32(x[2], hi.z, lo.z);
    split_tf32(x[3], hi.w, lo.w);
    float* chunk = prod + ((k0 + cc * KC) / KC) * 2 * per;
    const int off = (((n0 + n) >> 3) * KQ + kq) * 32 + (lane & 7) * 4;
    *reinterpret_cast<uint4*>(chunk + off) = hi;
    *reinterpret_cast<uint4*>(chunk + per + off) = lo;
  }
}

// One product B (kTransB: W^T, else W) of the edge stream at prod: f32 as
// TF32 planes, bf16 as rows n of KC values (M = B^T), padded to KC + 8.
template <class S, bool kTransB>
__device__ __forceinline__ void edge_image(typename S::T* prod, const typename S::Bits* tile,
                                           int tr, int tc) {
  if constexpr (sizeof(typename S::T) == 4)
    edge_image_f32<S, kTransB>(prod, tile, tr, tc);
  else
    row_image<S, EdgeTile<typename S::T, S::L>::KC, !kTransB>(prod, tile, tr, tc);
}

// Block (x, y): round y; x = (weight block, tile): the edge MLP's 2 +
// n_layers blocks (W0's e, s, r rows, then W_1 ..), then the node MLP's 1 +
// n_layers (W0's v, agg rows, then W_1 ..), kTiles^2 tiles each.  pe.w[l]
// and pn.w[l] point at the (rounds, in, L) stacks of the cast weights; an
// MLP with n_layers 0 has no stream.
template <class S>
__global__ void __launch_bounds__(S::kThreads)
weight_streams_kernel(MlpParams pe, MlpParams pn, int form, typename S::T* __restrict__ out_e,
                      typename S::T* __restrict__ out_n, typename S::T* __restrict__ out_p) {
  using T = typename S::T;
  using Bits = typename S::Bits;
  constexpr int L = S::L;
  using Y = ProjLayout<T, L>;
  constexpr int kT = S::kT, E = S::E, V = S::kVecs, T2 = S::kTiles * S::kTiles;
  __shared__ __align__(16) Bits tile[kT * kT];
  const int r = blockIdx.y, tr = (blockIdx.x % T2) / S::kTiles, tc = blockIdx.x % S::kTiles;
  const int n_edge = pe.n_layers > 0 ? 2 + pe.n_layers : 0;
  const bool edge = static_cast<int>(blockIdx.x) / T2 < n_edge;
  const MlpParams& p = edge ? pe : pn;
  const int b = static_cast<int>(blockIdx.x) / T2 - (edge ? 0 : n_edge);
  const int parts = edge ? 3 : 2;  // W0's row blocks
  const int layer = b < parts ? 0 : b - parts + 1, part = b < parts ? b : 0;
  const Bits* w = static_cast<const Bits*>(p.w[layer]) +
                  (static_cast<size_t>(r) * (layer == 0 ? parts : 1) + part) * (L * L);
  for (int q = threadIdx.x; q < kT * V; q += S::kThreads) {
    const int i = q / V, c = q % V;
    *reinterpret_cast<uint4*>(tile + S::at(i, c * E)) =
        __ldg(reinterpret_cast<const uint4*>(w + (tr * kT + i) * L + tc * kT + c * E));
  }
  __syncthreads();

  const int nl = p.n_layers, H = nl - 1;
  if (edge) {
    constexpr int kProd = EdgeTile<T, L>::kChunks * stage_elems<T, L>() * (sizeof(T) == 4 ? 2 : 1);
    const int n_prod = form == kStreamServing ? nl : form == kStreamAdjoint ? 2 * nl + 2 : 2 * nl;
    T* oe = out_e + static_cast<size_t>(r) * n_prod * kProd;
    if (layer > 0 || part == 0) {  // K2's product of W0's e block or W_l, then K4's
      edge_image<S, false>(oe + layer * kProd, tile, tr, tc);
      if (form != kStreamServing)
        edge_image<S, true>(oe + (nl + (layer == 0 ? H : H - layer)) * kProd, tile, tr, tc);
    } else {  // W0's s (part 1) or r (part 2) block: K7's images, then K8's and K4's
      constexpr int kPart = Y::kSlices * Y::kImage;
      T* op = out_p + static_cast<size_t>(r) * (form == kStreamServing ? 2 : 4) * kPart;
      row_image<S, Y::CN, false>(op + (part - 1) * kPart, tile, tr, tc);
      if (form != kStreamServing)
        row_image<S, Y::CN, true>(op + (part + 1) * kPart, tile, tr, tc);
      if (form == kStreamAdjoint)
        edge_image<S, true>(oe + (nl + H + part) * kProd, tile, tr, tc);
    }
  } else {  // K3's rows, then K5's (hidden layers n-1 .. 1, then W0's v and agg blocks)
    constexpr int PW = NodeTile<T, L>::PW;
    const int rows = (1 + nl) * L;  // K3's rows of a round
    T* on = out_n + static_cast<size_t>(r) * (form == kStreamServing ? 1 : 2) * rows * PW;
    row_image<S, L, false>(on + (layer == 0 ? part : layer + 1) * L * PW, tile, tr, tc);
    if (form != kStreamServing)
      row_image<S, L, true>(on + (rows + (layer == 0 ? H + part : H - layer) * L) * PW, tile,
                            tr, tc);
  }
}

}  // namespace mgn
