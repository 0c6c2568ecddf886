// K6 (wgrad) — every weight, bias and LayerNorm gradient of one processor-MLP
// round in one launch, for Hopper (sm_90a), on the tensor cores:
//
//   product i:  dw_i[p*A + a][b] = sum over rows of x_p[row'][a] * dh_i[row][b]
//               db_i[b]          = sum over rows of dh_i[row][b]
//
//   x_p (·, A) and dh_i (rows, B) in the compute dtype T (f32 or bf16);
//   row' = idx_p[row] (int32) or row, so the first layer's v[senders] and
//   v[receivers] parts are read through the edge index and never
//   materialised; dw and db in f32.  A product without x only sums columns
//   (the LayerNorm gradients from K4/K5's per-tile partial sums, f32).  One
//   round's group is: the first layer (its 2 or 3 parts share one dh_0 and
//   one bias), each hidden layer (x = the ReLU output feeding it), and the
//   LayerNorm column sums; in the backward's defer_first form the edge
//   MLP's first layer is its e part alone, and two more products give
//   W0's sender and receiver rows from the node space, v^T G_s and v^T G_r
//   (N rows, G the f32 sums of dh_0 by sender and by receiver).  Those have
//   f32 dh beside a bf16 x in a bf16 group: the mixed form, x exact in TF32
//   and dh split into TF32 high and low parts (f32 x f32, as JAX promotes
//   them; G is never rounded to bf16).  ops/fused.py:wgrad_plan lays the
//   group out.
//
// Replaces: the weight-gradient reductions of the TPU backward kernel
// mgn_tpu/ops/fused.py:_make_bwd_kernel (the per-chunk `_wgrad` of _mlp_bwd,
// :288, and the bias and LayerNorm sums), which accumulate into VMEM scratch
// as the sequential TPU grid walks the chunks.  GPU blocks run in no order,
// so the row axis is split over blocks and the splits are added inside the
// launch, in a fixed order, with no float atomics: a gradient has the same
// bits from run to run.
//
// Bound on this card (H100 SXM), the e part of the edge MLP's first layer
// at the cylinder in f32 (11,264 rows, 128 x 128, with the bias): 11.6 MB
// read once, 3.5 us at 3.35 TB/s, against 0.37 GFLOP, 2.2 us at the 3xTF32
// rate (495/3 TFLOP/s): bytes.  One cylinder round in f32 (both MLPs, 2
// hidden layers): about 45 MB, 13.4 us, against 12.7 us of 3xTF32.
//
// Design.  The product is x^T dh with the row axis as the reduction axis;
// both operands are row-major (rows, ·), M- and N-contiguous.  What it does
// about the costs of the two-pass design it replaced (64 x 64 tiles on
// mma.sync, a second kernel adding the row splits):
// - One launch.  The row splits of a tile are added inside the launch.
//   Every block writes its partial tile to a scratch slot (the
//   accumulators' own order, one 512-byte store a warp) and counts itself
//   on the tile's first counter; the launch is cooperative, so the tile's
//   blocks are resident together and each waits for the count, then adds
//   its share of the tile's floats over the slots in split order (the
//   threads of a float4 each a contiguous range of slots, combined in
//   order) and writes it; the tile's second counter counts the blocks past
//   the wait and the last sets both back to 0.  The bits depend on the plan, never
//   on the order in which blocks finish.  The counters live in a small
//   buffer the wrapper keeps per device, zeroed once.  (A cluster design —
//   eight blocks adding their partials through distributed shared memory,
//   then a ticket among the clusters — spent about half of the e part's
//   time in those two steps: PERF.md §6.)
// - A full-width tile.  A block owns one TILE x TILE output tile of one
//   part (TILE = min(L, 128); four tiles a part at L = 256; 64 for a group
//   too small to fill the card at 128, see ops/fused.py:wgrad_tile) over a
//   contiguous range of whole 32-row chunks, so each x row and each dh row
//   of the range enters the block once.  Two consumer warpgroups own 64
//   output rows each (one at TILE 64 and 32; at 32 its upper 32 rows are
//   zeros).
// - A copy ring fed by a producer warpgroup.  kStages stages, kAhead
//   chunks in flight (the first lands before the later ones take the
//   memory's bandwidth).  dh's chunk is one cp.async.bulk completing the
//   stage's mbarrier where its width is TILE; x's rows (gathered through
//   the edge index where a part has one) come by cp.async into rows padded
//   so that the A fragments are read without bank conflicts, each thread's
//   landing arriving on the same mbarrier.  The producer and the consumers
//   meet only at mbarriers, so the two consumer warpgroups drift apart and
//   one's additions run under the other's products.
// - wgmma.  Hopper's wgmma takes a TF32 B only K-major, and dh is
//   N-contiguous: the producer splits each landed dh chunk once into its
//   TF32 high and low planes, written K-major in wgmma's core-matrix layout
//   (tf32_core_offset), double-buffered (bf16: one plane, the same layout
//   at 16 bytes of K a core-matrix row), and sums the bias columns on the
//   way.  A = x^T comes from the x stage into the consumers' registers
//   (load_a_m: each x value read and split by one warp of the block).
//   - f32: 3xTF32 on wgmma m64nNk8: lo*hi + hi*lo + hi*hi.
//   - mixed (bf16 x, f32 dh): x is exact in TF32: x*lo + x*hi.
//   - bf16: wgmma m64nNk16 on the bf16 plane (exact products), from the
//     same prepared B and warpgroup layout as f32.  Chosen by a measured
//     run against mma.sync m16n8k16 with ldmatrix.trans on the same tile
//     (B straight from padded dh rows, summed into the accumulator): wgmma
//     was faster at the edge MLP's e part, within 3 % either way on the
//     groups, and its fresh accumulators keep the sums closer to the
//     plain version (PERF.md §6).
//   Each warpgroup runs its tile as 64-column halves with a fresh
//   accumulator every kFold = 2 K-steps, added to the running sum in
//   round-to-nearest f32: the tensor cores truncate as they accumulate
//   (see Mma<float>::mma).  (A second fresh accumulator in flight does not
//   fit the 168 registers a thread has at 384 threads.)

#include "mma_tile.cuh"

namespace mgn {

constexpr int kWgradMaxProducts = 12;  // ops/fused.py _WGRAD_MAX_PRODUCTS
constexpr int kWgradMaxParts = 3;

// One product of a group; the layout must match ops/_build.py's WgradProduct.
struct WgradProduct {
  const void* x[kWgradMaxParts];   // (·, a_dim) per part, T; parts == 0: column sums only
  const int* idx[kWgradMaxParts];  // row gather of x per part, or null
  const void* dh;                  // (rows, b_dim): T, or f32 where dh_f32 (mixed if parts)
  float* dw;                       // (parts * a_dim, b_dim), or null
  float* db[2];                    // columns [0, b_split) -> db[0], the rest -> db[1]; null: skipped
  long long scratch0;              // first float of its tiles' partial tiles (splits > 1)
  int parts, rows, a_dim, b_dim, b_split, dh_f32;
  int tiles_a, tiles_b;            // output tiles a part
  int splits;                      // blocks a tile, each a range of rows
  int rows_per_block;              // a whole number of chunks
  int block0;                      // first block of this product in the grid
  int counter0;                    // first of its tiles' counter pairs (splits > 1)
};

struct WgradGroup {
  WgradProduct p[kWgradMaxProducts];
  int n_products;
  int n_blocks;
};

}  // namespace mgn

namespace {

using mgn::WgradGroup;
using mgn::WgradProduct;
using B16 = __nv_bfloat16;

constexpr int kChunk = 32;   // rows per ring stage (ops/fused.py _WGRAD_CHUNK)
constexpr int kStages = 4;   // ring depth (_WGRAD_STAGES)
constexpr int kAhead = 2;    // chunks in flight ahead of the one in use
constexpr int kFold = 2;     // K-steps a fresh accumulator takes

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(B16 x) { return __bfloat162float(x); }

// A block's shapes at output tile TILE x TILE, compute dtype T (mirrored by
// ops/fused.py:wgrad_plan).  Warps: kConsumerWarps (one or two
// warpgroups of 64 output rows) and a producer warpgroup.  Shared memory:
// the mbarriers, the ring (per stage a chunk of x in T, rows padded to PX
// so that the A fragments are read without bank conflicts, then one of dh,
// f32 at most: the mixed form), two plane buffers (f32 and mixed: a
// chunk's TF32 high plane, then its low plane; bf16: one plane), and the
// column-sum partials.  The reduction reuses the ring.
template <typename T, int TILE>
struct WgradTile {
  static constexpr int kConsumerWarps = TILE == 128 ? 8 : 4;
  static constexpr int kThreads = 32 * kConsumerWarps + 128;
  static constexpr int kMinBlocks = TILE == 128 ? 1 : 2;  // blocks an SM
  static constexpr int NI = TILE / 8;  // 4-float accumulator groups a thread
  static constexpr int PX = TILE + 8;  // x row pitch (elements)
  static constexpr size_t kX = size_t(kChunk) * PX * sizeof(T);
  static constexpr size_t kStage = kX + size_t(kChunk) * TILE * 4;
  static constexpr size_t kPlane = size_t(kChunk) * TILE * 4;
  static constexpr size_t kBar = 128;
  static constexpr size_t kRing = kStages * kStage;
  static constexpr size_t kPlanes = 2 * 2 * kPlane;
  static constexpr size_t kSmem = kBar + kRing + kPlanes + size_t(kThreads) * 4;
  // floats of a partial tile in a scratch slot: every consumer thread's
  // accumulators, then the bias
  static constexpr int kSlot = kConsumerWarps * 32 * NI * 4 + TILE;
  static_assert(size_t(kThreads) * 16 <= kRing, "the reduction's partial sums fit the ring");
  static_assert(kSmem <= 232448, "a block's shared memory");
};

// The mbarriers of a block: a ring stage's data landed (full) and read
// (empty), a plane buffer written (pfull) and read (pempty).
struct WgradBars {
  uint64_t full[kStages], empty[kStages], pfull[2], pempty[2];
};

// What one block does: its product, tile and rows.
struct Job {
  const WgradProduct* q;
  int part, ta, tb, tile, split;  // tile: among the product's; split: the block among the tile's
  int r0, r1;
  bool with_w, with_bias;
};

__device__ __forceinline__ Job decode(const WgradGroup& g, int block) {
  int i = 0;
  while (i + 1 < g.n_products && g.p[i + 1].block0 <= block) ++i;
  Job j;
  j.q = &g.p[i];
  const WgradProduct& q = *j.q;
  const int local = block - q.block0;
  j.split = local % q.splits;
  j.tile = local / q.splits;
  j.tb = j.tile % q.tiles_b;
  j.ta = (j.tile / q.tiles_b) % q.tiles_a;
  j.part = j.tile / (q.tiles_b * q.tiles_a);
  j.r0 = min(j.split * q.rows_per_block, q.rows);
  j.r1 = min(j.r0 + q.rows_per_block, q.rows);
  j.with_w = q.parts > 0;
  j.with_bias = j.part == 0 && j.ta == 0 && (q.db[0] != nullptr || q.db[1] != nullptr);
  return j;
}

__device__ __forceinline__ void add4(float4& s, const float4& v) {
  s.x += v.x;
  s.y += v.y;
  s.z += v.z;
  s.w += v.w;
}

// The producer warpgroup's own barrier (named barrier 1).
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

__device__ __forceinline__ void zero_bytes(void* dst, int bytes, int tid, int nt) {
  uint4* p = static_cast<uint4*>(dst);
  for (int i = tid; i < bytes / 16; i += nt) p[i] = make_uint4(0u, 0u, 0u, 0u);
}

// The row loop: acc (a consumer warp's rows of the tile, wgmma's
// accumulator layout) = the sum over the block's rows of x_part^T dh;
// colsum, where the block sums the bias, producer thread p's share of
// column p % TILE (rows p / TILE, p / TILE + 128 / TILE, ... of each
// group of four).  TX: x's type (T); TD: dh's (T, or f32 in the mixed
// form).  The producer warpgroup issues the ring's copies and writes each
// chunk's planes; the consumer warps read x into A fragments and run the
// products; they meet only at the mbarriers.
template <typename T, int TILE, typename TX, typename TD>
__device__ __forceinline__ void row_loop(const Job& jb, unsigned char* smem,
                                         float (&acc)[TILE / 8][4], float& colsum) {
  using C = WgradTile<T, TILE>;
  constexpr int NI = C::NI, S = kStages, KC = kChunk, PX = C::PX;
  constexpr bool kBf16 = sizeof(TD) == 2;  // bf16 x bf16: 16-deep K-steps on one plane
  constexpr int KS = kBf16 ? 16 : 8;
  constexpr int kFolds = KC / (KS * kFold);
  // At TILE 128 each warpgroup runs its 64 x 128 tile as two 64-column
  // halves, one fresh accumulator at a time (the registers of a 64 x 128
  // one do not fit beside the sum); the other warpgroup's products run
  // while this one adds.
  constexpr int kHalves = TILE == 128 ? 2 : 1;
  constexpr int NH = NI / kHalves, WN = TILE / kHalves;
  constexpr int kHalfB = (WN / 8) * KC * (kBf16 ? 16 : 32);  // B's second half (bytes)
  constexpr int kKPer = kBf16 ? 8 : 4;  // K values a core-matrix row holds
  const WgradProduct& q = *jb.q;
  WgradBars& bars = *reinterpret_cast<WgradBars*>(smem);
  unsigned char* ring = smem + C::kBar;
  unsigned char* planes = ring + C::kRing;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const TX* x = static_cast<const TX*>(q.x[jb.part]);
  const int* idx = q.idx[jb.part];
  const int nc = (jb.r1 - jb.r0 + KC - 1) / KC;
  auto xs = [&](int s) { return reinterpret_cast<TX*>(ring + s * C::kStage); };
  auto ds = [&](int s) { return reinterpret_cast<TD*>(ring + s * C::kStage + C::kX); };

  if (warp >= C::kConsumerWarps) {  // the producer warpgroup
    const int p = tid - 32 * C::kConsumerWarps;
    const TD* dh = static_cast<const TD*>(q.dh);
    const int a0 = jb.ta * TILE, b0 = jb.tb * TILE;
    // Chunk c into stage c % S, zeros past the product's last row: x's rows
    // (gathered through idx where the part has one) by cp.async, 16 bytes
    // a thread, into the padded rows; dh's rows by one bulk copy where its
    // width is TILE, else by cp.async too.  Each thread's cp.async landing
    // and thread 0's bulk copy complete the stage's full barrier.
    auto issue = [&](int c) {
      const int s = c % S, row0 = jb.r0 + c * KC, valid = min(KC, jb.r1 - row0);
      TX* xd = xs(s);
      TD* dd = ds(s);
      constexpr int VX = 16 / sizeof(TX), RX = TILE / VX;
      for (int i = p; i < KC * RX; i += 128) {
        const int r = i / RX, col = (i % RX) * VX;
        const bool ok = r < valid;
        const int src = ok ? (idx != nullptr ? idx[row0 + r] : row0 + r) : 0;
        mgn::cp_async16(xd + r * PX + col, x + static_cast<size_t>(src) * q.a_dim + a0 + col, ok);
      }
      const bool bulk = q.b_dim == TILE;
      if (!bulk) {
        constexpr int VD = 16 / sizeof(TD), RD = TILE / VD;
        for (int i = p; i < KC * RD; i += 128) {
          const int r = i / RD, col = (i % RD) * VD;
          const bool ok = r < valid;
          mgn::cp_async16(dd + r * TILE + col,
                          dh + static_cast<size_t>(ok ? row0 + r : 0) * q.b_dim + b0 + col, ok);
        }
      } else if (valid < KC) {
        zero_bytes(dd + valid * TILE, (KC - valid) * TILE * sizeof(TD), p, 128);
        producer_sync();  // the zeros, before the transposing pass reads them
      }
      mgn::cp_async_mbar_arrive(&bars.full[s]);
      if (p == 0) {
        if (bulk) {
          const uint32_t bytes = valid * TILE * sizeof(TD);
          mgn::mbar_expect_tx(&bars.full[s], bytes);
          mgn::bulk_copy_tx(dd, dh + static_cast<size_t>(row0) * TILE, bytes, &bars.full[s]);
        } else {
          mgn::mbar_arrive(&bars.full[s]);
        }
      }
    };
    // kAhead chunks in flight: the first chunk lands before the later ones
    // take the memory's bandwidth
    for (int c = 0; c < kAhead && c < nc; ++c) issue(c);
#pragma unroll 1
    for (int c = 0; c < nc; ++c) {
      mgn::mbar_wait(&bars.full[c % S], (c / S) & 1);
      const int r = c + kAhead;
      if (r < nc) {
        if (r >= S) mgn::mbar_wait(&bars.empty[r % S], ((r - S) / S) & 1);
        issue(r);
      }
      if (c >= 2) mgn::mbar_wait(&bars.pempty[c & 1], ((c - 2) / 2) & 1);
      // dh of chunk c into plane buffer c & 1, K-major core matrices, and
      // the bias columns' sums (a fixed order: chunk, then row)
      const TD* d = ds(c % S);
      unsigned char* pl = planes + (c & 1) * (C::kPlanes / 2);
      const int n = p % TILE;
#pragma unroll 2
      for (int k0 = (p / TILE) * kKPer; k0 < KC; k0 += (128 / TILE) * kKPer) {
        if constexpr (!kBf16) {
          uint32_t* hi = reinterpret_cast<uint32_t*>(pl);
          uint32_t* lo = hi + KC * TILE;
          uint32_t h[4], l[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float v = d[(k0 + i) * TILE + n];
            if (jb.with_bias) colsum += v;
            mgn::split_tf32(v, h[i], l[i]);
          }
          const int off = mgn::tf32_core_offset(n, k0, KC);
          *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
          *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
        } else {
          B16* pb = reinterpret_cast<B16*>(pl);
          uint32_t w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const B16 v0 = d[(k0 + 2 * i) * TILE + n], v1 = d[(k0 + 2 * i + 1) * TILE + n];
            if (jb.with_bias) {
              colsum += to_f(v0);
              colsum += to_f(v1);
            }
            w[i] = mgn::pack_bf16(v0, v1);
          }
          const int off = ((n >> 3) * (KC / 8) + (k0 >> 3)) * 64 + (n & 7) * 8;
          *reinterpret_cast<uint4*>(pb + off) = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
      mgn::fence_proxy_async();  // the planes are read by wgmma, through the async proxy
      __syncwarp();
      if (lane == 0) {
        mgn::mbar_arrive(&bars.pfull[c & 1]);
        mgn::mbar_arrive(&bars.empty[c % S]);
      }
    }
    return;
  }

  const int m0 = warp * 16;  // the consumer warp's first output row
  const int g = lane >> 2, t4 = lane & 3;
  const bool rows_in = m0 < TILE;  // TILE 32: warps 2 and 3 hold no output rows
  float t[NH][4];
  auto add = [&](int h) {
#pragma unroll
    for (int j = 0; j < NH; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[h * NH + j][k] += t[j][k];
  };
#pragma unroll 1
  for (int c = 0; c < nc; ++c) {
    const int s = c % S;
    const TX* xc = xs(s);
    const unsigned char* pl = planes + (c & 1) * (C::kPlanes / 2);
    mgn::mbar_wait(&bars.full[s], (c / S) & 1);
#pragma unroll
    for (int f = 0; f < kFolds; ++f) {
      // the fold's A fragments (f32: TF32 high and low parts; mixed: x
      // exactly; bf16: pairs along K)
      uint32_t ahi[kFold][4], alo[kFold][4];
#pragma unroll
      for (int k2 = 0; k2 < kFold; ++k2) {
        const int kk = (f * kFold + k2) * KS;
        if (!rows_in) {
#pragma unroll
          for (int i = 0; i < 4; ++i) ahi[k2][i] = alo[k2][i] = 0u;
        } else if constexpr (kBf16) {
          typename mgn::Mma<B16>::A a;
          mgn::Mma<B16>::load_a_m(a, xc, PX, m0, kk, lane);
#pragma unroll
          for (int i = 0; i < 4; ++i) ahi[k2][i] = a.r[i];
        } else if constexpr (sizeof(TX) == 4) {
          typename mgn::Mma<float>::A a;
          mgn::Mma<float>::load_a_m(a, xc, PX, m0, kk, lane);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ahi[k2][i] = a.hi[i];
            alo[k2][i] = a.lo[i];
          }
        } else {  // bf16 x, exact in TF32: A[m][k] = x[k][m], rows g, g + 8, K t, t + 4
          const TX* p = xc + (kk + t4) * PX + m0 + g;
          ahi[k2][0] = __float_as_uint(to_f(p[0]));
          ahi[k2][1] = __float_as_uint(to_f(p[8]));
          ahi[k2][2] = __float_as_uint(to_f(p[4 * PX]));
          ahi[k2][3] = __float_as_uint(to_f(p[4 * PX + 8]));
        }
      }
      if (f == kFolds - 1) {  // the chunk's x is read
        __syncwarp();
        if (lane == 0) mgn::mbar_arrive(&bars.empty[s]);
      }
      if (f == 0) mgn::mbar_wait(&bars.pfull[c & 1], (c / 2) & 1);
#pragma unroll
      for (int h = 0; h < kHalves; ++h) {
        mgn::wgmma_fence();
#pragma unroll
        for (int k2 = 0; k2 < kFold; ++k2) {
          const int kk = (f * kFold + k2) * KS;
          if constexpr (kBf16) {
            mgn::WgmmaBf16<WN>::run(t, ahi[k2],
                                    mgn::wgmma_desc(pl + kk * 16 + h * kHalfB, 128, KC * 16),
                                    k2 != 0);
          } else {
            const unsigned char* b = pl + kk * 32 + h * kHalfB;
            const uint64_t dhi = mgn::wgmma_desc(b, 128, KC * 32);
            const uint64_t dlo = mgn::wgmma_desc(b + C::kPlane, 128, KC * 32);
            if constexpr (sizeof(TX) == 4) {
              mgn::WgmmaTf32<WN>::run(t, alo[k2], dhi, k2 != 0);
              mgn::WgmmaTf32<WN>::run(t, ahi[k2], dlo, 1);
            } else {
              mgn::WgmmaTf32<WN>::run(t, ahi[k2], dlo, k2 != 0);
            }
            mgn::WgmmaTf32<WN>::run(t, ahi[k2], dhi, 1);
          }
        }
        mgn::wgmma_commit();
        mgn::wgmma_wait<0>();
        add(h);
      }
    }
    __syncwarp();
    if (lane == 0) mgn::mbar_arrive(&bars.pempty[c & 1]);
  }
}

// One arrival on a counter, ordering the block's writes before it (after
// a __syncthreads) for whoever acquires the counter.
__device__ __forceinline__ void arrive_release(unsigned* p) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(p) : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

template <typename T, int TILE>
__global__ void __launch_bounds__(WgradTile<T, TILE>::kThreads, WgradTile<T, TILE>::kMinBlocks)
wgrad_kernel(const __grid_constant__ WgradGroup g, float* __restrict__ scratch,
             unsigned* __restrict__ counters) {
  using C = WgradTile<T, TILE>;
  constexpr int NI = C::NI, NT = C::kThreads, NCW = C::kConsumerWarps, kSlot = C::kSlot;
  extern __shared__ __align__(1024) unsigned char smem[];
  const Job jb = decode(g, blockIdx.x);
  const WgradProduct& q = *jb.q;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  WgradBars& bars = *reinterpret_cast<WgradBars*>(smem);
  static_assert(sizeof(WgradBars) <= C::kBar, "the mbarriers");
  if (tid == 0) {
    // a stage lands with each producer thread's cp.async and thread 0's arrival
    for (int s = 0; s < kStages; ++s) {
      mgn::mbar_init(&bars.full[s], 129);
      mgn::mbar_init(&bars.empty[s], NCW + 4);
    }
    for (int b = 0; b < 2; ++b) {
      mgn::mbar_init(&bars.pfull[b], 4);
      mgn::mbar_init(&bars.pempty[b], NCW);
    }
  }
  __syncthreads();

  float acc[NI][4];
#pragma unroll
  for (int j = 0; j < NI; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;
  // the bias: the producer warpgroup's thread p sums a share of column
  // p % TILE (in the row loop, or here for a product of column sums only)
  float colsum = 0.f;
  const int p = tid - 32 * NCW;
  float* cs = reinterpret_cast<float*>(smem + C::kBar + C::kRing + C::kPlanes);
  if (jb.with_w) {
    if constexpr (sizeof(T) == 4) {
      row_loop<T, TILE, float, float>(jb, smem, acc, colsum);
    } else if (q.dh_f32) {
      row_loop<T, TILE, B16, float>(jb, smem, acc, colsum);
    } else {
      row_loop<T, TILE, B16, B16>(jb, smem, acc, colsum);
    }
  } else if (p >= 0) {  // column sums only, straight from device memory
    const int col = jb.tb * TILE + p % TILE;
    for (int r = jb.r0 + p / TILE; r < jb.r1; r += 128 / TILE) {
      const size_t at = static_cast<size_t>(r) * q.b_dim + col;
      colsum += q.dh_f32 ? static_cast<const float*>(q.dh)[at]
                         : to_f(static_cast<const T*>(q.dh)[at]);
    }
  }
  if (jb.with_bias && p >= 0) cs[p] = colsum;
  __syncthreads();

  float* dw_tile = jb.with_w ? q.dw + static_cast<size_t>(jb.part * q.a_dim + jb.ta * TILE) *
                                          q.b_dim + jb.tb * TILE
                             : nullptr;
  auto put_bias = [&](int col, float v) {
    const int c = jb.tb * TILE + col;
    if (c < q.b_split) {
      if (q.db[0] != nullptr) q.db[0][c] = v;
    } else if (q.db[1] != nullptr) {
      q.db[1][c - q.b_split] = v;
    }
  };
  // Two floats of the tile's rows (a consumer thread's accumulator pair
  // acc[j][2h], acc[j][2h + 1]) into dw.
  auto put_pair = [&](int w, int ln, int j, int h, float a, float b) {
    const int row = w * 16 + (ln >> 2) + 8 * h, col = j * 8 + 2 * (ln & 3);
    if (row < TILE)  // TILE 32: warps 2 and 3 hold no rows
      *reinterpret_cast<float2*>(dw_tile + static_cast<size_t>(row) * q.b_dim + col) =
          make_float2(a, b);
  };
  float bias = 0.f;
  if (jb.with_bias && tid < TILE) {
#pragma unroll
    for (int h = 0; h < 128 / TILE; ++h) bias += cs[h * TILE + tid];
  }
  const int splits = q.splits;
  if (splits == 1) {  // the tile's one block writes it
    if (jb.with_w && warp < NCW) {
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) put_pair(warp, lane, j, h, acc[j][2 * h], acc[j][2 * h + 1]);
    }
    if (jb.with_bias && tid < TILE) put_bias(tid, bias);
    return;
  }

  // Several blocks: each writes its partial tile to its scratch slot in the
  // accumulators' own order (float4 (w NI + j) 32 + lane holds acc[j] of
  // consumer warp w's lane: one 512-byte store a warp), then the bias.
  // Once every block of the tile has written (the tile's first counter
  // counts them; the blocks of a launch are co-resident), block `split`
  // adds its share of the slot's float4 units over the slots in split
  // order, tpu threads a unit (each a contiguous range of slots, combined
  // in order; neighbouring threads on neighbouring units), and writes them
  // to dw and db; the tile's second counter counts the blocks past the
  // wait, and the last sets both back to 0 (no block waits on them then).
  constexpr int kAcc = NCW * 32 * NI * 4;  // floats of the accumulators in a slot
  float* slot = scratch + q.scratch0 + (static_cast<size_t>(jb.tile) * splits + jb.split) * kSlot;
  if (jb.with_w && warp < NCW) {
#pragma unroll
    for (int j = 0; j < NI; ++j)
      reinterpret_cast<float4*>(slot)[(warp * NI + j) * 32 + lane] =
          make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
  }
  if (jb.with_bias && tid < TILE) slot[kAcc + tid] = bias;
  unsigned* ctr = counters + q.counter0 + 2 * jb.tile;
  unsigned past = 0;  // blocks of the tile past the wait before this one
  __syncthreads();
  if (tid == 0) {
    arrive_release(&ctr[0]);
    while (load_acquire(&ctr[0]) < static_cast<unsigned>(splits)) __nanosleep(20);
    past = atomicAdd(&ctr[1], 1u);  // read at the end: its latency runs under the sums
  }
  __syncthreads();
  const float4* first = reinterpret_cast<const float4*>(
      scratch + q.scratch0 + static_cast<size_t>(jb.tile) * splits * kSlot);
  constexpr int kUnits = kSlot / 4;
  const int per = (kUnits + splits - 1) / splits;
  const int u0 = jb.split * per, nu = max(0, min(kUnits, u0 + per) - u0);
  const int tpu = max(1, min(splits, NT / max(nu, 1)));
  const int span = (splits + tpu - 1) / tpu;  // slots a thread adds
  float4* red = reinterpret_cast<float4*>(smem + C::kBar);
  // units at once: thread tid takes unit tid % lanes, slot range tid / lanes
  const int lanes = NT / tpu;
  for (int base = 0; base < nu; base += lanes) {
    const int u = base + tid % lanes, j = tid / lanes;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < tpu && u < nu) {
      const int i0 = j * span, i1 = min(splits, i0 + span);
      constexpr int kBatch = 16;  // loads in flight
      for (int i = i0; i < i1; i += kBatch) {
        float4 v[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
          if (i + k < i1) v[k] = __ldcg(first + static_cast<size_t>(i + k) * kUnits + u0 + u);
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
          if (i + k < i1) add4(s, v[k]);
      }
    }
    if (tpu > 1) {
      red[tid] = s;
      __syncthreads();
      if (tid < lanes && base + tid < nu) {
        s = red[tid];
        for (int k = 1; k < tpu; ++k) add4(s, red[k * lanes + tid]);
      }
      __syncthreads();
    }
    const int uw = u0 + base + tid;
    if (tid < lanes && uw < u0 + nu) {
      if (uw < kAcc / 4) {  // float4 (w NI + j) 32 + lane: acc[j] of warp w's lane
        if (jb.with_w) {
          const int ln = uw % 32, j = (uw / 32) % NI, w = uw / (32 * NI);
          put_pair(w, ln, j, 0, s.x, s.y);
          put_pair(w, ln, j, 1, s.z, s.w);
        }
      } else if (jb.with_bias) {
        const int col = (uw - kAcc / 4) * 4;
        put_bias(col, s.x);
        put_bias(col + 1, s.y);
        put_bias(col + 2, s.z);
        put_bias(col + 3, s.w);
      }
    }
  }
  if (tid == 0 && past == static_cast<unsigned>(splits - 1)) {  // every block is past the wait
    ctr[0] = 0u;
    ctr[1] = 0u;
  }
}

template <typename T, int TILE>
int init_one() {
  return static_cast<int>(cudaFuncSetAttribute(wgrad_kernel<T, TILE>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(WgradTile<T, TILE>::kSmem)));
}

// Blocks of the kernel the current device holds at once.
template <typename T, int TILE>
int max_blocks(int* out) {
  using C = WgradTile<T, TILE>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wgrad_kernel<T, TILE>,
                                                       C::kThreads, C::kSmem);
  *out = sms * per_sm;
  return static_cast<int>(rc);
}

// A cooperative launch: every block of the grid is resident at once (the
// reduction waits for the blocks of a tile), or the launch is refused.
template <typename T, int TILE>
int launch(const WgradGroup& g, float* scratch, unsigned* counters, cudaStream_t s) {
  using C = WgradTile<T, TILE>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.n_blocks);
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, wgrad_kernel<T, TILE>, g, scratch, counters);
  return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
}

template <typename T>
int dispatch(int tile, const WgradGroup& g, float* scratch, unsigned* counters,
             cudaStream_t s, int* blocks_out) {
  switch (tile) {
    case 128: return blocks_out ? max_blocks<T, 128>(blocks_out)
                                : launch<T, 128>(g, scratch, counters, s);
    case 64: return blocks_out ? max_blocks<T, 64>(blocks_out)
                               : launch<T, 64>(g, scratch, counters, s);
    case 32: return blocks_out ? max_blocks<T, 32>(blocks_out)
                               : launch<T, 32>(g, scratch, counters, s);
    default: return cudaErrorInvalidValue;
  }
}

int dispatch_any(int dtype, int tile, const WgradGroup& g, float* scratch, unsigned* counters,
                 cudaStream_t s, int* blocks_out) {
  if (dtype == 0) return dispatch<float>(tile, g, scratch, counters, s, blocks_out);
  if (dtype == 1) return dispatch<B16>(tile, g, scratch, counters, s, blocks_out);
  return cudaErrorInvalidValue;
}

// The plan's layout, as the kernel decodes it (ops/fused.py:wgrad_plan).
bool plan_ok(const WgradGroup& g, int tile, long long n_scratch, int n_counters) {
  const long long slot = (tile == 128 ? 256 : 128) * tile / 2 + tile;  // WgradTile::kSlot
  if (g.n_products < 1 || g.n_products > mgn::kWgradMaxProducts || g.n_blocks < 1) return false;
  int block = 0;
  for (int i = 0; i < g.n_products; ++i) {
    const WgradProduct& q = g.p[i];
    const bool w = q.parts > 0;
    if (q.parts < 0 || q.parts > mgn::kWgradMaxParts || q.rows <= 0 || q.b_dim % tile ||
        q.tiles_b != q.b_dim / tile || (w && (q.a_dim % tile || q.tiles_a != q.a_dim / tile ||
                                              q.dw == nullptr)) ||
        (!w && (q.tiles_a != 1 || (q.db[0] == nullptr && q.db[1] == nullptr))) ||
        q.splits < 1 || q.rows_per_block <= 0 || q.rows_per_block % kChunk ||
        static_cast<long long>(q.splits) * q.rows_per_block < q.rows ||
        static_cast<long long>(q.splits - 1) * q.rows_per_block >= q.rows || q.block0 != block)
      return false;
    for (int p = 0; p < q.parts; ++p)
      if (q.x[p] == nullptr) return false;
    const int tiles = (w ? q.parts : 1) * q.tiles_a * q.tiles_b;
    if (q.splits > 1 &&
        (q.counter0 < 0 || q.counter0 + 2 * tiles > n_counters || q.scratch0 < 0 ||
         q.scratch0 + static_cast<long long>(tiles) * q.splits * slot > n_scratch))
      return false;
    block += tiles * q.splits;
  }
  return block == g.n_blocks;
}

}  // namespace

extern "C" {

// K6's shared-memory attributes for every dtype and tile, on the current
// device; once before its first launch there.
int mgn_wgrad_init() {
  const int rcs[] = {init_one<float, 128>(), init_one<float, 64>(), init_one<float, 32>(),
                     init_one<B16, 128>(), init_one<B16, 64>(), init_one<B16, 32>()};
  for (const int rc : rcs)
    if (rc != 0) return rc;
  return 0;
}

// Blocks of K6 at (dtype, tile) the current device holds at once (after
// mgn_wgrad_init): ops/fused.py:wgrad_plan sizes a group to one wave.
int mgn_wgrad_max_blocks(int dtype, int tile, int* out) {
  if (out == nullptr) return cudaErrorInvalidValue;
  WgradGroup unused{};
  return dispatch_any(dtype, tile, unused, nullptr, nullptr, nullptr, out);
}

// dtype: 0 = float32, 1 = bfloat16 (of every x and of dh where !dh_f32;
// a bf16 product with x and an f32 dh runs the mixed form).  tile: 128, 64
// or 32, dividing every a_dim and b_dim of the group.  scratch: n_scratch
// floats for the partial tiles of tiles with several blocks; counters:
// n_counters int32 counters (two a tile with several blocks), 0 before
// the launch and after it.
// Returns the launch's error code (0 on success).
int mgn_wgrad_group(int dtype, int tile, const mgn::WgradGroup* group, float* scratch,
                    long long n_scratch, unsigned* counters, int n_counters, void* stream) {
  if (group == nullptr || counters == nullptr || (scratch == nullptr && n_scratch > 0) ||
      !plan_ok(*group, tile, n_scratch, n_counters))
    return cudaErrorInvalidValue;
  return dispatch_any(dtype, tile, *group, scratch, counters, static_cast<cudaStream_t>(stream),
                      nullptr);
}

const char* mgn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
