// The 64-edge tile shared by K2 (edge_round, fused_round.cu) and K4
// (edge_round_bwd, fused_round_bwd.cu): the edge MLP's forward on the tensor
// cores, written once so that K2's messages and K4's recomputed forward are
// the same arithmetic (the ReLU masks K4 recomputes see the values K2
// produced).
//
//   acc = (P[s] + Q[r]) + e . W0[0:L]   (the pre-projected first layer)
//   acc = ReLU(rnd(rnd(acc) + b)) . W_l + ...   (hidden layers)
//   xhat = (h - mean) * rstd     (LayerNorm statistics in f32, two passes,
//                                 over the real width MlpParams::real)
//
// P = v . W0[L:2L] and Q = v . W0[2L:3L] are K7's f32 projections of the
// round's node state (edge_project, fused_round.cu), the TPU kernel's
// preproject form (mgn_tpu/ops/fused.py:453-463, :493-503): the tile reads
// the rows of P at its senders and of Q at its receivers straight into the
// first layer's accumulator fragments, after the e product, and adds their
// f32 sum once per element (_mlp_fwd(extra_acc=) adds the gathered extra
// to the whole product, in that order).  So the tile no longer reads v.
//
// A block owns kRows = 64 edges: a warpgroup of four 16-row warps per
// column group.  A (the 64 rows) sits in shared memory: the e rows are
// gathered with cp.async, 16 bytes a thread; each hidden layer's input is
// written back there from the accumulators.
// B is K-contiguous and streams, one KC-deep chunk at a time, through a
// shared-memory ring, across product boundaries.  The stream comes prepared
// (weight_streams_kernel, stream_tile.cuh, once per forward): each chunk is
// one contiguous block that is the image of a ring stage, so one bulk copy
// (cp.async.bulk) fills a stage and completes its mbarrier.  K2 reads a
// round's forward products (W0's e rows, then each hidden layer), K4 the
// same followed by its adjoint products.  The ring is the tile's feed, one
// of two on the same arithmetic (chunk, edge_mlp_forward):
// - K4 (EdgeBlock): kStages - 1 chunks ahead, refilled by thread 0 behind
//   the block barrier each chunk starts with.
// - K2 (EdgeRoundTile on EdgeRingFeed): kStages deep where two blocks an
//   SM still fit (bf16: 4 stages), started at entry, each stage refilled
//   as soon as the block is done with it.
// - bf16: mma.sync m16n8k16 per warp, B fragments from the ring's rows.
// - f32: 3xTF32 on wgmma m64n128k8 (m64n64k8 / m64n32k8 at L = 64 / 32), A
//   split into TF32 high and low parts in registers by each warp, B the
//   chunk's TF32 planes in wgmma's core-matrix layout ([hi | lo] per
//   chunk).  Each pair of K-steps starts a fresh partial that is then added
//   in round-to-nearest f32: the tensor cores truncate as they accumulate.
// - LayerNorm statistics run on the accumulator fragments: a row's sums are
//   quad shuffles plus a fixed-order combine of the column groups through
//   shared memory where there are several.
// Both kernels run each element's instruction sequence unchanged (the
// products' K order and partials, P[s] + Q[r], the bias rounding,
// row_sums' order), so K2 kept its bits through its redesign.
//
// K2 on this card (H100 SXM, the cylinder's round: E_pad 11,264, L 128, 2
// hidden layers): 3 L^2 MACs an edge, 1.11 GFLOP, 6.7 us at the 3xTF32
// rate; about 17 MB of e, msg, edge_valid, indices and the P/Q rows read
// and written once in f32 (5.2 us at 3.35 TB/s).  176 tiles on 132 SMs at
// two blocks an SM: the 44 SMs that hold two tiles bound it at about 10 us
// of 3xTF32 work (9,200 cycles a tile).  The round's weights cross L2 once
// per block, 69.2 MB a launch in f32 (19.5 in bf16; ops/fused.py:edge_plan
// counts them).  The tile before this one took 0.0311 ms in f32, 0.0191
// in bf16; ablated copies (probes/k2_split.py) split it as the epilogue
// 9.5 us (each thread's 32 loads of e waited behind its stores: e is
// updated in place, so not restrict), the products 13.6, the P/Q reads
// 1.5, the e rows 1.1, the weight feed 0.6.  So this tile stages msg in
// As and stores whole rows after loading every e value it updates; copies
// its e rows before its indices arrive; starts its weight ring at entry;
// refills a stage before it waits for the next; and keeps an f32 chunk's
// two partials in flight together: 0.0249 ms in f32, 0.0172 in bf16.  The
// multicast ring (clusters of 2 or 4) halved or quartered the L2 weight
// bytes and lost time: a stage is refilled only when every block of the
// cluster has left it, and the cheapest cross-block release found, the
// cluster barrier once a chunk, cost more (0.0293 and 0.0288 ms against
// 0.0251, f32) than the weight feed's whole 0.6-0.9 us; so each block
// keeps its own ring.
#pragma once

#include "mlp_tile.cuh"
#include "mma_tile.cuh"

namespace mgn {

// Shapes of the tile at latent L.  bf16 (mma.sync): 64-column groups, 32
// accumulators a thread.  f32 (wgmma): 128-column groups, so one m64n128
// warpgroup covers L = 128 and a thread's 64 accumulators and 64 K-step
// partials fit its 255 registers at two 128-thread blocks an SM.
template <typename T, int L>
struct EdgeTile {
  static constexpr int kRows = 64;  // ops/fused.py _EDGE_BWD_ROWS
  static constexpr int kColGroups =
      sizeof(T) == 4 ? (L >= 256 ? 2 : 1) : (L >= 128 ? L / 64 : 1);
  static constexpr int kWarps = 4 * kColGroups;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kWarpCols = L / kColGroups;
  static constexpr int NI = kWarpCols / 8;  // 8-column MMA tiles per warp
  // K-chunk of a weight ring stage: 128 bytes of each of the L rows
  static constexpr int KC = 128 / int(sizeof(T)) < L ? 128 / int(sizeof(T)) : L;
  static constexpr int kChunks = L / KC;  // chunks per product
  static constexpr int kStages = sizeof(T) == 4 ? 2 : 3;  // K4's ring depth
  static constexpr int PA = L + smem_pad_k<T>();   // row pitch of the staged rows
  static constexpr int PB = KC + smem_pad_k<T>();  // row pitch of a bf16 ring stage
  // a ring stage: bf16, L rows of KC (pitch PB); f32, the chunk's TF32 high
  // and low planes in wgmma's core-matrix layout
  static constexpr size_t kStage = sizeof(T) == 4 ? size_t(2) * L * KC * 4 : size_t(L) * PB * 2;
  static constexpr size_t kA = size_t(kRows) * PA * sizeof(T);
  static constexpr size_t kB = size_t(kStages) * kStage;
  static constexpr size_t kRed = size_t(kColGroups) * kRows * 2 * sizeof(float);
  static constexpr size_t kLn = size_t(4) * 2 * L * sizeof(float);  // K4's LayerNorm partials
  static constexpr size_t kIdx = size_t(3) * kRows * sizeof(int);
  static constexpr size_t kBar = size_t(kStages) * sizeof(uint64_t);  // a stage's mbarrier
  static constexpr size_t kSmem = kA + kB + kRed + kLn + kIdx + kBar;
  // two blocks an SM where their shared memory allows (registers then
  // capped at 32768 / kThreads a thread)
  static constexpr int kMinBlocks = kSmem <= 113 * 1024 && kThreads <= 256 ? 2 : 1;
};

// K2's block (ops/fused.py's edge_plan mirrors every number): the tile and
// a ring of kStages stages, the deepest of 4, 3 or 2 that leaves two
// blocks an SM (for tiles of up to 256 threads), else the deepest that
// fits one.
constexpr size_t kMaxSmem = 232448;   // dynamic shared memory a block can have
constexpr size_t kPairSmem = 115712;  // the same for each of two blocks an SM

// The ring's stages, the tile's rows, its column groups' row sums (where
// there are several) and its indices, a full mbarrier a stage.
template <typename T, int L>
__host__ __device__ constexpr size_t edge_ring_bytes(int stages) {
  using C = EdgeTile<T, L>;
  return size_t(stages) * C::kStage + C::kA + (C::kColGroups > 1 ? C::kRed : 0) + C::kIdx +
         size_t(8) * stages;
}
template <typename T, int L>
__host__ __device__ constexpr int edge_ring_stages() {
  constexpr size_t room = EdgeTile<T, L>::kThreads <= 256 ? kPairSmem : kMaxSmem;
  return edge_ring_bytes<T, L>(4) <= room ? 4 : edge_ring_bytes<T, L>(3) <= room ? 3 : 2;
}

template <typename T, int L>
struct EdgeRing {
  using C = EdgeTile<T, L>;
  static constexpr int kStages = edge_ring_stages<T, L>();
  static constexpr int kThreads = C::kThreads;
  static constexpr size_t kRed = C::kColGroups > 1 ? C::kRed : 0;
  static constexpr size_t kSmem = edge_ring_bytes<T, L>(kStages);
  static constexpr int kMinBlocks = kSmem <= kPairSmem ? 2 : 1;
  static_assert(kSmem <= kMaxSmem, "K2's block does not fit an SM");
};

// Element e of one chunk of a ring stage, as (output column n, depth k):
// f32, the core-matrix order of tf32_core_offset; bf16, row n of pitch PB
// (k >= KC is the row's padding).
template <typename T, int L>
__host__ __device__ __forceinline__ void stage_nk(int e, int& n, int& k) {
  using C = EdgeTile<T, L>;
  if constexpr (sizeof(T) == 4) {
    const int cm = e >> 5, w = e & 31, CM = C::KC / 4;
    n = (cm / CM) * 8 + (w >> 2);
    k = (cm % CM) * 4 + (w & 3);
  } else {
    n = e / C::PB;
    k = e % C::PB;
  }
}

// Values per chunk of a prepared stream (f32: the high plane; the low plane
// follows it).
template <typename T, int L>
__host__ __device__ constexpr int stage_elems() {
  return sizeof(T) == 4 ? L * EdgeTile<T, L>::KC : L * EdgeTile<T, L>::PB;
}

template <typename T> struct Pair;
template <> struct Pair<float> {
  static __device__ __forceinline__ void load(const float* p, float& a, float& b) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    a = x.x;
    b = x.y;
  }
  static __device__ __forceinline__ void store(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};
template <> struct Pair<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float& a, float& b) {
    const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(p);
    a = __low2float(x);
    b = __high2float(x);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

// What every thread of a tile knows about its place in it.
struct TileLane {
  int tid, lane, wm, cg, m0, nb, t;  // m0: first of the warp's 16 rows; nb: first column
  int row[2];                        // local rows g and g + 8

  __device__ __forceinline__ TileLane(int tid_, int warp_cols) : tid(tid_) {
    lane = tid % 32;
    const int warp = tid / 32;
    wm = warp % 4;
    cg = warp / 4;
    m0 = wm * 16;
    nb = cg * warp_cols;
    t = lane & 3;
    row[0] = m0 + (lane >> 2);
    row[1] = row[0] + 8;
  }
};

// The tile's kRows indices: rid the edge (-1 past the last), snd and rcv
// its sender and receiver.
template <int kRows, int kThreads>
__device__ __forceinline__ void load_rows(int* rid, int* snd, int* rcv, int row0, int tid,
                                          const int* senders, const int* receivers,
                                          int n_edges) {
  for (int i = tid; i < kRows; i += kThreads) {
    const int r = row0 + i;
    const bool ok = r < n_edges;
    rid[i] = ok ? r : -1;
    snd[i] = ok ? senders[r] : -1;
    rcv[i] = ok ? receivers[r] : -1;
  }
}

// The tile's 64 rows of e (zeros past the last edge) copied into As with
// cp.async, 16 bytes a thread; waits for this thread's copies, and the
// next product's first barrier publishes them all.
template <typename T, int L>
__device__ __forceinline__ void gather_rows(T* As, const int* rid, const T* e,
                                            const TileLane& me) {
  using C = EdgeTile<T, L>;
  constexpr int E = 16 / sizeof(T), OPS = L / E;
  for (int i = me.tid; i < C::kRows * OPS; i += C::kThreads) {
    const int r = i / OPS, col = (i % OPS) * E, s = rid[r];
    cp_async16(As + r * C::PA + col, e + static_cast<size_t>(s < 0 ? 0 : s) * L + col, s >= 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
}

// The product's arithmetic on one chunk, written once for both feeds.
//
// f32: K-step kk (0, 8, .. KC - 8) of chunk c on the stage's TF32 planes,
// into the partial t: A's TF32 high and low parts from As, then lo.hi,
// hi.lo, hi.hi; the first K-step of each pair overwrites t (a fresh
// accumulator every kFold K-steps, added to acc in round-to-nearest f32 by
// add_partial, see Mma<float>::mma).
constexpr int kFold = 2;

template <typename T, int L>
__device__ __forceinline__ void tf32_kstep(float (&t)[EdgeTile<T, L>::NI][4], const T* As,
                                           const unsigned char* stage, int c, int kk,
                                           const TileLane& me) {
  using C = EdgeTile<T, L>;
  const float* hi = reinterpret_cast<const float*>(stage);
  const float* lo = hi + L * C::KC;
  typename Mma<float>::A a;
  Mma<float>::load_a_k(a, As, C::PA, me.m0, c * C::KC + kk, me.lane);
  const int off = tf32_core_offset(me.nb, kk, C::KC);
  const uint64_t dhi = wgmma_desc(hi + off, 128, C::KC * 32);
  const uint64_t dlo = wgmma_desc(lo + off, 128, C::KC * 32);
  wgmma_fence();
  WgmmaTf32<C::kWarpCols>::run(t, a.lo, dhi, (kk / 8) % kFold != 0);
  WgmmaTf32<C::kWarpCols>::run(t, a.hi, dlo, 1);
  WgmmaTf32<C::kWarpCols>::run(t, a.hi, dhi, 1);
}

template <int NI>
__device__ __forceinline__ void add_partial(float (&acc)[NI][4], const float (&t)[NI][4]) {
#pragma unroll
  for (int j = 0; j < NI; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] += t[j][k];
}

// bf16: mma.sync per warp from the stage's rows.  f32: each partial waited
// for before the next is issued (K4), or kPair: the chunk's two partials
// in flight together, each added in K order once done (K2; K4's registers
// have no room for a second partial).
template <typename T, int L, bool kPair = false>
__device__ __forceinline__ void chunk(float (&acc)[EdgeTile<T, L>::NI][4], const T* As,
                                      const unsigned char* stage, int c, const TileLane& me) {
  using C = EdgeTile<T, L>;
  if constexpr (sizeof(T) == 4 && kPair) {
    static_assert(C::KC == 2 * kFold * 8, "two partials a chunk");
    float t0[C::NI][4], t1[C::NI][4];
    tf32_kstep<T, L>(t0, As, stage, c, 0, me);
    tf32_kstep<T, L>(t0, As, stage, c, 8, me);
    wgmma_commit();
    tf32_kstep<T, L>(t1, As, stage, c, 16, me);
    tf32_kstep<T, L>(t1, As, stage, c, 24, me);
    wgmma_commit();
    wgmma_wait<1>();
    add_partial(acc, t0);
    wgmma_wait<0>();
    add_partial(acc, t1);
  } else if constexpr (sizeof(T) == 4) {
    float t[C::NI][4];
#pragma unroll
    for (int kk = 0; kk < C::KC; kk += 8) {
      tf32_kstep<T, L>(t, As, stage, c, kk, me);
      if ((kk / 8) % kFold == kFold - 1) {
        wgmma_commit();
        wgmma_wait_all();
        add_partial(acc, t);
      }
    }
  } else {
    using M = Mma<T>;
    const T* rows = reinterpret_cast<const T*>(stage);
#pragma unroll
    for (int kk = 0; kk < C::KC; kk += M::K) {
      typename M::A a;
      M::load_a_k(a, As, C::PA, me.m0, c * C::KC + kk, me.lane);
#pragma unroll
      for (int j = 0; j < C::NI; ++j) {
        typename M::B b;
        M::load_b_k(b, rows, C::PB, me.nb + j * 8, kk, me.lane);
        M::mma(acc[j], a, b);
      }
    }
  }
}

template <int NI>
__device__ __forceinline__ void clear(float (&acc)[NI][4]) {
#pragma unroll
  for (int j = 0; j < NI; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;
}

// The first layer's gathered f32 projections: acc += P[s] + Q[r] at the
// fragment's rows, once per element (a row past the last edge, s < 0,
// adds nothing).
template <int NI>
__device__ __forceinline__ void add_projections(float (&acc)[NI][4], const float* P,
                                                const float* Q, const int* snd, const int* rcv,
                                                int L, const TileLane& me) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = snd[me.row[h]], r = rcv[me.row[h]];
    if (s < 0) continue;
    const float* ps = P + static_cast<size_t>(s) * L;
    const float* qr = Q + static_cast<size_t>(r) * L;
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int col = me.nb + j * 8 + 2 * me.t;
      float p0, p1, q0, q1;
      Pair<float>::load(ps + col, p0, p1);
      Pair<float>::load(qr + col, q0, q1);
      acc[j][2 * h] += p0 + q0;
      acc[j][2 * h + 1] += p1 + q1;
    }
  }
}

// K4's tile: a block is one tile with its own ring (a round's row of
// weight_streams_kernel's edge stream: kStage bytes a chunk).  Constructed
// by every thread of the block at once (it synchronises them).
template <typename T, int L>
struct EdgeBlock {
  using C = EdgeTile<T, L>;
  static constexpr int NI = C::NI, S = C::kStages;

  T* As;
  unsigned char* ring;
  float* red;
  float* lnp;
  int *rid, *snd, *rcv;
  uint64_t* bar;
  TileLane me;
  const unsigned char* stream;
  const T* e;  // the rows of the first layer's product
  int total, next, cur;

  // Carves shared memory, loads the tile's edge indices and starts the
  // weight stream of n_products (L, L) products.
  __device__ __forceinline__ EdgeBlock(unsigned char* smem, const unsigned char* wstream,
                                       int n_products, const T* e_, const int* senders,
                                       const int* receivers, int n_edges)
      : me(threadIdx.x, C::kWarpCols), stream(wstream), e(e_) {
    As = reinterpret_cast<T*>(smem);
    ring = smem + C::kA;
    red = reinterpret_cast<float*>(smem + C::kA + C::kB);
    lnp = reinterpret_cast<float*>(smem + C::kA + C::kB + C::kRed);
    rid = reinterpret_cast<int*>(smem + C::kA + C::kB + C::kRed + C::kLn);
    snd = rid + C::kRows;
    rcv = snd + C::kRows;
    bar = reinterpret_cast<uint64_t*>(rcv + C::kRows);
    total = n_products * C::kChunks;
    next = cur = 0;
    if (me.tid < S) mbar_init(&bar[me.tid]);
    load_rows<C::kRows, C::kThreads>(rid, snd, rcv, blockIdx.x * C::kRows, me.tid, senders,
                                     receivers, n_edges);
    __syncthreads();
    for (int k = 0; k < S - 1; ++k) issue();
  }

  // Copies the stream's next chunk into the ring, kStages - 1 chunks ahead
  // of the product that reads it.
  __device__ __forceinline__ void issue() {
    if (next < total && me.tid == 0)
      bulk_copy(ring + (next % S) * C::kStage, stream + static_cast<size_t>(next) * C::kStage,
                static_cast<uint32_t>(C::kStage), &bar[next % S]);
    ++next;
  }

  __device__ __forceinline__ void gather_e() { gather_rows<T, L>(As, rid, e, me); }

  // acc = As (64 x L) . B over the next product of the stream, one barrier
  // per chunk: it publishes the chunk's copies (and, before the first, the
  // writes to As) and frees the stage the chunk kStages - 1 ahead is copied
  // into.  The barrier at the end frees As for the caller.
  __device__ __forceinline__ void product(float (&acc)[NI][4]) {
    clear(acc);
#pragma unroll 1
    for (int c = 0; c < C::kChunks; ++c) {
      mbar_wait(&bar[cur % S], (cur / S) & 1);
      __syncthreads();
      issue();
      chunk<T, L>(acc, As, ring + (cur % S) * C::kStage, c, me);
      ++cur;
    }
    __syncthreads();
  }
};

// K2's ring: kStages stages at the start of the block's shared memory and
// a full mbarrier a stage after the tile.  Chunk g of the stream goes to
// stage s = g % kStages.  Before chunk g (g > 0) the block's threads meet
// once all are done with chunk g - 1, thread 0 refills that stage with
// chunk g - 1 + kStages, and then every thread waits for chunk g's: the
// refill does not wait for chunk g to land (K4's ring waits for it first).
template <typename T, int L>
struct EdgeRingFeed {
  using C = EdgeTile<T, L>;
  using R = EdgeRing<T, L>;
  static constexpr int S = R::kStages;

  unsigned char* ring;
  uint64_t* full;
  const unsigned char* stream;
  int total;  // chunks in the launch's stream

  // Thread 0 initialises the mbarriers and copies the first kStages chunks.
  __device__ __forceinline__ EdgeRingFeed(unsigned char* smem, const unsigned char* stream_,
                                          int total_)
      : ring(smem), stream(stream_), total(total_) {
    full = reinterpret_cast<uint64_t*>(smem + S * C::kStage + C::kA + R::kRed + C::kIdx);
    if (threadIdx.x == 0) {
      for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
      for (int g = 0; g < S && g < total; ++g) fill(g);
    }
  }

  __device__ __forceinline__ const unsigned char* stage(int g) const {
    return ring + (g % S) * C::kStage;
  }

  // Thread 0: chunk g into its stage.
  __device__ __forceinline__ void fill(int g) const {
    bulk_copy(ring + (g % S) * C::kStage, stream + static_cast<size_t>(g) * C::kStage,
              static_cast<uint32_t>(C::kStage), &full[g % S]);
  }

  // With g > 0, every thread is done with chunk g - 1: its stage takes
  // chunk g - 1 + kStages at once, before anyone waits for chunk g's.
  __device__ __forceinline__ void acquire(int g) const {
    if (g > 0) {
      __syncthreads();
      if (threadIdx.x == 0 && g - 1 + S < total) fill(g - 1 + S);
    }
    mbar_wait(&full[g % S], (g / S) & 1);
  }
};

// K2's tile, fed by EdgeRingFeed.
template <typename T, int L>
struct EdgeRoundTile {
  using C = EdgeTile<T, L>;
  using R = EdgeRing<T, L>;
  static constexpr int NI = C::NI;

  T* As;
  float* red;
  int *rid, *snd, *rcv;
  TileLane me;
  const T* e;
  const EdgeRingFeed<T, L>& ring;
  int cur;  // the next chunk of the stream

  // Carves the tile's shared memory, starts copying its e rows (their row
  // numbers are the tile's own, so before its indices arrive) and loads its
  // edge indices (the block's threads meet before they are read).
  __device__ __forceinline__ EdgeRoundTile(unsigned char* smem, const EdgeRingFeed<T, L>& ring_,
                                           const T* e_, const int* senders, const int* receivers,
                                           int n_edges)
      : me(threadIdx.x, C::kWarpCols), e(e_), ring(ring_), cur(0) {
    unsigned char* base = smem + R::kStages * C::kStage;
    As = reinterpret_cast<T*>(base);
    red = reinterpret_cast<float*>(base + C::kA);
    rid = reinterpret_cast<int*>(base + C::kA + R::kRed);
    snd = rid + C::kRows;
    rcv = snd + C::kRows;
    const int row0 = blockIdx.x * C::kRows;
    constexpr int E = 16 / sizeof(T), OPS = L / E;
    for (int i = me.tid; i < C::kRows * OPS; i += C::kThreads) {
      const int r = i / OPS, col = (i % OPS) * E;
      const bool ok = row0 + r < n_edges;
      cp_async16(As + r * C::PA + col, e + static_cast<size_t>(ok ? row0 + r : 0) * L + col, ok);
    }
    cp_async_commit();
    load_rows<C::kRows, C::kThreads>(rid, snd, rcv, row0, me.tid, senders, receivers, n_edges);
    __syncthreads();
  }

  __device__ __forceinline__ void gather_e() { cp_async_wait<0>(); }

  // acc = As (64 x L) . B over the next product of the stream.  The block
  // barrier publishes the writes to As (and frees As at the end); each
  // chunk waits for its stage (EdgeRingFeed::acquire).
  __device__ __forceinline__ void product(float (&acc)[NI][4]) {
    __syncthreads();
    clear(acc);
#pragma unroll 1
    for (int c = 0; c < C::kChunks; ++c) {
      ring.acquire(cur);
      chunk<T, L, true>(acc, As, ring.stage(cur), c, me);
      ++cur;
    }
    __syncthreads();
  }
};

// Per-row sums over all L columns of Q statistics: s[q][h] holds this
// lane's part for its row g (h = 0) or g + 8 (h = 1); on return every lane
// holds the row totals.  Fixed order: the lane's columns, the quad, then the
// column groups in order.
template <typename T, int L, int Q>
__device__ __forceinline__ void row_sums(float (&s)[Q][2], float* red, const TileLane& me) {
  using C = EdgeTile<T, L>;
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s[q][h] += __shfl_xor_sync(0xffffffffu, s[q][h], 1);
      s[q][h] += __shfl_xor_sync(0xffffffffu, s[q][h], 2);
    }
  if constexpr (C::kColGroups > 1) {
    if (me.t == 0) {
#pragma unroll
      for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h) red[(me.cg * 2 + q) * C::kRows + me.row[h]] = s[q][h];
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = 0.f;
#pragma unroll
        for (int g = 0; g < C::kColGroups; ++g) v += red[(g * 2 + q) * C::kRows + me.row[h]];
        s[q][h] = v;
      }
    __syncthreads();
  }
}

// Write acc (rounded to T) to As at the fragment positions and, for the
// valid rows, to the (rows, L) output out where there is one.
template <typename T, int L>
__device__ __forceinline__ void put_rows(const float (&acc)[EdgeTile<T, L>::NI][4], T* As,
                                         T* out, const int (&grow)[2], const TileLane& me) {
  using C = EdgeTile<T, L>;
#pragma unroll
  for (int j = 0; j < C::NI; ++j) {
    const int col = me.nb + j * 8 + 2 * me.t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      Pair<T>::store(As + me.row[h] * C::PA + col, acc[j][2 * h], acc[j][2 * h + 1]);
      if (out != nullptr && grow[h] >= 0)
        Pair<T>::store(out + static_cast<size_t>(grow[h]) * L + col, acc[j][2 * h],
                       acc[j][2 * h + 1]);
    }
  }
}

// acc = rnd(rnd(acc) + b) over the fragment's columns.
template <typename T, int L>
__device__ __forceinline__ void add_bias(float (&acc)[EdgeTile<T, L>::NI][4], const T* b,
                                         const TileLane& me) {
  using C = EdgeTile<T, L>;
#pragma unroll
  for (int j = 0; j < C::NI; ++j) {
    float b0, b1;
    Pair<T>::load(b + me.nb + j * 8 + 2 * me.t, b0, b1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      acc[j][2 * h] = rnd<T>(rnd<T>(acc[j][2 * h]) + b0);
      acc[j][2 * h + 1] = rnd<T>(rnd<T>(acc[j][2 * h + 1]) + b1);
    }
  }
}

// The edge MLP's forward on a tile (K4's EdgeBlock or K2's EdgeRoundTile),
// as apply_mlp_parts rounds it with extra = P[s] + Q[r]: the first layer's
// e product, then the gathered f32 projections added once per element
// (rows past the last edge add nothing), the hidden layers with ReLU (each
// hidden layer's input also stored to post[layer - 1] where post is given:
// K4 keeps them for K6), the LayerNorm statistics.  Leaves xhat (f32) in
// acc and each row's rstd; the stream's first n_layers products are this
// forward's.
template <typename T, int L, typename Block>
__device__ __forceinline__ void edge_mlp_forward(Block& b, float (&acc)[EdgeTile<T, L>::NI][4],
                                                 const MlpParams& p, const float* P,
                                                 const float* Q, void* const* post,
                                                 const int (&grow)[2], float (&rstd)[2]) {
  using C = EdgeTile<T, L>;
  constexpr int NI = C::NI;
  b.gather_e();
  b.product(acc);
  add_projections(acc, P, Q, b.snd, b.rcv, L, b.me);
  add_bias<T, L>(acc, static_cast<const T*>(p.b[0]), b.me);
#pragma unroll 1
  for (int layer = 1; layer < p.n_layers; ++layer) {
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[j][k] = fmaxf(acc[j][k], 0.f);
    put_rows<T, L>(acc, b.As, post ? static_cast<T*>(post[layer - 1]) : nullptr, grow, b.me);
    b.product(acc);
    add_bias<T, L>(acc, static_cast<const T*>(p.b[layer]), b.me);
  }

  // LayerNorm statistics (f32, two passes as the plain version) over the
  // real width p.real, then xhat in acc: a padded column (p.real <= col < L)
  // adds nothing to either sum and gets xhat = 0.  At p.real = L every select
  // keeps its value and the division by a power of two is the old product
  // by its reciprocal, so a built width keeps its bits.
  const float real = static_cast<float>(p.real);
  float s[1][2] = {{0.f, 0.f}};
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    const int col = b.me.nb + j * 8 + 2 * b.me.t;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      s[0][h] += (col < p.real ? acc[j][2 * h] : 0.f) +
                 (col + 1 < p.real ? acc[j][2 * h + 1] : 0.f);
  }
  row_sums<T, L, 1>(s, b.red, b.me);
  const float mean[2] = {s[0][0] / real, s[0][1] / real};
  float d[1][2] = {{0.f, 0.f}};
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    const int col = b.me.nb + j * 8 + 2 * b.me.t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float x = col < p.real ? acc[j][2 * h] - mean[h] : 0.f;
      const float y = col + 1 < p.real ? acc[j][2 * h + 1] - mean[h] : 0.f;
      d[0][h] += x * x + y * y;
    }
  }
  row_sums<T, L, 1>(d, b.red, b.me);
#pragma unroll
  for (int h = 0; h < 2; ++h) rstd[h] = 1.0f / sqrtf(d[0][h] / real + 1e-5f);
#pragma unroll
  for (int j = 0; j < NI; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int col = b.me.nb + j * 8 + 2 * b.me.t + (k & 1);
      acc[j][k] = col < p.real ? (acc[j][k] - mean[k / 2]) * rstd[k / 2] : 0.f;
    }
}

}  // namespace mgn
