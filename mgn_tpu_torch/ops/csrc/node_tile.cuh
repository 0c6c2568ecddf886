// The 16-node tile shared by K3 (node_round, fused_round.cu) and K5
// (node_round_bwd, fused_round_bwd.cu): the node MLP's forward on the
// tensor cores, written once so that K5's recompute is K3's arithmetic (the
// ReLU masks K5 recomputes are the ones K3 applied).
//
//   acc = [extra +] [v, rnd(agg)] . W0        (one 2L-deep product)
//   acc = ReLU(rnd(rnd(acc) + b)) . W_l + ...  (hidden layers)
//   mean, rstd                                 (LayerNorm statistics, f32, two passes)
//
// 64-row tiles would give 30 blocks for the cylinder's 1,920 nodes on 132
// SMs, so a block owns kRows = 16 node rows (120 blocks there, 104 at the
// flag's 1,664) and its 4 warps split the L columns, each running mma.sync
// m16n8 on its column slice (bf16 m16n8k16; f32 3xTF32 m16n8k8, the B
// operand split as it is read, KI K-steps' products interleaved so that
// they do not wait on one another, each K-step in a fresh accumulator).
// Warps own column slices but read whole rows, so A sits in shared memory:
// the first layer's input [v | rnd(agg)] is staged before the first
// product, each hidden layer's input is written there from the
// accumulators.  The weights stream through one shared-memory ring per
// block, a KC-row chunk at a time across product boundaries: each weight
// element is read from L2 once per 16 rows.  The stream comes prepared
// (weight_streams_kernel, stream_tile.cuh, once per forward) as rows of B
// (N-contiguous, padded to PW), so a chunk is one contiguous ring-stage
// image that one bulk copy (cp.async.bulk) fills, completing the stage's
// mbarrier.  K3 reads a round's forward products; K5 the same followed by
// its adjoint products.  The weights, the same for every block, come from
// L2 at some 12-16 GB/s per SM, which bounds the tile more than its
// products do.  LayerNorm row sums combine the warps' column slices in a
// fixed order through shared memory.
#pragma once

#include "edge_tile.cuh"

namespace mgn {

// Shapes of the tile at latent L; kOwn bytes of shared memory the kernel
// keeps for itself, after the ring (K3 none).
template <typename T, int L, size_t kOwn = 0>
struct NodeTile {
  static constexpr int kRows = 16;  // ops/fused.py _NODE_BWD_ROWS
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int WC = L / kWarps;  // columns per warp
  static constexpr int NI = WC / 8;      // 8-column MMA tiles per warp
  // weight rows a ring stage holds: 256 bytes of depth per column (f32 64
  // rows, a 34 KB stage at L = 128: fewer, larger bulk copies)
  static constexpr int KC = 256 / int(sizeof(T)) < L ? 256 / int(sizeof(T)) : L;
  // f32 K-steps whose products run interleaved (independent accumulators)
  static constexpr int KI = NI * 4 <= 16 ? 4 : 16 / NI;
  static_assert((KC / 8) % KI == 0, "a chunk holds whole groups of KI K-steps");
  static constexpr int PA = 2 * L + smem_pad_k<T>();  // [v | rnd(agg)] rows
  static constexpr int PH = L + smem_pad_k<T>();      // a hidden layer's input
  // ring rows (N-contiguous): 8 words apart for load_b_n, 16 bytes apart
  // in bank for ldmatrix
  static constexpr int PW = L + 8;
  static constexpr size_t kA = size_t(kRows) * PA * sizeof(T);
  static constexpr size_t kH = size_t(kRows) * PH * sizeof(T);
  static constexpr size_t kStage = size_t(KC) * PW * sizeof(T);
  static constexpr size_t kRed = size_t(2) * kWarps * kRows * sizeof(float);
  static constexpr size_t kBars = 8 * sizeof(uint64_t);
  static constexpr size_t kRing = kA + kH + kRed + kBars;  // where the ring starts
  // as deep a ring as the block's 227 KB allow, up to 6 stages
  static constexpr size_t kFit = (232448 - kRing - kOwn) / kStage;
  static constexpr int kStages = kFit < 6 ? int(kFit) : 6;
  static_assert(kStages >= 2, "the ring needs a stage in flight beside the one read");
  static constexpr size_t kSmem = kRing + kStages * kStage + kOwn;
};

// One block's tile: its shared memory, its rows and its weight stream (a
// round's row of weight_streams_kernel's node stream, L rows of PW values a
// product).  Constructed by every thread of the block at once (it
// synchronises them).
template <typename T, int L, size_t kOwn = 0>
struct NodeBlock {
  using C = NodeTile<T, L, kOwn>;
  using M = Mma<T>;
  static constexpr int NI = C::NI, S = C::kStages, KC = C::KC;

  T* As;
  T* Hs;
  float* red;
  uint64_t* bar;
  T* ring;
  unsigned char* own;  // the kernel's kOwn bytes
  const T* stream;
  int total, next, cur;
  int tid, lane, warp, g, t, nb, row0, n_nodes;

  // Carves shared memory and starts the stream of n_products products of
  // L weight rows each (the first layer counts as two).
  __device__ __forceinline__ NodeBlock(unsigned char* smem, const T* wstream, int n_products,
                                       int n_nodes_)
      : stream(wstream), n_nodes(n_nodes_) {
    As = reinterpret_cast<T*>(smem);
    Hs = reinterpret_cast<T*>(smem + C::kA);
    red = reinterpret_cast<float*>(smem + C::kA + C::kH);
    bar = reinterpret_cast<uint64_t*>(smem + C::kA + C::kH + C::kRed);
    ring = reinterpret_cast<T*>(smem + C::kRing);
    own = smem + C::kRing + S * C::kStage;
    tid = threadIdx.x;
    lane = tid % 32;
    warp = tid / 32;
    g = lane >> 2;
    t = lane & 3;
    nb = warp * C::WC;
    row0 = blockIdx.x * C::kRows;
    total = n_products * (L / KC);
    next = cur = 0;
    if (tid < S) mbar_init(&bar[tid]);
    __syncthreads();
    for (int k = 0; k < S - 1; ++k) issue();
  }

  // Copies the stream's next chunk (KC rows, one contiguous stage image)
  // into the ring, kStages - 1 ahead of the product that reads it; one bulk
  // copy completes the stage's mbarrier.
  __device__ __forceinline__ void issue() {
    if (next < total && tid == 0)
      bulk_copy(ring + (next % S) * (KC * C::PW), stream + static_cast<size_t>(next) * KC * C::PW,
                static_cast<uint32_t>(C::kStage), &bar[next % S]);
    ++next;
  }

  // dst's 16 rows (pitch) = [x0 | x1], W columns in all (x1 read only where
  // W > L), each value rounded to T, zeros past the last node.  Every warp
  // reads these rows before any warp writes x0 or x1 in place (the first
  // product's barrier).
  template <int W, typename X1>
  __device__ __forceinline__ void stage(T* dst, int pitch, const T* x0, const X1* x1) {
    constexpr int G = 4, RG = W / G;
    for (int i = tid; i < C::kRows * RG; i += C::kThreads) {
      const int r = i / RG, c = (i % RG) * G, row = row0 + r;
      float x[G] = {0.f, 0.f, 0.f, 0.f};
      if (row < n_nodes) {
        if (c < L) {
          load_pack<T, G>(x0 + static_cast<size_t>(row) * L + c, x);
        } else {
          load_pack<X1, G>(x1 + static_cast<size_t>(row) * L + c - L, x);
#pragma unroll
          for (int j = 0; j < G; ++j) x[j] = rnd<T>(x[j]);
        }
      }
      store_pack<T, G>(dst + r * pitch + c, x);
    }
  }

  __device__ __forceinline__ void clear(float (&acc)[NI][4]) {
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;
  }

  // acc += A (16 x depth, pitch) . the stream's next depth rows; one barrier
  // per chunk publishes its copies (and A's writes before the first) and
  // frees the stage the chunk kStages - 1 ahead goes to; the barrier at the
  // end frees A.
  __device__ __forceinline__ void product(float (&acc)[NI][4], const T* A, int pitch,
                                          int depth) {
#pragma unroll 1
    for (int c = 0; c < depth / KC; ++c) {
      mbar_wait(&bar[cur % S], (cur / S) & 1);
      __syncthreads();
      issue();
      const T* stage = ring + (cur % S) * (KC * C::PW);
      if constexpr (sizeof(T) == 4) {
        // Mma<float>::mma on KI K-steps and all NI tiles at once, so the
        // products of one K-step do not wait on each other's: per K-step a
        // fresh accumulator, lo*hi + hi*lo + hi*hi, added to acc in
        // round-to-nearest in K order
        constexpr int KI = C::KI;
#pragma unroll
        for (int k0 = 0; k0 < KC; k0 += 8 * KI) {
          typename M::A a[KI];
          typename M::B bf[KI][NI];
          float tt[KI][NI][4];
#pragma unroll
          for (int s = 0; s < KI; ++s) {
            M::load_a_k(a[s], A, pitch, 0, c * KC + k0 + 8 * s, lane);
#pragma unroll
            for (int j = 0; j < NI; ++j) {
              M::load_b_n(bf[s][j], stage, C::PW, nb + j * 8, k0 + 8 * s, lane);
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
      } else {
#pragma unroll
        for (int kk = 0; kk < KC; kk += M::K) {
          typename M::A a;
          M::load_a_k(a, A, pitch, 0, c * KC + kk, lane);
          typename M::B bf[NI];
#pragma unroll
          for (int j = 0; j + 1 < NI; j += 2)
            M::ldsm_b_n(bf[j], bf[j + 1], stage, C::PW, nb + j * 8, kk, lane);
          if constexpr (NI % 2 == 1)
            M::ldsm_b_n(bf[NI - 1], stage, C::PW, nb + (NI - 1) * 8, kk, lane);
#pragma unroll
          for (int j = 0; j < NI; ++j) M::mma(acc[j], a, bf[j]);
        }
      }
      ++cur;
    }
    __syncthreads();
  }

  // acc = rnd(rnd(acc) + b)
  __device__ __forceinline__ void add_bias(float (&acc)[NI][4], const T* bias) {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      float b0, b1;
      Pair<T>::load(bias + nb + j * 8 + 2 * t, b0, b1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc[j][2 * h] = rnd<T>(rnd<T>(acc[j][2 * h]) + b0);
        acc[j][2 * h + 1] = rnd<T>(rnd<T>(acc[j][2 * h + 1]) + b1);
      }
    }
  }

  // A row's sum over the warp's columns (quad shuffles), then over the 4
  // warps in order through buf (kWarps x kRows floats, written once a call:
  // a later call takes another buffer).
  __device__ __forceinline__ void row_sum(float (&s)[2], float* buf) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
      s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
      if (t == 0) buf[warp * C::kRows + g + 8 * h] = s[h];
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h;
      s[h] = ((buf[r] + buf[C::kRows + r]) + buf[2 * C::kRows + r]) + buf[3 * C::kRows + r];
    }
  }

  // The node MLP up to its LayerNorm on the staged [v | rnd(agg)] rows, as
  // apply_mlp_parts rounds it; leaves the last layer's output (T values)
  // in acc.  The first layer's accumulator starts from the rows of extra
  // where it is given (zeros past the last node), else from zeros.  Where
  // post is given (K5), each hidden layer's input is also stored to
  // post[layer - 1] for the valid rows and its ReLU mask to
  // masks[(layer - 1) * kThreads + tid], bit 4 j + k for acc[j][k].
  __device__ __forceinline__ void mlp_forward(float (&acc)[NI][4], const MlpParams& p,
                                              const float* extra, void* const* post,
                                              uint32_t* masks) {
    clear(acc);
    if (extra != nullptr) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + g + 8 * h;
        if (row >= n_nodes) continue;
#pragma unroll
        for (int j = 0; j < NI; ++j)
          Pair<float>::load(extra + static_cast<size_t>(row) * L + nb + j * 8 + 2 * t,
                            acc[j][2 * h], acc[j][2 * h + 1]);
      }
    }
    product(acc, As, C::PA, 2 * L);
    add_bias(acc, static_cast<const T*>(p.b[0]));
#pragma unroll 1
    for (int layer = 1; layer < p.n_layers; ++layer) {
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          Pair<T>::store(Hs + (g + 8 * h) * C::PH + nb + j * 8 + 2 * t,
                         fmaxf(acc[j][2 * h], 0.f), fmaxf(acc[j][2 * h + 1], 0.f));
      if (post != nullptr) {
        uint32_t m = 0;
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k) m |= (acc[j][k] > 0.f ? 1u : 0u) << (4 * j + k);
        masks[(layer - 1) * C::kThreads + tid] = m;
        T* out = static_cast<T*>(post[layer - 1]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + g + 8 * h;
          if (row >= n_nodes) continue;
#pragma unroll
          for (int j = 0; j < NI; ++j)
            Pair<T>::store(out + static_cast<size_t>(row) * L + nb + j * 8 + 2 * t,
                           fmaxf(acc[j][2 * h], 0.f), fmaxf(acc[j][2 * h + 1], 0.f));
        }
      }
      clear(acc);
      product(acc, Hs, C::PH, L);
      add_bias(acc, static_cast<const T*>(p.b[layer]));
    }
  }

  // LayerNorm statistics of the rows in acc (f32, two passes) over the real
  // width `real`, through the tile's two row-sum buffers: a padded column
  // (real <= col < L) adds nothing to either sum (at real = L the selects
  // keep every value and the division by a power of two is the old product
  // by its reciprocal: a built width keeps its bits).
  __device__ __forceinline__ void ln_stats(const float (&acc)[NI][4], int real,
                                           float (&mean)[2], float (&rstd)[2]) {
    const float n = static_cast<float>(real);
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int col = nb + j * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        s[h] += (col < real ? acc[j][2 * h] : 0.f) + (col + 1 < real ? acc[j][2 * h + 1] : 0.f);
    }
    row_sum(s, red);
    mean[0] = s[0] / n;
    mean[1] = s[1] / n;
    float d[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int col = nb + j * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float x = col < real ? acc[j][2 * h] - mean[h] : 0.f;
        const float y = col + 1 < real ? acc[j][2 * h + 1] - mean[h] : 0.f;
        d[h] += x * x + y * y;
      }
    }
    row_sum(d, red + C::kWarps * C::kRows);
#pragma unroll
    for (int h = 0; h < 2; ++h) rstd[h] = 1.0f / sqrtf(d[h] / n + 1e-5f);
  }

  // xhat in acc from ln_stats' statistics; 0 in the padded columns.
  __device__ __forceinline__ void ln_xhat(float (&acc)[NI][4], int real, const float (&mean)[2],
                                          const float (&rstd)[2]) {
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int col = nb + j * 8 + 2 * t + (k & 1);
        acc[j][k] = col < real ? (acc[j][k] - mean[k / 2]) * rstd[k / 2] : 0.f;
      }
  }
};

}  // namespace mgn
