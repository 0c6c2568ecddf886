// K4 (edge_round_bwd), K5 (node_round_bwd) and K8 (first_layer_adjoint) —
// the reverse of one processor round for Hopper (sm_90a).  With K6
// (wgrad.cu) and K1 (csr_segment.cu, receiver rows and, through a sender
// permutation, sender rows) they replace the TPU backward kernel
// mgn_tpu/ops/fused.py:_pallas_backward (body _make_bwd_kernel, MLP adjoint
// _mlp_bwd; its HBM-streaming twin _make_bwd_kernel_stream), which runs all
// mps rounds in reverse in one call.
//
// The host loop in ops/fused.py (_FusedProcess.backward) runs, per round r
// from mps-1 down to 0, on the residuals the forward saved (v_r, e_r and the
// compute-dtype aggregate agg_r):
//
//   K5, per node:  recompute upd = LN(MLP_n([v_r, agg_r])); with dupd = dv,
//                  dv += dv_part (in place), dagg = d agg_r (f32 out)
//   K6             node-MLP weight, bias and LayerNorm gradients
//   K7             P, Q = v_r.W0[L:2L], v_r.W0[2L:3L] (fused_round.cu)
//   K4, per edge:  recompute LN(MLP_e) with the first layer
//                  (P[s] + Q[r]) + e_r.W0[0:L], as K2 ran it;
//                  dmsg = (de + dagg[r]) * edge_valid;
//                  de += de_part (in place), and dh0 (the first layer's
//                  pre-activation cotangent) for K6
// then, where E >= N, the TPU backward's defer_first form (:785-794,
// :966-971, :1071-1094; every mesh of the repo):
//   K1 twice       G_r = sum over receivers of dh0, G_s = sum over senders (f32)
//   K8, per node:  dv += rnd(G_s.W0[L:2L]^T + G_r.W0[2L:3L]^T)
//   K6             edge-MLP gradients, dW0[L:2L] = v_r^T G_s and
//                  dW0[2L:3L] = v_r^T G_r as N-row products
// or else K4 also writes the per-edge dvs = dh0.W0[L:2L]^T and dvr =
// dh0.W0[2L:3L]^T (rounded to T), and
//   K1 twice       dv += sum over receivers of dvr + sum over senders of dvs
//   K6             edge-MLP weight, bias and LayerNorm gradients
//
// K4 and K5 also write, for K6, each layer's pre-activation cotangent dh_l
// and post-ReLU activations (the inputs of layers 1..n-1), both in the
// compute dtype T, and partial sums of the LayerNorm gradients (sum of
// dy * xhat and of dy, f32) per group of rows: one row per 64-edge tile in
// K4, per 16-node tile in K5.  So no reduction across rows happens here and no
// atomics are needed; K6 reduces in a fixed order.
//
// Rounding follows the JAX package's _mlp_bwd: LayerNorm backward in f32,
// cotangents rounded to T after each adjoint product and carried in T;
// the ReLU mask is post > 0 (== pre > 0).  dmsg is multiplied by edge_valid,
// since the port's forward masks messages (process_rounds_xla does; the TPU
// forward kernel does not), so a dead edge gets no gradient at all.
//
// K4 replaces the edge stage of _make_bwd_kernel (mgn_tpu/ops/fused.py:888),
// with its pre-projected recompute (:895-906, :943-949).
// Bound on this card, a cylinder round (E_pad 11,264, L 128, 2 hidden
// layers): (3 + 5) L^2 MACs per edge (recompute + adjoint), 2.95 GFLOP —
// 17.9 us at the 3xTF32 rate (495/3 TFLOP/s) in f32, 3.0 us at 989 TFLOP/s
// in bf16 — against about 61 MB (f32) or 32 MB (bf16) read and written once
// (18 and 9.6 us at 3.35 TB/s).  So f32 is bound by the tensor-core work and
// bf16 by the bytes, most of them the dh and post outputs K6 reads.  The
// defer form (null dvs and dvr) runs 6 of the 8 products and writes 11.5 MB
// less in f32: 2.21 GFLOP (13.4 us) against about 49.5 MB (14.8 us).
// Design: a block owns a tile of 64 edges (edge_tile.cuh, shared with K2)
// and runs every product of the round on the tensor cores with f32
// accumulators in registers: the recompute is edge_tile.cuh's
// edge_mlp_forward, the very routine K2 runs (so the recomputed ReLU masks
// see the values K2 produced), then the adjoint (the hidden layers, then
// the first layer per part, giving de_part, dvs, dvr) on the same tile.
// - B is always K-contiguous.  All 4 + 2 (n_layers - 1) products stream,
//   one K-chunk at a time, through the tile's shared-memory ring across
//   product boundaries (every block reads the same weights, which stay in
//   L2), from the round's row of the edge weight stream that
//   weight_streams_kernel (fused_round.cu) lays out once per forward: K2's
//   forward products (W0's e rows, then the hidden layers), then the
//   adjoint's (the hidden layers' W_l, l = n-1 .. 1, and the first layer's
//   three row blocks of W0, each as B = W^T).  The defer form reads the
//   stream only up to W0's e block: its ring stops issuing copies there
//   (EdgeBlock's product count), so no copy is in flight when it exits.
//   The forward that needs a gradient asks for both and saves the stream
//   for the backward, so the layout is made by one kernel in one launch
//   per training step.  Every chunk is the image of a ring stage (f32: TF32
//   high and low planes in wgmma's core-matrix layout; bf16: K-contiguous
//   rows padded to the ring's pitch), so one bulk copy (cp.async.bulk, the
//   copy engine TMA drives) fills a stage: no tensor map is needed, and the
//   16 copies each thread issued per chunk with cp.async are gone (f32,
//   cylinder round on an H100 80GB HBM3 at 700 W: 0.0901 ms against 0.1010
//   ms, chip_smoke.py's K4 timing of both versions in one run).
// - bf16: mma.sync m16n8k16 per warp, B fragments read from the ring's rows
//   (wgmma would take them from shared memory too; mma.sync already met the
//   bf16 target, so bf16 K4 kept the route K6 uses).
// - f32: 3xTF32 on wgmma m64n128k8 (m64n64k8 at L = 64), A from registers
//   (split by each warp), B from the ring.  Each pair of K-steps starts a
//   fresh accumulator that is then added in round-to-nearest f32: the
//   tensor cores truncate as they accumulate, and a longer run per
//   accumulator leaves the recomputed ReLU inputs further from an f64
//   reference than cuBLAS's f32 products, so more ReLU decisions differ from
//   the plain path's.  chip_smoke.py reports both errors.
// - LayerNorm statistics and backward run on the accumulator fragments: a
//   row's sums are quad shuffles plus a fixed-order combine of the column
//   groups through shared memory where there are several.
// - 176 tiles at the cylinder size fill the 132 SMs at up to two blocks each
//   (104 KB of shared memory and 128 threads a block at L = 128 in f32), so
//   every tile runs in the first wave; a taller tile would leave SMs idle
//   and a shorter one is below wgmma's 64 rows.
//
// K5 replaces the node stage of _make_bwd_kernel (mgn_tpu/ops/fused.py:855).
// Bound on this card, a cylinder round (N_pad 1,920, L 128, 2 hidden
// layers): (4 + 4) L^2 MACs per node (recompute + adjoint), 0.50 GFLOP —
// 3.05 us at the 3xTF32 rate in f32, 0.51 us in bf16 — against 10.5 MB
// (f32) or 5.8 MB (bf16) read and written once, most of them the dh and
// post outputs K6 reads (3.13 and 1.73 us at 3.35 TB/s).
// Design: K3's 16-node tile (node_tile.cuh; 4 warps split the L columns,
// mma.sync, one weight ring per block), so the recompute of
// LN(MLP_n([v, rnd(agg)])) is NodeBlock::mlp_forward, the very arithmetic
// K3 ran — the first-layer accumulator starting from extra where it is
// given — and the recomputed ReLU masks are K3's.
// - Weights: the round's row of the node stream weight_streams_kernel
//   (fused_round.cu) lays out once per forward made for a gradient: K3's
//   products, then the adjoint's, B = W^T of the hidden layers n-1 .. 1 and
//   of W0's v and agg row blocks, in the same ring layout.  So the adjoint
//   runs through the same product routine as the recompute, and nothing is
//   transposed per backward.
// - In place: warps own column slices but read whole rows, so the tile
//   stages [v | agg] and the carry dv (= dy, the update's cotangent) into
//   shared memory before any warp writes dv; the recompute's ReLU masks
//   stay in shared memory (one bit per accumulator) besides going to post.
// - LayerNorm backward on the fragments: the row statistics combine the
//   warps' slices in a fixed order (NodeBlock::row_sum); the partial sums
//   [sum dy*xhat | sum dy] are summed over the tile's 16 rows in a fixed
//   order (rows g and g + 8, then lanes 4, 8 and 16 apart) and written as
//   one row per tile: each warp owns its columns, so no atomics.
// - The tail: dxtr = dh0 rounded to T, stored f32 (node_extra, the cloth
//   family's _make_bwd_kernel(node_extra=True), :812-820, :869-880); dv =
//   dy + rnd(dh0 . W0_v^T) in T; dagg = rnd(dh0 . W0_agg^T), stored f32.
//   Null extra/dxtr give the kernel without the offset; a zero extra gives
//   the same bits.

#include "node_tile.cuh"

namespace mgn {

// What the backward of one MLP round writes for K6 besides its outputs;
// the layout must match ops/_build.py's BwdParams.
struct BwdParams {
  void* dh[kMaxLayers];    // out: (rows, L) cotangent of layer i's pre-activation
  void* post[kMaxLayers];  // out: (rows, L) ReLU output feeding layer i+1
  float* ln_part;          // out: (groups, 2L): sum dy*xhat | sum dy per group
};
// (In namespace mgn and not in the file's unnamed namespace: the extern "C"
// entry points take it, and a type with internal linkage in their signature
// would give them internal linkage too, so the library would export nothing.)

}  // namespace mgn

namespace {

using mgn::BwdParams;
using mgn::MlpParams;
using mgn::kMaxLayers;

// --- K4: a tile of 64 edges per block, every product on the tensor cores ---

using mgn::EdgeTile;

template <typename T, int L>
__global__ void __launch_bounds__(EdgeTile<T, L>::kThreads, EdgeTile<T, L>::kMinBlocks)
edge_round_bwd_kernel(T* de, T* __restrict__ dvs, T* __restrict__ dvr,
                      const float* __restrict__ dagg, const T* __restrict__ e,
                      const float* __restrict__ P, const float* __restrict__ Q,
                      const int* __restrict__ senders, const int* __restrict__ receivers,
                      const T* __restrict__ edge_valid, int n_edges, MlpParams p, BwdParams q,
                      const unsigned char* __restrict__ wstream) {
  using C = EdgeTile<T, L>;
  using mgn::Pair;
  constexpr int NI = C::NI;
  extern __shared__ __align__(16) unsigned char smem[];
  // the weight stream: the recompute's 1 + H products, then the adjoint's H +
  // 3 (the defer form, null dvs and dvr: H + 1, the first layer's e block)
  const int H = p.n_layers - 1;  // hidden layers
  const int parts = dvs == nullptr ? 1 : 3;
  mgn::EdgeBlock<T, L> b(smem, wstream, 1 + 2 * H + parts, e, senders, receivers, n_edges);
  const mgn::TileLane& me = b.me;
  T* As = b.As;
  float* lnp = b.lnp;
  const int grow[2] = {b.rid[me.row[0]], b.rid[me.row[1]]};
  const int grcv[2] = {b.rcv[me.row[0]], b.rcv[me.row[1]]};

  // recompute: the edge MLP's forward as K2 runs it (xhat in acc)
  float acc[NI][4], rstd[2];
  mgn::edge_mlp_forward<T, L>(b, acc, p, P, Q, q.post, grow, rstd);

  // cotangent of the message: the residual carry plus the aggregate's,
  // masked.  It is a T value, so it waits in As (free until the adjoint)
  // at this thread's fragment positions rather than in 32 more registers.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float valid = grow[h] >= 0 ? mgn::to_f<T>(edge_valid[grow[h]]) : 0.f;
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int col = me.nb + j * 8 + 2 * me.t;
      float d0 = 0.f, d1 = 0.f, a0 = 0.f, a1 = 0.f;
      if (grow[h] >= 0) {
        Pair<T>::load(de + static_cast<size_t>(grow[h]) * L + col, d0, d1);
        Pair<float>::load(dagg + static_cast<size_t>(grcv[h]) * L + col, a0, a1);
      }
      Pair<T>::store(As + me.row[h] * C::PA + col,
                     mgn::rnd<T>(mgn::rnd<T>(d0 + mgn::rnd<T>(a0)) * valid),
                     mgn::rnd<T>(mgn::rnd<T>(d1 + mgn::rnd<T>(a1)) * valid));
    }
  }
  auto dy = [&](int j, int h, float& d0, float& d1) {
    Pair<T>::load(As + me.row[h] * C::PA + me.nb + j * 8 + 2 * me.t, d0, d1);
  };

  // LayerNorm partial sums of the tile: [sum dy*xhat | sum dy] per column,
  // rows g and g + 8, then over the 8 row pairs of the warp, then over the 4
  // row warps in order
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    float d[2][2];
    dy(j, 0, d[0][0], d[0][1]);
    dy(j, 1, d[1][0], d[1][1]);
    float sg[2], sb[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      sg[k] = d[0][k] * acc[j][k] + d[1][k] * acc[j][k + 2];
      sb[k] = d[0][k] + d[1][k];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        sg[k] += __shfl_xor_sync(0xffffffffu, sg[k], o);
        sb[k] += __shfl_xor_sync(0xffffffffu, sb[k], o);
      }
    }
    if (me.lane < 4) {
      const int col = me.nb + j * 8 + 2 * me.t;
      float* row = lnp + me.wm * 2 * L;
      row[col] = sg[0];
      row[col + 1] = sg[1];
      row[L + col] = sb[0];
      row[L + col + 1] = sb[1];
    }
  }
  __syncthreads();
  for (int i = me.tid; i < 2 * L; i += C::kThreads)
    q.ln_part[static_cast<size_t>(blockIdx.x) * 2 * L + i] =
        ((lnp[i] + lnp[2 * L + i]) + lnp[4 * L + i]) + lnp[6 * L + i];

  // LayerNorm backward: dh = (dxhat - mean(dxhat) - xhat mean(dxhat xhat)) rstd,
  // dxhat = dy * ln_scale
  {
    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      float sc0, sc1;
      Pair<float>::load(p.ln_scale + me.nb + j * 8 + 2 * me.t, sc0, sc1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float d0, d1;
        dy(j, h, d0, d1);
        d0 *= sc0;
        d1 *= sc1;
        s[0][h] += d0 + d1;
        s[1][h] += d0 * acc[j][2 * h] + d1 * acc[j][2 * h + 1];
      }
    }
    mgn::row_sums<T, L, 2>(s, b.red, me);
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      float sc0, sc1;
      Pair<float>::load(p.ln_scale + me.nb + j * 8 + 2 * me.t, sc0, sc1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float d0, d1;
        dy(j, h, d0, d1);
        const float m1 = s[0][h] / L, m2 = s[1][h] / L;
        acc[j][2 * h] = mgn::rnd<T>((d0 * sc0 - m1 - acc[j][2 * h] * m2) * rstd[h]);
        acc[j][2 * h + 1] = mgn::rnd<T>((d1 * sc1 - m1 - acc[j][2 * h + 1] * m2) * rstd[h]);
      }
    }
  }

  // adjoint of the hidden layers: dh_{l-1} = (dh_l . W_l^T) * (post_{l-1} > 0)
#pragma unroll 1
  for (int layer = H; layer >= 1; --layer) {
    mgn::put_rows<T, L>(acc, As, static_cast<T*>(q.dh[layer]), grow, me);
    b.product(acc);
    const T* post = static_cast<const T*>(q.post[layer - 1]);
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int col = me.nb + j * 8 + 2 * me.t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p0 = 0.f, p1 = 0.f;  // written by this thread in the recompute
        if (grow[h] >= 0) Pair<T>::load(post + static_cast<size_t>(grow[h]) * L + col, p0, p1);
        acc[j][2 * h] = p0 > 0.f ? mgn::rnd<T>(acc[j][2 * h]) : 0.f;
        acc[j][2 * h + 1] = p1 > 0.f ? mgn::rnd<T>(acc[j][2 * h + 1]) : 0.f;
      }
    }
  }
  mgn::put_rows<T, L>(acc, As, static_cast<T*>(q.dh[0]), grow, me);

  // first layer, part by part: de += dh0 W0_e^T, dvs = dh0 W0_s^T, dvr = dh0 W0_r^T
  // (the defer form: de alone)
#pragma unroll 1
  for (int part = 0; part < parts; ++part) {
    b.product(acc);
    // a select, not an array indexed by the loop: that would live in local memory
    T* out = part == 0 ? de : part == 1 ? dvs : dvr;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (grow[h] < 0) continue;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        T* dst = out + static_cast<size_t>(grow[h]) * L + me.nb + j * 8 + 2 * me.t;
        float o0 = mgn::rnd<T>(acc[j][2 * h]), o1 = mgn::rnd<T>(acc[j][2 * h + 1]);
        if (part == 0) {
          float d0, d1;
          Pair<T>::load(dst, d0, d1);
          o0 += d0;  // rounded to T by the store
          o1 += d1;
        }
        Pair<T>::store(dst, o0, o1);
      }
    }
  }
}

// --- K5: 16 node rows a block, K3's tile -----------------------------------

// K5's shared memory besides the tile's: the carry dv (= dy) staged, the
// recompute's ReLU masks, and the two row-sum buffers of the LayerNorm
// backward.
template <typename T, int L>
struct NodeBwdSmem {
  using Tile = mgn::NodeTile<T, L>;
  static_assert(Tile::NI * 4 <= 32, "a thread's ReLU mask of a layer fits one word");
  static constexpr size_t kDy = size_t(Tile::kRows) * Tile::PH * sizeof(T);
  static constexpr size_t kMasks = size_t(kMaxLayers - 1) * Tile::kThreads * sizeof(uint32_t);
  static constexpr size_t kRed = size_t(2) * Tile::kWarps * Tile::kRows * sizeof(float);
  static constexpr size_t kBytes = kDy + kMasks + kRed;
};

template <typename T, int L>
__global__ void __launch_bounds__(mgn::NodeTile<T, L>::kThreads)
node_round_bwd_kernel(T* dv, float* __restrict__ dagg, const T* __restrict__ v,
                      const T* __restrict__ agg, const float* __restrict__ extra,
                      float* __restrict__ dxtr, int n_nodes, MlpParams p, BwdParams q,
                      const T* __restrict__ wstream) {
  using O = NodeBwdSmem<T, L>;
  using Block = mgn::NodeBlock<T, L, O::kBytes>;
  using C = typename Block::C;
  using mgn::Pair;
  constexpr int NI = C::NI;
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.n_layers - 1;  // hidden layers
  // the round's node stream: the recompute's 2 + H products of L rows, then
  // the adjoint's H + 2
  Block b(smem, wstream, 2 * (2 + H), n_nodes);
  T* Ds = reinterpret_cast<T*>(b.own);
  uint32_t* masks = reinterpret_cast<uint32_t*>(b.own + O::kDy);
  float* red = reinterpret_cast<float*>(b.own + O::kDy + O::kMasks);
  b.template stage<2 * L>(b.As, C::PA, v, agg);
  b.template stage<L>(Ds, C::PH, dv, static_cast<const T*>(nullptr));
  auto dy = [&](int j, int h, float& d0, float& d1) {
    Pair<T>::load(Ds + (b.g + 8 * h) * C::PH + b.nb + j * 8 + 2 * b.t, d0, d1);
  };

  // recompute: K3's forward (posts and masks kept), then xhat in acc
  float acc[NI][4], mean[2], rstd[2];
  b.mlp_forward(acc, p, extra, q.post, masks);
  b.ln_stats(acc, mean, rstd);
#pragma unroll
  for (int j = 0; j < NI; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = (acc[j][k] - mean[k / 2]) * rstd[k / 2];

  // LayerNorm partial sums of the tile, [sum dy*xhat | sum dy] per column:
  // rows g and g + 8, then over the 8 row pairs (lanes 4, 8, 16 apart); the
  // warp's columns are its own, so lanes 0-3 write the tile's row
  float* lnp = q.ln_part + static_cast<size_t>(blockIdx.x) * 2 * L;
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    float d[2][2];
    dy(j, 0, d[0][0], d[0][1]);
    dy(j, 1, d[1][0], d[1][1]);
    float sg[2], sb[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      sg[k] = d[0][k] * acc[j][k] + d[1][k] * acc[j][k + 2];
      sb[k] = d[0][k] + d[1][k];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        sg[k] += __shfl_xor_sync(0xffffffffu, sg[k], o);
        sb[k] += __shfl_xor_sync(0xffffffffu, sb[k], o);
      }
    }
    if (b.lane < 4) {
      const int col = b.nb + j * 8 + 2 * b.t;
      Pair<float>::store(lnp + col, sg[0], sg[1]);
      Pair<float>::store(lnp + L + col, sb[0], sb[1]);
    }
  }

  // LayerNorm backward: dh = (dxhat - mean(dxhat) - xhat mean(dxhat xhat)) rstd,
  // dxhat = dy * ln_scale
  {
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      float sc0, sc1;
      Pair<float>::load(p.ln_scale + b.nb + j * 8 + 2 * b.t, sc0, sc1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float d0, d1;
        dy(j, h, d0, d1);
        d0 *= sc0;
        d1 *= sc1;
        s1[h] += d0 + d1;
        s2[h] += d0 * acc[j][2 * h] + d1 * acc[j][2 * h + 1];
      }
    }
    b.row_sum(s1, red);
    b.row_sum(s2, red + C::kWarps * C::kRows);
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      float sc0, sc1;
      Pair<float>::load(p.ln_scale + b.nb + j * 8 + 2 * b.t, sc0, sc1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float d0, d1;
        dy(j, h, d0, d1);
        const float m1 = s1[h] / L, m2 = s2[h] / L;
        acc[j][2 * h] = mgn::rnd<T>((d0 * sc0 - m1 - acc[j][2 * h] * m2) * rstd[h]);
        acc[j][2 * h + 1] = mgn::rnd<T>((d1 * sc1 - m1 - acc[j][2 * h + 1] * m2) * rstd[h]);
      }
    }
  }

  // dh (acc, T values) to Hs, the next product's A, and to out for the valid rows
  auto put = [&](void* out) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = b.g + 8 * h, row = b.row0 + r;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int col = b.nb + j * 8 + 2 * b.t;
        Pair<T>::store(b.Hs + r * C::PH + col, acc[j][2 * h], acc[j][2 * h + 1]);
        if (row < n_nodes)
          Pair<T>::store(static_cast<T*>(out) + static_cast<size_t>(row) * L + col,
                         acc[j][2 * h], acc[j][2 * h + 1]);
      }
    }
  };

  // adjoint of the hidden layers: dh_{l-1} = rnd(dh_l . W_l^T) * (post_{l-1} > 0)
#pragma unroll 1
  for (int layer = H; layer >= 1; --layer) {
    put(q.dh[layer]);
    b.clear(acc);
    b.product(acc, b.Hs, C::PH, L);
    const uint32_t m = masks[(layer - 1) * C::kThreads + b.tid];  // this thread's
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        acc[j][k] = (m >> (4 * j + k)) & 1u ? mgn::rnd<T>(acc[j][k]) : 0.f;
  }
  put(q.dh[0]);
  // the offset enters the first layer additively: its cotangent is dh0
  if (dxtr != nullptr) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = b.row0 + b.g + 8 * h;
      if (row >= n_nodes) continue;
#pragma unroll
      for (int j = 0; j < NI; ++j)
        Pair<float>::store(dxtr + static_cast<size_t>(row) * L + b.nb + j * 8 + 2 * b.t,
                           acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }

  // the first layer part by part: dv = dy + rnd(dh0 W0_v^T) (dy == dv here),
  // then dagg = rnd(dh0 W0_agg^T), the cotangent of agg_r, stored f32
#pragma unroll 1
  for (int part = 0; part < 2; ++part) {
    b.clear(acc);
    b.product(acc, b.Hs, C::PH, L);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = b.row0 + b.g + 8 * h;
      if (row >= n_nodes) continue;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int col = b.nb + j * 8 + 2 * b.t;
        const size_t off = static_cast<size_t>(row) * L + col;
        const float o0 = mgn::rnd<T>(acc[j][2 * h]), o1 = mgn::rnd<T>(acc[j][2 * h + 1]);
        if (part == 0) {
          float d0, d1;
          dy(j, h, d0, d1);
          Pair<T>::store(dv + off, d0 + o0, d1 + o1);  // rounded to T by the store
        } else {
          Pair<float>::store(dagg + off, o0, o1);
        }
      }
    }
  }
}

// --- K8: dv += rnd(G_s W0_s^T + G_r W0_r^T), 16 node rows a block -----------
//
// The end of a defer_first round (mgn_tpu/ops/fused.py:1071-1088): G_s and
// G_r are the f32 (N, L) sums of the edge MLP's first-layer cotangent dh0
// by sender and by receiver (K1), W0_s = W0[L:2L] and W0_r = W0[2L:3L] its
// sender and receiver row blocks.  Both products are f32 x f32, as JAX
// promotes a bf16 weight against the f32 sums: f32 on 3xTF32, bf16 as the
// weight's exact TF32 value against G's TF32 split (NodeBlock::product_f32);
// G is never rounded to bf16.  Each product in its own accumulator, the two
// added in f32, rounded once to T and added to dv in T, as the plain version
// orders it.
// Design: K3's 16-node tile (node_tile.cuh), NodeBlock::product twice as K7
// runs it, on the tile's 16 rows of [G_s | G_r] staged in f32 (the tile's
// A in f32; a region of the kernel's own in bf16, whose A is bf16); the
// weights are the round's projection stream past K7's part, B = W0_s^T then
// W0_r^T (laid out by the same weight_streams launch as every other
// stream).  120 blocks at the cylinder's 1,920 nodes.
// Bound on this card, a cylinder round (N_pad 1,920, L 128): 2 L^2 MACs a
// node, 0.126 GFLOP (0.76 us at the 3xTF32 rate, 1.9 us on the f32 CUDA
// cores), against about 4.1 MB (f32) read and written once (1.2 us).

template <typename T, int L>
struct AdjointSmem {
  static constexpr int PG = 2 * L + 4;  // f32 row pitch of [G_s | G_r] (NodeTile<float>::PA)
  // bf16: the f32 rows in the kernel's own region; f32: the tile's A holds them
  static constexpr size_t kBytes =
      sizeof(T) == 4 ? 0 : size_t(mgn::NodeTile<T, L>::kRows) * PG * sizeof(float);
};

template <typename T, int L>
__global__ void __launch_bounds__(mgn::NodeTile<T, L>::kThreads)
first_layer_adjoint_kernel(T* dv, const float* __restrict__ gs, const float* __restrict__ gr,
                           int n_nodes, const T* __restrict__ wstream) {
  using O = AdjointSmem<T, L>;
  using Block = mgn::NodeBlock<T, L, O::kBytes>;
  using C = typename Block::C;
  using mgn::Pair;
  constexpr int NI = C::NI;
  static_assert(sizeof(T) == 2 || C::PA == O::PG, "the f32 tile's A holds the G rows");
  extern __shared__ __align__(16) unsigned char smem[];
  // the round's projection stream past K7's part: W0_s^T's L rows, then W0_r^T's
  Block b(smem, wstream, 2, n_nodes);
  float* G = sizeof(T) == 4 ? reinterpret_cast<float*>(b.As) : reinterpret_cast<float*>(b.own);
  for (int i = b.tid; i < C::kRows * (L / 2); i += C::kThreads) {  // 4 floats a thread
    const int r = i / (L / 2), c = (i % (L / 2)) * 4, row = b.row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n_nodes)
      x = *reinterpret_cast<const float4*>((c < L ? gs : gr) + static_cast<size_t>(row) * L +
                                           c % L);
    *reinterpret_cast<float4*>(G + r * O::PG + c) = x;
  }
  // the first product's barrier publishes the staged rows; the loop is
  // unrolled so that both accumulators stay in registers
  float acc[2][NI][4];
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    b.clear(acc[part]);
    b.product_f32(acc[part], G + part * L, O::PG, L);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = b.row0 + b.g + 8 * h;
    if (row >= n_nodes) continue;
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      T* dst = dv + static_cast<size_t>(row) * L + b.nb + j * 8 + 2 * b.t;
      float d0, d1;
      Pair<T>::load(dst, d0, d1);
      const float o0 = mgn::rnd<T>(acc[0][j][2 * h] + acc[1][j][2 * h]);
      const float o1 = mgn::rnd<T>(acc[0][j][2 * h + 1] + acc[1][j][2 * h + 1]);
      Pair<T>::store(dst, d0 + o0, d1 + o1);  // rounded to T by the store
    }
  }
}

bool params_ok(const MlpParams* p, const BwdParams* q) {
  return p != nullptr && q != nullptr && p->n_layers >= 1 && p->n_layers <= kMaxLayers;
}

template <typename T, int L>
int launch_edge_bwd(void* de, void* dvs, void* dvr, const float* dagg, const void* e,
                    const float* P, const float* Q, const int* senders, const int* receivers,
                    const void* edge_valid, int n_edges, const MlpParams& p,
                    const BwdParams& q, const unsigned char* wstream, cudaStream_t s) {
  using C = EdgeTile<T, L>;
  const cudaError_t rc = cudaFuncSetAttribute(
      edge_round_bwd_kernel<T, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((n_edges + C::kRows - 1) / C::kRows), block(C::kThreads);
  edge_round_bwd_kernel<T, L><<<grid, block, C::kSmem, s>>>(
      static_cast<T*>(de), static_cast<T*>(dvs), static_cast<T*>(dvr), dagg,
      static_cast<const T*>(e), P, Q, senders, receivers,
      static_cast<const T*>(edge_valid), n_edges, p, q, wstream);
  return 0;
}

template <typename T, int L>
int launch_node_bwd(void* dv, float* dagg, const void* v, const void* agg, const float* extra,
                    float* dxtr, int n_nodes, const MlpParams& p, const BwdParams& q,
                    const void* wstream, cudaStream_t s) {
  using C = mgn::NodeTile<T, L, NodeBwdSmem<T, L>::kBytes>;
  const cudaError_t rc = cudaFuncSetAttribute(
      node_round_bwd_kernel<T, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((n_nodes + C::kRows - 1) / C::kRows), block(C::kThreads);
  node_round_bwd_kernel<T, L><<<grid, block, C::kSmem, s>>>(
      static_cast<T*>(dv), dagg, static_cast<const T*>(v), static_cast<const T*>(agg), extra,
      dxtr, n_nodes, p, q, static_cast<const T*>(wstream));
  return 0;
}

// K8's dynamic shared memory, set once per device by
// mgn_first_layer_adjoint_init (not before every launch).
template <typename T, int L>
int init_adjoint() {
  using C = mgn::NodeTile<T, L, AdjointSmem<T, L>::kBytes>;
  return static_cast<int>(cudaFuncSetAttribute(first_layer_adjoint_kernel<T, L>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(C::kSmem)));
}

template <typename T, int L>
int launch_adjoint(void* dv, const float* gs, const float* gr, int n_nodes, const void* wstream,
                   cudaStream_t s) {
  using C = mgn::NodeTile<T, L, AdjointSmem<T, L>::kBytes>;
  const dim3 grid((n_nodes + C::kRows - 1) / C::kRows), block(C::kThreads);
  first_layer_adjoint_kernel<T, L><<<grid, block, C::kSmem, s>>>(
      static_cast<T*>(dv), gs, gr, n_nodes, static_cast<const T*>(wstream));
  return 0;
}

// Dispatch over the latent widths (ops/fused.py's _KERNEL_LATENTS); returns
// a CUDA error code, cudaErrorInvalidValue for a width it is not built for.
template <typename T>
int edge_bwd_any(int latent, void* de, void* dvs, void* dvr, const float* dagg,
                 const void* e, const float* P, const float* Q, const int* senders,
                 const int* receivers, const void* edge_valid, int n_edges, const MlpParams& p,
                 const BwdParams& q, const unsigned char* wstream, cudaStream_t s) {
#define MGN_EDGE_BWD(Lc)                                                              \
  case Lc:                                                                            \
    return launch_edge_bwd<T, Lc>(de, dvs, dvr, dagg, e, P, Q, senders, receivers,    \
                                  edge_valid, n_edges, p, q, wstream, s);
  switch (latent) {
    MGN_EDGE_BWD(32)
    MGN_EDGE_BWD(64)
    MGN_EDGE_BWD(128)
    MGN_EDGE_BWD(256)
    default: return cudaErrorInvalidValue;
  }
#undef MGN_EDGE_BWD
}

template <typename T>
int node_bwd_any(int latent, void* dv, float* dagg, const void* v, const void* agg,
                 const float* extra, float* dxtr, int n_nodes, const MlpParams& p,
                 const BwdParams& q, const void* wstream, cudaStream_t s) {
#define MGN_NODE_BWD(Lc)                                                              \
  case Lc:                                                                            \
    return launch_node_bwd<T, Lc>(dv, dagg, v, agg, extra, dxtr, n_nodes, p, q, wstream, s);
  switch (latent) {
    MGN_NODE_BWD(32)
    MGN_NODE_BWD(64)
    MGN_NODE_BWD(128)
    MGN_NODE_BWD(256)
    default: return cudaErrorInvalidValue;
  }
#undef MGN_NODE_BWD
}

template <typename T>
int init_adjoint_all() {
  int rc = init_adjoint<T, 32>();
  if (rc == 0) rc = init_adjoint<T, 64>();
  if (rc == 0) rc = init_adjoint<T, 128>();
  if (rc == 0) rc = init_adjoint<T, 256>();
  return rc;
}

template <typename T>
int adjoint_any(int latent, void* dv, const float* gs, const float* gr, int n_nodes,
                const void* wstream, cudaStream_t s) {
  switch (latent) {
    case 32: return launch_adjoint<T, 32>(dv, gs, gr, n_nodes, wstream, s);
    case 64: return launch_adjoint<T, 64>(dv, gs, gr, n_nodes, wstream, s);
    case 128: return launch_adjoint<T, 128>(dv, gs, gr, n_nodes, wstream, s);
    case 256: return launch_adjoint<T, 256>(dv, gs, gr, n_nodes, wstream, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (the compute dtype of de, dvs, dvr, e,
// edge_valid, the weights and the dh/post outputs).  de is updated in place;
// dvs, dvr and q's dh, post and ln_part outputs are written; dvs and dvr
// both null: the defer_first form, which stops after de; P and Q are
// K7's f32 projections of the round's saved v; wstream is the round's row
// of mgn_weight_streams' edge stream made with its adjoint products.
// Returns cudaGetLastError() after the launch (0 on success).
int mgn_edge_round_bwd(int dtype, int latent, void* de, void* dvs, void* dvr,
                       const float* dagg, const void* e, const float* P, const float* Q,
                       const int* senders, const int* receivers, const void* edge_valid,
                       int n_edges, const MlpParams* params, const BwdParams* bwd,
                       const void* wstream, void* stream) {
  if (n_edges <= 0 || !params_ok(params, bwd) || wstream == nullptr || P == nullptr ||
      Q == nullptr || (dvs == nullptr) != (dvr == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ws = static_cast<const unsigned char*>(wstream);
  int rc = cudaErrorInvalidValue;
  if (dtype == 0) {
    rc = edge_bwd_any<float>(latent, de, dvs, dvr, dagg, e, P, Q, senders, receivers,
                             edge_valid, n_edges, *params, *bwd, ws, s);
  } else if (dtype == 1) {
    rc = edge_bwd_any<__nv_bfloat16>(latent, de, dvs, dvr, dagg, e, P, Q, senders,
                                     receivers, edge_valid, n_edges, *params, *bwd, ws, s);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// dv (compute dtype) is updated in place; dagg (f32) and q's outputs are
// written; v and agg are the round's saved inputs (compute dtype).  extra
// (f32 (n_nodes, L), node_extra's first-layer offset) and dxtr (f32, its
// cotangent, written) are both given or both null; null gives the kernel
// without the offset.  wstream is the round's row of mgn_weight_streams'
// node stream made with its adjoint products.
int mgn_node_round_bwd(int dtype, int latent, void* dv, float* dagg, const void* v,
                       const void* agg, const float* extra, float* dxtr, int n_nodes,
                       const MlpParams* params, const BwdParams* bwd, const void* wstream,
                       void* stream) {
  if (n_nodes <= 0 || !params_ok(params, bwd) || (extra == nullptr) != (dxtr == nullptr) ||
      wstream == nullptr)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = cudaErrorInvalidValue;
  if (dtype == 0) {
    rc = node_bwd_any<float>(latent, dv, dagg, v, agg, extra, dxtr, n_nodes, *params, *bwd,
                             wstream, s);
  } else if (dtype == 1) {
    rc = node_bwd_any<__nv_bfloat16>(latent, dv, dagg, v, agg, extra, dxtr, n_nodes, *params,
                                     *bwd, wstream, s);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// K8's shared-memory attributes for every dtype and width, on the current
// device; once before its first launch there.
int mgn_first_layer_adjoint_init() {
  const int rc = init_adjoint_all<float>();
  return rc != 0 ? rc : init_adjoint_all<__nv_bfloat16>();
}

// K8: dv (compute dtype, (n_nodes, latent)) += rnd(gs.W0_s^T + gr.W0_r^T);
// gs and gr are f32 (n_nodes, latent); wstream is the part past K7's of
// the round's row of mgn_weight_streams' projection stream made with its
// adjoint products.
int mgn_first_layer_adjoint(int dtype, int latent, void* dv, const float* gs, const float* gr,
                            int n_nodes, const void* wstream, void* stream) {
  if (n_nodes <= 0 || dv == nullptr || gs == nullptr || gr == nullptr || wstream == nullptr)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = cudaErrorInvalidValue;
  if (dtype == 0) {
    rc = adjoint_any<float>(latent, dv, gs, gr, n_nodes, wstream, s);
  } else if (dtype == 1) {
    rc = adjoint_any<__nv_bfloat16>(latent, dv, gs, gr, n_nodes, wstream, s);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* mgn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
