// K4 (edge_round_bwd) and K5 (node_round_bwd) — the reverse of one processor
// round for Hopper (sm_90a).  With K6 (wgrad.cu) and K1 (csr_segment.cu,
// receiver rows and, through a sender permutation, sender rows) they replace
// the TPU backward kernel mgn_tpu/ops/fused.py:_pallas_backward (body
// _make_bwd_kernel, MLP adjoint _mlp_bwd; its HBM-streaming twin
// _make_bwd_kernel_stream), which runs all mps rounds in reverse in one call.
//
// The host loop in ops/fused.py (_FusedProcess.backward) runs, per round r
// from mps-1 down to 0, on the residuals the forward saved (v_r, e_r and the
// compute-dtype aggregate agg_r):
//
//   K5, per node:  recompute upd = LN(MLP_n([v_r, agg_r])); with dupd = dv,
//                  dv += dv_part (in place), dagg = d agg_r (f32 out)
//   K6             node-MLP weight, bias and LayerNorm gradients
//   K4, per edge:  recompute LN(MLP_e([e_r, v_r[s], v_r[r]]));
//                  dmsg = (de + dagg[r]) * edge_valid;
//                  de += de_part (in place), dvs, dvr out
//   K1 twice       dv += sum over receivers of dvr + sum over senders of dvs
//   K6             edge-MLP weight, bias and LayerNorm gradients
//
// K4 and K5 also write, for K6, each layer's pre-activation cotangent dh_l
// and post-ReLU activations (the inputs of layers 1..n-1), both in the
// compute dtype T, and partial sums of the LayerNorm gradients (sum of
// dy * xhat and of dy, f32) per group of rows: one row per 64-edge tile in
// K4, per 2-row warp in K5.  So no reduction across rows happens here and no
// atomics are needed; K6 reduces in a fixed order.
//
// Rounding follows the JAX package's _mlp_bwd: LayerNorm backward in f32,
// cotangents rounded to T after each adjoint product and carried in T;
// the ReLU mask is post > 0 (== pre > 0).  dmsg is multiplied by edge_valid,
// since the port's forward masks messages (process_rounds_xla does; the TPU
// forward kernel does not), so a dead edge gets no gradient at all.
//
// K4 replaces the edge stage of _make_bwd_kernel (mgn_tpu/ops/fused.py:888).
// Bound on this card, a cylinder round (E_pad 11,264, L 128, 2 hidden
// layers): (5 + 5) L^2 MACs per edge (recompute + adjoint), 3.69 GFLOP —
// 22.4 us at the 3xTF32 rate (495/3 TFLOP/s) in f32, 3.7 us at 989 TFLOP/s
// in bf16 — against about 60 MB (f32) or 30 MB (bf16) read and written once
// (18 and 9 us at 3.35 TB/s).  So f32 is bound by the tensor-core work and
// bf16 by the bytes, most of them the dh and post outputs K6 reads.
// Design: a block owns a tile of 64 edges (edge_tile.cuh, shared with K2)
// and runs every product of the round on the tensor cores with f32
// accumulators in registers: the recompute is edge_tile.cuh's
// edge_mlp_forward, the very routine K2 runs (so the recomputed ReLU masks
// see the values K2 produced), then the adjoint (the hidden layers, then
// the first layer per part, giving de_part, dvs, dvr) on the same tile.
// - B is always K-contiguous.  All 6 + 2 (n_layers - 1) products stream,
//   one K-chunk at a time, through the tile's shared-memory ring across
//   product boundaries (every block reads the same weights, which stay in
//   L2), from the round's row of the edge weight stream that
//   weight_streams_kernel (fused_round.cu) lays out once per forward: K2's
//   forward products, then the adjoint's (the hidden layers' W_l, l = n-1
//   .. 1, and the first layer's three row blocks of W0, each as B = W^T).
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
// K5 (node stage, :855) keeps the first slice's CUDA-core design
// (mlp_tile.cuh): a warp owns R rows and all L columns; weight rows stream
// through L1/L2; the adjoint products use weights the host transposed once
// per backward, so they run through the same warp_matmul as the forward.

#include "edge_tile.cuh"

namespace mgn {

// What the backward of one MLP round reads besides MlpParams, and writes for
// K6; the layout must match ops/_build.py's BwdParams.
struct BwdParams {
  const void* wt[kMaxLayers];  // K5's transposed weights: wt[0] (L, 2L), wt[i] (L, L)
  void* dh[kMaxLayers];        // out: (rows, L) cotangent of layer i's pre-activation
  void* post[kMaxLayers];      // out: (rows, L) ReLU output feeding layer i+1
  float* ln_part;              // out: (groups, 2L): sum dy*xhat | sum dy per group
};
// (In namespace mgn and not in the file's unnamed namespace: the extern "C"
// entry points take it, and a type with internal linkage in their signature
// would give them internal linkage too, so the library would export nothing.)

}  // namespace mgn

namespace {

using mgn::BwdParams;
using mgn::MlpParams;
using mgn::kMaxLayers;
using mgn::kTileWarps;

constexpr int kNodeRows = 2;  // rows per warp in K5 (ops/fused.py _NODE_BWD_ROWS)

template <typename T, int L, int R>
__device__ __forceinline__ void zero(float (&a)[R][L / 32]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < L / 32; ++j) a[i][j] = 0.f;
  }
}

// acc holds the first layer's f32 products.  Applies the biases and hidden
// layers as mgn::warp_mlp_tail does and stores each ReLU output to
// q.post[layer-1]; leaves the last layer's pre-LayerNorm output (rounded to
// T) in acc.
template <typename T, int L, int R>
__device__ __forceinline__ void warp_mlp_recompute(float (&acc)[R][L / 32], float* xs,
                                                   const MlpParams& p, const BwdParams& q,
                                                   const int (&rows)[R], int lane) {
  constexpr int C = L / 32;
  for (int layer = 0; layer < p.n_layers; ++layer) {
    if (layer > 0) {
      __syncwarp();
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float h[C];
#pragma unroll
        for (int j = 0; j < C; ++j) {
          h[j] = fmaxf(acc[i][j], 0.f);
          acc[i][j] = 0.f;
        }
        mgn::store_pack<float, C>(xs + i * L + lane * C, h);
        if (rows[i] >= 0)
          mgn::store_pack<T, C>(static_cast<T*>(q.post[layer - 1]) +
                                    static_cast<size_t>(rows[i]) * L + lane * C, h);
      }
      __syncwarp();
      mgn::warp_matmul<T, L, R>(acc, xs, static_cast<const T*>(p.w[layer]), lane);
    }
    float bias[C];
    mgn::load_pack<T, C>(static_cast<const T*>(p.b[layer]) + lane * C, bias);
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < C; ++j) acc[i][j] = mgn::rnd<T>(mgn::rnd<T>(acc[i][j]) + bias[j]);
    }
  }
}

// LayerNorm backward.  acc holds the pre-LayerNorm output h, dy the
// cotangent of the LayerNorm output (T values as f32).  Adds dy*xhat and dy
// of the valid rows to pg/pb; leaves dh (rounded to T) in acc.
template <typename T, int L, int R>
__device__ __forceinline__ void warp_ln_bwd(float (&acc)[R][L / 32],
                                            const float (&dy)[R][L / 32],
                                            const MlpParams& p, float (&pg)[L / 32],
                                            float (&pb)[L / 32], const int (&rows)[R],
                                            int lane) {
  constexpr int C = L / 32;
  float scale[C];
  mgn::load_pack<float, C>(p.ln_scale + lane * C, scale);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < C; ++j) s += acc[i][j];
    const float mean = mgn::warp_sum(s) / L;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const float d = acc[i][j] - mean;
      sq += d * d;
    }
    const float var = mgn::warp_sum(sq) / L;
    const float rstd = 1.0f / sqrtf(var + 1e-5f);
    float xhat[C], dxhat[C];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      xhat[j] = (acc[i][j] - mean) * rstd;
      if (rows[i] >= 0) {
        pg[j] += dy[i][j] * xhat[j];
        pb[j] += dy[i][j];
      }
      dxhat[j] = dy[i][j] * scale[j];
      s1 += dxhat[j];
      s2 += dxhat[j] * xhat[j];
    }
    const float m1 = mgn::warp_sum(s1) / L;
    const float m2 = mgn::warp_sum(s2) / L;
#pragma unroll
    for (int j = 0; j < C; ++j)
      acc[i][j] = mgn::rnd<T>((dxhat[j] - m1 - xhat[j] * m2) * rstd);
  }
}

// Backward through layers n-1 .. 1.  acc holds dh of the last layer; each
// dh_l is stored to q.dh[l].  Returns with dh_0 staged (f32) in xs, ready for
// the first layer's per-part adjoint products.
template <typename T, int L, int R>
__device__ __forceinline__ void warp_mlp_adjoint(float (&acc)[R][L / 32], float* xs,
                                                 const MlpParams& p, const BwdParams& q,
                                                 const int (&rows)[R], int lane) {
  constexpr int C = L / 32;
  for (int layer = p.n_layers - 1; layer >= 0; --layer) {
    __syncwarp();
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (rows[i] >= 0)
        mgn::store_pack<T, C>(static_cast<T*>(q.dh[layer]) +
                                  static_cast<size_t>(rows[i]) * L + lane * C, acc[i]);
      mgn::store_pack<float, C>(xs + i * L + lane * C, acc[i]);
    }
    __syncwarp();
    if (layer == 0) return;
    zero<T, L, R>(acc);
    mgn::warp_matmul<T, L, R>(acc, xs, static_cast<const T*>(q.wt[layer]), lane);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float post[C];
      if (rows[i] >= 0) {
        // written by this lane in warp_mlp_recompute: program order suffices
        mgn::load_pack<T, C>(static_cast<const T*>(q.post[layer - 1]) +
                                 static_cast<size_t>(rows[i]) * L + lane * C, post);
      } else {
#pragma unroll
        for (int j = 0; j < C; ++j) post[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < C; ++j) acc[i][j] = post[j] > 0.f ? mgn::rnd<T>(acc[i][j]) : 0.f;
    }
  }
}

template <int L>
__device__ __forceinline__ void store_ln_part(float* ln_part, int warp_id, const float* pg,
                                              const float* pb, int lane) {
  constexpr int C = L / 32;
  float* row = ln_part + static_cast<size_t>(warp_id) * 2 * L;
#pragma unroll
  for (int j = 0; j < C; ++j) {
    row[lane * C + j] = pg[j];
    row[L + lane * C + j] = pb[j];
  }
}

// --- K4: a tile of 64 edges per block, every product on the tensor cores ---

using mgn::EdgeTile;

template <typename T, int L>
__global__ void __launch_bounds__(EdgeTile<T, L>::kThreads, EdgeTile<T, L>::kMinBlocks)
edge_round_bwd_kernel(T* de, T* __restrict__ dvs, T* __restrict__ dvr,
                      const float* __restrict__ dagg, const T* __restrict__ e,
                      const T* __restrict__ v, const int* __restrict__ senders,
                      const int* __restrict__ receivers, const T* __restrict__ edge_valid,
                      int n_edges, MlpParams p, BwdParams q,
                      const unsigned char* __restrict__ wstream) {
  using C = EdgeTile<T, L>;
  using mgn::Pair;
  constexpr int NI = C::NI;
  extern __shared__ __align__(16) unsigned char smem[];
  // the weight stream: the recompute's 3 + H products, then the adjoint's H + 3
  const int H = p.n_layers - 1;  // hidden layers
  mgn::EdgeBlock<T, L> b(smem, wstream, 6 + 2 * H, e, v, senders, receivers, n_edges);
  const mgn::TileLane& me = b.me;
  T* As = b.As;
  float* lnp = b.lnp;
  const int grow[2] = {b.rid[me.row[0]], b.rid[me.row[1]]};
  const int grcv[2] = {b.rcv[me.row[0]], b.rcv[me.row[1]]};

  // recompute: the edge MLP's forward as K2 runs it (xhat in acc)
  float acc[NI][4], rstd[2];
  mgn::edge_mlp_forward<T, L>(b, acc, p, q.post, grow, rstd);

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
    b.product(acc, false, false, 0);
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
#pragma unroll 1
  for (int part = 0; part < 3; ++part) {
    b.product(acc, false, false, 0);
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

template <typename T, int L, int R>
__global__ void __launch_bounds__(kTileWarps * 32)
node_round_bwd_kernel(T* dv, float* __restrict__ dagg, const T* __restrict__ v,
                      const T* __restrict__ agg, int n_nodes, MlpParams p, BwdParams q) {
  constexpr int C = L / 32;
  __shared__ __align__(16) float smem[kTileWarps][R * L];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* xs = smem[warp];
  const int warp_id = blockIdx.x * kTileWarps + warp;
  const int row0 = warp_id * R;
  if (row0 >= n_nodes) return;

  int rows[R];
#pragma unroll
  for (int i = 0; i < R; ++i) rows[i] = row0 + i < n_nodes ? row0 + i : -1;

  float acc[R][C];
  zero<T, L, R>(acc);
  const T* w0 = static_cast<const T*>(p.w[0]);
  mgn::warp_stage<T, T, L, R>(xs, v, rows, lane);
  mgn::warp_matmul<T, L, R>(acc, xs, w0, lane);
  mgn::warp_stage<T, T, L, R>(xs, agg, rows, lane);
  mgn::warp_matmul<T, L, R>(acc, xs, w0 + L * L, lane);
  warp_mlp_recompute<T, L, R>(acc, xs, p, q, rows, lane);

  // v' = v + upd, so the update's cotangent is the carry dv itself
  float dy[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (rows[i] >= 0) {
      mgn::load_pack<T, C>(dv + static_cast<size_t>(rows[i]) * L + lane * C, dy[i]);
    } else {
#pragma unroll
      for (int j = 0; j < C; ++j) dy[i][j] = 0.f;
    }
  }
  float pg[C], pb[C];
#pragma unroll
  for (int j = 0; j < C; ++j) pg[j] = pb[j] = 0.f;
  warp_ln_bwd<T, L, R>(acc, dy, p, pg, pb, rows, lane);
  warp_mlp_adjoint<T, L, R>(acc, xs, p, q, rows, lane);

  const T* wt0 = static_cast<const T*>(q.wt[0]);
  // part 0: dv += dh0 W0_v^T
  zero<T, L, R>(acc);
  mgn::warp_matmul<T, L, R>(acc, xs, wt0, lane, 2 * L);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (rows[i] < 0) continue;
    const size_t off = static_cast<size_t>(rows[i]) * L + lane * C;
    float o[C];
#pragma unroll
    for (int j = 0; j < C; ++j) o[j] = dy[i][j] + mgn::rnd<T>(acc[i][j]);  // dy == dv here
    mgn::store_pack<T, C>(dv + off, o);
  }
  // part 1: dagg = dh0 W0_agg^T, rounded to T (the cotangent of agg_r) and stored f32
  zero<T, L, R>(acc);
  mgn::warp_matmul<T, L, R>(acc, xs, wt0 + L, lane, 2 * L);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (rows[i] < 0) continue;
    float o[C];
#pragma unroll
    for (int j = 0; j < C; ++j) o[j] = mgn::rnd<T>(acc[i][j]);
    mgn::store_pack<float, C>(dagg + static_cast<size_t>(rows[i]) * L + lane * C, o);
  }
  store_ln_part<L>(q.ln_part, warp_id, pg, pb, lane);
}

bool params_ok(const MlpParams* p, const BwdParams* q) {
  return p != nullptr && q != nullptr && p->n_layers >= 1 && p->n_layers <= kMaxLayers;
}

template <typename T, int L>
int launch_edge_bwd(void* de, void* dvs, void* dvr, const float* dagg, const void* e,
                    const void* v, const int* senders, const int* receivers,
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
      static_cast<const T*>(e), static_cast<const T*>(v), senders, receivers,
      static_cast<const T*>(edge_valid), n_edges, p, q, wstream);
  return 0;
}

template <typename T, int L>
void launch_node_bwd(void* dv, float* dagg, const void* v, const void* agg, int n_nodes,
                     const MlpParams& p, const BwdParams& q, cudaStream_t s) {
  constexpr int per_block = kTileWarps * kNodeRows;
  const dim3 grid((n_nodes + per_block - 1) / per_block), block(kTileWarps * 32);
  node_round_bwd_kernel<T, L, kNodeRows><<<grid, block, 0, s>>>(
      static_cast<T*>(dv), dagg, static_cast<const T*>(v), static_cast<const T*>(agg),
      n_nodes, p, q);
}

// Dispatch over the latent widths (ops/fused.py's _KERNEL_LATENTS); returns
// a CUDA error code, cudaErrorInvalidValue for a width it is not built for.
template <typename T>
int edge_bwd_any(int latent, void* de, void* dvs, void* dvr, const float* dagg,
                 const void* e, const void* v, const int* senders, const int* receivers,
                 const void* edge_valid, int n_edges, const MlpParams& p,
                 const BwdParams& q, const unsigned char* wstream, cudaStream_t s) {
#define MGN_EDGE_BWD(Lc)                                                              \
  case Lc:                                                                            \
    return launch_edge_bwd<T, Lc>(de, dvs, dvr, dagg, e, v, senders, receivers,       \
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
bool node_bwd_any(int latent, void* dv, float* dagg, const void* v, const void* agg,
                  int n_nodes, const MlpParams& p, const BwdParams& q, cudaStream_t s) {
  switch (latent) {
    case 32: launch_node_bwd<T, 32>(dv, dagg, v, agg, n_nodes, p, q, s); return true;
    case 64: launch_node_bwd<T, 64>(dv, dagg, v, agg, n_nodes, p, q, s); return true;
    case 128: launch_node_bwd<T, 128>(dv, dagg, v, agg, n_nodes, p, q, s); return true;
    case 256: launch_node_bwd<T, 256>(dv, dagg, v, agg, n_nodes, p, q, s); return true;
    default: return false;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (the compute dtype of de, dvs, dvr, e, v,
// edge_valid, the weights and the dh/post outputs).  de is updated in place;
// dvs, dvr and q's dh, post and ln_part outputs are written (q.wt is not
// read); wstream is the round's row of mgn_weight_streams' edge stream made
// with its adjoint products.  Returns cudaGetLastError() after the launch
// (0 on success).
int mgn_edge_round_bwd(int dtype, int latent, void* de, void* dvs, void* dvr,
                       const float* dagg, const void* e, const void* v, const int* senders,
                       const int* receivers, const void* edge_valid, int n_edges,
                       const MlpParams* params, const BwdParams* bwd, const void* wstream,
                       void* stream) {
  if (n_edges <= 0 || !params_ok(params, bwd) || wstream == nullptr)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ws = static_cast<const unsigned char*>(wstream);
  int rc = cudaErrorInvalidValue;
  if (dtype == 0) {
    rc = edge_bwd_any<float>(latent, de, dvs, dvr, dagg, e, v, senders, receivers, edge_valid,
                             n_edges, *params, *bwd, ws, s);
  } else if (dtype == 1) {
    rc = edge_bwd_any<__nv_bfloat16>(latent, de, dvs, dvr, dagg, e, v, senders, receivers,
                                     edge_valid, n_edges, *params, *bwd, ws, s);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// dv (compute dtype) is updated in place; dagg (f32) and q's outputs are
// written; v and agg are the round's saved inputs (compute dtype).
int mgn_node_round_bwd(int dtype, int latent, void* dv, float* dagg, const void* v,
                       const void* agg, int n_nodes, const MlpParams* params,
                       const BwdParams* bwd, void* stream) {
  if (n_nodes <= 0 || !params_ok(params, bwd)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == 0) {
    ok = node_bwd_any<float>(latent, dv, dagg, v, agg, n_nodes, *params, *bwd, s);
  } else if (dtype == 1) {
    ok = node_bwd_any<__nv_bfloat16>(latent, dv, dagg, v, agg, n_nodes, *params, *bwd, s);
  }
  if (!ok) return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}

const char* mgn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
