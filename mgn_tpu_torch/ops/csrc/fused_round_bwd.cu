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
// compute dtype T, and each warp's partial sums of the LayerNorm gradients
// (sum of dy * xhat and of dy over the warp's rows, f32).  So no reduction
// across rows happens here and no atomics are needed; K6 reduces in a fixed
// order.
//
// Rounding follows the JAX package's _mlp_bwd: LayerNorm backward in f32,
// cotangents rounded to T after each adjoint product and carried in T;
// the ReLU mask is post > 0 (== pre > 0).  dmsg is multiplied by edge_valid,
// since the port's forward masks messages (process_rounds_xla does; the TPU
// forward kernel does not), so a dead edge gets no gradient at all.
//
// Bound on this card: operations.  A cylinder round's edge stage is
// (5 + 5) L^2 MACs per edge (recompute + adjoint), 3.69 GFLOP over E_pad
// 11,264 edges at L = 128, far above its bytes at 67 TFLOP/s (f32 on the
// CUDA cores).  Design as K2/K3 (mlp_tile.cuh): a warp owns R rows and all
// L columns; weight rows stream through L1/L2; the adjoint products use
// weights the host transposed once per backward, so they run through the
// same warp_matmul as the forward.

#include "mlp_tile.cuh"

namespace mgn {

// What the backward of one MLP round reads besides MlpParams, and writes for
// K6; the layout must match ops/_build.py's BwdParams.
struct BwdParams {
  const void* wt[kMaxLayers];  // transposed weights: wt[0] (L, parts*L), wt[i] (L, L)
  void* dh[kMaxLayers];        // out: (rows, L) cotangent of layer i's pre-activation
  void* post[kMaxLayers];      // out: (rows, L) ReLU output feeding layer i+1
  float* ln_part;              // out: (warps, 2L): sum dy*xhat | sum dy per warp
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

constexpr int kEdgeRows = 4;  // rows per warp in K4 (ops/fused.py _EDGE_BWD_ROWS)
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

template <typename T, int L, int R>
__global__ void __launch_bounds__(kTileWarps * 32)
edge_round_bwd_kernel(T* de, T* __restrict__ dvs, T* __restrict__ dvr,
                      const float* __restrict__ dagg, const T* __restrict__ e,
                      const T* __restrict__ v, const int* __restrict__ senders,
                      const int* __restrict__ receivers, const T* __restrict__ edge_valid,
                      int n_edges, MlpParams p, BwdParams q) {
  constexpr int C = L / 32;
  __shared__ __align__(16) float smem[kTileWarps][R * L];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* xs = smem[warp];
  const int warp_id = blockIdx.x * kTileWarps + warp;
  const int row0 = warp_id * R;
  if (row0 >= n_edges) return;  // whole warp: no shuffle partner is lost

  int rows[R], snd[R], rcv[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = row0 + i;
    const bool ok = r < n_edges;
    rows[i] = ok ? r : -1;
    snd[i] = ok ? senders[r] : -1;
    rcv[i] = ok ? receivers[r] : -1;
  }

  // recompute the forward of this round's edge MLP
  float acc[R][C];
  zero<T, L, R>(acc);
  const T* w0 = static_cast<const T*>(p.w[0]);
  mgn::warp_stage<T, T, L, R>(xs, e, rows, lane);
  mgn::warp_matmul<T, L, R>(acc, xs, w0, lane);
  mgn::warp_stage<T, T, L, R>(xs, v, snd, lane);
  mgn::warp_matmul<T, L, R>(acc, xs, w0 + L * L, lane);
  mgn::warp_stage<T, T, L, R>(xs, v, rcv, lane);
  mgn::warp_matmul<T, L, R>(acc, xs, w0 + 2 * L * L, lane);
  warp_mlp_recompute<T, L, R>(acc, xs, p, q, rows, lane);

  // cotangent of the message: the residual carry plus the aggregate's, masked
  float dy[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (rows[i] < 0) {
#pragma unroll
      for (int j = 0; j < C; ++j) dy[i][j] = 0.f;
      continue;
    }
    float d[C], a[C];
    mgn::load_pack<T, C>(de + static_cast<size_t>(rows[i]) * L + lane * C, d);
    mgn::load_pack<float, C>(dagg + static_cast<size_t>(rcv[i]) * L + lane * C, a);
    const float valid = mgn::to_f<T>(edge_valid[rows[i]]);
#pragma unroll
    for (int j = 0; j < C; ++j)
      dy[i][j] = mgn::rnd<T>(mgn::rnd<T>(d[j] + mgn::rnd<T>(a[j])) * valid);
  }
  float pg[C], pb[C];
#pragma unroll
  for (int j = 0; j < C; ++j) pg[j] = pb[j] = 0.f;
  warp_ln_bwd<T, L, R>(acc, dy, p, pg, pb, rows, lane);
  warp_mlp_adjoint<T, L, R>(acc, xs, p, q, rows, lane);

  // first layer, part by part: de += dh0 W0_e^T, dvs = dh0 W0_s^T, dvr = dh0 W0_r^T
  const T* wt0 = static_cast<const T*>(q.wt[0]);
  T* outs[3] = {de, dvs, dvr};
#pragma unroll
  for (int part = 0; part < 3; ++part) {
    zero<T, L, R>(acc);
    mgn::warp_matmul<T, L, R>(acc, xs, wt0 + part * L, lane, 3 * L);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (rows[i] < 0) continue;
      T* dst = outs[part] + static_cast<size_t>(rows[i]) * L + lane * C;
      float o[C];
#pragma unroll
      for (int j = 0; j < C; ++j) o[j] = mgn::rnd<T>(acc[i][j]);
      if (part == 0) {
        float d[C];
        mgn::load_pack<T, C>(dst, d);
#pragma unroll
        for (int j = 0; j < C; ++j) o[j] += d[j];  // rounded to T by the store
      }
      mgn::store_pack<T, C>(dst, o);
    }
  }
  store_ln_part<L>(q.ln_part, warp_id, pg, pb, lane);
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
void launch_edge_bwd(void* de, void* dvs, void* dvr, const float* dagg, const void* e,
                     const void* v, const int* senders, const int* receivers,
                     const void* edge_valid, int n_edges, const MlpParams& p,
                     const BwdParams& q, cudaStream_t s) {
  constexpr int per_block = kTileWarps * kEdgeRows;
  const dim3 grid((n_edges + per_block - 1) / per_block), block(kTileWarps * 32);
  edge_round_bwd_kernel<T, L, kEdgeRows><<<grid, block, 0, s>>>(
      static_cast<T*>(de), static_cast<T*>(dvs), static_cast<T*>(dvr), dagg,
      static_cast<const T*>(e), static_cast<const T*>(v), senders, receivers,
      static_cast<const T*>(edge_valid), n_edges, p, q);
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

// Dispatch over the latent widths (ops/fused.py's _KERNEL_LATENTS).
template <typename T>
bool edge_bwd_any(int latent, void* de, void* dvs, void* dvr, const float* dagg,
                  const void* e, const void* v, const int* senders, const int* receivers,
                  const void* edge_valid, int n_edges, const MlpParams& p,
                  const BwdParams& q, cudaStream_t s) {
#define MGN_EDGE_BWD(Lc)                                                              \
  case Lc:                                                                            \
    launch_edge_bwd<T, Lc>(de, dvs, dvr, dagg, e, v, senders, receivers, edge_valid,  \
                           n_edges, p, q, s);                                         \
    return true;
  switch (latent) {
    MGN_EDGE_BWD(32)
    MGN_EDGE_BWD(64)
    MGN_EDGE_BWD(128)
    MGN_EDGE_BWD(256)
    default: return false;
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
// dvs, dvr and q's outputs are written.  Returns cudaGetLastError() after
// the launch (0 on success).
int mgn_edge_round_bwd(int dtype, int latent, void* de, void* dvs, void* dvr,
                       const float* dagg, const void* e, const void* v, const int* senders,
                       const int* receivers, const void* edge_valid, int n_edges,
                       const MlpParams* params, const BwdParams* bwd, void* stream) {
  if (n_edges <= 0 || !params_ok(params, bwd)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == 0) {
    ok = edge_bwd_any<float>(latent, de, dvs, dvr, dagg, e, v, senders, receivers,
                             edge_valid, n_edges, *params, *bwd, s);
  } else if (dtype == 1) {
    ok = edge_bwd_any<__nv_bfloat16>(latent, de, dvs, dvr, dagg, e, v, senders, receivers,
                                     edge_valid, n_edges, *params, *bwd, s);
  }
  if (!ok) return cudaErrorInvalidValue;
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
