// K2 (edge_round) and K3 (node_round) — one processor round of the
// MeshGraphNet for Hopper (sm_90a).  With K1 (csr_segment.cu) between them
// they replace the fused TPU forward kernel mgn_tpu/ops/fused.py:_make_kernel
// (and its edge-streaming twin :_make_kernel_stream_e), which runs all mps
// rounds in one call with the graph resident in VMEM:
//
//   K2, per edge:  msg = LN(MLP_e([e, v[s], v[r]])) * edge_valid
//                  e  += msg                       (in place)
//   K1, per node:  agg = sum of msg over the node's CSR row   (f32)
//   K3, per node:  v  += LN(MLP_n([v, agg]))       (in place)
//
// The host loop in ops/fused.py:fused_process launches K2 -> K1 -> K3 once
// per round.  An H100 SM has 228 KB of shared memory, not 128 MB of VMEM, so
// the state lives in device memory (and mostly in the 50 MB L2, which holds
// the cylinder-size state several times over) between launches.
//
// Bound on this card: operations.  A cylinder round (E = 11,264 padded edges,
// N = 1,920 nodes, L = 128, 2 hidden layers) is about 2.1 GFLOP against about
// 12 MB of edge state read and written in f32; in f32 the products run on
// the CUDA cores (67 TFLOP/s peak), so the round is compute-bound.
//
// Design: what the TPU kernel needed one-hot matmuls for (gathering v[s] and
// v[r] on a machine without a vector gather) is a direct row load here, so
// edges need no spatial order and there is no banding plan.  Each warp owns
// R rows (edges or nodes) and all L columns (mlp_tile.cuh); the first layer's
// (3L, L) weight is applied part by part from the three staged inputs, so the
// (E, 3L) concat never exists and the 192 KB f32 weight is never staged
// whole in shared memory — weights stream through L1/L2, shared by every warp.
// LayerNorm statistics are f32 warp reductions.  msg is multiplied by
// edge_valid as process_rounds_xla does, so dead edges add nothing to the
// trash node either.  Products use the CUDA cores (FFMA) so that f32 stays
// exact f32; tensor-core tiles (wgmma) are later work.

#include "mlp_tile.cuh"

namespace {

using mgn::MlpParams;
using mgn::kTileWarps;

constexpr int kEdgeRows = 4;  // rows per warp in K2
constexpr int kNodeRows = 2;  // rows per warp in K3 (fewer nodes than edges)

template <typename T, int L, int R>
__global__ void __launch_bounds__(kTileWarps * 32)
edge_round_kernel(T* e, T* __restrict__ msg, const T* __restrict__ v,
                  const int* __restrict__ senders, const int* __restrict__ receivers,
                  const T* __restrict__ edge_valid, int n_edges, MlpParams p) {
  constexpr int C = L / 32;
  __shared__ __align__(16) float smem[kTileWarps][R * L];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* xs = smem[warp];
  const int row0 = (blockIdx.x * kTileWarps + warp) * R;

  int rows[R], snd[R], rcv[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = row0 + i;
    const bool ok = r < n_edges;
    rows[i] = ok ? r : -1;
    snd[i] = ok ? senders[r] : -1;
    rcv[i] = ok ? receivers[r] : -1;
  }

  float acc[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = 0.f;
  }
  const T* w0 = static_cast<const T*>(p.w[0]);
  mgn::warp_stage<T, T, L, R>(xs, e, rows, lane);  // part 0: e
  mgn::warp_matmul<T, L, R>(acc, xs, w0, lane);
  mgn::warp_stage<T, T, L, R>(xs, v, snd, lane);  // part 1: v[senders]
  mgn::warp_matmul<T, L, R>(acc, xs, w0 + L * L, lane);
  mgn::warp_stage<T, T, L, R>(xs, v, rcv, lane);  // part 2: v[receivers]
  mgn::warp_matmul<T, L, R>(acc, xs, w0 + 2 * L * L, lane);
  mgn::warp_mlp_tail<T, L, R>(acc, xs, p, lane);

#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (rows[i] < 0) continue;
    const size_t off = static_cast<size_t>(rows[i]) * L + lane * C;
    const float valid = mgn::to_f<T>(edge_valid[rows[i]]);
    float m[C], eo[C];
    mgn::load_pack<T, C>(e + off, eo);
#pragma unroll
    for (int j = 0; j < C; ++j) {
      m[j] = acc[i][j] * valid;
      eo[j] += m[j];  // rounded to T by the store
    }
    mgn::store_pack<T, C>(msg + off, m);
    mgn::store_pack<T, C>(e + off, eo);
  }
}

template <typename T, int L, int R>
__global__ void __launch_bounds__(kTileWarps * 32)
node_round_kernel(T* v, const float* __restrict__ agg, int n_nodes, MlpParams p) {
  constexpr int C = L / 32;
  __shared__ __align__(16) float smem[kTileWarps][R * L];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* xs = smem[warp];
  const int row0 = (blockIdx.x * kTileWarps + warp) * R;

  int rows[R];
#pragma unroll
  for (int i = 0; i < R; ++i) rows[i] = row0 + i < n_nodes ? row0 + i : -1;

  float acc[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = 0.f;
  }
  const T* w0 = static_cast<const T*>(p.w[0]);
  mgn::warp_stage<T, T, L, R>(xs, v, rows, lane);        // part 0: v
  mgn::warp_matmul<T, L, R>(acc, xs, w0, lane);
  mgn::warp_stage<T, float, L, R>(xs, agg, rows, lane);  // part 1: agg -> T
  mgn::warp_matmul<T, L, R>(acc, xs, w0 + L * L, lane);
  mgn::warp_mlp_tail<T, L, R>(acc, xs, p, lane);

#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (rows[i] < 0) continue;
    const size_t off = static_cast<size_t>(rows[i]) * L + lane * C;
    float vo[C];
    mgn::load_pack<T, C>(v + off, vo);
#pragma unroll
    for (int j = 0; j < C; ++j) vo[j] += acc[i][j];  // rounded to T by the store
    mgn::store_pack<T, C>(v + off, vo);
  }
}

bool params_ok(const MlpParams* p) {
  return p != nullptr && p->n_layers >= 1 && p->n_layers <= mgn::kMaxLayers;
}

template <typename T, int L>
void launch_edge(T* e, T* msg, const T* v, const int* senders, const int* receivers,
                 const T* edge_valid, int n_edges, const MlpParams& p, cudaStream_t s) {
  constexpr int per_block = kTileWarps * kEdgeRows;
  const dim3 grid((n_edges + per_block - 1) / per_block), block(kTileWarps * 32);
  edge_round_kernel<T, L, kEdgeRows><<<grid, block, 0, s>>>(e, msg, v, senders, receivers,
                                                           edge_valid, n_edges, p);
}

template <typename T, int L>
void launch_node(T* v, const float* agg, int n_nodes, const MlpParams& p, cudaStream_t s) {
  constexpr int per_block = kTileWarps * kNodeRows;
  const dim3 grid((n_nodes + per_block - 1) / per_block), block(kTileWarps * 32);
  node_round_kernel<T, L, kNodeRows><<<grid, block, 0, s>>>(v, agg, n_nodes, p);
}

// Dispatch over the latent widths the kernels are instantiated for
// (ops/fused.py's _KERNEL_LATENTS); false for any other width.
template <typename T>
bool edge_any(int latent, void* e, void* msg, const void* v, const int* senders,
              const int* receivers, const void* edge_valid, int n_edges,
              const MlpParams& p, cudaStream_t s) {
  T* e_ = static_cast<T*>(e);
  T* m_ = static_cast<T*>(msg);
  const T* v_ = static_cast<const T*>(v);
  const T* ev_ = static_cast<const T*>(edge_valid);
  switch (latent) {
    case 32: launch_edge<T, 32>(e_, m_, v_, senders, receivers, ev_, n_edges, p, s); return true;
    case 64: launch_edge<T, 64>(e_, m_, v_, senders, receivers, ev_, n_edges, p, s); return true;
    case 128: launch_edge<T, 128>(e_, m_, v_, senders, receivers, ev_, n_edges, p, s); return true;
    case 256: launch_edge<T, 256>(e_, m_, v_, senders, receivers, ev_, n_edges, p, s); return true;
    default: return false;
  }
}

template <typename T>
bool node_any(int latent, void* v, const float* agg, int n_nodes, const MlpParams& p,
              cudaStream_t s) {
  T* v_ = static_cast<T*>(v);
  switch (latent) {
    case 32: launch_node<T, 32>(v_, agg, n_nodes, p, s); return true;
    case 64: launch_node<T, 64>(v_, agg, n_nodes, p, s); return true;
    case 128: launch_node<T, 128>(v_, agg, n_nodes, p, s); return true;
    case 256: launch_node<T, 256>(v_, agg, n_nodes, p, s); return true;
    default: return false;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (the compute dtype of e, msg, v,
// edge_valid and the weights and biases).  e is updated in place and msg
// written.  Returns cudaGetLastError() after the launch (0 on success).
int mgn_edge_round(int dtype, int latent, void* e, void* msg, const void* v,
                   const int* senders, const int* receivers, const void* edge_valid,
                   int n_edges, const MlpParams* params, void* stream) {
  if (n_edges <= 0 || !params_ok(params)) return cudaErrorInvalidValue;
  const MlpParams p = *params;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == 0) {
    ok = edge_any<float>(latent, e, msg, v, senders, receivers, edge_valid, n_edges, p, s);
  } else if (dtype == 1) {
    ok = edge_any<__nv_bfloat16>(latent, e, msg, v, senders, receivers, edge_valid, n_edges,
                                 p, s);
  }
  if (!ok) return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}

// v (compute dtype) is updated in place; agg is the f32 aggregate from K1.
int mgn_node_round(int dtype, int latent, void* v, const float* agg, int n_nodes,
                   const MlpParams* params, void* stream) {
  if (n_nodes <= 0 || !params_ok(params)) return cudaErrorInvalidValue;
  const MlpParams p = *params;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == 0) {
    ok = node_any<float>(latent, v, agg, n_nodes, p, s);
  } else if (dtype == 1) {
    ok = node_any<__nv_bfloat16>(latent, v, agg, n_nodes, p, s);
  }
  if (!ok) return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}

const char* mgn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
