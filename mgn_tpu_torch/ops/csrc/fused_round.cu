// K7 (edge_project), K2 (edge_round) and K3 (node_round) — one processor
// round of the MeshGraphNet for Hopper (sm_90a), on the tensor cores.  With
// K1 (csr_segment.cu) between them they replace the fused TPU forward kernel
// mgn_tpu/ops/fused.py:_make_kernel (and its edge-streaming twin
// :_make_kernel_stream_e), which runs all mps rounds in one call with the
// graph resident in VMEM, in its preproject form (:393-395, :453-463,
// :493-503; the JAX forward takes it whenever E >= N, every real mesh):
//
//   K7, per node:  P = v.W0[L:2L], Q = v.W0[2L:3L]   (f32, no bias, no rounding)
//   K2, per edge:  msg = LN(MLP_e) * edge_valid, first layer
//                  (P[s] + Q[r]) + e.W0[0:L]
//                  e  += msg                       (in place)
//   K1, per node:  agg = sum of msg over the node's CSR row   (f32)
//   K3, per node:  v  += LN(MLP_n([v, agg]))       (in place)
//                  with node_extra, the first layer's pre-activation
//                  starts from extra:  extra + v.W0[0:L] + rnd(agg).W0[L:2L]
//
// The host loop in ops/fused.py:fused_process launches K7 -> K2 -> K1 -> K3
// once per round, after one launch of weight_streams_kernel that lays out
// every round's edge- and node-MLP weights for K7, K2 and K3.  An H100 SM
// has 228 KB of shared memory, not 128 MB of VMEM, so the state lives in
// device memory (and mostly in the 50 MB L2) between launches.
//
// Rounding follows mgn_tpu/models/mlp.py:apply_mlp_parts (process_rounds_xla,
// the reference the JAX tests hold the fused kernel against): weights and
// inputs in the compute dtype T, products accumulated in f32, each sum
// rounded to T and the T bias added in T, LayerNorm in f32 with its output
// rounded to T; agg rounded to T before the node MLP.  msg is multiplied by
// edge_valid as process_rounds_xla does, so dead edges add nothing to the
// trash node either.  Products: bf16 directly on the tensor cores, f32 as
// 3xTF32 (mma_tile.cuh), which keeps f32 accuracy.
//
// Bounds on this card, a cylinder round (E_pad 11,264, N_pad 1,920, L 128,
// 2 hidden layers): K2 does 3 L^2 MACs an edge, 1.11 GFLOP — 6.7 us at the
// 3xTF32 rate (495/3 TFLOP/s) in f32; its ~17 MB (f32; bf16 ~11 MB) of
// state, messages, indices and f32 projections read and written once take
// 5.2 us (3.2) at 3.35 TB/s, and in bf16 they bound it.  K7 does 2 L^2 MACs
// a node, 0.13 GFLOP (0.76 us in f32), below
// its 3.1 MB (f32; bf16 2.5 MB) of v in and P, Q out (0.92 us; 0.75).  K3
// does 4 L^2 MACs a node, 0.25 GFLOP (1.5 us in f32; bf16 0.6 us of bytes).
//
// K2 replaces the TPU kernel's edge stage (mgn_tpu/ops/fused.py:469-540 in
// _make_kernel, :367; preproject :453-503).  It is edge_tile.cuh's 64-edge
// tile (edge_mlp_forward: the e product, then K7's P[s] + Q[r] added in
// f32; the routine K4 recomputes its forward with), plus an epilogue:
// LayerNorm's affine step and the edge_valid mask on the accumulator
// fragments into As, then e += msg and the msg store a whole row at a time
// (16 bytes a thread), every e value read before the first store.  A block
// owns a tile, two blocks an SM, so the cylinder's 176 tiles take one wave
// and its 44 doubly loaded SMs set the floor of about 10 us of 3xTF32 work.
// The block's weight ring (edge_tile.cuh's EdgeRingFeed) starts at entry,
// holds 2 stages in f32 and 4 in bf16, and refills a stage as soon as the
// block is done with it; f32 keeps a chunk's two partials in flight.  The
// round's weights cross L2 once a block (69.2 MB a launch in f32); a
// cluster-multicast ring that copies them once a cluster measured slower
// (edge_tile.cuh).  No launch sets an attribute: mgn_edge_round_init sets
// the shared memory once per device.
// Its weight stream comes prepared, once per fused_process call
// for every round of both MLPs in one launch (weight_streams_kernel): f32 as
// TF32 high and low planes in wgmma's core-matrix layout, bf16 transposed to
// K-contiguous rows with the ring's row padding — each chunk the image of a
// ring stage, so one bulk copy fills a stage.  Where the
// forward will be differentiated, the same launch appends K4's adjoint
// products to each round's edge stream (fused_round_bwd.cu), so one kernel
// owns the edge tile's weight layout (stream_tile.cuh).  Not cached across
// calls: training changes the weights at every step.
//
// K3 is the 16-node tile of node_tile.cuh (NodeBlock::mlp_forward, the
// routine K5 recomputes its forward with) plus the LayerNorm's affine step
// and the residual add.  Its weights come from the same launch that
// prepares K2's, laid out with the ring's padded rows (raw values: f32 is
// split as it is read, which keeps the bytes at one copy), so a chunk is
// one bulk copy; where a gradient is needed the launch appends K5's
// adjoint products to each round's node stream.  Measured on an H100 80GB
// HBM3 at 700 W (chip_smoke.py's K3 timing, cylinder, f32, with 32-row
// chunks): chunks copied as 16-byte cp.async pieces 0.0243 ms, as one bulk
// copy a weight row 0.0303 ms, as one bulk copy a chunk 0.0219 ms; 64-row
// chunks (kept) did better still.  The update is in place and split by
// columns, so one warp's writes of v could meet another warp's reads of the
// same row: every row's v and agg are staged into shared memory before the
// first product, and the residual add reads v from there.
//
// node_extra (the cloth family's form of the TPU kernel,
// mgn_tpu/ops/fused.py:_make_kernel(node_extra=True), :384-389, :560-563):
// an f32 (N, L) offset, the world-edge aggregate's first-layer term, which
// the host computes per round.  K3 starts each row's first-layer
// accumulator from it, before the K-ordered chunk sums (f32: the chunk
// partials keep adding into it in K order).  It adds N L 4 bytes read a
// round (0.85 MB at the flag's N_pad 1,664, L 128) and no products.  A null
// extra starts from zeros as before, so K3 without it keeps its bits.
//
// K7 (it replaces the TPU kernel's preproject step, mgn_tpu/ops/fused.py:
// 453-463) is the projection tile of proj_tile.cuh: a block owns 64 node
// rows and a 64-column slice of P or of Q (30 x 2 x 2 = 120 blocks at the
// cylinder, 104 at the flag's N_pad 1,664, about 1,250 at the 20k-node mesh),
// 8 warps of 16 x 32; it reads that slice of W0's sender or receiver block
// (32 KB in f32) and its 64 rows of v once, so a call moves about 7.7 MB
// through L2 in f32 at the cylinder.  K7 ran on K3's 16-node tile before,
// which streamed both weight blocks whole into each of its 120 blocks
// (16.7 MB from L2 a call, fed at about 15 GB/s per SM), with 4 warps an
// SM and a barrier a chunk: 0.00893 ms in f32 against one torch.matmul's
// 0.00757 on an H100 80GB HBM3 at 700 W (chip_smoke.py).  On the
// projection tile, the earlier tile beside it in one run (chip_smoke.py
// --proj-bits, the same card): f32 0.0063 ms against 0.0092 and one
// torch.matmul's 0.0078, bf16 0.0031 against 0.0035; launch, copies and
// staging alone take 0.0029 (f32).  The tile keeps that kernel's bits
// (bf16: mma.sync m16n8k16 with f32 accumulation; f32: 3xTF32, a fresh
// accumulator per K-step added in K order).  A fixed K order, no split-K
// and no atomics: the same v gives the same bits, which K4 relies on (the
// backward recomputes P and Q from the saved v with this kernel, as the
// TPU backward recomputes them, :895-906).  Its weights are a third stream
// of the same weight_streams launch, each (product, slice) one contiguous
// image (stream_tile.cuh's row_image).  B stays unsplit in the stream (f32 is split
// into TF32 parts as it is read): leaving the split out saved 0.0011 ms
// of the 0.0063 in the same run, less than the floor above, and a
// pre-split stream doubles the f32 bytes a block copies.

#include "node_tile.cuh"
#include "proj_tile.cuh"
#include "stream_tile.cuh"

namespace {

using mgn::EdgeTile;
using mgn::MlpParams;
using mgn::NodeTile;
using mgn::Pair;

// --- K2: the 64-edge tile ----------------------------------------------------

// K2's block: one tile of 64 edges (block b owns rows 64 b ..).  The
// weight ring starts at entry, the tile's e rows before its indices; the
// epilogue stages msg in As and stores whole rows.
template <typename T, int L>
__global__ void __launch_bounds__(mgn::EdgeRing<T, L>::kThreads, mgn::EdgeRing<T, L>::kMinBlocks)
edge_round_kernel(T* e, T* __restrict__ msg, const float* __restrict__ P,
                  const float* __restrict__ Q, const int* __restrict__ senders,
                  const int* __restrict__ receivers, const T* __restrict__ edge_valid,
                  int n_edges, MlpParams p, const unsigned char* __restrict__ wstream) {
  using C = EdgeTile<T, L>;
  constexpr int NI = C::NI;
  extern __shared__ __align__(16) unsigned char smem[];
  // the round's edge stream: W0's e rows, then each hidden layer
  const mgn::EdgeRingFeed<T, L> ring(smem, wstream, p.n_layers * C::kChunks);
  mgn::EdgeRoundTile<T, L> b(smem, ring, e, senders, receivers, n_edges);
  const mgn::TileLane& me = b.me;
  const int grow[2] = {b.rid[me.row[0]], b.rid[me.row[1]]};
  float acc[NI][4], rstd[2];
  mgn::edge_mlp_forward<T, L>(b, acc, p, P, Q, nullptr, grow, rstd);

  // LayerNorm's affine step, rounded to T; msg = that * edge_valid, into
  // As (free since the last product) at the fragment positions.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float valid = grow[h] < 0 ? 0.f : mgn::to_f<T>(edge_valid[grow[h]]);
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int col = me.nb + j * 8 + 2 * me.t;
      float s0, s1, b0, b1;
      Pair<float>::load(p.ln_scale + col, s0, s1);
      Pair<float>::load(p.ln_bias + col, b0, b1);
      Pair<T>::store(b.As + me.row[h] * C::PA + col,
                     mgn::rnd<T>(mgn::rnd<T>(acc[j][2 * h] * s0 + b0) * valid),
                     mgn::rnd<T>(mgn::rnd<T>(acc[j][2 * h + 1] * s1 + b1) * valid));
    }
  }
  __syncthreads();
  // then row by row, 16 bytes a thread, whole lines a warp: msg stored,
  // e += msg (rounded to T by the store); every e value read before the
  // first store (e is updated in place, so a load after a store would wait
  // for it)
  constexpr int E = 16 / sizeof(T), OPS = L / E, kIters = C::kRows * OPS / C::kThreads;
  static_assert(C::kRows * OPS % C::kThreads == 0, "whole rows a pass");
  float x[kIters][E];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = me.tid + it * C::kThreads, row = b.rid[i / OPS];
    if (row >= 0) mgn::load_pack<T, E>(e + static_cast<size_t>(row) * L + (i % OPS) * E, x[it]);
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = me.tid + it * C::kThreads, r = i / OPS, col = (i % OPS) * E, row = b.rid[r];
    if (row < 0) continue;
    const size_t off = static_cast<size_t>(row) * L + col;
    float m[E];
    mgn::load_pack<T, E>(b.As + r * C::PA + col, m);
#pragma unroll
    for (int k = 0; k < E; ++k) x[it][k] += m[k];
    *reinterpret_cast<mgn::Pack<T, E>*>(msg + off) =
        *reinterpret_cast<const mgn::Pack<T, E>*>(b.As + r * C::PA + col);
    mgn::store_pack<T, E>(e + off, x[it]);
  }
}

// --- K3: 16 node rows a block, the columns split over 4 warps (node_tile.cuh) ---

template <typename T, int L>
__global__ void __launch_bounds__(NodeTile<T, L>::kThreads)
node_round_kernel(T* v, const float* __restrict__ agg, const float* __restrict__ extra,
                  int n_nodes, MlpParams p, const T* __restrict__ wstream) {
  using C = NodeTile<T, L>;
  constexpr int NI = C::NI;
  extern __shared__ __align__(16) unsigned char smem[];
  // the round's node stream: the first layer's 2L rows, then each hidden layer's L
  mgn::NodeBlock<T, L> b(smem, wstream, 1 + p.n_layers, n_nodes);
  b.template stage<2 * L>(b.As, C::PA, v, agg);  // the residual add reads v from here
  float acc[NI][4], mean[2], rstd[2];
  b.mlp_forward(acc, p, extra, nullptr, nullptr);
  b.ln_stats(acc, p.real, mean, rstd);

  // v += rnd(xhat * ln_scale + ln_bias), v read back from the staged rows;
  // xhat is 0 in the padded columns (col >= p.real)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = b.g + 8 * h, row = b.row0 + r;
    if (row >= n_nodes) continue;
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int col = b.nb + j * 8 + 2 * b.t;
      float s0, s1, b0, b1, v0, v1;
      Pair<float>::load(p.ln_scale + col, s0, s1);
      Pair<float>::load(p.ln_bias + col, b0, b1);
      Pair<T>::load(b.As + r * C::PA + col, v0, v1);
      const float x0 = col < p.real ? (acc[j][2 * h] - mean[h]) * rstd[h] : 0.f;
      const float x1 = col + 1 < p.real ? (acc[j][2 * h + 1] - mean[h]) * rstd[h] : 0.f;
      const float y0 = mgn::rnd<T>(x0 * s0 + b0);
      const float y1 = mgn::rnd<T>(x1 * s1 + b1);
      Pair<T>::store(v + static_cast<size_t>(row) * L + col, v0 + y0, v1 + y1);
    }
  }
}

// --- K7: the first layer's sender and receiver projections, the projection tile ---

constexpr int kProjectRows = 64;  // ops/fused.py _PROJ_ROWS["edge_project"]

template <typename T, int L>
using ProjectBlock = mgn::ProjBlock<T, T, L, kProjectRows, 1>;

// Block (x, y): rows x * 64 .., output y / kSlices (P, then Q), column
// slice y % kSlices.
template <typename T, int L>
__global__ void __launch_bounds__(ProjectBlock<T, L>::C::kThreads)
edge_project_kernel(const T* __restrict__ v, float* __restrict__ P, float* __restrict__ Q,
                    int n_nodes, const T* __restrict__ wstream) {
  using C = typename ProjectBlock<T, L>::C;
  constexpr int NI = C::NI;
  extern __shared__ __align__(16) unsigned char smem[];
  const int part = blockIdx.y / C::kSlices, slice = blockIdx.y % C::kSlices;
  ProjectBlock<T, L> b(smem);
  // the round's projection stream: W0's sender rows' slices, then its receiver rows'
  const T* src[1] = {wstream + (part * C::kSlices + slice) * C::kImage};
  b.issue(src);
  const T* x[1] = {v};
  b.stage(x, n_nodes);
  float acc[NI][4];
  b.clear(acc);
  b.product(acc);
  float* out = part == 0 ? P : Q;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = b.row0 + b.m0 + b.g + 8 * h;
    if (row >= n_nodes) continue;
#pragma unroll
    for (int j = 0; j < NI; ++j)
      Pair<float>::store(out + static_cast<size_t>(row) * L + slice * C::CN + b.nb + j * 8 +
                             2 * b.t,
                         acc[j][2 * h], acc[j][2 * h + 1]);
  }
}

// --- launches ------------------------------------------------------------------

// A round's parameters at tile width latent: 1..kMaxLayers layers, a real
// width of 1..latent.
bool params_ok(const MlpParams* p, int latent) {
  return p != nullptr && p->n_layers >= 1 && p->n_layers <= mgn::kMaxLayers && p->real >= 1 &&
         p->real <= latent;
}

// K2's dynamic shared memory, set once per device by mgn_edge_round_init
// (not before every launch).
template <typename T, int L>
int init_edge() {
  return static_cast<int>(cudaFuncSetAttribute(
      edge_round_kernel<T, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(mgn::EdgeRing<T, L>::kSmem)));
}

// K2's grid: a block per 64 edges.
template <typename T, int L>
int edge_grid(int n_edges) {
  return (n_edges + EdgeTile<T, L>::kRows - 1) / EdgeTile<T, L>::kRows;
}

template <typename T, int L>
int launch_edge(void* e, void* msg, const float* P, const float* Q, const int* senders,
                const int* receivers, const void* edge_valid, int n_edges, const MlpParams& p,
                const unsigned char* wstream, cudaStream_t s) {
  using R = mgn::EdgeRing<T, L>;
  const dim3 grid(edge_grid<T, L>(n_edges)), block(R::kThreads);
  edge_round_kernel<T, L><<<grid, block, R::kSmem, s>>>(
      static_cast<T*>(e), static_cast<T*>(msg), P, Q, senders, receivers,
      static_cast<const T*>(edge_valid), n_edges, p, wstream);
  return 0;
}

// K2's launch shape as ops/fused.py:edge_plan computes it: column groups,
// ring stages, threads, shared memory, grid.
template <typename T, int L>
int plan_edge(int n_edges, int* out) {
  using R = mgn::EdgeRing<T, L>;
  out[0] = EdgeTile<T, L>::kColGroups;
  out[1] = R::kStages;
  out[2] = R::kThreads;
  out[3] = static_cast<int>(R::kSmem);
  out[4] = edge_grid<T, L>(n_edges);
  return 0;
}

// K7's dynamic shared memory, set once per device by mgn_edge_project_init
// (not before every launch).
template <typename T, int L>
int init_project() {
  return static_cast<int>(cudaFuncSetAttribute(
      edge_project_kernel<T, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(ProjectBlock<T, L>::C::kSmem)));
}

template <typename T, int L>
int launch_project(const void* v, float* P, float* Q, int n_nodes, const void* wstream,
                   cudaStream_t s) {
  using C = typename ProjectBlock<T, L>::C;
  const dim3 grid((n_nodes + C::kRows - 1) / C::kRows, 2 * C::kSlices), block(C::kThreads);
  edge_project_kernel<T, L><<<grid, block, C::kSmem, s>>>(static_cast<const T*>(v), P, Q, n_nodes,
                                                           static_cast<const T*>(wstream));
  return 0;
}

template <typename T, int L>
int launch_node(void* v, const float* agg, const float* extra, int n_nodes, const MlpParams& p,
                const void* wstream, cudaStream_t s) {
  using C = NodeTile<T, L>;
  const cudaError_t rc = cudaFuncSetAttribute(
      node_round_kernel<T, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((n_nodes + C::kRows - 1) / C::kRows), block(C::kThreads);
  node_round_kernel<T, L><<<grid, block, C::kSmem, s>>>(static_cast<T*>(v), agg, extra, n_nodes,
                                                         p, static_cast<const T*>(wstream));
  return 0;
}

// pe / pn null: no edge and projection / no node stream; form: a
// mgn::StreamForm.  One block a tile of each (L, L) weight block, rounds
// along y.
template <typename T, int L>
int launch_streams(const MlpParams* pe, const MlpParams* pn, int n_rounds, int form,
                   void* out_e, void* out_n, void* out_p, cudaStream_t s) {
  using S = mgn::StreamTile<T, L>;
  const int blocks = ((pe ? 2 + pe->n_layers : 0) + (pn ? 1 + pn->n_layers : 0)) * S::kTiles *
                     S::kTiles;
  if (n_rounds > 65535) return cudaErrorInvalidValue;
  const MlpParams none{};
  mgn::weight_streams_kernel<S><<<dim3(blocks, n_rounds), S::kThreads, 0, s>>>(
      pe ? *pe : none, pn ? *pn : none, form, static_cast<T*>(out_e), static_cast<T*>(out_n),
      static_cast<T*>(out_p));
  return 0;
}

// Dispatch over the compute dtype (0 = float32, 1 = bfloat16) and the
// latent widths the kernels are built for (ops/fused.py's _KERNEL_LATENTS);
// cudaErrorInvalidValue for any other.
#define MGN_DISPATCH(launch, ...)                                                  \
  {                                                                                \
    if (dtype == 0) {                                                              \
      switch (latent) {                                                            \
        case 32: return launch<float, 32>(__VA_ARGS__);                            \
        case 64: return launch<float, 64>(__VA_ARGS__);                            \
        case 128: return launch<float, 128>(__VA_ARGS__);                          \
        case 256: return launch<float, 256>(__VA_ARGS__);                          \
      }                                                                            \
    } else if (dtype == 1) {                                                       \
      switch (latent) {                                                            \
        case 32: return launch<__nv_bfloat16, 32>(__VA_ARGS__);                    \
        case 64: return launch<__nv_bfloat16, 64>(__VA_ARGS__);                    \
        case 128: return launch<__nv_bfloat16, 128>(__VA_ARGS__);                  \
        case 256: return launch<__nv_bfloat16, 256>(__VA_ARGS__);                  \
      }                                                                            \
    }                                                                              \
    return cudaErrorInvalidValue;                                                  \
  }

int edge_any(int dtype, int latent, void* e, void* msg, const float* P, const float* Q,
             const int* senders, const int* receivers, const void* edge_valid, int n_edges,
             const MlpParams& p, const unsigned char* wstream, cudaStream_t s) {
  MGN_DISPATCH(launch_edge, e, msg, P, Q, senders, receivers, edge_valid, n_edges, p, wstream,
               s);
}

int edge_plan_any(int dtype, int latent, int n_edges, int* out) {
  MGN_DISPATCH(plan_edge, n_edges, out);
}

int project_any(int dtype, int latent, const void* v, float* P, float* Q, int n_nodes,
                const void* wstream, cudaStream_t s) {
  MGN_DISPATCH(launch_project, v, P, Q, n_nodes, wstream, s);
}

template <typename T>
int init_edge_all() {
  int rc = init_edge<T, 32>();
  if (rc == 0) rc = init_edge<T, 64>();
  if (rc == 0) rc = init_edge<T, 128>();
  if (rc == 0) rc = init_edge<T, 256>();
  return rc;
}

template <typename T>
int init_project_all() {
  int rc = init_project<T, 32>();
  if (rc == 0) rc = init_project<T, 64>();
  if (rc == 0) rc = init_project<T, 128>();
  if (rc == 0) rc = init_project<T, 256>();
  return rc;
}

int node_any(int dtype, int latent, void* v, const float* agg, const float* extra, int n_nodes,
             const MlpParams& p, const void* wstream, cudaStream_t s) {
  MGN_DISPATCH(launch_node, v, agg, extra, n_nodes, p, wstream, s);
}

int streams_any(int dtype, int latent, const MlpParams* pe, const MlpParams* pn, int n_rounds,
                int form, void* out_e, void* out_n, void* out_p, cudaStream_t s) {
  MGN_DISPATCH(launch_streams, pe, pn, n_rounds, form, out_e, out_n, out_p, s);
}

#undef MGN_DISPATCH

int finish(int rc) { return rc != 0 ? rc : static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (the compute dtype of e, msg,
// edge_valid and the weights and biases).  e is updated in place and msg
// written; P and Q are K7's f32 (n_nodes, latent) projections of the
// round's v; wstream is the round's forward part of mgn_weight_streams'
// edge stream.  mgn_edge_round_init must have run on the device.  Returns
// cudaGetLastError() after the launch (0 on success).
int mgn_edge_round(int dtype, int latent, void* e, void* msg, const float* P, const float* Q,
                   const int* senders, const int* receivers, const void* edge_valid,
                   int n_edges, const MlpParams* params, const void* wstream, void* stream) {
  if (n_edges <= 0 || !params_ok(params, latent) || wstream == nullptr || P == nullptr ||
      Q == nullptr)
    return cudaErrorInvalidValue;
  return finish(edge_any(dtype, latent, e, msg, P, Q, senders, receivers, edge_valid, n_edges,
                         *params, static_cast<const unsigned char*>(wstream),
                         static_cast<cudaStream_t>(stream)));
}

// K2's shared-memory attributes for every dtype and width, on the current
// device; once before its first launch there.
int mgn_edge_round_init() {
  const int rc = init_edge_all<float>();
  return rc != 0 ? rc : init_edge_all<__nv_bfloat16>();
}

// K2's launch at n_edges rows: out[0..4] = column groups of the tile, ring
// stages, threads a block, dynamic shared memory, grid (blocks).
int mgn_edge_round_plan(int dtype, int latent, int n_edges, int* out) {
  if (n_edges <= 0 || out == nullptr) return cudaErrorInvalidValue;
  return edge_plan_any(dtype, latent, n_edges, out);
}

// K7's shared-memory attributes for every dtype and width, on the current
// device; once before its first launch there.
int mgn_edge_project_init() {
  const int rc = init_project_all<float>();
  return rc != 0 ? rc : init_project_all<__nv_bfloat16>();
}

// K7: P = v.W0[L:2L] and Q = v.W0[2L:3L] in f32 for the n_nodes rows of v
// (compute dtype); wstream is K7's part of the round's row of
// mgn_weight_streams' projection stream.
int mgn_edge_project(int dtype, int latent, const void* v, float* P, float* Q, int n_nodes,
                     const void* wstream, void* stream) {
  if (n_nodes <= 0 || wstream == nullptr || P == nullptr || Q == nullptr)
    return cudaErrorInvalidValue;
  return finish(project_any(dtype, latent, v, P, Q, n_nodes, wstream,
                            static_cast<cudaStream_t>(stream)));
}

// v (compute dtype) is updated in place; agg is the f32 aggregate from K1;
// extra is null or the round's f32 (n_nodes, latent) first-layer offset
// (node_extra); wstream is the round's part of mgn_weight_streams' node
// stream.
int mgn_node_round(int dtype, int latent, void* v, const float* agg, const float* extra,
                   int n_nodes, const MlpParams* params, const void* wstream, void* stream) {
  if (n_nodes <= 0 || !params_ok(params, latent) || wstream == nullptr)
    return cudaErrorInvalidValue;
  return finish(node_any(dtype, latent, v, agg, extra, n_nodes, *params, wstream,
                         static_cast<cudaStream_t>(stream)));
}

// K2's, K3's and K7's weight streams for n_rounds rounds of the edge and
// node MLPs, written to out_edge, out_node and out_proj (the edge MLP's
// first-layer projections); edge->w[l] and node->w[l] are the (n_rounds,
// in, L) stacks of the cast weights.  Either MLP may be null (no stream
// for it; the edge MLP's null: no edge and no projection stream).
// form 1: each round's edge stream also holds K4's adjoint products, after
// K2's, its node stream K5's, after K3's, and its projection stream K8's,
// after K7's; form 2: the same without K4's last two products (W0's sender
// and receiver blocks, which the defer_first backward does not read);
// form 0: the forward products alone.
int mgn_weight_streams(int dtype, int latent, const MlpParams* edge, const MlpParams* node,
                       int n_rounds, int form, void* out_edge, void* out_node,
                       void* out_proj, void* stream) {
  if (n_rounds <= 0 || (edge == nullptr && node == nullptr) || form < 0 || form > 2 ||
      (edge != nullptr &&
       (!params_ok(edge, latent) || out_edge == nullptr || out_proj == nullptr)) ||
      (node != nullptr && (!params_ok(node, latent) || out_node == nullptr)))
    return cudaErrorInvalidValue;
  return finish(streams_any(dtype, latent, edge, node, n_rounds, form, out_edge, out_node,
                            out_proj, static_cast<cudaStream_t>(stream)));
}

const char* mgn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
