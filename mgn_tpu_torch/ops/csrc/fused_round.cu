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
// 3xTF32 rate (495/3 TFLOP/s) in f32; in bf16 its ~11 MB of state,
// messages and f32 projections read and written once (3.2 us at 3.35 TB/s)
// bound it.  K7 does 2 L^2 MACs a node, 0.13 GFLOP (0.76 us in f32), below
// its 3.1 MB (f32; bf16 2.5 MB) of v in and P, Q out (0.92 us; 0.75).  K3
// does 4 L^2 MACs a node, 0.25 GFLOP (1.5 us in f32; bf16 0.6 us of bytes).
//
// K2 is the 64-edge tile of edge_tile.cuh (edge_mlp_forward: the e product,
// then K7's P[s] + Q[r] added in f32; the routine K4 recomputes its forward
// with), plus an epilogue on the accumulator
// fragments: LayerNorm's affine step, the edge_valid mask, e += msg and the
// msg store.  Its weight stream comes prepared, once per fused_process call
// for every round of both MLPs in one launch (weight_streams_kernel): f32 as
// TF32 high and low planes in wgmma's core-matrix layout, bf16 transposed to
// K-contiguous rows with the ring's row padding — each chunk the image of a
// ring stage, so a block fills a stage with one bulk copy.  Where the
// forward will be differentiated, the same launch appends K4's adjoint
// products to each round's edge stream (fused_round_bwd.cu), so one kernel
// owns the edge tile's weight layout.  Not cached across calls: training
// changes the weights at every step.
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
// K7 is K3's 16-node tile without its MLP: the tile's v rows staged once,
// then NodeBlock::product twice, one (L, L) block of W0 each, the raw f32
// accumulators stored (bf16: mma.sync with f32 accumulation; f32: 3xTF32,
// a fresh accumulator per K-step added in K order).  A fixed K order, no
// split-K and no atomics: the same v gives the same bits, which K4 relies
// on (the backward recomputes P and Q from the saved v with this kernel,
// as the TPU backward recomputes them, :895-906).  Its weights are a third
// stream of the same weight_streams launch, W0's sender and receiver row
// blocks as rows of PW values (the node stream's layout).  120 blocks at
// the cylinder.

#include "node_tile.cuh"

namespace {

using mgn::EdgeTile;
using mgn::MlpParams;
using mgn::NodeTile;
using mgn::Pair;

// --- K2: the 64-edge tile ----------------------------------------------------

template <typename T, int L>
__global__ void __launch_bounds__(EdgeTile<T, L>::kThreads, EdgeTile<T, L>::kMinBlocks)
edge_round_kernel(T* e, T* __restrict__ msg, const float* __restrict__ P,
                  const float* __restrict__ Q, const int* __restrict__ senders,
                  const int* __restrict__ receivers, const T* __restrict__ edge_valid,
                  int n_edges, MlpParams p, const unsigned char* __restrict__ wstream) {
  using C = EdgeTile<T, L>;
  constexpr int NI = C::NI;
  extern __shared__ __align__(16) unsigned char smem[];
  // the round's edge stream: W0's e rows, then each hidden layer
  mgn::EdgeBlock<T, L> b(smem, wstream, p.n_layers, e, senders, receivers, n_edges);
  const mgn::TileLane& me = b.me;
  const int grow[2] = {b.rid[me.row[0]], b.rid[me.row[1]]};
  float acc[NI][4], rstd[2];
  mgn::edge_mlp_forward<T, L>(b, acc, p, P, Q, nullptr, grow, rstd);

  // LayerNorm's affine step, rounded to T; msg = that * edge_valid; e += msg
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (grow[h] < 0) continue;
    const float valid = mgn::to_f<T>(edge_valid[grow[h]]);
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int col = me.nb + j * 8 + 2 * me.t;
      const size_t off = static_cast<size_t>(grow[h]) * L + col;
      float s0, s1, b0, b1, e0, e1;
      Pair<float>::load(p.ln_scale + col, s0, s1);
      Pair<float>::load(p.ln_bias + col, b0, b1);
      const float m0 = mgn::rnd<T>(mgn::rnd<T>(acc[j][2 * h] * s0 + b0) * valid);
      const float m1 = mgn::rnd<T>(mgn::rnd<T>(acc[j][2 * h + 1] * s1 + b1) * valid);
      Pair<T>::load(e + off, e0, e1);
      Pair<T>::store(msg + off, m0, m1);
      Pair<T>::store(e + off, e0 + m0, e1 + m1);  // rounded to T by the store
    }
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
  b.ln_stats(acc, mean, rstd);

  // v += rnd(xhat * ln_scale + ln_bias), v read back from the staged rows
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
      const float y0 = mgn::rnd<T>((acc[j][2 * h] - mean[h]) * rstd[h] * s0 + b0);
      const float y1 = mgn::rnd<T>((acc[j][2 * h + 1] - mean[h]) * rstd[h] * s1 + b1);
      Pair<T>::store(v + static_cast<size_t>(row) * L + col, v0 + y0, v1 + y1);
    }
  }
}

// --- K7: the first layer's sender and receiver projections, K3's tile -----------

template <typename T, int L>
__global__ void __launch_bounds__(NodeTile<T, L>::kThreads)
edge_project_kernel(const T* __restrict__ v, float* __restrict__ P, float* __restrict__ Q,
                    int n_nodes, const T* __restrict__ wstream) {
  using C = NodeTile<T, L>;
  constexpr int NI = C::NI;
  extern __shared__ __align__(16) unsigned char smem[];
  // the round's projection stream: W0's sender rows, then its receiver rows
  mgn::NodeBlock<T, L> b(smem, wstream, 2, n_nodes);
  b.template stage<L>(b.As, C::PA, v, static_cast<const T*>(nullptr));
  float acc[NI][4];
#pragma unroll 1
  for (int part = 0; part < 2; ++part) {
    b.clear(acc);
    b.product(acc, b.As, C::PA, L);
    float* out = part == 0 ? P : Q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = b.row0 + b.g + 8 * h;
      if (row >= n_nodes) continue;
#pragma unroll
      for (int j = 0; j < NI; ++j)
        Pair<float>::store(out + static_cast<size_t>(row) * L + b.nb + j * 8 + 2 * b.t,
                           acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
}

// --- the weight streams of K2, K3 and K7 ---------------------------------------

// Element i of the edge tile's weight stream: for round r, product prod
// and KC-deep chunk c, the image of one ring stage (edge_tile.cuh's
// stage_nk): f32, B[k][n] split into TF32 high and low planes; bf16, B
// transposed to rows n of KC values padded to PB with zeros.  The products
// of a round: K2's forward, B = W (the first layer's e row block, then each
// hidden layer); with n_prod larger, K4's adjoint after them, B = W^T (the
// hidden layers n-1 .. 1, then the first layer's three row blocks).
template <typename T, int L>
__device__ __forceinline__ void edge_stream_elem(const MlpParams& p, int n_prod, T* out,
                                                 long long i) {
  using C = EdgeTile<T, L>;
  constexpr int per = mgn::stage_elems<T, L>();
  const int n_fwd = p.n_layers, H = p.n_layers - 1;
  const long long chunk = i / per;  // over rounds x products x chunks
  const int e = static_cast<int>(i % per);
  const int c = static_cast<int>(chunk % C::kChunks);
  const int prod = static_cast<int>((chunk / C::kChunks) % n_prod);
  const long long r = chunk / (C::kChunks * n_prod);
  int n, k;
  mgn::stage_nk<T, L>(e, n, k);
  // the (L, L) block W of the product, and B[k][n]'s place in it
  const int blk = prod < n_fwd ? prod : prod - n_fwd;
  const int layer = prod < n_fwd ? blk : (blk < H ? H - blk : 0);
  const int row_block = prod < n_fwd || layer != 0 ? 0 : blk - H;
  const T* w = static_cast<const T*>(p.w[layer]) +
               (r * (layer == 0 ? 3 : 1) + row_block) * L * L;
  const size_t src = prod < n_fwd ? static_cast<size_t>(c * C::KC + k) * L + n
                                  : static_cast<size_t>(n) * L + c * C::KC + k;
  if constexpr (sizeof(T) == 4) {
    uint32_t hi, lo;
    mgn::split_tf32(w[src], hi, lo);
    T* o = out + chunk * 2 * per;
    o[e] = __uint_as_float(hi);  // e == tf32_core_offset(n, k, KC)
    o[per + e] = __uint_as_float(lo);
  } else {
    out[chunk * per + e] = k < C::KC ? w[src] : mgn::from_f<T>(0.f);
  }
}

// Element i of the node stream: per round, K3's products — the node MLP's
// weight rows, the first layer's 2L, then each hidden layer's L — and,
// with adjoint, K5's after them, B = W^T of the hidden layers n-1 .. 1 and
// of the first layer's two row blocks (the v part, then the agg part), L
// rows each; every row padded to PW with zeros, so that KC rows are one
// contiguous ring-stage image.
template <typename T, int L>
__device__ __forceinline__ void node_stream_elem(const MlpParams& p, int adjoint, T* out,
                                                 long long i) {
  constexpr int PW = NodeTile<T, L>::PW;
  const int fwd = (1 + p.n_layers) * L * PW;  // K3's part of a round
  const long long r = i / (adjoint ? 2 * fwd : fwd);
  const int e = static_cast<int>(i - r * (adjoint ? 2 * fwd : fwd));
  const int row = (e < fwd ? e : e - fwd) / PW, col = e % PW;
  if (e < fwd) {
    const int h = row - 2 * L;  // row of the hidden layers' part
    const T* w = h < 0 ? static_cast<const T*>(p.w[0]) + (r * 2 * L + row) * L
                       : static_cast<const T*>(p.w[1 + h / L]) + (r * L + h % L) * L;
    out[i] = col < L ? w[col] : mgn::from_f<T>(0.f);
  } else {
    // B[k][n] = W[n][k] of the product's (L, L) block, k = row % L, n = col
    const int H = p.n_layers - 1, blk = row / L;
    const int layer = blk < H ? H - blk : 0, part = blk < H ? 0 : blk - H;
    const T* w = static_cast<const T*>(p.w[layer]) +
                 (r * (layer == 0 ? 2 : 1) * L + part * L + col) * L;
    out[i] = col < L ? w[row % L] : mgn::from_f<T>(0.f);
  }
}

// Element i of the projection stream (K7's): per round, the first
// layer's sender rows W0[L:2L], then its receiver rows W0[2L:3L] — with
// adjoint, then K8's (fused_round_bwd.cu), B = W^T of the same two row
// blocks — each padded to PW with zeros, as the node stream lays out its
// rows.  Fewer than 2^31 elements in all (the launch checks), so 32-bit
// index math.
template <typename T, int L>
__device__ __forceinline__ void proj_stream_elem(const MlpParams& p, int adjoint, T* out, int i) {
  constexpr int PW = NodeTile<T, L>::PW;
  const int per = (adjoint ? 4 : 2) * L * PW;
  const int r = i / per, row = (i % per) / PW, col = i % PW;
  const T* w0 = static_cast<const T*>(p.w[0]) + static_cast<size_t>(r) * 3 * L * L;
  if (col >= L) {
    out[i] = mgn::from_f<T>(0.f);
  } else if (row < 2 * L) {
    out[i] = w0[static_cast<size_t>(L + row) * L + col];
  } else {  // B[k][n] = W0[L + blk L + n][k], k = row % L, n = col
    const int blk = (row - 2 * L) / L, k = row % L;
    out[i] = w0[static_cast<size_t>(L + blk * L + col) * L + k];
  }
}

// Every weight stream of a forward, every round, in one launch: one thread
// per element, the edge stream's total_e first, then the node stream's
// total_n, then the projection stream's.  adjoint: each round's edge stream
// also holds K4's products, its node stream K5's and its projection stream
// K8's.  pe.w[l] and pn.w[l]
// point at the (rounds, in, L) stacks of the cast weights.
template <typename T, int L>
__global__ void weight_streams_kernel(MlpParams pe, MlpParams pn, int adjoint,
                                      T* __restrict__ out_e, T* __restrict__ out_n,
                                      T* __restrict__ out_p, long long total_e,
                                      long long total_en, long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  if (i < total_e) {
    edge_stream_elem<T, L>(pe, adjoint ? 2 * pe.n_layers + 2 : pe.n_layers, out_e, i);
  } else if (i < total_en) {
    node_stream_elem<T, L>(pn, adjoint, out_n, i - total_e);
  } else {
    proj_stream_elem<T, L>(pe, adjoint, out_p, static_cast<int>(i - total_en));
  }
}

// --- launches ------------------------------------------------------------------

bool params_ok(const MlpParams* p) {
  return p != nullptr && p->n_layers >= 1 && p->n_layers <= mgn::kMaxLayers;
}

template <typename T, int L>
int launch_edge(void* e, void* msg, const float* P, const float* Q, const int* senders,
                const int* receivers, const void* edge_valid, int n_edges, const MlpParams& p,
                const unsigned char* wstream, cudaStream_t s) {
  using C = EdgeTile<T, L>;
  const cudaError_t rc = cudaFuncSetAttribute(
      edge_round_kernel<T, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((n_edges + C::kRows - 1) / C::kRows), block(C::kThreads);
  edge_round_kernel<T, L><<<grid, block, C::kSmem, s>>>(
      static_cast<T*>(e), static_cast<T*>(msg), P, Q, senders, receivers,
      static_cast<const T*>(edge_valid), n_edges, p, wstream);
  return 0;
}

template <typename T, int L>
int launch_project(const void* v, float* P, float* Q, int n_nodes, const void* wstream,
                   cudaStream_t s) {
  using C = NodeTile<T, L>;
  const cudaError_t rc = cudaFuncSetAttribute(
      edge_project_kernel<T, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((n_nodes + C::kRows - 1) / C::kRows), block(C::kThreads);
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

// pe / pn null: no edge and projection / no node stream; adjoint: K4's,
// K5's and K8's products too.
template <typename T, int L>
int launch_streams(const MlpParams* pe, const MlpParams* pn, int n_rounds, int adjoint,
                   void* out_e, void* out_n, void* out_p, cudaStream_t s) {
  const int twice = adjoint ? 2 : 1;
  const int edge_products = pe == nullptr ? 0 : adjoint ? 2 * pe->n_layers + 2 : pe->n_layers;
  const long long total_e = static_cast<long long>(n_rounds) * edge_products *
                            EdgeTile<T, L>::kChunks * mgn::stage_elems<T, L>();
  const long long total_n = pn == nullptr ? 0
      : static_cast<long long>(n_rounds) * (1 + pn->n_layers) * twice * L * NodeTile<T, L>::PW;
  const long long total_p = pe == nullptr ? 0
      : static_cast<long long>(n_rounds) * 2 * twice * L * NodeTile<T, L>::PW;
  if (total_p >= (1LL << 31)) return cudaErrorInvalidValue;
  const MlpParams none{};
  const unsigned blocks = static_cast<unsigned>((total_e + total_n + total_p + 255) / 256);
  weight_streams_kernel<T, L><<<blocks, 256, 0, s>>>(
      pe ? *pe : none, pn ? *pn : none, adjoint, static_cast<T*>(out_e),
      static_cast<T*>(out_n), static_cast<T*>(out_p), total_e, total_e + total_n,
      total_e + total_n + total_p);
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

int project_any(int dtype, int latent, const void* v, float* P, float* Q, int n_nodes,
                const void* wstream, cudaStream_t s) {
  MGN_DISPATCH(launch_project, v, P, Q, n_nodes, wstream, s);
}

int node_any(int dtype, int latent, void* v, const float* agg, const float* extra, int n_nodes,
             const MlpParams& p, const void* wstream, cudaStream_t s) {
  MGN_DISPATCH(launch_node, v, agg, extra, n_nodes, p, wstream, s);
}

int streams_any(int dtype, int latent, const MlpParams* pe, const MlpParams* pn, int n_rounds,
                int adjoint, void* out_e, void* out_n, void* out_p, cudaStream_t s) {
  MGN_DISPATCH(launch_streams, pe, pn, n_rounds, adjoint, out_e, out_n, out_p, s);
}

#undef MGN_DISPATCH

int finish(int rc) { return rc != 0 ? rc : static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (the compute dtype of e, msg,
// edge_valid and the weights and biases).  e is updated in place and msg
// written; P and Q are K7's f32 (n_nodes, latent) projections of the
// round's v; wstream is the round's forward part of mgn_weight_streams'
// edge stream.  Returns cudaGetLastError() after the launch (0 on success).
int mgn_edge_round(int dtype, int latent, void* e, void* msg, const float* P, const float* Q,
                   const int* senders, const int* receivers, const void* edge_valid,
                   int n_edges, const MlpParams* params, const void* wstream, void* stream) {
  if (n_edges <= 0 || !params_ok(params) || wstream == nullptr || P == nullptr || Q == nullptr)
    return cudaErrorInvalidValue;
  return finish(edge_any(dtype, latent, e, msg, P, Q, senders, receivers, edge_valid, n_edges,
                         *params, static_cast<const unsigned char*>(wstream),
                         static_cast<cudaStream_t>(stream)));
}

// K7: P = v.W0[L:2L] and Q = v.W0[2L:3L] in f32 for the n_nodes rows of v
// (compute dtype); wstream is the round's row of mgn_weight_streams'
// projection stream.
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
  if (n_nodes <= 0 || !params_ok(params) || wstream == nullptr) return cudaErrorInvalidValue;
  return finish(node_any(dtype, latent, v, agg, extra, n_nodes, *params, wstream,
                         static_cast<cudaStream_t>(stream)));
}

// K2's, K3's and K7's weight streams for n_rounds rounds of the edge and
// node MLPs, written to out_edge, out_node and out_proj (the edge MLP's
// first-layer projections); edge->w[l] and node->w[l] are the (n_rounds,
// in, L) stacks of the cast weights.  Either MLP may be null (no stream
// for it; the edge MLP's null: no edge and no projection stream).
// adjoint != 0: each round's edge stream also holds K4's adjoint products,
// after K2's, its node stream K5's, after K3's, and its projection stream
// K8's, after K7's.
int mgn_weight_streams(int dtype, int latent, const MlpParams* edge, const MlpParams* node,
                       int n_rounds, int adjoint, void* out_edge, void* out_node,
                       void* out_proj, void* stream) {
  if (n_rounds <= 0 || (edge == nullptr && node == nullptr) ||
      (edge != nullptr && (!params_ok(edge) || out_edge == nullptr || out_proj == nullptr)) ||
      (node != nullptr && (!params_ok(node) || out_node == nullptr)))
    return cudaErrorInvalidValue;
  return finish(streams_any(dtype, latent, edge, node, n_rounds, adjoint, out_edge, out_node,
                            out_proj, static_cast<cudaStream_t>(stream)));
}

const char* mgn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
