// K6 (wgrad) — every weight, bias and LayerNorm gradient of one processor-MLP
// round in one grouped launch (plus one launch that adds the row splits),
// for Hopper (sm_90a), on the tensor cores:
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
//   and dh split into TF32 high and low parts, two m16n8k8 products a
//   K-step (f32 x f32, as JAX promotes them; G is never rounded to bf16).
//   ops/fused.py:wgrad_plan lays the group out.
//
// Replaces: the weight-gradient reductions of the TPU backward kernel
// mgn_tpu/ops/fused.py:_make_bwd_kernel (the per-chunk `_wgrad` of _mlp_bwd,
// :288, and the bias and LayerNorm sums), which accumulate into VMEM scratch
// as the sequential TPU grid walks the chunks.  GPU blocks run in no order,
// so the row axis is split instead: pass 1 gives each block one output tile
// of one product (one part) and one contiguous split of the rows and writes
// its partial sums; pass 2 adds the splits of every output in split order.
// No atomics, so a gradient has the same bits from run to run.
//
// Bound on this card, one cylinder round in f32 (E 11,264, N 1,920, L 128,
// 2 hidden layers, both MLPs): 2.10 GFLOP, and each input read once is about
// 45 MB — 13.4 us at 3.35 TB/s, 12.7 us at the 3xTF32 rate (495/3 TFLOP/s),
// so the two bounds meet.  Design: the product is x^T dh with the row axis
// as the reduction axis, and both operands are row-major (rows, ·) in
// memory, i.e. M- and N-contiguous for the MMA.  A block of 4 warps owns a
// 64 x 64 output tile (32 x 32 below latent 64), 32 x 32 per warp; 32-row
// chunks of x (gathered rows through idx) and dh stream into a double-
// buffered shared-memory ring with cp.async, 16 bytes a thread; fragments
// are read from that ring in the transposed layouts (mma_tile.cuh: load_a_m,
// load_b_n) and multiplied with mma.sync — bf16 directly, f32 through 3xTF32.
// The host picks the splits so that each product fills about two blocks per
// SM.  (Hopper's wgmma would take the bf16 operands MN-major from shared
// memory but TF32 only K-major; one mma.sync route serves both dtypes.)
// The ring is fed by cp.async and not by TMA: two of the first layer's
// three x parts are row gathers (v[senders], v[receivers]), which TMA on
// sm_90 cannot do, and the contiguous operands are 32-row boxes of 64
// columns out of (rows, L) arrays — a tiled tensor map per operand of each
// of a call's products, each built on the host (cuTensorMapEncodeTiled),
// or one bulk copy a row.  Each thread issues 4 + 4 16-byte copies a chunk
// (f32).
// The one contiguous stream of the backward, K4's f32 weight chunks, did
// move to the bulk-copy engine (fused_round_bwd.cu), which made K4 11 %
// faster; K6 streams no such block.

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
  long long scratch0;              // first float of this product's partial sums in the scratch
  long long out0;                  // first output of this product in pass 2's numbering
  int parts, rows, a_dim, b_dim, b_split, dh_f32;
  int tiles_a, tiles_b, splits, rows_per_split;
  int job0;                        // first block of this product in pass 1's grid
};

struct WgradGroup {
  WgradProduct p[kWgradMaxProducts];
  int n_products;
  int n_jobs;
  long long n_out;
};

}  // namespace mgn

namespace {

using mgn::Mma;
using mgn::WgradGroup;
using mgn::WgradProduct;

constexpr int kThreads = 128;  // 4 warps, 2 x 2 over the output tile
constexpr int kChunk = 32;     // rows per ring stage (ops/fused.py _WGRAD_CHUNK)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ int find_product(const WgradGroup& g, int job) {
  int i = 0;
  while (i + 1 < g.n_products && g.p[i + 1].job0 <= job) ++i;
  return i;
}

// Column sums of rows [r0, r1) of dh, one thread per column of the tile.
template <typename S>
__device__ __forceinline__ float column_sum(const S* dh, int b_dim, int col, int r0, int r1) {
  float s = 0.f;
  for (int r = r0; r < r1; ++r) s += to_f(dh[static_cast<size_t>(r) * b_dim + col]);
  return s;
}

// The ring of one block: two stages of x rows and of dh rows.  The mixed
// form (bf16 x, f32 dh) keeps its dh stages in f32.
template <typename T, int TILE>
struct WgradRing {
  static constexpr int P = TILE + mgn::smem_pad_mn<T>();       // row pitch (elements)
  static constexpr int PF = TILE + mgn::smem_pad_mn<float>();  // f32 dh rows (mixed)
  static constexpr size_t kX = size_t(2) * kChunk * P * sizeof(T);
  static constexpr size_t kPlain = 2 * kX;
  static constexpr size_t kMixed = sizeof(T) == 4 ? 0 : kX + size_t(2) * kChunk * PF * 4;
  static constexpr size_t kBytes = kPlain > kMixed ? kPlain : kMixed;
};

// The mixed form's product on a bf16 group: dw_tile += x^T dh over rows
// [r_begin, r_end) with bf16 x (M-contiguous, exact in TF32) and f32 dh
// (N-contiguous, split into TF32 high and low parts), lo*x + hi*x a K-step
// in a fresh accumulator added in round-to-nearest; bsum the tile's column
// sums of dh where with_bias.
template <int TILE, int MI, int NI>
__device__ __forceinline__ void mixed_product(const __nv_bfloat16* __restrict__ x,
                                              const int* __restrict__ idx,
                                              const float* __restrict__ dh, int a_dim,
                                              int b_dim, int a0, int b0, int r_begin,
                                              int r_end, bool with_bias,
                                              unsigned char* smem, float (&acc)[MI][NI][4],
                                              float& bsum) {
  using B16 = __nv_bfloat16;
  using MF = Mma<float>;
  using R = WgradRing<B16, TILE>;
  constexpr int P = R::P, PF = R::PF, WT = TILE / 2;
  constexpr int OX = TILE * 2 / 16, OD = TILE * 4 / 16;  // 16-byte copies per row
  B16* xs = reinterpret_cast<B16*>(smem);
  float* ds = reinterpret_cast<float*>(smem + R::kX);
  const int tid = threadIdx.x;
  auto issue = [&](int chunk, int stage) {
    const int r0 = r_begin + chunk * kChunk;
    for (int i = tid; i < kChunk * OX; i += kThreads) {
      const int rr = i / OX, c = (i % OX) * 8, row = r0 + rr;
      const bool ok = row < r_end;
      const int src = ok ? (idx != nullptr ? idx[row] : row) : 0;
      mgn::cp_async16(xs + stage * kChunk * P + rr * P + c,
                      x + static_cast<size_t>(src) * a_dim + a0 + c, ok);
    }
    for (int i = tid; i < kChunk * OD; i += kThreads) {
      const int rr = i / OD, c = (i % OD) * 4, row = r0 + rr;
      const bool ok = row < r_end;
      mgn::cp_async16(ds + stage * kChunk * PF + rr * PF + c,
                      dh + static_cast<size_t>(ok ? row : 0) * b_dim + b0 + c, ok);
    }
    mgn::cp_async_commit();
  };
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int wm = (warp & 1) * WT, wn = (warp >> 1) * WT;
  const int chunks = (r_end - r_begin + kChunk - 1) / kChunk;
  if (chunks > 0) issue(0, 0);
  for (int c = 0; c < chunks; ++c) {
    const int s = c & 1;
    if (c + 1 < chunks) {
      issue(c + 1, s ^ 1);
      mgn::cp_async_wait<1>();
    } else {
      mgn::cp_async_wait<0>();
    }
    __syncthreads();
    const B16* xc = xs + s * kChunk * P;
    const float* dc = ds + s * kChunk * PF;
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += MF::K) {
      uint32_t a[MI][4];  // A[m][k] = x[k][m]: rows g, g + 8 and columns t, t + 4
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const B16* p = xc + (kk + t) * P + wm + i * 16 + g;
        a[i][0] = __float_as_uint(__bfloat162float(p[0]));
        a[i][1] = __float_as_uint(__bfloat162float(p[8]));
        a[i][2] = __float_as_uint(__bfloat162float(p[4 * P]));
        a[i][3] = __float_as_uint(__bfloat162float(p[4 * P + 8]));
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        typename MF::B b;
        MF::load_b_n(b, dc, PF, wn + j * 8, kk, lane);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          float tt[4] = {0.f, 0.f, 0.f, 0.f};
          MF::one(tt, a[i], b.lo);
          MF::one(tt, a[i], b.hi);
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[i][j][k] += tt[k];
        }
      }
    }
    if (with_bias && tid < TILE) {
#pragma unroll 8
      for (int k = 0; k < kChunk; ++k) bsum += dc[k * PF + tid];
    }
    __syncthreads();
  }
}

template <typename T, int TILE>
__global__ void __launch_bounds__(kThreads)
wgrad_partial_kernel(const __grid_constant__ WgradGroup g, float* __restrict__ scratch) {
  using M = Mma<T>;
  using R = WgradRing<T, TILE>;
  constexpr int P = R::P;     // ring row pitch (elements)
  constexpr int WT = TILE / 2;  // warp tile
  constexpr int MI = WT / 16, NI = WT / 8;
  constexpr int OPS = TILE * static_cast<int>(sizeof(T)) / 16;  // 16-byte copies per row
  __shared__ __align__(16) unsigned char smem[R::kBytes];
  T(*xs)[kChunk * P] = reinterpret_cast<T(*)[kChunk * P]>(smem);
  T(*ds)[kChunk * P] = reinterpret_cast<T(*)[kChunk * P]>(smem + R::kX);

  const int job = blockIdx.x;
  const WgradProduct& q = g.p[find_product(g, job)];
  int local = job - q.job0;
  const int split = local % q.splits;
  local /= q.splits;
  const int tb = local % q.tiles_b;
  local /= q.tiles_b;
  const int ta = local % q.tiles_a;
  const int part = local / q.tiles_a;
  const int r_begin = split * q.rows_per_split;
  const int r_end = min(q.rows, r_begin + q.rows_per_split);
  const int a0 = ta * TILE, b0 = tb * TILE;
  const long long pab = static_cast<long long>(q.parts) * q.a_dim * q.b_dim;
  float* out = scratch + q.scratch0 + split * (pab + q.b_dim);
  const int tid = threadIdx.x;

  if (q.parts == 0) {  // column sums only
    if (tid < TILE) {
      const int col = b0 + tid;
      out[col] = q.dh_f32 ? column_sum(static_cast<const float*>(q.dh), q.b_dim, col, r_begin, r_end)
                          : column_sum(static_cast<const T*>(q.dh), q.b_dim, col, r_begin, r_end);
    }
    return;
  }

  const T* x = static_cast<const T*>(q.x[part]);
  const int* idx = q.idx[part];
  const T* dh = static_cast<const T*>(q.dh);
  const bool with_bias = part == 0 && ta == 0;
  auto issue = [&](int chunk, int stage) {
    const int r0 = r_begin + chunk * kChunk;
    for (int i = tid; i < kChunk * OPS; i += kThreads) {
      const int rr = i / OPS, c = (i % OPS) * (16 / sizeof(T));
      const int row = r0 + rr;
      const bool ok = row < r_end;
      const int src = ok ? (idx != nullptr ? idx[row] : row) : 0;
      mgn::cp_async16(&xs[stage][rr * P + c], x + static_cast<size_t>(src) * q.a_dim + a0 + c, ok);
      mgn::cp_async16(&ds[stage][rr * P + c],
                      dh + static_cast<size_t>(ok ? row : 0) * q.b_dim + b0 + c, ok);
    }
    mgn::cp_async_commit();
  };

  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp & 1) * WT, wn = (warp >> 1) * WT;
  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;
  float bsum = 0.f;

  bool mixed = false;  // the mixed form: an f32 dh beside the bf16 x
  if constexpr (sizeof(T) == 2) mixed = q.dh_f32 != 0;
  if (mixed) {
    if constexpr (sizeof(T) == 2)
      mixed_product<TILE, MI, NI>(x, idx, static_cast<const float*>(q.dh), q.a_dim, q.b_dim,
                                  a0, b0, r_begin, r_end, with_bias, smem, acc, bsum);
  }
  const int chunks = mixed ? 0 : (r_end - r_begin + kChunk - 1) / kChunk;
  if (chunks > 0) issue(0, 0);
  for (int c = 0; c < chunks; ++c) {
    const int s = c & 1;
    if (c + 1 < chunks) {
      issue(c + 1, s ^ 1);
      mgn::cp_async_wait<1>();
    } else {
      mgn::cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += M::K) {
      typename M::A a[MI];
#pragma unroll
      for (int i = 0; i < MI; ++i) M::load_a_m(a[i], xs[s], P, wm + i * 16, kk, lane);
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        typename M::B b;
        M::load_b_n(b, ds[s], P, wn + j * 8, kk, lane);
#pragma unroll
        for (int i = 0; i < MI; ++i) M::mma(acc[i][j], a[i], b);
      }
    }
    if (with_bias && tid < TILE) {
#pragma unroll 8
      for (int k = 0; k < kChunk; ++k) bsum += to_f(ds[s][k * P + tid]);
    }
    __syncthreads();
  }

  // partial sums: [parts*A*B products | B column sums] per split
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int n = b0 + wn + j * 8 + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = part * q.a_dim + a0 + wm + i * 16 + gq + 8 * h;
        *reinterpret_cast<float2*>(out + static_cast<size_t>(m) * q.b_dim + n) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  }
  if (with_bias && tid < TILE) out[pab + b0 + tid] = bsum;
}

// Pass 2: every output of the group is the sum of its splits, in split order.
__global__ void wgrad_reduce_kernel(const __grid_constant__ WgradGroup g,
                                    const float* __restrict__ scratch) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= g.n_out) return;
  int k = 0;
  while (k + 1 < g.n_products && g.p[k + 1].out0 <= i) ++k;
  const WgradProduct& q = g.p[k];
  const long long j = i - q.out0;
  const long long pab = static_cast<long long>(q.parts) * q.a_dim * q.b_dim;
  const long long stride = pab + q.b_dim;
  const float* src = scratch + q.scratch0 + j;
  float s = 0.f;
  for (int sp = 0; sp < q.splits; ++sp) s += src[sp * stride];
  if (j < pab) {
    if (q.dw != nullptr) q.dw[j] = s;
    return;
  }
  const int c = static_cast<int>(j - pab);
  if (c < q.b_split) {
    if (q.db[0] != nullptr) q.db[0][c] = s;
  } else if (q.db[1] != nullptr) {
    q.db[1][c - q.b_split] = s;
  }
}

template <typename T, int TILE>
void launch_partial(const WgradGroup& g, float* scratch, cudaStream_t s) {
  wgrad_partial_kernel<T, TILE><<<g.n_jobs, kThreads, 0, s>>>(g, scratch);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (of every x and of dh where !dh_f32;
// a bf16 product with x and an f32 dh runs the mixed form).
// tile: 64 or 32, dividing every a_dim and b_dim of the group.  scratch:
// the f32 partial sums, sized by ops/fused.py:wgrad_plan.  Returns
// cudaGetLastError() after the two launches (0 on success).
int mgn_wgrad_group(int dtype, int tile, const mgn::WgradGroup* group, float* scratch,
                    void* stream) {
  if (group == nullptr || group->n_products < 1 ||
      group->n_products > mgn::kWgradMaxProducts || group->n_jobs < 1 || group->n_out < 1 ||
      (tile != 32 && tile != 64))
    return cudaErrorInvalidValue;
  for (int i = 0; i < group->n_products; ++i) {
    const WgradProduct& q = group->p[i];
    if (q.parts < 0 || q.parts > mgn::kWgradMaxParts || q.rows <= 0 || q.b_dim % tile ||
        (q.parts > 0 && q.a_dim % tile) || q.splits <= 0 ||
        static_cast<long long>(q.splits) * q.rows_per_split < q.rows)
      return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (tile == 64) launch_partial<float, 64>(*group, scratch, s);
    else launch_partial<float, 32>(*group, scratch, s);
  } else if (dtype == 1) {
    if (tile == 64) launch_partial<__nv_bfloat16, 64>(*group, scratch, s);
    else launch_partial<__nv_bfloat16, 32>(*group, scratch, s);
  } else {
    return cudaErrorInvalidValue;
  }
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int blocks = static_cast<int>((group->n_out + 255) / 256);
  wgrad_reduce_kernel<<<blocks, 256, 0, s>>>(*group, scratch);
  return static_cast<int>(cudaGetLastError());
}

const char* mgn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
