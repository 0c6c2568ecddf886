// K6 (wgrad) — weight and bias gradients of one processor-MLP layer for
// Hopper (sm_90a), in f32:
//
//   dw[a][b] = sum over rows of x[row'][a] * dh[row][b]    (row' = idx[row] or row)
//   db[b]    = sum over rows of dh[row][b]
//
//   x (rows or N, A) and dh (rows, B) in the compute dtype (f32 or bf16),
//   idx optional int32 (rows,) — a row gather of x, so the first layer's
//   v[senders] / v[receivers] inputs are never materialised; dw (A, B) and
//   db (B,) f32.  With x null only db is computed (the column sums that
//   reduce K4/K5's per-warp LayerNorm partial sums).
//
// Replaces: the weight-gradient reductions inside the TPU backward kernel
// mgn_tpu/ops/fused.py:_make_bwd_kernel (the per-chunk `_wgrad` and
// bias sums of _mlp_bwd, or the batched (E,L)^T@(E,L) of batch_wgrads),
// which accumulate into one VMEM scratch as the sequential TPU grid walks the
// chunks.  GPU blocks run in no order, so the sum is split instead: pass 1
// gives each block one (TILE x TILE) output tile and one contiguous split of
// the rows and writes its partial sums; pass 2 adds the splits for every
// output in split order.  No atomics: the result is the same from run to run.
//
// Bound on this card: operations, 2 * rows * A * B FLOP (edge MLP, first
// layer, one round at the cylinder size: 2 * 11,264 * 384 * 128 = 1.1 GFLOP)
// against (rows * (A + B)) elements read.  Design: 256 threads per block, 16
// rows of x and dh staged per step in shared memory as f32, each thread
// holds a (TILE/16)^2 register tile of products; the host picks the number
// of splits so that about two blocks run per SM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kChunk = 16;     // rows staged per step

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int TILE>
__global__ void __launch_bounds__(kThreads)
wgrad_partial_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                     const T* __restrict__ dh, int rows, int rows_per_split, int a_dim,
                     int b_dim, float* __restrict__ partial) {
  constexpr int M = TILE / 16;
  __shared__ float xs[kChunk][TILE];
  __shared__ float ds[kChunk][TILE];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int b0 = blockIdx.x * TILE, a0 = blockIdx.y * TILE;
  const int split = blockIdx.z;
  const int r_begin = split * rows_per_split;
  const int r_end = min(rows, r_begin + rows_per_split);
  const bool has_x = x != nullptr;
  const bool with_bias = blockIdx.y == 0;

  float acc[M][M], bacc[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    bacc[m] = 0.f;
#pragma unroll
    for (int n = 0; n < M; ++n) acc[m][n] = 0.f;
  }
  for (int r0 = r_begin; r0 < r_end; r0 += kChunk) {
    for (int t = threadIdx.x; t < kChunk * TILE; t += kThreads) {
      const int rr = t / TILE, c = t % TILE;
      const int row = r0 + rr;
      float dv = 0.f, xv = 0.f;
      if (row < r_end) {
        dv = to_f(dh[static_cast<size_t>(row) * b_dim + b0 + c]);
        if (has_x) {
          const int src = idx != nullptr ? idx[row] : row;
          xv = to_f(x[static_cast<size_t>(src) * a_dim + a0 + c]);
        }
      }
      ds[rr][c] = dv;
      xs[rr][c] = xv;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kChunk; ++k) {
      float bv[M];
#pragma unroll
      for (int n = 0; n < M; ++n) bv[n] = ds[k][tx * M + n];
      if (has_x) {
        float av[M];
#pragma unroll
        for (int m = 0; m < M; ++m) av[m] = xs[k][ty * M + m];
#pragma unroll
        for (int m = 0; m < M; ++m) {
#pragma unroll
          for (int n = 0; n < M; ++n) acc[m][n] = fmaf(av[m], bv[n], acc[m][n]);
        }
      }
      if (with_bias && ty == 0) {
#pragma unroll
        for (int n = 0; n < M; ++n) bacc[n] += bv[n];
      }
    }
    __syncthreads();
  }
  // split layout: [A*B products | B column sums]
  const int a_b = has_x ? a_dim * b_dim : 0;
  float* out = partial + static_cast<size_t>(split) * (a_b + b_dim);
  if (has_x) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
#pragma unroll
      for (int n = 0; n < M; ++n)
        out[static_cast<size_t>(a0 + ty * M + m) * b_dim + b0 + tx * M + n] = acc[m][n];
    }
  }
  if (with_bias && ty == 0) {
#pragma unroll
    for (int n = 0; n < M; ++n) out[a_b + b0 + tx * M + n] = bacc[n];
  }
}

// out = sum over splits, in split order.
__global__ void wgrad_reduce_kernel(const float* __restrict__ partial, int splits, int a_b,
                                    int b_dim, float* __restrict__ out_w,
                                    float* __restrict__ out_b) {
  const int n = a_b + b_dim;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[static_cast<size_t>(k) * n + i];
  if (i < a_b) {
    if (out_w != nullptr) out_w[i] = s;
  } else if (out_b != nullptr) {
    out_b[i - a_b] = s;
  }
}

template <typename T, int TILE>
void launch_partial(const void* x, const int* idx, const void* dh, int rows,
                    int rows_per_split, int splits, int a_dim, int b_dim, float* partial,
                    cudaStream_t s) {
  const dim3 grid(b_dim / TILE, x != nullptr ? a_dim / TILE : 1, splits);
  wgrad_partial_kernel<T, TILE><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), idx, static_cast<const T*>(dh), rows, rows_per_split, a_dim,
      b_dim, partial);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (of x and dh).  tile: 32 or 64, dividing
// a_dim and b_dim.  partial: (splits, a_dim*b_dim + b_dim) f32 scratch
// (a_dim*b_dim taken as 0 when x is null).  out_w (a_dim, b_dim) and out_b
// (b_dim,) f32 may each be null.  Returns cudaGetLastError() after the two
// launches (0 on success).
int mgn_wgrad(int dtype, const void* x, const int* idx, const void* dh, int rows, int a_dim,
              int b_dim, int tile, int splits, int rows_per_split, float* partial,
              float* out_w, float* out_b, void* stream) {
  if (rows <= 0 || splits <= 0 || rows_per_split <= 0 || b_dim <= 0 ||
      (x != nullptr && a_dim <= 0) || (tile != 32 && tile != 64) || b_dim % tile ||
      (x != nullptr && a_dim % tile) || static_cast<long long>(splits) * rows_per_split < rows)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MGN_PARTIAL(T, TILE) \
  launch_partial<T, TILE>(x, idx, dh, rows, rows_per_split, splits, a_dim, b_dim, partial, s)
  if (dtype == 0) {
    if (tile == 64) MGN_PARTIAL(float, 64);
    else MGN_PARTIAL(float, 32);
  } else if (dtype == 1) {
    if (tile == 64) MGN_PARTIAL(__nv_bfloat16, 64);
    else MGN_PARTIAL(__nv_bfloat16, 32);
  } else {
    return cudaErrorInvalidValue;
  }
#undef MGN_PARTIAL
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int a_b = x != nullptr ? a_dim * b_dim : 0;
  const int n = a_b + b_dim;
  wgrad_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(partial, splits, a_b, b_dim, out_w,
                                                      out_b);
  return static_cast<int>(cudaGetLastError());
}

const char* mgn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
