// Shared device routine of K2 (edge_round) and K3 (node_round): the
// processor MLP of mgn_tpu/ops/fused.py:_mlp_fwd — a first layer computed
// part by part with no concat, hidden layers with ReLU, then LayerNorm — on a
// tile of rows held by one warp.
//
// Rounding matches mgn_tpu/models/mlp.py:apply_mlp_parts, the reference the
// JAX tests hold the fused kernel against (process_rounds_xla): weights and
// inputs are in the compute dtype T, products accumulate in f32, the sum is
// rounded to T, the bias (in T) is added in T, and LayerNorm runs in f32 with
// its output rounded to T.  (The TPU kernel adds f32 master biases instead.)
//
// Work split: a warp owns R rows and all L columns; lane l holds columns
// [l*C, l*C + C), C = L/32, of each of its rows in registers.  Its rows are
// staged as f32 in the warp's own slice of shared memory, so warps never
// wait for one another.  Each 4-deep step of the k loop reads four weight
// rows (C values per lane, coalesced across the warp, served from L1/L2 —
// every warp of the grid reads the same weights) and one 16-byte broadcast
// of each staged row, then issues 4*R*C FMAs.  The kernels are instantiated
// for L = 32, 64, 128 and 256.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace mgn {

constexpr int kMaxLayers = 8;
constexpr int kTileWarps = 8;  // warps per block

// One processor round of one MLP; the layout must match ops/_build.py's
// MlpParams.  All layers are (L, L) except the first, (parts * L, L).
struct MlpParams {
  const void* w[kMaxLayers];  // (in, L) row-major, compute dtype
  const void* b[kMaxLayers];  // (L,), compute dtype
  const float* ln_scale;      // (L,) f32
  const float* ln_bias;       // (L,) f32
  int n_layers;
};

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round an f32 value to T and back (round to nearest even, as astype does).
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f<T>(from_f<T>(x));
}

// N consecutive values moved as one access (16 bytes at most per load, so
// 16-byte alignment suffices; ops/fused.py checks it).
template <typename T, int N>
struct alignas(sizeof(T) * N < 16 ? sizeof(T) * N : 16) Pack {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ void load_pack(const T* p, float (&x)[N]) {
  const Pack<T, N> t = *reinterpret_cast<const Pack<T, N>*>(p);
#pragma unroll
  for (int j = 0; j < N; ++j) x[j] = to_f<T>(t.v[j]);
}

template <typename T, int N>
__device__ __forceinline__ void store_pack(T* p, const float (&x)[N]) {
  Pack<T, N> t;
#pragma unroll
  for (int j = 0; j < N; ++j) t.v[j] = from_f<T>(x[j]);
  *reinterpret_cast<Pack<T, N>*>(p) = t;
}

__device__ __forceinline__ float warp_sum(float v) {
  // butterfly: every lane ends with the same value (each step adds the same
  // two operands on both lanes of a pair)
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// xs[i][:] = src[idx[i]][:] rounded to T (zeros where idx[i] < 0).
// S is the source's element type (T, or f32 for the node stage's aggregate).
template <typename T, typename S, int L, int R>
__device__ __forceinline__ void warp_stage(float* xs, const S* __restrict__ src,
                                           const int (&idx)[R], int lane) {
  constexpr int C = L / 32;
  __syncwarp();  // the previous contents may still be read by other lanes
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float x[C];
    if (idx[i] >= 0) {
      load_pack<S, C>(src + static_cast<size_t>(idx[i]) * L + lane * C, x);
#pragma unroll
      for (int j = 0; j < C; ++j) x[j] = rnd<T>(x[j]);
    } else {
#pragma unroll
      for (int j = 0; j < C; ++j) x[j] = 0.f;
    }
    store_pack<float, C>(xs + i * L + lane * C, x);
  }
  __syncwarp();
}

// acc[i][j] += sum_k xs[i][k] * w[k*ld + lane*C + j], k = 0 .. L-1 in order.
// ld is w's row stride (L for an (L, L) block; the backward reads column
// blocks of a transposed (L, parts*L) first-layer weight with ld = parts*L).
template <typename T, int L, int R>
__device__ __forceinline__ void warp_matmul(float (&acc)[R][L / 32], const float* xs,
                                            const T* __restrict__ w, int lane, int ld = L) {
  constexpr int C = L / 32;
  const T* wl = w + lane * C;
#pragma unroll 2
  for (int k = 0; k < L; k += 4) {
    float wk[4][C];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      load_pack<T, C>(wl + static_cast<size_t>(k + kk) * ld, wk[kk]);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float x[4];
      load_pack<float, 4>(xs + i * L + k, x);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int j = 0; j < C; ++j) acc[i][j] = fmaf(x[kk], wk[kk][j], acc[i][j]);
      }
    }
  }
}

// acc holds the first layer's f32 products.  Applies the first bias, the
// remaining layers (ReLU, matmul, bias) and the LayerNorm; leaves the
// LayerNorm output, rounded to T, in acc.  xs is the warp's staging slice.
template <typename T, int L, int R>
__device__ __forceinline__ void warp_mlp_tail(float (&acc)[R][L / 32], float* xs,
                                              const MlpParams& p, int lane) {
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
        store_pack<float, C>(xs + i * L + lane * C, h);
      }
      __syncwarp();
      warp_matmul<T, L, R>(acc, xs, static_cast<const T*>(p.w[layer]), lane);
    }
    float bias[C];
    load_pack<T, C>(static_cast<const T*>(p.b[layer]) + lane * C, bias);
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < C; ++j) acc[i][j] = rnd<T>(rnd<T>(acc[i][j]) + bias[j]);
    }
  }
  float scale[C], shift[C];
  load_pack<float, C>(p.ln_scale + lane * C, scale);
  load_pack<float, C>(p.ln_bias + lane * C, shift);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < C; ++j) s += acc[i][j];
    const float mean = warp_sum(s) / L;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const float d = acc[i][j] - mean;
      q += d * d;
    }
    const float var = warp_sum(q) / L;
    const float rstd = 1.0f / sqrtf(var + 1e-5f);
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const float xhat = (acc[i][j] - mean) * rstd;
      acc[i][j] = rnd<T>(xhat * scale[j] + shift[j]);
    }
  }
}

}  // namespace mgn
