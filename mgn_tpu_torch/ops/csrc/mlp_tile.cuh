// The processor MLP's parameters and the dtype helpers shared by the round
// kernels (K2/K4 through edge_tile.cuh, K3/K5 through node_tile.cuh).
//
// Rounding matches mgn_tpu/models/mlp.py:apply_mlp_parts, the reference the
// JAX tests hold the fused kernel against (process_rounds_xla): weights and
// inputs are in the compute dtype T, products accumulate in f32, the sum is
// rounded to T, the bias (in T) is added in T, and LayerNorm runs in f32 with
// its output rounded to T.  (The TPU kernel adds f32 master biases instead.)
// The kernels are instantiated for L = 32, 64, 128 and 256.  A model whose
// latent width is another one, up to 256, runs on the next of those tiles
// (ops/fused.py:fused_process pads it): its weights, biases and LayerNorm
// parameters are zero past the real width, so every padded column of every
// activation stays exactly zero, and only the LayerNorm's statistics and its
// adjoint need the real width, MlpParams::real.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace mgn {

constexpr int kMaxLayers = 8;

// One processor round of one MLP; the layout must match ops/_build.py's
// MlpParams.  All layers are (L, L) except the first, (parts * L, L).
struct MlpParams {
  const void* w[kMaxLayers];  // (in, L) row-major, compute dtype
  const void* b[kMaxLayers];  // (L,), compute dtype
  const float* ln_scale;      // (L,) f32
  const float* ln_bias;       // (L,) f32
  int n_layers;
  int real;  // the model's width, 1 <= real <= L: columns past it are padding
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

}  // namespace mgn
