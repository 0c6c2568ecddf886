// K1 — CSR segment-sum for Hopper (sm_90a).
//
//   out[n, :] = sum over j in [row_offsets[n], row_offsets[n+1]) of data[p(j), :]
//
//   data (E, F) f32 or bf16, row-major; row_offsets (N+1,) int32;
//   out (N, F) f32.  F must be a multiple of 4.  p(j) = j, or perm[j] when
//   an int32 permutation perm (E,) is given: the backward sums the sender
//   cotangents through the template's sender-sorted permutation, so senders
//   get a CSR row each like receivers do, again with no atomics.
//
// Replaces: mgn_tpu/ops/pallas_segment.py:_kernel_vmem (edge array resident
// in VMEM) and :_kernel (edges streamed from HBM), both reached through
// csr_segment_sum.  The TPU kernels turn the scatter into one-hot MXU matmuls
// because the TPU has no vector gather, and split on whether the edge array
// fits VMEM.  Neither reason exists here: edges are receiver-sorted, so a
// node's incoming edges are one contiguous run of rows, and one row-parallel
// kernel serves every graph size.
//
// Bound: bytes.  Every edge row is read once (E*F*itemsize), every node row
// written once (N*F*4); there is one add per element read, far below the
// card's add rate.
//
// Design: one block of 4 warps per node row.  A lane owns 4 adjacent columns,
// so each edge row is one 16-byte (f32) or 8-byte (bf16) load per lane and a
// warp reads 128 columns of a row in one coalesced transaction.  Warp w sums
// edges w, w+4, w+8, ... of the row in f32 registers, with four loads in
// flight per iteration; the four partial sums are then added in a fixed
// order through shared memory.  There are no atomics and every order is
// fixed, so the result is the same from run to run.  Splitting a row over
// four warps keeps the long rows (the padded trash row N-1 collects every
// dead edge) from serialising on one warp.  An empty row writes zeros.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kWarps = 4;               // warps per row
constexpr int kVec = 4;                 // columns per lane
constexpr int kColsPerPass = 32 * kVec; // columns per warp pass

struct alignas(16) F4 { float v[4]; };
struct alignas(8) B4 { __nv_bfloat16 v[4]; };

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const F4 t = *reinterpret_cast<const F4*>(p);
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] = t.v[j];
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const B4 t = *reinterpret_cast<const B4*>(p);
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] = __bfloat162float(t.v[j]);
}

// The data row of the j-th entry of a CSR row.
__device__ __forceinline__ int src(const int* __restrict__ perm, int j) {
  return perm != nullptr ? perm[j] : j;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
csr_segment_sum_kernel(const T* __restrict__ data,
                       const int* __restrict__ row_offsets,
                       const int* __restrict__ perm,
                       float* __restrict__ out, int f) {
  __shared__ F4 part[kWarps][32];
  const int row = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int begin = row_offsets[row];
  const int end = row_offsets[row + 1];

  for (int c0 = 0; c0 < f; c0 += kColsPerPass) {
    const int c = c0 + lane * kVec;
    const bool active = c < f;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (active) {
      const T* base = data + c;
      int e = begin + warp;
      for (; e + 3 * kWarps < end; e += 4 * kWarps) {
        float x0[4], x1[4], x2[4], x3[4];
        load4(base + static_cast<size_t>(src(perm, e)) * f, x0);
        load4(base + static_cast<size_t>(src(perm, e + kWarps)) * f, x1);
        load4(base + static_cast<size_t>(src(perm, e + 2 * kWarps)) * f, x2);
        load4(base + static_cast<size_t>(src(perm, e + 3 * kWarps)) * f, x3);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[j] += x0[j];
          acc[j] += x1[j];
          acc[j] += x2[j];
          acc[j] += x3[j];
        }
      }
      for (; e < end; e += kWarps) {
        float x[4];
        load4(base + static_cast<size_t>(src(perm, e)) * f, x);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] += x[j];
      }
    }
    F4 t;
#pragma unroll
    for (int j = 0; j < 4; ++j) t.v[j] = acc[j];
    part[warp][lane] = t;
    __syncthreads();
    if (warp == 0 && active) {
      F4 s = part[0][lane];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s.v[j] += part[w][lane].v[j];
      }
      *reinterpret_cast<F4*>(out + static_cast<size_t>(row) * f + c) = s;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  perm may be null (identity).  Returns
// cudaGetLastError() after the launch (0 on success).
int mgn_csr_segment_sum(const void* data, int dtype, const int* row_offsets,
                        const int* perm, float* out, int n_rows, int f, void* stream) {
  if (n_rows <= 0 || f <= 0 || f % kVec != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_rows), block(kWarps * 32);
  if (dtype == 0) {
    csr_segment_sum_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(data), row_offsets, perm, out, f);
  } else if (dtype == 1) {
    csr_segment_sum_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(data), row_offsets, perm, out, f);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* mgn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
