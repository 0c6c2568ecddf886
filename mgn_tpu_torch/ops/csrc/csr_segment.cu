// K1 — CSR segment-sum for Hopper (sm_90a).
//
//   out[n, :] = sum over j in [row_offsets[n], row_offsets[n+1]) of data[p(j), :]
//
//   data (E, F) f32 or bf16, row-major; row_offsets (N+1,) int32;
//   out (N, F) f32, any F >= 1.  p(j) = j, or perm[j] when
//   an int32 permutation perm (E,) is given: the backward sums the sender
//   cotangents through the template's sender-sorted permutation, so senders
//   get a CSR row each like receivers do, again with no atomics.
//
// The fixed order, which the plain version (ops/csr_segment.py,
// csr_segment_sum_plain) keeps bit for bit: row n's entries, in CSR order,
// are cut into chunks of C entries counted from the row's start; each chunk
// is summed left to right from zero in f32 (bf16 widened first), and the
// row's value is its chunk sums added left to right from zero.  C is
// kChunk = 16, whatever the launch; the wrapper passes its CHUNK and the C
// function refuses any other, so the two cannot drift apart.
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
// card's add rate.  One row is far longer than the rest: the padding
// contract sends every dead edge to row N-1 (222 entries at the cylinder,
// 966 at the flag, whose longest real rows have 11 and 6), and the design
// keeps that row from serialising on a few warps.
//
// Design: a block of kWarps warps takes kRows consecutive rows (Rows: 16,
// 8 in bf16's identity form); its first kRows + 1 threads read their offsets
// into shared memory, once.  A lane owns 4 adjacent columns, so each entry is
// one 16-byte (f32) or 8-byte (bf16) load a lane and a warp reads 128
// columns of a row in one coalesced transaction.  Every load of a chunk is
// issued (predicated on the chunk's length) before its first add, so its up
// to C loads are in flight together; the adds stay in order.
//  - A row of at most C entries is one chunk: one warp sums it and stores
//    it, with no block barrier and no shared-memory round trip.
//  - A row of more chunks (the padded trash row N-1, a hub) is taken by the
//    whole block, kWarps chunks a round: each warp sums one chunk and
//    writes it to its shared slot, and after one block barrier the block's
//    first 128 threads, one column each, add the round's chunk sums in
//    chunk order to the row's running sum.  The slots are double-buffered,
//    so one barrier a round suffices.  The cylinder's 222-entry trash row
//    is one round of 14 chunks.
//  - In the perm form every lane loads the chunk's C perm entries itself
//    (each a broadcast load), all before the first data load, so a chunk
//    waits for one perm load, not one before each data load; handing one
//    coalesced load's entries out by shuffles measured slower.
// A chunk's C f32 loads hold 4C registers a lane (2C in bf16): an f32
// block of 16 warps takes a whole SM's registers, so a block takes 16 rows
// (120 blocks at the cylinder, one wave on 132 SMs).  bf16's identity form
// fits in 64 registers and takes 8 rows, two blocks an SM; its perm form
// needs more (the perm entries) and takes 16, so that it too runs in one
// wave.  Streaming a long row's chunks through a shared ring of bulk copies
// (cp.async.bulk) measured no faster than these registers.
// There are no atomics; the order is fixed and independent of the grid, so
// the result is the same from run to run.  An empty row writes zeros.
// Widths that are not a multiple of 4 (a model of latent 90: the world
// set's sums and the gathers' backward run at the model's width) take the
// tail form: a row starts off the 16-byte grid there, so a lane loads and
// stores its 4 columns one value at a time, the columns past F as zeros.
// The order of every sum is the same, so the plain version's bits hold
// there too; widths that are multiples of 4 run the vector form as before.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kChunk = 16;              // C of the fixed order
static_assert(kChunk <= 32, "a chunk's perm entries are one warp load");
constexpr int kWarps = 16;              // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kVec = 4;                 // columns a lane
constexpr int kColsPerPass = 32 * kVec; // columns a warp pass
static_assert(kThreads >= kColsPerPass, "the fold takes one thread a column");

// Rows a block, by the data's type and the form (see the design note).
template <typename T, bool kPerm>
struct Rows {
  static constexpr int value = sizeof(T) == 4 || kPerm ? 16 : 8;
};

struct alignas(16) F4 { float v[4]; };

// A lane's 4 columns of one entry as loaded: 16 bytes of f32, 8 of bf16.
template <typename T> struct Raw;
template <> struct Raw<float> { using type = uint4; };
template <> struct Raw<__nv_bfloat16> { using type = uint2; };

__device__ __forceinline__ void add(float (&acc)[4], uint4 x) {
  acc[0] += __uint_as_float(x.x);
  acc[1] += __uint_as_float(x.y);
  acc[2] += __uint_as_float(x.z);
  acc[3] += __uint_as_float(x.w);
}

// bf16 is the top half of an f32: widening is a shift, exact.
__device__ __forceinline__ void add(float (&acc)[4], uint2 x) {
  acc[0] += __uint_as_float(x.x << 16);
  acc[1] += __uint_as_float(x.x & 0xffff0000u);
  acc[2] += __uint_as_float(x.y << 16);
  acc[3] += __uint_as_float(x.y & 0xffff0000u);
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// One chunk's sum: the entries [j0, j0 + n) of the CSR order (n <= C) at this
// lane's columns [c, c + 4), left to right from zero.  Every load is issued
// before the first add.  A lane whose columns lie past f loads no data and
// returns zeros (kTail: each column past f).
template <typename T, bool kPerm, bool kTail>
__device__ __forceinline__ void chunk_sum(const T* __restrict__ data,
                                          const int* __restrict__ perm, int j0, int n, int c,
                                          int f, int lane, float (&acc)[4]) {
  using R = typename Raw<T>::type;
  const bool active = c < f;
  int q[kChunk];
#pragma unroll
  for (int k = 0; k < kChunk; ++k) q[k] = (kPerm && k < n) ? perm[j0 + k] : 0;
  if constexpr (kTail) {
    float x[kChunk][kVec];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const T* row = data + static_cast<size_t>(kPerm ? q[k] : j0 + k) * f;
#pragma unroll
      for (int j = 0; j < kVec; ++j) x[k][j] = (k < n && c + j < f) ? widen(row[c + j]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] = 0.f;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (active && k < n) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc[j] += x[k][j];
      }
    }
    return;
  }
  R x[kChunk];
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    const int src = kPerm ? q[k] : j0 + k;
    if (active && k < n) {
      x[k] = *reinterpret_cast<const R*>(data + static_cast<size_t>(src) * f + c);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] = 0.f;
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    if (active && k < n) add(acc, x[k]);
  }
}

template <typename T, bool kPerm, bool kTail>
__global__ void __launch_bounds__(kThreads)
csr_segment_sum_kernel(const T* __restrict__ data, const int* __restrict__ row_offsets,
                       const int* __restrict__ perm, float* __restrict__ out,
                       int n_rows, int f) {
  constexpr int kRows = Rows<T, kPerm>::value;
  static_assert(kRows + 1 <= kThreads, "a thread reads each offset");
  __shared__ int off[kRows + 1];
  __shared__ F4 slot[2][kWarps][32];  // a round's chunk sums, double-buffered
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, n_rows - row0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x <= rows) off[threadIdx.x] = row_offsets[row0 + threadIdx.x];
  __syncthreads();

  // rows of one chunk, empty rows included: a warp each
  for (int i = warp; i < rows; i += kWarps) {
    const int begin = off[i], n = off[i + 1] - begin;
    if (n > kChunk) continue;
    float* dst = out + static_cast<size_t>(row0 + i) * f;
    for (int c0 = 0; c0 < f; c0 += kColsPerPass) {
      const int c = c0 + lane * kVec;
      F4 s;
      chunk_sum<T, kPerm, kTail>(data, perm, begin, n, c, f, lane, s.v);
      if constexpr (kTail) {
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          if (c + j < f) dst[c + j] = s.v[j];
      } else if (c < f) {
        *reinterpret_cast<F4*>(dst + c) = s;
      }
    }
  }

  // rows of several chunks: the whole block, kWarps chunks a round, chunk
  // k0 + warp in slot warp
  int buf = 0;
  for (int i = 0; i < rows; ++i) {
    const int begin = off[i], end = off[i + 1];
    if (end - begin <= kChunk) continue;
    const int chunks = (end - begin + kChunk - 1) / kChunk;
    float* dst = out + static_cast<size_t>(row0 + i) * f;
    for (int c0 = 0; c0 < f; c0 += kColsPerPass) {
      float sum = 0.f;  // column c0 + threadIdx.x's running sum (threads < 128)
      for (int k0 = 0; k0 < chunks; k0 += kWarps) {
        const int t = k0 + warp;
        if (t < chunks) {
          const int j0 = begin + t * kChunk;
          F4 s;
          chunk_sum<T, kPerm, kTail>(data, perm, j0, min(kChunk, end - j0), c0 + lane * kVec,
                                     f, lane, s.v);
          slot[buf][warp][lane] = s;
        }
        __syncthreads();
        if (threadIdx.x < kColsPerPass) {
          const float* s = slot[buf][0][0].v;
          const int m = min(kWarps, chunks - k0);
          for (int w = 0; w < m; ++w) sum += s[w * kColsPerPass + threadIdx.x];
        }
        buf ^= 1;
      }
      if (threadIdx.x < kColsPerPass && c0 + threadIdx.x < f) dst[c0 + threadIdx.x] = sum;
    }
  }
}

template <typename T, bool kTail>
cudaError_t launch(const void* data, const int* row_offsets, const int* perm, float* out,
                   int n_rows, int f, cudaStream_t s) {
  const T* d = static_cast<const T*>(data);
  const dim3 block(kThreads);
  if (perm == nullptr) {
    constexpr int kRows = Rows<T, false>::value;
    csr_segment_sum_kernel<T, false, kTail><<<(n_rows + kRows - 1) / kRows, block, 0, s>>>(
        d, row_offsets, perm, out, n_rows, f);
  } else {
    constexpr int kRows = Rows<T, true>::value;
    csr_segment_sum_kernel<T, true, kTail><<<(n_rows + kRows - 1) / kRows, block, 0, s>>>(
        d, row_offsets, perm, out, n_rows, f);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_any(const void* data, const int* row_offsets, const int* perm, float* out,
                       int n_rows, int f, cudaStream_t s) {
  return f % kVec == 0 ? launch<T, false>(data, row_offsets, perm, out, n_rows, f, s)
                       : launch<T, true>(data, row_offsets, perm, out, n_rows, f, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  perm may be null (identity).  chunk: C
// of the fixed order the caller sums in; anything but kChunk is refused.
// Returns cudaGetLastError() after the launch (0 on success).
int mgn_csr_segment_sum(const void* data, int dtype, const int* row_offsets,
                        const int* perm, float* out, int n_rows, int f, int chunk,
                        void* stream) {
  if (n_rows <= 0 || f <= 0 || chunk != kChunk) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaErrorInvalidValue;
  if (dtype == 0) {
    rc = launch_any<float>(data, row_offsets, perm, out, n_rows, f, s);
  } else if (dtype == 1) {
    rc = launch_any<__nv_bfloat16>(data, row_offsets, perm, out, n_rows, f, s);
  }
  return static_cast<int>(rc);
}

const char* mgn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
