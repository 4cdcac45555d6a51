// Eq. 2 utility kernel with the Eq. 13 column sums, for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `utility_scores_pallas`
// (src/repro/kernels/utility/kernel.py): over an (R, M) tile of
// (request, model) pairs,
//
//     U[r, m] = A[r, m] * (1 - clip(gamma(d[r], E[r, m]), 0, 1))
//
// with a static deadline penalty gamma (none / step / linear / sigmoid),
// plus, when asked, the column sums of U over the R rows.
//
// Numerics.  The scheduling path runs the double instance, which must equal
// the reference's numpy arithmetic bit for bit, or near-tied group
// utilities pick other models:
//   * this file is compiled with --fmad=false, so no multiply-add is fused;
//   * the sigmoid's ratio^-3 uses only `*` and `/` (correctly rounded);
//   * a column is summed by one thread, row after row from 0, exactly the
//     order of `sequential_mean` (src/repro/core/fastpath.py:658).
// The float instance computes what the Pallas kernel computes.
//
// What bounds it on the H100: neither bytes nor flops.  A group tile is a
// few hundred KB at most (R <= a few thousand, M <= 8), which the card
// moves in well under a microsecond; the call costs its launch latency
// (several microseconds) plus the ordered column sum, a chain of R
// dependent adds.  So the design is one block per call: its threads fill
// the tile chunk by chunk with a strided loop, keeping each chunk in shared
// memory, and M of them walk the chunk's columns, so the chain waits on
// shared memory rather than on device memory.  The Pallas kernel's padding
// of M to 128 lanes has no use here; M is at most the block's 256 threads.
// Completions may be a full (R, M) tile or one (M,) row shared by every
// request (grouped selection), through their row stride; evaluate's
// per-entry scoring is the M = 1 column tile, one deadline per row.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunkElems = 4096;  // 32 KB of doubles per chunk

enum Penalty { kNone = 0, kStep = 1, kLinear = 2, kSigmoid = 3 };

template <typename T>
__device__ __forceinline__ T penalty_gamma(int penalty, T d, T e) {
  if (penalty == kNone) return T(0);
  if (penalty == kStep) return d < e ? T(1) : T(0);
  if (e <= d) return T(0);
  if (d <= T(0)) return T(1);
  const T x = (e - d) / d;
  if (penalty == kLinear) return x < T(1) ? x : T(1);
  // sigmoid
  if (x >= T(1)) return T(1);
  if (x <= T(0)) return T(0);
  const T ratio = x / (T(1) - x);
  const T inner = T(1) / (T(1) + T(1) / (ratio * ratio * ratio));
  return inner < T(1) ? inner : T(1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
utility_kernel(const T* __restrict__ acc, const T* __restrict__ deadlines,
               const T* __restrict__ comp, int comp_row_stride,
               T* __restrict__ u, T* __restrict__ sums, int R, int M, int penalty) {
  // Rows go through in chunks that fit shared memory: the block fills a
  // chunk (to device memory and to the chunk buffer), synchronises, and
  // M threads add the chunk's rows to their running column sums in row
  // order, reading the buffer instead of device memory.
  __shared__ T chunk[kChunkElems];
  const int rows_per_chunk = kChunkElems / M;
  T s = T(0);  // running sum of column threadIdx.x (when < M)
  for (int r0 = 0; r0 < R; r0 += rows_per_chunk) {
    const int rows = min(rows_per_chunk, R - r0);
    const int n = rows * M;
    const int base = r0 * M;
#pragma unroll 4
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int r = r0 + i / M;
      const int m = (base + i) - r * M;
      T g = penalty_gamma<T>(penalty, deadlines[r], comp[r * comp_row_stride + m]);
      g = g < T(0) ? T(0) : (g > T(1) ? T(1) : g);
      const T v = acc[base + i] * (T(1) - g);
      u[base + i] = v;
      chunk[i] = v;
    }
    if (sums == nullptr) continue;
    __syncthreads();  // the chunk is complete
    if (threadIdx.x < M) {
      // Loads run eight rows ahead of the adds; the adds stay in row order.
      int r = 0;
      for (; r + 8 <= rows; r += 8) {
        T v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = chunk[(r + j) * M + threadIdx.x];
#pragma unroll
        for (int j = 0; j < 8; ++j) s = s + v[j];
      }
      for (; r < rows; ++r) s = s + chunk[r * M + threadIdx.x];
    }
    __syncthreads();  // the chunk is consumed before it is overwritten
  }
  if (sums != nullptr && threadIdx.x < M) sums[threadIdx.x] = s;
}

template <typename T>
int launch(const void* acc, const void* d, const void* e, int e_stride, void* u,
           void* sums, int R, int M, int penalty, void* stream) {
  if (R <= 0 || M <= 0 || M > kThreads || penalty < kNone || penalty > kSigmoid ||
      (e_stride != 0 && e_stride != M)) {
    return (int)cudaErrorInvalidValue;
  }
  utility_kernel<T><<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(acc), static_cast<const T*>(d), static_cast<const T*>(e),
      e_stride, static_cast<T*>(u), static_cast<T*>(sums), R, M, penalty);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// acc, u (R, M); deadlines (R,); completions (R, M) with e_stride = M, or
// (M,) with e_stride = 0; sums (M,) or null.  Contiguous, current device.
int utility_scores_f64(const void* acc, const void* d, const void* e, int e_stride,
                       void* u, void* sums, int R, int M, int penalty, void* stream) {
  return launch<double>(acc, d, e, e_stride, u, sums, R, M, penalty, stream);
}

int utility_scores_f32(const void* acc, const void* d, const void* e, int e_stride,
                       void* u, void* sums, int R, int M, int penalty, void* stream) {
  return launch<float>(acc, d, e, e_stride, u, sums, R, M, penalty, stream);
}

const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
