// k-NN evidence kernel (SneakPeek, paper §IV-B) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `knn_pallas`
// (src/repro/kernels/knn/kernel.py): for each query, the k training points
// with the smallest  d = |x|^2 - 2 q.x  (|q|^2 is dropped: it does not change
// the ranking), returned as (Q, k) distances and labels in ascending order.
//
// Tie rule: candidates are ordered by (d, training index), so on equal
// distance the lower index wins, as in `knn_pallas` within one train block
// (its argmin keeps the first column).  Arithmetic is IEEE fp32 on the CUDA
// cores; no TF32.
//
// What bounds it on the H100: the distance work, 2*Q*N*D flops in fp32
// (67 TFLOP/s outside the tensor cores), against reading x once
// (N*D*4 bytes at 3.35 TB/s).  At the main path's shapes (Q ~ 1365,
// N = 80000, D <= 32) the flops dominate.  Design:
//   * one block of 256 threads per QB queries and per slice of the training
//     set; the queries sit in shared memory, so every training row read
//     serves QB distances, and a 16-byte load of a query serves four
//     multiply-adds.  The training set is cut into as many slices as
//     it takes for the grid to cover the SMs a few times over;
//   * the block walks x in tiles of 256 rows staged through shared memory
//     (coalesced loads, rows padded to D+1 floats against bank conflicts);
//     each thread scores one row of the tile against the QB queries;
//   * each thread keeps a sorted top-K per query in registers (K is a
//     template parameter, so every index is static);
//   * at the end, K rounds per query of a block argmin over the threads'
//     heads merge the lists into the slice's top K;
//   * with more than one slice, a second kernel merges the slices' lists,
//     one thread per query, in the same (d, index) order.
// x, its norms and labels stay L2-resident (80000 x 28 fp32 is 9 MB) across
// the Q/QB blocks.  Tensor cores are not used: TF32 would reorder
// neighbours, and an fp32-exact split product is work for a later change.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = kThreads;  // training rows staged per step

template <int K>
struct QueriesPerBlock {
  static constexpr int value = K <= 6 ? 8 : (K <= 12 ? 4 : 2);
};

__device__ __forceinline__ bool pair_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_topk_kernel(const float* __restrict__ q, const float* __restrict__ x,
                const float* __restrict__ xn, const int32_t* __restrict__ y,
                float* __restrict__ out_d, int32_t* __restrict__ out_l,
                float* __restrict__ part_d, int32_t* __restrict__ part_i,
                int Q, int N, int D, int slice_rows) {
  constexpr int QB = QueriesPerBlock<K>::value;
  const int slices = gridDim.y;
  const int lo = blockIdx.y * slice_rows;
  const int hi = min(N, lo + slice_rows);
  extern __shared__ float4 smem4[];
  const int Dp = (D + 3) & ~3;        // query rows padded to whole float4s
  float* qs = reinterpret_cast<float*>(smem4);  // QB * Dp, zero padded
  float* xs = qs + QB * Dp;           // kTile * (D + 1)
  const int stride = D + 1;
  const int q0 = blockIdx.x * QB;
  const int tid = threadIdx.x;

  for (int i = tid; i < QB * Dp; i += kThreads) {
    const int qq = i / Dp;
    const int c = i - qq * Dp;
    qs[i] = (q0 + qq < Q && c < D) ? q[(size_t)(q0 + qq) * D + c] : 0.0f;
  }

  float bd[QB][K];
  int bi[QB][K];
#pragma unroll
  for (int qq = 0; qq < QB; ++qq) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      bd[qq][s] = CUDART_INF_F;
      bi[qq][s] = INT32_MAX;
    }
  }

  for (int base = lo; base < hi; base += kTile) {
    const int rows = min(kTile, hi - base);
    __syncthreads();  // previous tile fully consumed (and qs written)
    for (int i = tid; i < rows * D; i += kThreads) {
      int r = i / D;
      xs[r * stride + (i - r * D)] = x[(size_t)base * D + i];
    }
    __syncthreads();
    if (tid < rows) {
      const int j = base + tid;
      const float nj = xn[j];
      const float* xr = xs + tid * stride;
      float dot[QB];
#pragma unroll
      for (int qq = 0; qq < QB; ++qq) dot[qq] = 0.0f;
      // Four features per step: one 16-byte shared load of each query
      // (a broadcast) feeds four multiply-adds, in feature order.
      for (int c = 0; c < Dp; c += 4) {
        const float x0 = xr[c];
        const float x1 = c + 1 < D ? xr[c + 1] : 0.0f;
        const float x2 = c + 2 < D ? xr[c + 2] : 0.0f;
        const float x3 = c + 3 < D ? xr[c + 3] : 0.0f;
#pragma unroll
        for (int qq = 0; qq < QB; ++qq) {
          const float4 qv = *reinterpret_cast<const float4*>(qs + qq * Dp + c);
          dot[qq] += qv.x * x0;
          dot[qq] += qv.y * x1;
          dot[qq] += qv.z * x2;
          dot[qq] += qv.w * x3;
        }
      }
#pragma unroll
      for (int qq = 0; qq < QB; ++qq) {
        const float d = nj - 2.0f * dot[qq];
        // This thread sees indices in increasing order, so strict `<`
        // keeps the lower index first among equal distances.
        if (d < bd[qq][K - 1]) {
          bd[qq][K - 1] = d;
          bi[qq][K - 1] = j;
#pragma unroll
          for (int s = K - 1; s > 0; --s) {
            if (bd[qq][s] < bd[qq][s - 1]) {
              float td = bd[qq][s]; bd[qq][s] = bd[qq][s - 1]; bd[qq][s - 1] = td;
              int ti = bi[qq][s]; bi[qq][s] = bi[qq][s - 1]; bi[qq][s - 1] = ti;
            }
          }
        }
      }
    }
  }

  // Block merge: K rounds of argmin over the threads' list heads.
  __shared__ float wd[kThreads / 32];
  __shared__ int wi[kThreads / 32];
  __shared__ int winner;
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int qq = 0; qq < QB; ++qq) {
    for (int r = 0; r < K; ++r) {
      float d = bd[qq][0];
      int i = bi[qq][0];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        float od = __shfl_down_sync(0xffffffffu, d, off);
        int oi = __shfl_down_sync(0xffffffffu, i, off);
        if (pair_less(od, oi, d, i)) { d = od; i = oi; }
      }
      if (lane == 0) { wd[warp] = d; wi[warp] = i; }
      __syncthreads();
      if (tid == 0) {
        float bdv = wd[0];
        int biv = wi[0];
        for (int w = 1; w < kThreads / 32; ++w) {
          if (pair_less(wd[w], wi[w], bdv, biv)) { bdv = wd[w]; biv = wi[w]; }
        }
        winner = biv;
        if (q0 + qq < Q) {
          if (slices == 1) {
            out_d[(size_t)(q0 + qq) * K + r] = bdv;
            out_l[(size_t)(q0 + qq) * K + r] = biv < N ? y[biv] : -1;
          } else {
            const size_t at = ((size_t)(q0 + qq) * slices + blockIdx.y) * K + r;
            part_d[at] = bdv;
            part_i[at] = biv;
          }
        }
      }
      __syncthreads();
      if (bi[qq][0] == winner) {  // indices are unique: one thread pops
#pragma unroll
        for (int s = 0; s < K - 1; ++s) {
          bd[qq][s] = bd[qq][s + 1];
          bi[qq][s] = bi[qq][s + 1];
        }
        bd[qq][K - 1] = CUDART_INF_F;
        bi[qq][K - 1] = INT32_MAX;
      }
      __syncthreads();  // winner is rewritten next round
    }
  }
}

// Merge the slices' lists: one thread per query keeps the K smallest
// (d, index) pairs in registers.
template <int K>
__global__ void knn_merge_kernel(const float* __restrict__ part_d,
                                 const int32_t* __restrict__ part_i,
                                 const int32_t* __restrict__ y, float* __restrict__ out_d,
                                 int32_t* __restrict__ out_l, int Q, int N, int slices) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = CUDART_INF_F;
    bi[s] = INT32_MAX;
  }
  const size_t row = (size_t)q * slices * K;
  for (int c = 0; c < slices * K; ++c) {
    const float d = part_d[row + c];
    const int i = part_i[row + c];
    if (pair_less(d, i, bd[K - 1], bi[K - 1])) {
      bd[K - 1] = d;
      bi[K - 1] = i;
#pragma unroll
      for (int s = K - 1; s > 0; --s) {
        if (pair_less(bd[s], bi[s], bd[s - 1], bi[s - 1])) {
          float td = bd[s]; bd[s] = bd[s - 1]; bd[s - 1] = td;
          int ti = bi[s]; bi[s] = bi[s - 1]; bi[s - 1] = ti;
        }
      }
    }
  }
#pragma unroll
  for (int s = 0; s < K; ++s) {
    out_d[(size_t)q * K + s] = bd[s];
    out_l[(size_t)q * K + s] = bi[s] < N ? y[bi[s]] : -1;
  }
}

// Slices of the training set for Q queries: enough blocks to cover the
// SMs about four times, whole tiles per slice, at least one slice.
int slice_count(int Q, int N, int k, int sms) {
  const int qb = k <= 6 ? 8 : (k <= 12 ? 4 : 2);  // QueriesPerBlock<k>
  const int qblocks = (Q + qb - 1) / qb;
  const int tiles = (N + kTile - 1) / kTile;
  int s = (4 * sms + qblocks - 1) / qblocks;
  s = s < 1 ? 1 : (s > tiles ? tiles : s);
  return s;
}

template <int K>
cudaError_t launch(const float* q, const float* x, const float* xn, const int32_t* y,
                   float* out_d, int32_t* out_l, float* part_d, int32_t* part_i,
                   int Q, int N, int D, int slices, cudaStream_t stream) {
  constexpr int QB = QueriesPerBlock<K>::value;
  static_assert(QB == (K <= 6 ? 8 : (K <= 12 ? 4 : 2)), "slice_count's table");
  const size_t smem =
      sizeof(float) * ((size_t)QB * ((D + 3) & ~3) + (size_t)kTile * (D + 1));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        knn_topk_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int tiles = (N + kTile - 1) / kTile;
  const int slice_rows = ((tiles + slices - 1) / slices) * kTile;
  const int used = (N + slice_rows - 1) / slice_rows;  // no empty slice
  if (used != slices) return cudaErrorInvalidValue;
  dim3 grid((Q + QB - 1) / QB, slices);
  knn_topk_kernel<K><<<grid, kThreads, smem, stream>>>(
      q, x, xn, y, out_d, out_l, part_d, part_i, Q, N, D, slice_rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || slices == 1) return e;
  knn_merge_kernel<K><<<(Q + 127) / 128, 128, 0, stream>>>(part_d, part_i, y, out_d,
                                                          out_l, Q, N, slices);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of training-set slices the search of Q queries uses on a card
// with `sms` SMs; the wrapper sizes the scratch lists with it.
int knn_slice_count(int Q, int N, int k, int sms) {
  if (Q <= 0 || N <= 0 || k < 1 || sms < 1) return 1;
  int s = slice_count(Q, N, k, sms);
  // Keep every slice non-empty after rounding to whole tiles.
  const int tiles = (N + kTile - 1) / kTile;
  const int slice_rows = ((tiles + s - 1) / s) * kTile;
  return (N + slice_rows - 1) / slice_rows;
}

// q (Q, D), x (N, D), xn (N,) fp32; y (N,) int32; out_d, out_l (Q, k);
// part_d, part_i (Q, slices, k) scratch, unused when slices == 1.
// All contiguous on the current device.  1 <= k <= 16, k <= N.
int knn_topk_f32(const void* q, const void* x, const void* xn, const void* y,
                 void* out_d, void* out_l, void* part_d, void* part_i,
                 int Q, int N, int D, int k, int slices, void* stream) {
  if (Q <= 0 || N <= 0 || D <= 0 || k < 1 || k > 16 || k > N || slices < 1 ||
      (slices > 1 && (part_d == nullptr || part_i == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const float* qf = static_cast<const float*>(q);
  const float* xf = static_cast<const float*>(x);
  const float* nf = static_cast<const float*>(xn);
  const int32_t* yi = static_cast<const int32_t*>(y);
  float* od = static_cast<float*>(out_d);
  int32_t* ol = static_cast<int32_t*>(out_l);
  float* pd = static_cast<float*>(part_d);
  int32_t* pi = static_cast<int32_t*>(part_i);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
#define REPRO_KNN_CASE(KK) \
    case KK: return (int)launch<KK>(qf, xf, nf, yi, od, ol, pd, pi, Q, N, D, slices, s);
    REPRO_KNN_CASE(1) REPRO_KNN_CASE(2) REPRO_KNN_CASE(3) REPRO_KNN_CASE(4)
    REPRO_KNN_CASE(5) REPRO_KNN_CASE(6) REPRO_KNN_CASE(7) REPRO_KNN_CASE(8)
    REPRO_KNN_CASE(9) REPRO_KNN_CASE(10) REPRO_KNN_CASE(11) REPRO_KNN_CASE(12)
    REPRO_KNN_CASE(13) REPRO_KNN_CASE(14) REPRO_KNN_CASE(15) REPRO_KNN_CASE(16)
#undef REPRO_KNN_CASE
  }
  return (int)cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
