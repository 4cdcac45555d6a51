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
// cores; no TF32.  Each dot product is one chain of fmaf in feature order
// from 0.0f, then |x|^2 - 2 dot.
//
// What bounds it on the H100: the distance work, 2*Q*N*D flops in fp32
// (67 TFLOP/s outside the tensor cores), against reading x once
// (N*D*4 bytes at 3.35 TB/s).  At the main path's shapes (Q ~ 1365,
// N = 80000, D <= 32) the flops dominate, so the design spends its
// instructions on FFMA:
//   * a block holds a query tile of QT = 16 * QPT queries (128, or 64 for
//     few queries or a wide D) in shared memory and walks its slice of the
//     training set in tiles of 64 rows.  Thread (tq, tr) of the 16 x 16
//     grid scores queries tq + 16 i (i < QPT) against rows tr + 16 j
//     (j < 4): per four features, 4 + QPT float4 shared loads feed
//     16 * QPT FFMA.  A warp is 4 query lanes x 8 row lanes and rows are an
//     odd number of float4s apart, so the row reads are free of bank
//     conflicts and the query reads are broadcasts;
//   * the training tiles are staged by cp.async (16-byte copies when D is a
//     multiple of 4 and x is aligned, else 4-byte ones) into a ring of 2-3
//     stages, so the loads of the next tiles overlap the math on this one;
//     no per-element division: a thread's (row, column) advance by adds.
//     Features are padded to whole float4s with zeros, which change no sum;
//   * top-k by threshold: each query keeps its sorted k best (d, index) in
//     shared memory, and its k-th best is the admission threshold, seeded
//     on the first tile by the k-th smallest of the threads' minima.  A
//     distance enters the query's candidate buffer only if it is below the
//     threshold in (d, index) order; after each tile one thread per query
//     inserts the query's candidates (if any) into its list, all queries at
//     once.  The threshold falls, and after the first tiles almost nothing
//     passes;
//   * N is cut into slices so that the grid covers the SMs; with more than
//     one slice a second kernel merges the slices' lists, one warp per
//     query, in the same (d, index) order.
// The launch plan (query tile, stages, slices, slice rows, shared bytes) is
// computed by the Python wrapper (`knn_plan` in ops.py) and validated here:
// a plan that does not fit is refused, never adjusted.  Tensor cores are not
// used: TF32 would reorder neighbours, and an fp32-exact split product is
// work for a later change.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 16;                   // query lanes and row lanes of the grid
constexpr int kRowsPerThread = 4;
constexpr int kTileRows = kLanes * kRowsPerThread;  // training rows per staged tile
constexpr int kMaxK = 16;
constexpr int kMaxSmem = 232448;             // 227 KB a block may use

__device__ __forceinline__ bool pair_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most `pending` of this thread's groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 1) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
}

// Floats between consecutive rows in shared memory: D rounded up to whole
// float4s, plus one float4 if that count is even, so 8 consecutive rows
// fall on 8 different bank quads.
__host__ __device__ __forceinline__ int row_stride(int D) {
  const int dp = (D + 3) & ~3;
  return ((dp / 4) & 1) ? dp : dp + 4;
}

__host__ __device__ __forceinline__ size_t smem_bytes(int qt, int D, int stages, int k) {
  const size_t s = row_stride(D);
  return 4 * ((size_t)qt * s + (size_t)stages * kTileRows * (s + 1) +
              (size_t)qt * (2 * kTileRows + 2 * k + 3));
}

template <int QPT>
__global__ void __launch_bounds__(kThreads, 2)
knn_search_kernel(const float* __restrict__ q, const float* __restrict__ x,
                  const float* __restrict__ xn, const int32_t* __restrict__ y,
                  float* __restrict__ out_d, int32_t* __restrict__ out_l,
                  float* __restrict__ part_d, int32_t* __restrict__ part_i,
                  int Q, int N, int D, int k, int stages, int slice_rows, int vec) {
  constexpr int QT = kLanes * QPT;
  const int stride = row_stride(D);
  const int s4 = stride / 4;
  const int dp4 = (D + 3) / 4;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);               // QT x stride
  float* xs = qs + QT * stride;                               // stages x 64 x stride
  float* xns = xs + stages * kTileRows * stride;              // stages x 64
  float* cd = xns + stages * kTileRows;                       // 64 x QT candidates
  int* ci = reinterpret_cast<int*>(cd + QT * kTileRows);
  float* ld = reinterpret_cast<float*>(ci + QT * kTileRows);  // k x QT sorted lists
  int* li = reinterpret_cast<int*>(ld + QT * k);
  float* thd = reinterpret_cast<float*>(li + QT * k);         // QT thresholds
  int* thj = reinterpret_cast<int*>(thd + QT);
  int* cnt = thj + QT;                                        // QT candidate counts

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tr = (warp & 1) * 8 + (lane & 7);   // row lane
  const int tq = (warp >> 1) * 4 + (lane >> 3);  // query lane
  const int q0 = blockIdx.x * QT;
  const int lo = blockIdx.y * slice_rows;
  const int hi = min(N, lo + slice_rows);
  const int ntiles = (hi - lo + kTileRows - 1) / kTileRows;

  // Queries, zero padded; empty lists; thresholds (-inf: no such query).
  for (int i = tid; i < QT * stride; i += kThreads) {
    const int qq = i / stride;
    const int c = i - qq * stride;
    qs[i] = (q0 + qq < Q && c < D) ? q[(size_t)(q0 + qq) * D + c] : 0.0f;
  }
  for (int i = tid; i < QT * k; i += kThreads) {
    ld[i] = CUDART_INF_F;
    li[i] = INT32_MAX;
  }
  for (int i = tid; i < QT; i += kThreads) {
    thd[i] = q0 + i < Q ? CUDART_INF_F : -CUDART_INF_F;
    thj[i] = INT32_MAX;
    cnt[i] = 0;
  }
  // With 4-byte copies, the padding features of every staged row stay zero.
  if (!vec) {
    const int pad = dp4 * 4 - D;
    for (int i = tid; i < stages * kTileRows * pad; i += kThreads) {
      const int r = i / pad;
      xs[r * stride + D + (i - r * pad)] = 0.0f;
    }
  }

  // This thread's first (row, chunk) of a tile's copy, and its step.
  const int chunks = vec ? D / 4 : D;
  const int step_r = kThreads / chunks;
  const int step_c = kThreads - step_r * chunks;
  const int r_first = tid / chunks;
  const int c_first = tid - r_first * chunks;

  auto stage = [&](int t) {
    const int base = lo + t * kTileRows;
    const int rows = min(kTileRows, hi - base);
    float* dst = xs + (t % stages) * kTileRows * stride;
    int r = r_first, c = c_first;
    if (vec) {
      while (r < rows) {
        cp_async16(dst + r * stride + 4 * c, x + (size_t)(base + r) * D + 4 * c);
        r += step_r;
        c += step_c;
        if (c >= chunks) { c -= chunks; ++r; }
      }
    } else {
      while (r < rows) {
        cp_async4(dst + r * stride + c, x + (size_t)(base + r) * D + c);
        r += step_r;
        c += step_c;
        if (c >= chunks) { c -= chunks; ++r; }
      }
    }
    if (tid < rows) cp_async4(xns + (t % stages) * kTileRows + tid, xn + base + tid);
  };

  for (int t = 0; t < stages - 1; ++t) {
    if (t < ntiles) stage(t);
    cp_async_commit();
  }

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait(stages - 2);  // this thread's copies of tile t have landed
    __syncthreads();            // everyone's have; the last merge is done
    if (t + stages - 1 < ntiles) stage(t + stages - 1);
    cp_async_commit();

    const float4* x4 = reinterpret_cast<const float4*>(xs + (t % stages) * kTileRows * stride);
    const float4* q4 = reinterpret_cast<const float4*>(qs);
    float acc[QPT][kRowsPerThread];
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) acc[i][j] = 0.0f;
    }
#pragma unroll 2
    for (int c = 0; c < dp4; ++c) {
      float4 xv[kRowsPerThread];
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) xv[j] = x4[(tr + kLanes * j) * s4 + c];
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        const float4 qv = q4[(tq + kLanes * i) * s4 + c];
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) {
          acc[i][j] = fmaf(qv.x, xv[j].x, acc[i][j]);
          acc[i][j] = fmaf(qv.y, xv[j].y, acc[i][j]);
          acc[i][j] = fmaf(qv.z, xv[j].z, acc[i][j]);
          acc[i][j] = fmaf(qv.w, xv[j].w, acc[i][j]);
        }
      }
    }

    const int base = lo + t * kTileRows;
    const float* xnt = xns + (t % stages) * kTileRows;
    float dist[QPT][kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const float nj = xnt[tr + kLanes * j];
#pragma unroll
      for (int i = 0; i < QPT; ++i) dist[i][j] = nj - 2.0f * acc[i][j];
    }
    if (t == 0) {
      // Seed the thresholds: the k-th smallest of the 16 threads' minima
      // over their rows of the first tile.  At least k distances are at or
      // below it, so the top k still pass, and about k others instead of
      // the whole tile.
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        float m = CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) {
          if (base + tr + kLanes * j < hi) m = fminf(m, dist[i][j]);
        }
        cd[tr * QT + tq + kLanes * i] = m;
      }
      __syncthreads();
      if (tid < QT && thd[tid] == CUDART_INF_F) {
        for (int a = 0; a < kLanes; ++a) {
          const float v = cd[a * QT + tid];
          int below = 0;
          for (int b = 0; b < kLanes; ++b) {
            const float w = cd[b * QT + tid];
            below += w < v || (w == v && b < a);
          }
          if (below == k - 1) thd[tid] = v;  // thj stays INT32_MAX: d <= v passes
        }
      }
      __syncthreads();
    }

    // Admission: below the query's k-th best in (d, index) order.
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const int qq = tq + kLanes * i;
      const float thr = thd[qq];
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const int idx = base + tr + kLanes * j;
        const float d = dist[i][j];
        if (d <= thr && idx < hi && (d < thr || idx < thj[qq])) {
          const int slot = atomicAdd(&cnt[qq], 1);
          cd[slot * QT + qq] = d;
          ci[slot * QT + qq] = idx;
        }
      }
    }
    __syncthreads();  // every candidate of tile t is in its buffer

    // Merge: one thread per query inserts its candidates, if any, into its
    // sorted list; a candidate the list has since outgrown is dropped at
    // the first compare.  Buffers and lists are laid out query-fastest, so
    // the threads of a warp read 32 different banks.
    if (tid < QT) {
      const int c = cnt[tid];
      for (int o = 0; o < c; ++o) {
        const float d = cd[o * QT + tid];
        const int idx = ci[o * QT + tid];
        int p = k - 1;
        if (!pair_less(d, idx, ld[p * QT + tid], li[p * QT + tid])) continue;
        for (; p > 0 && pair_less(d, idx, ld[(p - 1) * QT + tid], li[(p - 1) * QT + tid]);
             --p) {
          ld[p * QT + tid] = ld[(p - 1) * QT + tid];
          li[p * QT + tid] = li[(p - 1) * QT + tid];
        }
        ld[p * QT + tid] = d;
        li[p * QT + tid] = idx;
      }
      if (c > 0) {
        thd[tid] = ld[(k - 1) * QT + tid];
        thj[tid] = li[(k - 1) * QT + tid];
        cnt[tid] = 0;
      }
    }
  }
  __syncthreads();

  const int slices = gridDim.y;
  for (int i = tid; i < QT * k; i += kThreads) {
    const int r = i / QT;
    const int qq = i - r * QT;
    if (q0 + qq >= Q) continue;
    const float d = ld[i];
    const int idx = li[i];
    if (slices == 1) {
      out_d[(size_t)(q0 + qq) * k + r] = d;
      out_l[(size_t)(q0 + qq) * k + r] = idx < N ? y[idx] : -1;
    } else {
      const size_t at = ((size_t)(q0 + qq) * slices + blockIdx.y) * k + r;
      part_d[at] = d;
      part_i[at] = idx;
    }
  }
}

// Merge the slices' lists: one warp per query.  Each lane keeps the K
// smallest (d, index) pairs of its share of the entries in registers, then
// K rounds of a warp argmin over the lanes' heads give the query's K.
template <int K>
__global__ void knn_merge_kernel(const float* __restrict__ part_d,
                                 const int32_t* __restrict__ part_i,
                                 const int32_t* __restrict__ y, float* __restrict__ out_d,
                                 int32_t* __restrict__ out_l, int Q, int N, int slices) {
  const int q = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (q >= Q) return;  // the whole warp
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = CUDART_INF_F;
    bi[s] = INT32_MAX;
  }
  const size_t row = (size_t)q * slices * K;
  for (int c = lane; c < slices * K; c += 32) {
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
  for (int r = 0; r < K; ++r) {
    float d = bd[0];
    int i = bi[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, d, off);
      const int oi = __shfl_xor_sync(0xffffffffu, i, off);
      if (pair_less(od, oi, d, i)) { d = od; i = oi; }
    }
    if (lane == 0) {
      out_d[(size_t)q * K + r] = d;
      out_l[(size_t)q * K + r] = i < N ? y[i] : -1;
    }
    if (bi[0] == i && bd[0] == d) {  // the lane that held it (padding: all alike)
#pragma unroll
      for (int s = 0; s < K - 1; ++s) {
        bd[s] = bd[s + 1];
        bi[s] = bi[s + 1];
      }
      bd[K - 1] = CUDART_INF_F;
      bi[K - 1] = INT32_MAX;
    }
  }
}

template <int K>
cudaError_t launch_merge(const float* part_d, const int32_t* part_i, const int32_t* y,
                         float* out_d, int32_t* out_l, int Q, int N, int slices,
                         cudaStream_t stream) {
  knn_merge_kernel<K><<<(Q + 7) / 8, 256, 0, stream>>>(part_d, part_i, y, out_d, out_l, Q, N,
                                                      slices);
  return cudaGetLastError();
}

template <int QPT>
cudaError_t launch_search(const float* q, const float* x, const float* xn, const int32_t* y,
                          float* out_d, int32_t* out_l, float* part_d, int32_t* part_i, int Q,
                          int N, int D, int k, int stages, int slices, int slice_rows,
                          size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(knn_search_kernel<QPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int vec = (D % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  dim3 grid((Q + kLanes * QPT - 1) / (kLanes * QPT), slices);
  knn_search_kernel<QPT><<<grid, kThreads, smem, stream>>>(
      q, x, xn, y, out_d, out_l, part_d, part_i, Q, N, D, k, stages, slice_rows, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (Q, D), x (N, D), xn (N,) fp32; y (N,) int32; out_d, out_l (Q, k);
// part_d, part_i (Q, slices, k) scratch, unused when slices == 1.
// All contiguous on the current device.  1 <= k <= 16, k <= N.
// The plan: query_tile 64 or 128, stages 2 or 3, slice_rows a multiple of
// 64 with exactly `slices` non-empty slices, smem the bytes it needs.
int knn_topk_f32(const void* q, const void* x, const void* xn, const void* y, void* out_d,
                 void* out_l, void* part_d, void* part_i, int Q, int N, int D, int k,
                 int query_tile, int stages, int slices, int slice_rows, long long smem,
                 void* stream) {
  if (Q <= 0 || N <= 0 || D <= 0 || D > kThreads || k < 1 || k > kMaxK || k > N ||
      (query_tile != 64 && query_tile != 128) || stages < 2 || stages > 3 || slices < 1 ||
      slice_rows <= 0 || slice_rows % kTileRows != 0 ||
      (long long)(slices - 1) * slice_rows >= N || (long long)slices * slice_rows < N ||
      smem != (long long)smem_bytes(query_tile, D, stages, k) || smem > kMaxSmem ||
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
  cudaError_t e = query_tile == 128
      ? launch_search<8>(qf, xf, nf, yi, od, ol, pd, pi, Q, N, D, k, stages, slices,
                         slice_rows, (size_t)smem, s)
      : launch_search<4>(qf, xf, nf, yi, od, ol, pd, pi, Q, N, D, k, stages, slices,
                         slice_rows, (size_t)smem, s);
  if (e != cudaSuccess || slices == 1) return (int)e;
  switch (k) {
#define REPRO_KNN_CASE(KK) \
    case KK: return (int)launch_merge<KK>(pd, pi, yi, od, ol, Q, N, slices, s);
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
