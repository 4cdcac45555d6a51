// Flash decode: one query token per row against a KV cache, for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `decode_attention_pallas`
// (src/repro/kernels/decode_attention/kernel.py): for batch row b and each
// of its Hq query heads, the softmax of q.k * scale over the cache
// positions p with p < lengths[b] (and, with a window w > 0,
// p >= lengths[b] - w), applied to v.  It reads the model layout
// directly: q and o (B, 1, Hq, D), the caches (B, S, Hkv, D); the G =
// Hq / Hkv query heads of a KV head share every K/V row loaded.  Inputs
// are fp32 or bf16, the arithmetic fp32 on the CUDA cores (no TF32).
// In bf16 the unnormalised probabilities p are rounded to bf16 before the
// P.V product, as kernel.py does; masked positions never enter (the
// reference gives them _NEG = -0.7 * FLT_MAX and p = 0), and a row with
// no valid position returns 0 (l clamped to 1e-30).
//
// What bounds it on the H100: bytes, in principle.  Each valid K and V
// row is read once and used for G dot products of length D, about one
// flop per byte: at the serving shape (B = 8, Hkv = 4, G = 8, D = 64,
// ~5,600 valid positions) the K and V bytes take 1.7 us at 3.35 TB/s.  At
// that size what it pays in practice is latency: one launch, a few
// dependent rounds of loads, and the merge of the partial softmaxes.  The
// design spends on that:
//   * ONE launch.  Per (batch row, KV head) a thread-block cluster of
//     `splits` blocks (at most 8, the portable cluster size; the wrapper
//     picks as many as leave each block an SM of its own) splits the
//     row's valid range [lo, len) in equal slices; len is read from
//     `lengths` on the device, so the grid depends on the shapes alone and
//     the same launch is right at every step of a replayed CUDA graph.  A
//     block whose slice is empty loads nothing and keeps an empty partial
//     (m = _NEG, l = 0).
//   * Parallel scores.  A row of K or V is D * sizeof(T) bytes; LPR lanes
//     read it with one 16-byte load each (bf16, D = 64: 8 lanes, so a warp
//     covers 4 rows per load), and each lane group keeps kRows rows' loads
//     in flight.  A row of more than 32 pieces (f32, D = 256: 64) takes PL
//     pieces per lane, pieces l, l + LPR, ..., so a row still fits a warp
//     and each load of the warp reads 512 contiguous bytes.  The group's
//     lanes hold their slice of kHeads query heads in registers, reduce
//     each dot product with shuffles across the lanes of the row, run the
//     online softmax per head in registers and fold P.V into per-lane fp32
//     accumulators.  More heads per KV head than a pass holds (G <= 32)
//     take several passes over the slice.
//   * Heads and rows fitted to G in bf16 at D = 256 (the `fitted`
//     instances; every other one holds 8 heads and 2 rows).  There a row
//     is one warp's 16-byte loads, so a block of 4 warps kept 8 K rows in
//     flight; at gemma-7b's decode (G = 1) 7 of the 8 head slots idled and
//     the split rule gave 132 // 128 = 1 block to each (batch row, KV
//     head): 16 KB in flight an SM, latency-bound at 0.171 ms, 6.2 times
//     its bound.  Now a pass holds 1, 2, 4 or 8 heads (G = 1, 2, 3-4, 5+),
//     the registers of the slots that would idle hold 8, 8, 4 or 2 rows in
//     flight a lane group (127-128 registers below 8 heads: 4 blocks an
//     SM), and ops.split_count gives each (batch row, KV head) enough
//     blocks for 4 on every SM (at most 8, a cluster; at most one per pass
//     of the block's lane groups), fixed by the shapes.  Measured
//     (benchmarks/torch_kernel_probe.py k4 --old, NVIDIA H100 80GB HBM3,
//     700.00 W; PERF.md): 0.038 ms at gemma-7b's decode (5 blocks a
//     pair), 1.37 times its bound, against 0.171 for the first design and
//     0.067 for SDPA; 0.016 at G = 2 and 0.019 at G = 4 (0.038 and 0.039
//     before); G = 16 unchanged, 0.044.  At gemma-7b's shape 2 to 8
//     blocks a pair give 0.036-0.038 ms, one 0.048; one valid position a
//     row costs 0.009 (launch, merge and cluster barriers).
//   * One merge.  Every lane group leaves its partial (m, l, acc) in shared
//     memory and the block merges them once, per (head, column), with the
//     groups' weights exp(m_group - m_block) computed once per head; the
//     blocks of the cluster then merge through distributed shared memory
//     after a cluster barrier: every block combines its share of the
//     (head, column) outputs from all the cluster's partials and writes
//     them.  No workspace in device memory persists between calls, so
//     nothing a graph holds can go stale.
//   * Little code.  At these sizes a block runs most of its code once, and
//     on the H100 a larger unrolled body cost more time than the loads it
//     kept in flight, even at one valid position per row: so 2 rows in
//     flight per group, the block's merge as loops over shared memory
//     rather than unrolled shuffles, and the fast exponential (__expf,
//     within 2e-5 of the plain version in f32).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kMaxSplits = 8;  // blocks per cluster (portable limit)
constexpr float kNeg = -0.7f * 3.4028234663852886e38f;  // _NEG of kernel.py:28

// The instances: query heads per pass (held in registers), rows per lane
// group in flight and blocks an SM are 8, 2 and 2, but for bf16 at D =
// 256 (`fitted`), where a row is one warp's 16-byte loads, the heads per
// pass follow G (1, 2, 4, or 8 from G = 5) and the registers of the head
// slots that would sit idle hold rows in flight: 8 for one or two heads,
// 4 for four, with 4 blocks an SM.
template <typename T, int D>
__host__ __device__ constexpr bool fitted() { return sizeof(T) == 2 && D == 256; }

__host__ __device__ constexpr int fitted_heads(int G) {
  return G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : 8;
}

__host__ __device__ constexpr int fitted_rows(int H) { return H <= 2 ? 8 : H == 4 ? 4 : 2; }

__host__ __device__ constexpr int resident(int H) { return H <= 4 ? 4 : 2; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// p as the reference rounds it before P.V: to the cache type and back.
__device__ __forceinline__ float round_p(float p, float) { return p; }
__device__ __forceinline__ float round_p(float p, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(p));
}

// 16 bytes of T as fp32 values.
__device__ __forceinline__ void unpack(const uint4& raw, float (&out)[4], float) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, float (&out)[8], __nv_bfloat16) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // the lower address sits in the lower half
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(static_cast<const uint4*>(p));
}

template <typename T, int D, int kHeads, int kRows>
__global__ void __launch_bounds__(kThreads, resident(kHeads))
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, const int32_t* __restrict__ lengths,
                        T* __restrict__ o, int S, int Hkv, int G, int window, float scale) {
  constexpr int E = 16 / sizeof(T);              // elements of a 16-byte piece
  constexpr int PIECES = D / E;                   // pieces of a row
  constexpr int PL = PIECES > 32 ? PIECES / 32 : 1;  // pieces per lane
  constexpr int LPR = PIECES / PL;                // lanes per row
  constexpr int EL = E * PL;                      // elements of a row per lane
  constexpr int NG = kThreads / LPR;              // lane groups per block
  static_assert(LPR >= 1 && LPR <= 32 && 32 % LPR == 0 && LPR * PL == PIECES,
                "a row must fit a warp");

  __shared__ float g_m[NG][kHeads], g_l[NG][kHeads], g_c[NG][kHeads];
  __shared__ __align__(16) float g_acc[NG][kHeads][D];
  __shared__ float b_m[kHeads], b_l[kHeads];
  __shared__ float b_acc[kHeads][D];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x;  // == the block's rank in its cluster
  const int splits = gridDim.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int grp = tid / LPR;
  const int e0 = (tid % LPR) * E;  // piece p of the lane starts at e0 + p * LPR * E
  const int Hq = Hkv * G;

  const int len = min(max(lengths[b], 0), S);
  const int lo = window > 0 ? max(len - window, 0) : 0;
  const int n = len - lo;
  const int chunk = (n + splits - 1) / splits;
  const int rb = lo + min(split * chunk, n);
  const int re = lo + min(split * chunk + chunk, n);
  const size_t row_stride = (size_t)Hkv * D;
  const T* kbase = kc + ((size_t)b * S * Hkv + hk) * D + e0;
  const T* vbase = vc + ((size_t)b * S * Hkv + hk) * D + e0;
  const size_t q_row0 = (size_t)b * Hq + (size_t)hk * G;  // first head of the group

  for (int g0 = 0; g0 < G; g0 += kHeads) {
    const int gn = min(kHeads, G - g0);
    float qf[kHeads][EL];
    float m[kHeads], l[kHeads], acc[kHeads][EL];
#pragma unroll
    for (int h = 0; h < kHeads; ++h) {
#pragma unroll
      for (int p = 0; p < PL; ++p) {
        float part[E];
        if (h < gn) {
          unpack(load16(q + (q_row0 + g0 + h) * D + e0 + p * LPR * E), part, T());
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) part[e] = 0.0f;
        }
#pragma unroll
        for (int e = 0; e < E; ++e) qf[h][p * E + e] = part[e];
      }
      m[h] = kNeg;
      l[h] = 0.0f;
#pragma unroll
      for (int e = 0; e < EL; ++e) acc[h][e] = 0.0f;
    }

    for (int base = rb; base < re; base += NG * kRows) {
      uint4 kr[kRows][PL], vr[kRows][PL];
      bool ok[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = base + grp + i * NG;
        ok[i] = r < re;
#pragma unroll
        for (int p = 0; p < PL; ++p) {
          if (ok[i]) {
            kr[i][p] = load16(kbase + (size_t)r * row_stride + p * LPR * E);
            vr[i][p] = load16(vbase + (size_t)r * row_stride + p * LPR * E);
          } else {
            kr[i][p] = make_uint4(0u, 0u, 0u, 0u);
            vr[i][p] = kr[i][p];
          }
        }
      }
      float s[kRows][kHeads];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float kf[EL];
#pragma unroll
        for (int p = 0; p < PL; ++p) {
          float part[E];
          unpack(kr[i][p], part, T());
#pragma unroll
          for (int e = 0; e < E; ++e) kf[p * E + e] = part[e];
        }
#pragma unroll
        for (int h = 0; h < kHeads; ++h) {
          float dot = 0.0f;
#pragma unroll
          for (int e = 0; e < EL; ++e) dot = fmaf(qf[h][e], kf[e], dot);
#pragma unroll
          for (int off = LPR / 2; off > 0; off >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          s[i][h] = ok[i] ? dot * scale : kNeg;
        }
      }
#pragma unroll
      for (int h = 0; h < kHeads; ++h) {
        float mx = s[0][h];
#pragma unroll
        for (int i = 1; i < kRows; ++i) mx = fmaxf(mx, s[i][h]);
        const float m_new = fmaxf(m[h], mx);
        const float alpha = __expf(m[h] - m_new);
        l[h] *= alpha;
#pragma unroll
        for (int e = 0; e < EL; ++e) acc[h][e] *= alpha;
        m[h] = m_new;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float vf[EL];
#pragma unroll
        for (int p = 0; p < PL; ++p) {
          float part[E];
          unpack(vr[i][p], part, T());
#pragma unroll
          for (int e = 0; e < E; ++e) vf[p * E + e] = part[e];
        }
#pragma unroll
        for (int h = 0; h < kHeads; ++h) {
          const float p = ok[i] ? __expf(s[i][h] - m[h]) : 0.0f;
          l[h] += p;
          const float pr = round_p(p, T());
#pragma unroll
          for (int e = 0; e < EL; ++e) acc[h][e] = fmaf(pr, vf[e], acc[h][e]);
        }
      }
    }

    // Every lane group's partial into shared memory; then per head the
    // groups' weights exp(m_group - m_block), and per (head, column) one sum.
    if (tid % LPR == 0) {
#pragma unroll
      for (int h = 0; h < kHeads; ++h) {
        g_m[grp][h] = m[h];
        g_l[grp][h] = l[h];
      }
    }
#pragma unroll
    for (int h = 0; h < kHeads; ++h) {
#pragma unroll
      for (int p = 0; p < PL; ++p)
#pragma unroll
        for (int e = 0; e < E; e += 4)
          *reinterpret_cast<float4*>(&g_acc[grp][h][e0 + p * LPR * E + e]) =
              make_float4(acc[h][p * E + e], acc[h][p * E + e + 1], acc[h][p * E + e + 2],
                          acc[h][p * E + e + 3]);
    }
    __syncthreads();
    for (int idx = tid; idx < NG * kHeads; idx += kThreads) {
      const int gi = idx / kHeads;
      const int h = idx - gi * kHeads;
      float mm = kNeg;
      for (int j = 0; j < NG; ++j) mm = fmaxf(mm, g_m[j][h]);
      g_c[gi][h] = __expf(g_m[gi][h] - mm);
      if (gi == 0) b_m[h] = mm;
    }
    __syncthreads();
    for (int idx = tid; idx < kHeads * D; idx += kThreads) {
      const int h = idx / D;
      const int d = idx - h * D;
      float a = 0.0f;
      for (int j = 0; j < NG; ++j) a = fmaf(g_acc[j][h][d], g_c[j][h], a);
      b_acc[h][d] = a;
      if (d == 0) {
        float ls = 0.0f;
        for (int j = 0; j < NG; ++j) ls = fmaf(g_l[j][h], g_c[j][h], ls);
        b_l[h] = ls;
      }
    }
    cluster.sync();  // every block's partial is written and visible

    // The blocks of the cluster: each combines its share of the outputs.
    for (int idx = split * kThreads + tid; idx < gn * D; idx += splits * kThreads) {
      const int h = idx / D;
      const int d = idx - h * D;
      float mm = kNeg;
      for (int r = 0; r < splits; ++r) mm = fmaxf(mm, cluster.map_shared_rank(b_m, r)[h]);
      float a = 0.0f;
      float ls = 0.0f;
      for (int r = 0; r < splits; ++r) {
        const float c = __expf(cluster.map_shared_rank(b_m, r)[h] - mm);
        a += cluster.map_shared_rank(&b_acc[0][0], r)[h * D + d] * c;
        ls += cluster.map_shared_rank(b_l, r)[h] * c;
      }
      o[(q_row0 + g0 + h) * D + d] = from_f32<T>(a / fmaxf(ls, 1e-30f));
    }
    cluster.sync();  // no block leaves, or reuses its partial, while it is read
  }
}

template <typename T, int D, int H, int R>
cudaError_t launch(const void* q, const void* k, const void* v, const int32_t* lengths,
                   void* o, int B, int S, int Hkv, int G, int window, float scale, int splits,
                   cudaStream_t stream) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(splits, Hkv, B);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&config, decode_attention_kernel<T, D, H, R>,
                                       static_cast<const T*>(q), static_cast<const T*>(k),
                                       static_cast<const T*>(v), lengths, static_cast<T*>(o),
                                       S, Hkv, G, window, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The instance of (T, D) for G: 8 heads a pass and 2 rows in flight, or
// the fitted heads and rows.
template <typename T, int D>
cudaError_t launch_for(const void* q, const void* k, const void* v, const int32_t* lengths,
                       void* o, int B, int S, int Hkv, int G, int window, float scale,
                       int splits, cudaStream_t s) {
  if constexpr (fitted<T, D>()) {
    switch (fitted_heads(G)) {
      case 1: return launch<T, D, 1, fitted_rows(1)>(q, k, v, lengths, o, B, S, Hkv, G, window,
                                                     scale, splits, s);
      case 2: return launch<T, D, 2, fitted_rows(2)>(q, k, v, lengths, o, B, S, Hkv, G, window,
                                                     scale, splits, s);
      case 4: return launch<T, D, 4, fitted_rows(4)>(q, k, v, lengths, o, B, S, Hkv, G, window,
                                                     scale, splits, s);
      default: break;
    }
  }
  return launch<T, D, 8, 2>(q, k, v, lengths, o, B, S, Hkv, G, window, scale, splits, s);
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const int32_t* lengths,
                     void* o, int B, int S, int Hkv, int G, int D, int window, float scale,
                     int splits, cudaStream_t s) {
  switch (D) {
    case 16: return launch_for<T, 16>(q, k, v, lengths, o, B, S, Hkv, G, window, scale, splits, s);
    case 32: return launch_for<T, 32>(q, k, v, lengths, o, B, S, Hkv, G, window, scale, splits, s);
    case 64: return launch_for<T, 64>(q, k, v, lengths, o, B, S, Hkv, G, window, scale, splits, s);
    case 128:
      return launch_for<T, 128>(q, k, v, lengths, o, B, S, Hkv, G, window, scale, splits, s);
    case 256:
      return launch_for<T, 256>(q, k, v, lengths, o, B, S, Hkv, G, window, scale, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Largest cluster (blocks per (batch row, KV head)) the kernel takes.
int decode_max_splits() { return kMaxSplits; }

// The instance a call of (dtype, D, G) launches: its query heads per pass
// (bits 0-7), rows in flight per lane group (8-15) and blocks an SM
// (16-23).  ops.py's `instance` states the same rule for the split count.
int decode_instance(int dtype, int D, int G) {
  const bool fit = dtype == 1 && D == 256;
  const int h = fit ? fitted_heads(G) : 8;
  const int r = fit ? fitted_rows(h) : 2;
  return h | (r << 8) | (resident(h) << 16);
}

// dtype: 0 = fp32, 1 = bf16.  q, o (B, 1, Hkv * G, D); k, v (B, S, Hkv, D);
// lengths (B,) int32; all 16-byte aligned.  `splits` blocks, 1 to
// decode_max_splits(), share each (batch row, KV head) as one cluster.
int decode_attention_fwd(const void* q, const void* k, const void* v, const void* lengths,
                         void* o, int dtype, int B, int S, int Hkv, int G, int D, int window,
                         float scale, int splits, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || G <= 0 || splits < 1 || splits > kMaxSplits) {
    return (int)cudaErrorInvalidValue;
  }
  const int32_t* len = static_cast<const int32_t*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, len, o, B, S, Hkv, G, D, window, scale, splits, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, len, o, B, S, Hkv, G, D, window, scale,
                                        splits, s);
  return (int)cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
