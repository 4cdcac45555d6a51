// Flash decode: one query token per row against a KV cache, for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `decode_attention_pallas`
// (src/repro/kernels/decode_attention/kernel.py): for batch row b and each
// of its Hq query heads, the softmax of q.k * scale over the cache
// positions p with p < lengths[b] (and, with a window w > 0,
// p >= lengths[b] - w), applied to v.  It reads the model layout
// directly: q and o (B, 1, Hq, D), the caches (B, S, Hkv, D); the G =
// Hq / Hkv query heads of a KV head share every K/V tile loaded.  Inputs
// are fp32 or bf16, the arithmetic fp32 on the CUDA cores (no TF32).
// In bf16 the unnormalised probabilities p are rounded to bf16 before the
// P.V product, as kernel.py does; masked positions never enter (the
// reference gives them _NEG = -0.7 * FLT_MAX and p = 0), and a row with
// no valid position returns 0 (l clamped to 1e-30).
//
// What bounds it on the H100: bytes.  Each valid K and V row is read once
// and used for G dot products of length D, about one flop per byte, far
// below the card's ~300 flops per byte in bf16: at the serving shape
// (B = 8, Hkv = 4, G = 8, D = 64, cache 1040) the K and V bytes take
// 2.5 us at 3.35 TB/s.  B * Hkv = 32 rows cannot fill 132 SMs, so the
// cache axis is split across blocks (flash decoding):
//   * one block of 128 threads per (cache slice, KV head, batch row);
//     the wrapper picks the slice count so the grid covers the SMs about
//     twice; a slice with no valid position exits after writing an
//     empty partial;
//   * the block stages 64-position tiles of K and V in shared memory,
//     scores all G x 64 pairs, runs the online-softmax update per query
//     head (one warp per head) and folds P.V into an fp32 accumulator in
//     shared memory;
//   * each slice writes its partial (m, l, acc); a second kernel of this
//     source combines the slices, as the k-NN merge does, weighting each
//     by exp(m_slice - m_max).  With one slice the first kernel writes
//     the output itself.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;      // cache positions staged per step
constexpr float kNeg = -0.7f * 3.4028234663852886e38f;  // _NEG of kernel.py:28

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__device__ __forceinline__ float round_p(float p) {
  return to_f32(from_f32<T>(p));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

size_t smem_bytes(int G, int D) {
  // q (G, D), K tile (kTile, D + 1), V tile (kTile, D), scores (G, kTile),
  // acc (G, D), m, l, alpha (G each).
  return sizeof(float) * ((size_t)G * D + (size_t)kTile * (D + 1) + (size_t)kTile * D +
                          (size_t)G * kTile + (size_t)G * D + 3 * (size_t)G);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                      const T* __restrict__ vc, const int32_t* __restrict__ lengths,
                      T* __restrict__ o, float* __restrict__ part_m,
                      float* __restrict__ part_l, float* __restrict__ part_acc,
                      int S, int Hkv, int G, int window, float scale, int chunk) {
  constexpr int KS = D + 1;
  extern __shared__ float smem[];
  float* qs = smem;                   // G x D
  float* ks = qs + G * D;             // kTile x KS
  float* vs = ks + kTile * KS;        // kTile x D
  float* ss = vs + kTile * D;         // G x kTile
  float* acc = ss + G * kTile;        // G x D
  float* ms = acc + G * D;            // G
  float* ls = ms + G;                 // G
  float* alphas = ls + G;             // G

  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int Hq = Hkv * G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int len = min(max(lengths[b], 0), S);
  const int lo = window > 0 ? max(len - window, 0) : 0;
  const int begin = max(split * chunk, lo);
  const int end = min(min(split * chunk + chunk, S), len);

  for (int i = tid; i < G * D; i += kThreads) {
    qs[i] = to_f32(q[((size_t)b * Hq + hk * G) * D + i]);  // heads hk*G .. hk*G+G-1
    acc[i] = 0.0f;
  }
  for (int g = tid; g < G; g += kThreads) {
    ms[g] = kNeg;
    ls[g] = 0.0f;
  }

  for (int t0 = begin; t0 < end; t0 += kTile) {
    const int rows = min(kTile, end - t0);
    __syncthreads();  // the previous tile is consumed (and qs, acc are set)
    for (int i = tid; i < rows * D; i += kThreads) {
      const int r = i / D;
      const int c = i - r * D;
      const size_t gidx = ((size_t)(b * S + t0 + r) * Hkv + hk) * D + c;
      ks[r * KS + c] = to_f32(kc[gidx]);
      vs[r * D + c] = to_f32(vc[gidx]);
    }
    __syncthreads();
    for (int e = tid; e < G * kTile; e += kThreads) {
      const int g = e / kTile;
      const int j = e - g * kTile;
      float sc = kNeg;
      if (j < rows) {
        const float* qr = qs + g * D;
        const float* kr = ks + j * KS;
        float dot = 0.0f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
        sc = dot * scale;
      }
      ss[e] = sc;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kWarps) {
      const bool v0 = lane < rows;
      const bool v1 = lane + 32 < rows;
      const float s0 = ss[g * kTile + lane];
      const float s1 = ss[g * kTile + lane + 32];
      const float m_prev = ms[g];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = v0 ? expf(s0 - m_new) : 0.0f;
      const float p1 = v1 ? expf(s1 - m_new) : 0.0f;
      const float psum = warp_sum(p0 + p1);
      ss[g * kTile + lane] = round_p<T>(p0);
      ss[g * kTile + lane + 32] = round_p<T>(p1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alphas[g] = alpha;
        ls[g] = ls[g] * alpha + psum;
        ms[g] = m_new;
      }
    }
    __syncthreads();
    for (int e = tid; e < G * D; e += kThreads) {
      const int g = e / D;
      const int d = e - g * D;
      const float* pr = ss + g * kTile;
      float pv = 0.0f;
      for (int j = 0; j < rows; ++j) pv += pr[j] * vs[j * D + d];
      acc[e] = acc[e] * alphas[g] + pv;
    }
  }
  __syncthreads();

  const size_t row0 = (size_t)b * Hq + hk * G;  // (b, first head of the group)
  if (splits == 1) {
    for (int e = tid; e < G * D; e += kThreads) {
      const int g = e / D;
      o[row0 * D + e] = from_f32<T>(acc[e] / fmaxf(ls[g], 1e-30f));
    }
    return;
  }
  for (int e = tid; e < G * D; e += kThreads) {
    const int g = e / D;
    const int d = e - g * D;
    part_acc[((row0 + g) * splits + split) * D + d] = acc[e];
  }
  for (int g = tid; g < G; g += kThreads) {
    part_m[(row0 + g) * splits + split] = ms[g];
    part_l[(row0 + g) * splits + split] = ls[g];
  }
}

// One block per (batch row, query head), one thread per output column.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc,
                                      T* __restrict__ o, int splits, int D) {
  const size_t row = blockIdx.x;
  const int d = threadIdx.x;
  const float* pm = part_m + row * splits;
  const float* pl = part_l + row * splits;
  float m = kNeg;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, pm[s]);
  float l = 0.0f;
  float a = 0.0f;
  for (int s = 0; s < splits; ++s) {
    const float w = expf(pm[s] - m);
    l += pl[s] * w;
    a += part_acc[(row * splits + s) * D + d] * w;
  }
  o[row * D + d] = from_f32<T>(a / fmaxf(l, 1e-30f));
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int32_t* lengths,
                   void* o, float* part_m, float* part_l, float* part_acc, int B, int S,
                   int Hkv, int G, int window, float scale, int splits, cudaStream_t stream) {
  auto kernel = decode_partial_kernel<T, D>;
  const size_t smem = smem_bytes(G, D);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int chunk = ((S + splits - 1) / splits + kTile - 1) / kTile * kTile;
  if ((S + chunk - 1) / chunk != splits) return cudaErrorInvalidValue;
  const dim3 grid(splits, Hkv, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      static_cast<T*>(o), part_m, part_l, part_acc, S, Hkv, G, window, scale, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  decode_combine_kernel<T><<<B * Hkv * G, D, 0, stream>>>(part_m, part_l, part_acc,
                                                          static_cast<T*>(o), splits, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const int32_t* lengths,
                     void* o, float* pm, float* pl, float* pa, int B, int S, int Hkv, int G,
                     int D, int window, float scale, int splits, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, lengths, o, pm, pl, pa, B, S, Hkv, G, window, scale, splits, s);
    case 32: return launch<T, 32>(q, k, v, lengths, o, pm, pl, pa, B, S, Hkv, G, window, scale, splits, s);
    case 64: return launch<T, 64>(q, k, v, lengths, o, pm, pl, pa, B, S, Hkv, G, window, scale, splits, s);
    case 128: return launch<T, 128>(q, k, v, lengths, o, pm, pl, pa, B, S, Hkv, G, window, scale, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Number of cache slices for B * Hkv rows of cache length S on a card
// with `sms` SMs: about two blocks per SM, at least one 64-position tile
// per slice.  The wrapper sizes the partial buffers with it.
int decode_split_count(int B, int Hkv, int S, int sms) {
  if (B <= 0 || Hkv <= 0 || S <= 0 || sms <= 0) return 1;
  const int tiles = (S + kTile - 1) / kTile;
  int splits = (2 * sms + B * Hkv - 1) / (B * Hkv);
  splits = splits < 1 ? 1 : (splits > tiles ? tiles : splits);
  const int chunk = ((S + splits - 1) / splits + kTile - 1) / kTile * kTile;
  return (S + chunk - 1) / chunk;  // no empty slice after rounding to tiles
}

// dtype: 0 = fp32, 1 = bf16.  q, o (B, 1, Hkv * G, D); k, v (B, S, Hkv, D);
// lengths (B,) int32; part_m, part_l (B * Hkv * G, splits) and part_acc
// (B * Hkv * G, splits, D) fp32 scratch, unused when splits == 1.
int decode_attention_fwd(const void* q, const void* k, const void* v, const void* lengths,
                         void* o, void* part_m, void* part_l, void* part_acc, int dtype, int B,
                         int S, int Hkv, int G, int D, int window, float scale, int splits,
                         void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || G <= 0 || splits < 1 ||
      (splits > 1 && (part_m == nullptr || part_l == nullptr || part_acc == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const int32_t* len = static_cast<const int32_t*>(lengths);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, len, o, pm, pl, pa, B, S, Hkv, G, D, window, scale,
                                splits, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, len, o, pm, pl, pa, B, S, Hkv, G, D, window,
                                        scale, splits, s);
  return (int)cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
