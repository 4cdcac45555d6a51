// Causal GQA prefill attention (flash attention, forward) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention/kernel.py): for every query row i,
// sitting at absolute position Skv - Sq + i, the softmax over the keys at
// positions <= its own (and, with a window w > 0, > position - w) of
// q.k * scale, applied to v.  It reads the model layout directly:
// q and o (B, Sq, Hq, D), k and v (B, Skv, Hkv, D); query head h reads
// KV head h / G (G = Hq / Hkv) without copying K/V.  Inputs are fp32 or
// bf16; scores, the running max m, the running sum l and the output
// accumulator are fp32.  In bf16 the probabilities p are rounded to bf16
// before the P.V product, where the reference rounds them
// (kernel.py:73); l sums the unrounded p.  Masked scores take
// _NEG = -0.7 * FLT_MAX, not -inf, and a row with nothing valid keeps
// l clamped to 1e-30, as kernel.py:28 and :80 do.  fp32 runs on the CUDA
// cores in IEEE fp32 (no TF32).
//
// What bounds it on the H100: operations.  Causal attention does
// 2 * B * Hq * Sq * Skv * D multiply-adds counted as flops (half of the
// full square, QK^T and PV each); at the serving shape (B = 8,
// S = 1024, Hq = 32, D = 64) that is 34 GFLOP, 35 us at the bf16
// tensor-core peak, while reading q, k, v and writing o is 75 MB, 22 us.
// This first kernel is the simple design, on the CUDA cores:
//   * one block of 256 threads per (64-row query tile, query head, batch
//     row); tiles are issued last-first, so the longest causal rows
//     start first;
//   * the block walks the KV tiles of 64 keys that its rows can see:
//     tiles wholly above the diagonal or left of the window are skipped
//     (kernel.py:46-50), the ragged last tile is masked in the kernel
//     rather than padded in memory (kernel.py:105-113);
//   * q, each K tile and each V tile are staged in shared memory as fp32;
//     each thread owns a 4 x 4 block of the 64 x 64 score tile (rows
//     ty + 16i, columns tx + 16j: conflict-free shared reads) and the
//     matching 4 x D/16 block of the output accumulator, in registers;
//   * the row max and row sum of the online softmax are reduced over the
//     16 threads of a row with warp shuffles.
// A tensor-core version (mma.sync or wgmma on bf16) is work for a later
// change; its times stand beside this one's in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per staged tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kPS = kBK + 16;  // row stride of the probability tile
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

// p as the P.V product sees it: rounded to the input type (kernel.py:73).
template <typename T>
__device__ __forceinline__ float round_p(float p) {
  return to_f32(from_f32<T>(p));
}

template <int D>
constexpr size_t smem_floats() {
  return (size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) + (size_t)kBK * D + (size_t)kBQ * kPS;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int Sq, int Skv, int Hq, int Hkv, int window, float scale) {
  constexpr int QS = D + 1;  // padded row stride of the q and K tiles
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;             // kBQ x QS
  float* ks = qs + kBQ * QS;    // kBK x QS
  float* vs = ks + kBK * QS;    // kBK x D
  float* ps = vs + kBK * D;     // kBQ x kPS

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest (last) tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kBQ;
  const int offset = Skv - Sq;  // query i sits at position offset + i
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    const int s = q0 + r;
    qs[r * QS + c] = s < Sq ? to_f32(q[((size_t)(b * Sq + s) * Hq + h) * D + c]) : 0.0f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  // KV tiles this query tile can see.
  const int q_first = offset + q0;                      // first row's position
  const int q_last = offset + min(q0 + kBQ, Sq) - 1;   // last real row's position
  const int k_stop = min(Skv, q_last + 1);              // causal: keys <= q_last
  int k_start = 0;
  if (window > 0) {
    const int lo = q_first - window + 1;  // the first row's oldest visible key
    k_start = lo > 0 ? (lo / kBK) * kBK : 0;
  }

  for (int k0 = k_start; k0 < k_stop; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D;
      const int c = i - r * D;
      const int s = k0 + r;
      const size_t g = ((size_t)(b * Skv + s) * Hkv + hk) * D + c;
      const bool in = s < Skv;
      ks[r * QS + c] = in ? to_f32(k[g]) : 0.0f;
      vs[r * D + c] = in ? to_f32(v[g]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q_first + r;
      bool ok[4];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < Skv && kpos <= qpos && (window <= 0 || kpos > qpos - window);
        s[i][j] = ok[j] ? s[i][j] * scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      // The 16 threads of a row are lanes tx of one half-warp.
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
        psum += p;
        ps[r * kPS + tx + 16 * j] = round_p<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // the probability tile is complete

    float pv[4][DJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) pv[i][j] = 0.0f;
#pragma unroll 8
    for (int c = 0; c < kBK; ++c) {
      float pr[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = ps[(ty + 16 * i) * kPS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) pv[i][j] += pr[i] * vv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] += pv[i][j];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= Sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    T* out = o + ((size_t)(b * Sq + s) * Hq + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) out[tx + 16 * j] = from_f32<T>(acc[i][j] / lc);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                   int Skv, int Hq, int Hkv, int window, float scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, D>;
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Skv, Hq, Hkv, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                     int Skv, int Hq, int Hkv, int D, int window, float scale,
                     cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, window, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Skv, Hq, Hkv, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16.  Returns the launch's cudaError_t.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int dtype, int B,
                        int Sq, int Skv, int Hq, int Hkv, int D, int window, float scale,
                        void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, window, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, window, scale, s);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
