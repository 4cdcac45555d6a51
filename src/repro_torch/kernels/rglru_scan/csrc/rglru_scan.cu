// The RG-LRU scan of the Griffin recurrent block, for Hopper, sm_90a.
//
// Replaces the reference's recurrence of src/repro/models/rglru.py
// (`_gates` :65 and the `jax.lax.associative_scan` of `rglru_forward` :77;
// `rglru_decode_step` :100 is the same step at S = 1; no Pallas kernel):
//
//   per (batch b, channel c), over t = 0 .. S-1, in float32:
//     r = sigmoid(u * a_w + a_b)        i = sigmoid(u * x_w + x_b)
//     a = exp(-8 * softplus(Lambda) * r)
//     h = a * h + sqrt(clip(1 - a^2, 1e-12, 1)) * i * u
//     y = h * gelu_tanh(g)               (rounded to the model's type)
//   h starts at h0 (or 0) and the last h is written out in float32.
//
// The reference's associative scan adds the same products in a log-depth
// order; this kernel walks the sequence in order, so the two agree within
// float32 rounding (1e-4 held on the CPU, against the plain version on the
// card).
//
// What bounds it: bytes.  Each step reads u and g once and writes y once
// (2 bytes each in bf16) for about thirty float32 operations, a handful of
// them transcendental: at B = 8, S = 1024, L = 4096 that is 201 MB, 0.06
// ms at 3.35 TB/s, against about 0.02 ms of operations.  The design: one
// thread per (batch, channel), the recurrence carried in a register, so
// the scan is one pass over memory with no second kernel and no block-wide
// synchronisation; neighbouring threads take neighbouring channels, so
// every load and store of a warp is one contiguous 64- or 128-byte row.
// Loads do not depend on h, so the unrolled loop keeps several in flight
// while the multiply-add chain runs.  The gate vectors are read once per
// thread.  The grid depends on B and L only and nothing is read back, so
// the decode step's launch (S = 1) can be captured in a CUDA graph.  The
// launch uses the caller's stream, synchronises nothing and allocates
// nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// log(1 + exp(x)), and x itself above 20, as torch's softplus.
__device__ __forceinline__ float softplus(float x) { return x > 20.0f ? x : log1pf(expf(x)); }

// GeLU, tanh approximation.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(k * (x + 0.044715f * x * x * x)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel(const T* __restrict__ u, const T* __restrict__ g,
                      const T* __restrict__ a_w, const T* __restrict__ a_b,
                      const T* __restrict__ x_w, const T* __restrict__ x_b,
                      const T* __restrict__ lam, const float* __restrict__ h0,
                      T* __restrict__ y, float* __restrict__ h_last, int B, int S, int L) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * L) return;
  const int b = idx / L;
  const int c = idx - b * L;
  const float aw = to_f(a_w[c]), ab = to_f(a_b[c]);
  const float xw = to_f(x_w[c]), xb = to_f(x_b[c]);
  const float neg_c_sp = -8.0f * softplus(to_f(lam[c]));
  float h = h0 != nullptr ? h0[idx] : 0.0f;
  const size_t base = (size_t)b * S * L + c;
#pragma unroll 4
  for (int t = 0; t < S; ++t) {
    const size_t off = base + (size_t)t * L;
    const float uf = to_f(u[off]);
    const float gf = to_f(g[off]);
    const float r = sigmoid(uf * aw + ab);
    const float i = sigmoid(uf * xw + xb);
    const float a = expf(neg_c_sp * r);
    const float beta = sqrtf(fminf(fmaxf(1.0f - a * a, 1e-12f), 1.0f));
    h = a * h + beta * i * uf;
    y[off] = from_f<T>(h * gelu_tanh(gf));
  }
  h_last[idx] = h;
}

template <typename T>
int launch(const void* u, const void* g, const void* a_w, const void* a_b, const void* x_w,
           const void* x_b, const void* lam, const void* h0, void* y, void* h_last, int B,
           int S, int L, cudaStream_t stream) {
  const int blocks = (B * L + kThreads - 1) / kThreads;
  rglru_scan_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(g), static_cast<const T*>(a_w),
      static_cast<const T*>(a_b), static_cast<const T*>(x_w), static_cast<const T*>(x_b),
      static_cast<const T*>(lam), static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(h_last), B, S, L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// u, g, y: (B, S, L); a_w, a_b, x_w, x_b, lam: (L,), all of `dtype` (0
// float32, 1 bfloat16); h0 (B, L) float32 or null; h_last (B, L) float32.
// Returns a cudaError_t (0 on success).
int rglru_scan(const void* u, const void* g, const void* a_w, const void* a_b, const void* x_w,
               const void* x_b, const void* lam, const void* h0, void* y, void* h_last, int B,
               int S, int L, int dtype, void* stream) {
  if (B < 1 || S < 1 || L < 1 || (long long)B * L > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(u, g, a_w, a_b, x_w, x_b, lam, h0, y, h_last, B, S, L, st);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(u, g, a_w, a_b, x_w, x_b, lam, h0, y, h_last, B, S, L, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
