// The RG-LRU gate arithmetic shared by the scan (rglru_scan.cu) and its
// backward (rglru_scan_bwd.cu), sm_90a.  Both kernels compute a, b·x and h
// through these functions, so the backward's recomputed h equals the
// forward's bit for bit: every multiply-add is an explicit fmaf, never
// left to the compiler's contraction.
#pragma once

#include <cuda_bf16.h>
#include <math.h>

namespace rglru {

constexpr int kChunk = 64;  // steps of a chunk (both kernels)
constexpr int kCh = 128;    // channels of a block, one a thread
// Steps between the carries the forward saves for the backward: the h
// entering every kCarry steps, so a backward warp walks kCarry steps from
// its own carry.
constexpr int kCarry = 16;
static_assert(kChunk % kCarry == 0, "a chunk is a whole number of carry spans");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// A sigmoid's argument is held above -kSigmoidFloor, where the sigmoid is
// below 7e-13: its denominator 1 + exp(-x) stays below 1.5e12, so the
// product of two stays finite and a fast reciprocal takes it.
constexpr float kSigmoidFloor = 28.0f;

// sigmoid(x) and sigmoid(y) from two exponentials and one reciprocal, by
// the special-function unit's approximations (each within a few ulp).
__device__ __forceinline__ void sigmoid2(float x, float y, float& sx, float& sy) {
  const float dx = 1.0f + __expf(-fmaxf(x, -kSigmoidFloor));
  const float dy = 1.0f + __expf(-fmaxf(y, -kSigmoidFloor));
  const float inv = __fdividef(1.0f, dx * dy);
  sx = dy * inv;
  sy = dx * inv;
}

// log(1 + exp(x)), and x itself above 20, as torch's softplus (once a
// channel: the accurate functions).
__device__ __forceinline__ float softplus(float x) { return x > 20.0f ? x : log1pf(expf(x)); }

constexpr float kGeluK2 = 1.5957691216057308f;  // 2 sqrt(2 / pi)
constexpr float kGeluC = 0.044715f;

// sigmoid(2 z) of the GeLU's tanh form, z = sqrt(2 / pi) (x + 0.044715 x^3):
// 0.5 (1 + tanh(z)) = sigmoid(2 z).
__device__ __forceinline__ float gelu_sig(float x) {
  const float z2 = kGeluK2 * fmaf(kGeluC * x * x, x, x);
  return __fdividef(1.0f, 1.0f + __expf(-fmaxf(z2, -kSigmoidFloor)));
}

// GeLU, tanh approximation: x * sigmoid(2 z).
__device__ __forceinline__ float gelu_tanh(float x) { return x * gelu_sig(x); }

// GeLU and its derivative: with s = sigmoid(2 z), gelu = x s and
// gelu' = s + x s (1 - s) 2 sqrt(2 / pi) (1 + 3 * 0.044715 x^2).
__device__ __forceinline__ void gelu_tanh_grad(float x, float& gelu, float& dgelu) {
  const float s = gelu_sig(x);
  gelu = x * s;
  dgelu = fmaf(x * s * (1.0f - s) * kGeluK2, fmaf(3.0f * kGeluC * x, x, 1.0f), s);
}

// A channel's gate weights: a = exp(neg_c_sp * sigmoid(u * aw + ab)).
struct Gates {
  float aw, ab, xw, xb, neg_c_sp;
};

template <typename T>
__device__ __forceinline__ Gates load_gates(const T* a_w, const T* a_b, const T* x_w,
                                            const T* x_b, const T* lam, int c) {
  Gates q;
  q.aw = to_f(a_w[c]);
  q.ab = to_f(a_b[c]);
  q.xw = to_f(x_w[c]);
  q.xb = to_f(x_b[c]);
  q.neg_c_sp = -8.0f * softplus(to_f(lam[c]));
  return q;
}

// What one element's gates leave: r and i (the two sigmoids), a, the
// clamped v = clip(1 - a^2, 1e-12, 1), 1 / sqrt(v), and whether 1 - a^2
// lay inside the clamp's bounds (where its gradient passes).
struct GateParts {
  float r, i, a, v, rs;
  bool inside;
};

// v = clip(1 - a^2, 1e-12, 1) and whether 1 - a^2 lay inside the bounds:
// no special-function operation, so the backward takes it again from a.
__device__ __forceinline__ float clamp_v(float a, bool& inside) {
  const float pre = fmaf(-a, a, 1.0f);
  inside = pre >= 1e-12f && pre <= 1.0f;
  return fminf(fmaxf(pre, 1e-12f), 1.0f);
}

// Five special-function operations (three exponentials, a reciprocal, a
// reciprocal square root), the same in both kernels.
__device__ __forceinline__ GateParts gate_parts(const Gates& q, float uf) {
  GateParts g;
  sigmoid2(fmaf(uf, q.aw, q.ab), fmaf(uf, q.xw, q.xb), g.r, g.i);
  g.a = __expf(q.neg_c_sp * g.r);
  g.v = clamp_v(g.a, g.inside);
  g.rs = rsqrtf(g.v);
  return g;
}

// b·x = sqrt(v) i u of one element.
__device__ __forceinline__ float gate_bx(const GateParts& g, float uf) {
  return g.v * g.rs * g.i * uf;
}

// One step of the recurrence, h = a h + b·x.
__device__ __forceinline__ float step(float a, float h, float bx) { return fmaf(a, h, bx); }

}  // namespace rglru
