// The RG-LRU scan, backward, for Hopper, sm_90a.
//
// The gradient of what rglru_scan.cu computes forward.  The reference has
// no hand-written backward: jax.grad differentiates its jnp `_gates` and
// `jax.lax.associative_scan` (src/repro/models/rglru.py:65-97).  Per
// (batch b, channel c), in float32, with the forward's
//   r_t = sigmoid(u_t a_w + a_b),  i_t = sigmoid(u_t x_w + x_b),
//   a_t = exp(-8 softplus(Lambda) r_t),  v_t = clip(1 - a_t^2, 1e-12, 1),
//   h_t = a_t h_{t-1} + sqrt(v_t) i_t u_t   (h_{-1} = h0, or 0),
//   y_t = h_t gelu(gpre_t),
// and the output's gradient dy (and dh_last, the last state's, or 0):
//   e_t = dy_t gelu(gpre_t);   dgpre_t = dy_t h_t gelu'(gpre_t)
//   g_t = e_t + a_{t+1} g_{t+1}   (backwards; g_{S-1} = e_{S-1} + dh_last)
//   d(a_t) = g_t h_{t-1} - 2 a_t d(v_t),   d(v_t) = g_t i_t u_t / (2 sqrt(v_t))
//            inside the clamp's bounds, else 0
//   dh0 = a_0 g_0
// and the chain rule through the gates: d(i_t) = g_t sqrt(v_t) u_t, the two
// sigmoids' r(1 - r), a's a * (-8 softplus(Lambda)), softplus' = sigmoid
// (Lambda).  The clamp passes its gradient where 1e-12 <= 1 - a^2 <= 1,
// bounds included (torch's clamp); the reference's jnp.clip splits it at a
// bound exactly, the only place the two differ.  The vector gradients (a_w,
// a_b, x_w, x_b, Lambda) are sums over (b, t).
//
// What bounds it on the H100: bytes.  It reads u, gpre and dy and writes
// du and dgpre, 2 bytes each an element in bf16: at B = 8, S = 1024, L =
// 4096 that is 336 MB, 0.100 ms at 3.35 TB/s, against some sixty float32
// operations and ten special-function ones an element (the gates twice,
// GeLU and its derivative).
//
// The design: the forward's chunking (rglru.cuh's kChunk), run from the
// right.  The adjoint recurrence has the forward's linear form reversed: a
// chunk hands its left neighbour a_{t0} g_{t0} = A w + E, where w is what
// enters from the right, A = prod a over the chunk and E the same from w
// = 0.  Three kernels on one stream, all named `rglru_bwd_*`, one thread a
// (batch, chunk, channel) as in the forward:
//   1. summary (chunks 1 .. nc-1): A and E of the chunk, walking it
//      backwards from u, gpre and dy, into a (2, B, nc-1, L) scratch.
//   2. scan (every chunk): w, from dh_last pushed through the summaries of
//      the chunks to the right; h recomputed forwards over the chunk from
//      the carry the forward saved ((B, nc, L), written by rglru_scan.cu's
//      pass 2) into shared memory, with the forward's gate arithmetic
//      (rglru.cuh), so it equals the forward's h bit for bit, not from a
//      saved (B, S, L) h (134 MB a layer at the shape above against the
//      carries' 2 MB); then the chunk backwards: du and dgpre, and the
//      thread's partial sums of the five vector gradients' terms, into a
//      (5, B, nc, L) scratch; chunk 0 writes dh0.
//   3. reduce: each vector gradient summed over (b, chunk) in a fixed
//      order, times -8 sigmoid(Lambda) for Lambda's, in the parameters'
//      type.
// No atomics: every sum is one thread's, in a fixed order, so two calls
// give the same gradients bit for bit.  u, gpre and dy are read twice (the
// summary and the scan; u a third time from L2 in the scan's forward
// walk): 8 x 2 bytes an element in bf16 against the bound's 5 x 2.
//
// Measured by chip_smoke.py phase 16 (a) (NVIDIA H100 80GB HBM3, 700.00
// W; PERF.md): 0.443 ms at the shape above (summary 0.082, scan 0.350,
// reduce 0.011), 4.4 times the bound.  The scan kernel holds most of it:
// each step evaluates the gates again (five special-function operations),
// GeLU and its derivative, reads three inputs without staging, and a
// thread walks its chunk twice (forwards for h, backwards for g).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rglru.cuh"

namespace {

using namespace rglru;

constexpr int kVecs = 5;  // a_w, a_b, x_w, x_b, Lambda

template <typename T>
struct BwdArgs {
  const T *u, *g, *dy, *a_w, *a_b, *x_w, *x_b, *lam;
  const float* carries;  // (B, nc, L): the h entering each chunk
  const float* dh_last;  // (B, L) or null
  T *du, *dg;            // (B, S, L)
  T* dvec[kVecs];        // (L,) each
  float* dh0;            // (B, L) or null
  float* sum_a;          // (B, nc - 1, L): chunk k's prod a at k - 1
  float* sum_e;          // (B, nc - 1, L): chunk k's a_{t0} g_{t0} from w = 0
  float* part;           // (kVecs, B, nc, L): one thread's sums of each vector's terms
  int B, S, L, nc;
};

template <typename T>
__global__ void __launch_bounds__(kCh) rglru_bwd_summary_kernel(BwdArgs<T> p) {
  const int b = blockIdx.z;
  const int k = blockIdx.y + 1;
  const int c = blockIdx.x * kCh + threadIdx.x;
  if (c >= p.L) return;
  const Gates q = load_gates(p.a_w, p.a_b, p.x_w, p.x_b, p.lam, c);
  const int n = min(kChunk, p.S - k * kChunk);
  const size_t row0 = (size_t)b * p.S + (size_t)k * kChunk;
  float w = 0.0f, prod = 1.0f;
#pragma unroll 4
  for (int r = n - 1; r >= 0; --r) {
    const size_t off = (row0 + r) * p.L + c;
    const float a = gate_parts(q, to_f(p.u[off])).a;
    const float gt = fmaf(to_f(p.dy[off]), gelu_tanh(to_f(p.g[off])), w);
    w = a * gt;
    prod = prod * a;
  }
  const size_t at = ((size_t)b * (p.nc - 1) + (k - 1)) * p.L + c;
  p.sum_a[at] = prod;
  p.sum_e[at] = w;
}

template <typename T>
__global__ void __launch_bounds__(kCh) rglru_bwd_scan_kernel(BwdArgs<T> p) {
  __shared__ float hs[kChunk][kCh];  // the chunk's h, one column a thread
  const int b = blockIdx.z;
  const int k = blockIdx.y;
  const int c = blockIdx.x * kCh + threadIdx.x;
  if (c >= p.L) return;
  const int tid = threadIdx.x;
  const Gates q = load_gates(p.a_w, p.a_b, p.x_w, p.x_b, p.lam, c);
  const int n = min(kChunk, p.S - k * kChunk);
  const size_t row0 = (size_t)b * p.S + (size_t)k * kChunk;

  // What enters from the right: dh_last through the summaries of chunks
  // nc-1 .. k+1.
  float w = p.dh_last != nullptr ? p.dh_last[(size_t)b * p.L + c] : 0.0f;
  const size_t base = (size_t)b * (p.nc - 1) * p.L + c;
#pragma unroll 4
  for (int j = p.nc - 1; j > k; --j) {
    w = fmaf(p.sum_a[base + (size_t)(j - 1) * p.L], w, p.sum_e[base + (size_t)(j - 1) * p.L]);
  }

  // h over the chunk, from the forward's carry, as the forward computed it.
  const float h_in = p.carries[((size_t)b * p.nc + k) * p.L + c];
  float h = h_in;
#pragma unroll 4
  for (int r = 0; r < n; ++r) {
    const float uf = to_f(p.u[(row0 + r) * p.L + c]);
    const GateParts gp = gate_parts(q, uf);
    h = step(gp.a, h, gate_bx(gp, uf));
    hs[r][tid] = h;
  }

  float acc_aw = 0.0f, acc_ab = 0.0f, acc_xw = 0.0f, acc_xb = 0.0f, acc_lam = 0.0f;
#pragma unroll 2
  for (int r = n - 1; r >= 0; --r) {
    const size_t off = (row0 + r) * p.L + c;
    const float uf = to_f(p.u[off]);
    const float dyf = to_f(p.dy[off]);
    float gelu, dgelu;
    gelu_tanh_grad(to_f(p.g[off]), gelu, dgelu);
    const GateParts gp = gate_parts(q, uf);
    const float h_prev = r > 0 ? hs[r - 1][tid] : h_in;
    const float gt = fmaf(dyf, gelu, w);  // e_t + a_{t+1} g_{t+1}
    p.dg[off] = from_f<T>(dyf * hs[r][tid] * dgelu);
    const float sq = gp.v * gp.rs;  // sqrt(v)
    const float d_i = gt * sq * uf;
    const float d_v = gp.inside ? 0.5f * gt * gp.i * uf * gp.rs : 0.0f;
    const float d_a = fmaf(-2.0f * gp.a, d_v, gt * h_prev);
    const float d_loga = d_a * gp.a;  // d(log a) = d(-8 softplus(Lambda) r)
    const float d_pre_r = d_loga * q.neg_c_sp * gp.r * (1.0f - gp.r);
    const float d_pre_i = d_i * gp.i * (1.0f - gp.i);
    p.du[off] = from_f<T>(fmaf(d_pre_r, q.aw, fmaf(d_pre_i, q.xw, gt * sq * gp.i)));
    acc_aw = fmaf(d_pre_r, uf, acc_aw);
    acc_ab += d_pre_r;
    acc_xw = fmaf(d_pre_i, uf, acc_xw);
    acc_xb += d_pre_i;
    acc_lam = fmaf(d_loga, gp.r, acc_lam);
    w = gp.a * gt;
  }
  if (k == 0 && p.dh0 != nullptr) p.dh0[(size_t)b * p.L + c] = w;
  const size_t plane = (size_t)p.B * p.nc * p.L;
  const size_t at = ((size_t)b * p.nc + k) * p.L + c;
  p.part[at] = acc_aw;
  p.part[plane + at] = acc_ab;
  p.part[2 * plane + at] = acc_xw;
  p.part[3 * plane + at] = acc_xb;
  p.part[4 * plane + at] = acc_lam;
}

// Vector blockIdx.y's gradient, channel by channel: its partials summed over
// b, then chunk, in that order.
template <typename T>
__global__ void __launch_bounds__(kCh) rglru_bwd_reduce_kernel(BwdArgs<T> p) {
  const int v = blockIdx.y;
  const int c = blockIdx.x * kCh + threadIdx.x;
  if (c >= p.L) return;
  const int rows = p.B * p.nc;
  const float* src = p.part + (size_t)v * rows * p.L + c;
  float s = 0.0f;
#pragma unroll 8
  for (int j = 0; j < rows; ++j) s += src[(size_t)j * p.L];
  if (v == kVecs - 1) {  // Lambda: d(-8 softplus(Lambda) r) / dLambda = -8 sigmoid(Lambda) r
    s *= -8.0f / (1.0f + expf(-to_f(p.lam[c])));
  }
  p.dvec[v][c] = from_f<T>(s);
}

template <typename T>
int launch(BwdArgs<T>& p, cudaStream_t stream) {
  dim3 grid((p.L + kCh - 1) / kCh, p.nc - 1, p.B);
  if (p.nc > 1) {
    rglru_bwd_summary_kernel<T><<<grid, kCh, 0, stream>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  grid.y = p.nc;
  rglru_bwd_scan_kernel<T><<<grid, kCh, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rglru_bwd_reduce_kernel<T><<<dim3((p.L + kCh - 1) / kCh, kVecs), kCh, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* const* in, const void* carries, const void* dh_last, void* const* out,
           void* dh0, void* scratch, int B, int S, int L, cudaStream_t stream) {
  BwdArgs<T> p;
  p.u = static_cast<const T*>(in[0]);
  p.g = static_cast<const T*>(in[1]);
  p.dy = static_cast<const T*>(in[2]);
  p.a_w = static_cast<const T*>(in[3]);
  p.a_b = static_cast<const T*>(in[4]);
  p.x_w = static_cast<const T*>(in[5]);
  p.x_b = static_cast<const T*>(in[6]);
  p.lam = static_cast<const T*>(in[7]);
  p.carries = static_cast<const float*>(carries);
  p.dh_last = static_cast<const float*>(dh_last);
  p.du = static_cast<T*>(out[0]);
  p.dg = static_cast<T*>(out[1]);
  for (int v = 0; v < kVecs; ++v) p.dvec[v] = static_cast<T*>(out[2 + v]);
  p.dh0 = static_cast<float*>(dh0);
  p.B = B;
  p.S = S;
  p.L = L;
  p.nc = (S + kChunk - 1) / kChunk;
  p.part = static_cast<float*>(scratch);
  p.sum_a = p.part + (size_t)kVecs * B * p.nc * L;
  p.sum_e = p.sum_a + (size_t)B * (p.nc - 1) * L;
  return launch<T>(p, stream);
}

}  // namespace

extern "C" {

// in: u, gpre, dy (B, S, L) and a_w, a_b, x_w, x_b, lam (L,), all of `dtype`
// (0 float32, 1 bfloat16); carries (B, ceil(S / chunk), L) float32 from the
// forward (rglru_scan's `carries`); dh_last (B, L) float32 or null.  out:
// du, dgpre (B, S, L) and the five vector gradients (L,), of `dtype`; dh0
// (B, L) float32 or null.  scratch: (5 nc + 2 (nc - 1)) B L float32, nc =
// ceil(S / chunk).  Returns a cudaError_t (0 on success).
int rglru_scan_bwd(const void* const* in, const void* carries, const void* dh_last,
                   void* const* out, void* dh0, void* scratch, int B, int S, int L, int dtype,
                   void* stream) {
  const int nc = S >= 1 ? (S + kChunk - 1) / kChunk : 0;
  if (B < 1 || S < 1 || L < 1 || B > 65535 || nc > 65535 || carries == nullptr ||
      scratch == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(in, carries, dh_last, out, dh0, scratch, B, S, L, st);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(in, carries, dh_last, out, dh0, scratch, B, S, L, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The chunk length the carries are read at (rglru.cuh's kChunk).
int rglru_scan_bwd_chunk() { return kChunk; }

const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
