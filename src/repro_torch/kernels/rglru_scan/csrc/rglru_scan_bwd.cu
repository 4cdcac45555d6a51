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
// operations and seven special-function ones an element (the gates' five,
// GeLU's two), about 0.063 ms of the special-function unit at 16 a clock
// an SM.
//
// The design: the forward's chunks (rglru.cuh's kChunk), walked from the
// right by a chained scan in one kernel, then a small reduce.  Both named
// `rglru_bwd_*`, on one stream.
//   1. chain: a block is a (batch, chunk, group of kGroup = 32 channels),
//      one channel a lane, and four warps, warp j on the chunk's span of
//      steps 16 j .. 16 j + 15 (kCarry: the forward saves the h entering
//      every 16 steps).  The block takes its batch row from blockIdx and
//      its chunk and channel group from that row's ticket, in arrival
//      order, the rightmost chunks first: it waits only on the block of
//      the chunk to its right, which took an earlier ticket of the same
//      counter and so is running, and every chain of waits ends at the
//      last chunk.  Each warp stages its span's u, gpre and dy through
//      shared memory by cp.async (16-byte pieces): each read from device
//      memory once.  Walking the span forwards from its carry it evaluates
//      each element's gates once, with rglru.cuh's arithmetic, so its h
//      equals the forward's bit for bit; it writes dgpre, keeps h, a, r, i,
//      1/sqrt(v) and e = dy gelu(gpre) in shared memory (e over the staged
//      gpre and dy, once every lane has read them), and sums up the span:
//      A = prod a, E = sum_t (prod_{s <= t} a_s) e_t, so that the w the span
//      hands to its left is A w + E for the w entering it from the right.
//      The top warp then takes the w entering the chunk (dh_last, or 0, at
//      the last chunk; else what the chunk to the right published), passes
//      it through the four summaries (one fmaf each), publishes the chunk's
//      own at once for the chunk to the left (chunk 0 writes it as dh0),
//      and leaves each span its entering w.  The four walks back then run
//      side by side (g_t = e_t + w, w = a_t g_t), each writing du and its
//      span's sums of the five vector gradients' terms; the block adds the
//      spans' sums from the right into a (5, B, nc, L) scratch.  56,336 B
//      of shared memory a block in bf16 (68,624 in float32): four blocks,
//      16 warps, an SM.
//   2. reduce: each vector gradient summed over (b, chunk) in a fixed
//      order, times -8 sigmoid(Lambda) for Lambda's, in the parameters'
//      type.
// No atomics in any sum (the ticket counters only order the blocks), and a
// chunk always takes its right neighbour's published w, whatever the
// timing: two calls give the same gradients bit for bit.  ref.py's
// rglru_scan_bwd_chunked_ref follows this order of operations.
//
// Measured (benchmarks/torch_kernel_probe.py rglru-bwd --old, the first
// design's source against this one in one call; NVIDIA H100 80GB HBM3,
// 700.00 W; PERF.md): 0.333 ms at the shape above against the first
// design's 0.442 (a summary kernel and a scan kernel that evaluated the
// gates three times and read u, gpre and dy twice, unstaged), 3.3 times
// the bound; 0.053 against 0.076 for a lone prompt (B = 1).  What holds it:
// its blocks are latency-bound, four an SM as shared memory allows, and
// each block's ticket, staged loads, hand-overs and stores are work that
// nothing else in the block overlaps.  Persistent blocks fetching the next
// chunk's rows during the walk back, and u and e held in registers under a
// four-block register cap, measured slower as drafts of this design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rglru.cuh"

namespace {

using namespace rglru;

constexpr int kVecs = 5;      // a_w, a_b, x_w, x_b, Lambda
constexpr int kGroup = 32;    // channels of a chain block: a channel a lane
constexpr int kSub = kCarry;  // steps of a warp
constexpr int kWarps = kChunk / kSub;
constexpr int kHand = (1 + kVecs) * kGroup;  // a span's A, E and w, then sums: floats a warp

template <typename T>
struct BwdArgs {
  const T *u, *g, *dy, *a_w, *a_b, *x_w, *x_b, *lam;
  const float* carries;  // (B, ncar, L): the h entering every kCarry steps
  const float* dh_last;  // (B, L) or null
  T *du, *dg;            // (B, S, L)
  T* dvec[kVecs];        // (L,) each
  float* dh0;            // (B, L) or null
  float* part;           // (kVecs, B, nc, L): each chunk's sums of each vector's terms
  float* wbuf;           // (B, nc, L): the w each chunk hands its left neighbour
  int* sync;             // B ticket counters, then (B, nc, ng) published flags
  int B, S, L, nc, ncar, ng;
};

// A warp's shared memory: u (kSub x kGroup of T); gpre and dy row by row
// (kSub x 2 kGroup of T), then e over them (row r's fp32 e at the start of
// row r's bytes); h, a, r, i and 1/sqrt(v) (kSub x kGroup fp32 each).  A
// block's: its warps', then each span's summary, entering w and sums.
template <typename T>
struct Smem {
  static constexpr int kU = kSub * kGroup * sizeof(T);
  static constexpr int kRow = 2 * kGroup * sizeof(T);  // bytes of a staged gpre-and-dy row
  static constexpr int kF = kSub * kGroup * 4;
  static constexpr int kWarp = kU + kSub * kRow + 5 * kF;
  static constexpr int kBytes = kWarps * kWarp + kWarps * kHand * 4;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// `rows` rows (device rows row ..) of u, gpre and dy for the group's
// channels from c0, into a warp's shared memory: by 16-byte cp.async pieces
// (kStaged: the width is a whole number of pieces, so a piece is in or
// out), or element by element, zero past L.
// `rows` rows (device rows row ..) of u, gpre and dy for the group's
// channels from c0, into a warp's shared memory: by 16-byte cp.async pieces
// (kStaged: the width is a whole number of pieces, so a piece is in or
// out), or element by element, zero past L.
template <typename T, bool kStaged>
__device__ __forceinline__ void stage(T* us, unsigned char* gd, const BwdArgs<T>& p, size_t row,
                                      int rows, int c0, int lane) {
  if constexpr (kStaged) {
    constexpr int kPer = 16 / sizeof(T);    // elements of a piece
    constexpr int kPieces = kGroup / kPer;  // pieces of a group's row
    for (int i = lane; i < rows * kPieces * 3; i += kGroup) {
      const int arr = i / (rows * kPieces);  // 0: u, 1: gpre, 2: dy
      const int j = i - arr * rows * kPieces;
      const int r = j / kPieces;
      const int q = j % kPieces;
      const int ch = c0 + q * kPer;
      if (ch >= p.L) continue;
      const size_t off = (row + r) * p.L + ch;
      if (arr == 0) {
        cp_async16(us + r * kGroup + q * kPer, p.u + off);
      } else {
        T* dst = reinterpret_cast<T*>(gd + r * Smem<T>::kRow) + (arr - 1) * kGroup + q * kPer;
        cp_async16(dst, (arr == 1 ? p.g : p.dy) + off);
      }
    }
    cp_async_commit();
    cp_async_wait_all();
  } else {
    const int c = c0 + lane;
    const bool in = c < p.L;
    for (int r = 0; r < rows; ++r) {
      const size_t off = (row + r) * p.L + c;
      T* gdr = reinterpret_cast<T*>(gd + r * Smem<T>::kRow);
      us[r * kGroup + lane] = in ? p.u[off] : from_f<T>(0.0f);
      gdr[lane] = in ? p.g[off] : from_f<T>(0.0f);
      gdr[kGroup + lane] = in ? p.dy[off] : from_f<T>(0.0f);
    }
  }
  __syncwarp();
}

template <typename T, bool kStaged>
__global__ void __launch_bounds__(kWarps * kGroup) rglru_bwd_chain_kernel(BwdArgs<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int ticket_s;
  const int warp = threadIdx.x / kGroup;
  const int lane = threadIdx.x % kGroup;
  unsigned char* mine = smem + warp * Smem<T>::kWarp;
  T* us = reinterpret_cast<T*>(mine);
  unsigned char* gd = mine + Smem<T>::kU;
  float* hs = reinterpret_cast<float*>(gd + kSub * Smem<T>::kRow);
  float* as = hs + kSub * kGroup;
  float* rs = as + kSub * kGroup;
  float* is = rs + kSub * kGroup;
  float* qs = is + kSub * kGroup;  // 1 / sqrt(v)
  // Per warp and lane: its span's A and E, then the w entering it, then
  // its five sums (over A and E once those are consumed).
  float* spans = reinterpret_cast<float*>(smem + kWarps * Smem<T>::kWarp);
  float* span = spans + warp * kHand + lane;

  // The batch row from blockIdx, the chunk and channel group from that
  // row's ticket: the rightmost chunks first.
  const int b = blockIdx.x % p.B;
  if (threadIdx.x == 0) ticket_s = atomicAdd(p.sync + b, 1);
  __syncthreads();
  const int ticket = ticket_s;
  const int k = p.nc - 1 - ticket / p.ng;
  const int cg = ticket % p.ng;
  const int c = cg * kGroup + lane;
  const bool live = c < p.L;
  const int n = max(0, min(kSub, p.S - k * kChunk - warp * kSub));  // this warp's steps
  const size_t row0 = (size_t)b * p.S + (size_t)k * kChunk + warp * kSub;

  Gates q{};
  float h_in = 0.0f;
  if (live) {  // issued before the staged rows are waited for
    q = load_gates(p.a_w, p.a_b, p.x_w, p.x_b, p.lam, c);
    if (n > 0) h_in = p.carries[((size_t)b * p.ncar + (size_t)k * kWarps + warp) * p.L + c];
  }
  if (n > 0) stage<T, kStaged>(us, gd, p, row0, n, cg * kGroup, lane);

  // Forwards: the gates once, h as the forward computed it, dgpre; what the
  // walk back needs kept in shared memory; and the span's summary: A =
  // prod a and E = sum_t (prod_{s <= t} a_s) e_t, so that the w it hands to
  // the left is A w + E for the w that enters it from the right.
  float prod = 1.0f, esum = 0.0f;
  {
    float gv[kSub], dv[kSub];
#pragma unroll
    for (int r = 0; r < kSub; ++r) {
      const T* gdr = reinterpret_cast<const T*>(gd + r * Smem<T>::kRow);
      gv[r] = r < n ? to_f(gdr[lane]) : 0.0f;
      dv[r] = r < n ? to_f(gdr[kGroup + lane]) : 0.0f;
    }
    __syncwarp();  // every lane has read gpre and dy before e takes their place
    float h = h_in;
#pragma unroll
    for (int r = 0; r < kSub; ++r) {
      if (r >= n) break;
      const float uf = to_f(us[r * kGroup + lane]);
      const GateParts gp = gate_parts(q, uf);
      h = step(gp.a, h, gate_bx(gp, uf));
      float gelu, dgelu;
      gelu_tanh_grad(gv[r], gelu, dgelu);
      if (live) p.dg[(row0 + r) * p.L + c] = from_f<T>(dv[r] * h * dgelu);
      const float e = dv[r] * gelu;
      prod = prod * gp.a;
      esum = fmaf(prod, e, esum);
      const int at = r * kGroup + lane;
      hs[at] = h;
      as[at] = gp.a;
      rs[at] = gp.r;
      is[at] = gp.i;
      qs[at] = gp.rs;
      reinterpret_cast<float*>(gd + r * Smem<T>::kRow)[lane] = e;
    }
  }
  span[0] = prod;
  span[kGroup] = esum;
  __syncthreads();

  // The top warp takes the w entering the chunk (dh_last, or 0, at the last
  // chunk; else what the chunk to the right published), passes it through
  // the spans' summaries from the right, publishes the chunk's own for the
  // chunk to the left (chunk 0: dh0) and leaves each span its entering w.
  if (warp == kWarps - 1) {
    float w = 0.0f;
    if (k == p.nc - 1) {
      if (live && p.dh_last != nullptr) w = p.dh_last[(size_t)b * p.L + c];
    } else {
      // The right neighbour is running (its ticket came first); a wait of
      // seconds means a fault, which traps rather than hangs the card.
      const int* flag = p.sync + p.B + ((size_t)b * p.nc + k + 1) * p.ng + cg;
      for (long long spin = 0; ld_acquire(flag) == 0; ++spin) {
        if (spin > (1ll << 26)) __trap();
        __nanosleep(32);
      }
      if (live) w = __ldcg(p.wbuf + ((size_t)b * p.nc + k + 1) * p.L + c);
    }
#pragma unroll
    for (int j = kWarps - 1; j >= 0; --j) {
      float* sj = spans + j * kHand + lane;
      const float w_left = fmaf(sj[0], w, sj[kGroup]);
      sj[2 * kGroup] = w;
      w = w_left;
    }
    const size_t at = ((size_t)b * p.nc + k) * p.L + c;
    if (k > 0) {
      if (live) p.wbuf[at] = w;
      __threadfence();
      __syncwarp();
      if (lane == 0) st_release(p.sync + p.B + ((size_t)b * p.nc + k) * p.ng + cg, 1);
    } else if (live && p.dh0 != nullptr) {
      p.dh0[(size_t)b * p.L + c] = w;
    }
  }
  __syncthreads();

  // Backwards over the span, all four at once: g_t = e_t + w, du, the
  // vector gradients' terms, w = a_t g_t.
  float w = span[2 * kGroup];
  float acc_aw = 0.0f, acc_ab = 0.0f, acc_xw = 0.0f, acc_xb = 0.0f, acc_lam = 0.0f;
#pragma unroll 4
  for (int r = n - 1; r >= 0; --r) {
    const int at = r * kGroup + lane;
    const float uf = to_f(us[at]);
    const float a = as[at];
    const float ri = rs[at];
    const float ii = is[at];
    const float h_prev = r > 0 ? hs[at - kGroup] : h_in;
    const float gt = reinterpret_cast<const float*>(gd + r * Smem<T>::kRow)[lane] + w;
    bool inside;
    const float v = clamp_v(a, inside);
    const float sq = v * qs[at];  // sqrt(v)
    const float d_i = gt * sq * uf;
    const float d_v = inside ? 0.5f * gt * ii * uf * qs[at] : 0.0f;
    const float d_a = fmaf(-2.0f * a, d_v, gt * h_prev);
    const float d_loga = d_a * a;  // d(log a) = d(-8 softplus(Lambda) r)
    const float d_pre_r = d_loga * q.neg_c_sp * ri * (1.0f - ri);
    const float d_pre_i = d_i * ii * (1.0f - ii);
    if (live) {
      p.du[(row0 + r) * p.L + c] =
          from_f<T>(fmaf(d_pre_r, q.aw, fmaf(d_pre_i, q.xw, gt * sq * ii)));
    }
    acc_aw = fmaf(d_pre_r, uf, acc_aw);
    acc_ab += d_pre_r;
    acc_xw = fmaf(d_pre_i, uf, acc_xw);
    acc_xb += d_pre_i;
    acc_lam = fmaf(d_loga, ri, acc_lam);
    w = a * gt;
  }
  span[0] = acc_aw;  // (A and E are consumed)
  span[kGroup] = acc_ab;
  span[3 * kGroup] = acc_xw;
  span[4 * kGroup] = acc_xb;
  span[5 * kGroup] = acc_lam;
  __syncthreads();

  // The chunk's sums: the spans' added from the right, in a fixed order.
  if (warp == 0 && live) {
    constexpr int kSlot[kVecs] = {0, 1, 3, 4, 5};
    const size_t plane = (size_t)p.B * p.nc * p.L;
    const size_t at = ((size_t)b * p.nc + k) * p.L + c;
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      float s = spans[(kWarps - 1) * kHand + kSlot[v] * kGroup + lane];
#pragma unroll
      for (int j = kWarps - 2; j >= 0; --j) s += spans[j * kHand + kSlot[v] * kGroup + lane];
      p.part[v * plane + at] = s;
    }
  }
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

template <typename T, bool kStaged>
int launch(BwdArgs<T>& p, cudaStream_t stream) {
  auto chain = rglru_bwd_chain_kernel<T, kStaged>;
  cudaError_t err = cudaFuncSetAttribute(chain, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Smem<T>::kBytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(p.sync, 0, sizeof(int) * (p.B + (size_t)p.B * p.nc * p.ng), stream);
  if (err != cudaSuccess) return (int)err;
  chain<<<p.B * p.nc * p.ng, kWarps * kGroup, Smem<T>::kBytes, stream>>>(p);
  err = cudaGetLastError();
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
  p.ncar = (S + kCarry - 1) / kCarry;
  p.ng = (L + kGroup - 1) / kGroup;
  p.part = static_cast<float*>(scratch);
  p.wbuf = p.part + (size_t)kVecs * B * p.nc * L;
  p.sync = reinterpret_cast<int*>(p.wbuf + (size_t)B * p.nc * L);
  const bool staged = (L * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(p.u) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(p.g) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(p.dy) % 16 == 0;
  return staged ? launch<T, true>(p, stream) : launch<T, false>(p, stream);
}

}  // namespace

extern "C" {

// in: u, gpre, dy (B, S, L) and a_w, a_b, x_w, x_b, lam (L,), all of `dtype`
// (0 float32, 1 bfloat16); carries (B, ceil(S / carry), L) float32 from the
// forward (rglru_scan's `carries`); dh_last (B, L) float32 or null.  out:
// du, dgpre (B, S, L) and the five vector gradients (L,), of `dtype`; dh0
// (B, L) float32 or null.  scratch: 6 nc B L float32 and then B + B nc
// ceil(L / group) int32, nc = ceil(S / chunk).  Returns a cudaError_t (0 on
// success).
int rglru_scan_bwd(const void* const* in, const void* carries, const void* dh_last,
                   void* const* out, void* dh0, void* scratch, int B, int S, int L, int dtype,
                   void* stream) {
  const int nc = S >= 1 ? (S + kChunk - 1) / kChunk : 0;
  if (B < 1 || S < 1 || L < 1 || (long long)B * nc * ((L + kGroup - 1) / kGroup) > 0x7fffffff ||
      carries == nullptr || scratch == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(in, carries, dh_last, out, dh0, scratch, B, S, L, st);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(in, carries, dh_last, out, dh0, scratch, B, S, L, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The chunk of the partial sums and the flags (rglru.cuh's kChunk), the
// steps between the carries it reads (kCarry) and the channels of a chain
// block, which size the scratch.
int rglru_scan_bwd_chunk() { return kChunk; }
int rglru_scan_bwd_carry() { return kCarry; }
int rglru_scan_bwd_group() { return kGroup; }

const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
