// Mamba-2 SSD chunk scan, backward (K5b), for Hopper, sm_90a.
//
// The gradient of the SSD chunk scan that K5 (ssd.cu) computes forward, in
// place of the Pallas TPU kernel `ssd_pallas`
// (src/repro/kernels/ssd/kernel.py:91).  The reference has no hand-written
// backward: jax.grad differentiates its jnp `ssd_scan`
// (src/repro/models/ssd.py:83).  Given the output's gradient dy and what the
// forward leaves (cum, the cumsum of dA inside each chunk, and the state
// entering each chunk, in K5's transposed (N, P) layout), it returns the
// gradients with respect to xdt (B, S, H, P), dA (B, S, H), bm and cm
// (B, S, N), all fp32.  Per (batch row b, chunk c, head h), with e_i =
// exp(cum_i), w_j = exp(cum_end - cum_j), L_ij = exp(cum_i - cum_j) for
// i >= j, G = C . B^T (the scores, shared by the heads), E the entering state
// and Sc the chunk's own state, the forward is
//   y_i = sum_{j <= i} G_ij L_ij xdt_j + e_i C_i . E^T,
//   Sc = sum_j w_j xdt_j^T B_j,   E_{c+1} = exp(cum_end) E_c + Sc_c,
// and the backward is its reverse, nine kernels on one stream, all named
// `ssd_chunk_bwd_*`, the stages of the plain version (kernels/ssd/ref.py,
// `ssd_chunk_bwd_ref`):
//   1. scores  C . B^T per (b, c), the lower tiles (recomputed, not saved).
//   2. dstate  dE = sum_i e_i dy_i^T C_i per (b, c, h): the gradient of the
//              entering state through y_off, into (B, nc, H, N, P).
//   3. pass    per (b, h), the reverse scan over the chunks: with g the
//              gradient of the state leaving chunk c (0 after the last: the
//              final state is not differentiated), dSc_c = g (written over
//              dE_c), dcum_end,c += exp(cum_end,c) <g, E_c>, and g <- dE_c +
//              exp(cum_end,c) g.
//   4. dx      dxdt_j = sum_{i >= j} G_ij L_ij dy_i + w_j sum_n B_j[n] dSc[:, n],
//              and r_j = w_j xdt_j . (sum_n B_j[n] dSc[:, n]), the chunk
//              states' share of dcum.
//   5. dscores per (b, c, h): dG_ij = (dy_i . xdt_j) L_ij on and below the
//              diagonal, into (B, nc, H, l, l), and qd_i = rowsum_i(dG o G) -
//              colsum_i(dG o G), dcum through L.
//   6. dbc     per (b, c, h): the heads' own dC_i = e_i dy_i . E and dB_j =
//              w_j xdt_j . dSc into (B, S, H, N), and s_i = C_i . dC_i, dcum
//              through y_off.
//   7. dcum    dcum = qd + s - r, the chunk's end also taking sum_j r_j and
//              the pass's share; ddA is its reverse cumsum in the chunk.
//   8. dgsum   the heads' dG summed per (b, c).
//   9. dbm_dcm dC = sum_h dC_h + dG . B, dB = sum_h dB_h + dG^T . C.
// Every sum is taken inside one block (per-head partials in scratch, summed
// by the next kernel), so the result is deterministic.  IEEE fp32 on the
// CUDA cores throughout, as K5 (fault P3).  K5's limits: l <= 128, P <= 64,
// N <= 128, ngroups = 1.
//
// What bounds it on the H100: operations.  At mamba2-130m's training shape
// (B = 8, S = 1024, H = 24, P = 64, N = 128, l = 128) the products are
// about 2.5 times the forward's 8.2 GFLOP, and the scratch (the heads'
// d(scores), dC and dB, 100 MB each) adds some 0.6 GB of traffic.
//
// The design is the simple one, right before fast: every product is the
// same 64 x 64 output tile of 256 threads (4 x 4 outputs a thread), its
// operands staged through shared memory in slices of 32 by functors that
// apply the decays and masks as they load (`mm_tile`).  A faster design
// would fuse stages 4-6, keep dy and xdt resident, and run the products on
// the tensor cores with an error-compensated split.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxL = 128;  // the largest chunk
constexpr int kMaxP = 64;   // the largest head dim
constexpr int kMaxN = 128;  // the largest state size
constexpr int kT = 64;      // rows and columns of an output tile
constexpr int kK = 32;      // depth of one staged slice
constexpr int kThreads = 256;
constexpr int kPassElems = kMaxP * kMaxN / kThreads;  // state elements a thread of the pass holds

// acc[a][k] += sum over depth d in [k_begin, k_end) of
//   fa(r0 + ty + 16 a, d) * fb(d, c0 + tx + 16 k),
// the functors returning 0 outside their ranges.  kARow stages A with
// consecutive threads on consecutive rows (else depths), kBCol B with
// consecutive threads on consecutive columns (else depths): whichever is
// contiguous in memory.  Starts with a barrier, so the tiles may be reused
// right after a previous call.
template <bool kARow, bool kBCol, class FA, class FB>
__device__ __forceinline__ void mm_tile(float (&acc)[4][4], FA fa, FB fb, int r0, int c0,
                                        int k_begin, int k_end, float (*as)[kK + 1],
                                        float (*bs)[kT + 1]) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  for (int k0 = k_begin; k0 < k_end; k0 += kK) {
    __syncthreads();  // the previous slice is consumed
    for (int e = tid; e < kT * kK; e += kThreads) {
      const int r = kARow ? e % kT : e / kK;
      const int kk = kARow ? e / kT : e % kK;
      const int d = k0 + kk;
      as[r][kk] = d < k_end ? fa(r0 + r, d) : 0.0f;
    }
    for (int e = tid; e < kK * kT; e += kThreads) {
      const int c = kBCol ? e % kT : e / kK;
      const int kk = kBCol ? e / kT : e % kK;
      const int d = k0 + kk;
      bs[kk][c] = d < k_end ? fb(d, c0 + c) : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = as[ty + 16 * a][kk];
#pragma unroll
      for (int k = 0; k < 4; ++k) bv[k] = bs[kk][tx + 16 * k];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[a][k] += av[a] * bv[k];
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[a][k] = 0.0f;
}

// The sum over the 16 threads tx of one row ty (a half-warp); every lane
// of the warp must call it.
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// cum of this (b, h, c) into shared memory.
__device__ __forceinline__ void load_cum(float* cum_s, const float* cum, int b, int h, int c,
                                         int H, int nc, int L) {
  const float* cb = cum + ((size_t)(b * H + h) * nc + c) * L;
  for (int i = threadIdx.x; i < L; i += blockDim.x) cum_s[i] = cb[i];
}

// ---------------------------------------------------------------- 1. scores

__global__ void __launch_bounds__(kThreads)
ssd_chunk_bwd_scores_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
                            float* __restrict__ scores, int S, int N, int L) {
  __shared__ float as[kT][kK + 1];
  __shared__ float bs[kK][kT + 1];
  int t = blockIdx.x;  // the t-th tile of the lower triangle, row by row
  int ti = 0;
  while (t > ti) {
    t -= ti + 1;
    ++ti;
  }
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int nc = gridDim.y;
  const size_t pos0 = (size_t)b * S + (size_t)c * L;
  auto fa = [&](int i, int n) { return i < L ? cm[(pos0 + i) * N + n] : 0.0f; };
  auto fb = [&](int n, int j) { return j < L ? bm[(pos0 + j) * N + n] : 0.0f; };
  float acc[4][4];
  zero(acc);
  mm_tile<false, false>(acc, fa, fb, ti * kT, t * kT, 0, N, as, bs);
  float* out = scores + (size_t)(b * nc + c) * L * L;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ti * kT + ty + 16 * a;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = t * kT + tx + 16 * k;
      if (i < L && j < L) out[(size_t)i * L + j] = acc[a][k];
    }
  }
}

// ---------------------------------------------------------------- 2. dstate

// dE[n][p] = sum_i e_i C_i[n] dy_i[p], an (n, p) tile per block.
__global__ void __launch_bounds__(kThreads)
ssd_chunk_bwd_dstate_kernel(const float* __restrict__ dy, const float* __restrict__ cm,
                            const float* __restrict__ cum, float* __restrict__ de, int S, int H,
                            int P, int N, int L) {
  __shared__ float as[kT][kK + 1];
  __shared__ float bs[kK][kT + 1];
  __shared__ float e_s[kMaxL];
  const int ntn = (N + kT - 1) / kT;
  const int h = blockIdx.x / ntn;
  const int n0 = (blockIdx.x % ntn) * kT;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int nc = gridDim.y;
  const size_t pos0 = (size_t)b * S + (size_t)c * L;
  load_cum(e_s, cum, b, h, c, H, nc, L);
  __syncthreads();
  for (int i = threadIdx.x; i < L; i += kThreads) e_s[i] = expf(e_s[i]);
  // (mm_tile's first barrier orders these writes before the staging reads)
  auto fa = [&](int n, int i) { return n < N ? e_s[i] * cm[(pos0 + i) * N + n] : 0.0f; };
  auto fb = [&](int i, int p) { return p < P ? dy[((pos0 + i) * H + h) * P + p] : 0.0f; };
  float acc[4][4];
  zero(acc);
  mm_tile<true, true>(acc, fa, fb, n0, 0, 0, L, as, bs);
  float* out = de + ((size_t)(b * nc + c) * H + h) * N * P;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int n = n0 + ty + 16 * a;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = tx + 16 * k;
      if (n < N && p < P) out[(size_t)n * P + p] = acc[a][k];
    }
  }
}

// ------------------------------------------------------------------ 3. pass

// The reverse scan over the chunks for one (b, h); dE becomes dSc in place.
__global__ void __launch_bounds__(kThreads)
ssd_chunk_bwd_pass_kernel(const float* __restrict__ cum, const float* __restrict__ entering_t,
                          float* __restrict__ de, float* __restrict__ dcend, int H, int P, int N,
                          int L, int nc) {
  __shared__ float red[kThreads / 32];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int PN = P * N;
  float g[kPassElems];
#pragma unroll
  for (int k = 0; k < kPassElems; ++k) g[k] = 0.0f;
  for (int c = nc - 1; c >= 0; --c) {
    const size_t base = ((size_t)(b * nc + c) * H + h) * PN;
    const float a = expf(cum[((size_t)(b * H + h) * nc + c) * L + L - 1]);
    float part = 0.0f;
#pragma unroll
    for (int k = 0; k < kPassElems; ++k) {
      const int e = tid + k * kThreads;
      if (e < PN) {
        const float ev = entering_t[base + e];
        const float dev = de[base + e];
        part += g[k] * ev;
        de[base + e] = g[k];  // dSc_c
        g[k] = dev + a * g[k];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    __syncthreads();  // red is free (the previous chunk's sum was read)
    if ((tid & 31) == 0) red[tid >> 5] = part;
    __syncthreads();
    if (tid == 0) {
      float total = 0.0f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) total += red[w];
      dcend[(size_t)(b * H + h) * nc + c] = a * total;
    }
  }
}

// -------------------------------------------------------------------- 4. dx

// dxdt and r for 64 positions j of one (b, c, h).
__global__ void __launch_bounds__(kThreads)
ssd_chunk_bwd_dx_kernel(const float* __restrict__ xdt, const float* __restrict__ dy,
                        const float* __restrict__ bm, const float* __restrict__ scores,
                        const float* __restrict__ cum, const float* __restrict__ dsc,
                        float* __restrict__ dxdt, float* __restrict__ rw, int S, int H, int P,
                        int N, int L) {
  __shared__ float as[kT][kK + 1];
  __shared__ float bs[kK][kT + 1];
  __shared__ float cum_s[kMaxL];
  const int nrt = (L + kT - 1) / kT;
  const int h = blockIdx.x / nrt;
  const int j0 = (blockIdx.x % nrt) * kT;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int nc = gridDim.y;
  const size_t pos0 = (size_t)b * S + (size_t)c * L;
  const float* sc = scores + (size_t)(b * nc + c) * L * L;
  const float* st = dsc + ((size_t)(b * nc + c) * H + h) * N * P;
  load_cum(cum_s, cum, b, h, c, H, nc, L);
  // (mm_tile's first barrier orders cum_s before its use)
  auto fw = [&](int j, int i) {
    return j < L && i < L && i >= j ? sc[(size_t)i * L + j] * expf(cum_s[i] - cum_s[j]) : 0.0f;
  };
  auto fdy = [&](int i, int p) { return p < P ? dy[((pos0 + i) * H + h) * P + p] : 0.0f; };
  auto fbm = [&](int j, int n) { return j < L ? bm[(pos0 + j) * N + n] : 0.0f; };
  auto fsc = [&](int n, int p) { return p < P ? st[(size_t)n * P + p] : 0.0f; };
  float acc1[4][4], acc2[4][4];
  zero(acc1);
  zero(acc2);
  mm_tile<true, true>(acc1, fw, fdy, j0, 0, j0, L, as, bs);
  mm_tile<false, true>(acc2, fbm, fsc, j0, 0, 0, N, as, bs);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = j0 + ty + 16 * a;
    float rpart = 0.0f;
    float w = 0.0f;
    if (j < L) {
      w = expf(cum_s[L - 1] - cum_s[j]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = tx + 16 * k;
        if (p < P) {
          const size_t at = ((pos0 + j) * H + h) * P + p;
          dxdt[at] = acc1[a][k] + w * acc2[a][k];
          rpart += xdt[at] * acc2[a][k];
        }
      }
    }
    rpart = row_sum(rpart);
    if (j < L && tx == 0) rw[((size_t)(b * H + h) * nc + c) * L + j] = w * rpart;
  }
}

// --------------------------------------------------------------- 5. dscores

// Per (b, c, h): dG on and below the diagonal, and qd = rowsum - colsum of
// dG o G, over the lower tiles in turn.
__global__ void __launch_bounds__(kThreads)
ssd_chunk_bwd_dscores_kernel(const float* __restrict__ xdt, const float* __restrict__ dy,
                             const float* __restrict__ scores, const float* __restrict__ cum,
                             float* __restrict__ dg, float* __restrict__ qd, int S, int H, int P,
                             int L) {
  __shared__ float as[kT][kK + 1];
  __shared__ float bs[kK][kT + 1];
  __shared__ float cum_s[kMaxL];
  __shared__ float qrow_s[kMaxL];
  __shared__ float qcol_s[kMaxL];
  __shared__ float colpart[16][kT];
  const int h = blockIdx.x;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int nc = gridDim.y;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const size_t pos0 = (size_t)b * S + (size_t)c * L;
  const float* sc = scores + (size_t)(b * nc + c) * L * L;
  float* dgb = dg + ((size_t)(b * nc + c) * H + h) * L * L;
  load_cum(cum_s, cum, b, h, c, H, nc, L);
  for (int i = tid; i < L; i += kThreads) qrow_s[i] = qcol_s[i] = 0.0f;
  auto fdy = [&](int i, int p) { return i < L ? dy[((pos0 + i) * H + h) * P + p] : 0.0f; };
  auto fx = [&](int p, int j) { return j < L ? xdt[((pos0 + j) * H + h) * P + p] : 0.0f; };
  const int nt = (L + kT - 1) / kT;
  for (int ti = 0; ti < nt; ++ti) {
    for (int tj = 0; tj <= ti; ++tj) {
      const int i0 = ti * kT;
      const int c0 = tj * kT;
      float acc[4][4];
      zero(acc);
      mm_tile<false, false>(acc, fdy, fx, i0, c0, 0, P, as, bs);
      float rq[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float cq[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = c0 + tx + 16 * k;
          const bool valid = i < L && j < L && i >= j;
          const float g = valid ? acc[a][k] * expf(cum_s[i] - cum_s[j]) : 0.0f;
          if (i < L && j < L) dgb[(size_t)i * L + j] = g;
          const float q = valid ? g * sc[(size_t)i * L + j] : 0.0f;
          rq[a] += q;
          cq[k] += q;
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float v = row_sum(rq[a]);
        const int i = i0 + ty + 16 * a;
        if (tx == 0 && i < L) qrow_s[i] += v;  // one writer per row and tile
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) colpart[ty][tx + 16 * k] = cq[k];
      __syncthreads();
      if (tid < kT) {
        float v = 0.0f;
#pragma unroll
        for (int r = 0; r < 16; ++r) v += colpart[r][tid];
        if (c0 + tid < L) qcol_s[c0 + tid] += v;
      }
      __syncthreads();  // colpart is read before the next tile writes it
    }
  }
  __syncthreads();
  for (int i = tid; i < L; i += kThreads)
    qd[((size_t)(b * H + h) * nc + c) * L + i] = qrow_s[i] - qcol_s[i];
}

// ------------------------------------------------------------------- 6. dbc

// The heads' own dC (through y_off) and dB (through the chunk states) for 64
// positions of one (b, c, h), and s_i = C_i . dC_i.
__global__ void __launch_bounds__(kThreads)
ssd_chunk_bwd_dbc_kernel(const float* __restrict__ xdt, const float* __restrict__ dy,
                         const float* __restrict__ cm, const float* __restrict__ cum,
                         const float* __restrict__ entering_t, const float* __restrict__ dsc,
                         float* __restrict__ dch, float* __restrict__ dbh,
                         float* __restrict__ sp, int S, int H, int P, int N, int L) {
  __shared__ float as[kT][kK + 1];
  __shared__ float bs[kK][kT + 1];
  __shared__ float cum_s[kMaxL];
  const int nrt = (L + kT - 1) / kT;
  const int h = blockIdx.x / nrt;
  const int i0 = (blockIdx.x % nrt) * kT;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int nc = gridDim.y;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t pos0 = (size_t)b * S + (size_t)c * L;
  const size_t sbase = ((size_t)(b * nc + c) * H + h) * N * P;
  const float* ent = entering_t + sbase;
  const float* st = dsc + sbase;
  load_cum(cum_s, cum, b, h, c, H, nc, L);
  auto fdy = [&](int i, int p) { return i < L ? dy[((pos0 + i) * H + h) * P + p] : 0.0f; };
  auto fx = [&](int i, int p) { return i < L ? xdt[((pos0 + i) * H + h) * P + p] : 0.0f; };
  auto fe = [&](int p, int n) { return n < N ? ent[(size_t)n * P + p] : 0.0f; };
  auto fs = [&](int p, int n) { return n < N ? st[(size_t)n * P + p] : 0.0f; };
  float spart[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int n0 = 0; n0 < N; n0 += kT) {
    float accc[4][4], accb[4][4];
    zero(accc);
    zero(accb);
    mm_tile<false, false>(accc, fdy, fe, i0, n0, 0, P, as, bs);
    mm_tile<false, false>(accb, fx, fs, i0, n0, 0, P, as, bs);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + ty + 16 * a;
      if (i >= L) continue;
      const float e = expf(cum_s[i]);
      const float w = expf(cum_s[L - 1] - cum_s[i]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int n = n0 + tx + 16 * k;
        if (n >= N) continue;
        const size_t at = ((pos0 + i) * H + h) * N + n;
        const float dco = e * accc[a][k];
        dch[at] = dco;
        dbh[at] = w * accb[a][k];
        spart[a] += cm[(pos0 + i) * N + n] * dco;
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float v = row_sum(spart[a]);
    const int i = i0 + ty + 16 * a;
    if (tx == 0 && i < L) sp[((size_t)(b * H + h) * nc + c) * L + i] = v;
  }
}

// ------------------------------------------------------------------ 7. dcum

__global__ void __launch_bounds__(kMaxL)
ssd_chunk_bwd_dcum_kernel(const float* __restrict__ qd, const float* __restrict__ sp,
                          const float* __restrict__ rw, const float* __restrict__ dcend,
                          float* __restrict__ dda, int S, int H, int L) {
  __shared__ float d_s[kMaxL];
  const int h = blockIdx.x;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int nc = gridDim.y;
  const int tid = threadIdx.x;
  const size_t base = ((size_t)(b * H + h) * nc + c) * L;
  if (tid < L) d_s[tid] = qd[base + tid] + sp[base + tid] - rw[base + tid];
  __syncthreads();
  if (tid == 0) {
    float rs = 0.0f;
    for (int j = 0; j < L; ++j) rs += rw[base + j];
    d_s[L - 1] += rs + dcend[(size_t)(b * H + h) * nc + c];
    float run = 0.0f;
    for (int i = L - 1; i >= 0; --i) {  // ddA_k = sum_{i >= k} dcum_i
      run += d_s[i];
      d_s[i] = run;
    }
  }
  __syncthreads();
  if (tid < L) dda[((size_t)b * S + (size_t)c * L + tid) * H + h] = d_s[tid];
}

// ----------------------------------------------------------------- 8. dgsum

__global__ void __launch_bounds__(kThreads)
ssd_chunk_bwd_dgsum_kernel(const float* __restrict__ dg, float* __restrict__ dgt, int H, int L,
                           size_t total) {
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const size_t LL = (size_t)L * L;
  const size_t bc = e / LL;
  const int ij = (int)(e - bc * LL);
  const int i = ij / L;
  const int j = ij - i * L;
  float v = 0.0f;
  if (j <= i)
    for (int h = 0; h < H; ++h) v += dg[(bc * H + h) * LL + ij];
  dgt[e] = v;
}

// --------------------------------------------------------------- 9. dbm_dcm

// dC (blockIdx.z even) or dB (odd) for a 64 x 64 (position, n) tile.
__global__ void __launch_bounds__(kThreads)
ssd_chunk_bwd_dbm_dcm_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
                             const float* __restrict__ dgt, const float* __restrict__ dch,
                             const float* __restrict__ dbh, float* __restrict__ dbm,
                             float* __restrict__ dcm, int S, int H, int N, int L) {
  __shared__ float as[kT][kK + 1];
  __shared__ float bs[kK][kT + 1];
  const int ntn = (N + kT - 1) / kT;
  const int r0 = (blockIdx.x / ntn) * kT;
  const int n0 = (blockIdx.x % ntn) * kT;
  const int c = blockIdx.y;
  const int which = blockIdx.z & 1;
  const int b = blockIdx.z >> 1;
  const int nc = gridDim.y;
  const size_t pos0 = (size_t)b * S + (size_t)c * L;
  const float* g = dgt + (size_t)(b * nc + c) * L * L;
  float acc[4][4];
  zero(acc);
  if (which == 0) {  // dC_i += sum_{j <= i} dG_ij B_j
    auto fa = [&](int i, int j) { return i < L && j <= i ? g[(size_t)i * L + j] : 0.0f; };
    auto fb = [&](int j, int n) { return n < N ? bm[(pos0 + j) * N + n] : 0.0f; };
    mm_tile<false, true>(acc, fa, fb, r0, n0, 0, min(L, r0 + kT), as, bs);
  } else {  // dB_j += sum_{i >= j} dG_ij C_i
    auto fa = [&](int j, int i) { return j < L && i >= j ? g[(size_t)i * L + j] : 0.0f; };
    auto fb = [&](int i, int n) { return n < N ? cm[(pos0 + i) * N + n] : 0.0f; };
    mm_tile<true, true>(acc, fa, fb, r0, n0, r0, L, as, bs);
  }
  const float* heads = which == 0 ? dch : dbh;
  float* out = which == 0 ? dcm : dbm;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = r0 + ty + 16 * a;
    if (i >= L) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int n = n0 + tx + 16 * k;
      if (n >= N) continue;
      float v = acc[a][k];
      for (int h = 0; h < H; ++h) v += heads[((pos0 + i) * H + h) * N + n];
      out[(pos0 + i) * N + n] = v;
    }
  }
}

bool shape_ok(int B, int S, int H, int P, int N, int L) {
  return B > 0 && S > 0 && H > 0 && P > 0 && N > 0 && L > 0 && L <= kMaxL && P <= kMaxP &&
         N <= kMaxN && S % L == 0;
}

}  // namespace

extern "C" {

// One backward: the nine stages in order on one stream.  Inputs: xdt, dy
// (B, S, H, P); bm, cm (B, S, N); cum (B, H, nc, L); entering_t (B, nc, H, N,
// P).  Outputs: dxdt (B, S, H, P), dda (B, S, H), dbm, dcm (B, S, N).
// Scratch: scores (B, nc, L, L), de (B, nc, H, N, P), dcend (B, H, nc), rw,
// qd and sp (B, H, nc, L), dg (B, nc, H, L, L), dgt (B, nc, L, L), dch and
// dbh (B, S, H, N).  Returns the first failing launch's cudaError_t, or 0.
int ssd_chunk_bwd(const void* xdt, const void* bm, const void* cm, const void* dy,
                  const void* cum, const void* entering_t, void* dxdt, void* dda, void* dbm,
                  void* dcm, void* scores, void* de, void* dcend, void* rw, void* qd, void* sp,
                  void* dg, void* dgt, void* dch, void* dbh, int B, int S, int H, int P, int N,
                  int L, void* stream) {
  if (!shape_ok(B, S, H, P, N, L)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = S / L;
  const int nt = (L + kT - 1) / kT;
  const int ntn = (N + kT - 1) / kT;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  cudaError_t err;
#define REPRO_SSD_BWD_CHECK()            \
  err = cudaGetLastError();              \
  if (err != cudaSuccess) return err;

  ssd_chunk_bwd_scores_kernel<<<dim3(nt * (nt + 1) / 2, nc, B), kThreads, 0, s>>>(
      f(bm), f(cm), w(scores), S, N, L);
  REPRO_SSD_BWD_CHECK()
  ssd_chunk_bwd_dstate_kernel<<<dim3(H * ntn, nc, B), kThreads, 0, s>>>(
      f(dy), f(cm), f(cum), w(de), S, H, P, N, L);
  REPRO_SSD_BWD_CHECK()
  ssd_chunk_bwd_pass_kernel<<<dim3(H, B), kThreads, 0, s>>>(f(cum), f(entering_t), w(de),
                                                            w(dcend), H, P, N, L, nc);
  REPRO_SSD_BWD_CHECK()
  ssd_chunk_bwd_dx_kernel<<<dim3(H * nt, nc, B), kThreads, 0, s>>>(
      f(xdt), f(dy), f(bm), f(scores), f(cum), f(de), w(dxdt), w(rw), S, H, P, N, L);
  REPRO_SSD_BWD_CHECK()
  ssd_chunk_bwd_dscores_kernel<<<dim3(H, nc, B), kThreads, 0, s>>>(
      f(xdt), f(dy), f(scores), f(cum), w(dg), w(qd), S, H, P, L);
  REPRO_SSD_BWD_CHECK()
  ssd_chunk_bwd_dbc_kernel<<<dim3(H * nt, nc, B), kThreads, 0, s>>>(
      f(xdt), f(dy), f(cm), f(cum), f(entering_t), f(de), w(dch), w(dbh), w(sp), S, H, P, N, L);
  REPRO_SSD_BWD_CHECK()
  ssd_chunk_bwd_dcum_kernel<<<dim3(H, nc, B), kMaxL, 0, s>>>(f(qd), f(sp), f(rw), f(dcend),
                                                             w(dda), S, H, L);
  REPRO_SSD_BWD_CHECK()
  const size_t total = (size_t)B * nc * L * L;
  ssd_chunk_bwd_dgsum_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      f(dg), w(dgt), H, L, total);
  REPRO_SSD_BWD_CHECK()
  ssd_chunk_bwd_dbm_dcm_kernel<<<dim3(nt * ntn, nc, 2 * B), kThreads, 0, s>>>(
      f(bm), f(cm), f(dgt), f(dch), f(dbh), w(dbm), w(dcm), S, H, N, L);
  REPRO_SSD_BWD_CHECK()
#undef REPRO_SSD_BWD_CHECK
  return cudaSuccess;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
