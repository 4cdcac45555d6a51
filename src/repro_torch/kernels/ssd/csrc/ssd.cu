// Mamba-2 SSD chunk scan (state-space duality) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `ssd_pallas`
// (src/repro/kernels/ssd/kernel.py:91, its pallas_call at :103), which
// takes one group, and the reference model's grouped scan beside it
// (src/repro/models/ssd.py:83), B and C shared by the H / G heads of a
// group: for every batch row b and head h, reading B and C of group
// g = h / (H / G), over the chunks of l positions in order, with
// cum = cumsum(dA) inside the chunk,
//   L[i, j]  = exp(cum_i - cum_j) for i >= j, else 0
//   y_diag   = (C . B^T o L) . xdt
//   y_off    = exp(cum_i) * (C . S_prev^T)
//   S       <- exp(cum_end) * S + sum_j exp(cum_end - cum_j) * xdt_j^T B_j
// and returns y and the final state S.  Layouts as the reference's:
// xdt and y (B, S, H, P), dA (B, S, H), bm and cm (B, S, G, N), the final
// state (B, H, P, N), all fp32; S is a multiple of l (the model pads with
// dt = 0 steps, which leave the state unchanged).  L is formed as
// exp(cum_i - cum_j), never as a quotient of exponentials, which would
// underflow over a chunk whose decays sum below -100.  IEEE fp32 on the
// CUDA cores throughout: no TF32 and no tensor cores, which the 2e-4 / 1e-3
// tolerances and the port's fp32 contract rest on.
//
// What bounds it on the H100: operations.  At the serving shape (B = 8,
// S = 1024, H = 24, P = 64, N = 128, l = 128) the causal work is 8.201
// GFLOP of fp32 (the scores once per chunk over the lower triangle, then
// per head y_diag over the triangle, y_off and the chunk state, l.P.N
// each), 0.1224 ms at 67 TFLOP/s, while its 116.1 MB (xdt and y 50 MB
// each, B and C 4 MB each, the final state 6 MB) take 0.035 ms at
// 3.35 TB/s.
//
// The design is the Mamba-2 split: five kernels launched in order on one
// stream by `ssd_chunk_scan` (kernels/ssd/ops.py), one C entry point each,
// the same stages as the plain version (kernels/ssd/ref.py); every kernel's
// name contains `ssd_chunk_scan`.
//   1. cumsum  (B x nc blocks, a warp per head): cum of dA inside each
//      chunk, and exp(cum_end - cum), into (B, H, nc, l).
//   2. scores  (B x nc x G x 3 blocks at the serving shape): C . B^T once
//      per (batch row, chunk, group), 64 x 64 tiles of the lower triangle
//      only, into (B, nc, G, l, l).  The scores are the same for every
//      head of a group; the TPU kernel computes them once per (batch,
//      chunk) for its one group and shares them (kernel.py:56-59), and so
//      does this one per group.
//   3. states  (B x nc x H blocks, 1,536 at the serving shape): each
//      chunk's own state sum_j exp(cum_end - cum_j) xdt_j^T B_j, an N x P
//      tile per block, into (B, nc, H, N, P): transposed, so that stages 4
//      and 5 read it along p.
//   4. pass    (B x H x P.N/1024 blocks): the short scan over the chunks,
//      S_c = exp(cum_end,c) S_{c-1} + states_c, four elements a thread,
//      the loads of eight chunks issued before their stores, writing the
//      state entering each chunk in place over the chunk states (no second
//      50 MB buffer) and the final state.
//   5. output  (B x nc x H x l/64 blocks, 3,072 at the serving shape):
//      y = exp(cum_i) C_i . S_enter^T, then + (scores o L) . xdt over the
//      causal column slices only, for a block of 64 rows; a warp skips a
//      slice that lies wholly right of its rows.
// Stages 3 and 5 read their head's group's B, C and scores; with one group
// every index is the one-group design's, so G = 1 runs the same arithmetic.
// Stages 3 and 5 keep a register tile of 8 x 4 outputs per thread and walk
// the depth of each product in slices of 32 through a two-stage cp.async
// ring in shared memory (about 50 and 35 KB a block), so the next slice
// loads while this one is multiplied; both operands are read from shared
// memory as float4 (12 loads per 128 multiply-adds), and every staging copy
// is a coalesced 16-byte copy into conflict-free rows.  The scaling of xdt
// by exp(cum_end - cum_j), and of the scores by L, is applied by each
// thread to the elements it copied once they have landed.  Shapes whose P,
// N or chunk are not multiples of 4 take the same kernels with plain loads.
// The split pays extra traffic: the chunk states (50 MB at the serving
// shape) are written by stage 3, read and rewritten by stage 4 and read by
// stage 5, about 150 MB or 0.045 ms at 3.35 TB/s.  It buys 1,536-3,072
// blocks in place of the first design's 192 (one per (head, batch row),
// 197 KB each, one per SM, two waves on 132 SMs), and the scores 24 times
// fewer.
//
// Measured by chip_smoke.py at the serving shape under torch.profiler
// (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md): 0.366-0.367 ms for the five
// kernels, 3.0 times the bound, against 1.070-1.109 ms for the one-kernel
// design it replaces in the same call; by stage, output 0.198, states
// 0.094, pass 0.047, scores 0.020, cumsum 0.006 ms.

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kMaxL = 128;  // the largest chunk
constexpr int kMaxP = 64;   // the largest head dim
constexpr int kMaxN = 128;  // the largest state size
constexpr int kSlice = 32;  // depth of one staged slice of a product
constexpr int kTile = 64;   // rows (and columns) of a score tile and an output block

// ---------------------------------------------------------------- 1. cumsum

__global__ void __launch_bounds__(128)
ssd_chunk_scan_cumsum_kernel(const float* __restrict__ dA, float* __restrict__ cum,
                             float* __restrict__ wend, int S, int H, int L) {
  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const int nc = gridDim.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int per = (L + 31) / 32;  // <= 4 positions a lane, in order
  const int owner = (L - 1) / per;  // the lane that holds position L - 1
  const int kend = (L - 1) - owner * per;
  for (int h = warp; h < H; h += 4) {
    float vals[kMaxL / 32];
    float run = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxL / 32; ++k) {
      const int j = lane * per + k;
      if (k < per && j < L) run += dA[(size_t)(b * S + c * L + j) * H + h];
      vals[k] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += t;
    }
    const float before = incl - run;
    float last = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxL / 32; ++k)
      if (k == kend) last = before + vals[k];
    const float cend = __shfl_sync(0xffffffffu, last, owner);
    const size_t o = ((size_t)(b * H + h) * nc + c) * L;
#pragma unroll
    for (int k = 0; k < kMaxL / 32; ++k) {
      const int j = lane * per + k;
      if (k < per && j < L) {
        const float v = before + vals[k];
        cum[o + j] = v;
        wend[o + j] = expf(cend - v);
      }
    }
  }
}

// ---------------------------------------------------------------- 2. scores

__global__ void __launch_bounds__(256)
ssd_chunk_scan_scores_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
                             float* __restrict__ scores, int S, int G, int N, int L) {
  __shared__ float cs[kTile][kSlice + 1];
  __shared__ float bs[kTile][kSlice + 1];
  int t = blockIdx.x;  // the t-th tile of the lower triangle, row by row
  int ti = 0;
  while (t > ti) {
    t -= ti + 1;
    ++ti;
  }
  const int tj = t;
  const int c = blockIdx.y;
  const int b = blockIdx.z / G;
  const int g = blockIdx.z - b * G;
  const int nc = gridDim.y;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows i0 + ty + 16 a
  const int tx = tid & 15;  // columns j0 + tx + 16 k
  const int i0 = ti * kTile;
  const int j0 = tj * kTile;
  const int GN = G * N;  // row stride of B and C
  const float* crow = cm + (size_t)(b * S + c * L) * GN + g * N;
  const float* brow = bm + (size_t)(b * S + c * L) * GN + g * N;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[a][k] = 0.0f;
  for (int n0 = 0; n0 < N; n0 += kSlice) {
    __syncthreads();
    for (int e = tid; e < kTile * kSlice; e += 256) {
      const int r = e / kSlice;
      const int nn = e - r * kSlice;
      const int n = n0 + nn;
      cs[r][nn] = i0 + r < L && n < N ? crow[(size_t)(i0 + r) * GN + n] : 0.0f;
      bs[r][nn] = j0 + r < L && n < N ? brow[(size_t)(j0 + r) * GN + n] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int nn = 0; nn < kSlice; ++nn) {
      float cv[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) cv[a] = cs[ty + 16 * a][nn];
#pragma unroll
      for (int k = 0; k < 4; ++k) bv[k] = bs[tx + 16 * k][nn];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[a][k] += cv[a] * bv[k];
    }
  }
  float* out = scores + ((size_t)(b * nc + c) * G + g) * L * L;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = i0 + ty + 16 * a;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int col = j0 + tx + 16 * k;
      if (row < L && col < L) out[(size_t)row * L + col] = acc[a][k];
    }
  }
}

// ---------------------------------------------------------------- 3. states

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !in (src is
// then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr size_t kStatesSmem = (2 * kSlice * (kMaxP + kMaxN) + kMaxL) * sizeof(float);

// Each chunk's own state, transposed: states_t[n][p] = sum_j B_j[n] w_j xdt_j[p]
// with w_j = exp(cum_end - cum_j), B of the head's group.  A thread owns 8 n by 4 p.  kVec: P, N
// and L multiples of 4 and every pointer 16-byte aligned; the slices of B
// and xdt then go through a two-stage cp.async ring, so the next slice
// loads while this one is multiplied, and each thread scales the xdt rows
// it copied by w_j once they have landed.  Otherwise plain loads.  kGroups
// false: one group, whose index and row stride fold to constants, so that
// instance keeps the registers of the design without groups.
template <bool kVec, bool kGroups>
__global__ void __launch_bounds__(256)
ssd_chunk_scan_states_kernel(const float* __restrict__ xdt, const float* __restrict__ bm,
                             const float* __restrict__ wend, float* __restrict__ states_t,
                             int S, int H, int P, int G, int N, int L) {
  extern __shared__ __align__(16) float states_smem[];  // kStatesSmem bytes
  auto xs = reinterpret_cast<float (*)[kSlice][kMaxP]>(states_smem);  // [2]: w_j xdt_j
  auto bs = reinterpret_cast<float (*)[kSlice][kMaxN]>(states_smem + 2 * kSlice * kMaxP);
  float* w_s = states_smem + 2 * kSlice * (kMaxP + kMaxN);  // kMaxL
  const int h = blockIdx.x;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int nc = gridDim.y;
  const int tid = threadIdx.x;
  const int tp = tid & 15;  // p = 4 tp + k
  const int tn = tid >> 4;  // n = 8 tn + i
  const float* w = wend + ((size_t)(b * H + h) * nc + c) * L;
  const size_t pos0 = (size_t)b * S + (size_t)c * L;
  const int GN = (kGroups ? G : 1) * N;                  // row stride of B
  const float* bg = kGroups ? bm + (h / (H / G)) * N : bm;  // the head's group
  for (int j = tid; j < L; j += 256) w_s[j] = w[j];
  __syncthreads();

  auto issue = [&](int j0, int buf) {
    if (kVec) {
      for (int e = tid; e < kSlice * kMaxP / 4; e += 256) {
        const int jj = e / (kMaxP / 4);
        const int p = 4 * (e - jj * (kMaxP / 4));
        const int j = j0 + jj;
        const bool in = j < L && p < P;
        cp_async16(&xs[buf][jj][p], in ? xdt + ((pos0 + j) * H + h) * P + p : xdt, in);
      }
      for (int e = tid; e < kSlice * kMaxN / 4; e += 256) {
        const int jj = e / (kMaxN / 4);
        const int n = 4 * (e - jj * (kMaxN / 4));
        const int j = j0 + jj;
        const bool in = j < L && n < N;
        cp_async16(&bs[buf][jj][n], in ? bg + (pos0 + j) * GN + n : bm, in);
      }
    } else {
      for (int e = tid; e < kSlice * kMaxP; e += 256) {
        const int jj = e / kMaxP;
        const int p = e - jj * kMaxP;
        const int j = j0 + jj;
        xs[buf][jj][p] = j < L && p < P ? xdt[((pos0 + j) * H + h) * P + p] * w_s[j] : 0.0f;
      }
      for (int e = tid; e < kSlice * kMaxN; e += 256) {
        const int jj = e / kMaxN;
        const int n = e - jj * kMaxN;
        const int j = j0 + jj;
        bs[buf][jj][n] = j < L && n < N ? bg[(pos0 + j) * GN + n] : 0.0f;
      }
    }
  };

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = 0.0f;
  const int ns = (L + kSlice - 1) / kSlice;
  issue(0, 0);
  cp_async_commit();
  for (int sl = 0; sl < ns; ++sl) {
    const int buf = sl & 1;
    if (sl + 1 < ns) {
      issue((sl + 1) * kSlice, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (kVec) {  // w_j on the xdt rows this thread copied
      for (int e = tid; e < kSlice * kMaxP / 4; e += 256) {
        const int jj = e / (kMaxP / 4);
        const int p = 4 * (e - jj * (kMaxP / 4));
        const int j = sl * kSlice + jj;
        if (j < L) {
          const float wj = w_s[j];
          float4 v = ld4(&xs[buf][jj][p]);
          v.x *= wj; v.y *= wj; v.z *= wj; v.w *= wj;
          st4(&xs[buf][jj][p], v);
        }
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int jj = 0; jj < kSlice; ++jj) {
      const float4 b0 = ld4(&bs[buf][jj][8 * tn]);
      const float4 b1 = ld4(&bs[buf][jj][8 * tn + 4]);
      const float4 x4 = ld4(&xs[buf][jj][4 * tp]);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][k] += bv[i] * xv[k];
    }
    __syncthreads();  // this buffer is consumed before the next slice refills it
  }
  float* out = states_t + ((size_t)(b * nc + c) * H + h) * P * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int n = 8 * tn + i;
    if (n >= N) continue;
    if (kVec) {
      if (4 * tp < P)
        st4(out + (size_t)n * P + 4 * tp, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * tp + k < P) out[(size_t)n * P + 4 * tp + k] = acc[i][k];
    }
  }
}

// ------------------------------------------------------------------ 4. pass

// One thread per kW elements of the (N, P) state of one (batch row, head)
// (kW = 4 when P is a multiple of 4 and the pointers 16-byte aligned, else
// 1); the loads of eight chunks are issued before their stores.
template <int kW>
__global__ void __launch_bounds__(256)
ssd_chunk_scan_pass_kernel(const float* __restrict__ cum, float* __restrict__ states_t,
                           float* __restrict__ final_state, int H, int P, int N, int L, int nc) {
  using Vec = typename std::conditional<kW == 4, float4, float>::type;
  constexpr int kGroup = 8;
  const int PN = P * N;
  const int e = kW * (blockIdx.x * 256 + threadIdx.x);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  if (e >= PN) return;
  const float* cb = cum + (size_t)(b * H + h) * nc * L;
  float s[kW];
#pragma unroll
  for (int k = 0; k < kW; ++k) s[k] = 0.0f;
  for (int c0 = 0; c0 < nc; c0 += kGroup) {
    Vec own[kGroup];
    float decay[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (c0 + g < nc) {
        own[g] = *reinterpret_cast<const Vec*>(
            &states_t[((size_t)(b * nc + c0 + g) * H + h) * PN + e]);
        decay[g] = expf(cb[(size_t)(c0 + g) * L + L - 1]);
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (c0 + g < nc) {
        float* at = &states_t[((size_t)(b * nc + c0 + g) * H + h) * PN + e];
        const float* o = reinterpret_cast<const float*>(&own[g]);
#pragma unroll
        for (int k = 0; k < kW; ++k) {
          at[k] = s[k];  // the state entering chunk c0 + g
          s[k] = decay[g] * s[k] + o[k];
        }
      }
    }
  }
  const int n = e / P;
  const int p = e - n * P;  // kW elements share n: P is a multiple of kW
#pragma unroll
  for (int k = 0; k < kW; ++k)
    final_state[(size_t)(b * H + h) * PN + (size_t)(p + k) * N + n] = s[k];
}

// ---------------------------------------------------------------- 5. output

// y for 64 rows of one (batch row, chunk, head), C and the scores of its
// group: first y_off = C . S_enter^T
// scaled by exp(cum_i) per row, then y_diag = (scores o L) . xdt over the
// causal column slices.  A thread owns 8 rows by 4 p.  The row operand (C,
// or the scores o L) is staged row by row and read as float4 along the
// depth, the other (S_enter^T, or xdt) depth by depth and read as float4
// along p: 12 shared loads per 128 multiply-adds.  kVec (P, N and L
// multiples of 4, 16-byte aligned pointers): the slices go through a
// two-stage cp.async ring, the next slice loading while this one is
// multiplied, and each thread applies L = exp(cum_i - cum_j) (0 above the
// diagonal) to the scores it copied once they have landed.  kGroups as the
// states stage's.
template <bool kVec, bool kGroups>
__global__ void __launch_bounds__(128)
ssd_chunk_scan_output_kernel(const float* __restrict__ xdt, const float* __restrict__ cm,
                             const float* __restrict__ scores, const float* __restrict__ cum,
                             const float* __restrict__ entering_t, float* __restrict__ y, int S,
                             int H, int P, int G, int N, int L) {
  constexpr int AS = kSlice + 4;  // row stride of the row operand: 16-byte rows
  __shared__ float cum_s[kMaxL];
  __shared__ __align__(16) float sa[2][kTile * AS];      // [row][n or j]: C, or scores o L
  __shared__ __align__(16) float sb[2][kSlice * kMaxP];  // [n or j][p]: S_enter, or xdt
  const int nrb = (L + kTile - 1) / kTile;
  const int rb = nrb - 1 - (int)(blockIdx.x % nrb);  // the longest rows first
  const int h = blockIdx.x / nrb;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int nc = gridDim.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int tp = tid & 15;  // p = 4 tp + k
  const int tr = tid >> 4;  // rows 8 tr + i: warp w holds rows 16 w .. 16 w + 15
  const int i0 = rb * kTile;
  const int rows = min(kTile, L - i0);
  const int jend = i0 + rows;  // causal: columns before the block's end
  const size_t pos0 = (size_t)b * S + (size_t)c * L;
  const int Gs = kGroups ? G : 1;
  const int g = kGroups ? h / (H / G) : 0;  // the head's group
  const int GN = Gs * N;                    // row stride of C
  const float* cg = cm + g * N;
  const float* sc = scores + ((size_t)(b * nc + c) * Gs + g) * L * L;
  const float* st = entering_t + ((size_t)(b * nc + c) * H + h) * P * N;
  const float* cb = cum + ((size_t)(b * H + h) * nc + c) * L;
  for (int j = tid; j < L; j += 128) cum_s[j] = cb[j];
  __syncthreads();

  // Slices 0 .. n_off - 1 are y_off's (states n0 = 32 s), the rest y_diag's
  // (columns j0 = 32 (s - n_off)).
  const int n_off = (N + kSlice - 1) / kSlice;
  const int n_all = n_off + (jend + kSlice - 1) / kSlice;

  auto issue = [&](int sl, int buf) {
    float* a = sa[buf];
    float* bb = sb[buf];
    if (sl < n_off) {
      const int n0 = sl * kSlice;
      if (kVec) {
        for (int e = tid; e < kTile * kSlice / 4; e += 128) {
          const int r = e / (kSlice / 4);
          const int nn = 4 * (e - r * (kSlice / 4));
          const int n = n0 + nn;
          const bool in = r < rows && n < N;
          cp_async16(&a[r * AS + nn], in ? cg + (pos0 + i0 + r) * GN + n : cm, in);
        }
        for (int e = tid; e < kSlice * kMaxP / 4; e += 128) {
          const int nn = e / (kMaxP / 4);
          const int p = 4 * (e - nn * (kMaxP / 4));
          const int n = n0 + nn;
          const bool in = n < N && p < P;
          cp_async16(&bb[nn * kMaxP + p], in ? st + (size_t)n * P + p : st, in);
        }
      } else {
        for (int e = tid; e < kTile * kSlice; e += 128) {
          const int r = e / kSlice;
          const int nn = e - r * kSlice;
          const int n = n0 + nn;
          a[r * AS + nn] = r < rows && n < N ? cg[(pos0 + i0 + r) * GN + n] : 0.0f;
        }
        for (int e = tid; e < kSlice * kMaxP; e += 128) {
          const int nn = e / kMaxP;
          const int p = e - nn * kMaxP;
          const int n = n0 + nn;
          bb[nn * kMaxP + p] = n < N && p < P ? st[(size_t)n * P + p] : 0.0f;
        }
      }
    } else {
      const int j0 = (sl - n_off) * kSlice;
      if (kVec) {
        for (int e = tid; e < kTile * kSlice / 4; e += 128) {
          const int r = e / (kSlice / 4);
          const int jj = 4 * (e - r * (kSlice / 4));
          const int j = j0 + jj;
          const bool in = r < rows && j < jend;
          cp_async16(&a[r * AS + jj], in ? sc + (size_t)(i0 + r) * L + j : sc, in);
        }
        for (int e = tid; e < kSlice * kMaxP / 4; e += 128) {
          const int jj = e / (kMaxP / 4);
          const int p = 4 * (e - jj * (kMaxP / 4));
          const int j = j0 + jj;
          const bool in = j < jend && p < P;
          cp_async16(&bb[jj * kMaxP + p], in ? xdt + ((pos0 + j) * H + h) * P + p : xdt, in);
        }
      } else {
        for (int e = tid; e < kTile * kSlice; e += 128) {
          const int r = e / kSlice;
          const int jj = e - r * kSlice;
          const int i = i0 + r;
          const int j = j0 + jj;
          a[r * AS + jj] =
              r < rows && j <= i ? sc[(size_t)i * L + j] * expf(cum_s[i] - cum_s[j]) : 0.0f;
        }
        for (int e = tid; e < kSlice * kMaxP; e += 128) {
          const int jj = e / kMaxP;
          const int p = e - jj * kMaxP;
          const int j = j0 + jj;
          bb[jj * kMaxP + p] = j < jend && p < P ? xdt[((pos0 + j) * H + h) * P + p] : 0.0f;
        }
      }
    }
  };

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = 0.0f;

  issue(0, 0);
  cp_async_commit();
  for (int sl = 0; sl < n_all; ++sl) {
    const int buf = sl & 1;
    if (sl + 1 < n_all) {
      issue(sl + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const bool diag = sl >= n_off;
    const int j0 = (sl - n_off) * kSlice;
    if (kVec && diag) {  // L on the scores this thread copied: exp(cum_i - cum_j), 0 for j > i
      for (int e = tid; e < kTile * kSlice / 4; e += 128) {
        const int r = e / (kSlice / 4);
        const int jj = 4 * (e - r * (kSlice / 4));
        const int i = i0 + r;
        float* at = &sa[buf][r * AS + jj];
        float4 v = ld4(at);
        float* vf = reinterpret_cast<float*>(&v);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + jj + u;
          vf[u] = r < rows && j <= i ? vf[u] * expf(cum_s[i] - cum_s[j]) : 0.0f;
        }
        st4(at, v);
      }
    }
    __syncthreads();
    // A y_diag slice left of every row of this warp is all zeros for it.
    if (!diag || j0 <= i0 + 16 * warp + 15) {
      const float* a = sa[buf];
      const float* bb = sb[buf];
#pragma unroll 2
      for (int q = 0; q < kSlice; q += 4) {
        float4 a4[8], b4[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) a4[i] = ld4(&a[(8 * tr + i) * AS + q]);
#pragma unroll
        for (int u = 0; u < 4; ++u) b4[u] = ld4(&bb[(q + u) * kMaxP + 4 * tp]);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av[4] = {a4[i].x, a4[i].y, a4[i].z, a4[i].w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            acc[i][0] += av[u] * b4[u].x;
            acc[i][1] += av[u] * b4[u].y;
            acc[i][2] += av[u] * b4[u].z;
            acc[i][3] += av[u] * b4[u].w;
          }
        }
      }
    }
    if (sl == n_off - 1) {  // y_off is complete: its decay exp(cum_i) per row
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = 8 * tr + i;
        const float decay_in = r < rows ? expf(cum_s[i0 + r]) : 0.0f;
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][k] *= decay_in;
      }
    }
    __syncthreads();  // this buffer is consumed before the next slice refills it
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = 8 * tr + i;
    if (r >= rows) continue;
    float* out = y + ((pos0 + i0 + r) * H + h) * P;
    if (kVec) {
      if (4 * tp < P) st4(out + 4 * tp, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * tp + k < P) out[4 * tp + k] = acc[i][k];
    }
  }
}

bool shape_ok(int B, int S, int H, int P, int G, int N, int L) {
  return B > 0 && S > 0 && H > 0 && P > 0 && G > 0 && N > 0 && L > 0 && L <= kMaxL &&
         P <= kMaxP && N <= kMaxN && S % L == 0 && H % G == 0;
}

// float4 copies: P, N and L multiples of 4 and every pointer 16-byte aligned.
bool vec_ok(int P, int N, int L, std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= reinterpret_cast<uintptr_t>(p);
  return P % 4 == 0 && N % 4 == 0 && L % 4 == 0 && (bits & 15) == 0;
}

}  // namespace

extern "C" {

// The five stages, in this order, on one stream; each returns the launch's
// cudaError_t.  bm and cm are (B, S, G, N), G dividing H.  Scratch (B =
// batch, nc = S / L): cum and wend (B, H, nc, L), scores (B, nc, G, L, L),
// written in the 64 x 64 tiles on and below the diagonal, states_t (B, nc,
// H, N, P): each chunk's state, transposed, then (after the pass) the state
// entering each chunk.

int ssd_chunk_scan_cumsum(const void* dA, void* cum, void* wend, int B, int S, int H, int L,
                          void* stream) {
  if (!shape_ok(B, S, H, 1, 1, 1, L)) return cudaErrorInvalidValue;
  ssd_chunk_scan_cumsum_kernel<<<dim3(S / L, B), 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dA), static_cast<float*>(cum), static_cast<float*>(wend), S, H,
      L);
  return cudaGetLastError();
}

int ssd_chunk_scan_scores(const void* bm, const void* cm, void* scores, int B, int S, int G,
                          int N, int L, void* stream) {
  if (!shape_ok(B, S, G, 1, G, N, L)) return cudaErrorInvalidValue;
  const int nt = (L + kTile - 1) / kTile;
  ssd_chunk_scan_scores_kernel<<<dim3(nt * (nt + 1) / 2, S / L, B * G), 256, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(bm), static_cast<const float*>(cm), static_cast<float*>(scores),
      S, G, N, L);
  return cudaGetLastError();
}

int ssd_chunk_scan_states(const void* xdt, const void* bm, const void* wend, void* states_t,
                          int B, int S, int H, int P, int G, int N, int L, void* stream) {
  if (!shape_ok(B, S, H, P, G, N, L)) return cudaErrorInvalidValue;
  const dim3 grid(H, S / L, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const float*>(xdt);
  auto bmf = static_cast<const float*>(bm);
  auto w = static_cast<const float*>(wend);
  auto out = static_cast<float*>(states_t);
  const bool vec = vec_ok(P, N, L, {xdt, bm, states_t});
  auto kernel = G == 1 ? (vec ? ssd_chunk_scan_states_kernel<true, false>
                              : ssd_chunk_scan_states_kernel<false, false>)
                       : (vec ? ssd_chunk_scan_states_kernel<true, true>
                              : ssd_chunk_scan_states_kernel<false, true>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kStatesSmem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, 256, kStatesSmem, s>>>(x, bmf, w, out, S, H, P, G, N, L);
  return cudaGetLastError();
}

int ssd_chunk_scan_pass(const void* cum, void* states_t, void* final_state, int B, int S, int H,
                        int P, int N, int L, void* stream) {
  if (!shape_ok(B, S, H, P, 1, N, L)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto c = static_cast<const float*>(cum);
  auto st = static_cast<float*>(states_t);
  auto fs = static_cast<float*>(final_state);
  if (P % 4 == 0 && (reinterpret_cast<uintptr_t>(states_t) & 15) == 0)
    ssd_chunk_scan_pass_kernel<4><<<dim3((P * N / 4 + 255) / 256, H, B), 256, 0, s>>>(
        c, st, fs, H, P, N, L, S / L);
  else
    ssd_chunk_scan_pass_kernel<1><<<dim3((P * N + 255) / 256, H, B), 256, 0, s>>>(
        c, st, fs, H, P, N, L, S / L);
  return cudaGetLastError();
}

int ssd_chunk_scan_output(const void* xdt, const void* cm, const void* scores, const void* cum,
                          const void* entering_t, void* y, int B, int S, int H, int P, int G,
                          int N, int L, void* stream) {
  if (!shape_ok(B, S, H, P, G, N, L)) return cudaErrorInvalidValue;
  const int nrb = (L + kTile - 1) / kTile;
  const dim3 grid(nrb * H, S / L, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<grid, 128, 0, s>>>(static_cast<const float*>(xdt), static_cast<const float*>(cm),
                                static_cast<const float*>(scores),
                                static_cast<const float*>(cum),
                                static_cast<const float*>(entering_t), static_cast<float*>(y),
                                S, H, P, G, N, L);
  };
  const bool vec = vec_ok(P, N, L, {xdt, cm, scores, entering_t, y});
  if (G == 1)
    args(vec ? ssd_chunk_scan_output_kernel<true, false>
             : ssd_chunk_scan_output_kernel<false, false>);
  else
    args(vec ? ssd_chunk_scan_output_kernel<true, true>
             : ssd_chunk_scan_output_kernel<false, true>);
  return cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
