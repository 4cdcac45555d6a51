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
// (B, S, Gr, N) (Gr groups, head h reading group h / (H / Gr)), all fp32.
// Per (batch row b, chunk c, head h), with e_i = exp(cum_i), w_j =
// exp(cum_end - cum_j), L_ij = exp(cum_i - cum_j) for i >= j, G = C . B^T
// (the scores of the head's group, shared by its heads), E the entering
// state and Sc the chunk's own state, the forward is
//   y_i = sum_{j <= i} G_ij L_ij xdt_j + e_i C_i . E^T,
//   Sc = sum_j w_j xdt_j^T B_j,   E_{c+1} = exp(cum_end) E_c + Sc_c,
// and the backward is its reverse, nine kernels on one stream, all named
// `ssd_chunk_bwd_*`, the stages of the plain version (kernels/ssd/ref.py,
// `ssd_chunk_bwd_ref`):
//   1. scores  C . B^T per (b, c, group), the lower tiles (recomputed, not
//              saved).
//   2. dstate  dE = sum_i e_i dy_i^T C_i per (b, c, h): the gradient of the
//              entering state through y_off, into (B, nc, H, N, P).
//   3. pass    per (b, h) and 8 state rows p, the reverse scan over the chunks: with g the
//              gradient of the state leaving chunk c (0 after the last:
//              the final state is not differentiated), dSc_c = g (written over
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
//   8. dgsum   each group's heads' dG summed per (b, c, group), in head order.
//   9. dbm_dcm per group, dC = sum_h dC_h + dG . B, dB = sum_h dB_h + dG^T . C
//              over the group's heads h, in head order.
// Every sum is taken inside one block (per-head and per-block partials in
// scratch, summed by a later kernel in a fixed order, no atomics), so the
// result is deterministic, bit for bit from call to call.  With one group
// every index is the one-group design's, and so is the arithmetic.  K5's
// limits: l <= 128, P <= 64, N <= 128.
//
// What bounds it on the H100: operations.  At mamba2-130m's training shape
// (B = 8, S = 1024, H = 24, P = 64, N = 128, l = 128) the products are 18.3
// GFLOP, about 2.5 times the forward's; the scratch (the heads' d(scores),
// dC and dB, 100 MB each) adds some 0.6 GB of traffic.  K5 and K5b stay fp32
// (fault P3), so the least time is that of an fp32-accurate route: the
// products as three TF32 passes at 495 TFLOP/s, 0.111 ms, against 0.273 ms
// at the fp32 CUDA-core peak of 67 TFLOP/s.
//
// The design:
// * Every product is one 64 x 64 output tile of 256 threads (`mm_tile`),
//   its operands staged through shared memory in slices of 32 by functors
//   that apply the decays and masks as they load, with the rows padded (36
//   and 72 floats) so that the fragment loads hit 32 banks.  The 8 warps
//   each own a 16 x 32 part of the tile as four m16n8 accumulators, on the
//   tensor cores: each operand x is split into hi = tf32(x) and lo =
//   tf32(x - hi) (cvt.rna), and mma.sync.m16n8k8 (TF32 in, fp32 accumulate)
//   adds a_lo b_hi + a_hi b_lo, then a_hi b_hi: the error-compensated
//   "3xTF32" product, within a few fp32 ulps of the fp32 one (a single TF32
//   pass would keep about three decimal digits, which fault P3 forbids).
//   Each slice's functor loads are issued before the previous slice's
//   products.  `acc_at` maps an accumulator index to its tile coordinate;
//   every epilogue stages the tile through shared memory with it
//   (`to_tile`) and walks it a row per warp (`out_at`), so its device
//   reads and writes stay coalesced; row sums are warp shuffles.
// * The pass splits each (b, h) over ceil(P / 8) blocks, each owning 8 rows
//   p of the state and every n: 1,536 blocks of 128 threads at mamba2's
//   shape rather than 192 of 256.  Each block writes its partial <g, E_c>
//   per chunk to a (B, H, nc, splits) scratch, which the dcum stage sums in
//   order.
// Stages 4-6 read dy and xdt each; fusing them is later work.
//
// Measured by chip_smoke.py phase 16 (a) at mamba2's shape (NVIDIA H100
// 80GB HBM3, 700.00 W; PERF.md): 1.31 ms, 11.8 times the bound (dbc 0.386,
// dx 0.308, dscores 0.241, dstate 0.168, dbm_dcm 0.092, pass 0.070), where
// the first design (fp32 products as 4 x 4 register tiles on the CUDA
// cores, the pass on 192 blocks) took 2.24 ms, its pass 0.554.  What holds
// it back is no longer the products: their staging (functor loads from L2,
// an expf an element, two barriers a slice) and the heads' scratch written
// and read back.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxL = 128;  // the largest chunk
constexpr int kMaxP = 64;   // the largest head dim
constexpr int kMaxN = 128;  // the largest state size
constexpr int kT = 64;      // rows and columns of an output tile
constexpr int kK = 32;      // depth of one staged slice
constexpr int kThreads = 256;
// The product stages ask for 2 or 3 resident blocks an SM
// (__launch_bounds__), whichever measured faster at mamba2's shape
// (PERF.md; benchmarks/torch_kernel_probe.py ssd-bwd): 3 caps the registers at 80, which spills a few bytes in
// dstate, dx and dbc and still gains from the occupancy; scores, dscores
// and dbm_dcm run best at 2.
constexpr int kAS = kK + 4;  // row stride of the staged A slice
constexpr int kBS = kT + 8;  // row stride of the staged B slice
constexpr int kOS = kT + 1;  // row stride of an output tile staged for its epilogue
constexpr int kE = kT * kK / kThreads;  // elements of A, and of B, a thread stages per slice
// Shared memory of a product stage: the staged slices, or after the
// products, two output tiles for the epilogue.
constexpr int kTileFloats = 2 * kT * kOS;
static_assert(kT * kAS + kK * kBS <= kTileFloats, "the slices fit the output tiles' room");
constexpr int kPassRows = 8;  // state rows p of one block of the pass
constexpr int kPassThreads = 128;
constexpr int kPassElems = kPassRows * kMaxN / kPassThreads;  // state elements a thread of the pass holds

struct At {
  int row, col;
};

// A 64 x 64 output tile is 8 warps' m16n8 accumulators: warp w owns rows
// 16 (w & 3) .. + 15 and columns 32 (w >> 2) .. + 31, four n-tiles of 8
// columns, and acc[j][c] of a lane sits at the tile coordinate acc_at(j, c).
__device__ __forceinline__ At acc_at(int j, int c) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  return {(warp & 3) * 16 + (lane >> 2) + 8 * (c >> 1),
          (warp >> 2) * 32 + 8 * j + 2 * (lane & 3) + (c & 1)};
}

// The epilogues walk a tile staged in shared memory (`to_tile`) so that a
// warp reads and writes device memory a row at a time: element (a, k) of a
// thread, a < 8 and k < 2, is row w + 8 a and column l + 32 k (w its warp,
// l its lane).
__device__ __forceinline__ At out_at(int a, int k) {
  return {(int)(threadIdx.x >> 5) + 8 * a, (int)(threadIdx.x & 31) + 32 * k};
}

// The accumulator into a shared 64 x 64 tile (row stride kOS) at acc_at's
// coordinates.  The caller puts a barrier before (the slices share its
// room) and after.
__device__ __forceinline__ void to_tile(const float (&acc)[4][4], float* tile) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const At at = acc_at(j, c);
      tile[at.row * kOS + at.col] = acc[j][c];
    }
}

// The sum over a warp's 32 lanes, in every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// x = hi + lo + O(2^-22 |x|), hi and lo TF32 (round to nearest at 10 mantissa bits).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// c += a . b for one m16n8k8 tile, TF32 in, fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Where element q of a thread's share of a staged slice goes: A's (row,
// depth) and B's (depth, column).  kARow puts A's neighbouring threads on
// neighbouring rows (else depths), kBCol B's on neighbouring columns (else
// depths): whichever is contiguous in memory, with a warp's 32 elements
// placed so that their shared-memory writes hit 32 banks.
template <bool kARow>
__device__ __forceinline__ At a_slot(int q) {
  const int e = threadIdx.x + q * kThreads;
  const int l = e & 31;
  const int w = e >> 5;
  return kARow ? At{(w & 7) * 8 + (l & 7), (w >> 3) * 4 + (l >> 3)} : At{w, l};
}

template <bool kBCol>
__device__ __forceinline__ At b_slot(int q) {
  const int e = threadIdx.x + q * kThreads;
  const int l = e & 31;
  const int w = e >> 5;
  return kBCol ? At{w >> 1, (w & 1) * 32 + l} : At{(w & 7) * 4 + (l & 3), (w >> 3) * 8 + (l >> 2)};
}

// acc[j][c] += sum over depth d in [k_begin, k_end) of
//   fa(r0 + row, d) * fb(d, c0 + col),  (row, col) = acc_at(j, c),
// the functors returning 0 outside their ranges.  Operands are staged
// through shared memory (`tiles`) in slices of kK; each slice's functor
// loads are issued before the previous slice's products, into registers.
// Each product runs on the tensor cores as three TF32 passes, a_lo b_hi +
// a_hi b_lo and then a_hi b_hi, with fp32 accumulation: fp32 accuracy, not
// TF32's (fault P3).  Starts with a barrier, so `tiles` may be reused right
// after a previous call or an epilogue.
template <bool kARow, bool kBCol, class FA, class FB>
__device__ __forceinline__ void mm_tile(float (&acc)[4][4], FA fa, FB fb, int r0, int c0,
                                        int k_begin, int k_end, float* tiles) {
  float (*as)[kAS] = reinterpret_cast<float (*)[kAS]>(tiles);
  float (*bs)[kBS] = reinterpret_cast<float (*)[kBS]>(tiles + kT * kAS);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rb = (warp & 3) * 16;
  const int cb = (warp >> 2) * 32;
  float ra[kE], rbv[kE];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int q = 0; q < kE; ++q) {
      const At sa = a_slot<kARow>(q);
      const At sb = b_slot<kBCol>(q);
      ra[q] = k0 + sa.col < k_end ? fa(r0 + sa.row, k0 + sa.col) : 0.0f;
      rbv[q] = k0 + sb.row < k_end ? fb(k0 + sb.row, c0 + sb.col) : 0.0f;
    }
  };
  if (k_begin < k_end) fetch(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += kK) {
    __syncthreads();  // the previous slice (or tile) is consumed
#pragma unroll
    for (int q = 0; q < kE; ++q) {
      const At sa = a_slot<kARow>(q);
      const At sb = b_slot<kBCol>(q);
      as[sa.row][sa.col] = ra[q];
      bs[sb.row][sb.col] = rbv[q];
    }
    __syncthreads();
    if (k0 + kK < k_end) fetch(k0 + kK);  // in flight during the products
#pragma unroll
    for (int ks = 0; ks < kK; ks += 8) {
      uint32_t ahi[4], alo[4];
      split_tf32(as[rb + g][ks + t], ahi[0], alo[0]);
      split_tf32(as[rb + g + 8][ks + t], ahi[1], alo[1]);
      split_tf32(as[rb + g][ks + t + 4], ahi[2], alo[2]);
      split_tf32(as[rb + g + 8][ks + t + 4], ahi[3], alo[3]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bhi[2], blo[2];
        split_tf32(bs[ks + t][cb + 8 * j + g], bhi[0], blo[0]);
        split_tf32(bs[ks + t + 4][cb + 8 * j + g], bhi[1], blo[1]);
        mma_tf32(acc[j], alo, bhi[0], bhi[1]);
        mma_tf32(acc[j], ahi, blo[0], blo[1]);
        mma_tf32(acc[j], ahi, bhi[0], bhi[1]);
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[a][k] = 0.0f;
}

// cum of this (b, h, c) into shared memory.
__device__ __forceinline__ void load_cum(float* cum_s, const float* cum, int b, int h, int c,
                                         int H, int nc, int L) {
  const float* cb = cum + ((size_t)(b * H + h) * nc + c) * L;
  for (int i = threadIdx.x; i < L; i += blockDim.x) cum_s[i] = cb[i];
}

// ---------------------------------------------------------------- 1. scores

__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_bwd_scores_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
                            float* __restrict__ scores, int S, int Gr, int N, int L) {
  __shared__ float tiles[kTileFloats];
  int t = blockIdx.x;  // the t-th tile of the lower triangle, row by row
  int ti = 0;
  while (t > ti) {
    t -= ti + 1;
    ++ti;
  }
  const int c = blockIdx.y;
  const int b = blockIdx.z / Gr;
  const int gr = blockIdx.z - b * Gr;
  const int nc = gridDim.y;
  const size_t pos0 = (size_t)b * S + (size_t)c * L;
  const size_t GN = (size_t)Gr * N;  // row stride of B and C
  const float* cg = cm + gr * N;
  const float* bg = bm + gr * N;
  auto fa = [&](int i, int n) { return i < L ? cg[(pos0 + i) * GN + n] : 0.0f; };
  auto fb = [&](int n, int j) { return j < L ? bg[(pos0 + j) * GN + n] : 0.0f; };
  float acc[4][4];
  zero(acc);
  mm_tile<false, false>(acc, fa, fb, ti * kT, t * kT, 0, N, tiles);
  __syncthreads();
  to_tile(acc, tiles);
  __syncthreads();
  float* out = scores + ((size_t)(b * nc + c) * Gr + gr) * L * L;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const At at = out_at(a, k);
      const int row = ti * kT + at.row;
      const int col = t * kT + at.col;
      if (row < L && col < L) out[(size_t)row * L + col] = tiles[at.row * kOS + at.col];
    }
  }
}

// ---------------------------------------------------------------- 2. dstate

// dE[n][p] = sum_i e_i C_i[n] dy_i[p], an (n, p) tile per block.  kGroups
// false: one group, whose group index and row stride fold to constants, so
// the one-group instance keeps the registers of the design without groups
// (the stages capped at 80 registers spill more with them live).
template <bool kGroups>
__global__ void __launch_bounds__(kThreads, 3)
ssd_chunk_bwd_dstate_kernel(const float* __restrict__ dy, const float* __restrict__ cm,
                            const float* __restrict__ cum, float* __restrict__ de, int S, int H,
                            int P, int Gr, int N, int L) {
  __shared__ float tiles[kTileFloats];
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
  __syncthreads();  // e_s is read by the staging functor
  const size_t GN = (size_t)(kGroups ? Gr : 1) * N;
  const float* cg = kGroups ? cm + (h / (H / Gr)) * N : cm;  // the head's group
  auto fa = [&](int n, int i) { return n < N ? e_s[i] * cg[(pos0 + i) * GN + n] : 0.0f; };
  auto fb = [&](int i, int p) { return p < P ? dy[((pos0 + i) * H + h) * P + p] : 0.0f; };
  float acc[4][4];
  zero(acc);
  mm_tile<true, true>(acc, fa, fb, n0, 0, 0, L, tiles);
  __syncthreads();
  to_tile(acc, tiles);
  __syncthreads();
  float* out = de + ((size_t)(b * nc + c) * H + h) * N * P;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const At at = out_at(a, k);
      const int n = n0 + at.row;
      if (n < N && at.col < P) out[(size_t)n * P + at.col] = tiles[at.row * kOS + at.col];
    }
  }
}

// ------------------------------------------------------------------ 3. pass

// The reverse scan over the chunks for one (b, h) and the state rows p0 ..
// p0 + kPassRows - 1 (p0 = kPassRows blockIdx.x); dE becomes dSc in place.
// The block's share of <g, E_c>, times exp(cum_end,c), goes to dcend_parts
// (B, H, nc, splits), which the dcum stage sums in a fixed order.  Each
// chunk's loads are issued before the previous chunk's arithmetic.
__global__ void __launch_bounds__(kPassThreads)
ssd_chunk_bwd_pass_kernel(const float* __restrict__ cum, const float* __restrict__ entering_t,
                          float* __restrict__ de, float* __restrict__ dcend_parts, int H, int P,
                          int N, int L, int nc) {
  __shared__ float red[2][kPassThreads / 32];
  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const size_t PN = (size_t)P * N;
  // Element k of this thread: (n, p) of the (N, P) state, neighbouring
  // threads on neighbouring p.
  int off[kPassElems];
  bool in[kPassElems];
#pragma unroll
  for (int k = 0; k < kPassElems; ++k) {
    const int e = tid + k * kPassThreads;
    const int p = split * kPassRows + e % kPassRows;
    const int n = e / kPassRows;
    in[k] = p < P && n < N;
    off[k] = in[k] ? n * P + p : 0;
  }
  auto load = [&](int c, float (&ev)[kPassElems], float (&dv)[kPassElems]) {
    const size_t base = ((size_t)(b * nc + c) * H + h) * PN;
#pragma unroll
    for (int k = 0; k < kPassElems; ++k) {
      ev[k] = in[k] ? entering_t[base + off[k]] : 0.0f;
      dv[k] = in[k] ? de[base + off[k]] : 0.0f;
    }
  };
  float g[kPassElems], ev[kPassElems], dv[kPassElems];
#pragma unroll
  for (int k = 0; k < kPassElems; ++k) g[k] = 0.0f;
  load(nc - 1, ev, dv);
  for (int c = nc - 1; c >= 0; --c) {
    float ev_next[kPassElems], dv_next[kPassElems];
    if (c > 0) load(c - 1, ev_next, dv_next);
    const size_t base = ((size_t)(b * nc + c) * H + h) * PN;
    const float a = expf(cum[((size_t)(b * H + h) * nc + c) * L + L - 1]);
    float part = 0.0f;
#pragma unroll
    for (int k = 0; k < kPassElems; ++k) {
      if (in[k]) {
        part += g[k] * ev[k];
        de[base + off[k]] = g[k];  // dSc_c
        g[k] = dv[k] + a * g[k];
      }
    }
#pragma unroll
    for (int off_ = 16; off_ > 0; off_ >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off_);
    // red[c & 1] was last read two chunks ago, before the previous barrier.
    if ((tid & 31) == 0) red[c & 1][tid >> 5] = part;
    __syncthreads();
    if (tid == 0) {
      float total = 0.0f;
#pragma unroll
      for (int w = 0; w < kPassThreads / 32; ++w) total += red[c & 1][w];
      dcend_parts[((size_t)(b * H + h) * nc + c) * splits + split] = a * total;
    }
    if (c > 0) {
#pragma unroll
      for (int k = 0; k < kPassElems; ++k) {
        ev[k] = ev_next[k];
        dv[k] = dv_next[k];
      }
    }
  }
}

// -------------------------------------------------------------------- 4. dx

// dxdt and r for 64 positions j of one (b, c, h); kGroups as dstate's.
template <bool kGroups>
__global__ void __launch_bounds__(kThreads, 3)
ssd_chunk_bwd_dx_kernel(const float* __restrict__ xdt, const float* __restrict__ dy,
                        const float* __restrict__ bm, const float* __restrict__ scores,
                        const float* __restrict__ cum, const float* __restrict__ dsc,
                        float* __restrict__ dxdt, float* __restrict__ rw, int S, int H, int P,
                        int Gr, int N, int L) {
  __shared__ float tiles[kTileFloats];
  __shared__ float cum_s[kMaxL];
  const int nrt = (L + kT - 1) / kT;
  const int h = blockIdx.x / nrt;
  const int j0 = (blockIdx.x % nrt) * kT;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int nc = gridDim.y;
  const size_t pos0 = (size_t)b * S + (size_t)c * L;
  const int Gs = kGroups ? Gr : 1;
  const int gr = kGroups ? h / (H / Gr) : 0;  // the head's group
  const size_t GN = (size_t)Gs * N;
  const float* bg = bm + gr * N;
  const float* sc = scores + ((size_t)(b * nc + c) * Gs + gr) * L * L;
  const float* st = dsc + ((size_t)(b * nc + c) * H + h) * N * P;
  load_cum(cum_s, cum, b, h, c, H, nc, L);
  __syncthreads();  // cum_s is read by the staging functor
  auto fw = [&](int j, int i) {
    return j < L && i < L && i >= j ? sc[(size_t)i * L + j] * expf(cum_s[i] - cum_s[j]) : 0.0f;
  };
  auto fdy = [&](int i, int p) { return p < P ? dy[((pos0 + i) * H + h) * P + p] : 0.0f; };
  auto fbm = [&](int j, int n) { return j < L ? bg[(pos0 + j) * GN + n] : 0.0f; };
  auto fsc = [&](int n, int p) { return p < P ? st[(size_t)n * P + p] : 0.0f; };
  float acc1[4][4], acc2[4][4];
  zero(acc1);
  zero(acc2);
  mm_tile<true, true>(acc1, fw, fdy, j0, 0, j0, L, tiles);
  mm_tile<false, true>(acc2, fbm, fsc, j0, 0, 0, N, tiles);
  __syncthreads();
  to_tile(acc1, tiles);
  to_tile(acc2, tiles + kT * kOS);
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int j = j0 + out_at(a, 0).row;
    const float w = j < L ? expf(cum_s[L - 1] - cum_s[j]) : 0.0f;
    float rpart = 0.0f;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const At at = out_at(a, k);
      if (j < L && at.col < P) {
        const float s2 = tiles[kT * kOS + at.row * kOS + at.col];
        const size_t i = ((pos0 + j) * H + h) * P + at.col;
        dxdt[i] = tiles[at.row * kOS + at.col] + w * s2;
        rpart += xdt[i] * s2;
      }
    }
    rpart = warp_sum(rpart);
    if (j < L && (threadIdx.x & 31) == 0) rw[((size_t)(b * H + h) * nc + c) * L + j] = w * rpart;
  }
}

// --------------------------------------------------------------- 5. dscores

// Per (b, c, h): dG on and below the diagonal, and qd = rowsum - colsum of
// dG o G, over the lower tiles in turn.
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_bwd_dscores_kernel(const float* __restrict__ xdt, const float* __restrict__ dy,
                             const float* __restrict__ scores, const float* __restrict__ cum,
                             float* __restrict__ dg, float* __restrict__ qd, int S, int H, int P,
                             int Gr, int L) {
  __shared__ float tiles[kTileFloats];
  __shared__ float cum_s[kMaxL];
  __shared__ float qrow_s[kMaxL];
  __shared__ float qcol_s[kMaxL];
  __shared__ float colpart[kThreads / 32][kT];
  const int h = blockIdx.x;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int nc = gridDim.y;
  const int tid = threadIdx.x;
  const size_t pos0 = (size_t)b * S + (size_t)c * L;
  const float* sc = scores + ((size_t)(b * nc + c) * Gr + h / (H / Gr)) * L * L;
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
      mm_tile<false, false>(acc, fdy, fx, i0, c0, 0, P, tiles);
      __syncthreads();
      to_tile(acc, tiles);
      __syncthreads();  // (and cum_s, qrow_s and qcol_s are written)
      float cq[2] = {0.0f, 0.0f};
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        float rq = 0.0f;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const At at = out_at(a, k);
          const int i = i0 + at.row;
          const int j = c0 + at.col;
          const bool valid = i < L && j < L && i >= j;
          const float g =
              valid ? tiles[at.row * kOS + at.col] * expf(cum_s[i] - cum_s[j]) : 0.0f;
          if (i < L && j < L) dgb[(size_t)i * L + j] = g;
          const float q = valid ? g * sc[(size_t)i * L + j] : 0.0f;
          rq += q;
          cq[k] += q;
        }
        rq = warp_sum(rq);
        const int i = i0 + out_at(a, 0).row;
        if ((tid & 31) == 0 && i < L) qrow_s[i] += rq;  // one writer per row and tile
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) colpart[tid >> 5][out_at(0, k).col] = cq[k];
      __syncthreads();
      if (tid < kT && c0 + tid < L) {
        float v = 0.0f;
#pragma unroll
        for (int w = 0; w < kThreads / 32; ++w) v += colpart[w][tid];
        qcol_s[c0 + tid] += v;
      }
      // (the next tile's mm_tile starts with a barrier: colpart is read by then)
    }
  }
  __syncthreads();
  for (int i = tid; i < L; i += kThreads)
    qd[((size_t)(b * H + h) * nc + c) * L + i] = qrow_s[i] - qcol_s[i];
}

// ------------------------------------------------------------------- 6. dbc

// The heads' own dC (through y_off) and dB (through the chunk states) for 64
// positions of one (b, c, h), and s_i = C_i . dC_i; kGroups as dstate's.
template <bool kGroups>
__global__ void __launch_bounds__(kThreads, 3)
ssd_chunk_bwd_dbc_kernel(const float* __restrict__ xdt, const float* __restrict__ dy,
                         const float* __restrict__ cm, const float* __restrict__ cum,
                         const float* __restrict__ entering_t, const float* __restrict__ dsc,
                         float* __restrict__ dch, float* __restrict__ dbh,
                         float* __restrict__ sp, int S, int H, int P, int Gr, int N, int L) {
  __shared__ float tiles[kTileFloats];
  __shared__ float cum_s[kMaxL];
  const int nrt = (L + kT - 1) / kT;
  const int h = blockIdx.x / nrt;
  const int i0 = (blockIdx.x % nrt) * kT;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int nc = gridDim.y;
  const size_t pos0 = (size_t)b * S + (size_t)c * L;
  const size_t sbase = ((size_t)(b * nc + c) * H + h) * N * P;
  const float* ent = entering_t + sbase;
  const float* st = dsc + sbase;
  const size_t GN = (size_t)(kGroups ? Gr : 1) * N;
  const float* cg = kGroups ? cm + (h / (H / Gr)) * N : cm;  // the head's group
  load_cum(cum_s, cum, b, h, c, H, nc, L);
  auto fdy = [&](int i, int p) { return i < L ? dy[((pos0 + i) * H + h) * P + p] : 0.0f; };
  auto fx = [&](int i, int p) { return i < L ? xdt[((pos0 + i) * H + h) * P + p] : 0.0f; };
  auto fe = [&](int p, int n) { return n < N ? ent[(size_t)n * P + p] : 0.0f; };
  auto fs = [&](int p, int n) { return n < N ? st[(size_t)n * P + p] : 0.0f; };
  float spart[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int n0 = 0; n0 < N; n0 += kT) {
    float accc[4][4], accb[4][4];
    zero(accc);
    zero(accb);
    mm_tile<false, false>(accc, fdy, fe, i0, n0, 0, P, tiles);
    mm_tile<false, false>(accb, fx, fs, i0, n0, 0, P, tiles);
    __syncthreads();
    to_tile(accc, tiles);
    to_tile(accb, tiles + kT * kOS);
    __syncthreads();  // (and cum_s is written)
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int i = i0 + out_at(a, 0).row;
      if (i >= L) continue;
      const float e = expf(cum_s[i]);
      const float w = expf(cum_s[L - 1] - cum_s[i]);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const At at = out_at(a, k);
        const int n = n0 + at.col;
        if (n >= N) continue;
        const size_t o = ((pos0 + i) * H + h) * N + n;
        const float dco = e * tiles[at.row * kOS + at.col];
        dch[o] = dco;
        dbh[o] = w * tiles[kT * kOS + at.row * kOS + at.col];
        spart[a] += cg[(pos0 + i) * GN + n] * dco;
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const float v = warp_sum(spart[a]);
    const int i = i0 + out_at(a, 0).row;
    if ((threadIdx.x & 31) == 0 && i < L) sp[((size_t)(b * H + h) * nc + c) * L + i] = v;
  }
}

// ------------------------------------------------------------------ 7. dcum

__global__ void __launch_bounds__(kMaxL)
ssd_chunk_bwd_dcum_kernel(const float* __restrict__ qd, const float* __restrict__ sp,
                          const float* __restrict__ rw, const float* __restrict__ dcend_parts,
                          float* __restrict__ dda, int S, int H, int L, int splits) {
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
    const float* parts = dcend_parts + ((size_t)(b * H + h) * nc + c) * splits;
    float dcend = 0.0f;
    for (int k = 0; k < splits; ++k) dcend += parts[k];  // the pass's blocks, in order
    d_s[L - 1] += rs + dcend;
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

// dgt (B, nc, Gr, L, L): group gr's heads gr * hg .. gr * hg + hg - 1 (hg =
// H / Gr), in order.
__global__ void __launch_bounds__(kThreads)
ssd_chunk_bwd_dgsum_kernel(const float* __restrict__ dg, float* __restrict__ dgt, int H, int Gr,
                           int L, size_t total) {
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const size_t LL = (size_t)L * L;
  const size_t bcg = e / LL;
  const size_t bc = bcg / Gr;
  const int hg = H / Gr;
  const int h0 = (int)(bcg - bc * Gr) * hg;
  const int ij = (int)(e - bcg * LL);
  const int i = ij / L;
  const int j = ij - i * L;
  float v = 0.0f;
  if (j <= i)
    for (int h = h0; h < h0 + hg; ++h) v += dg[(bc * H + h) * LL + ij];
  dgt[e] = v;
}

// --------------------------------------------------------------- 9. dbm_dcm

// dC (blockIdx.z even) or dB (odd) of one group for a 64 x 64 (position,
// n) tile.
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_bwd_dbm_dcm_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
                             const float* __restrict__ dgt, const float* __restrict__ dch,
                             const float* __restrict__ dbh, float* __restrict__ dbm,
                             float* __restrict__ dcm, int S, int H, int Gr, int N, int L) {
  __shared__ float tiles[kTileFloats];
  const int ntn = (N + kT - 1) / kT;
  const int r0 = (blockIdx.x / ntn) * kT;
  const int n0 = (blockIdx.x % ntn) * kT;
  const int c = blockIdx.y;
  const int which = blockIdx.z & 1;
  const int b = (blockIdx.z >> 1) / Gr;
  const int gr = (blockIdx.z >> 1) - b * Gr;
  const int nc = gridDim.y;
  const size_t pos0 = (size_t)b * S + (size_t)c * L;
  const size_t GN = (size_t)Gr * N;  // row stride of B, C, dB and dC
  const float* bg = bm + gr * N;
  const float* cg = cm + gr * N;
  const int hg = H / Gr;
  const float* g = dgt + ((size_t)(b * nc + c) * Gr + gr) * L * L;
  float acc[4][4];
  zero(acc);
  if (which == 0) {  // dC_i += sum_{j <= i} dG_ij B_j
    auto fa = [&](int i, int j) { return i < L && j <= i ? g[(size_t)i * L + j] : 0.0f; };
    auto fb = [&](int j, int n) { return n < N ? bg[(pos0 + j) * GN + n] : 0.0f; };
    mm_tile<false, true>(acc, fa, fb, r0, n0, 0, min(L, r0 + kT), tiles);
  } else {  // dB_j += sum_{i >= j} dG_ij C_i
    auto fa = [&](int j, int i) { return j < L && i >= j ? g[(size_t)i * L + j] : 0.0f; };
    auto fb = [&](int i, int n) { return n < N ? cg[(pos0 + i) * GN + n] : 0.0f; };
    mm_tile<true, true>(acc, fa, fb, r0, n0, r0, L, tiles);
  }
  __syncthreads();
  to_tile(acc, tiles);
  __syncthreads();
  const float* heads = which == 0 ? dch : dbh;
  float* out = which == 0 ? dcm : dbm;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const At at = out_at(a, k);
      const int i = r0 + at.row;
      const int n = n0 + at.col;
      if (i >= L || n >= N) continue;
      float v = tiles[at.row * kOS + at.col];
      for (int h = gr * hg; h < (gr + 1) * hg; ++h) v += heads[((pos0 + i) * H + h) * N + n];
      out[(pos0 + i) * GN + gr * N + n] = v;
    }
  }
}

bool shape_ok(int B, int S, int H, int P, int Gr, int N, int L) {
  return B > 0 && S > 0 && H > 0 && P > 0 && Gr > 0 && N > 0 && L > 0 && L <= kMaxL &&
         P <= kMaxP && N <= kMaxN && S % L == 0 && H % Gr == 0;
}

}  // namespace

extern "C" {

// One backward: the nine stages in order on one stream.  Inputs: xdt, dy
// (B, S, H, P); bm, cm (B, S, Gr, N), Gr dividing H; cum (B, H, nc, L);
// entering_t (B, nc, H, N, P).  Outputs: dxdt (B, S, H, P), dda (B, S, H),
// dbm, dcm (B, S, Gr, N).  Scratch: scores (B, nc, Gr, L, L), de (B, nc, H,
// N, P), dcend_parts (B, H, nc, ceil(P / 8)), rw, qd and sp (B, H, nc, L),
// dg (B, nc, H, L, L), dgt (B, nc, Gr, L, L), dch and dbh (B, S, H, N).
// Returns the first failing launch's cudaError_t, or 0.
int ssd_chunk_bwd(const void* xdt, const void* bm, const void* cm, const void* dy,
                  const void* cum, const void* entering_t, void* dxdt, void* dda, void* dbm,
                  void* dcm, void* scores, void* de, void* dcend_parts, void* rw, void* qd,
                  void* sp,
                  void* dg, void* dgt, void* dch, void* dbh, int B, int S, int H, int P, int Gr,
                  int N, int L, void* stream) {
  if (!shape_ok(B, S, H, P, Gr, N, L)) return cudaErrorInvalidValue;
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

  ssd_chunk_bwd_scores_kernel<<<dim3(nt * (nt + 1) / 2, nc, B * Gr), kThreads, 0, s>>>(
      f(bm), f(cm), w(scores), S, Gr, N, L);
  REPRO_SSD_BWD_CHECK()
  const bool one = Gr == 1;
  auto dstate = one ? ssd_chunk_bwd_dstate_kernel<false> : ssd_chunk_bwd_dstate_kernel<true>;
  dstate<<<dim3(H * ntn, nc, B), kThreads, 0, s>>>(
      f(dy), f(cm), f(cum), w(de), S, H, P, Gr, N, L);
  REPRO_SSD_BWD_CHECK()
  const int splits = (P + kPassRows - 1) / kPassRows;
  ssd_chunk_bwd_pass_kernel<<<dim3(splits, H, B), kPassThreads, 0, s>>>(
      f(cum), f(entering_t), w(de), w(dcend_parts), H, P, N, L, nc);
  REPRO_SSD_BWD_CHECK()
  auto dx = one ? ssd_chunk_bwd_dx_kernel<false> : ssd_chunk_bwd_dx_kernel<true>;
  dx<<<dim3(H * nt, nc, B), kThreads, 0, s>>>(
      f(xdt), f(dy), f(bm), f(scores), f(cum), f(de), w(dxdt), w(rw), S, H, P, Gr, N, L);
  REPRO_SSD_BWD_CHECK()
  ssd_chunk_bwd_dscores_kernel<<<dim3(H, nc, B), kThreads, 0, s>>>(
      f(xdt), f(dy), f(scores), f(cum), w(dg), w(qd), S, H, P, Gr, L);
  REPRO_SSD_BWD_CHECK()
  auto dbc = one ? ssd_chunk_bwd_dbc_kernel<false> : ssd_chunk_bwd_dbc_kernel<true>;
  dbc<<<dim3(H * nt, nc, B), kThreads, 0, s>>>(
      f(xdt), f(dy), f(cm), f(cum), f(entering_t), f(de), w(dch), w(dbh), w(sp), S, H, P, Gr,
      N, L);
  REPRO_SSD_BWD_CHECK()
  ssd_chunk_bwd_dcum_kernel<<<dim3(H, nc, B), kMaxL, 0, s>>>(f(qd), f(sp), f(rw),
                                                             f(dcend_parts), w(dda), S, H, L,
                                                             splits);
  REPRO_SSD_BWD_CHECK()
  const size_t total = (size_t)B * nc * Gr * L * L;
  ssd_chunk_bwd_dgsum_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      f(dg), w(dgt), H, Gr, L, total);
  REPRO_SSD_BWD_CHECK()
  ssd_chunk_bwd_dbm_dcm_kernel<<<dim3(nt * ntn, nc, 2 * B * Gr), kThreads, 0, s>>>(
      f(bm), f(cm), f(dgt), f(dch), f(dbh), w(dbm), w(dcm), S, H, Gr, N, L);
  REPRO_SSD_BWD_CHECK()
#undef REPRO_SSD_BWD_CHECK
  return cudaSuccess;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
