// Causal GQA prefill attention, backward (K3b), for Hopper, sm_90a.
//
// Replaces the reference's hand-written flash-attention gradient, the
// custom VJP `_flash_core_bwd` (src/repro/models/attention.py:265, joined
// to its forward at :353) of the attention that the Pallas TPU kernel
// `flash_attention_pallas` (src/repro/kernels/flash_attention/kernel.py:89)
// computes forward.  Given q, k, v, the forward's output o, its per-row
// logsumexp L (float32 (B, Hq, Sq), written by flash_attention.cu when
// asked) and the output's gradient dO, it computes
//   D_i   = rowsum(dO_i o O_i)
//   p_ij  = exp(s_ij - L_i),  s_ij = q_i . k_j * scale   (masked: 0)
//   dV_j += sum_i p_ij dO_i
//   dP_ij = dO_i . v_j
//   dS_ij = p_ij (dP_ij - D_i) scale
//   dQ_i += sum_j dS_ij k_j,   dK_j += sum_i dS_ij q_i
// with the masks of the forward (key j sees query i when j <= i's position
// and, with a window w > 0, j > position - w).  p is rebuilt from L tile by
// tile and never stored whole, as the reference rebuilds it.  The G query
// heads of a KV head add into its dK and dV.  Layouts are the model's:
// q, o, dO, dQ (B, Sq, Hq, D); k, v, dK, dV (B, Skv, Hkv, D).
//
// What bounds it on the H100: operations.  The backward does five products
// of the forward's size (S and dP, dV, dK, dQ); at tinyllama's training
// shape (B = 8, S = 1024, Hq = 32, Hkv = 4, D = 64) that is 86 GFLOP of the
// causal triangle, 0.087 ms at the bf16 tensor-core peak of 989 TFLOP/s.
// So the bf16 instance has to run its products on the tensor cores.
//
// Three kernels on one stream (four with head groups, below), all named
// `flash_attention_bwd_*`:
//   1. dot   (a warp per row): D = rowsum(dO o O), fp32.
//   2. dkdv  (per 64-key tile, KV head and batch row): K and V stay in
//            shared memory while the block walks the G query heads of the
//            KV head and the query tiles that can see the tile, and
//            accumulates dK and dV in registers.  No atomics: each block
//            owns its keys' gradients.
//   3. dq    (per 64-row query tile, query head and batch row): the
//            forward's walk over the visible key tiles, accumulating dQ in
//            registers; the heaviest tiles go first.
// S and dP are recomputed by both 2 and 3 (seven products where the bound
// counts five), which keeps every sum in one block and the result
// deterministic, bit for bit from call to call.  Head dims 16, 32, 64, 128
// and 256.
//
// Three designs, picked by dtype and head dim (no fallback from one to
// another), all on the tensor cores:
//
// * bf16 at D <= 128, on the tensor cores (`*_bf16_kernel`), the design of K3's
//   forward (flash_attention.cu; helpers in mma.cuh): blocks of 4 warps,
//   mma.sync.m16n8k16 with bf16 in and fp32 accumulate, fragments by
//   ldmatrix (ldmatrix.trans where a tile is the product's B operand along
//   its rows), tiles streamed through a cp.async ring of two stages whose
//   rows are padded by 16 bytes.
//   - dkdv: the grid's slowest axis is the key tile, so the blocks of the
//     first tiles, which walk the most query tiles, are issued first.  A
//     warp owns 16 of the block's 64 keys.  K and V are resident
//     as bf16; the Q and dO tiles of the walk, with their L and D rows, come
//     through the ring.  Per query tile: S^T = K.Q^T; P^T = exp2(S^T scale
//     log2 e - L log2 e); dV += P^T.dO (P^T's accumulator repacked as the
//     next A fragment, as K3 packs p); dP^T = V.dO^T; dS^T = P^T o (dP^T -
//     D) scale; dK += dS^T.Q.  dK and dV stay in fp32 registers, 16 x D a
//     warp each; at D = 128 the query tiles are 32 rows, so S^T and dP^T
//     take 16 registers each beside them.
//   - dq: a warp owns 16 of the block's 64 queries, with its L and D rows in
//     registers (and, at D <= 64, Q's A fragments; dO's, and Q's at D =
//     128, are read again from the resident tiles, which keeps the
//     registers within the 255 a thread has).  K and V tiles (64 keys, 32
//     at D = 128) come through the ring.  Per tile: S = Q.K^T; dP = dO.V^T;
//     dS = P o (dP - D) scale, packed as an A fragment; dQ += dS.K.  The
//     grid's x axis is the query head, so the G heads of a KV head share
//     its K/V tiles in L2.
//   - The causal and window masks run on the CUDA cores only in a warp's
//     tile that straddles the diagonal, the window's edge or a ragged end;
//     interior tiles skip the compare and select.
//   - p and dS are rounded to bf16 where they become a product's operand,
//     as FlashAttention-2 does; the reference keeps them in fp32
//     (src/repro/models/attention.py:294-303).  ROADMAP, queue 3, P10.
// * bf16 at D = 256, on warpgroup products (`*_wgmma_kernel`; helpers in
//   wgmma.cuh): every operand a 64 x 256 tile, 32 KB, in shared memory
//   with the 128-byte swizzle, filled by cp.async 16-byte pieces on
//   1024-byte boundaries, read by wgmma through matrix descriptors.  Two
//   products: m64n64k16 with both operands in shared memory (S^T = K.Q^T,
//   dP^T = V.dO^T, S = Q.K^T, dP = dO.V^T: 16 a tile) and m64n256k16 with
//   A in registers (the score-sized accumulator rounded to bf16) and
//   B MN-major in shared memory (dV += P^T.dO, dK += dS^T.Q, dQ += dS.K:
//   4 a tile; dV's 8, below).  The same masks as the D <= 128 design, and
//   its rounding but for p: dV's product takes P^T as two bf16 terms, its
//   rounding and what that rounding left (P10).  With p rounded once, one
//   dv element of recurrentgemma-9b's training shape (16 over 1, B = 8, S =
//   1024), summed over 16 heads x 1024 queries, left 2e-2 + 2e-2 |ref|
//   (-0.0933 against -0.0698; the plain version with that rounding gives
//   -0.0933 too: benchmarks/torch_kernel_probe.py k3b --old, NVIDIA H100
//   80GB HBM3, 700.00 W); with two terms it uses 0.29 of it.
//   - dkdv (`flash_attention_bwd_dkdv_wgmma_kernel`): 64 keys a block, K
//     and V resident, Q and dO tiles (64 queries) and their L and D rows
//     through a ring of two stages; two warpgroups.  The first computes
//     S^T and P^T (masks only on a straddling tile) and dV += P^T.dO (two
//     bf16 terms, 8 products a tile); the second dP^T, then, once the first has put P^T in shared memory in
//     fp32 (its accumulator layout is the second's, thread for thread),
//     dS^T and dK += dS^T.Q.  dV and dK are 64 x 256 fp32, 128 registers a
//     thread.  215,040 B of shared memory, 256 threads, one block an SM;
//     ptxas 255 registers, no spill.  When a KV head's (key tile, KV head,
//     batch row) blocks would be fewer than the SMs (recurrentgemma-9b's
//     16 over 1), ops.bwd_plan spreads its G query heads over head groups
//     (enough for two waves; the groups' sizes differ by at most one); a
//     group's block writes fp32 partial dK and dV, and
//     `flash_attention_bwd_sum` adds the groups' partials in group order
//     and rounds once.  The grid's slowest axis is the key tile, so the
//     first key tiles, the longest causal walks, are issued first.
//   - dq (`flash_attention_bwd_dq_wgmma_kernel`): 64 queries of a query
//     head a block, one warpgroup, Q and dO resident, K and V tiles (64
//     keys) through a ring of two stages; S and dP as two chains of 16
//     products, P's exponentials issued while the second runs (ptxas adds
//     a warpgroup wait there; measured no faster than one chain), dS = P
//     o (dP - D) scale, dQ += dS.K.  197,632 B of shared memory, 128
//     threads; ptxas 252 registers, no spill.  The heaviest
//     query tiles go first; the grid's fastest axis is the query head, so
//     a KV head's G query heads share its K and V tiles in L2.
//   - What holds it: one block an SM, so a tile's loads, its
//     shared-memory product chains (both operands from shared memory,
//     nothing filling their waits), its exponentials and its register-A
//     products run in sequence.  p's second term makes the first
//     warpgroup's register-A products 8 a tile where the second's are 4:
//     at gemma-7b's shape dkdv went from 0.593 to 0.670 ms
//     (benchmarks/torch_kernel_probe.py k3b --old, NVIDIA H100 80GB HBM3,
//     700.00 W).
// * fp32 at fp32 accuracy, on the tensor cores (`*_f32_kernel`): the bf16
//   D <= 128 design's blocks, walks and masks with every product (S, dP,
//   dV, dK, dQ) as three TF32 products on mma.sync.m16n8k8 (K3's fp32
//   instance, flash_attention.cu, has the arithmetic; mma.cuh the helpers):
//   operands split hi = tf32(x), lo = tf32(x - hi) as their fragments load,
//   lo.hi, hi.lo, then hi.hi; p, dS, the masks, exp2 and D in IEEE fp32 on
//   the CUDA cores.  Fragments by 32-bit shared loads from tiles whose rows
//   are D + 4 floats (conflict-free either way a tile is read: dO and Q are
//   read along their rows for dP^T and S^T and across them for dV and dK);
//   P^T, dS^T and dS become the next product's A fragments as they stand,
//   the 8 keys or queries of each n-tile taken in the lane's order.  Each
//   tile's dV, dK or dQ products are summed in fresh accumulators and added
//   to the running sums by fp32 adds: kept in the accumulator itself, a sum
//   over a head's 1024 queries took the tensor cores' rounding at every
//   product and dv left 2e-5 of the plain version at tinyllama's shape.
//   - dkdv: 64 keys a block, K and V resident, 64-query tiles through the
//     ring for D <= 32, 32 for D = 64 and 128, 16 at 256; dK and dV summed
//     over each query head's walk and added to the output head by head in
//     order (one running sum of G heads' terms left 2e-5 at 16 over 1; the
//     first design, fp32 on the CUDA cores, measured it: dv 1.18 times the
//     tolerance against the float64 plain version, per-head sums 0.71).
//   - dq: 64 queries a block, Q and dO resident, 64-key tiles for D <= 32,
//     32 at 64 and 128, 16 at 256.
//   - From D = 128 two warps share each 16-row group, each holding half
//     of the gradients' columns (dK and dV whole took 128 registers a
//     thread at D = 128 and spilled) and the partial S and dP over its half
//     of D, which the pair sums through shared memory; 8 warps a block.
//     At D = 256 dkdv spills 148 bytes (ptxas, 255 registers); below 256
//     nothing spills.
//   The bound counts each of the five products three times at the TF32
//   tensor-core peak (495 TFLOP/s): 0.521 ms at tinyllama's shape, 0.130
//   ms at B = 1, S = 1024, 16 over 16, D = 256.  Measured
//   (benchmarks/torch_kernel_probe.py k3b --old, NVIDIA H100 80GB HBM3,
//   700.00 W; PERF.md): 2.76 ms at tinyllama's shape (dkdv 1.61, dq 1.08)
//   against 7.28 for the first design and 5.79 for SDPA's f32 backward;
//   0.857 ms at D = 256, B = 1, against 3.18 and 1.11.  As in K3's, the
//   two extra TF32 passes take about half of it (f32-split).
//
// Measured by chip_smoke.py phase 16 (a) (NVIDIA H100 80GB HBM3, 700.00
// W; PERF.md): the bf16 instance 0.807 ms at tinyllama's shape (dkdv 0.425,
// dq 0.319, dot 0.063), 9.3 times the bound and 1.8 times SDPA's backward
// (0.447 ms), where its first design (fp32 on the CUDA cores, as the fp32
// instance's first design, which took 7.18 ms) took 7.09 ms; 0.559 ms at llama4's shape
// (40 over 8, D = 128, B = 2) and 0.688 ms with a 1024 window (B = 2, S =
// 2048).  What holds it back, by count: seven mma.sync products where the
// bound counts five, at mma.sync's rate where the bound assumes wgmma's,
// with 72 ldmatrix.x4 per 128 MMAs a warp in dkdv.  At D = 256,
// benchmarks/torch_kernel_probe.py k3b --old (the first design's source
// against this one in one call, the same card): gemma-7b's training shape
// (B = 8, S = 1024, 16 over 16) 1.034 ms against the first design's 1.698
// (dkdv 0.670, dq 0.315), 5.9 times its bound (five products, 0.174 ms);
// recurrentgemma-9b's training shape (16 over 1, 3 head groups) 0.988
// against 2.336; its local layers (B = 2, S = 4096, window 2048) 2.605
// against 5.186; gemma3-4b's (B = 2, S = 2048, 8 over 4, window 1024) 0.416
// against 0.705.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "wgmma.cuh"

namespace {

using namespace repro_mma;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// D = rowsum(dO o O) in float32, one warp per (b, s, h) row, into (B, Hq, Sq).
template <class T>
__global__ void __launch_bounds__(256)
flash_attention_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                               float* __restrict__ drow, int rows, int Sq, int Hq, int D) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* op = o + (size_t)row * D;
  const T* dp = dout + (size_t)row * D;
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32) acc += to_f(op[d]) * to_f(dp[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % Hq;
    const int bs = row / Hq;
    const int s = bs % Sq;
    const int b = bs / Sq;
    drow[((size_t)b * Hq + h) * Sq + s] = acc;
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int Skv, int window) {
  return kpos < Skv && kpos <= qpos && (window <= 0 || kpos > qpos - window);
}

// ---------------------------------------------------- bf16 tensor-core instance

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTcThreads = 128;  // 4 warps, 16 keys (dkdv) or queries (dq) each
constexpr int kTcRows = 64;      // keys of a dkdv block, queries of a dq block

// Queries per dkdv tile and keys per dq tile: 64, or 32 at D = 128, which
// keeps the two score-sized accumulators at 16 registers each.
template <int D>
__host__ __device__ constexpr int tc_cols() { return D <= 64 ? 64 : 32; }

// Both kernels hold two 64-row tiles and a ring of two stages of two
// tc_cols-row tiles; dkdv also stages the L and D rows of its query tiles.
template <int D>
constexpr size_t tc_tiles_bytes() {
  return (size_t)(2 * kTcRows + 4 * tc_cols<D>()) * row_stride<D>() * sizeof(__nv_bfloat16);
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  return tc_tiles_bytes<D>() + 4 * tc_cols<D>() * sizeof(float);
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
}

// acc (n-tiles over the tile's rows r) += A . rows^T over the D columns,
// the A fragments read by ldmatrix at `arow` (16 rows) or taken from `af`,
// B from the shared tile `rows` (NR rows); both tiles have D-wide rows.
template <int D, int NR, bool kHeld>
__device__ __forceinline__ void mma_rows(float (&acc)[NR / 8][4], uint32_t (*af)[4],
                                         const __nv_bfloat16* arow, const __nv_bfloat16* rows,
                                         int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    if constexpr (kHeld) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = af[kk][i];
    } else {
      ldmatrix_x4(a, arow + kk * 16);
    }
#pragma unroll
    for (int np = 0; np < NR / 16; ++np) {
      uint32_t bf[4];
      ldmatrix_x4(bf, b_frag_at<D>(rows + np * 16 * row_stride<D>() + kk * 16, lane));
      mma_bf16(acc[2 * np], a, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], a, bf[2], bf[3]);
    }
  }
}

// out (16 x D) += X . cols, X the warp's 16 x NR accumulator rounded to
// bf16 as A fragments, cols the shared tile (NR rows, D wide) through
// ldmatrix.trans.
template <int D, int NR>
__device__ __forceinline__ void mma_acc_cols(float (&out)[D / 8][4], const float (&x)[NR / 8][4],
                                             const __nv_bfloat16* cols, int lane) {
#pragma unroll
  for (int kk = 0; kk < NR / 16; ++kk) {
    const uint32_t a[4] = {
        pack_bf16(x[2 * kk][0], x[2 * kk][1]),
        pack_bf16(x[2 * kk][2], x[2 * kk][3]),
        pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
        pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]),
    };
#pragma unroll
    for (int nd = 0; nd < D / 16; ++nd) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, a_frag_at<D>(cols + kk * 16 * row_stride<D>() + nd * 16, lane));
      mma_bf16(out[2 * nd], a, bf[0], bf[1]);
      mma_bf16(out[2 * nd + 1], a, bf[2], bf[3]);
    }
  }
}

// Rows 16 x D of a warp's fp32 accumulator, rounded to bf16, to rows
// row0 .. row0 + 15 (those < nrows) of a matrix with row stride `stride`
// (the first D columns at dst); the lane writes columns 2t, 2t + 1 of every
// n-tile.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float (&acc)[D / 8][4],
                                           int row0, int nrows, size_t stride, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = row0 + g + 8 * rr;
    if (r >= nrows) continue;
    __nv_bfloat16* out = dst + (size_t)r * stride + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * rr], acc[j][2 * rr + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_attention_bwd_dkdv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                     const __nv_bfloat16* __restrict__ k,
                                     const __nv_bfloat16* __restrict__ v,
                                     const __nv_bfloat16* __restrict__ dout,
                                     const float* __restrict__ lse,
                                     const float* __restrict__ drow, __nv_bfloat16* __restrict__ dk,
                                     __nv_bfloat16* __restrict__ dv, int Sq, int Skv, int Hq,
                                     int Hkv, int window, float scale, float scale_log2) {
  constexpr int ST = row_stride<D>();
  constexpr int BQ = tc_cols<D>();
  constexpr int THREADS = kTcThreads;
  constexpr int ND = D / 8;   // n-tiles of dK and dV
  constexpr int NQ = BQ / 8;  // n-tiles of S^T and dP^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // 64 x ST
  __nv_bfloat16* vs = ks + kTcRows * ST;                           // 64 x ST
  __nv_bfloat16* qs = vs + kTcRows * ST;                           // stages x BQ x ST
  __nv_bfloat16* dos = qs + 2 * BQ * ST;                           // stages x BQ x ST
  float* ls = reinterpret_cast<float*>(dos + 2 * BQ * ST);         // stages x BQ
  float* dls = ls + 2 * BQ;                                        // stages x BQ

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kTcRows;  // the first key tiles, the longest walks, go first
  const int G = Hq / Hkv;
  const int offset = Skv - Sq;  // query i sits at position offset + i
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // the accumulator rows (keys) g and g + 8 of the warp
  const int t = lane & 3;   // the accumulator columns 2t and 2t + 1 of each n-tile
  const int kw = k0 + warp * 16;  // the warp's first key
  const size_t kv_stride = (size_t)Hkv * D;
  const size_t q_stride = (size_t)Hq * D;

  // The query tiles holding a row that sees a key of this tile: position >=
  // k0 and, with a window, position <= the tile's last key + window - 1;
  // walked for each of the G heads in turn.
  const int k_last = min(k0 + kTcRows, Skv) - 1;
  const int i_lo = max(0, k0 - offset);
  const int i_hi = window > 0 ? min(Sq - 1, k_last + window - 1 - offset) : Sq - 1;
  const int qt_lo = i_lo / BQ;
  const int n_qt = i_hi >= i_lo ? i_hi / BQ - qt_lo + 1 : 0;
  const int n_it = G * n_qt;

  // Stage `stage` <- the Q and dO tiles, L and D rows of step `it` of the walk.
  auto issue = [&](int it, int stage) {
    const int h = hk * G + it / n_qt;
    const int q0 = (qt_lo + it % n_qt) * BQ;
    const size_t head = ((size_t)b * Sq * Hq + h) * D;
    cp_async_rows<D, BQ, THREADS>(qs + stage * BQ * ST, q + head, q0, Sq, q_stride, tid);
    cp_async_rows<D, BQ, THREADS>(dos + stage * BQ * ST, dout + head, q0, Sq, q_stride, tid);
    if (tid < BQ) {
      const bool in = q0 + tid < Sq;
      const size_t at = ((size_t)b * Hq + h) * Sq + (in ? q0 + tid : 0);
      cp_async4(ls + stage * BQ + tid, lse + at, in);
      cp_async4(dls + stage * BQ + tid, drow + at, in);
    }
  };

  cp_async_rows<D, kTcRows, THREADS>(ks, k + ((size_t)b * Skv * Hkv + hk) * D, k0, Skv,
                                     kv_stride, tid);
  cp_async_rows<D, kTcRows, THREADS>(vs, v + ((size_t)b * Skv * Hkv + hk) * D, k0, Skv,
                                     kv_stride, tid);
  if (n_it > 0) issue(0, 0);
  cp_async_commit();

  const __nv_bfloat16* krow = a_frag_at<D>(ks + warp * 16 * ST, lane);
  const __nv_bfloat16* vrow = a_frag_at<D>(vs + warp * 16 * ST, lane);
  float dka[ND][4], dva[ND][4];
  zero_acc(dka);
  zero_acc(dva);

  for (int it = 0; it < n_it; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_it) {  // the next tile loads while this one is used
      issue(it + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = (qt_lo + it % n_qt) * BQ;
    const __nv_bfloat16* qst = qs + stage * BQ * ST;
    const __nv_bfloat16* dost = dos + stage * BQ * ST;
    const float* lst = ls + stage * BQ;
    const float* dlst = dls + stage * BQ;

    // S^T = K . Q^T for the warp's 16 keys and the tile's BQ queries.
    float st[NQ][4], dpt[NQ][4];
    zero_acc(st);
    mma_rows<D, BQ, false>(st, nullptr, krow, qst, lane);

    // P^T, in the log2 domain; the masks only where the warp's keys and the
    // tile's queries are not all visible to each other.
    const int qpos0 = offset + q0;
    const bool full = q0 + BQ <= Sq && kw + 16 <= Skv && kw + 15 <= qpos0 &&
                      (window <= 0 || kw > qpos0 + BQ - 1 - window);
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        const float l2 = lst[c] * kLog2e;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float p = exp2f(fmaf(st[j][2 * rr + e], scale_log2, -l2));
          if (!full && !(q0 + c < Sq && visible(qpos0 + c, kw + g + 8 * rr, Skv, window)))
            p = 0.0f;
          st[j][2 * rr + e] = p;
        }
      }
    }

    // dV += P^T . dO
    mma_acc_cols<D, BQ>(dva, st, dost, lane);

    // dP^T = V . dO^T, then dS^T = P^T o (dP^T - D) scale in its place.
    zero_acc(dpt);
    mma_rows<D, BQ, false>(dpt, nullptr, vrow, dost, lane);
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dr = dlst[8 * j + 2 * t + e];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          dpt[j][2 * rr + e] = st[j][2 * rr + e] * (dpt[j][2 * rr + e] - dr) * scale;
      }
    }

    // dK += dS^T . Q
    mma_acc_cols<D, BQ>(dka, dpt, qst, lane);
    __syncthreads();  // this stage is consumed before the next load overwrites it
  }

  cp_async_wait<0>();  // (K and V were loaded even where no query sees the tile)
  const size_t base = ((size_t)b * Skv * Hkv + hk) * D;
  store_rows<D>(dk + base, dka, kw, Skv, kv_stride, lane);
  store_rows<D>(dv + base, dva, kw, Skv, kv_stride, lane);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_attention_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                   const __nv_bfloat16* __restrict__ k,
                                   const __nv_bfloat16* __restrict__ v,
                                   const __nv_bfloat16* __restrict__ dout,
                                   const float* __restrict__ lse, const float* __restrict__ drow,
                                   __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int Hq,
                                   int Hkv, int window, float scale, float scale_log2) {
  constexpr int ST = row_stride<D>();
  constexpr int BK = tc_cols<D>();
  constexpr bool kHeld = D <= 64;  // Q's A fragments held in registers
  constexpr int KD = D / 16;
  constexpr int ND = D / 8;   // n-tiles of dQ
  constexpr int NK = BK / 8;  // n-tiles of S and dP
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // 64 x ST
  __nv_bfloat16* dos = qs + kTcRows * ST;                          // 64 x ST
  __nv_bfloat16* ks = dos + kTcRows * ST;                          // stages x BK x ST
  __nv_bfloat16* vs = ks + 2 * BK * ST;                            // stages x BK x ST

  const int h = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest (last) tiles first
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kTcRows;
  const int offset = Skv - Sq;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // the accumulator rows (queries) g and g + 8 of the warp
  const int t = lane & 3;   // the accumulator columns 2t and 2t + 1 of each n-tile
  const size_t q_stride = (size_t)Hq * D;
  const size_t kv_stride = (size_t)Hkv * D;
  const size_t head = ((size_t)b * Sq * Hq + h) * D;
  const __nv_bfloat16* kb = k + ((size_t)b * Skv * Hkv + hk) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * Skv * Hkv + hk) * D;

  // Key tiles this query tile can see (at least one: k_start <= q_first < k_stop).
  const int q_first = offset + q0;
  const int q_last = offset + min(q0 + kTcRows, Sq) - 1;
  const int k_stop = min(Skv, q_last + 1);
  int k_start = 0;
  if (window > 0) {
    const int lo = q_first - window + 1;
    k_start = lo > 0 ? (lo / BK) * BK : 0;
  }
  const int n_tiles = (k_stop - k_start + BK - 1) / BK;

  cp_async_rows<D, kTcRows, kTcThreads>(qs, q + head, q0, Sq, q_stride, tid);
  cp_async_rows<D, kTcRows, kTcThreads>(dos, dout + head, q0, Sq, q_stride, tid);
  cp_async_commit();
  cp_async_rows<D, BK, kTcThreads>(ks, kb, k_start, Skv, kv_stride, tid);
  cp_async_rows<D, BK, kTcThreads>(vs, vb, k_start, Skv, kv_stride, tid);
  cp_async_commit();

  // L (log2 domain) and D of the lane's rows g and g + 8.
  float l2[2], dr[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int s = q0 + warp * 16 + g + 8 * rr;
    const size_t at = ((size_t)b * Hq + h) * Sq + s;
    l2[rr] = s < Sq ? lse[at] * kLog2e : 0.0f;
    dr[rr] = s < Sq ? drow[at] : 0.0f;
  }
  const int qw = q_first + warp * 16;  // the warp's first query position
  const __nv_bfloat16* qrow = a_frag_at<D>(qs + warp * 16 * ST, lane);
  const __nv_bfloat16* dorow = a_frag_at<D>(dos + warp * 16 * ST, lane);
  uint32_t qf[kHeld ? KD : 1][4];
  if constexpr (kHeld) {  // Q's fragments, once their group has landed
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) ldmatrix_x4(qf[kk], qrow + kk * 16);
  }
  float dqa[ND][4];
  zero_acc(dqa);

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_start + it * BK;
    const int stage = it & 1;
    if (it + 1 < n_tiles) {
      const int nxt = stage ^ 1;
      cp_async_rows<D, BK, kTcThreads>(ks + nxt * BK * ST, kb, k0 + BK, Skv, kv_stride, tid);
      cp_async_rows<D, BK, kTcThreads>(vs + nxt * BK * ST, vb, k0 + BK, Skv, kv_stride, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kst = ks + stage * BK * ST;
    const __nv_bfloat16* vst = vs + stage * BK * ST;

    // S = Q . K^T and dP = dO . V^T for the warp's 16 rows and BK keys.
    float sacc[NK][4], dpa[NK][4];
    zero_acc(sacc);
    zero_acc(dpa);
    mma_rows<D, BK, kHeld>(sacc, qf, qrow, kst, lane);
    mma_rows<D, BK, false>(dpa, nullptr, dorow, vst, lane);

    // dS = P o (dP - D) scale in S's place; masks only on a straddling tile.
    const bool full = k0 + BK - 1 <= qw && k0 + BK <= Skv &&
                      (window <= 0 || k0 > qw + 15 - window);
#pragma unroll
    for (int j = 0; j < NK; ++j) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p = exp2f(fmaf(sacc[j][2 * rr + e], scale_log2, -l2[rr]));
          if (!full && !visible(qw + g + 8 * rr, k0 + 8 * j + 2 * t + e, Skv, window)) p = 0.0f;
          sacc[j][2 * rr + e] = p * (dpa[j][2 * rr + e] - dr[rr]) * scale;
        }
      }
    }

    // dQ += dS . K
    mma_acc_cols<D, BK>(dqa, sacc, kst, lane);
    __syncthreads();  // this stage is consumed before the next load overwrites it
  }

  store_rows<D>(dq + head, dqa, q0 + warp * 16, Sq, q_stride, lane);
}

// ------------------------------------- bf16 instance at D = 256, on wgmma

namespace wg = repro_wgmma;

constexpr int kWgD = 256;
constexpr int kWgRows = 64;                     // a block's keys (dkdv) or queries (dq); a tile's
constexpr int kWgThreads = 128;                 // one warpgroup
constexpr int kWgTile = kWgRows * kWgD * 2;     // bytes of a swizzled 64 x 256 bf16 tile
constexpr int kAlign = 1024;                    // the swizzle's period: every tile starts on it
constexpr int kPBytes = kWgRows * kWgRows * 4;  // P^T, 64 x 64 fp32, handed between warpgroups
constexpr int kRowsBytes = 4 * kWgRows * 4;     // two stages of 64 L and 64 D values
// dkdv: K, V, two stages of Q and dO, P^T, the L and D rows; dq: Q, dO, two
// stages of K and V.  (ops.py's WGMMA_SMEM states the same sums.)
constexpr size_t kDkdvSmem = kAlign + 6 * kWgTile + kPBytes + kRowsBytes;  // 215,040 B
constexpr size_t kDqSmem = kAlign + 6 * kWgTile;                           // 197,632 B

__device__ __forceinline__ unsigned char* align_tiles(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + ((kAlign - (a & (kAlign - 1))) & (kAlign - 1));
}

// A warpgroup's 64 x N fp32 accumulator as m64k16 A fragments of bf16 for
// the reduction columns 16 kk .. 16 kk + 15: wgmma's accumulator and A
// layouts are mma.sync's, warp by warp.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// A warpgroup's 64 x N fp32 accumulator (rows row0 + 16 warp + g + 8 rr,
// columns 8 j + 2 t + e) to rows < nrows of a matrix with row stride
// `stride` (its first N columns at dst), as bf16 or, for a head group's
// partial, fp32.
template <int N, class T>
__device__ __forceinline__ void store_acc(T* dst, const float (&acc)[N / 2], int row0, int nrows,
                                          size_t stride, int wt) {
  const int warp = wt >> 5;
  const int g = (wt & 31) >> 2;
  const int t = wt & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = row0 + warp * 16 + g + 8 * rr;
    if (r >= nrows) continue;
    T* out = dst + (size_t)r * stride + 2 * t;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      if constexpr (sizeof(T) == 2) {
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * rr], acc[4 * j + 2 * rr + 1]);
      } else {
        *reinterpret_cast<float2*>(out + 8 * j) =
            make_float2(acc[4 * j + 2 * rr], acc[4 * j + 2 * rr + 1]);
      }
    }
  }
}

// dK and dV of 64 keys of one KV head, over the query heads of one head
// group (all G when `groups` is 1).  Two warpgroups: the first computes S^T
// = K.Q^T, P^T and dV += P^T.dO; the second dP^T = V.dO^T, dS^T and dK +=
// dS^T.Q, taking P^T (fp32) from the first through shared memory.
__global__ void __launch_bounds__(2 * kWgThreads, 1)
flash_attention_bwd_dkdv_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                                      const __nv_bfloat16* __restrict__ k,
                                      const __nv_bfloat16* __restrict__ v,
                                      const __nv_bfloat16* __restrict__ dout,
                                      const float* __restrict__ lse,
                                      const float* __restrict__ drow,
                                      __nv_bfloat16* __restrict__ dk,
                                      __nv_bfloat16* __restrict__ dv, float* __restrict__ part,
                                      int Sq, int Skv, int Hq, int Hkv, int window, int groups,
                                      float scale, float scale_log2) {
  constexpr int D = kWgD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ks = align_tiles(smem_raw);
  unsigned char* vs = ks + kWgTile;
  unsigned char* qs = vs + kWgTile;       // two stages
  unsigned char* dos = qs + 2 * kWgTile;  // two stages
  float4* xs = reinterpret_cast<float4*>(dos + 2 * kWgTile);  // P^T, 8 float4 a thread
  float* ls = reinterpret_cast<float*>(xs + 8 * kWgThreads);  // two stages of 64
  float* dls = ls + 2 * kWgRows;                              // two stages of 64

  const int hk = blockIdx.x / groups;
  const int grp = blockIdx.x - hk * groups;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kWgRows;  // the first key tiles, the longest walks, go first
  const int G = Hq / Hkv;
  const int h_first = hk * G + grp * G / groups;
  const int n_heads = hk * G + (grp + 1) * G / groups - h_first;
  const int offset = Skv - Sq;  // query i sits at position offset + i
  const int tid = threadIdx.x;
  const int role = tid / kWgThreads;  // 0: S^T, P^T, dV; 1: dP^T, dS^T, dK
  const int wt = tid % kWgThreads;
  const int warp = wt >> 5;
  const int g = (wt & 31) >> 2;  // the accumulator rows (keys) g and g + 8 of the warp's 16
  const int t = wt & 3;          // the accumulator columns 8 j + 2 t, 8 j + 2 t + 1
  const size_t kv_stride = (size_t)Hkv * D;
  const size_t q_stride = (size_t)Hq * D;

  // The query tiles holding a row that sees a key of this tile, walked for
  // each head of the group in turn.
  const int k_last = min(k0 + kWgRows, Skv) - 1;
  const int i_lo = max(0, k0 - offset);
  const int i_hi = window > 0 ? min(Sq - 1, k_last + window - 1 - offset) : Sq - 1;
  const int qt_lo = i_lo / kWgRows;
  const int n_qt = i_hi >= i_lo ? i_hi / kWgRows - qt_lo + 1 : 0;
  const int n_it = n_heads * n_qt;

  // Stage `stage` <- the Q and dO tiles, L and D rows of step `it`.
  auto issue = [&](int it, int stage) {
    const int h = h_first + it / n_qt;
    const int q0 = (qt_lo + it % n_qt) * kWgRows;
    const size_t head = ((size_t)b * Sq * Hq + h) * D;
    wg::cp_async_tile<D, kWgRows, 2 * kWgThreads>(qs + stage * kWgTile, q + head, q0, Sq,
                                                   q_stride, tid);
    wg::cp_async_tile<D, kWgRows, 2 * kWgThreads>(dos + stage * kWgTile, dout + head, q0, Sq,
                                                   q_stride, tid);
    if (tid < 2 * kWgRows) {
      const int r = tid & (kWgRows - 1);
      const bool in = q0 + r < Sq;
      const size_t at = ((size_t)b * Hq + h) * Sq + (in ? q0 + r : 0);
      if (tid < kWgRows) {
        cp_async4(ls + stage * kWgRows + r, lse + at, in);
      } else {
        cp_async4(dls + stage * kWgRows + r, drow + at, in);
      }
    }
  };

  wg::cp_async_tile<D, kWgRows, 2 * kWgThreads>(ks, k + ((size_t)b * Skv * Hkv + hk) * D, k0,
                                                 Skv, kv_stride, tid);
  wg::cp_async_tile<D, kWgRows, 2 * kWgThreads>(vs, v + ((size_t)b * Skv * Hkv + hk) * D, k0,
                                                 Skv, kv_stride, tid);
  if (n_it > 0) issue(0, 0);
  cp_async_commit();

  float acc[128];  // dV (role 0) or dK (role 1): the warpgroup's 64 keys x 256
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  const int kw = k0 + warp * 16;  // the warp's first key

  for (int it = 0; it < n_it; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_it) {  // the next tile loads while this one is used
      issue(it + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    wg::fence_proxy_async();
    __syncthreads();
    const int q0 = (qt_lo + it % n_qt) * kWgRows;
    const unsigned char* qst = qs + stage * kWgTile;
    const unsigned char* dost = dos + stage * kWgTile;

    // S^T = K . Q^T (role 0) or dP^T = V . dO^T (role 1), over all D.
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    const unsigned char* at = role == 0 ? ks : vs;
    const unsigned char* bt = role == 0 ? qst : dost;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::wgmma_m64n64k16_ss(s, wg::desc_k<kWgRows>(at, kk), wg::desc_k<kWgRows>(bt, kk), 1);
    wg::commit();
    wg::wait<0>();
    wg::keep(s);

    uint32_t a[4][4];
    if (role == 0) {
      // P^T in the log2 domain; the masks only where the warp's keys and the
      // tile's queries are not all visible to each other.
      const int qpos0 = offset + q0;
      const bool full = q0 + kWgRows <= Sq && kw + 16 <= Skv && kw + 15 <= qpos0 &&
                        (window <= 0 || kw > qpos0 + kWgRows - 1 - window);
      const float* lst = ls + stage * kWgRows;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t + e;
          const float l2 = lst[c] * kLog2e;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            float p = exp2f(fmaf(s[4 * j + 2 * rr + e], scale_log2, -l2));
            if (!full && !(q0 + c < Sq && visible(qpos0 + c, kw + g + 8 * rr, Skv, window)))
              p = 0.0f;
            s[4 * j + 2 * rr + e] = p;
          }
        }
        xs[j * kWgThreads + wt] = make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
      }
      wg::bar_arrive(1, 2 * kWgThreads);  // P^T is in shared memory
    } else {
      // dS^T = P^T o (dP^T - D) scale, P^T in fp32 from the first warpgroup.
      wg::bar_sync(1, 2 * kWgThreads);
      const float* dlst = dls + stage * kWgRows;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 p = xs[j * kWgThreads + wt];
        const float d0 = dlst[8 * j + 2 * t];
        const float d1 = dlst[8 * j + 2 * t + 1];
        s[4 * j + 0] = p.x * (s[4 * j + 0] - d0) * scale;
        s[4 * j + 1] = p.y * (s[4 * j + 1] - d1) * scale;
        s[4 * j + 2] = p.z * (s[4 * j + 2] - d0) * scale;
        s[4 * j + 3] = p.w * (s[4 * j + 3] - d1) * scale;
      }
    }
    // dV += P^T . dO (role 0) or dK += dS^T . Q (role 1); the tile's 64
    // queries are the reduction.  dS^T goes in rounded to bf16; P^T as two
    // bf16 terms, its rounding and what that rounding left (P10).
    acc_to_a<64>(a, s);
    uint32_t lo[4][4];
    if (role == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] -= __bfloat162float(__float2bfloat16_rn(s[i]));
      acc_to_a<64>(lo, s);
    }
    const unsigned char* mt = role == 0 ? dost : qst;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kWgRows / 16; ++kk)
      wg::wgmma_m64n256k16_rs(acc, a[kk], wg::desc_mn<kWgRows>(mt, kk), 1);
    if (role == 0) {
#pragma unroll
      for (int kk = 0; kk < kWgRows / 16; ++kk)
        wg::wgmma_m64n256k16_rs(acc, lo[kk], wg::desc_mn<kWgRows>(mt, kk), 1);
    }
    wg::commit();
    wg::wait<0>();
    wg::keep(acc);
    wg::keep(a);
    if (role == 0) wg::keep(lo);
    __syncthreads();  // this stage and P^T are consumed before they are overwritten
  }

  cp_async_wait<0>();  // (K and V were loaded even where no query sees the tile)
  const size_t at = ((size_t)b * Skv * Hkv + hk) * D;
  if (groups == 1) {
    store_acc<kWgD>(role == 0 ? dv + at : dk + at, acc, k0, Skv, kv_stride, wt);
  } else {  // the group's fp32 partial: (2, groups, B, Skv, Hkv, D), dK's first
    const size_t n = (size_t)gridDim.y * Skv * Hkv * D;
    store_acc<kWgD>(part + (size_t)((1 - role) * groups + grp) * n + at, acc, k0, Skv, kv_stride,
                    wt);
  }
}

// dK and dV from the head groups' fp32 partials, added in group order and
// rounded to bf16 once: four elements a thread.
__global__ void __launch_bounds__(256)
flash_attention_bwd_sum_kernel(const float4* __restrict__ part, int groups, size_t n4,
                               __nv_bfloat162* __restrict__ dk, __nv_bfloat162* __restrict__ dv) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * n4) return;
  const int which = i >= n4;  // 0: dK, 1: dV
  const size_t j = i - which * n4;
  const float4* src = part + (size_t)which * groups * n4 + j;
  float4 s = src[0];
  for (int gi = 1; gi < groups; ++gi) {
    const float4 x = src[(size_t)gi * n4];
    s.x += x.x, s.y += x.y, s.z += x.z, s.w += x.w;
  }
  __nv_bfloat162* out = (which ? dv : dk) + 2 * j;
  out[0] = __floats2bfloat162_rn(s.x, s.y);
  out[1] = __floats2bfloat162_rn(s.z, s.w);
}

// dQ of 64 queries of one query head: one warpgroup, Q and dO resident,
// the K and V tiles it sees through a ring of two stages.  Per tile: S =
// Q.K^T and dP = dO.V^T, dS = P o (dP - D) scale, dQ += dS.K.
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_bwd_dq_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                                    const __nv_bfloat16* __restrict__ k,
                                    const __nv_bfloat16* __restrict__ v,
                                    const __nv_bfloat16* __restrict__ dout,
                                    const float* __restrict__ lse, const float* __restrict__ drow,
                                    __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int Hq,
                                    int Hkv, int window, float scale, float scale_log2) {
  constexpr int D = kWgD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* qs = align_tiles(smem_raw);
  unsigned char* dos = qs + kWgTile;
  unsigned char* ks = dos + kWgTile;     // two stages
  unsigned char* vs = ks + 2 * kWgTile;  // two stages

  const int h = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest (last) tiles first
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kWgRows;
  const int offset = Skv - Sq;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;  // the accumulator rows (queries) g and g + 8 of the warp's 16
  const int t = tid & 3;          // the accumulator columns 8 j + 2 t, 8 j + 2 t + 1
  const size_t q_stride = (size_t)Hq * D;
  const size_t kv_stride = (size_t)Hkv * D;
  const size_t head = ((size_t)b * Sq * Hq + h) * D;
  const __nv_bfloat16* kb = k + ((size_t)b * Skv * Hkv + hk) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * Skv * Hkv + hk) * D;

  // Key tiles this query tile can see (at least one).
  const int q_first = offset + q0;
  const int q_last = offset + min(q0 + kWgRows, Sq) - 1;
  const int k_stop = min(Skv, q_last + 1);
  int k_start = 0;
  if (window > 0) {
    const int lo = q_first - window + 1;
    k_start = lo > 0 ? (lo / kWgRows) * kWgRows : 0;
  }
  const int n_tiles = (k_stop - k_start + kWgRows - 1) / kWgRows;

  wg::cp_async_tile<D, kWgRows, kWgThreads>(qs, q + head, q0, Sq, q_stride, tid);
  wg::cp_async_tile<D, kWgRows, kWgThreads>(dos, dout + head, q0, Sq, q_stride, tid);
  wg::cp_async_tile<D, kWgRows, kWgThreads>(ks, kb, k_start, Skv, kv_stride, tid);
  wg::cp_async_tile<D, kWgRows, kWgThreads>(vs, vb, k_start, Skv, kv_stride, tid);
  cp_async_commit();

  // L (log2 domain) and D of the lane's rows g and g + 8.
  float l2[2], dr[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int s = q0 + warp * 16 + g + 8 * rr;
    const size_t at = ((size_t)b * Hq + h) * Sq + s;
    l2[rr] = s < Sq ? lse[at] * kLog2e : 0.0f;
    dr[rr] = s < Sq ? drow[at] : 0.0f;
  }
  const int qw = q_first + warp * 16;  // the warp's first query position
  float acc[128];                      // dQ, the warpgroup's 64 queries x 256
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_start + it * kWgRows;
    const int stage = it & 1;
    if (it + 1 < n_tiles) {
      const int nxt = stage ^ 1;
      wg::cp_async_tile<D, kWgRows, kWgThreads>(ks + nxt * kWgTile, kb, k0 + kWgRows, Skv,
                                                 kv_stride, tid);
      wg::cp_async_tile<D, kWgRows, kWgThreads>(vs + nxt * kWgTile, vb, k0 + kWgRows, Skv,
                                                 kv_stride, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    wg::fence_proxy_async();
    __syncthreads();
    const unsigned char* kst = ks + stage * kWgTile;
    const unsigned char* vst = vs + stage * kWgTile;

    // S = Q . K^T and dP = dO . V^T as two groups: P's exponentials run
    // while the second is on the tensor cores.
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::wgmma_m64n64k16_ss(s, wg::desc_k<kWgRows>(qs, kk), wg::desc_k<kWgRows>(kst, kk), 1);
    wg::commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::wgmma_m64n64k16_ss(dp, wg::desc_k<kWgRows>(dos, kk), wg::desc_k<kWgRows>(vst, kk), 1);
    wg::commit();
    wg::wait<1>();
    wg::keep(s);

    // P in S's place, masks only on a straddling tile; then dS = P o (dP -
    // D) scale.
    const bool full = k0 + kWgRows - 1 <= qw && k0 + kWgRows <= Skv &&
                      (window <= 0 || k0 > qw + 15 - window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * rr + e;
          float p = exp2f(fmaf(s[i], scale_log2, -l2[rr]));
          if (!full && !visible(qw + g + 8 * rr, k0 + 8 * j + 2 * t + e, Skv, window)) p = 0.0f;
          s[i] = p;
        }
      }
    }
    wg::wait<0>();
    wg::keep(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = s[i] * (dp[i] - dr[(i >> 1) & 1]) * scale;

    // dQ += dS . K, dS rounded to bf16; the tile's 64 keys are the reduction.
    uint32_t a[4][4];
    acc_to_a<64>(a, s);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kWgRows / 16; ++kk)
      wg::wgmma_m64n256k16_rs(acc, a[kk], wg::desc_mn<kWgRows>(kst, kk), 1);
    wg::commit();
    wg::wait<0>();
    wg::keep(acc);
    wg::keep(a);
    __syncthreads();  // this stage is consumed before the next load overwrites it
  }

  store_acc<kWgD>(dq + head, acc, q0, Sq, q_stride, tid);
}

// ------------------------------------------ fp32 tensor-core instance (3xTF32)

// Warps sharing a 16-row group (keys in dkdv, queries in dq): 2 at D >=
// 128, each holding half of the gradients' columns (dK and dV together would
// take 128 registers a thread at D = 128, and spill) and the scores' partial
// sums over its half of D (pair_sum adds them), 1 below.
template <int D>
__host__ __device__ constexpr int f32_split() { return D >= 128 ? 2 : 1; }

// Queries per dkdv tile and keys per dq tile: 64 for D <= 32, 32 at D =
// 64 and 128, 16 at 256 (the tiles within 227 KB).  dq's 64-key tiles at
// D = 64 took 1.33 ms where 32 take 1.07 (torch_kernel_probe.py f32-split
// --tiles).
template <int D>
__host__ __device__ constexpr int f32_dkdv_cols() { return D <= 32 ? 64 : D <= 128 ? 32 : 16; }

template <int D>
__host__ __device__ constexpr int f32_dq_cols() { return D <= 32 ? 64 : D <= 128 ? 32 : 16; }

// Floats of the pairs' partial S and dP (S^T and dP^T) over COLS columns:
// 4 pairs x 2 warps x 2 accumulators of COLS / 8 n-tiles x 4 x 32 lanes.
template <int D, int COLS>
constexpr size_t f32_xch_floats() {
  return f32_split<D>() > 1 ? (size_t)4 * 2 * 2 * (COLS / 8) * 4 * 32 : 0;
}

// Both kernels hold two 64-row tiles and a ring of two stages of two
// COLS-row tiles; dkdv also stages the L and D rows of its query tiles.
template <int D>
constexpr size_t f32_dkdv_smem_bytes() {
  constexpr int C = f32_dkdv_cols<D>();
  return ((size_t)(2 * kTcRows + 4 * C) * f32_stride<D>() + 4 * C + f32_xch_floats<D, C>()) *
         sizeof(float);
}

template <int D>
constexpr size_t f32_dq_smem_bytes() {
  constexpr int C = f32_dq_cols<D>();
  return ((size_t)(2 * kTcRows + 4 * C) * f32_stride<D>() + f32_xch_floats<D, C>()) *
         sizeof(float);
}

// out (the lane's rows g, g + 8 of row0's 16, columns 2t, 2t + 1 of each of
// N n-tiles from dst) = acc, or += acc when !first, for rows < nrows.
template <int N>
__device__ __forceinline__ void add_rows_f32(float* dst, const float (&acc)[N][4], int row0,
                                             int nrows, size_t stride, bool first, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = row0 + g + 8 * rr;
    if (r >= nrows) continue;
    float* out = dst + (size_t)r * stride + 2 * t;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float2 x = make_float2(acc[j][2 * rr], acc[j][2 * rr + 1]);
      if (!first) {
        const float2 y = *reinterpret_cast<const float2*>(out + 8 * j);
        x = make_float2(y.x + x.x, y.y + x.y);
      }
      *reinterpret_cast<float2*>(out + 8 * j) = x;
    }
  }
}

// dK and dV of 64 keys of one KV head in fp32 at fp32 accuracy: the bf16
// design's walk (K and V resident, the G heads' query tiles through the
// ring) with every product as 3xTF32.
template <int D>
__global__ void __launch_bounds__(kTcThreads * f32_split<D>(), 1)
flash_attention_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                    const float* __restrict__ v, const float* __restrict__ dout,
                                    const float* __restrict__ lse,
                                    const float* __restrict__ drow, float* __restrict__ dk,
                                    float* __restrict__ dv, int Sq, int Skv, int Hq, int Hkv,
                                    int window, float scale, float scale_log2) {
  constexpr int SPLIT = f32_split<D>();
  constexpr int THREADS = kTcThreads * SPLIT;
  constexpr int ST = f32_stride<D>();
  constexpr int BQ = f32_dkdv_cols<D>();
  constexpr int DW = D / SPLIT;  // the warp's share of D
  constexpr int KW = DW / 8;     // k-steps of the warp's (partial) S^T and dP^T
  constexpr int NW = DW / 8;     // n-tiles of the warp's dK and dV columns
  constexpr int NQ = BQ / 8;     // n-tiles of S^T and dP^T
  extern __shared__ __align__(16) float smem_f[];
  float* ks = smem_f;                 // 64 x ST
  float* vs = ks + kTcRows * ST;      // 64 x ST
  float* qs = vs + kTcRows * ST;      // stages x BQ x ST
  float* dos = qs + 2 * BQ * ST;      // stages x BQ x ST
  float* ls = dos + 2 * BQ * ST;      // stages x BQ
  float* dls = ls + 2 * BQ;           // stages x BQ
  float* xs = dls + 2 * BQ;           // 4 pairs x 2 x 2 x NQ x 4 x 32

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kTcRows;  // the first key tiles, the longest walks, go first
  const int G = Hq / Hkv;
  const int offset = Skv - Sq;  // query i sits at position offset + i
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rw = warp & 3;     // the warp's keys: 16 rw .. 16 rw + 15 of the block's
  const int half = warp >> 2;  // its share of D: columns d0 .. d0 + DW - 1
  const int d0 = half * DW;
  const int g = lane >> 2;  // the accumulator rows (keys) g and g + 8 of the warp
  const int t = lane & 3;   // the accumulator columns 2t and 2t + 1 of each n-tile
  const int kw = k0 + rw * 16;  // the warp's first key
  const size_t kv_stride = (size_t)Hkv * D;
  const size_t q_stride = (size_t)Hq * D;

  // The query tiles holding a row that sees a key of this tile: position >=
  // k0 and, with a window, position <= the tile's last key + window - 1;
  // walked for each of the G heads in turn.
  const int k_last = min(k0 + kTcRows, Skv) - 1;
  const int i_lo = max(0, k0 - offset);
  const int i_hi = window > 0 ? min(Sq - 1, k_last + window - 1 - offset) : Sq - 1;
  const int qt_lo = i_lo / BQ;
  const int n_qt = i_hi >= i_lo ? i_hi / BQ - qt_lo + 1 : 0;
  const int n_it = G * n_qt;

  // Stage `stage` <- the Q and dO tiles, L and D rows of step `it` of the walk.
  auto issue = [&](int it, int stage) {
    const int h = hk * G + it / n_qt;
    const int q0 = (qt_lo + it % n_qt) * BQ;
    const size_t head = ((size_t)b * Sq * Hq + h) * D;
    cp_async_rows_f32<D, BQ, THREADS>(qs + stage * BQ * ST, q + head, q0, Sq, q_stride, tid);
    cp_async_rows_f32<D, BQ, THREADS>(dos + stage * BQ * ST, dout + head, q0, Sq, q_stride, tid);
    if (tid < BQ) {
      const bool in = q0 + tid < Sq;
      const size_t at = ((size_t)b * Hq + h) * Sq + (in ? q0 + tid : 0);
      cp_async4(ls + stage * BQ + tid, lse + at, in);
      cp_async4(dls + stage * BQ + tid, drow + at, in);
    }
  };

  cp_async_rows_f32<D, kTcRows, THREADS>(ks, k + ((size_t)b * Skv * Hkv + hk) * D, k0, Skv,
                                         kv_stride, tid);
  cp_async_rows_f32<D, kTcRows, THREADS>(vs, v + ((size_t)b * Skv * Hkv + hk) * D, k0, Skv,
                                         kv_stride, tid);
  if (n_it > 0) issue(0, 0);
  cp_async_commit();

  const float* krow = ks + rw * 16 * ST + d0;
  const float* vrow = vs + rw * 16 * ST + d0;
  float* xpair = xs + rw * (2 * 2 * NQ * 4 * 32);
  const size_t base = ((size_t)b * Skv * Hkv + hk) * D + d0;
  // dK and dV summed over each query head's walk, then added to the output
  // head by head in order: one running sum of G heads' terms left fp32
  // rounding past 2e-5 at recurrentgemma-9b's 16 over 1 (the header).
  float dka[NW][4], dva[NW][4];
  zero_acc(dka);
  zero_acc(dva);

  for (int it = 0; it < n_it; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_it) {  // the next tile loads while this one is used
      issue(it + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = (qt_lo + it % n_qt) * BQ;
    const float* qst = qs + stage * BQ * ST;
    const float* dost = dos + stage * BQ * ST;
    const float* lst = ls + stage * BQ;
    const float* dlst = dls + stage * BQ;

    // S^T = K . Q^T and dP^T = V . dO^T for the warp's 16 keys and the
    // tile's BQ queries (with a split, over the warp's half of D, then
    // summed with its partner's).
    float st[NQ][4], dpt[NQ][4];
    zero_acc(st);
    zero_acc(dpt);
#pragma unroll
    for (int kk = 0; kk < KW; ++kk) {
      const FragA ak = a_tf32<ST>(krow + kk * 8, g, t);
      const FragA av = a_tf32<ST>(vrow + kk * 8, g, t);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        mma_3xtf32(st[n], ak, b_rows_tf32<ST>(qst + n * 8 * ST + d0 + kk * 8, g, t));
        mma_3xtf32(dpt[n], av, b_rows_tf32<ST>(dost + n * 8 * ST + d0 + kk * 8, g, t));
      }
    }
    if constexpr (SPLIT > 1) {
      pair_sum<NQ>(st, xpair, half, rw, lane);
      pair_sum<NQ>(dpt, xpair + 2 * NQ * 4 * 32, half, rw, lane);
    }

    // P^T, in the log2 domain; the masks only where the warp's keys and the
    // tile's queries are not all visible to each other.
    const int qpos0 = offset + q0;
    const bool full = q0 + BQ <= Sq && kw + 16 <= Skv && kw + 15 <= qpos0 &&
                      (window <= 0 || kw > qpos0 + BQ - 1 - window);
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        const float l2 = lst[c] * kLog2e;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float p = exp2f(fmaf(st[j][2 * rr + e], scale_log2, -l2));
          if (!full && !(q0 + c < Sq && visible(qpos0 + c, kw + g + 8 * rr, Skv, window)))
            p = 0.0f;
          st[j][2 * rr + e] = p;
        }
      }
    }

    // dS^T = P^T o (dP^T - D) scale in dP^T's place; then each 8-query
    // n-tile of P^T and of dS^T is an A fragment as it stands (acc_a_tf32's
    // k order), dO's and Q's rows read in that order: dV += P^T . dO, dK +=
    // dS^T . Q.
    FragA xa[NQ];
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dr = dlst[8 * j + 2 * t + e];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          dpt[j][2 * rr + e] = st[j][2 * rr + e] * (dpt[j][2 * rr + e] - dr) * scale;
      }
      xa[j] = acc_a_tf32(st[j]);
    }
    mma_pairs_add<ST>(dva, xa, dost + d0, g, t);
#pragma unroll
    for (int j = 0; j < NQ; ++j) xa[j] = acc_a_tf32(dpt[j]);
    mma_pairs_add<ST>(dka, xa, qst + d0, g, t);

    if (it % n_qt == n_qt - 1) {  // a head's walk is done: add its sums in head order
      add_rows_f32<NW>(dk + base, dka, kw, Skv, kv_stride, it < n_qt, lane);
      add_rows_f32<NW>(dv + base, dva, kw, Skv, kv_stride, it < n_qt, lane);
      zero_acc(dka);
      zero_acc(dva);
    }
    __syncthreads();  // this stage (and the partial sums) is consumed before it is overwritten
  }

  cp_async_wait<0>();  // (K and V were loaded even where no query sees the tile)
  if (n_it == 0) {     // no query sees these keys: their gradients are 0
    add_rows_f32<NW>(dk + base, dka, kw, Skv, kv_stride, true, lane);
    add_rows_f32<NW>(dv + base, dva, kw, Skv, kv_stride, true, lane);
  }
}

// dQ of 64 queries of one query head in fp32 at fp32 accuracy: the bf16
// design's walk over the key tiles (Q and dO resident, K and V through the
// ring) with every product as 3xTF32.
template <int D>
__global__ void __launch_bounds__(kTcThreads * f32_split<D>(), 1)
flash_attention_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, const float* __restrict__ dout,
                                  const float* __restrict__ lse, const float* __restrict__ drow,
                                  float* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv,
                                  int window, float scale, float scale_log2) {
  constexpr int SPLIT = f32_split<D>();
  constexpr int THREADS = kTcThreads * SPLIT;
  constexpr int ST = f32_stride<D>();
  constexpr int BK = f32_dq_cols<D>();
  constexpr int DW = D / SPLIT;  // the warp's share of D
  constexpr int KW = DW / 8;     // k-steps of the warp's (partial) S and dP
  constexpr int NW = DW / 8;     // n-tiles of the warp's dQ columns
  constexpr int NK = BK / 8;     // n-tiles of S and dP
  extern __shared__ __align__(16) float smem_f[];
  float* qs = smem_f;              // 64 x ST
  float* dos = qs + kTcRows * ST;  // 64 x ST
  float* ks = dos + kTcRows * ST;  // stages x BK x ST
  float* vs = ks + 2 * BK * ST;    // stages x BK x ST
  float* xs = vs + 2 * BK * ST;    // 4 pairs x 2 x 2 x NK x 4 x 32

  const int h = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest (last) tiles first
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kTcRows;
  const int offset = Skv - Sq;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rw = warp & 3;     // the warp's queries: 16 rw .. 16 rw + 15 of the block's
  const int half = warp >> 2;  // its share of D: columns d0 .. d0 + DW - 1
  const int d0 = half * DW;
  const int g = lane >> 2;  // the accumulator rows (queries) g and g + 8 of the warp
  const int t = lane & 3;   // the accumulator columns 2t and 2t + 1 of each n-tile
  const size_t q_stride = (size_t)Hq * D;
  const size_t kv_stride = (size_t)Hkv * D;
  const size_t head = ((size_t)b * Sq * Hq + h) * D;
  const float* kb = k + ((size_t)b * Skv * Hkv + hk) * D;
  const float* vb = v + ((size_t)b * Skv * Hkv + hk) * D;

  // Key tiles this query tile can see (at least one: k_start <= q_first < k_stop).
  const int q_first = offset + q0;
  const int q_last = offset + min(q0 + kTcRows, Sq) - 1;
  const int k_stop = min(Skv, q_last + 1);
  int k_start = 0;
  if (window > 0) {
    const int lo = q_first - window + 1;
    k_start = lo > 0 ? (lo / BK) * BK : 0;
  }
  const int n_tiles = (k_stop - k_start + BK - 1) / BK;

  cp_async_rows_f32<D, kTcRows, THREADS>(qs, q + head, q0, Sq, q_stride, tid);
  cp_async_rows_f32<D, kTcRows, THREADS>(dos, dout + head, q0, Sq, q_stride, tid);
  cp_async_rows_f32<D, BK, THREADS>(ks, kb, k_start, Skv, kv_stride, tid);
  cp_async_rows_f32<D, BK, THREADS>(vs, vb, k_start, Skv, kv_stride, tid);
  cp_async_commit();

  // L (log2 domain) and D of the lane's rows g and g + 8.
  float l2[2], dr[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int s = q0 + rw * 16 + g + 8 * rr;
    const size_t at = ((size_t)b * Hq + h) * Sq + s;
    l2[rr] = s < Sq ? lse[at] * kLog2e : 0.0f;
    dr[rr] = s < Sq ? drow[at] : 0.0f;
  }
  const int qw = q_first + rw * 16;  // the warp's first query position
  const float* qrow = qs + rw * 16 * ST + d0;
  const float* dorow = dos + rw * 16 * ST + d0;
  float* xpair = xs + rw * (2 * 2 * NK * 4 * 32);
  float dqa[NW][4];
  zero_acc(dqa);

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_start + it * BK;
    const int stage = it & 1;
    if (it + 1 < n_tiles) {
      const int nxt = stage ^ 1;
      cp_async_rows_f32<D, BK, THREADS>(ks + nxt * BK * ST, kb, k0 + BK, Skv, kv_stride, tid);
      cp_async_rows_f32<D, BK, THREADS>(vs + nxt * BK * ST, vb, k0 + BK, Skv, kv_stride, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kst = ks + stage * BK * ST;
    const float* vst = vs + stage * BK * ST;

    // S = Q . K^T and dP = dO . V^T for the warp's 16 rows and BK keys
    // (with a split, over the warp's half of D, then summed with its
    // partner's).
    float sacc[NK][4], dpa[NK][4];
    zero_acc(sacc);
    zero_acc(dpa);
#pragma unroll
    for (int kk = 0; kk < KW; ++kk) {
      const FragA aq = a_tf32<ST>(qrow + kk * 8, g, t);
      const FragA ado = a_tf32<ST>(dorow + kk * 8, g, t);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        mma_3xtf32(sacc[n], aq, b_rows_tf32<ST>(kst + n * 8 * ST + d0 + kk * 8, g, t));
        mma_3xtf32(dpa[n], ado, b_rows_tf32<ST>(vst + n * 8 * ST + d0 + kk * 8, g, t));
      }
    }
    if constexpr (SPLIT > 1) {
      pair_sum<NK>(sacc, xpair, half, rw, lane);
      pair_sum<NK>(dpa, xpair + 2 * NK * 4 * 32, half, rw, lane);
    }

    // dS = P o (dP - D) scale in S's place; masks only on a straddling tile.
    const bool full = k0 + BK - 1 <= qw && k0 + BK <= Skv &&
                      (window <= 0 || k0 > qw + 15 - window);
#pragma unroll
    for (int j = 0; j < NK; ++j) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p = exp2f(fmaf(sacc[j][2 * rr + e], scale_log2, -l2[rr]));
          if (!full && !visible(qw + g + 8 * rr, k0 + 8 * j + 2 * t + e, Skv, window)) p = 0.0f;
          sacc[j][2 * rr + e] = p * (dpa[j][2 * rr + e] - dr[rr]) * scale;
        }
      }
    }

    // dQ += dS . K over the warp's columns, K's rows read in acc_a_tf32's order.
    FragA sa[NK];
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) sa[kk] = acc_a_tf32(sacc[kk]);
    mma_pairs_add<ST>(dqa, sa, kst + d0, g, t);
    __syncthreads();  // this stage (and the partial sums) is consumed before it is overwritten
  }

  add_rows_f32<NW>(dq + head + d0, dqa, q0 + rw * 16, Sq, q_stride, true, lane);
}

// ------------------------------------------------------------------ launches

template <class T>
cudaError_t launch_dot(const void* o, const void* dout, void* drow, int B, int Sq, int Hq, int D,
                       cudaStream_t s) {
  const int rows = B * Sq * Hq;
  flash_attention_bwd_dot_kernel<T><<<(rows + 7) / 8, 256, 0, s>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<float*>(drow), rows, Sq,
      Hq, D);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const void* lse, void* drow, void* dq, void* dk, void* dv,
                       int B, int Sq, int Skv, int Hq, int Hkv, int window, float scale,
                       cudaStream_t s) {
  using T = float;
  auto kv_kernel = flash_attention_bwd_dkdv_f32_kernel<D>;
  auto q_kernel = flash_attention_bwd_dq_f32_kernel<D>;
  const size_t kv_smem = f32_dkdv_smem_bytes<D>();
  const size_t q_smem = f32_dq_smem_bytes<D>();
  cudaError_t err =
      cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kv_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)q_smem);
  if (err != cudaSuccess) return err;
  auto qp = static_cast<const T*>(q);
  auto kp = static_cast<const T*>(k);
  auto vp = static_cast<const T*>(v);
  auto dop = static_cast<const T*>(dout);
  auto lp = static_cast<const float*>(lse);
  auto drp = static_cast<const float*>(drow);
  err = launch_dot<T>(o, dout, drow, B, Sq, Hq, D, s);
  if (err != cudaSuccess) return err;
  const float scale_log2 = scale * kLog2e;
  constexpr int threads = kTcThreads * f32_split<D>();
  kv_kernel<<<dim3(Hkv, B, (Skv + kTcRows - 1) / kTcRows), threads, kv_smem, s>>>(
      qp, kp, vp, dop, lp, drp, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv, Hq, Hkv,
      window, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  q_kernel<<<dim3(Hq, (Sq + kTcRows - 1) / kTcRows, B), threads, q_smem, s>>>(
      qp, kp, vp, dop, lp, drp, static_cast<T*>(dq), Sq, Skv, Hq, Hkv, window, scale, scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const void* lse, void* drow, void* dq, void* dk,
                        void* dv, int B, int Sq, int Skv, int Hq, int Hkv, int window,
                        float scale, cudaStream_t s) {
  using T = __nv_bfloat16;
  auto kv_kernel = flash_attention_bwd_dkdv_bf16_kernel<D>;
  auto q_kernel = flash_attention_bwd_dq_bf16_kernel<D>;
  const size_t kv_smem = dkdv_smem_bytes<D>();
  const size_t q_smem = tc_tiles_bytes<D>();
  cudaError_t err =
      cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kv_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)q_smem);
  if (err != cudaSuccess) return err;
  auto qp = static_cast<const T*>(q);
  auto kp = static_cast<const T*>(k);
  auto vp = static_cast<const T*>(v);
  auto dop = static_cast<const T*>(dout);
  auto lp = static_cast<const float*>(lse);
  auto drp = static_cast<const float*>(drow);
  err = launch_dot<T>(o, dout, drow, B, Sq, Hq, D, s);
  if (err != cudaSuccess) return err;
  const float scale_log2 = scale * kLog2e;
  kv_kernel<<<dim3(Hkv, B, (Skv + kTcRows - 1) / kTcRows), kTcThreads, kv_smem, s>>>(
      qp, kp, vp, dop, lp, drp, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv, Hq, Hkv,
      window, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  q_kernel<<<dim3(Hq, (Sq + kTcRows - 1) / kTcRows, B), kTcThreads, q_smem, s>>>(
      qp, kp, vp, dop, lp, drp, static_cast<T*>(dq), Sq, Skv, Hq, Hkv, window, scale, scale_log2);
  return cudaGetLastError();
}

// The bf16 instance at D = 256: the two warpgroup kernels and, with head
// groups, the sum of their partials.
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const void* lse, void* drow, void* dq, void* dk,
                         void* dv, void* part, int B, int Sq, int Skv, int Hq, int Hkv,
                         int window, int groups, float scale, cudaStream_t s) {
  using T = __nv_bfloat16;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_bwd_dkdv_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kDkdvSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_attention_bwd_dq_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDqSmem);
  if (err != cudaSuccess) return err;
  auto qp = static_cast<const T*>(q);
  auto kp = static_cast<const T*>(k);
  auto vp = static_cast<const T*>(v);
  auto dop = static_cast<const T*>(dout);
  auto lp = static_cast<const float*>(lse);
  auto drp = static_cast<const float*>(drow);
  err = launch_dot<T>(o, dout, drow, B, Sq, Hq, kWgD, s);
  if (err != cudaSuccess) return err;
  const float scale_log2 = scale * kLog2e;
  flash_attention_bwd_dkdv_wgmma_kernel<<<dim3(Hkv * groups, B, (Skv + kWgRows - 1) / kWgRows),
                                          2 * kWgThreads, kDkdvSmem, s>>>(
      qp, kp, vp, dop, lp, drp, static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<float*>(part), Sq, Skv, Hq, Hkv, window, groups, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (groups > 1) {
    const size_t n4 = (size_t)B * Skv * Hkv * kWgD / 4;
    flash_attention_bwd_sum_kernel<<<(unsigned)((2 * n4 + 255) / 256), 256, 0, s>>>(
        static_cast<const float4*>(part), groups, n4, static_cast<__nv_bfloat162*>(dk),
        static_cast<__nv_bfloat162*>(dv));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  flash_attention_bwd_dq_wgmma_kernel<<<dim3(Hq, (Sq + kWgRows - 1) / kWgRows, B), kWgThreads,
                                        kDqSmem, s>>>(
      qp, kp, vp, dop, lp, drp, static_cast<T*>(dq), Sq, Skv, Hq, Hkv, window, scale, scale_log2);
  return cudaGetLastError();
}

#define REPRO_FLASH_BWD_DISPATCH(LAUNCH)                                                    \
  switch (D) {                                                                              \
    case 16: return LAUNCH<16>(q, k, v, o, dout, lse, drow, dq, dk, dv, B, Sq, Skv, Hq, Hkv,  \
                               window, scale, s);                                           \
    case 32: return LAUNCH<32>(q, k, v, o, dout, lse, drow, dq, dk, dv, B, Sq, Skv, Hq, Hkv,  \
                               window, scale, s);                                           \
    case 64: return LAUNCH<64>(q, k, v, o, dout, lse, drow, dq, dk, dv, B, Sq, Skv, Hq, Hkv,  \
                               window, scale, s);                                           \
    case 128: return LAUNCH<128>(q, k, v, o, dout, lse, drow, dq, dk, dv, B, Sq, Skv, Hq,     \
                                 Hkv, window, scale, s);                                    \
    case 256: return LAUNCH<256>(q, k, v, o, dout, lse, drow, dq, dk, dv, B, Sq, Skv, Hq,     \
                                 Hkv, window, scale, s);                                    \
    default: return cudaErrorInvalidValue;                                                  \
  }

}  // namespace

extern "C" {

// dtype: 0 = fp32 (3xTF32 on the tensor cores), 1 = bf16 (tensor cores);
// anything else is refused.  q, k, v and dout must be 16-byte aligned.  lse from
// flash_attention_fwd; drow is float32 (B, Hq, Sq) scratch for D.  groups:
// the head groups a KV head's G query heads are spread over, 1 <= groups
// <= G, and more than 1 only for bf16 at D = 256, where `part` is float32
// (2, groups, B, Skv, Hkv, D) scratch for their partial dK and dV (else
// null).  Returns the first failing launch's cudaError_t, or 0.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const void* lse, void* drow, void* dq, void* dk,
                        void* dv, void* part, int dtype, int B, int Sq, int Skv, int Hq, int Hkv,
                        int D, int window, int groups, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Sq > Skv || Hkv <= 0 || Hq % Hkv != 0 || window < 0 ||
      groups < 1 || groups > Hq / Hkv || B > 65535)
    return cudaErrorInvalidValue;
  const bool wgmma = dtype == 1 && D == kWgD;
  if (groups > 1 && (!wgmma || part == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout);
  if ((dtype == 0 || dtype == 1) && (bases & 15)) return cudaErrorMisalignedAddress;
  if (dtype == 0) {
    REPRO_FLASH_BWD_DISPATCH(launch_f32)
  }
  if (dtype == 1) {
    switch (D) {
      case 16: return launch_bf16<16>(q, k, v, o, dout, lse, drow, dq, dk, dv, B, Sq, Skv, Hq,
                                      Hkv, window, scale, s);
      case 32: return launch_bf16<32>(q, k, v, o, dout, lse, drow, dq, dk, dv, B, Sq, Skv, Hq,
                                      Hkv, window, scale, s);
      case 64: return launch_bf16<64>(q, k, v, o, dout, lse, drow, dq, dk, dv, B, Sq, Skv, Hq,
                                      Hkv, window, scale, s);
      case 128: return launch_bf16<128>(q, k, v, o, dout, lse, drow, dq, dk, dv, B, Sq, Skv, Hq,
                                        Hkv, window, scale, s);
      case kWgD: return launch_wgmma(q, k, v, o, dout, lse, drow, dq, dk, dv, part, B, Sq, Skv,
                                     Hq, Hkv, window, groups, scale, s);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
