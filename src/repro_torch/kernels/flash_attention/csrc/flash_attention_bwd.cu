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
// Three kernels on one stream, all named `flash_attention_bwd_*`:
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
// deterministic, bit for bit from call to call.  Head dims 16, 32, 64 and
// 128; 256 waits for its own design (ROADMAP, queue 2, entry 7).
//
// Two instances, picked by dtype (no fallback from one to the other):
//
// * bf16, on the tensor cores (`*_bf16_kernel`), the design of K3's
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
//     registers within the 255 a thread has without a spill).  K and V tiles (64 keys, 32
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
// * fp32, on the CUDA cores (`*_kernel<D, float>`), in IEEE fp32: one block
//   of 256 threads per 64-key or 64-query tile, everything staged in shared
//   memory as fp32, 4 x 4 register tiles per thread, p and dS staged in
//   shared memory between the products.  The models' f32 paths and the f32
//   tests take it, as K3's fp32 instance stays on the CUDA cores.
//
// Measured by chip_smoke.py phase 16 (a) (NVIDIA H100 80GB HBM3, 700.00
// W; PERF.md): the bf16 instance 0.807 ms at tinyllama's shape (dkdv 0.425,
// dq 0.319, dot 0.063), 9.3 times the bound and 1.8 times SDPA's backward
// (0.447 ms), where its first design (fp32 on the CUDA cores, as the fp32
// instance, which takes 7.18 ms) took 7.09 ms; 0.559 ms at llama4's shape
// (40 over 8, D = 128, B = 2) and 0.688 ms with a 1024 window (B = 2, S =
// 2048).  What holds it back, by count: seven mma.sync products where the
// bound counts five, at mma.sync's rate where the bound assumes wgmma's,
// with 72 ldmatrix.x4 per 128 MMAs a warp in dkdv.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using namespace repro_mma;

constexpr int kB = 64;         // query rows, and keys, per tile
constexpr int kThreads = 256;  // 16 x 16: a thread owns rows ty + 16 i, columns tx + 16 j
constexpr int kPS = kB + 1;    // row stride of the p / dS tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <class T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

template <int D>
constexpr size_t smem_bytes() {
  return (4 * (size_t)kB * (D + 1) + (size_t)kB * kPS + 2 * kB) * sizeof(float);
}

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

// Rows row0 .. row0 + 63 of a (rows, D) matrix whose rows are `stride`
// elements apart, widened to float32 into a (64, D + 1) shared tile; rows
// >= nrows are zero.
template <int D, class T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int row0, int nrows,
                                          size_t stride, int tid) {
  for (int i = tid; i < kB * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    const int s = row0 + r;
    dst[r * (D + 1) + c] = s < nrows ? to_f(src[(size_t)s * stride + c]) : 0.0f;
  }
}

// s[i][j] = a[ty + 16 i] . bt[tx + 16 j] over D, both (64, D + 1) tiles.
template <int D>
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* a, const float* bt,
                                         int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 16
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = bt[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] += av[i] * bv[j];
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int Skv, int window) {
  return kpos < Skv && kpos <= qpos && (window <= 0 || kpos > qpos - window);
}

// dK and dV of one 64-key tile of one KV head: K and V stay resident while
// the block walks the G query heads and the query tiles that see the tile.
template <int D, class T>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, const T* __restrict__ dout,
                                const float* __restrict__ lse, const float* __restrict__ drow,
                                T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv, int Hq,
                                int Hkv, int window, float scale) {
  constexpr int RS = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kB * RS;
  float* qs = vs + kB * RS;
  float* dos = qs + kB * RS;
  float* ps = dos + kB * RS;  // p, then dS: (64 queries, 64 keys)
  float* ls = ps + kB * kPS;
  float* dls = ls + kB;

  const int k0 = blockIdx.x * kB;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const int offset = Skv - Sq;  // query i sits at position offset + i
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const size_t kv_stride = (size_t)Hkv * D;
  const size_t q_stride = (size_t)Hq * D;

  load_rows<D>(ks, k + ((size_t)b * Skv * Hkv + hk) * D, k0, Skv, kv_stride, tid);
  load_rows<D>(vs, v + ((size_t)b * Skv * Hkv + hk) * D, k0, Skv, kv_stride, tid);

  float dka[4][DJ], dva[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dka[i][j] = dva[i][j] = 0.0f;

  // The query rows that see a key of this tile: position >= k0 and, with a
  // window, position <= the tile's last key + window - 1.
  const int k_last = min(k0 + kB, Skv) - 1;
  const int i_lo = max(0, k0 - offset);
  const int i_hi = window > 0 ? min(Sq - 1, k_last + window - 1 - offset) : Sq - 1;
  const int qt_lo = i_lo / kB;
  const int qt_hi = i_hi >= i_lo ? i_hi / kB : qt_lo - 1;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const T* qb = q + ((size_t)b * Sq * Hq + h) * D;
    const T* db = dout + ((size_t)b * Sq * Hq + h) * D;
    const float* lb = lse + ((size_t)b * Hq + h) * Sq;
    const float* drb = drow + ((size_t)b * Hq + h) * Sq;
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q0 = qt * kB;
      __syncthreads();  // the previous query tile is consumed
      load_rows<D>(qs, qb, q0, Sq, q_stride, tid);
      load_rows<D>(dos, db, q0, Sq, q_stride, tid);
      for (int r = tid; r < kB; r += kThreads) {
        const bool in = q0 + r < Sq;
        ls[r] = in ? lb[q0 + r] : 0.0f;
        dls[r] = in ? drb[q0 + r] : 0.0f;
      }
      __syncthreads();

      float p[4][4], dp[4][4];
      tile_dot<D>(p, qs, ks, tx, ty);
      tile_dot<D>(dp, dos, vs, tx, ty);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const int qpos = offset + q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const bool ok = q0 + r < Sq && visible(qpos, k0 + c, Skv, window);
          p[i][j] = ok ? expf(p[i][j] * scale - ls[r]) : 0.0f;
          ps[r * kPS + c] = p[i][j];
        }
      }
      __syncthreads();
      // dV[c][d] += sum_r p[r][c] dO[r][d]
#pragma unroll 4
      for (int r = 0; r < kB; ++r) {
        float pr[4], dov[DJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) pr[i] = ps[r * kPS + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < DJ; ++j) dov[j] = dos[r * RS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) dva[i][j] += pr[i] * dov[j];
      }
      __syncthreads();  // p is read; dS takes its place
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) ps[r * kPS + tx + 16 * j] = p[i][j] * (dp[i][j] - dls[r]) * scale;
      }
      __syncthreads();
      // dK[c][d] += sum_r dS[r][c] q[r][d]
#pragma unroll 4
      for (int r = 0; r < kB; ++r) {
        float sr[4], qv[DJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) sr[i] = ps[r * kPS + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < DJ; ++j) qv[j] = qs[r * RS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) dka[i][j] += sr[i] * qv[j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= Skv) continue;
    const size_t base = ((size_t)(b * Skv + kpos) * Hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[base + tx + 16 * j] = from_f<T>(dka[i][j]);
      dv[base + tx + 16 * j] = from_f<T>(dva[i][j]);
    }
  }
}

// dQ of one 64-row query tile of one query head: the forward's walk over
// the key tiles it sees.
template <int D, class T>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ drow,
                              T* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv, int window,
                              float scale) {
  constexpr int RS = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kB * RS;
  float* ks = dos + kB * RS;
  float* vs = ks + kB * RS;
  float* ps = vs + kB * RS;  // dS: (64 queries, 64 keys)
  float* ls = ps + kB * kPS;
  float* dls = ls + kB;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest (last) tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kB;
  const int offset = Skv - Sq;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const size_t kv_stride = (size_t)Hkv * D;
  const size_t q_stride = (size_t)Hq * D;

  load_rows<D>(qs, q + ((size_t)b * Sq * Hq + h) * D, q0, Sq, q_stride, tid);
  load_rows<D>(dos, dout + ((size_t)b * Sq * Hq + h) * D, q0, Sq, q_stride, tid);
  for (int r = tid; r < kB; r += kThreads) {
    const bool in = q0 + r < Sq;
    ls[r] = in ? lse[((size_t)b * Hq + h) * Sq + q0 + r] : 0.0f;
    dls[r] = in ? drow[((size_t)b * Hq + h) * Sq + q0 + r] : 0.0f;
  }

  float dqa[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dqa[i][j] = 0.0f;

  const int q_first = offset + q0;
  const int q_last = offset + min(q0 + kB, Sq) - 1;
  const int k_stop = min(Skv, q_last + 1);
  int k_start = 0;
  if (window > 0) {
    const int lo = q_first - window + 1;
    k_start = lo > 0 ? (lo / kB) * kB : 0;
  }
  const T* kb = k + ((size_t)b * Skv * Hkv + hk) * D;
  const T* vb = v + ((size_t)b * Skv * Hkv + hk) * D;

  for (int k0 = k_start; k0 < k_stop; k0 += kB) {
    __syncthreads();  // the previous key tile is consumed (and q, dO are staged)
    load_rows<D>(ks, kb, k0, Skv, kv_stride, tid);
    load_rows<D>(vs, vb, k0, Skv, kv_stride, tid);
    __syncthreads();
    float p[4][4], dp[4][4];
    tile_dot<D>(p, qs, ks, tx, ty);
    tile_dot<D>(dp, dos, vs, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q_first + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = q0 + r < Sq && visible(qpos, k0 + c, Skv, window);
        const float pv = ok ? expf(p[i][j] * scale - ls[r]) : 0.0f;
        ps[r * kPS + c] = pv * (dp[i][j] - dls[r]) * scale;
      }
    }
    __syncthreads();
    // dQ[r][d] += sum_c dS[r][c] k[c][d]
#pragma unroll 4
    for (int c = 0; c < kB; ++c) {
      float sr[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) sr[i] = ps[(ty + 16 * i) * kPS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = ks[c * RS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) dqa[i][j] += sr[i] * kv[j];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= Sq) continue;
    T* out = dq + ((size_t)(b * Sq + s) * Hq + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) out[tx + 16 * j] = from_f<T>(dqa[i][j]);
  }
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
constexpr size_t dkdv_smem_bytes() { return tc_tiles_bytes<D>() + 4 * tc_cols<D>() * sizeof(float); }

template <int N>
__device__ __forceinline__ void zero_acc(float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
}

// acc (n-tiles over the tile's rows r) += A . rows^T, the A fragments read
// by ldmatrix at `arow` (16 rows, D wide) or taken from `af`, B from the
// shared tile `rows` (NR rows, D wide).
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
// row0 .. row0 + 15 (those < nrows) of a (rows, D) matrix with row stride
// `stride`; the lane writes columns 2t, 2t + 1 of every n-tile.
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
    cp_async_rows<D, BQ, kTcThreads>(qs + stage * BQ * ST, q + head, q0, Sq, q_stride, tid);
    cp_async_rows<D, BQ, kTcThreads>(dos + stage * BQ * ST, dout + head, q0, Sq, q_stride, tid);
    if (tid < BQ) {
      const bool in = q0 + tid < Sq;
      const size_t at = ((size_t)b * Hq + h) * Sq + (in ? q0 + tid : 0);
      cp_async4(ls + stage * BQ + tid, lse + at, in);
      cp_async4(dls + stage * BQ + tid, drow + at, in);
    }
  };

  cp_async_rows<D, kTcRows, kTcThreads>(ks, k + ((size_t)b * Skv * Hkv + hk) * D, k0, Skv,
                                        kv_stride, tid);
  cp_async_rows<D, kTcRows, kTcThreads>(vs, v + ((size_t)b * Skv * Hkv + hk) * D, k0, Skv,
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
    float st[NQ][4];
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
    float dpt[NQ][4];
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
  const size_t smem = smem_bytes<D>();
  auto kv_kernel = flash_attention_bwd_dkdv_kernel<D, T>;
  auto q_kernel = flash_attention_bwd_dq_kernel<D, T>;
  cudaError_t err =
      cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  auto qp = static_cast<const T*>(q);
  auto kp = static_cast<const T*>(k);
  auto vp = static_cast<const T*>(v);
  auto dop = static_cast<const T*>(dout);
  auto lp = static_cast<const float*>(lse);
  auto drp = static_cast<float*>(drow);
  err = launch_dot<T>(o, dout, drow, B, Sq, Hq, D, s);
  if (err != cudaSuccess) return err;
  kv_kernel<<<dim3((Skv + kB - 1) / kB, Hkv, B), kThreads, smem, s>>>(
      qp, kp, vp, dop, lp, drp, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv, Hq, Hkv,
      window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  q_kernel<<<dim3((Sq + kB - 1) / kB, Hq, B), kThreads, smem, s>>>(
      qp, kp, vp, dop, lp, drp, static_cast<T*>(dq), Sq, Skv, Hq, Hkv, window, scale);
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
    default: return cudaErrorInvalidValue;                                                  \
  }

}  // namespace

extern "C" {

// dtype: 0 = fp32 (CUDA cores), 1 = bf16 (tensor cores; q, k, v and dout
// 16-byte aligned); anything else is refused.  lse from
// flash_attention_fwd; drow is float32 (B, Hq, Sq) scratch for D.  Returns
// the first failing launch's cudaError_t, or 0.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const void* lse, void* drow, void* dq, void* dk,
                        void* dv, int dtype, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                        int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Sq > Skv || Hkv <= 0 || Hq % Hkv != 0 || window < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    REPRO_FLASH_BWD_DISPATCH(launch_f32)
  }
  if (dtype == 1) {
    const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                            reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout);
    if (bases & 15) return cudaErrorMisalignedAddress;
    REPRO_FLASH_BWD_DISPATCH(launch_bf16)
  }
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
