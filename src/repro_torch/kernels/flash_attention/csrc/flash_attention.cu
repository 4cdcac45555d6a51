// GQA prefill attention (flash attention, forward) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention/kernel.py:89, its pallas_call at
// :123): for every query row i, sitting at absolute position Skv - Sq + i,
// the softmax over the keys at positions <= its own (and, with a window
// w > 0, > position - w) of q.k * scale, applied to v.  Not causal
// (`causal` = 0 in the C entry, kernel.py:65-68), a row sees every key,
// later ones too, and only the window masks; the key-tile walk then ends
// at the last key tile instead of the diagonal's, and a tile's mask drops
// the diagonal compare.  Both cases are a template argument of each
// instance, so the causal instances' code is that of the causal-only
// design.  It reads the model
// layout directly: q and o (B, Sq, Hq, D), k and v (B, Skv, Hkv, D); query
// head h reads KV head h / G (G = Hq / Hkv) without copying K/V.  Scores,
// the running max m, the running sum l and the output accumulator are
// fp32.  Masked scores take _NEG = -0.7 * FLT_MAX, not -inf, and a row with
// nothing valid keeps l clamped to 1e-30, as kernel.py:28 and :80 do.
// KV tiles wholly above the diagonal (causal) or left of the window are
// skipped (kernel.py:46-50); the ragged last tile is masked in the kernel rather
// than padded in memory (kernel.py:105-113).
//
// What bounds it on the H100: operations.  Causal attention does
// 2 * B * Hq * Sq * Skv * D flops (half of the full square, QK^T and PV
// each); at the serving shape (B = 8, S = 1024, Hq = 32, Hkv = 4, D = 64,
// bf16) that is 34.4 GFLOP, 0.0347 ms at the bf16 tensor-core peak of
// 989 TFLOP/s, while reading q, k, v and writing o is 75 MB, 0.022 ms at
// 3.35 TB/s.  So the work has to go through the tensor cores.
//
// Two instances, picked by dtype in `flash_attention_fwd` (no fallback from
// one to the other):
//
// * bf16, on the tensor cores (`flash_attention_bf16_kernel`):
//   - one block of 4 warps per (64-row query tile, query head, batch row),
//     16 query rows per warp.  The grid's x axis is the query head, so the
//     G heads that share a KV head are neighbours in launch order and find
//     its K/V tiles in L2 (all of K and V is 8 MB at the serving shape,
//     against a 50 MB L2), rather than one block walking the G heads, which
//     would hold G output accumulators in registers or issue G times fewer
//     blocks.  Query tiles are issued last-first, so the longest causal
//     rows start first;
//   - Q is loaded once (cp.async) into a shared tile that stays resident.
//     For D <= 128 it is read once more (ldmatrix) into registers, where it
//     stays as the A fragments of mma.sync.m16n8k16 (bf16 in, fp32
//     accumulate).  At D = 256 those fragments would take 64 registers
//     beside the output accumulator's 128, so each k-step re-reads its
//     A fragment from the shared tile with ldmatrix instead;
//   - K and V tiles of BK keys go through a ring of two shared-memory
//     stages filled by cp.async (16-byte copies, zero-filled past Skv), so
//     the next tile's load overlaps this tile's products; rows are padded
//     by 16 bytes, so the eight rows an ldmatrix reads fall in eight
//     distinct bank groups.  BK is 64 for D <= 128; at D = 256 it is 32,
//     which keeps the score accumulator at 16 registers and shared memory
//     at 101,376 B, so two blocks (8 warps) share an SM;
//   - S = Q.K^T with ldmatrix on K; the online softmax stays in registers:
//     the row max is reduced over the quad of lanes that share a row of the
//     m16n8 accumulator, the row sum is kept per lane and reduced once at
//     the end; exponentials are exp2 of scores pre-scaled by log2(e);
//   - p is rounded to bf16 as it is packed from the S accumulator into P's
//     A fragment (the C layout of m16n8k16 is the A layout of the next
//     product), which is the reference's own rounding of p before P.V
//     (kernel.py:73); l sums the unrounded p.  O += P.V with ldmatrix.trans
//     on V.
// * fp32 at fp32 accuracy, on the tensor cores (`flash_attention_f32_kernel`),
//   the bf16 design's blocks, walk, ring and softmax with TF32 operands:
//   - every product (S = Q.K^T, O += P.V) runs as three TF32 products of
//     mma.sync.m16n8k8 (fp32 accumulate): each operand is split into hi =
//     tf32(x) and lo = tf32(x - hi) (round to nearest, ties away: cvt.rna's
//     rounding, by integer ops) as its fragment is loaded, and
//     lo.hi, hi.lo, then hi.hi are accumulated (mma.cuh), which keeps
//     fp32's accuracy where one TF32 product keeps three digits.  The
//     softmax, the masks, exp2 and the logsumexp stay IEEE fp32 on the CUDA
//     cores, and p is not rounded: the reference keeps it in fp32;
//   - TF32 has no ldmatrix, so fragments come from 32-bit shared loads;
//     every tile's rows are D + 4 floats, which puts a warp's loads on 32
//     banks whether it reads a tile along its rows (Q, K) or across them
//     (V);
//   - the S accumulator is P's A fragment as it stands: m16n8k8's C layout
//     gives a lane columns 2t and 2t + 1 where A wants t and t + 4, so the
//     product's 8 keys are taken in that lane's order (k = t is key 2t, k =
//     t + 4 key 2t + 1) and V's rows are read in the same order; no value
//     moves between lanes.  Each tile's P.V is summed in fresh accumulators
//     and added to O by fp32 adds (mma.cuh's mma_pairs_add);
//   - 64-key tiles for D <= 64, where Q's split fragments stay in registers
//     (64 at D = 64); 32-key tiles above, Q's fragments re-read from its
//     shared tile.  At D = 256 a 16-row group takes two warps, each holding
//     half of O's columns (64 registers, where all 256 would take 128) and
//     computing S over its half of D; the pair sums its two partial S
//     through shared memory (both warps get the same bits: fp32 addition
//     commutes) and runs the softmax on the whole.  216,064 B of shared
//     memory at D = 256, one block of 8 warps an SM; 101,376 B at D = 128
//     and 87,040 B at D = 64, two blocks an SM.
//   The bound counts each product three times at the TF32 tensor-core peak
//   (495 TFLOP/s), or once at fp32's 67 TFLOP/s if that is shorter: at
//   tinyllama's shape 103 GFLOP of TF32 products, 0.208 ms.  Measured
//   (benchmarks/torch_kernel_probe.py k3 --old, NVIDIA H100 80GB HBM3,
//   700.00 W; PERF.md): 0.765 ms there, against 1.575 for its first design
//   (fp32 on the CUDA cores) and 5.30 for SDPA in f32; not causal 1.44;
//   gemma-7b's D = 256 (B = 8) 1.65, SDPA f32 1.92.  What holds it: the two
//   extra TF32 passes take about half of it and the splits a fifth
//   (torch_kernel_probe.py f32-split): mma.sync's TF32 rate, not bytes.
//   The models' f32 paths and the f32 tests take it.
//
// The bf16 instance, measured by chip_smoke.py at the serving shape under
// torch.profiler (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md): 0.217-0.218 ms, 6.3 times
// the bound, against 0.109-0.112 ms for PyTorch's SDPA and 1.580-1.587 ms
// for the earlier design of this file (bf16 staged as fp32, scalar FMAs on
// the CUDA cores) in the same call.  What holds it back is issue and
// latency, not bytes: the softmax's exp2, scale, compare and max per score
// run on the CUDA cores between the two products, and mma.sync issues at
// well under wgmma's rate; 128-row tiles and 128-key tiles were no faster.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using namespace repro_mma;

constexpr float kNeg = -0.7f * 3.4028234663852886e38f;  // _NEG of kernel.py:28
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------- bf16 tensor-core instance

constexpr int kTcBQ = 64;                     // query rows per block, 16 per warp
constexpr int kTcThreads = 128;               // 4 warps
constexpr int kTcStages = 2;                  // K/V ring depth

// Keys per K/V tile: 64, or 32 at D = 256 (see the header).
template <int D>
__host__ __device__ constexpr int tc_keys() { return D <= 128 ? 64 : 32; }

template <int D>
constexpr size_t tc_smem_bytes() {
  return (size_t)(kTcBQ + 2 * kTcStages * tc_keys<D>()) * row_stride<D>() * sizeof(__nv_bfloat16);
}

template <int D, bool Causal>
__global__ void __launch_bounds__(kTcThreads)
flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                            float* __restrict__ lse, int Sq, int Skv, int Hq, int Hkv,
                            int window, float scale_log2) {
  constexpr int ST = row_stride<D>();
  constexpr int BK = tc_keys<D>();
  constexpr bool kQInRegs = D <= 128;  // Q's A fragments held in registers
  constexpr int KD = D / 16;      // k-steps of Q.K^T
  constexpr int ND = D / 8;       // n-tiles of the output
  constexpr int NK = BK / 8;      // n-tiles of the scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // kTcBQ x ST
  __nv_bfloat16* ks = qs + kTcBQ * ST;                            // stages x BK x ST
  __nv_bfloat16* vs = ks + kTcStages * BK * ST;                   // stages x BK x ST

  const int h = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest (last) tiles first
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kTcBQ;
  const int offset = Skv - Sq;  // query i sits at position offset + i
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // the accumulator rows g and g + 8 of the warp
  const int t = lane & 3;   // the accumulator columns 2t and 2t + 1 of each n-tile

  const size_t q_stride = (size_t)Hq * D;
  const size_t kv_stride = (size_t)Hkv * D;
  const __nv_bfloat16* qb = q + ((size_t)b * Sq * Hq + h) * D;
  const __nv_bfloat16* kb = k + ((size_t)b * Skv * Hkv + hk) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * Skv * Hkv + hk) * D;

  // KV tiles this query tile can see (at least one: k_start <= q_first < k_stop).
  const int q_first = offset + q0;
  const int q_last = offset + min(q0 + kTcBQ, Sq) - 1;
  const int k_stop = Causal ? min(Skv, q_last + 1) : Skv;
  int k_start = 0;
  if (window > 0) {
    const int lo = q_first - window + 1;
    k_start = lo > 0 ? (lo / BK) * BK : 0;
  }
  const int n_tiles = (k_stop - k_start + BK - 1) / BK;

  cp_async_rows<D, kTcBQ, kTcThreads>(qs, qb, q0, Sq, q_stride, tid);
  cp_async_rows<D, BK, kTcThreads>(ks, kb, k_start, Skv, kv_stride, tid);
  cp_async_rows<D, BK, kTcThreads>(vs, vb, k_start, Skv, kv_stride, tid);
  cp_async_commit();

  // The warp's 16 rows of Q, as ldmatrix reads them for k-step kk.
  const __nv_bfloat16* qrow =
      qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ST + (lane >> 4) * 8;
  uint32_t qf[kQInRegs ? KD : 1][4];
  float oacc[ND][4];
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.0f, 0.0f};  // this lane's share of the row sums
#pragma unroll
  for (int j = 0; j < ND; ++j) oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_start + it * BK;
    const int stage = it & 1;
    if (it + 1 < n_tiles) {  // the next tile loads while this one is used
      const int nxt = (it + 1) & 1;
      cp_async_rows<D, BK, kTcThreads>(ks + nxt * BK * ST, kb, k0 + BK, Skv, kv_stride, tid);
      cp_async_rows<D, BK, kTcThreads>(vs + nxt * BK * ST, vb, k0 + BK, Skv, kv_stride, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kQInRegs) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) ldmatrix_x4(qf[kk], qrow + kk * 16);
      }
    }
    const __nv_bfloat16* kst = ks + stage * BK * ST;
    const __nv_bfloat16* vst = vs + stage * BK * ST;

    // S = Q . K^T for the warp's 16 rows and the tile's BK keys.
    float sacc[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j) sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      if constexpr (kQInRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
      } else {
        ldmatrix_x4(a, qrow + kk * 16);
      }
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, kst + (np * 16 + (lane & 7) + (lane >> 4) * 8) * ST + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(sacc[2 * np], a, bf[0], bf[1]);
        mma_bf16(sacc[2 * np + 1], a, bf[2], bf[3]);
      }
    }

    // Online softmax, in the log2 domain: s * scale * log2(e).  Masks are
    // computed only in a tile that is not wholly visible to the block's rows.
    const bool full = (!Causal || k0 + BK - 1 <= q_first) && k0 + BK <= Skv &&
                      (window <= 0 || k0 > q_last - window);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int qpos = q_first + warp * 16 + g + 8 * rr;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float s = sacc[j][2 * rr + e] * scale_log2;
          if (!full) {
            const int kpos = k0 + 8 * j + 2 * t + e;
            const bool ok = kpos < Skv && (!Causal || kpos <= qpos) &&
                            (window <= 0 || kpos > qpos - window);
            s = ok ? s : kNeg;
          }
          sacc[j][2 * rr + e] = s;
          mx = fmaxf(mx, s);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[rr], mx);
      const float alpha = exp2f(m[rr] - m_new);
      m[rr] = m_new;
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float s = sacc[j][2 * rr + e];
          const float p = s == kNeg ? 0.0f : exp2f(s - m_new);  // masked: p = 0
          psum += p;
          sacc[j][2 * rr + e] = p;
        }
      }
      l[rr] = l[rr] * alpha + psum;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        oacc[j][2 * rr] *= alpha;
        oacc[j][2 * rr + 1] *= alpha;
      }
    }

    // O += P . V: the score accumulator, rounded to bf16, is P's A fragment.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]),
          pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]),
          pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
          pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3]),
      };
#pragma unroll
      for (int nd = 0; nd < ND / 2; ++nd) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vst + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ST +
                                  nd * 16 + (lane >> 4) * 8);
        mma_bf16(oacc[2 * nd], pa, bf[0], bf[1]);
        mma_bf16(oacc[2 * nd + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();  // this stage is consumed before the next load overwrites it
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float lt = l[rr];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int s = q0 + warp * 16 + g + 8 * rr;
    if (s >= Sq) continue;
    const float lc = fmaxf(lt, 1e-30f);
    // m is in the log2 domain: the natural logsumexp is (m + log2 l) ln 2.
    if (lse != nullptr && t == 0)
      lse[(size_t)(b * Hq + h) * Sq + s] = (m[rr] + log2f(lc)) * 0.6931471805599453f;
    __nv_bfloat16* out = o + ((size_t)(b * Sq + s) * Hq + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(oacc[j][2 * rr] / lc, oacc[j][2 * rr + 1] / lc);
  }
}

template <int D, bool Causal>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                        int B, int Sq, int Skv, int Hq, int Hkv, int window, float scale,
                        cudaStream_t stream) {
  auto kernel = flash_attention_bf16_kernel<D, Causal>;
  const size_t smem = tc_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hq, (Sq + kTcBQ - 1) / kTcBQ, B);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, Sq, Skv, Hq,
      Hkv, window, scale * kLog2e);
  return cudaGetLastError();
}

// ------------------------------------------ fp32 tensor-core instance (3xTF32)

// Warps sharing a 16-row group: 2 at D = 256, each holding half of the
// output's columns (O whole would take 128 registers a thread) and the
// scores' partial sum over its half of D, summed through shared memory.
template <int D>
__host__ __device__ constexpr int f32_split() { return D > 128 ? 2 : 1; }

// Keys per K/V tile: 64 for D <= 64, 32 above (see the header).
template <int D>
__host__ __device__ constexpr int f32_keys() { return D <= 64 ? 64 : 32; }

// Q, the K/V ring and, with a split, the pairs' partial scores.
template <int D>
constexpr size_t f32_smem_bytes() {
  constexpr int BK = f32_keys<D>();
  constexpr size_t xch = f32_split<D>() > 1 ? (size_t)4 * 2 * (BK / 8) * 4 * 32 : 0;
  return ((size_t)(kTcBQ + 2 * kTcStages * BK) * f32_stride<D>() + xch) * sizeof(float);
}

template <int D, bool Causal>
__global__ void __launch_bounds__(kTcThreads * f32_split<D>(), 1)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, int Sq, int Skv, int Hq, int Hkv,
                           int window, float scale_log2) {
  constexpr int SPLIT = f32_split<D>();
  constexpr int THREADS = kTcThreads * SPLIT;
  constexpr int ST = f32_stride<D>();
  constexpr int BK = f32_keys<D>();
  constexpr int DW = D / SPLIT;       // the warp's share of D
  constexpr bool kQInRegs = D <= 64;  // Q's split A fragments held in registers
  constexpr int KW = DW / 8;          // k-steps of the warp's (partial) scores
  constexpr int NW = DW / 8;          // n-tiles of the warp's output columns
  constexpr int NK = BK / 8;          // n-tiles of the scores
  extern __shared__ __align__(16) float smem_f[];
  float* qs = smem_f;                    // kTcBQ x ST
  float* ks = qs + kTcBQ * ST;           // stages x BK x ST
  float* vs = ks + kTcStages * BK * ST;  // stages x BK x ST
  float* xs = vs + kTcStages * BK * ST;  // 4 pairs x 2 x NK x 4 x 32 partial scores

  const int h = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest (last) tiles first
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kTcBQ;
  const int offset = Skv - Sq;  // query i sits at position offset + i
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rw = warp & 3;      // the warp's rows: 16 rw .. 16 rw + 15 of the tile
  const int half = warp >> 2;   // its share of D: columns d0 .. d0 + DW - 1
  const int d0 = half * DW;
  const int g = lane >> 2;  // the accumulator rows g and g + 8 of the warp
  const int t = lane & 3;   // the accumulator columns 2t and 2t + 1 of each n-tile

  const size_t q_stride = (size_t)Hq * D;
  const size_t kv_stride = (size_t)Hkv * D;
  const float* qb = q + ((size_t)b * Sq * Hq + h) * D;
  const float* kb = k + ((size_t)b * Skv * Hkv + hk) * D;
  const float* vb = v + ((size_t)b * Skv * Hkv + hk) * D;

  // KV tiles this query tile can see (at least one: k_start <= q_first < k_stop).
  const int q_first = offset + q0;
  const int q_last = offset + min(q0 + kTcBQ, Sq) - 1;
  const int k_stop = Causal ? min(Skv, q_last + 1) : Skv;
  int k_start = 0;
  if (window > 0) {
    const int lo = q_first - window + 1;
    k_start = lo > 0 ? (lo / BK) * BK : 0;
  }
  const int n_tiles = (k_stop - k_start + BK - 1) / BK;

  cp_async_rows_f32<D, kTcBQ, THREADS>(qs, qb, q0, Sq, q_stride, tid);
  cp_async_rows_f32<D, BK, THREADS>(ks, kb, k_start, Skv, kv_stride, tid);
  cp_async_rows_f32<D, BK, THREADS>(vs, vb, k_start, Skv, kv_stride, tid);
  cp_async_commit();

  const float* qrow = qs + rw * 16 * ST + d0;
  FragA qf[kQInRegs ? KW : 1];
  float oacc[NW][4];
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.0f, 0.0f};  // this lane's share of the row sums
#pragma unroll
  for (int j = 0; j < NW; ++j) oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_start + it * BK;
    const int stage = it & 1;
    if (it + 1 < n_tiles) {  // the next tile loads while this one is used
      const int nxt = (it + 1) & 1;
      cp_async_rows_f32<D, BK, THREADS>(ks + nxt * BK * ST, kb, k0 + BK, Skv, kv_stride, tid);
      cp_async_rows_f32<D, BK, THREADS>(vs + nxt * BK * ST, vb, k0 + BK, Skv, kv_stride, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kQInRegs) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KW; ++kk) qf[kk] = a_tf32<ST>(qrow + kk * 8, g, t);
      }
    }
    const float* kst = ks + stage * BK * ST;
    const float* vst = vs + stage * BK * ST;

    // S = Q . K^T for the warp's 16 rows and the tile's BK keys (with a
    // split, over the warp's half of D, then summed with its partner's).
    float sacc[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j) sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KW; ++kk) {
      FragA a;
      if constexpr (kQInRegs) {
        a = qf[kk];
      } else {
        a = a_tf32<ST>(qrow + kk * 8, g, t);
      }
#pragma unroll
      for (int n = 0; n < NK; ++n)
        mma_3xtf32(sacc[n], a, b_rows_tf32<ST>(kst + n * 8 * ST + d0 + kk * 8, g, t));
    }
    if constexpr (SPLIT > 1) pair_sum<NK>(sacc, xs + rw * (2 * NK * 4 * 32), half, rw, lane);

    // Online softmax, in the log2 domain: s * scale * log2(e).  Masks are
    // computed only in a tile that is not wholly visible to the block's rows.
    const bool full = (!Causal || k0 + BK - 1 <= q_first) && k0 + BK <= Skv &&
                      (window <= 0 || k0 > q_last - window);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int qpos = q_first + rw * 16 + g + 8 * rr;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float s = sacc[j][2 * rr + e] * scale_log2;
          if (!full) {
            const int kpos = k0 + 8 * j + 2 * t + e;
            const bool ok = kpos < Skv && (!Causal || kpos <= qpos) &&
                            (window <= 0 || kpos > qpos - window);
            s = ok ? s : kNeg;
          }
          sacc[j][2 * rr + e] = s;
          mx = fmaxf(mx, s);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[rr], mx);
      const float alpha = exp2f(m[rr] - m_new);
      m[rr] = m_new;
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float s = sacc[j][2 * rr + e];
          const float p = s == kNeg ? 0.0f : exp2f(s - m_new);  // masked: p = 0
          psum += p;
          sacc[j][2 * rr + e] = p;
        }
      }
      l[rr] = l[rr] * alpha + psum;
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        oacc[j][2 * rr] *= alpha;
        oacc[j][2 * rr + 1] *= alpha;
      }
    }

    // O += P . V over the warp's columns: each 8-key n-tile of p is an A
    // fragment as it stands (acc_a_tf32's k order), V read in that order.
    FragA pa[NK];
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) pa[kk] = acc_a_tf32(sacc[kk]);
    mma_pairs_add<ST>(oacc, pa, vst + d0, g, t);
    __syncthreads();  // this stage (and the partial scores) is consumed before it is overwritten
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float lt = l[rr];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int s = q0 + rw * 16 + g + 8 * rr;
    if (s >= Sq) continue;
    const float lc = fmaxf(lt, 1e-30f);
    // m is in the log2 domain: the natural logsumexp is (m + log2 l) ln 2.
    if (lse != nullptr && t == 0 && half == 0)
      lse[(size_t)(b * Hq + h) * Sq + s] = (m[rr] + log2f(lc)) * 0.6931471805599453f;
    // 1 / l to about an ulp (lc lies in [1e-30, 2^24]): IEEE division calls
    // a slow-path subroutine, whose calling convention spilled registers.
    const float inv = __fdividef(1.0f, lc);
    float* out = o + ((size_t)(b * Sq + s) * Hq + h) * D + d0 + 2 * t;
#pragma unroll
    for (int j = 0; j < NW; ++j)
      *reinterpret_cast<float2*>(out + 8 * j) =
          make_float2(oacc[j][2 * rr] * inv, oacc[j][2 * rr + 1] * inv);
  }
}

template <int D, bool Causal>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse,
                       int B, int Sq, int Skv, int Hq, int Hkv, int window, float scale,
                       cudaStream_t stream) {
  auto kernel = flash_attention_f32_kernel<D, Causal>;
  const size_t smem = f32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hq, (Sq + kTcBQ - 1) / kTcBQ, B);
  kernel<<<grid, kTcThreads * f32_split<D>(), smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, Sq, Skv, Hq, Hkv, window, scale * kLog2e);
  return cudaGetLastError();
}

#define REPRO_FLASH_DISPATCH(LAUNCH, C)                                                   \
  switch (D) {                                                                            \
    case 16: return LAUNCH<16, C>(q, k, v, o, l, B, Sq, Skv, Hq, Hkv, window, scale, s);  \
    case 32: return LAUNCH<32, C>(q, k, v, o, l, B, Sq, Skv, Hq, Hkv, window, scale, s);  \
    case 64: return LAUNCH<64, C>(q, k, v, o, l, B, Sq, Skv, Hq, Hkv, window, scale, s);  \
    case 128: return LAUNCH<128, C>(q, k, v, o, l, B, Sq, Skv, Hq, Hkv, window, scale, s); \
    case 256: return LAUNCH<256, C>(q, k, v, o, l, B, Sq, Skv, Hq, Hkv, window, scale, s); \
    default: return cudaErrorInvalidValue;                                                \
  }

}  // namespace

extern "C" {

// dtype: 0 = fp32 (3xTF32 on the tensor cores), 1 = bf16 (tensor cores);
// anything else is refused.  causal: 1 = keys at positions <= the query's,
// 0 = every key.  q, k, v and o must be 16-byte aligned.  lse, unless null,
// receives the natural logsumexp of each row's scaled scores, float32
// (B, Hq, Sq), which the backward (flash_attention_bwd.cu) reads.  Returns
// the launch's cudaError_t.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                        int dtype, int B, int Sq, int Skv, int Hq, int Hkv, int D, int causal,
                        int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Sq > Skv || Hkv <= 0 || Hq % Hkv != 0 ||
      (causal != 0 && causal != 1) || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  if (bases & 15) return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0) {
    if (causal) {
      REPRO_FLASH_DISPATCH(launch_f32, true)
    }
    REPRO_FLASH_DISPATCH(launch_f32, false)
  }
  if (causal) {
    REPRO_FLASH_DISPATCH(launch_bf16, true)
  }
  REPRO_FLASH_DISPATCH(launch_bf16, false)
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
