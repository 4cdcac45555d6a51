// Causal GQA prefill attention (flash attention, forward) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention/kernel.py:89, its pallas_call at
// :123): for every query row i, sitting at absolute position Skv - Sq + i,
// the softmax over the keys at positions <= its own (and, with a window
// w > 0, > position - w) of q.k * scale, applied to v.  It reads the model
// layout directly: q and o (B, Sq, Hq, D), k and v (B, Skv, Hkv, D); query
// head h reads KV head h / G (G = Hq / Hkv) without copying K/V.  Scores,
// the running max m, the running sum l and the output accumulator are
// fp32.  Masked scores take _NEG = -0.7 * FLT_MAX, not -inf, and a row with
// nothing valid keeps l clamped to 1e-30, as kernel.py:28 and :80 do.
// KV tiles wholly above the diagonal or left of the window are skipped
// (kernel.py:46-50); the ragged last tile is masked in the kernel rather
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
// * fp32, on the CUDA cores (`flash_attention_f32_kernel`), in IEEE fp32
//   with no TF32: one block of 256 threads per (64-row query tile, query
//   head, batch row), q, K and V staged in shared memory as fp32, a 4 x 4
//   register tile of the score block per thread, the online softmax
//   reduced over the 16 threads of a row with warp shuffles.  The models'
//   f32 paths and the f32 tests take it.  At D = 256 its tiles take
//   217,600 B of shared memory, one block per SM.
//
// Measured by chip_smoke.py at the serving shape under torch.profiler
// (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md): 0.217-0.218 ms, 6.3 times
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

// ------------------------------------------------------------ fp32 instance

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per staged tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kPS = kBK + 16;  // row stride of the probability tile

template <int D>
constexpr size_t f32_smem_floats() {
  return (size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) + (size_t)kBK * D + (size_t)kBQ * kPS;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, int Sq, int Skv, int Hq, int Hkv,
                           int window, float scale) {
  constexpr int QS = D + 1;  // padded row stride of the q and K tiles
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;             // kBQ x QS
  float* ks = qs + kBQ * QS;    // kBK x QS
  float* vs = ks + kBK * QS;    // kBK x D
  float* ps = vs + kBK * D;     // kBQ x kPS

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest (last) tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kBQ;
  const int offset = Skv - Sq;  // query i sits at position offset + i
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    const int s = q0 + r;
    qs[r * QS + c] = s < Sq ? q[((size_t)(b * Sq + s) * Hq + h) * D + c] : 0.0f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  // KV tiles this query tile can see.
  const int q_first = offset + q0;                      // first row's position
  const int q_last = offset + min(q0 + kBQ, Sq) - 1;   // last real row's position
  const int k_stop = min(Skv, q_last + 1);              // causal: keys <= q_last
  int k_start = 0;
  if (window > 0) {
    const int lo = q_first - window + 1;  // the first row's oldest visible key
    k_start = lo > 0 ? (lo / kBK) * kBK : 0;
  }

  for (int k0 = k_start; k0 < k_stop; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D;
      const int c = i - r * D;
      const int s = k0 + r;
      const size_t g = ((size_t)(b * Skv + s) * Hkv + hk) * D + c;
      const bool in = s < Skv;
      ks[r * QS + c] = in ? k[g] : 0.0f;
      vs[r * D + c] = in ? v[g] : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q_first + r;
      bool ok[4];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < Skv && kpos <= qpos && (window <= 0 || kpos > qpos - window);
        s[i][j] = ok[j] ? s[i][j] * scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      // The 16 threads of a row are lanes tx of one half-warp.
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
        psum += p;
        ps[r * kPS + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // the probability tile is complete

    float pv[4][DJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) pv[i][j] = 0.0f;
#pragma unroll 8
    for (int c = 0; c < kBK; ++c) {
      float pr[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = ps[(ty + 16 * i) * kPS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) pv[i][j] += pr[i] * vv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] += pv[i][j];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= Sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    float* out = o + ((size_t)(b * Sq + s) * Hq + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) out[tx + 16 * j] = acc[i][j] / lc;
    if (lse != nullptr && tx == 0) lse[(size_t)(b * Hq + h) * Sq + s] = m[i] + logf(lc);
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse,
                       int B, int Sq, int Skv, int Hq, int Hkv, int window, float scale,
                       cudaStream_t stream) {
  auto kernel = flash_attention_f32_kernel<D>;
  const size_t smem = f32_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, Sq, Skv, Hq, Hkv, window, scale);
  return cudaGetLastError();
}

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

template <int D>
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
  const int k_stop = min(Skv, q_last + 1);
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
    const bool full = k0 + BK - 1 <= q_first && k0 + BK <= Skv &&
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
            const bool ok = kpos < Skv && kpos <= qpos && (window <= 0 || kpos > qpos - window);
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

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                        int B, int Sq, int Skv, int Hq, int Hkv, int window, float scale,
                        cudaStream_t stream) {
  auto kernel = flash_attention_bf16_kernel<D>;
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

#define REPRO_FLASH_DISPATCH(LAUNCH)                                                   \
  switch (D) {                                                                         \
    case 16: return LAUNCH<16>(q, k, v, o, l, B, Sq, Skv, Hq, Hkv, window, scale, s);  \
    case 32: return LAUNCH<32>(q, k, v, o, l, B, Sq, Skv, Hq, Hkv, window, scale, s);  \
    case 64: return LAUNCH<64>(q, k, v, o, l, B, Sq, Skv, Hq, Hkv, window, scale, s);  \
    case 128: return LAUNCH<128>(q, k, v, o, l, B, Sq, Skv, Hq, Hkv, window, scale, s); \
    case 256: return LAUNCH<256>(q, k, v, o, l, B, Sq, Skv, Hq, Hkv, window, scale, s); \
    default: return cudaErrorInvalidValue;                                             \
  }

}  // namespace

extern "C" {

// dtype: 0 = fp32 (CUDA cores), 1 = bf16 (tensor cores); anything else is
// refused.  q, k, v and o must be 16-byte aligned for bf16.  lse, unless
// null, receives the natural logsumexp of each row's scaled scores, float32
// (B, Hq, Sq), which the backward (flash_attention_bwd.cu) reads.  Returns
// the launch's cudaError_t.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                        int dtype, int B, int Sq, int Skv, int Hq, int Hkv, int D, int window,
                        float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Sq > Skv || Hkv <= 0 || Hq % Hkv != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0) {
    REPRO_FLASH_DISPATCH(launch_f32)
  }
  if (dtype == 1) {
    const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                            reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
    if (bases & 15) return cudaErrorMisalignedAddress;
    REPRO_FLASH_DISPATCH(launch_bf16)
  }
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
