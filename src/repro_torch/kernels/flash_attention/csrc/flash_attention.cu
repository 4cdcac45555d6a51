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
// Three designs, picked by dtype and head dim in `flash_attention_fwd` (no
// fallback from one to another):
//
// * bf16 at D <= 128, on the tensor cores (`flash_attention_bf16_kernel`):
//   - one block of 4 warps per (64-row query tile, query head, batch row),
//     16 query rows per warp.  The grid's x axis is the query head, so the
//     G heads that share a KV head are neighbours in launch order and find
//     its K/V tiles in L2 (all of K and V is 8 MB at the serving shape,
//     against a 50 MB L2), rather than one block walking the G heads, which
//     would hold G output accumulators in registers or issue G times fewer
//     blocks.  Query tiles are issued last-first, so the longest causal
//     rows start first;
//   - Q is loaded once (cp.async) into a shared tile that stays resident,
//     and read once more (ldmatrix) into registers, where it stays as the
//     A fragments of mma.sync.m16n8k16 (bf16 in, fp32 accumulate);
//   - K and V tiles of 64 keys go through a ring of two shared-memory
//     stages filled by cp.async (16-byte copies, zero-filled past Skv), so
//     the next tile's load overlaps this tile's products; rows are padded
//     by 16 bytes, so the eight rows an ldmatrix reads fall in eight
//     distinct bank groups;
//   - S = Q.K^T with ldmatrix on K; the online softmax stays in registers:
//     the row max is reduced over the quad of lanes that share a row of the
//     m16n8 accumulator, the row sum is kept per lane and reduced once at
//     the end; exponentials are exp2 of scores pre-scaled by log2(e);
//   - p is rounded to bf16 as it is packed from the S accumulator into P's
//     A fragment (the C layout of m16n8k16 is the A layout of the next
//     product), which is the reference's own rounding of p before P.V
//     (kernel.py:73); l sums the unrounded p.  O += P.V with ldmatrix.trans
//     on V.
// * bf16 at D = 256, on warpgroup products (`flash_attention_wgmma_kernel`;
//   wgmma.cuh's swizzled tiles and descriptors):
//   - one block of two warpgroups per (128-row query tile, query head,
//     batch row), 64 rows a warpgroup, each with its Q tile resident; the
//     grid, the last-first order and the masks are the D <= 128 design's.
//     A warpgroup skips a key tile none of its rows sees, so its tiles are
//     those a 64-row block would walk (ops.key_tiles counts them);
//   - Q, K and V come by the Tensor Memory Accelerator: one thread issues
//     a tile as four boxes of 64 columns x 64 rows (a column block of the
//     128-byte swizzle; rows past the tensor's end are zero-filled) against
//     an mbarrier, from tensor maps the C entry encodes each call (the
//     encoder fetched with cudaGetDriverEntryPoint).  K and V
//     tiles of 64 keys go through a ring of two stages each: at each tile
//     the V of the next and the K of the one after are issued; 197,672 B
//     of shared memory, one block an SM;
//   - S = Q.K^T is 16 m64n64k16 with both operands in shared memory, issued
//     for the next tile before this tile's softmax and O += P.V (4
//     m64n256k16, P from registers, V MN-major), so the tensor cores run
//     the next S under this tile's softmax.  The second warpgroup issues
//     its S after the first has issued its own (a named barrier), which
//     puts the two warpgroups' products in turn;
//   - the softmax has an unmasked path for tiles wholly visible to a
//     warp's rows (the max taken unscaled, the scale folded into the
//     exponent's FMA, ex2.approx) and a masked one; p is rounded to bf16
//     as it becomes P's A fragment, as the reference rounds it, and l sums
//     the unrounded p;
//   - the output, O times 1 / l, is written bf16 into the warpgroup's own
//     Q tile in the swizzled layout (a warp's stores on 32 banks) and
//     leaves by one thread's tensor store (rows past Sq dropped).
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
// The bf16 instance at D <= 128, measured by chip_smoke.py at the serving
// shape under torch.profiler (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md):
// 0.217-0.218 ms, 6.3 times the bound, against 0.109-0.112 ms for
// PyTorch's SDPA and 1.580-1.587 ms for the earlier design of this file
// (bf16 staged as fp32, scalar FMAs on the CUDA cores) in the same call.
// What holds it back is issue and latency, not bytes: the softmax's exp2,
// scale, compare and max per score run on the CUDA cores between the two
// products, and mma.sync issues at well under wgmma's rate; 128-row tiles
// and 128-key tiles were no faster.
//
// The bf16 instance at D = 256, measured (benchmarks/torch_kernel_probe.py
// k3 --old and chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W; PERF.md):
// 0.161 ms at gemma-7b's prefill (B = 8, S = 1024, 16 over 16), 0.160 at
// recurrentgemma-9b's local layers (16 over 1) and 0.035 at gemma3-4b's
// window of 1024, against 0.391, 0.394 and 0.082 for its first design
// (mma.sync, 32-key tiles, Q's fragments re-read at every k-step) and
// 0.156, 0.151 and 0.122 for SDPA.  What holds it: the tensor cores run
// its two product chains at their peak alone (torch_kernel_probe.py
// wgmma-rate: 2,048 MACs a cycle an SM on two warpgroups), 2,048 cycles a
// 64-key tile, but a tile's walk takes about 3,000 (k3-phases), the
// softmax 930-950 of them on the CUDA cores; and each block, one an SM
// and about nine tiles long, adds some 5,000 cycles of set-up (Q and the
// first K from memory, the first S alone) and 2,000 of output that no
// other block overlaps.  The products alone in this structure take 0.149
// ms (k3-split gemm_only).  Along the way: the softmax's per-score mask
// branches and exp2f's denormal path took 2,500 cycles a tile (then
// 960), the threads' cp.async copies 700-1,100 (then the tensor memory
// copies), IEEE division in the output 0.013 ms, and a persistent grid
// that copied the next tile's Q under the output was 15 % slower (255
// registers).

#include <cuda.h>  // CUtensorMap and its enums (the encoder is fetched at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "wgmma.cuh"

namespace {

using namespace repro_mma;
namespace wg = repro_wgmma;

constexpr float kNeg = -0.7f * 3.4028234663852886e38f;  // _NEG of kernel.py:28
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------- bf16 tensor-core instance

constexpr int kTcBQ = 64;                     // query rows per block, 16 per warp
constexpr int kTcBK = 64;                     // keys per K/V tile
constexpr int kTcThreads = 128;               // 4 warps
constexpr int kTcStages = 2;                  // K/V ring depth

template <int D>
constexpr size_t tc_smem_bytes() {
  return (size_t)(kTcBQ + 2 * kTcStages * kTcBK) * row_stride<D>() * sizeof(__nv_bfloat16);
}

template <int D, bool Causal>
__global__ void __launch_bounds__(kTcThreads)
flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                            float* __restrict__ lse, int Sq, int Skv, int Hq, int Hkv,
                            int window, float scale_log2) {
  static_assert(D <= 128, "D = 256 runs flash_attention_wgmma_kernel");
  constexpr int ST = row_stride<D>();
  constexpr int BK = kTcBK;
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
  uint32_t qf[KD][4];
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
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) ldmatrix_x4(qf[kk], qrow + kk * 16);
    }
    const __nv_bfloat16* kst = ks + stage * BK * ST;
    const __nv_bfloat16* vst = vs + stage * BK * ST;

    // S = Q . K^T for the warp's 16 rows and the tile's BK keys.
    float sacc[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j) sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, kst + (np * 16 + (lane & 7) + (lane >> 4) * 8) * ST + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(sacc[2 * np], qf[kk], bf[0], bf[1]);
        mma_bf16(sacc[2 * np + 1], qf[kk], bf[2], bf[3]);
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

template <bool Causal>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse,
                         int B, int Sq, int Skv, int Hq, int Hkv, int window, float scale,
                         cudaStream_t stream);

template <int D, bool Causal>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                        int B, int Sq, int Skv, int Hq, int Hkv, int window, float scale,
                        cudaStream_t stream) {
  if constexpr (D == 256) {
    return launch_wgmma<Causal>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, window, scale, stream);
  } else {
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
}

// ---------------------------------------- bf16 instance at D = 256, on wgmma

constexpr int kWgD = 256;
constexpr int kWgRows = 64;                  // a warpgroup's query rows; a K/V tile's keys
constexpr int kWgGroups = 2;                 // consumer warpgroups a block
constexpr int kWgBlockRows = kWgGroups * kWgRows;
constexpr int kWgThreads = 128 * kWgGroups;
constexpr int kWgTile = kWgRows * kWgD * 2;  // bytes of a swizzled 64 x 256 bf16 tile
constexpr int kWgAlign = 1024;               // the swizzle's period: every tile starts on it
constexpr int kOrderBar = 1;                 // named barrier: the warpgroups' S products in turn
// The warpgroups' Q tiles, two stages of K and two of V, then the five
// mbarriers the tensor-memory copies complete on (Q, K's two stages, V's
// two): 197,672 B.
constexpr size_t kWgSmem = kWgAlign + (size_t)(kWgGroups + 4) * kWgTile + 5 * 8;

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

// The barrier's next phase completes when `bytes` have landed (one arrive).
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of parity `phase` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(phase)
      : "memory");
}

// One box of a tensor map (64 columns of one head's 64 rows) into shared
// memory at dst, in the 128-byte swizzle, completing on `bar`; rows past
// the tensor's end are zero-filled.
__device__ __forceinline__ void tma_box(unsigned char* dst, const CUtensorMap* map,
                                        uint64_t* bar, int col, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(head), "r"(row), "r"(batch),
      "r"(smem_u32(bar))
      : "memory");
}

// Rows row0 .. row0 + 63 of one head of a (B, S, H, 256) tensor as a
// swizzled 64 x 256 tile (four column blocks of 64 x 128 bytes), by one
// thread, completing on `bar`.
__device__ __forceinline__ void tma_tile(unsigned char* tile, const CUtensorMap* map,
                                         uint64_t* bar, int head, int row0, int batch) {
#pragma unroll
  for (int cb = 0; cb < kWgD / 64; ++cb)
    tma_box(tile + cb * (kWgRows * 128), map, bar, cb * 64, head, row0, batch);
}

__device__ __forceinline__ unsigned char* align_tiles(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + ((kWgAlign - (a & (kWgAlign - 1))) & (kWgAlign - 1));
}

// wgmma.cuh's descriptors of k-step kk (desc_k) and reduction step kk
// (desc_mn) of a 64-row tile, as its step-0 descriptor plus the step's
// offset in 16-byte units: 32 bytes a k-step inside a swizzled row, a
// column block every 4; 16 rows of 128 bytes a reduction step.  The start
// address field (bits 0-13) does not carry: shared addresses are below
// 2^18.
__device__ __forceinline__ uint64_t k_step(uint64_t d0, int kk) {
  return d0 + (uint64_t)(((kk >> 2) * (kWgRows * 128) + (kk & 3) * 32) >> 4);
}

__device__ __forceinline__ uint64_t mn_step(uint64_t d0, int kk) {
  return d0 + (uint64_t)(kk * 16 * 128 >> 4);
}

// S = Q . K^T for a warpgroup's 64 rows (the Q tile's step-0 descriptor
// dq) and a K tile's 64 keys (dk) into s, issued (when `go`) and not waited
// on.  The second warpgroup issues after the first, so the tensor cores
// run the two in turn and each one's softmax overlaps the other's products.
__device__ __forceinline__ void issue_scores(float (&s)[32], bool go, int grp, uint64_t dq,
                                             uint64_t dk) {
  if (grp == 1) wg::bar_sync(kOrderBar, kWgThreads);
  if (go) {
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kWgD / 16; ++kk)
      wg::wgmma_m64n64k16_ss(s, k_step(dq, kk), k_step(dk, kk), kk > 0);
    wg::commit();
  }
  if (grp == 0) wg::bar_arrive(kOrderBar, kWgThreads);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of a tile's scores s (a warpgroup's m64n64 accumulator:
// the lane's rows qrow and qrow + 8, columns 8 j + 2 t + e) in the log2
// domain, s * scale * log2(e): the running max m and sum l (the lane's
// share), the output rows rescaled, p in s's place.  `Masked`: the causal,
// window and ragged masks per score (_NEG where not visible, then p = 0);
// else every score is visible, the max is taken unscaled and the scale
// folds into the exponent's FMA.  Two partial maxima and sums a row keep
// the dependent chains short.
template <bool Causal, bool Masked>
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m)[2], float (&l)[2],
                                             float (&acc)[128], float scale_log2, int k0,
                                             int qrow, int t, int Skv, int window) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qpos = qrow + 8 * rr;
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * rr + e];
        if constexpr (Masked) {
          const int kpos = k0 + 8 * j + 2 * t + e;
          const bool ok = kpos < Skv && (!Causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
          x = ok ? x * scale_log2 : kNeg;
        }
        mx[e] = fmaxf(mx[e], x);
      }
    }
    float mr = fmaxf(mx[0], mx[1]);
    mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 1));
    mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 2));
    const float m_new = fmaxf(m[rr], Masked ? mr : mr * scale_log2);
    const float alpha = ex2(m[rr] - m_new);
    m[rr] = m_new;
    float ps[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * rr + e];
        if constexpr (Masked) {
          x = x == kNeg ? 0.0f : ex2(x - m_new);  // masked: p = 0
        } else {
          x = ex2(fmaf(x, scale_log2, -m_new));
        }
        ps[e] += x;
      }
    }
    l[rr] = l[rr] * alpha + (ps[0] + ps[1]);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      acc[4 * j + 2 * rr] *= alpha;
      acc[4 * j + 2 * rr + 1] *= alpha;
    }
  }
}

// 128 query rows of one query head a block, 64 a warpgroup, each with its
// Q tile resident; the block's K/V tiles (64 keys) through a ring of two
// stages.  A warpgroup skips a tile none of its rows sees.  Per tile:
// S = Q.K^T (16 m64n64k16, both operands in shared memory), the online
// softmax in S's registers, O += P.V (4 m64n256k16, P from registers).
template <bool Causal>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap to, float* __restrict__ lse,
                             int Sq, int Skv, int Hq, int Hkv, int window, float scale_log2) {
  constexpr int D = kWgD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* qs = align_tiles(smem_raw);     // kWgGroups tiles
  unsigned char* ks = qs + kWgGroups * kWgTile;  // two stages
  unsigned char* vs = ks + 2 * kWgTile;          // two stages
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(vs + 2 * kWgTile);
  uint64_t* bar_k = bar_q + 1;  // two stages
  uint64_t* bar_v = bar_q + 3;  // two stages

  const int h = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest (last) tiles first
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kWgBlockRows;
  const int offset = Skv - Sq;  // query i sits at position offset + i
  const int tid = threadIdx.x;
  // The warpgroup, rows q0 + 64 grp .. (a shuffle makes it warp-uniform
  // for the compiler, so its descriptors sit in uniform registers).
  const int grp = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int wt = tid & 127;
  const int warp = wt >> 5;
  const int g = (wt & 31) >> 2;  // the accumulator rows 16 warp + g and + 8
  const int t = wt & 3;          // the accumulator columns 8 j + 2 t and + 1

  // The block's KV tiles (at least one: k_start <= q_first < k_stop).
  const int q_first = offset + q0;
  const int q_last = offset + min(q0 + kWgBlockRows, Sq) - 1;
  const int k_stop = Causal ? min(Skv, q_last + 1) : Skv;
  int k_start = 0;
  if (window > 0) {
    const int lo = q_first - window + 1;
    k_start = lo > 0 ? (lo / kWgRows) * kWgRows : 0;
  }
  const int n_tiles = (k_stop - k_start + kWgRows - 1) / kWgRows;
  // The warpgroup's rows (none past Sq in the last block's second half).
  const int r0 = q0 + grp * kWgRows;
  const bool has_rows = r0 < Sq;
  const int w_first = offset + r0;
  const int w_last = offset + min(r0 + kWgRows, Sq) - 1;
  const int qw = w_first + warp * 16;  // the warp's first query position

  // Some row of the warpgroup sees some key of tile `it`: a key j is seen by
  // query position p when j <= p (causal) and j > p - window.
  auto seen = [&](int it) {
    const int k0 = k_start + it * kWgRows;
    return has_rows && (!Causal || k0 <= w_last) &&
           (window <= 0 || max(w_first, Causal ? k0 : w_first) < k0 + kWgRows - 1 + window);
  };
  // Tile `it`'s K or V rows into its stage, and the wait for them: a
  // stage's n-th tile (it = stage + 2 n) completes its barrier's phase of
  // parity n & 1.  The copies are issued by the block's last thread: its
  // warpgroup issues its S products after the first's anyway.
  const bool issuer = tid == kWgThreads - 1;
  auto load = [&](unsigned char* ring, uint64_t* bars, const CUtensorMap* map, int it) {
    if (issuer && it < n_tiles) {
      mbar_expect(bars + (it & 1), kWgTile);
      tma_tile(ring + (it & 1) * kWgTile, map, bars + (it & 1), hk, k_start + it * kWgRows, b);
    }
  };
  auto landed = [&](uint64_t* bars, int it) { mbar_wait(bars + (it & 1), (it >> 1) & 1); };
  const unsigned char* qw_tile = qs + grp * kWgTile;

  // Q, K and V of tile 0 and K of tile 1; then per tile the V of the next
  // and the K of the one after, each into the stage the tile two before
  // left.  S of the next tile runs while this one's softmax and P.V do.
  if (issuer) {
    for (int i = 0; i < 5; ++i) mbar_init(bar_q + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tq)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tk)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tv)) : "memory");
  }
  __syncthreads();
  if (issuer) {
    mbar_expect(bar_q, kWgGroups * kWgTile);
#pragma unroll
    for (int i = 0; i < kWgGroups; ++i) tma_tile(qs + i * kWgTile, &tq, bar_q, h, q0 + i * kWgRows, b);
  }
  load(ks, bar_k, &tk, 0);
  load(vs, bar_v, &tv, 0);
  load(ks, bar_k, &tk, 1);
  mbar_wait(bar_q, 0);
  landed(bar_k, 0);

  float acc[128];  // O, the warpgroup's 64 rows x 256
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.0f, 0.0f};  // this lane's share of the row sums
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  float s[32], sn[32];  // this tile's scores, the next tile's
  uint32_t pa[4][4];
  const uint64_t dq = wg::desc_k<kWgRows>(qw_tile, 0);
  const uint64_t dk = wg::desc_k<kWgRows>(ks, 0);
  const uint64_t dv = wg::desc_mn<kWgRows>(vs, 0);
  issue_scores(s, seen(0), grp, dq, dk);
  wg::wait<0>();
  wg::keep(s);

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_start + it * kWgRows;
    __syncthreads();  // both warpgroups are done with tile it - 1's stages
    load(vs, bar_v, &tv, it + 1);
    load(ks, bar_k, &tk, it + 2);
    const bool next = it + 1 < n_tiles && seen(it + 1);
    if (next) landed(bar_k, it + 1);
    issue_scores(sn, next, grp, dq, dk + ((it + 1) & 1) * (kWgTile >> 4));
    if (seen(it)) {
      // Masks only in a tile not wholly visible to the warp's rows.
      const bool full = (!Causal || k0 + kWgRows - 1 <= qw) && k0 + kWgRows <= Skv &&
                        (window <= 0 || k0 > qw + 15 - window);
      if (full) {
        softmax_tile<Causal, false>(s, m, l, acc, scale_log2, k0, qw + g, t, Skv, window);
      } else {
        softmax_tile<Causal, true>(s, m, l, acc, scale_log2, k0, qw + g, t, Skv, window);
      }

      // O += P . V: p rounded to bf16 into A fragments (wgmma's accumulator
      // and A layouts are mma.sync's, warp by warp); the tile's keys are the
      // reduction, V read MN-major.
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
      const uint64_t dvs = dv + (it & 1) * (kWgTile >> 4);
      landed(bar_v, it);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wg::wgmma_m64n256k16_rs(acc, pa[kk], mn_step(dvs, kk), 1);
      wg::commit();
    }
    wg::wait<0>();
    wg::keep(acc);
    wg::keep(pa);
    wg::keep(sn);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = sn[i];
  }

  // O / l, rounded to bf16, into the warpgroup's own Q tile (its S products
  // are done) in the swizzled layout, which puts a warp's stores on 32
  // banks; then one thread copies the tile out (rows past Sq are dropped).
  if (!has_rows) return;
  unsigned char* ot = qs + grp * kWgTile;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float lt = l[rr];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int r = warp * 16 + g + 8 * rr;  // the row in the tile
    const float lc = fmaxf(lt, 1e-30f);
    // m is in the log2 domain: the natural logsumexp is (m + log2 l) ln 2.
    if (lse != nullptr && t == 0 && r0 + r < Sq)
      lse[(size_t)(b * Hq + h) * Sq + r0 + r] = (m[rr] + log2f(lc)) * 0.6931471805599453f;
    const float inv = 1.0f / lc;  // one division a row, then products
#pragma unroll
    for (int j = 0; j < 32; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ot + (j >> 3) * (kWgRows * 128) + r * 128 +
                                         (((j & 7) ^ (r & 7)) << 4) + 4 * t) =
          __floats2bfloat162_rn(acc[4 * j + 2 * rr] * inv, acc[4 * j + 2 * rr + 1] * inv);
  }
  wg::fence_proxy_async();          // the stores, seen by the copy
  wg::bar_sync(2 + grp, 128);       // the warpgroup's stores are all in
  if (wt == 0) {
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb)
      asm volatile(
          "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, %3, %4}], [%5];\n"
          ::"l"(reinterpret_cast<uint64_t>(&to)), "r"(cb * 64), "r"(h), "r"(r0), "r"(b),
          "r"(smem_u32(ot + cb * (kWgRows * 128)))
          : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // before the tile is freed
  }
}

// cuTensorMapEncodeTiled, fetched with the runtime's cudaGetDriverEntryPoint
// (the library links no libcuda of its own), or null.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A (B, S, H, 256) bf16 tensor as boxes of 64 columns of one head's 64
// rows, in the 128-byte swizzle (its dimensions innermost first: columns,
// heads, rows, batch rows).
cudaError_t tile_map(CUtensorMap* map, const void* base, int B, int S, int H) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)kWgD, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)kWgD * 2, (cuuint64_t)H * kWgD * 2,
                                 (cuuint64_t)S * H * kWgD * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)kWgRows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool Causal>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse,
                         int B, int Sq, int Skv, int Hq, int Hkv, int window, float scale,
                         cudaStream_t stream) {
  auto kernel = flash_attention_wgmma_kernel<Causal>;
  CUtensorMap tq, tk, tv, to;
  cudaError_t err = tile_map(&tq, q, B, Sq, Hq);
  if (err == cudaSuccess) err = tile_map(&tk, k, B, Skv, Hkv);
  if (err == cudaSuccess) err = tile_map(&tv, v, B, Skv, Hkv);
  if (err == cudaSuccess) err = tile_map(&to, o, B, Sq, Hq);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kWgSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hq, (Sq + kWgBlockRows - 1) / kWgBlockRows, B);
  kernel<<<grid, kWgThreads, kWgSmem, stream>>>(tq, tk, tv, to, lse, Sq, Skv, Hq, Hkv, window,
                                                scale * kLog2e);
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
