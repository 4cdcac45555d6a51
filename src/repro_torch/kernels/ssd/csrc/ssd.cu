// Mamba-2 SSD chunk scan (state-space duality, ngroups = 1) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `ssd_pallas`
// (src/repro/kernels/ssd/kernel.py): for every batch row b and head h,
// over the chunks of l positions in order, with cum = cumsum(dA) inside
// the chunk,
//   L[i, j]  = exp(cum_i - cum_j) for i >= j, else 0
//   y_diag   = (C . B^T o L) . xdt
//   y_off    = exp(cum_i) * (C . S_prev^T)
//   S       <- exp(cum_end) * S + sum_j exp(cum_end - cum_j) * xdt_j^T B_j
// and returns y and the final state S.  Layouts as the reference's:
// xdt and y (B, S, H, P), dA (B, S, H), bm and cm (B, S, N), the final
// state (B, H, P, N), all fp32; S is a multiple of l (the model pads with
// dt = 0 steps, which leave the state unchanged).  L is formed as
// exp(cum_i - cum_j), never as a quotient of exponentials, which would
// underflow over a chunk whose decays sum below -100.  IEEE fp32 on the
// CUDA cores throughout, no TF32.
//
// What bounds it on the H100: operations.  At the serving shape (B = 8,
// S = 1024, H = 24, P = 64, N = 128, l = 128) the causal work is about
// 8.2 GFLOP of fp32 (y_diag over the lower triangle, y_off and the state
// update l.P.N each, the scores once per chunk), 0.12 ms at 67 TFLOP/s,
// while its bytes (xdt and y 50 MB each, B and C 4 MB each, the state
// 6 MB) take 0.035 ms at 3.35 TB/s.  This first kernel is the simple
// design:
//   * one block of 256 threads per (head, batch row), 192 blocks at the
//     serving shape; the block walks the chunks in order and carries the
//     state (P x N fp32, 32 KB) in shared memory, as the Pallas kernel
//     carries it in VMEM across its sequential chunk axis;
//   * per chunk it stages xdt (l x P) and B (l x N) in shared memory,
//     with 16-byte loads where P and N allow, and computes cum with one
//     warp's scan;
//   * it walks the chunk's rows in blocks of 64: the C rows of the block,
//     their scores against the B rows up to the block's last row (only
//     the column groups the causal mask keeps), weighted by L in place,
//     then y = scores . xdt plus exp(cum_i) * C . S^T;
//   * after every row has read the old state, it folds the chunk into S;
//   * each thread owns a strided 4 x 8, 4 x 4 or 4 x 8 register tile of
//     each product (rows ty + 16 i, columns tx + 16 j), reading
//     conflict-free rows of shared memory padded to an odd stride, four
//     steps of each inner loop unrolled.
// About 197 KB of shared memory at the serving shape, so one block per
// SM and two waves of blocks.  With ngroups = 1 the scores C . B^T are
// the same for every head; each block recomputes them for its own head,
// 24 times the needed score work at the serving shape (about a third of
// the block's multiply-adds).  Sharing them, the tensor cores and the
// Mamba-2 split over chunks are work for a later change; the times
// stand in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kRows = 64;      // chunk rows per row block
constexpr int kMaxL = 128;     // the largest chunk
constexpr int kMaxP = 64;      // the largest head dim
constexpr int kMaxN = 128;     // the largest state size
constexpr int kRI = kRows / 16;
constexpr int kLJ = kMaxL / 16;
constexpr int kPI = kMaxP / 16;
constexpr int kNJ = kMaxN / 16;

__host__ __device__ constexpr size_t smem_floats(int L, int P, int N) {
  // state P x (N+1), xdt L x P, B L x (N+1), C kRows x (N+1),
  // scores kRows x (L+1), cum L, exp(cum_end - cum) L
  return (size_t)P * (N + 1) + (size_t)L * P + (size_t)L * (N + 1) + (size_t)kRows * (N + 1) +
         (size_t)kRows * (L + 1) + 2 * (size_t)L;
}

// One row block's scores o L (see the kernel): gs[r][j] for r < rows and
// j < jend, from the C rows cs and the B rows bs; JG column groups of 16.
template <int JG>
__device__ __forceinline__ void score_block(const float* cs, const float* bs, const float* cum,
                                            float* gs, int NS, int GS, int N, int i0, int rows,
                                            int jend, int tx, int ty) {
  float acc[kRI][JG];
#pragma unroll
  for (int i = 0; i < kRI; ++i)
#pragma unroll
    for (int j = 0; j < JG; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int n = 0; n < N; ++n) {
    float cv[kRI], bv[JG];
#pragma unroll
    for (int i = 0; i < kRI; ++i) cv[i] = cs[(ty + 16 * i) * NS + n];
#pragma unroll
    for (int j = 0; j < JG; ++j) {
      const int jj = tx + 16 * j;
      bv[j] = jj < jend ? bs[jj * NS + n] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kRI; ++i)
#pragma unroll
      for (int j = 0; j < JG; ++j) acc[i][j] += cv[i] * bv[j];
  }
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    const int r = ty + 16 * i;
    const int row = i0 + r;
#pragma unroll
    for (int j = 0; j < JG; ++j) {
      const int jj = tx + 16 * j;
      if (r < rows && jj < jend)
        gs[r * GS + jj] = jj <= row ? acc[i][j] * expf(cum[row] - cum[jj]) : 0.0f;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_scan_kernel(const float* __restrict__ xdt, const float* __restrict__ dA,
                      const float* __restrict__ bm, const float* __restrict__ cm,
                      float* __restrict__ y, float* __restrict__ final_state, int S, int H,
                      int P, int N, int L) {
  extern __shared__ float smem[];
  const int NS = N + 1;  // odd row strides: conflict-free column walks
  const int GS = L + 1;
  float* st = smem;              // P x NS: the carried state
  float* xs = st + P * NS;       // L x P: xdt of the chunk
  float* bs = xs + L * P;        // L x NS: B of the chunk
  float* cs = bs + L * NS;       // kRows x NS: C of the row block
  float* gs = cs + kRows * NS;   // kRows x GS: scores o L of the row block
  float* cum = gs + kRows * GS;  // L: cumsum of dA inside the chunk
  float* wend = cum + L;         // L: exp(cum_end - cum_j)

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(xdt) | reinterpret_cast<uintptr_t>(bm);
  const bool vec = ((P | N) & 3) == 0 && (bases & 15) == 0;

  for (int i = tid; i < P * NS; i += kThreads) st[i] = 0.0f;

  for (int s0 = 0; s0 < S; s0 += L) {
    __syncthreads();  // the previous chunk's reads of xs, bs and st are done
    if (vec) {  // 16-byte loads: P and N are multiples of 4
      const int P4 = P >> 2, N4 = N >> 2;
#pragma unroll 4
      for (int i = tid; i < L * P4; i += kThreads) {
        const int j = i / P4;
        const int q = i - j * P4;
        const float4 v = reinterpret_cast<const float4*>(
            xdt + ((size_t)(b * S + s0 + j) * H + h) * P)[q];
        float* d = xs + j * P + 4 * q;
        d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
      }
#pragma unroll 4
      for (int i = tid; i < L * N4; i += kThreads) {
        const int j = i / N4;
        const int q = i - j * N4;
        const float4 v = reinterpret_cast<const float4*>(bm + (size_t)(b * S + s0 + j) * N)[q];
        float* d = bs + j * NS + 4 * q;
        d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
      }
    } else {
      for (int i = tid; i < L * P; i += kThreads) {
        const int j = i / P;
        const int p = i - j * P;
        xs[i] = xdt[((size_t)(b * S + s0 + j) * H + h) * P + p];
      }
      for (int i = tid; i < L * N; i += kThreads) {
        const int j = i / N;
        const int n = i - j * N;
        bs[j * NS + n] = bm[(size_t)(b * S + s0 + j) * N + n];
      }
    }
    if (tid < 32) {  // inclusive cumsum of dA over the chunk, one warp
      const int per = (L + 31) / 32;  // <= 4 positions a lane, in order
      float vals[kMaxL / 32];
      float run = 0.0f;
#pragma unroll
      for (int k = 0; k < kMaxL / 32; ++k) {
        const int j = tid * per + k;
        if (k < per && j < L) run += dA[(size_t)(b * S + s0 + j) * H + h];
        vals[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += t;
      }
      const float before = incl - run;
#pragma unroll
      for (int k = 0; k < kMaxL / 32; ++k) {
        const int j = tid * per + k;
        if (k < per && j < L) cum[j] = before + vals[k];
      }
    }
    __syncthreads();
    const float cend = cum[L - 1];
    for (int j = tid; j < L; j += kThreads) wend[j] = expf(cend - cum[j]);

    for (int i0 = 0; i0 < L; i0 += kRows) {
      const int rows = min(kRows, L - i0);
      const int jend = i0 + rows;  // causal: columns before the block's end
      __syncthreads();  // the previous row block's reads of cs and gs are done
      for (int i = tid; i < rows * N; i += kThreads) {
        const int r = i / N;
        const int n = i - r * N;
        cs[r * NS + n] = cm[(size_t)(b * S + s0 + i0 + r) * N + n];
      }
      __syncthreads();

      // scores o L: gs[r][j] = (C_r . B_j) * exp(cum_r - cum_j), 0 for j > r;
      // only the column groups before the block's end are computed.
      if (jend <= kMaxL / 2)
        score_block<kLJ / 2>(cs, bs, cum, gs, NS, GS, N, i0, rows, jend, tx, ty);
      else
        score_block<kLJ>(cs, bs, cum, gs, NS, GS, N, i0, rows, jend, tx, ty);
      __syncthreads();

      // y = gs . xdt + exp(cum_r) * C_r . S^T for the block's rows.
      {
        float acc[kRI][kPI], off[kRI][kPI];
#pragma unroll
        for (int i = 0; i < kRI; ++i)
#pragma unroll
          for (int j = 0; j < kPI; ++j) acc[i][j] = off[i][j] = 0.0f;
#pragma unroll 4
        for (int jj = 0; jj < jend; ++jj) {
          float gv[kRI], xv[kPI];
#pragma unroll
          for (int i = 0; i < kRI; ++i) gv[i] = gs[(ty + 16 * i) * GS + jj];
#pragma unroll
          for (int j = 0; j < kPI; ++j) {
            const int p = tx + 16 * j;
            xv[j] = p < P ? xs[jj * P + p] : 0.0f;
          }
#pragma unroll
          for (int i = 0; i < kRI; ++i)
#pragma unroll
            for (int j = 0; j < kPI; ++j) acc[i][j] += gv[i] * xv[j];
        }
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[kRI], sv[kPI];
#pragma unroll
          for (int i = 0; i < kRI; ++i) cv[i] = cs[(ty + 16 * i) * NS + n];
#pragma unroll
          for (int j = 0; j < kPI; ++j) {
            const int p = tx + 16 * j;
            sv[j] = p < P ? st[p * NS + n] : 0.0f;
          }
#pragma unroll
          for (int i = 0; i < kRI; ++i)
#pragma unroll
            for (int j = 0; j < kPI; ++j) off[i][j] += cv[i] * sv[j];
        }
#pragma unroll
        for (int i = 0; i < kRI; ++i) {
          const int r = ty + 16 * i;
          if (r >= rows) continue;
          const int row = i0 + r;
          const float decay_in = expf(cum[row]);
          float* out = y + ((size_t)(b * S + s0 + row) * H + h) * P;
#pragma unroll
          for (int j = 0; j < kPI; ++j) {
            const int p = tx + 16 * j;
            if (p < P) out[p] = acc[i][j] + decay_in * off[i][j];
          }
        }
      }
    }
    __syncthreads();  // every row has read the state before this chunk

    // S <- exp(cum_end) S + sum_j (exp(cum_end - cum_j) xdt_j)^T B_j
    {
      const float decay_all = expf(cend);
      float acc[kPI][kNJ];
#pragma unroll
      for (int i = 0; i < kPI; ++i)
#pragma unroll
        for (int j = 0; j < kNJ; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
      for (int jj = 0; jj < L; ++jj) {
        const float w = wend[jj];
        float xv[kPI], bv[kNJ];
#pragma unroll
        for (int i = 0; i < kPI; ++i) {
          const int p = ty + 16 * i;
          xv[i] = p < P ? xs[jj * P + p] * w : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          const int n = tx + 16 * j;
          bv[j] = n < N ? bs[jj * NS + n] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < kPI; ++i)
#pragma unroll
          for (int j = 0; j < kNJ; ++j) acc[i][j] += xv[i] * bv[j];
      }
#pragma unroll
      for (int i = 0; i < kPI; ++i) {
        const int p = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          const int n = tx + 16 * j;
          if (p < P && n < N) st[p * NS + n] = decay_all * st[p * NS + n] + acc[i][j];
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N;
    const int n = i - p * N;
    final_state[((size_t)(b * H + h) * P + p) * N + n] = st[p * NS + n];
  }
}

}  // namespace

extern "C" {

// Returns the launch's cudaError_t.
int ssd_chunk_scan_fwd(const void* xdt, const void* dA, const void* bm, const void* cm, void* y,
                       void* final_state, int B, int S, int H, int P, int N, int L,
                       void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || L <= 0 || L > kMaxL || P > kMaxP ||
      N > kMaxN || S % L != 0)
    return cudaErrorInvalidValue;
  const size_t smem = smem_floats(L, P, N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_scan_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B);
  ssd_chunk_scan_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xdt), static_cast<const float*>(dA),
      static_cast<const float*>(bm), static_cast<const float*>(cm), static_cast<float*>(y),
      static_cast<float*>(final_state), S, H, P, N, L);
  return cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
