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
// of the forward's size (S and dP recomputed twice, dV, dK, dQ), about 2.5
// times the forward's work; at tinyllama's training shape (B = 8, S = 1024,
// Hq = 32, Hkv = 4, D = 64) that is 86 GFLOP of the causal triangle.
//
// The design is the simple one, right before fast: everything in IEEE
// float32 on the CUDA cores (bf16 inputs are widened as they are staged,
// and the gradients rounded once at the end), in three kernels on one
// stream, all named `flash_attention_bwd_*`:
//   1. dot   (a warp per row): D = rowsum(dO o O).
//   2. dkdv  (one block of 256 threads per 64-key tile, KV head and batch
//            row): K and V stay in shared memory while the block walks the
//            G query heads of the KV head and the query tiles that can see
//            the tile; per query tile it recomputes S and dP as 4 x 4
//            register tiles, stages p and then dS in shared memory, and
//            accumulates dV and dK (64 x D) in registers.  No atomics: each
//            block owns its keys' gradients.
//   3. dq    (one block per 64-row query tile, query head and batch row):
//            the forward's loop over the visible key tiles, accumulating dQ
//            in registers; the heaviest tiles go first.
// S and dP are recomputed by both 2 and 3, which keeps every sum in one
// block and the result deterministic.  Head dims 16, 32, 64 and 128;
// 256 waits for its own design (ROADMAP, queue 2, entry 7).  A faster
// design would put the five products on the tensor cores with K3's
// mma.sync fragments.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;         // query rows, and keys, per tile
constexpr int kThreads = 256;  // 16 x 16: a thread owns rows ty + 16 i, columns tx + 16 j
constexpr int kPS = kB + 1;    // row stride of the p / dS tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <class T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

template <int D, class T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const void* lse, void* drow, void* dq, void* dk, void* dv, int B, int Sq,
                   int Skv, int Hq, int Hkv, int window, float scale, cudaStream_t s) {
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
  const int rows = B * Sq * Hq;
  flash_attention_bwd_dot_kernel<T><<<(rows + 7) / 8, 256, 0, s>>>(
      static_cast<const T*>(o), dop, drp, rows, Sq, Hq, D);
  err = cudaGetLastError();
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

template <class T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const void* lse, void* drow, void* dq, void* dk, void* dv,
                     int B, int Sq, int Skv, int Hq, int Hkv, int window, float scale,
                     cudaStream_t s) {
  switch (D) {
    case 16: return launch<16, T>(q, k, v, o, dout, lse, drow, dq, dk, dv, B, Sq, Skv, Hq, Hkv, window, scale, s);
    case 32: return launch<32, T>(q, k, v, o, dout, lse, drow, dq, dk, dv, B, Sq, Skv, Hq, Hkv, window, scale, s);
    case 64: return launch<64, T>(q, k, v, o, dout, lse, drow, dq, dk, dv, B, Sq, Skv, Hq, Hkv, window, scale, s);
    case 128: return launch<128, T>(q, k, v, o, dout, lse, drow, dq, dk, dv, B, Sq, Skv, Hq, Hkv, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16 (inputs and gradients; the arithmetic is fp32
// either way).  lse from flash_attention_fwd; drow is float32 (B, Hq, Sq)
// scratch for D.  Returns the first failing launch's cudaError_t, or 0.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const void* lse, void* drow, void* dq, void* dk,
                        void* dv, int dtype, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                        int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Sq > Skv || Hkv <= 0 || Hq % Hkv != 0 || window < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(D, q, k, v, o, dout, lse, drow, dq, dk, dv, B, Sq, Skv, Hq, Hkv,
                           window, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k, v, o, dout, lse, drow, dq, dk, dv, B, Sq, Skv, Hq,
                                   Hkv, window, scale, s);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
