// Tensor-core and async-copy helpers shared by flash attention's forward
// (flash_attention.cu) and backward (flash_attention_bwd.cu), sm_90a:
// cp.async copies into shared tiles whose rows are padded by 16 bytes;
// for the bf16 instances ldmatrix fragment loads and mma.sync.m16n8k16
// with bf16 in and fp32 accumulate; for the fp32 instances 32-bit
// fragment loads and mma.sync.m16n8k8 on TF32 operands, three products a
// product (3xTF32), which keeps fp32 accuracy.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace repro_mma {

// bf16 per shared row of a D-wide tile: +16 bytes, so the eight rows an
// ldmatrix reads fall in eight distinct bank groups.
template <int D>
__host__ __device__ constexpr int row_stride() { return D + 8; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !in.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronously; zero-filled when !in.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a . b for one m16n8k16 tile, bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows row0 .. row0 + ROWS - 1 of a (rows, D) bf16 matrix whose rows are
// `stride` elements apart, by THREADS threads, into a shared tile of
// row_stride<D>() columns; rows >= nrows are zero-filled.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void cp_async_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                              int row0, int nrows, size_t stride, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte pieces of a row
#pragma unroll
  for (int i = tid; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    const int s = row0 + r;
    const bool in = s < nrows;
    cp_async16(dst + r * row_stride<D>() + c * 8, src + (size_t)(in ? s : 0) * stride + c * 8,
               in);
  }
}

// Where a lane points ldmatrix in a padded shared tile (`tile` at the
// fragment's first row and column): with ldmatrix_x4, the m16n8k16 A
// fragment of rows 0-15 and k-columns 0-15; with ldmatrix_x4_trans, of a
// tile whose rows are the k index, the two B fragments of n-columns 0-7
// ({r[0], r[1]}) and 8-15 ({r[2], r[3]}).
template <int D>
__device__ __forceinline__ const __nv_bfloat16* a_frag_at(const __nv_bfloat16* tile, int lane) {
  return tile + ((lane & 7) + ((lane >> 3) & 1) * 8) * row_stride<D>() + (lane >> 4) * 8;
}

// Two m16n8k16 B fragments (n-columns 0-7 and 8-15, k 0-15) of a padded
// shared tile whose rows are the n index and columns the k index, for
// ldmatrix_x4: {r[0], r[1]} and {r[2], r[3]}.
template <int D>
__device__ __forceinline__ const __nv_bfloat16* b_frag_at(const __nv_bfloat16* tile, int lane) {
  return tile + ((lane & 7) + (lane >> 4) * 8) * row_stride<D>() + ((lane >> 3) & 1) * 8;
}

// ------------------------------------------------ fp32 on the tensor cores: 3xTF32
//
// TF32 has no ldmatrix (it takes 16-bit elements only), so a lane reads its
// fragment elements with 32-bit shared loads.  Lane (g, t) = (lane / 4,
// lane % 4) reads a tile along its rows (row g, columns t and t + 4: A, or
// B stored as its transpose) or, for B stored with k along the rows, rows
// 2t and 2t + 1 at column g: the k order of acc_a_tf32 below, in which an
// m16n8 accumulator is the next product's A fragment without any lane
// exchanging a value.  A row stride of D + 4 floats, 4 times an odd number,
// puts both reads of a warp on 32 distinct banks (4g + t and 8t + g, up to
// the odd factor), so one stride serves every tile either way.

// floats per shared row of a D-wide fp32 tile (16-byte rows for cp.async).
template <int D>
__host__ __device__ constexpr int f32_stride() { return D + 4; }

// x = hi + lo + O(2^-22 |x|), hi and lo TF32: rounded to nearest, ties
// away from zero, at 10 mantissa bits, as cvt.rna.tf32.f32 rounds a finite
// value, by two integer ops on the bits (2^12 added, the low 13 cleared).
// ptxas expands cvt.rna into five instructions, a compare and a select among
// them, and the splits are most of the fp32 kernels' non-MMA instructions.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
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

// A split fragment: TF32 high and low parts.
template <int N>
struct SplitFrag {
  uint32_t hi[N], lo[N];
};
using FragA = SplitFrag<4>;
using FragB = SplitFrag<2>;

// c += a . b at fp32 accuracy: a_lo b_hi, a_hi b_lo, then a_hi b_hi (the
// small terms first; a_lo b_lo, below fp32's rounding, is dropped).
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const FragA& a, const FragB& b) {
  mma_tf32(c, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(c, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(c, a.hi, b.hi[0], b.hi[1]);
}

// The m16n8k8 A fragment (rows 0-15, k 0-7) of a shared tile with row
// stride S whose rows are the product's rows, split.
template <int S>
__device__ __forceinline__ FragA a_tf32(const float* tile, int g, int t) {
  FragA f;
  split_tf32(tile[g * S + t], f.hi[0], f.lo[0]);
  split_tf32(tile[(g + 8) * S + t], f.hi[1], f.lo[1]);
  split_tf32(tile[g * S + t + 4], f.hi[2], f.lo[2]);
  split_tf32(tile[(g + 8) * S + t + 4], f.hi[3], f.lo[3]);
  return f;
}

// The B fragment (k 0-7, n 0-7) of a shared tile whose rows are n and
// columns k (B^T: K in Q.K^T), split.
template <int S>
__device__ __forceinline__ FragB b_rows_tf32(const float* tile, int g, int t) {
  FragB f;
  split_tf32(tile[g * S + t], f.hi[0], f.lo[0]);
  split_tf32(tile[g * S + t + 4], f.hi[1], f.lo[1]);
  return f;
}

// The B fragment of a shared tile whose rows are k and columns n (V in
// P.V), in acc_a_tf32's k order: k = t is row 2t, k = t + 4 row 2t + 1.
template <int S>
__device__ __forceinline__ FragB b_pairs_tf32(const float* tile, int g, int t) {
  FragB f;
  split_tf32(tile[2 * t * S + g], f.hi[0], f.lo[0]);
  split_tf32(tile[(2 * t + 1) * S + g], f.hi[1], f.lo[1]);
  return f;
}

// One n-tile of an m16n8 accumulator (the lane's columns 2t, 2t + 1 of rows
// g, g + 8) as the A fragment of a product over those 8 columns, split, in
// the k order that b_pairs_tf32 reads: k = t is column 2t, k = t + 4
// column 2t + 1.
__device__ __forceinline__ FragA acc_a_tf32(const float (&c)[4]) {
  FragA f;
  split_tf32(c[0], f.hi[0], f.lo[0]);
  split_tf32(c[2], f.hi[1], f.lo[1]);
  split_tf32(c[1], f.hi[2], f.lo[2]);
  split_tf32(c[3], f.hi[3], f.lo[3]);
  return f;
}

// out[n] += X . cols for the NW n-tiles of 8 columns at cols + 8 n, X the
// warp's 16 rows over the tile's 8 NK rows of `cols` (a shared tile with
// row stride S, its rows the k index), given as NK split A fragments in
// acc_a_tf32's k order.  Each group of n-tiles (4, or 8 where a warp holds
// 16 or more: 3 % faster in K3b's dkdv at D = 256, where 8 with 32-key
// tiles at D = 64 made dq 23 % slower; torch_kernel_probe.py f32-split
// --tiles) is summed over the tile in fresh accumulators, then added to
// `out` by fp32 adds, which round to nearest: a running sum kept in the
// accumulator itself takes the tensor cores' rounding at every product,
// which drifted past fp32's accuracy over a head's 1024 queries.
template <int S, int NK, int NW>
__device__ __forceinline__ void mma_pairs_add(float (&out)[NW][4], const FragA (&x)[NK],
                                              const float* cols, int g, int t) {
  constexpr int NG = NW >= 16 ? 8 : NW < 4 ? NW : 4;
#pragma unroll
  for (int n0 = 0; n0 < NW; n0 += NG) {
    float tmp[NG][4];
#pragma unroll
    for (int n = 0; n < NG; ++n) tmp[n][0] = tmp[n][1] = tmp[n][2] = tmp[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
#pragma unroll
      for (int n = 0; n < NG; ++n)
        mma_3xtf32(tmp[n], x[kk], b_pairs_tf32<S>(cols + kk * 8 * S + (n0 + n) * 8, g, t));
#pragma unroll
    for (int n = 0; n < NG; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[n0 + n][e] += tmp[n][e];
  }
}

// Rows row0 .. row0 + ROWS - 1 of a (rows, D) fp32 matrix whose rows are
// `stride` elements apart, by THREADS threads, into a shared tile of
// f32_stride<D>() floats a row, in 16-byte pieces; rows >= nrows are
// zero-filled.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void cp_async_rows_f32(float* dst, const float* src, int row0,
                                                  int nrows, size_t stride, int tid) {
  constexpr int kChunks = D / 4;  // 16-byte pieces of a row
#pragma unroll
  for (int i = tid; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    const int s = row0 + r;
    const bool in = s < nrows;
    cp_async16(dst + r * f32_stride<D>() + c * 4, src + (size_t)(in ? s : 0) * stride + c * 4,
               in);
  }
}

// The `threads` threads of named barrier `id` (1-15; __syncthreads is 0)
// wait for each other.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Where D is split between two warps of a 16-row group (the fp32 instances
// at D = 256), each warp holds a partial sum over its half of D of N m16n8
// tiles; after this both hold the whole sum, bit for bit the same (fp32
// addition commutes).  `xs` holds 2 x N x 4 x 32 floats for the pair; a
// lane's partner holds the same positions, so each writes its own slots and
// reads the partner's at its own lane.  The caller keeps `xs` from being
// written again until both warps have read it (a __syncthreads).
template <int N>
__device__ __forceinline__ void pair_sum(float (&acc)[N][4], float* xs, int half, int pair,
                                         int lane) {
  float* mine = xs + half * (N * 4 * 32);
  const float* other = xs + (half ^ 1) * (N * 4 * 32);
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mine[(4 * j + e) * 32 + lane] = acc[j][e];
  bar_sync(1 + pair, 64);
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += other[(4 * j + e) * 32 + lane];
}

}  // namespace repro_mma
