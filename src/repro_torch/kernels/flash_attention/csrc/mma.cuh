// Tensor-core and async-copy helpers shared by the bf16 instances of flash
// attention's forward (flash_attention.cu) and backward
// (flash_attention_bwd.cu), sm_90a: cp.async copies into shared tiles whose
// rows are padded by 16 bytes, ldmatrix fragment loads, and
// mma.sync.m16n8k16 with bf16 in and fp32 accumulate.
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

}  // namespace repro_mma
