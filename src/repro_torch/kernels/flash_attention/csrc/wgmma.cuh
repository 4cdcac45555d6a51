// Warpgroup-product (wgmma) helpers of K3b's bf16 design at head dim 256
// (flash_attention_bwd.cu), sm_90a.
//
// A tile of ROWS rows by D bf16 columns lies in shared memory as D / 64
// column blocks of ROWS x 128 bytes, one after the other; row r of a block
// sits at r * 128 and its eight 16-byte pieces are permuted, piece c at
// (c ^ (r % 8)) * 16.  That is the 128-byte swizzle wgmma reads when every
// block starts on a 1024-byte boundary, and it spreads the eight rows of a
// core matrix over all 32 banks.  cp_async_tile fills such a tile from a
// (rows, D) matrix in device memory by 16-byte cp.async pieces.
//
// Operands are read through matrix descriptors: desc_k for a K-major tile
// (the reduction runs along its rows' D columns: Q.K^T and its kin), desc_mn
// for an MN-major B operand (the reduction runs down its rows: P^T.dO,
// dS^T.Q, dS.K).  Two products are used: m64n64k16 with A and B in shared
// memory, and m64n256k16 with A in registers (an accumulator rounded to
// bf16, in mma.sync's A-fragment layout) and B in shared memory.  A wgmma
// runs asynchronously: fence() before it when its registers were written by
// other instructions, commit() and wait<N>() after, then keep() on every
// register it read or wrote, so the compiler neither reads an accumulator
// nor reuses an operand's register before the product has finished.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma.cuh"

namespace repro_wgmma {

// Rows row0 .. row0 + ROWS - 1 of a (rows, D) bf16 matrix whose rows are
// `stride` elements apart, by THREADS threads, into the swizzled tile at
// `tile` (1024-byte aligned); rows >= nrows are zero-filled.
// A thread copies one 16-byte piece column c of rows r0, r0 + kStep, ...,
// so its addresses are set once and stepped.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void cp_async_tile(unsigned char* tile, const __nv_bfloat16* src,
                                              int row0, int nrows, size_t stride, int tid) {
  constexpr int kPieces = D / 8;  // 16-byte pieces of a row
  static_assert(THREADS % kPieces == 0 && ROWS % (THREADS / kPieces) == 0, "whole passes");
  constexpr int kStep = THREADS / kPieces;  // rows a pass covers
  const int c = tid % kPieces;
  const int r0 = tid / kPieces;
  unsigned char* dst = tile + (c >> 3) * (ROWS * 128) + r0 * 128;
  const __nv_bfloat16* from = src + (size_t)(row0 + r0) * stride + c * 8;
#pragma unroll
  for (int m = 0; m < ROWS / kStep; ++m) {
    const int r = r0 + m * kStep;
    const bool in = row0 + r < nrows;
    repro_mma::cp_async16(dst + m * kStep * 128 + (((c & 7) ^ (r & 7)) << 4), in ? from : src,
                          in);
    from += kStep * stride;
  }
}

// A shared-memory matrix descriptor with the 128-byte swizzle: the start
// address, the leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((repro_mma::smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// The K-major operand of 64 rows (rows 0-63 of a ROWS-row tile) and the
// reduction columns 16 kk .. 16 kk + 15: eight-row groups 1024 bytes apart;
// a step of 16 columns moves 32 bytes inside a swizzled row, or to the
// next column block.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k(const unsigned char* tile, int kk) {
  return desc(tile + (kk >> 2) * (ROWS * 128) + (kk & 3) * 32, 16, 1024);
}

// The MN-major B operand of rows 16 kk .. 16 kk + 15 (the reduction) and all
// D columns (N): column blocks ROWS x 128 bytes apart, eight-row groups 1024.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn(const unsigned char* tile, int kk) {
  return desc(tile + kk * 16 * 128, ROWS * 128, 1024);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared memory written by ordinary stores or cp.async, made visible to
// wgmma's reads (the async proxy); before the barrier that publishes it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D (64 x 64, fp32) = D * scale_d + A . B over 16 columns, A and B K-major
// tiles in shared memory.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, "
      "0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 256, fp32) = D * scale_d + A . B over 16 rows of B: A (64 x 16)
// in registers, B an MN-major tile in shared memory.
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128], const uint32_t (&a)[4],
                                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, "
      "%73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, "
      "%91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, "
      "%107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// Named barrier `id` over `n` threads: arrive without waiting, or wait.
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

}  // namespace repro_wgmma
