// Eq. 2 utility kernel with the Eq. 13 column sums, for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `utility_scores_pallas`
// (src/repro/kernels/utility/kernel.py): over an (R, M) tile of
// (request, model) pairs,
//
//     U[r, m] = A[r, m] * (1 - clip(gamma(d[r], E[r, m]), 0, 1))
//
// with a static deadline penalty gamma (none / step / linear / sigmoid),
// plus, when asked, the column sums of U over the R rows.
//
// Numerics.  The scheduling path runs the double instance, which must equal
// the reference's numpy arithmetic bit for bit, or near-tied group
// utilities pick other models:
//   * this file is compiled with --fmad=false, so no multiply-add is fused;
//   * the sigmoid's ratio^-3 uses only `*` and `/` (correctly rounded);
//   * a column is summed by one thread, row after row from 0, exactly the
//     order of `sequential_mean` (src/repro/core/fastpath.py:658).
// The float instance computes what the Pallas kernel computes.
//
// What bounds it on the H100: neither bytes nor flops.  A group tile is a
// few hundred KB at most, which the card moves in well under a
// microsecond; the call costs a launch, the fill (up to four correctly
// rounded divisions per pair) and the ordered column sum, a chain of R
// dependent adds (8.2 cycles each in f64 on the H100).  The design:
//   * with the sums, ONE cluster launch of 2 to 8 blocks (the portable
//     cluster size).  Blocks 1..P fill the tile, one chunk of rows each
//     (whole groups of 8 rows), into device memory and, by asynchronous
//     stores through distributed shared memory (st.async), into a slot of
//     block 0's shared memory, column by column; the slot's mbarrier counts
//     the bytes as they land, so no block fences or signals.  Block 0 waits
//     on each chunk's mbarrier in row order and adds it from its own shared
//     memory, one thread per column (the M threads of its first block row),
//     each column one chain, row 0 first.  Where the tile does not fit
//     block 0 (224 KB), each filling block has a ring of two slots in turn,
//     and block 0 tells it by a counter when a slot is free again.  (A wait
//     costs about 0.2 us, so more and smaller chunks measured slower.)
//     Nothing outlives the call in device memory;
//   * without the sums (evaluate's per-entry (N, 1) tiles), a plain grid of
//     blocks fills the tile;
//   * a block is M x (256 / M) threads: a thread's column and row come from
//     its 2-D index, with no division.
// Completions may be a full (R, M) tile or one (M,) row shared by every
// request (grouped selection), through their row stride; evaluate's
// per-entry scoring is the M = 1 column tile, one deadline per row.  The
// launch plan (block rows, cluster size, chunk rows, blocks) is computed by
// the Python wrapper (`utility_plan` in ops.py) and validated here.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "penalty.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCluster = 8;       // portable cluster size
constexpr int kMaxSmem = 232448;     // 227 KB a block may use

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t cluster_addr(const void* p, unsigned rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote)
               : "r"(smem_addr(p)), "r"(rank));
  return remote;
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// One arrival on this block's mbarrier, which now also waits for `bytes`
// of asynchronous stores.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}
// Wait for the phase of parity `parity` of this block's mbarrier.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}
// Store v at `addr` of another block's shared memory; its mbarrier at
// `bar` counts the bytes when they have landed.
__device__ __forceinline__ void store_async(uint32_t addr, double v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];"
               ::"r"(addr), "l"(__double_as_longlong(v)), "r"(bar) : "memory");
}
__device__ __forceinline__ void store_async(uint32_t addr, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               ::"r"(addr), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}
// Release store of `value` to the counter at `counter` of cluster block `rank`.
__device__ __forceinline__ void signal_remote(unsigned* counter, unsigned rank, unsigned value) {
  asm volatile("st.release.cluster.shared::cluster.u32 [%0], %1;"
               ::"r"(cluster_addr(counter, rank)), "r"(value) : "memory");
}
// Wait until this block's counter reaches `value` (counters only grow).
__device__ __forceinline__ void wait_for(const unsigned* counter, unsigned value) {
  unsigned seen;
  do {
    asm volatile("ld.relaxed.cluster.shared::cta.u32 %0, [%1];" : "=r"(seen)
                 : "r"(smem_addr(counter)) : "memory");
  } while (seen < value);
  asm volatile("fence.acq_rel.cluster;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

constexpr int kRowsInFlight = 8;  // rows a thread loads before it computes any

// Rows [r0, r1) of U: thread (m, y) takes column m of rows r0 + y,
// r0 + y + blockDim.y, ...; with dst (a cluster address) also into another
// block's shared memory, column by column (row r of column m at element
// m * dst_stride + r - r0), counted by its mbarrier at `bar`.
// A thread's rows go kRowsInFlight at a time: all their loads, then the
// values, so the loads and the divisions of the rows overlap.
template <typename T>
__device__ __forceinline__ void fill_rows(const T* __restrict__ acc,
                                          const T* __restrict__ deadlines,
                                          const T* __restrict__ comp, int comp_row_stride,
                                          T* __restrict__ u, uint32_t dst, uint32_t bar,
                                          int dst_stride, int r0, int r1, int M,
                                          int penalty) {
  const int m = threadIdx.x;
  const int by = blockDim.y;
  for (int r = r0 + threadIdx.y; r < r1; r += kRowsInFlight * by) {
    T a[kRowsInFlight], dl[kRowsInFlight], e[kRowsInFlight];
#pragma unroll
    for (int i = 0; i < kRowsInFlight; ++i) {
      const int ri = r + i * by;
      if (ri < r1) {
        a[i] = acc[(size_t)ri * M + m];
        dl[i] = deadlines[ri];
        e[i] = comp[(size_t)ri * comp_row_stride + m];
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsInFlight; ++i) {
      const int ri = r + i * by;
      if (ri < r1) {
        const T v = eq2_utility<T>(penalty, a[i], dl[i], e[i]);
        u[(size_t)ri * M + m] = v;
        if (dst != 0) store_async(dst + (m * dst_stride + ri - r0) * sizeof(T), v, bar);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
utility_fill_kernel(const T* __restrict__ acc, const T* __restrict__ deadlines,
                    const T* __restrict__ comp, int comp_row_stride, T* __restrict__ u, int R,
                    int M, int penalty, int rows_per_block) {
  const int r0 = blockIdx.x * rows_per_block;
  fill_rows<T>(acc, deadlines, comp, comp_row_stride, u, 0, 0, 0, r0,
               min(R, r0 + rows_per_block), M, penalty);
}

// s + col[0] + col[1] + ... + col[rows - 1], in that order: groups of 8
// loads, then their 8 adds.  (Interleaving one group's loads with another's
// adds measured slower on the H100: 16 against 10 cycles a row.)
template <typename T>
__device__ __forceinline__ T add_column(const T* col, int rows, T s) {
  int r = 0;
  for (; r + 8 <= rows; r += 8) {
    T w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j] = col[r + j];
#pragma unroll
    for (int j = 0; j < 8; ++j) s = s + w[j];
  }
  for (; r < rows; ++r) s = s + col[r];
  return s;
}

// The cluster launch with the sums.  Blocks 1..P fill chunk c (rows
// [c * chunk_rows, ...)) in round t = c / P and store it asynchronously
// into block 0's slot (t % slots, block - 1); the slot's mbarrier counts
// the bytes, so block 0 waits on it and adds the chunks in row order from
// its own shared memory.  Where the tile fits there is one round (one slot
// per filling block); else each filling block has a ring of two slots, and
// block 0 also tells it when a slot is free again by a counter that only
// grows.
template <typename T>
__global__ void __launch_bounds__(kThreads)
utility_sums_kernel(const T* __restrict__ acc, const T* __restrict__ deadlines,
                    const T* __restrict__ comp, int comp_row_stride, T* __restrict__ u,
                    T* __restrict__ sums, int R, int M, int penalty, int chunk_rows,
                    int slots) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int P = (int)cluster.num_blocks() - 1;  // filling blocks
  const int chunks = (R + chunk_rows - 1) / chunk_rows;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  __shared__ uint64_t full[2 * (kMaxCluster - 1)];  // block 0: a slot's bytes landed
  __shared__ unsigned summed;                       // filling blocks: chunks added
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);  // block 0: slots x P x M x stride
  // A slot holds its chunk column by column; the padding puts the columns
  // the summing threads read at once in different banks.
  const int stride = chunk_rows + 16 / sizeof(T);
  const int slot_elems = M * stride;
  auto chunk_bytes = [&](int c) {
    return (unsigned)(min(chunk_rows, R - c * chunk_rows) * M * sizeof(T));
  };

  if (tid == 0) {
    if (rank == 0) {
      for (int i = 0; i < slots * P && i < chunks; ++i) {  // slot i takes chunk i first
        mbar_init(&full[i], 1);
        mbar_expect(&full[i], chunk_bytes(i));
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    summed = 0;
  }
  // Every block runs, and every barrier is armed, before any remote access.
  cluster_arrive();
  cluster_wait();

  if (rank == 0) {
    // The first M threads sum a column each; the rest of their warps walk
    // along (column 0, never written) so the walk does not diverge.
    T s = T(0);
    const bool walker = tid < ((M + 31) & ~31);
    const int col = tid < M ? tid : 0;
    for (int c = 0; c < chunks; ++c) {
      const int b = 1 + c % P;
      const int t = c / P;
      const int slot = (t % slots) * P + b - 1;
      if (walker) {
        mbar_wait(&full[slot], (t / slots) & 1);
        s = add_column<T>(buf + slot * slot_elems + col * stride,
                          min(chunk_rows, R - c * chunk_rows), s);
      }
      if (slots < (chunks + P - 1) / P) {  // a ring: free the slot for its next chunk
        __syncthreads();  // every column is done with the slot
        if (tid == 0 && c + slots * P < chunks) {
          mbar_expect(&full[slot], chunk_bytes(c + slots * P));
          signal_remote(&summed, b, t + 1);
        }
      }
    }
    if (tid < M) sums[tid] = s;
  } else {
    for (int t = 0, c = rank - 1; c < chunks; ++t, c += P) {
      if (t >= slots) wait_for(&summed, t - slots + 1);  // the slot's last chunk is added
      const int slot = (t % slots) * P + rank - 1;
      const int r0 = c * chunk_rows;
      fill_rows<T>(acc, deadlines, comp, comp_row_stride, u,
                   cluster_addr(buf + slot * slot_elems, 0), cluster_addr(&full[slot], 0),
                   stride, r0, min(R, r0 + chunk_rows), M, penalty);
    }
  }
  // No block leaves while its shared memory may still be written.
  cluster_arrive();
  cluster_wait();
}

template <typename T>
int launch(const void* acc, const void* d, const void* e, int e_stride, void* u, void* sums,
           int R, int M, int penalty, int block_rows, int cluster, int chunk_rows, int blocks,
           int slots, void* stream) {
  if (R <= 0 || M <= 0 || M > kThreads || penalty < kNone || penalty > kSigmoid ||
      (e_stride != 0 && e_stride != M) || block_rows < 1 || block_rows * M > kThreads ||
      chunk_rows < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const T* a = static_cast<const T*>(acc);
  const T* dl = static_cast<const T*>(d);
  const T* cm = static_cast<const T*>(e);
  T* uu = static_cast<T*>(u);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(M, block_rows);
  const long long chunks = (R + (long long)chunk_rows - 1) / chunk_rows;
  if (sums == nullptr) {
    if (blocks != chunks) return (int)cudaErrorInvalidValue;  // a chunk per block
    utility_fill_kernel<T><<<blocks, block, 0, st>>>(a, dl, cm, e_stride, uu, R, M, penalty,
                                                     chunk_rows);
    return (int)cudaGetLastError();
  }
  const int fill = cluster - 1;
  if (cluster < 2 || cluster > kMaxCluster || chunks < fill ||  // a filling block idle
      chunk_rows % 8 != 0 || slots < 1 || slots > 2 || slots > (chunks + fill - 1) / fill) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)slots * fill * M * (chunk_rows + 16 / sizeof(T)) * sizeof(T);
  if (smem > kMaxSmem - 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(utility_sums_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster);
  config.blockDim = block;
  config.dynamicSmemBytes = smem;
  config.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&config, utility_sums_kernel<T>, a, dl, cm, e_stride, uu,
                                       static_cast<T*>(sums), R, M, penalty, chunk_rows, slots);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// acc, u (R, M); deadlines (R,); completions (R, M) with e_stride = M, or
// (M,) with e_stride = 0; sums (M,) or null.  Contiguous, current device.
// The plan: blocks of M x block_rows threads and chunks of chunk_rows rows
// (with sums, a multiple of 8).  With sums, one cluster of `cluster` blocks
// (2..8), every filling block with a chunk, and `slots` chunk slots per
// filling block in block 0's shared memory (1, or 2 as a ring); without,
// `blocks` blocks, one chunk each.
int utility_scores_f64(const void* acc, const void* d, const void* e, int e_stride, void* u,
                       void* sums, int R, int M, int penalty, int block_rows, int cluster,
                       int chunk_rows, int blocks, int slots, void* stream) {
  return launch<double>(acc, d, e, e_stride, u, sums, R, M, penalty, block_rows, cluster,
                        chunk_rows, blocks, slots, stream);
}

int utility_scores_f32(const void* acc, const void* d, const void* e, int e_stride, void* u,
                       void* sums, int R, int M, int penalty, int block_rows, int cluster,
                       int chunk_rows, int blocks, int slots, void* stream) {
  return launch<float>(acc, d, e, e_stride, u, sums, R, M, penalty, block_rows, cluster,
                       chunk_rows, blocks, slots, stream);
}

const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
