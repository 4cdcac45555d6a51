// The per-shard work of one round of sharded window scheduling, for Hopper,
// sm_90a.
//
// Replaces the per-shard programs of the reference's sharded pipeline
// (src/repro/core/shard.py:162 `_sharded_select_program`, :368
// `_sharded_mw_program`, :460 `_sharded_mw_spec_program`; `shard_map`ped
// XLA, no Pallas kernel).  A sharded window (core/shard.py) splits its
// decision tables by rows (the per-request and grouped selectors) or by
// workers (Eq. 15 placement) into one block per shard; the host loop over
// the rounds calls two entry points:
//
//   score_block  one shard's block of rows scored against a carry per row
//                (or one carry for every row): step.cuh's step on each
//                row — residency and completions (t + swap_eff) + lat, the
//                Eq. 2 tile, the member means in member order — then the
//                block's pick per row: the maximum utility and, among
//                equal utilities, the least tie-break rank, over the
//                block's (worker, model) cells (invalid models and padded
//                workers -inf).  Out per row: the utility, the pick's raw
//                and effective swap, its latency and completion (float64),
//                the pick, its rank and its model id (int64).  Speculation
//                and validation both call it; the exact cross-shard pick
//                (max utility, then min rank) is the caller's.
//   chain        the carry reconstruction of a round from the gathered
//                picks: one thread applies n decisions (worker, model id,
//                raw swap, latency) one after the other — the completion
//                (t + (resident ? 0 : swap)) + lat, the slot1 id or
//                lru.cuh's touch — and writes the n + 1 states (the
//                pre-state of every position, then the state after the
//                last).
//
// Numerics: compiled with --fmad=false, like the two scans whose step it
// shares (../../selection_scan/csrc/step.cuh: scoring and the carry
// update; ../../utility/csrc/penalty.cuh: Eq. 2's multiply/divide-only
// sigmoid; lru.cuh: the touch).  Every row's bits are those the
// sequential scan computes for the same carry, so splitting the rows over
// shards cannot change a decision; the pick's order (max value, then min
// rank, then the first cell) is the reference's local all-reduce key.
//
// What bounds it: a round's rows are independent, so score_block runs one
// block per row (the row's cells over the block's threads, as the
// sequential scan's step runs); a row of a per-request policy has W * M
// cells, most threads idle.  The chain is a dependent chain of 2 adds and
// a store per position on one thread (its state in shared memory, the
// rows written to device memory, never read back).  The simple design:
// spreading a round over SMs better is later work.  The launches use the
// caller's stream, synchronise nothing and allocate nothing; the wrapper
// (ops.py) allocates the outputs and the scratch tile.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../selection_scan/csrc/step.cuh"

namespace {

constexpr int kScoreThreads = 128;
constexpr int kChainThreads = 32;

// Shared bytes of a score_block launch: one row's (W, M) completions and
// means (8 bytes each), its pick and its (W, M) residency flags.
size_t score_smem_bytes(int W, int M) {
  const size_t wm = (size_t)W * M;
  return 16 * wm + 8 + wm;
}

// Shared bytes of a chain launch: the carry's (W, K) slots and (W,) tails.
size_t chain_smem_bytes(int W, int K) { return 8 * ((size_t)W * K + W); }

__global__ void __launch_bounds__(kScoreThreads) shard_round_score(
    ScanArgs p, const double* t, int ts, const int64_t* r, int rs, const int64_t* rank,
    const unsigned char* wvalid, double* outf, int64_t* outi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int row = blockIdx.x;
  const int W = p.W, M = p.M, R = p.S;
  const int wm = W * M;
  StepRows rows;
  rows.comp = reinterpret_cast<double*>(smem_raw);  // (W, M)
  rows.umean = rows.comp + wm;                      // (W, M)
  int* pick = reinterpret_cast<int*>(rows.umean + wm);
  rows.flag = reinterpret_cast<unsigned char*>(smem_raw + 16 * (size_t)wm + 8);  // (W, M)

  // The row is step `row` of the block's tables; its tile rows are its own.
  ScanArgs q = p;
  if (p.tile != nullptr) q.tile = p.tile + (size_t)row * W * p.B * M;
  score_steps<true>(q, rows, row, 0, 1, t + (size_t)row * ts, 0, r + (size_t)row * rs, 0, pick);
  if (threadIdx.x != 0) return;

  // Thread 0 wrote the fixed pick itself; phases A and C ended in barriers.
  const int a = static_cast<int>(p.step_app[row]);
  const int64_t* rk = rank + (size_t)a * wm;
  int best;
  double ub;
  int64_t rb;
  if (p.fixed != nullptr) {
    best = *pick;
    ub = 0.0;  // not scored: a fixed choice has no utility to compare
    rb = rk[best];
  } else {
    best = 0;
    ub = (wvalid == nullptr || wvalid[0]) ? rows.umean[0] : -INFINITY;
    rb = rk[0];
    for (int c = 1; c < wm; ++c) {
      const double u = (wvalid == nullptr || wvalid[c / M]) ? rows.umean[c] : -INFINITY;
      if (u > ub || (u == ub && rk[c] < rb)) {
        best = c;
        ub = u;
        rb = rk[c];
      }
    }
  }
  const int w = best / M;
  const int m = best - w * M;
  const double sw = p.swap[((size_t)a * W + w) * M + m];
  outf[row] = ub;
  outf[(size_t)R + row] = sw;
  outf[2 * (size_t)R + row] = rows.flag[best] ? 0.0 : sw;
  outf[3 * (size_t)R + row] = p.lat[((size_t)row * W + w) * M + m];
  outf[4 * (size_t)R + row] = rows.comp[best];
  outi[row] = best;
  outi[(size_t)R + row] = rb;
  outi[2 * (size_t)R + row] = p.gid[(size_t)a * M + m];
}

__global__ void __launch_bounds__(kChainThreads) shard_round_chain(
    ScanArgs p, int n, const int64_t* wi, const int64_t* g, const double* sw, const double* lt,
    double* t_st, int64_t* r_st) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = p.W, K = p.K;
  const int wk = W * K;
  int64_t* r = reinterpret_cast<int64_t*>(smem_raw);  // (W, K) slots
  double* t = reinterpret_cast<double*>(r + wk);      // (W,) tails
  for (int i = threadIdx.x; i < wk; i += blockDim.x) r[i] = p.res0[i];
  for (int i = threadIdx.x; i < W; i += blockDim.x) t[i] = p.t0[i];
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int k = 0;; ++k) {
    double* t_row = t_st + (size_t)k * W;
    int64_t* r_row = r_st + (size_t)k * wk;
    for (int i = 0; i < W; ++i) t_row[i] = t[i];
    for (int i = 0; i < wk; ++i) r_row[i] = r[i];
    if (k == n) break;
    const int w = static_cast<int>(wi[k]);
    const int64_t gk = g[k];
    const bool was = resident_in(p, r + (size_t)w * K, gk);
    advance(p, w, gk, was, (t[w] + (was ? 0.0 : sw[k])) + lt[k], t, r);
  }
}

// Opts a kernel in to `smem` bytes past the default 48 KiB; refuses a sum
// beyond the device's per-block maximum (the wrapper refuses it first).
cudaError_t fit_smem(const void* kernel, size_t smem) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return err;
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// score_block: every pointer a tensor on the current device.  `t` holds
// (R, W) tails at row stride `ts` (0: one carry for every row), `r` (R, W,
// K) slots at row stride `rs`; the tables as ScanArgs says with S = R
// (`lat` (R, W, M), `swap` (A, W, M); no preference permutation: the
// step's own pick is skipped), `rank` (A, W * M) the tie-break ranks,
// `wvalid` (W,) or null, `fixed` (R,) or null, `tile` (R, W, B, M) scratch
// (null with fixed choices);
// `outf` (5, R) float64 and `outi` (3, R) int64.  One block per row.
// Returns a cudaError_t (0 on success).
int shard_round_score_f64(const void* t, int ts, const void* r, int rs, const void* acc,
                          const void* mask, const void* deadlines, const void* bsize,
                          const void* lat, const void* step_app, const void* swap,
                          const void* gid, const void* valid, const void* pen, const void* rank,
                          const void* wvalid, const void* fixed, void* tile,
                          void* outf, void* outi, int R, int B, int M, int W, int K, int slot1,
                          void* stream) {
  if (R < 1 || B < 1 || M < 1 || W < 1 || K < 1 || ts < 0 || rs < 0 || (slot1 && K != 1) ||
      (fixed == nullptr && tile == nullptr) || (size_t)R * W * B * M >> 32) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = score_smem_bytes(W, M);
  cudaError_t err = fit_smem(reinterpret_cast<const void*>(shard_round_score), smem);
  if (err != cudaSuccess) return (int)err;
  ScanArgs a;
  a.t0 = nullptr;
  a.res0 = nullptr;
  a.sizes = nullptr;
  a.acc = static_cast<const double*>(acc);
  a.mask = static_cast<const double*>(mask);
  a.deadlines = static_cast<const double*>(deadlines);
  a.bsize = static_cast<const double*>(bsize);
  a.lat = static_cast<const double*>(lat);
  a.step_app = static_cast<const int64_t*>(step_app);
  a.swap = static_cast<const double*>(swap);
  a.gid = static_cast<const int64_t*>(gid);
  a.valid = static_cast<const unsigned char*>(valid);
  a.pen = static_cast<const int64_t*>(pen);
  a.pref = nullptr;  // the block's own pick (below) replaces the step's
  a.fixed = static_cast<const int64_t*>(fixed);
  a.tile = static_cast<double*>(tile);
  a.out = nullptr;
  a.cap = 0.0;
  a.S = R;
  a.B = B;
  a.M = M;
  a.W = W;
  a.K = K;
  a.G = 0;
  a.slot1 = slot1;
  a.ld = 0;
  shard_round_score<<<R, kScoreThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const double*>(t), ts, static_cast<const int64_t*>(r), rs,
      static_cast<const int64_t*>(rank), static_cast<const unsigned char*>(wvalid),
      static_cast<double*>(outf), static_cast<int64_t*>(outi));
  return (int)cudaGetLastError();
}

// chain: `t0` (W,) tails and `res0` (W, K) slots of the carry before the
// first position, `sizes` (W, G) bytes per id (lru only) and `cap`; the n
// positions' worker `wi`, model id `g`, raw swap `sw` and latency `lt`;
// `t_st` (n + 1, W) and `r_st` (n + 1, W, K) the states out.  One thread
// applies the positions.  Returns a cudaError_t (0 on success).
int shard_round_chain_f64(const void* t0, const void* res0, const void* sizes, double cap,
                          const void* wi, const void* g, const void* sw, const void* lt,
                          void* t_st, void* r_st, int n, int W, int K, int G, int slot1,
                          void* stream) {
  if (n < 0 || W < 1 || K < 1 || (slot1 && K != 1) || (!slot1 && G < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = chain_smem_bytes(W, K);
  cudaError_t err = fit_smem(reinterpret_cast<const void*>(shard_round_chain), smem);
  if (err != cudaSuccess) return (int)err;
  ScanArgs a = {};
  a.t0 = static_cast<const double*>(t0);
  a.res0 = static_cast<const int64_t*>(res0);
  a.sizes = static_cast<const double*>(sizes);
  a.cap = cap;
  a.W = W;
  a.K = K;
  a.G = G;
  a.slot1 = slot1;
  shard_round_chain<<<1, kChainThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a, n, static_cast<const int64_t*>(wi), static_cast<const int64_t*>(g),
      static_cast<const double*>(sw), static_cast<const double*>(lt),
      static_cast<double*>(t_st), static_cast<int64_t*>(r_st));
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
