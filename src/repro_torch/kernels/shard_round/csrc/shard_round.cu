// The per-shard work of one round of sharded window scheduling, for Hopper,
// sm_90a.
//
// Replaces the per-shard programs of the reference's sharded pipeline
// (src/repro/core/shard.py:162 `_sharded_select_program`, :368
// `_sharded_mw_program`, :460 `_sharded_mw_spec_program`; `shard_map`ped
// XLA, no Pallas kernel).  A sharded window (core/shard.py) splits its
// decision tables by rows (the per-request and grouped selectors) or by
// workers (Eq. 15 placement) into one block per shard; the rounds call
// three entry points:
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
//                picks: n decisions (worker, model id, raw swap, latency)
//                applied one after the other — the completion (t +
//                (resident ? 0 : swap)) + lat, the slot1 id or lru.cuh's
//                touch — writing the n + 1 states (the pre-state of every
//                position, then the state after the last).
//   accept       the end of a round: the first conflict between the
//                speculated and validated picks, the accepted rows written
//                at the round's position, the carry moved by the last
//                accepted decision, the position advanced.
//
// A round that runs without reading anything back: with `pos` given (a
// device int64, the window's next undecided position), score_block scores
// the rows of [pos + lo, pos + hi) its block holds (`row0` the block's
// first row of the window, `total` the window's rows), the chain applies
// the decisions that precede a real position, and accept advances `pos`;
// each does nothing once `pos` has reached `total`.  So the host can
// enqueue the rounds a window needs if nothing conflicts and read `pos`
// back once.
//
// Numerics: compiled with --fmad=false, like the two scans whose step it
// shares (../../selection_scan/csrc/step.cuh: scoring and the carry
// update; ../../utility/csrc/penalty.cuh: Eq. 2's multiply/divide-only
// sigmoid; lru.cuh: the touch).  Every row's bits are those the
// sequential scan computes for the same carry, so splitting the rows over
// shards cannot change a decision; the pick's order (max value, then min
// rank, then the first cell) is the reference's local all-reduce key.
//
// What bounds it, and the second design:
//   * score_block: a round's rows are independent.  A row of at most 32
//     (worker, member, model) cells (per-request rows) takes one warp, a
//     lane a cell, eight rows to a block: the completion, Eq. 2 value and
//     member mean in registers and shuffles (ahead.cuh's warp step), the
//     pick a warp reduction over the rank order.  A wider row (a group of
//     up to 1,232 members) spreads its Eq. 2 tile over a cluster of
//     `blocks` blocks on neighbouring SMs, each a slice (step.cuh's
//     `pass_tile`, the routine of the chunked scan's large rounds) written
//     into the leader block's shared memory through distributed shared
//     memory, then a cluster barrier and the leader's member chains from
//     its own shared memory.
//   * chain: a dependent chain of 2 adds and a touch per position on one
//     thread.  The block's other warps stage the next tile of positions'
//     inputs (worker, id, swap, latency) into shared memory and write the
//     last tile's states out while thread 0 chains the current tile from
//     shared memory into a shared-memory buffer; the LRU sizes are staged
//     once.  On one worker thread 0 carries the tail (and the slot1 id) in
//     registers and loads the inputs ahead of the chain: eight positions'
//     at a time with one slot, a position ahead with LRU slots.  A carry too wide for two tiles of states beside it takes the
//     direct form: the carry in shared memory, every state written
//     straight to device memory.
//   * accept: one block; a ballot finds the conflict, a thread a row
//     writes the outputs.
// The launches use the caller's stream, synchronise nothing and allocate
// nothing; the wrapper (ops.py) allocates the outputs and the scratch tile.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../selection_scan/csrc/step.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowWarps = 8;        // score_block's warp instance: rows a block
constexpr int kWideThreads = 256;   // score_block's wide rows: threads a block
constexpr int kMaxBlocks = 8;       // blocks of a cluster (the portable size)
constexpr int kChainThreads = 256;
constexpr int kChainTile = 256;     // positions a staged tile, at most
constexpr int kChainMinTile = 8;    // below it the chain takes the direct form
constexpr int kUnroll = 8;          // slot1 positions whose inputs load together
constexpr int kAcceptThreads = 256;
constexpr long long kRankInf = 1LL << 62;  // a padded worker's rank (ref.py's RANK_INF)

__host__ __device__ size_t align8(size_t n) { return (n + 7) & ~size_t(7); }

// Which rows a score_block launch scores: row slot j of the launch is row
// g = max(p + lo, row0) + j of the window (p = *pos, 0 without one), real
// while g < min(p + hi, row0 + R, total); it reads the block's row g -
// row0 and its carry, and writes its outputs, at g - p - lo.
struct RowMap {
  const int64_t* pos;
  int lo, hi, row0, total, R, ld;  // ld: the outputs' row stride
};

__device__ __forceinline__ bool map_row(const RowMap& rm, int slot, int& local, int& rel) {
  const int p = rm.pos != nullptr ? static_cast<int>(*rm.pos) : 0;
  const int g = max(p + rm.lo, rm.row0) + slot;
  if (g >= min(min(p + rm.hi, rm.row0 + rm.R), rm.total)) return false;
  local = g - rm.row0;
  rel = g - p - rm.lo;
  return true;
}

__device__ __forceinline__ void write_row(double* outf, int64_t* outi, int ld, int rel, double ub,
                                          double sw, bool flag, double lt, double comp, int best,
                                          int64_t rb, int64_t g) {
  outf[rel] = ub;
  outf[(size_t)ld + rel] = sw;
  outf[2 * (size_t)ld + rel] = flag ? 0.0 : sw;
  outf[3 * (size_t)ld + rel] = lt;
  outf[4 * (size_t)ld + rel] = comp;
  outi[rel] = best;
  outi[(size_t)ld + rel] = rb;
  outi[2 * (size_t)ld + rel] = g;
}

// (t, r, i) comes before (ot, orr, oi) in the pick's order: the tier (a
// NaN utility at cell 0 is kept, one elsewhere never taken, as the
// sequential rule does), then the larger utility, the least rank, the
// first cell.
__device__ __forceinline__ bool before(int ot, double ov, long long orr, int oi, int t, double v,
                                       long long r, int i) {
  if (ot != t) return ot > t;
  if (ov != v) return ov > v;
  if (orr != r) return orr < r;
  return oi < i;
}

// ---------------------------------------------------- score_block, warps

__global__ void __launch_bounds__(kRowWarps * 32) shard_round_score_warp(
    ScanArgs p, RowMap rm, const double* t, int ts, const int64_t* r, int rs,
    const int64_t* rank, const unsigned char* wvalid, double* outf, int64_t* outi) {
  const int lane = threadIdx.x % 32;
  const int slot = blockIdx.x * kRowWarps + threadIdx.x / 32;
  int row, rel;
  if (!map_row(rm, slot, row, rel)) return;  // the whole warp
  const int W = p.W, M = p.M, B = p.B, K = p.K;
  const int wm = W * M;
  const bool on = lane < W * B * M;
  const int m = lane % M;
  const int b = (lane / M) % B;
  const int w = lane / (B * M);
  const int64_t a = p.step_app[row];
  const double* t_row = t + (size_t)rel * ts;
  const int64_t* r_row = r + (size_t)rel * rs;
  int64_t gid = -2;
  bool resident = false;
  double sw = 0.0, lt = 0.0, comp = 0.0;
  if (on) {
    gid = p.gid[(size_t)a * M + m];
    resident = resident_in(p, r_row + (size_t)w * K, gid);
    sw = p.swap[((size_t)a * W + w) * M + m];
    lt = p.lat[((size_t)row * W + w) * M + m];
    comp = (t_row[w] + (resident ? 0.0 : sw)) + lt;
  }
  const int64_t* rk = rank + (size_t)a * wm;
  int best;
  double ub;
  long long rb;
  if (p.fixed != nullptr) {
    best = static_cast<int>(p.fixed[row]);
    ub = 0.0;  // not scored: a fixed choice has no utility to compare
    rb = rk[best];
  } else {
    const double size = p.bsize[row];
    const int members = static_cast<int>(size);
    double um = 0.0;  // the cell's Eq. 2 value times its member mask
    if (on && b < members) {
      um = eq2_utility<double>(static_cast<int>(p.pen[a]), p.acc[((size_t)row * B + b) * M + m],
                               p.deadlines[(size_t)row * B + b], comp) *
           p.mask[(size_t)row * B + b];
    }
    const int col = w * B * M + m;  // the lane of member 0 of (w, m)
    double sum = 0.0 + __shfl_sync(kFull, um, col);
    for (int k = 1; k < members; ++k) sum = sum + __shfl_sync(kFull, um, col + k * M);
    const double mean = on && p.valid[(size_t)a * M + m] ? sum / size : -INFINITY;
    // Lane i < W * M takes cell i = wc * M + mc: its mean, masked for a
    // padded worker, and its rank; the lanes then reduce by the order.
    const int wc = lane / M;
    const int mc = lane - wc * M;
    double u = __shfl_sync(kFull, mean, (wc * B) * M + mc);
    int tier = -1;
    long long rr = kRankInf;
    if (lane < wm) {
      if (wvalid != nullptr && !wvalid[wc]) u = -INFINITY;
      tier = isnan(u) ? (lane == 0 ? 2 : 0) : 1;
      rr = rk[lane];
    }
    const double raw = u;
    double v = tier == 1 ? u : 0.0;
    int i = lane;
    for (int off = 16; off > 0; off >>= 1) {
      const int ot = __shfl_xor_sync(kFull, tier, off);
      const double ov = __shfl_xor_sync(kFull, v, off);
      const long long orr = __shfl_xor_sync(kFull, rr, off);
      const int oi = __shfl_xor_sync(kFull, i, off);
      if (before(ot, ov, orr, oi, tier, v, rr, i)) {
        tier = ot;
        v = ov;
        rr = orr;
        i = oi;
      }
    }
    best = i;
    ub = __shfl_sync(kFull, raw, best);
    rb = rr;
  }
  const int wi = best / M;
  const int mi = best - wi * M;
  const int owner = (wi * B) * M + mi;  // the lane of (wi, 0, mi)
  const double sw_b = __shfl_sync(kFull, sw, owner);
  const bool flag_b = __shfl_sync(kFull, static_cast<int>(resident), owner) != 0;
  const double lt_b = __shfl_sync(kFull, lt, owner);
  const double comp_b = __shfl_sync(kFull, comp, owner);
  const long long g_b = __shfl_sync(kFull, static_cast<long long>(gid), owner);
  if (lane == 0) write_row(outf, outi, rm.ld, rel, ub, sw_b, flag_b, lt_b, comp_b, best, rb, g_b);
}

// -------------------------------------------------- score_block, wide rows

// The most bytes of a wide row's (W, B, M) tile kept in the leader block's
// shared memory, beside its rows; a wider tile stays in device memory and
// its row takes one block.
constexpr size_t kWideSmemTile = 160 * 1024;

// Shared bytes of a wide row: its (W, M) completions and means (8 bytes
// each) and its (W, M) residency flags, then, where it fits, its tile.
__host__ __device__ size_t wide_rows_bytes(int W, int M) { return 17 * (size_t)W * M; }
__host__ __device__ size_t wide_tile_offset(int W, int M) {
  return align8(wide_rows_bytes(W, M));
}
bool wide_tile_in_smem(int W, int B, int M) {
  return wide_tile_offset(W, M) + 8 * (size_t)W * B * M <= kWideSmemTile;
}

__global__ void __launch_bounds__(kWideThreads) shard_round_score_wide(
    ScanArgs p, RowMap rm, const double* t, int ts, const int64_t* r, int rs,
    const int64_t* rank, const unsigned char* wvalid, double* outf, int64_t* outi,
    int smem_tile) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  int row, rel;
  if (!map_row(rm, blockIdx.y, row, rel)) return;  // every block of the cluster
  const int W = p.W, M = p.M;
  const int wm = W * M;
  StepRows rows;
  rows.comp = reinterpret_cast<double*>(smem_raw);  // (W, M)
  rows.umean = rows.comp + wm;                      // (W, M)
  rows.flag = smem_raw + 16 * (size_t)wm;           // (W, M)
  double* tile = reinterpret_cast<double*>(smem_raw + wide_tile_offset(W, M));
  // The row's tile: the leader's shared memory, or the row's own slice of
  // the scratch in device memory (one block).
  ScanArgs q = p;
  q.tile = smem_tile ? cl.map_shared_rank(tile, 0)
            : p.tile != nullptr ? p.tile + (size_t)blockIdx.y * W * p.B * M : nullptr;
  // Every block takes the row's completions itself (W * M cells).
  pass_completions(q, rows, row, 0, 1, t + (size_t)rel * ts, 0, r + (size_t)rel * rs, 0);
  __syncthreads();
  const bool leader = cl.block_rank() == 0;
  if (p.fixed == nullptr) {
    const unsigned per_w = static_cast<unsigned>(p.bsize[row]) * M;
    const unsigned long long cells = (unsigned long long)W * per_w;
    const unsigned nb = cl.num_blocks(), rank_b = cl.block_rank();
    cl.sync();  // every block runs before any writes the leader's tile
    pass_tile(q, rows.comp, row, 0, 1, per_w, static_cast<unsigned>(cells * rank_b / nb),
              static_cast<unsigned>(cells * (rank_b + 1) / nb));
    cl.sync();  // every slice of the row's tile is written
    if (!leader) return;
    pass_means(q, smem_tile ? tile : q.tile, rows.umean, row, 0, 0, W);
    __syncthreads();
  } else if (!leader) {
    return;
  }
  if (threadIdx.x != 0) return;

  const int64_t a = p.step_app[row];
  const int64_t* rk = rank + (size_t)a * wm;
  int best;
  double ub;
  int64_t rb;
  if (p.fixed != nullptr) {
    best = static_cast<int>(p.fixed[row]);
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
  write_row(outf, outi, rm.ld, rel, ub, p.swap[((size_t)a * W + w) * M + m], rows.flag[best] != 0,
            p.lat[((size_t)row * W + w) * M + m], rows.comp[best], best, rb,
            p.gid[(size_t)a * M + m]);
}

// ------------------------------------------------------------------ chain

// The decisions a chain applies: n, or with a device position p those
// that precede a real position (min(n, total - p - 1)); -1 once p has
// reached total (nothing is written).
__device__ __forceinline__ int chain_length(int n, const int64_t* pos, int total) {
  if (pos == nullptr) return n;
  const long long p = *pos;
  if (p >= total) return -1;
  return static_cast<int>(min((long long)n, max(total - p - 1, 0LL)));
}

// The chain's inputs, as given: a worker, or with `models` > 0 a (worker,
// model) cell whose worker is cell / models.
struct ChainIn {
  const int64_t* wi;
  const int64_t* g;
  const double* sw;
  const double* lt;
  int models;
  __device__ __forceinline__ int worker(int k) const {
    const int x = static_cast<int>(wi[k]);
    return models > 0 ? x / models : x;
  }
};

// Decision (w, g, sw, lt) applied to the state (pt, pr) into (nt, nr).
__device__ __forceinline__ void chain_step(const ScanArgs& q, int w, int64_t g, double sw,
                                           double lt, const double* pt, const int64_t* pr,
                                           double* nt, int64_t* nr) {
  const int W = q.W, K = q.K;
  for (int i = 0; i < W; ++i) nt[i] = pt[i];
  const bool was = resident_in(q, pr + (size_t)w * K, g);
  nt[w] = (pt[w] + (was ? 0.0 : sw)) + lt;
  for (int x = 0; x < W; ++x) {
    if (x == w) continue;
#pragma unroll 4
    for (int i = 0; i < K; ++i) nr[(size_t)x * K + i] = pr[(size_t)x * K + i];
  }
  if (q.slot1) {
    nr[w] = g;
  } else {
    touch_lru_copy(pr + (size_t)w * K, nr + (size_t)w * K, K, g, was, q.sizes + (size_t)w * q.G,
                   q.cap);
  }
}

// Byte offsets of the staged chain's shared memory: the LRU sizes, the
// carry before the first position, and two tiles of T positions' inputs
// (worker, id, swap, latency) and states (tails, slots).
struct ChainLayout {
  size_t sizes, c_t, c_r, in_w, in_g, in_sw, in_lt, buf_t, buf_r, bytes;
  int tile;
};

ChainLayout chain_layout(int W, int K, int G, bool lru, size_t room) {
  ChainLayout L;
  size_t at = 0;
  L.sizes = at;
  if (lru) at += 8 * (size_t)W * G;
  L.c_t = at;
  at += 8 * (size_t)W;
  L.c_r = at;
  at += 8 * (size_t)W * K;
  const size_t per = 2 * (4 + 8 + 8 + 8 + 8 * (size_t)W + 8 * (size_t)W * K);
  const size_t fit = at + 64 < room ? (room - at - 64) / per : 0;
  L.tile = static_cast<int>(fit < (size_t)kChainTile ? fit : kChainTile);
  const size_t T = L.tile;
  L.in_g = at;
  at += 2 * 8 * T;
  L.in_sw = at;
  at += 2 * 8 * T;
  L.in_lt = at;
  at += 2 * 8 * T;
  L.buf_t = at;
  at += 2 * 8 * T * W;
  L.buf_r = at;
  at += 2 * 8 * T * W * K;
  L.in_w = at;
  at += 2 * 4 * T;
  L.bytes = align8(at);
  return L;
}

__global__ void __launch_bounds__(kChainThreads) shard_round_chain_staged(
    ScanArgs p, ChainLayout L, int n, ChainIn in, const int64_t* pos, int total, double* t_st,
    int64_t* r_st) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int len = chain_length(n, pos, total);
  if (len < 0) return;
  const int W = p.W, K = p.K;
  const int wk = W * K;
  const int T = L.tile;
  const int tid = threadIdx.x;
  double* c_t = reinterpret_cast<double*>(smem_raw + L.c_t);
  int64_t* c_r = reinterpret_cast<int64_t*>(smem_raw + L.c_r);
  int* in_w = reinterpret_cast<int*>(smem_raw + L.in_w);
  int64_t* in_g = reinterpret_cast<int64_t*>(smem_raw + L.in_g);
  double* in_sw = reinterpret_cast<double*>(smem_raw + L.in_sw);
  double* in_lt = reinterpret_cast<double*>(smem_raw + L.in_lt);
  double* buf_t = reinterpret_cast<double*>(smem_raw + L.buf_t);
  int64_t* buf_r = reinterpret_cast<int64_t*>(smem_raw + L.buf_r);
  ScanArgs q = p;
  if (!p.slot1) {
    double* s = reinterpret_cast<double*>(smem_raw + L.sizes);
    for (int i = tid; i < W * p.G; i += blockDim.x) s[i] = p.sizes[i];
    q.sizes = s;
  }
  for (int i = tid; i < W; i += blockDim.x) c_t[i] = t_st[i] = p.t0[i];
  for (int i = tid; i < wk; i += blockDim.x) c_r[i] = r_st[i] = p.res0[i];
  const int tiles = (len + T - 1) / T;
  // Tile `i`'s inputs into buffer i % 2, by threads [from, blockDim).
  auto stage = [&](int i, int from) {
    const int k0 = i * T;
    const int cnt = min(T, len - k0);
    const int h = (i & 1) * T;
    for (int j = tid - from; j < cnt; j += blockDim.x - from) {
      in_w[h + j] = in.worker(k0 + j);
      in_g[h + j] = in.g[k0 + j];
      in_sw[h + j] = in.sw[k0 + j];
      in_lt[h + j] = in.lt[k0 + j];
    }
  };
  if (tiles > 0) stage(0, 0);
  __syncthreads();
  // One worker: the tail (and the slot1 id) carried in registers.
  double t_one = c_t[0];
  int64_t slot_one = c_r[0];
  for (int i = 0; i <= tiles; ++i) {
    if (tid == 0 && i < tiles && W == 1 && q.slot1) {  // one worker, slot1: kUnroll at a time
      const int h = (i & 1) * T;
      const int cnt = min(T, len - i * T);
      int j = 0;
      for (; j + kUnroll <= cnt; j += kUnroll) {
        int64_t gs[kUnroll];
        double sws[kUnroll], lts[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          gs[u] = in_g[h + j + u];
          sws[u] = in_sw[h + j + u];
          lts[u] = in_lt[h + j + u];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const bool was = slot_one == gs[u];
          t_one = (t_one + (was ? 0.0 : sws[u])) + lts[u];
          slot_one = gs[u];
          buf_t[h + j + u] = t_one;
          buf_r[h + j + u] = slot_one;
        }
      }
      for (; j < cnt; ++j) {
        const int64_t g = in_g[h + j];
        const bool was = slot_one == g;
        t_one = (t_one + (was ? 0.0 : in_sw[h + j])) + in_lt[h + j];
        slot_one = g;
        buf_t[h + j] = t_one;
        buf_r[h + j] = g;
      }
    } else if (tid == 0 && i < tiles && W == 1) {  // one worker, LRU: inputs a position ahead
      const int h = (i & 1) * T;
      const int cnt = min(T, len - i * T);
      int64_t g = in_g[h];
      double sw = in_sw[h], lt = in_lt[h];
      for (int j = 0; j < cnt; ++j) {
        const int nx = h + min(j + 1, cnt - 1);
        const int64_t g_next = in_g[nx];
        const double sw_next = in_sw[nx], lt_next = in_lt[nx];
        const int64_t* pr = j > 0 ? buf_r + (size_t)(h + j - 1) * K
                            : i > 0 ? buf_r + (size_t)(((i - 1) & 1) * T + T - 1) * K
                                    : c_r;
        const bool was = resident_in(q, pr, g);
        t_one = (t_one + (was ? 0.0 : sw)) + lt;
        buf_t[h + j] = t_one;
        touch_lru_copy(pr, buf_r + (size_t)(h + j) * K, K, g, was, q.sizes, q.cap);
        g = g_next;
        sw = sw_next;
        lt = lt_next;
      }
    } else if (tid == 0) {
      if (i < tiles) {  // chain tile i from shared memory into buffer i % 2
        const int h = (i & 1) * T;
        const int cnt = min(T, len - i * T);
        for (int j = 0; j < cnt; ++j) {
          const double* pt;
          const int64_t* pr;
          if (j > 0) {
            pt = buf_t + (size_t)(h + j - 1) * W;
            pr = buf_r + (size_t)(h + j - 1) * wk;
          } else if (i > 0) {
            const int o = ((i - 1) & 1) * T + T - 1;
            pt = buf_t + (size_t)o * W;
            pr = buf_r + (size_t)o * wk;
          } else {
            pt = c_t;
            pr = c_r;
          }
          chain_step(q, in_w[h + j], in_g[h + j], in_sw[h + j], in_lt[h + j], pt, pr,
                     buf_t + (size_t)(h + j) * W, buf_r + (size_t)(h + j) * wk);
        }
      }
    } else if (tid >= 32) {
      if (i + 1 < tiles) stage(i + 1, 32);
      if (i > 0) {  // tile i - 1's states out, rows 1 + (i - 1) * T ...
        const int k0 = (i - 1) * T;
        const int cnt = min(T, len - k0);
        const int h = ((i - 1) & 1) * T;
        for (int x = tid - 32; x < cnt * W; x += blockDim.x - 32) {
          t_st[(size_t)(k0 + 1) * W + x] = buf_t[(size_t)h * W + x];
        }
        for (int x = tid - 32; x < cnt * wk; x += blockDim.x - 32) {
          r_st[(size_t)(k0 + 1) * wk + x] = buf_r[(size_t)h * wk + x];
        }
      }
    }
    __syncthreads();
  }
}

// The direct form, for a carry too wide to stage: the carry in shared
// memory, one thread applying the positions and writing every state.
__global__ void __launch_bounds__(32) shard_round_chain_direct(ScanArgs p, int n, ChainIn in,
                                                               const int64_t* pos, int total,
                                                               double* t_st, int64_t* r_st) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int len = chain_length(n, pos, total);
  if (len < 0) return;
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
    if (k == len) break;
    const int w = in.worker(k);
    const int64_t gk = in.g[k];
    const bool was = resident_in(p, r + (size_t)w * K, gk);
    advance(p, w, gk, was, (t[w] + (was ? 0.0 : in.sw[k])) + in.lt[k], t, r);
  }
}

// ----------------------------------------------------------------- accept

// One round's picks: cells, model ids, raw swaps, effective swaps and
// latencies of positions [first, first + n) of the round, with the
// score_block outputs' row stride.
struct Picks {
  const double* f;
  const int64_t* i;
  int ld;
};

__global__ void __launch_bounds__(kAcceptThreads) shard_round_accept(
    ScanArgs p, int span, Picks spec, Picks val, const double* t_st, const int64_t* r_st,
    int64_t* pos, double* t, int64_t* res, long long* stats) {
  __shared__ int s_a, s_conflict;
  const long long p0 = *pos;
  if (p0 >= p.S) return;
  const int W = p.W, M = p.M, K = p.K;
  const int wk = W * K;
  const int kn = static_cast<int>(min((long long)span, p.S - p0));
  const int tid = threadIdx.x;
  // Position j's pick: the speculated one at 0, the validated one after.
  auto ival = [&](int row, int j) {
    return j ? val.i[(size_t)row * val.ld + j - 1] : spec.i[(size_t)row * spec.ld];
  };
  auto fval = [&](int row, int j) {
    return j ? val.f[(size_t)row * val.ld + j - 1] : spec.f[(size_t)row * spec.ld];
  };
  auto cell = [&](int j) { return ival(0, j); };
  if (tid < 32) {
    int first = kn;
    for (int j0 = 1; j0 < kn; j0 += 32) {
      const int j = j0 + tid;
      const unsigned mis = __ballot_sync(kFull, j < kn && val.i[j - 1] != spec.i[j]);
      if (mis) {
        first = j0 + __ffs(mis) - 1;
        break;
      }
    }
    if (tid == 0) {
      s_a = first < kn ? first + 1 : kn;
      s_conflict = first < kn;
    }
  }
  __syncthreads();
  const int a = s_a;
  for (int j = tid; j < a; j += blockDim.x) {
    const int c = static_cast<int>(cell(j));
    const int wi = c / M;
    const double start = t_st[(size_t)j * W + wi];
    const size_t o = static_cast<size_t>(p0) + j;
    p.out[o] = wi;
    p.out[(size_t)p.ld + o] = c - wi * M;
    p.out[2 * (size_t)p.ld + o] = start;
    p.out[3 * (size_t)p.ld + o] = ((start + fval(2, j)) + fval(3, j)) - start;
  }
  __syncthreads();
  // The carry: the last accepted decision on its pre-state (state k of the
  // round; the carry itself when the round has one position).
  const int k = a - 1;
  for (int x = tid; x < W; x += blockDim.x) t[x] = t_st[(size_t)k * W + x];
  for (int x = tid; x < wk; x += blockDim.x) res[x] = r_st[(size_t)k * wk + x];
  __syncthreads();
  if (tid == 0) {
    const int wi = static_cast<int>(cell(k)) / M;
    const int64_t g = ival(2, k);
    const bool was = resident_in(p, res + (size_t)wi * K, g);
    advance(p, wi, g, was, (t[wi] + (was ? 0.0 : fval(1, k))) + fval(3, k), t, res);
    *pos = p0 + a;
    stats[0] += 1;
    stats[1] += s_conflict;
  }
}

// Opts a kernel in to `smem` bytes past the default 48 KiB; refuses a sum
// beyond the device's per-block maximum (the wrapper refuses it first).
cudaError_t fit_smem(const void* kernel, size_t smem, size_t* optin_out = nullptr) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return err;
  if (optin_out != nullptr) *optin_out = (size_t)optin;
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  return cudaSuccess;
}

ScanArgs table_args(const void* acc, const void* mask, const void* deadlines, const void* bsize,
                    const void* lat, const void* step_app, const void* swap, const void* gid,
                    const void* valid, const void* pen, const void* fixed, void* tile, int R,
                    int B, int M, int W, int K, int slot1) {
  ScanArgs a = {};
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
  a.pref = nullptr;  // the block's own pick replaces the step's
  a.fixed = static_cast<const int64_t*>(fixed);
  a.tile = static_cast<double*>(tile);
  a.S = R;
  a.B = B;
  a.M = M;
  a.W = W;
  a.K = K;
  a.slot1 = slot1;
  return a;
}

}  // namespace

extern "C" {

// score_block: every pointer a tensor on the current device.  `t` holds
// the (W,) tails of each row slot at stride `ts` (0: one carry for every
// row), `r` its (W, K) slots at stride `rs`; the block's tables as
// ScanArgs says with S = R (`lat` (R, W, M), `swap` (A, W, M); no
// preference permutation: the step's own pick is skipped), `rank` (A, W *
// M) the tie-break ranks, `wvalid` (W,) or null, `fixed` (R,) or null,
// `tile` (slots, W, B, M) scratch, for a wide row whose tile does not fit
// the leader's shared memory (else null); `outf` (5, ld) float64 and
// `outi` (3, ld) int64.  Rows as
// RowMap says: `pos` null scores rows [0, R) into columns [0, R) (lo = 0,
// hi = row0 = 0, total = R, ld = R); `slots` row slots are launched.
// `warp` runs a row a warp (W * B * M <= 32), else a row a cluster of
// `blocks` blocks (one when the tile is in device memory).  Returns a
// cudaError_t (0 on success).
int shard_round_score_f64(const void* t, int ts, const void* r, int rs, const void* acc,
                          const void* mask, const void* deadlines, const void* bsize,
                          const void* lat, const void* step_app, const void* swap,
                          const void* gid, const void* valid, const void* pen, const void* rank,
                          const void* wvalid, const void* fixed, void* tile,
                          void* outf, void* outi, const void* pos, int lo, int hi, int row0,
                          int total, int ld, int slots, int R, int B, int M, int W, int K,
                          int slot1, int warp, int blocks, void* stream) {
  if (R < 1 || B < 1 || M < 1 || W < 1 || K < 1 || ts < 0 || rs < 0 || (slot1 && K != 1) ||
      slots < 1 || ld < 1 || hi - lo < 1 || blocks < 1 || blocks > kMaxBlocks ||
      (warp && (size_t)W * B * M > 32) || (size_t)slots * W * B * M >> 32) {
    return (int)cudaErrorInvalidValue;
  }
  ScanArgs a = table_args(acc, mask, deadlines, bsize, lat, step_app, swap, gid, valid, pen,
                          fixed, tile, R, B, M, W, K, slot1);
  RowMap rm;
  rm.pos = static_cast<const int64_t*>(pos);
  rm.lo = lo;
  rm.hi = hi;
  rm.row0 = row0;
  rm.total = total;
  rm.R = R;
  rm.ld = ld;
  const double* tp = static_cast<const double*>(t);
  const int64_t* rp = static_cast<const int64_t*>(r);
  const int64_t* rkp = static_cast<const int64_t*>(rank);
  const unsigned char* wv = static_cast<const unsigned char*>(wvalid);
  double* of = static_cast<double*>(outf);
  int64_t* oi = static_cast<int64_t*>(outi);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (warp) {
    shard_round_score_warp<<<(slots + kRowWarps - 1) / kRowWarps, kRowWarps * 32, 0, st>>>(
        a, rm, tp, ts, rp, rs, rkp, wv, of, oi);
    return (int)cudaGetLastError();
  }
  const int smem_tile = fixed == nullptr && wide_tile_in_smem(W, B, M);
  if (!smem_tile && (blocks != 1 || (fixed == nullptr && tile == nullptr))) {
    return (int)cudaErrorInvalidValue;  // a tile in device memory takes one block
  }
  const size_t smem =
      smem_tile ? wide_tile_offset(W, M) + 8 * (size_t)W * B * M : wide_rows_bytes(W, M);
  cudaError_t err = fit_smem(reinterpret_cast<const void*>(shard_round_score_wide), smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks, slots);
  config.blockDim = dim3(kWideThreads);
  config.dynamicSmemBytes = smem;
  config.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, shard_round_score_wide, a, rm, tp, ts, rp, rs, rkp, wv, of,
                           oi, smem_tile);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// chain: `t0` (W,) tails and `res0` (W, K) slots of the carry before the
// first position, `sizes` (W, G) bytes per id (lru only) and `cap`; the n
// positions' worker `wi` (or, with `models` > 0, its (worker, model) cell),
// model id `g`, raw swap `sw` and latency `lt`; `t_st` (n + 1, W) and
// `r_st` (n + 1, W, K) the states out.  With `pos` (a device int64) the
// chain stops before the window's last position `total` and does nothing
// once pos has reached it.  Returns a cudaError_t (0 on success).
int shard_round_chain_f64(const void* t0, const void* res0, const void* sizes, double cap,
                          const void* wi, const void* g, const void* sw, const void* lt,
                          void* t_st, void* r_st, int n, int W, int K, int G, int slot1,
                          const void* pos, int total, int models, void* stream) {
  if (n < 0 || W < 1 || K < 1 || (slot1 && K != 1) || (!slot1 && G < 1) || models < 0) {
    return (int)cudaErrorInvalidValue;
  }
  ScanArgs a = {};
  a.t0 = static_cast<const double*>(t0);
  a.res0 = static_cast<const int64_t*>(res0);
  a.sizes = static_cast<const double*>(sizes);
  a.cap = cap;
  a.W = W;
  a.K = K;
  a.G = G;
  a.slot1 = slot1;
  ChainIn in;
  in.wi = static_cast<const int64_t*>(wi);
  in.g = static_cast<const int64_t*>(g);
  in.sw = static_cast<const double*>(sw);
  in.lt = static_cast<const double*>(lt);
  in.models = models;
  const int64_t* pp = static_cast<const int64_t*>(pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  size_t optin = 0;
  cudaError_t err = fit_smem(reinterpret_cast<const void*>(shard_round_chain_staged), 0, &optin);
  if (err != cudaSuccess) return (int)err;
  const ChainLayout L = chain_layout(W, K, G, !slot1, optin > 1024 ? optin - 1024 : 0);
  if (L.tile >= kChainMinTile || (L.tile >= 1 && n < kChainMinTile)) {
    err = fit_smem(reinterpret_cast<const void*>(shard_round_chain_staged), L.bytes);
    if (err != cudaSuccess) return (int)err;
    shard_round_chain_staged<<<1, kChainThreads, L.bytes, st>>>(
        a, L, n, in, pp, total, static_cast<double*>(t_st), static_cast<int64_t*>(r_st));
    return (int)cudaGetLastError();
  }
  const size_t smem = 8 * ((size_t)W * K + W);  // the carry: (W, K) slots and (W,) tails
  err = fit_smem(reinterpret_cast<const void*>(shard_round_chain_direct), smem);
  if (err != cudaSuccess) return (int)err;
  shard_round_chain_direct<<<1, 32, smem, st>>>(a, n, in, pp, total, static_cast<double*>(t_st),
                                                static_cast<int64_t*>(r_st));
  return (int)cudaGetLastError();
}

// accept: `pos` a device int64 (the round's first position) and `total`
// the window's positions; the round's `span` positions' speculated picks
// `spec_f` (5, ld_s) / `spec_i` (3, ld_s) and validated picks of
// positions 1..span-1 `val_f` (5, ld_v) / `val_i` (3, ld_v) (null when
// span is 1), as score_block writes them; `t_st` (span, W) and `r_st`
// (span, W, K) the round's pre-states (the carry itself when span is 1);
// `out` (4, total) the rows; `t` (W,), `res` (W, K) the carry, moved in
// place; `stats` (2,) int64 rounds and conflicts, added to.  Does nothing
// once pos has reached total.  One block.  Returns a cudaError_t.
int shard_round_accept_f64(void* pos, int total, int span, const void* spec_f, const void* spec_i,
                           int ld_s, const void* val_f, const void* val_i, int ld_v,
                           const void* t_st, const void* r_st, const void* sizes, double cap,
                           void* t, void* res, void* out, void* stats, int M, int W, int K, int G,
                           int slot1, void* stream) {
  if (total < 1 || span < 1 || M < 1 || W < 1 || K < 1 || (slot1 && K != 1) ||
      (!slot1 && G < 1) || (span > 1 && (val_f == nullptr || val_i == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  ScanArgs a = {};
  a.sizes = static_cast<const double*>(sizes);
  a.cap = cap;
  a.out = static_cast<double*>(out);
  a.S = total;
  a.ld = total;
  a.M = M;
  a.W = W;
  a.K = K;
  a.G = G;
  a.slot1 = slot1;
  Picks s{static_cast<const double*>(spec_f), static_cast<const int64_t*>(spec_i), ld_s};
  Picks v{static_cast<const double*>(val_f), static_cast<const int64_t*>(val_i), ld_v};
  shard_round_accept<<<1, kAcceptThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, span, s, v, static_cast<const double*>(t_st), static_cast<const int64_t*>(r_st),
      static_cast<int64_t*>(pos), static_cast<double*>(t), static_cast<int64_t*>(res),
      static_cast<long long*>(stats));
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
