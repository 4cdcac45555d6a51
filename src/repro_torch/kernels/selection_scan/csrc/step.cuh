// The step of the port's selection scans: the arguments, the scoring of a
// run of positions against their carries, and the carry update of one
// decision.  Included by selection_scan.cu (the sequential scan: one
// position at a time), ../../spec_scan/csrc/spec_scan.cu (the chunked
// scan: C positions a round) and ../../shard_round/csrc/shard_round.cu
// (the sharded rounds); all are compiled with --fmad=false, so every scan
// takes each decision with the same arithmetic.
#pragma once

#include <math.h>
#include <stdint.h>

#include "../../utility/csrc/penalty.cuh"
#include "lru.cuh"

struct ScanArgs {
  const double* t0;          // (W,) queue-tail times
  const int64_t* res0;       // (W, K) resident ids, LRU oldest first, -1 empty
  const double* sizes;       // (W, G) effective bytes per id (lru only)
  const double* acc;         // (S, B, M) accuracies
  const double* mask;        // (S, B) 1 for the first bsize[s] members, else 0
  const double* deadlines;   // (S, B)
  const double* bsize;       // (S,) members per step
  const double* lat;         // (S, W, M) latency of the step's batch
  const int64_t* step_app;   // (S,) application (table row) of each step
  const double* swap;        // (A, W, M) swap latencies
  const int64_t* gid;        // (A, M) residency ids, -2 for padding
  const unsigned char* valid;  // (A, M) real models
  const int64_t* pen;        // (A,) penalty codes
  const int64_t* pref;       // (A, W * M) preference permutations, or null (no pick)
  const int64_t* fixed;      // (S,) fixed choices, or null
  double* tile;              // (C, W, B, M) scratch (B = 1 with fixed choices)
  double* out;               // (4, ld): worker, model, start, latency
  double cap;
  int S, B, M, W, K, G, slot1, ld;
};

// The per-position rows of a run of positions: (C, W, M) completions,
// member means and residency flags (C = 1 for the sequential scan).
struct StepRows {
  double* comp;
  double* umean;
  unsigned char* flag;
};

// Whether id g sits in a worker's slots.
__device__ __forceinline__ bool resident_in(const ScanArgs& p, const int64_t* slots, int64_t g) {
  if (p.slot1) return slots[0] == g;
  bool was = false;
  for (int j = 0; j < p.K; ++j) was |= slots[j] == g;
  return was;
}

// One step's values that a scoring thread keeps while its cells stay in
// that step.
struct StepView {
  int s = -1, a = 0, members = 0, pen = 0;
  double size = 0.0;
};

__device__ __forceinline__ void view_step(const ScanArgs& p, int s, StepView& v) {
  if (v.s == s) return;
  v.s = s;
  v.a = static_cast<int>(p.step_app[s]);
  v.size = p.bsize[s];
  v.members = static_cast<int>(v.size);
  v.pen = static_cast<int>(p.pen[v.a]);
}

// The block routines of a pass over positions k in [k0, kn) of the run
// starting at step `pos`, each scored against its carry — tails t + (k -
// k0) * ts, slots r + (k - k0) * rs (ts = rs = 0: one carry for every
// position).  The chunked scan's block instance (spec_scan.cu) and the
// sharded rounds' wide rows (shard_round.cu) run them in this order, a
// barrier after each:
//   A. pass_completions: per (position, worker, model) cell, whether the
//      model is resident under the carry, and the completion (t +
//      swap_eff) + lat; `run_most` (warp 0) the most members any of the
//      run's positions has, phase B's bound;
//   B. pass_tile: per (position, worker, member, model) cell of the
//      positions' real members, the Eq. 2 value (K1's arithmetic,
//      penalty.cuh) into the tile in device memory (a group of 1,300
//      members on four workers does not fit shared memory), or into a
//      tile in shared memory.  A pass takes a slice [c0, c1) of the cells,
//      so the blocks of a cluster can share the work: whole (position,
//      worker) rows each, or each a slice of one row's cells written into
//      the leader block's shared memory;
//   C. pass_means: per (position, worker, model) column of a range of
//      (position, worker) rows, one chain of member adds in member order,
//      then one divide; -inf for an invalid (padded) model, from a tile
//      the block wrote itself (in device or shared memory); or
//      pass_means_warps: the same chain a warp a column, from a tile the
//      blocks of a cluster wrote, 32 members' loads at a time;
//   D. pass_picks: per position, the first maximum over its preference
//      permutation, or the fixed choice (MaxAcc: B and C are skipped).
// Members past a step's count add exact zeros in the reference and are
// skipped.  A thread keeps its position's step values (application,
// member count, penalty) while its cells stay in that position.  Cell
// indices are 32-bit (the launches refuse a tile of 2^32 cells).
__device__ void pass_completions(const ScanArgs& p, const StepRows& rows, int pos, int k0,
                                 int kn, const double* t, int ts, const int64_t* r, int rs) {
  const int W = p.W, M = p.M, K = p.K;
  const int wm = W * M;
  StepView v;
  for (int c = threadIdx.x; c < (kn - k0) * wm; c += blockDim.x) {
    const int j = c / wm;
    const int k = k0 + j;
    const int cell = c - j * wm;
    const int w = cell / M;
    const int m = cell - w * M;
    view_step(p, pos + k, v);
    const bool resident =
        resident_in(p, r + (size_t)j * rs + (size_t)w * K, p.gid[(size_t)v.a * M + m]);
    rows.flag[(size_t)k * wm + cell] = resident;
    const double sw = resident ? 0.0 : p.swap[((size_t)v.a * W + w) * M + m];
    rows.comp[(size_t)k * wm + cell] =
        (t[(size_t)j * ts + w] + sw) + p.lat[((size_t)v.s * W + w) * M + m];
  }
}

// The most members of positions [0, kn) of the run at `pos`, in every lane
// of the calling warp (1 for tables of one member).
__device__ __forceinline__ unsigned run_most(const ScanArgs& p, int pos, int kn) {
  if (p.B == 1) return 1u;
  unsigned mine = 0;
  for (int k = threadIdx.x % warpSize; k < kn; k += warpSize) {
    mine = max(mine, static_cast<unsigned>(p.bsize[pos + k]));
  }
  return __reduce_max_sync(0xffffffffu, mine);
}

// Phase B over cells [c0, c1) of the (kn - k0, W, per_w) cells of the
// pass, per_w = most * M; `comp` holds the pass's completions, indexed as
// StepRows.comp.
__device__ void pass_tile(const ScanArgs& p, const double* comp, int pos, int k0, int kn,
                          unsigned per_w, unsigned c0, unsigned c1) {
  const int W = p.W, M = p.M, B = p.B;
  const int wm = W * M;
  const unsigned per_k = (unsigned)W * per_w;
  StepView v;
  for (unsigned c = c0 + threadIdx.x; c < c1; c += blockDim.x) {
    const unsigned j = c / per_k;
    const unsigned r0 = c - j * per_k;
    const unsigned w = r0 / per_w;
    const unsigned r1 = r0 - w * per_w;
    const int b = static_cast<int>(r1 / M);
    const int m = static_cast<int>(r1 - b * M);
    const int k = k0 + static_cast<int>(j);
    view_step(p, pos + k, v);
    if (b >= v.members) continue;
    p.tile[((size_t)k * W + w) * B * M + (size_t)b * M + m] =
        eq2_utility<double>(v.pen, p.acc[((size_t)v.s * B + b) * M + m],
                            p.deadlines[(size_t)v.s * B + b], comp[(size_t)k * wm + w * M + m]);
  }
  (void)kn;
}

// Member values phase C loads before it adds them.
constexpr int kMeanDepth = 8;

// Phase C over the (position, worker) rows r in [r0, r1) of the pass, row
// r = (k - k0) * W + w: each of the row's M columns summed from `tile`
// (the (C, W, B, M) tile of p's shape, in device or shared memory),
// written to umean[k * W * M + w * M + m] (the caller's rows, or another
// block's through distributed shared memory).
__device__ void pass_means(const ScanArgs& p, const double* tile, double* umean, int pos, int k0,
                           int r0, int r1) {
  const int W = p.W, M = p.M, B = p.B;
  const int wm = W * M;
  StepView v;
  for (int c = threadIdx.x; c < (r1 - r0) * M; c += blockDim.x) {
    const int r = r0 + c / M;
    const int m = c - (c / M) * M;
    const int k = k0 + r / W;
    const int w = r - (r / W) * W;
    view_step(p, pos + k, v);
    const double* col = tile + ((size_t)k * W + w) * B * M + m;
    const double* mk = p.mask + (size_t)v.s * B;
    double sum = 0.0;
    int b = 0;
    for (; b + kMeanDepth <= v.members; b += kMeanDepth) {
      double x[kMeanDepth], y[kMeanDepth];
#pragma unroll
      for (int i = 0; i < kMeanDepth; ++i) {
        x[i] = col[(size_t)(b + i) * M];
        y[i] = mk[b + i];
      }
#pragma unroll
      for (int i = 0; i < kMeanDepth; ++i) sum = sum + x[i] * y[i];
    }
    for (; b < v.members; ++b) sum = sum + col[(size_t)b * M] * mk[b];
    umean[(size_t)k * wm + w * M + m] = p.valid[(size_t)v.a * M + m] ? sum / v.size : -INFINITY;
  }
}

// Phase C by warps, for a tile that other blocks of a cluster wrote: the
// pass's (kn - k0) * W * M columns a warp each (warp `gw` of `nwarps`
// takes columns gw, gw + nwarps, ...).  The lanes load 32 members' values
// at a time (through L2), the next 32 in flight while the warp adds these,
// and every lane runs the same chain of adds in member order over the
// products shuffled from their lanes; lane 0 writes the mean to umean[k *
// W * M + cell] (the leader's rows, through distributed shared memory).
__device__ void pass_means_warps(const ScanArgs& p, const double* tile, double* umean, int pos,
                                 int k0, int kn, int gw, int nwarps) {
  const int W = p.W, M = p.M, B = p.B;
  const int wm = W * M;
  const int lane = threadIdx.x % warpSize;
  StepView v;
  for (int c = gw; c < (kn - k0) * wm; c += nwarps) {
    const int k = k0 + c / wm;
    const int cell = c - (c / wm) * wm;
    const int w = cell / M;
    const int m = cell - w * M;
    view_step(p, pos + k, v);
    const double* col = tile + ((size_t)k * W + w) * B * M + m;
    const double* mk = p.mask + (size_t)v.s * B;
    double x = 0.0, y = 0.0;
    if (lane < v.members) {
      x = __ldcg(col + (size_t)lane * M);
      y = mk[lane];
    }
    double sum = 0.0;
    for (int b0 = 0; b0 < v.members; b0 += warpSize) {
      const int bn = b0 + warpSize + lane;
      double xn = 0.0, yn = 0.0;
      if (bn < v.members) {
        xn = __ldcg(col + (size_t)bn * M);
        yn = mk[bn];
      }
      const double prod = x * y;
      const int cnt = min(warpSize, v.members - b0);
#pragma unroll 8
      for (int i = 0; i < cnt; ++i) sum = sum + __shfl_sync(0xffffffffu, prod, i);
      x = xn;
      y = yn;
    }
    if (lane == 0) {
      umean[(size_t)k * wm + cell] = p.valid[(size_t)v.a * M + m] ? sum / v.size : -INFINITY;
    }
  }
}

// Each position's first maximum over its preference permutation, or its
// fixed choice, into picks[k] (thread k - k0 of the block writes it).
__device__ void pass_picks(const ScanArgs& p, const StepRows& rows, int pos, int k0, int kn,
                           int* picks) {
  const int wm = p.W * p.M;
  for (int k = k0 + threadIdx.x; k < kn; k += blockDim.x) {
    if (p.fixed != nullptr) {
      picks[k] = static_cast<int>(p.fixed[pos + k]);
      continue;
    }
    const int64_t* pr = p.pref + (size_t)p.step_app[pos + k] * wm;
    const double* u = rows.umean + (size_t)k * wm;
    int pick = static_cast<int>(pr[0]);
    double best = u[pick];
    for (int i = 1; i < wm; ++i) {
      const int c = static_cast<int>(pr[i]);
      if (u[c] > best) {
        best = u[c];
        pick = c;
      }
    }
    picks[k] = pick;
  }
}

// The residency id of decision `pick` of step s.
__device__ __forceinline__ int64_t pick_id(const ScanArgs& p, int s, int pick) {
  return p.gid[(size_t)p.step_app[s] * p.M + pick % p.M];
}

// A decision applied to a carry (tails t, slots r) in place: worker wi's
// tail becomes `done`, the decision's completion, and its slots take id g
// (the slot1 id or the LRU touch; `was` says whether g was resident).
__device__ __forceinline__ void advance(const ScanArgs& p, int wi, int64_t g, bool was,
                                        double done, double* t, int64_t* r) {
  t[wi] = done;
  int64_t* slots = r + (size_t)wi * p.K;
  if (p.slot1) {
    slots[0] = g;
  } else {
    touch_lru(slots, p.K, g, was, p.sizes + (size_t)wi * p.G, p.cap);
  }
}

// The output column of step s: worker, model column, start, latency.
__device__ __forceinline__ void emit(const ScanArgs& p, int s, int pick, double start,
                                     double done) {
  const int wi = pick / p.M;
  p.out[s] = wi;
  p.out[(size_t)p.ld + s] = pick - wi * p.M;
  p.out[2 * (size_t)p.ld + s] = start;
  p.out[3 * (size_t)p.ld + s] = done - start;
}
