// The two instances of the sequential selection scan's step, and the
// fetch of a step's tables while earlier steps resolve.  Included by
// selection_scan.cu and ../../spec_scan/csrc/spec_scan.cu (whose warp
// instance scores a round's positions a warp each with `warp_pick`), both
// compiled with --fmad=false; both instances
// repeat step.cuh's arithmetic, so they take every decision with the same
// operations in the same order: completions (t + swap_eff) + lat,
// penalty.cuh's Eq. 2, a member mean as one chain of adds in member order
// then one divide (-inf for an invalid model), the first maximum over the
// application's preference permutation, step.cuh's `advance`, and the
// output column `emit` writes.
//
//   warp instance   a step's W * B * M cells fit one warp: lane
//                   (w * B + b) * M + m owns cell (w, b, m); its
//                   completion and Eq. 2 value stay in registers, a mean
//                   gathers its members with __shfl_sync, the pick is a
//                   warp reduction; no device-memory tile, no block barrier.
//   block instance  step.cuh's four phases (score_steps<true>'s form) over
//                   a block, the Eq. 2 tile in device memory, phase C's
//                   member loads issued kDepth at a time, phase D a warp
//                   reduction.
//
// The tables a step reads that do not depend on the carry (the step's
// application, member count, penalty and fixed choice, its accuracies,
// deadlines, masks and latencies, the application's ids, swaps, validity
// and preference row) are fetched several steps before the step is scored
// (selection_scan.cu keeps a ring of them), into registers held raw
// (converted where they are used), so their latency overlaps the float64
// chains of the steps between; the application a step's rows are indexed
// by is loaded a ring's length earlier still.
#pragma once

#include <math.h>
#include <stdint.h>

#include "step.cuh"

constexpr unsigned kFullWarp = 0xffffffffu;

// A candidate of the first-maximum rule: step.cuh's phase D keeps u[pref[0]]
// and moves only to a strictly larger value, so its pick is the largest
// value at the least rank.  A NaN at rank 0 is never left and a NaN
// elsewhere never taken, so it ranks as +inf at rank 0 and as -inf
// elsewhere (a mean is at most 1).
__device__ __forceinline__ double ranked_value(double u, int rank) {
  return isnan(u) ? (rank == 0 ? INFINITY : -INFINITY) : u;
}

// (v, r) becomes (ov, orr) when that candidate comes first by the rule.
__device__ __forceinline__ void take_first(double& v, int& r, double ov, int orr) {
  if (ov > v || (ov == v && orr < r)) {
    v = ov;
    r = orr;
  }
}

// The winning rank of the candidates (v, r) held by lanes [0, span), in
// each of those lanes (span a power of two up to 32).  The rule is a total
// order, so the butterfly's order of comparisons does not change the
// winner.
__device__ __forceinline__ int warp_first(double v, int r, int span) {
  for (int off = span >> 1; off > 0; off >>= 1) {
    take_first(v, r, __shfl_xor_sync(kFullWarp, v, off), __shfl_xor_sync(kFullWarp, r, off));
  }
  return r;
}

// The least power of two at or above n (1 <= n <= 32).
__device__ __forceinline__ int pow2_span(int n) { return n <= 1 ? 1 : 1 << (32 - __clz(n - 1)); }

// ---------------------------------------------------------- warp instance

// The cell a lane owns: lane = (w * B + b) * M + m; `on` is false past the
// W * B * M cells.  inv_m is 1 / M, for quotients by M of cells below 32.
struct LaneCell {
  int w, b, m;
  bool on;
  float inv_m;
};

// n / M for 0 <= n < 32 and M <= 32: (n + 1/2) / M is at least 1/64 from
// an integer, far beyond a float's rounding, so one multiply takes it.
__device__ __forceinline__ int div_m(int n, float inv_m) {
  return __float2int_rz((static_cast<float>(n) + 0.5f) * inv_m);
}

// One lane's tables of one step, raw as loaded: the step's member count,
// penalty and fixed choice; of the lane's cell its accuracy,
// member mask, deadline, latency, swap, residency id and validity; of rank
// `lane` of the preference permutation its cell.
struct LaneStep {
  int64_t pen = 0, fixed = 0, gid = -2, pref = 0;
  double size = 1.0, acc = 0.0, mask = 0.0, dl = 0.0, lat = 0.0, swap = 0.0;
  unsigned char valid = 0;
};

__device__ __forceinline__ void fetch_lane(const ScanArgs& p, int s, int64_t a, const LaneCell& c,
                                           int lane, LaneStep& v) {
  const int W = p.W, B = p.B, M = p.M, wm = W * M;
  v.size = p.bsize[s];
  v.pen = p.pen[a];
  if (c.on) {
    v.acc = p.acc[((size_t)s * B + c.b) * M + c.m];
    v.mask = p.mask[(size_t)s * B + c.b];
    v.dl = p.deadlines[(size_t)s * B + c.b];
    v.lat = p.lat[((size_t)s * W + c.w) * M + c.m];
    v.swap = p.swap[((size_t)a * W + c.w) * M + c.m];
    v.gid = p.gid[(size_t)a * M + c.m];
    v.valid = p.valid[(size_t)a * M + c.m];
  }
  if (lane < wm) v.pref = p.pref[(size_t)a * wm + lane];
  if (p.fixed != nullptr) v.fixed = p.fixed[s];
}

// A warp's decision on one step: the worker and model column, the
// completion, whether the model was resident, its id.
struct WarpPick {
  int wi, mi;
  double done;
  bool was;
  int64_t g;
};

// The decision of the step whose tables `v` holds, scored by the warp
// against the carry (tails t, slots res, in shared memory), in every lane.
// `span` is pow2_span(W * M).
__device__ __forceinline__ WarpPick warp_pick(const ScanArgs& p, const LaneStep& v,
                                              const LaneCell& c, int lane, int span,
                                              const double* t, const int64_t* res) {
  const int B = p.B, M = p.M, wm = p.W * M;
  bool resident = false;
  double comp = 0.0;
  if (c.on) {
    resident = resident_in(p, res + (size_t)c.w * p.K, v.gid);
    const double sw = resident ? 0.0 : v.swap;
    comp = (t[c.w] + sw) + v.lat;
  }
  // The decision's worker, model, completion, residency flag and id.
  int wi, mi;
  double done;
  bool was;
  int64_t g;
  if (p.fixed != nullptr) {
    const int pick = static_cast<int>(v.fixed);
    wi = div_m(pick, c.inv_m);
    mi = pick - wi * M;
    const int owner = wi * B * M + mi;  // the lane of (wi, 0, mi)
    done = __shfl_sync(kFullWarp, comp, owner);
    was = __shfl_sync(kFullWarp, static_cast<int>(resident), owner) != 0;
    g = __shfl_sync(kFullWarp, static_cast<long long>(v.gid), mi);  // lane mi: gid[a, mi]
  } else {
    const int members = static_cast<int>(v.size);
    double um = 0.0;  // the cell's Eq. 2 value times its member mask
    if (c.on && c.b < members) {
      um = eq2_utility<double>(static_cast<int>(v.pen), v.acc, v.dl, comp) * v.mask;
    }
    const int col = c.w * B * M + c.m;  // the lane of member 0 of (w, m)
    // Member 0's add is taken out of the loop: with none, um is 0 there.
    double sum = 0.0 + __shfl_sync(kFullWarp, um, col);
    for (int b = 1; b < members; ++b) sum = sum + __shfl_sync(kFullWarp, um, col + b * M);
    // x / 1 is x exactly, so a lone member's mean skips the divide.
    const double mean = v.valid ? (v.size == 1.0 ? sum : sum / v.size) : -INFINITY;
    // Lane i < W * M takes rank i of the permutation: its cell's mean and,
    // so that the winner's need one shuffle, its worker, completion,
    // residency flag and id (cells and lanes are prefetched values, off
    // the chain).
    const int cell = static_cast<int>(v.pref);
    const int wc = div_m(cell, c.inv_m);
    const int mc = cell - wc * M;
    const int src = wc * B * M + mc;  // the lane of (wc, 0, mc)
    const double u = __shfl_sync(kFullWarp, mean, src);
    const double cu = __shfl_sync(kFullWarp, comp, src);
    const int ru = __shfl_sync(kFullWarp, static_cast<int>(resident), src);
    const long long gu = __shfl_sync(kFullWarp, static_cast<long long>(v.gid), mc);
    const bool ranked = lane < wm;
    const int r =
        warp_first(ranked ? ranked_value(u, lane) : -INFINITY, ranked ? lane : wm, span);
    wi = __shfl_sync(kFullWarp, wc, r);
    mi = __shfl_sync(kFullWarp, mc, r);
    done = __shfl_sync(kFullWarp, cu, r);
    was = __shfl_sync(kFullWarp, ru, r) != 0;
    g = __shfl_sync(kFullWarp, gu, r);
  }
  return {wi, mi, done, was, g};
}

// Step s of the warp instance against the carry (tails t, slots res, in
// shared memory): `warp_pick`, then lane 0 moves the carry and writes the
// decision's column (step.cuh's `emit`, its worker and model taken from
// the shuffles).  The caller synchronises the warp before the next step
// reads the carry.
__device__ __forceinline__ void warp_step(const ScanArgs& p, int s, const LaneStep& v,
                                          const LaneCell& c, int lane, int span, double* t,
                                          int64_t* res) {
  const WarpPick d = warp_pick(p, v, c, lane, span, t, res);
  if (lane == 0) {
    const double start = t[d.wi];
    advance(p, d.wi, d.g, d.was, d.done, t, res);
    p.out[s] = d.wi;
    p.out[(size_t)p.ld + s] = d.mi;
    p.out[2 * (size_t)p.ld + s] = start;
    p.out[3 * (size_t)p.ld + s] = d.done - start;
  }
}

// --------------------------------------------------------- block instance

// Member values phase C loads before it adds them (step.cuh's depth).
constexpr int kDepth = kMeanDepth;

// One thread's tables of one step, raw as loaded: the step's application,
// member count, penalty and fixed choice; of the (w, m) cell `tid` (tid <
// W * M) its latency, swap, residency id and validity; of rank `tid` (tid <
// 32) of the preference permutation its cell.
struct ThreadStep {
  int64_t a = 0, pen = 0, fixed = 0, gid = -2, pref = 0;
  double size = 1.0, lat = 0.0, swap = 0.0;
  unsigned char valid = 0;
};

__device__ __forceinline__ void fetch_thread(const ScanArgs& p, int s, int64_t a, int tid,
                                             ThreadStep& v) {
  const int W = p.W, M = p.M, wm = W * M;
  v.a = a;
  v.size = p.bsize[s];
  v.pen = p.pen[a];
  if (tid < wm) {
    const int w = tid / M;
    const int m = tid - w * M;
    v.lat = p.lat[((size_t)s * W + w) * M + m];
    v.swap = p.swap[((size_t)a * W + w) * M + m];
    v.gid = p.gid[(size_t)a * M + m];
    v.valid = p.valid[(size_t)a * M + m];
    if (tid < warpSize) v.pref = p.pref[(size_t)a * wm + tid];
  }
  if (p.fixed != nullptr && tid == 0) v.fixed = p.fixed[s];
}

// Step s of the block instance against the carry (tails t, slots res):
// the per-step rows go to `rows`, the Eq. 2 tile to p.tile.  Returns the
// pick in thread 0; the caller moves the carry there.
__device__ __forceinline__ int block_step(const ScanArgs& p, int s, const ThreadStep& v,
                                          const StepRows& rows, const double* t,
                                          const int64_t* res) {
  const int W = p.W, M = p.M, K = p.K, B = p.B, wm = W * M;
  const int tid = threadIdx.x;
  const int64_t a = v.a;
  const int members = static_cast<int>(v.size);

  // A. Completions and residency flags.
  for (int c = tid; c < wm; c += blockDim.x) {
    const int w = c / M;
    const int m = c - w * M;
    const bool mine = c == tid;
    const bool resident =
        resident_in(p, res + (size_t)w * K, mine ? v.gid : p.gid[(size_t)a * M + m]);
    rows.flag[c] = resident;
    const double sw = resident ? 0.0 : (mine ? v.swap : p.swap[((size_t)a * W + w) * M + m]);
    rows.comp[c] = (t[w] + sw) + (mine ? v.lat : p.lat[((size_t)s * W + w) * M + m]);
  }
  __syncthreads();
  if (p.fixed != nullptr) return static_cast<int>(v.fixed);

  // B. The Eq. 2 tile over the step's real members.
  const int pen = static_cast<int>(v.pen);
  const unsigned per_w = (unsigned)members * M;
  for (unsigned c = tid; c < (unsigned)W * per_w; c += blockDim.x) {
    const unsigned w = c / per_w;
    const unsigned r1 = c - w * per_w;
    const int b = static_cast<int>(r1 / M);
    const int m = static_cast<int>(r1 - b * M);
    p.tile[(size_t)w * B * M + (size_t)b * M + m] =
        eq2_utility<double>(pen, p.acc[((size_t)s * B + b) * M + m],
                            p.deadlines[(size_t)s * B + b], rows.comp[w * M + m]);
  }
  __syncthreads();

  // C. Member means: one chain of adds in member order, its loads issued
  // kDepth members ahead of the adds.
  for (int c = tid; c < wm; c += blockDim.x) {
    const int w = c / M;
    const int m = c - w * M;
    const double* col = p.tile + (size_t)w * B * M + m;
    const double* mk = p.mask + (size_t)s * B;
    double sum = 0.0;
    int b = 0;
    for (; b + kDepth <= members; b += kDepth) {
      double x[kDepth], y[kDepth];
#pragma unroll
      for (int j = 0; j < kDepth; ++j) {
        x[j] = col[(size_t)(b + j) * M];
        y[j] = mk[b + j];
      }
#pragma unroll
      for (int j = 0; j < kDepth; ++j) sum = sum + x[j] * y[j];
    }
    for (; b < members; ++b) sum = sum + col[(size_t)b * M] * mk[b];
    const bool valid = c == tid ? v.valid != 0 : p.valid[(size_t)a * M + m] != 0;
    rows.umean[c] = valid ? (v.size == 1.0 ? sum : sum / v.size) : -INFINITY;
  }
  __syncthreads();

  // D. The first maximum over the preference permutation, in warp 0: lane
  // l takes ranks l, l + 32, ..., then the lanes reduce.
  int pick = 0;
  if (tid < warpSize) {
    double best = -INFINITY;
    int rank = wm;  // after every real rank
    for (int i = tid; i < wm; i += warpSize) {
      const int cell = i == tid ? static_cast<int>(v.pref)
                                : static_cast<int>(p.pref[(size_t)a * wm + i]);
      take_first(best, rank, ranked_value(rows.umean[cell], i), i);
    }
    const int r = warp_first(best, rank, warpSize);
    pick = r < warpSize ? __shfl_sync(kFullWarp, static_cast<int>(v.pref), r)
                        : static_cast<int>(p.pref[(size_t)a * wm + r]);
  }
  return pick;
}
