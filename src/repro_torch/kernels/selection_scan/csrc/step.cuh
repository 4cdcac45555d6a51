// The step of the port's selection scans: the arguments, the scoring of a
// run of positions against their carries, and the carry update of one
// decision.  Included by selection_scan.cu (the sequential scan: one
// position at a time) and ../../spec_scan/csrc/spec_scan.cu (the chunked
// scan: C positions a round); both are compiled with --fmad=false, so the
// two scans take each decision with the same arithmetic.
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

// Scores positions k in [k0, kn) of the run starting at step `pos`, each
// against its carry — tails t + (k - k0) * ts, slots r + (k - k0) * rs
// (ts = rs = 0: one carry for every position) — and writes each pick to
// picks[k].  Phase B covers members below the most any of these positions
// has, not the table's padded B: warp 0 finds it during phase A of a
// speculation pass (k0 = 0), and the validation pass (k0 = 1) that
// follows reuses it.  Four phases, the first three ended by a barrier:
//   A. per (position, worker, model) cell: whether the model is resident
//      under the carry, and the completion (t + swap_eff) + lat;
//   B. per (position, worker, member, model) cell of the position's real
//      members: the Eq. 2 value (K1's arithmetic, penalty.cuh), into the
//      tile in device memory (a group of 1,300 members on four workers
//      does not fit shared memory);
//   C. per (position, worker, model) column: one chain of member adds in
//      member order, then one divide; -inf for an invalid (padded) model;
//   D. per position: the first maximum over the preference permutation,
//      or the fixed choice (MaxAcc: B and C are skipped).
// Members past a step's count add exact zeros in the reference and are
// skipped.  A thread keeps its position's step values (application,
// member count, penalty) while its cells stay in that position; `One`
// instantiates the run of one position (the sequential scan's step), where
// they are loop-invariant and the loops index one step's rows.  Cell
// indices are 32-bit (the launch refuses a (C, W, B, M)
// tile of 2^32 cells).  D ends with no barrier: picks[k] is written by
// thread k - k0 (mod the block), and a caller that reads it from another
// thread synchronises first.
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

template <bool One>
__device__ void score_steps(const ScanArgs& p, const StepRows& rows, int pos, int k0, int kn,
                            const double* t, int ts, const int64_t* r, int rs, int* picks) {
  const int W = p.W, M = p.M, K = p.K, B = p.B;
  const int wm = W * M;
  const int tid = threadIdx.x;
  const int n = One ? 1 : kn - k0;
  StepView v;
  if (One) view_step(p, pos + k0, v);

  // A. Completions and residency flags.
  for (int c = tid; c < n * wm; c += blockDim.x) {
    const int j = One ? 0 : c / wm;
    const int k = k0 + j;
    const int cell = c - j * wm;
    const int w = cell / M;
    const int m = cell - w * M;
    if (!One) view_step(p, pos + k, v);
    const bool resident =
        resident_in(p, r + (size_t)j * rs + (size_t)w * K, p.gid[(size_t)v.a * M + m]);
    rows.flag[(size_t)k * wm + cell] = resident;
    const double sw = resident ? 0.0 : p.swap[((size_t)v.a * W + w) * M + m];
    rows.comp[(size_t)k * wm + cell] =
        (t[(size_t)j * ts + w] + sw) + p.lat[((size_t)v.s * W + w) * M + m];
  }
  __shared__ unsigned most;  // the run's most members: phase B's bound
  if (!One && B > 1 && k0 == 0 && tid < warpSize) {
    unsigned mine = 0;
    for (int k = k0 + tid; k < kn; k += warpSize) {
      mine = max(mine, static_cast<unsigned>(p.bsize[pos + k]));
    }
    mine = __reduce_max_sync(0xffffffffu, mine);
    if (tid == 0) most = mine;
  }
  __syncthreads();

  if (p.fixed != nullptr) {
    for (int k = k0 + tid; k < kn; k += blockDim.x) picks[k] = static_cast<int>(p.fixed[pos + k]);
    return;
  }

  // B. The Eq. 2 tile of every position over its real members.
  const unsigned per_w = (One ? static_cast<unsigned>(v.members) : B > 1 ? most : 1u) * M;
  const unsigned per_k = (unsigned)W * per_w;
  for (unsigned c = tid; c < (unsigned)n * per_k; c += blockDim.x) {
    const unsigned j = One ? 0u : c / per_k;
    const unsigned r0 = c - j * per_k;
    const unsigned w = r0 / per_w;
    const unsigned r1 = r0 - w * per_w;
    const int b = static_cast<int>(r1 / M);
    const int m = static_cast<int>(r1 - b * M);
    const int k = k0 + static_cast<int>(j);
    if (!One) {
      view_step(p, pos + k, v);
      if (b >= v.members) continue;
    }
    p.tile[((size_t)k * W + w) * B * M + (size_t)b * M + m] =
        eq2_utility<double>(v.pen, p.acc[((size_t)v.s * B + b) * M + m],
                            p.deadlines[(size_t)v.s * B + b], rows.comp[(size_t)k * wm + w * M + m]);
  }
  __syncthreads();

  // C. Member means.
  for (int c = tid; c < n * wm; c += blockDim.x) {
    const int k = k0 + (One ? 0 : c / wm);
    const int cell = c - (k - k0) * wm;
    const int w = cell / M;
    const int m = cell - w * M;
    if (!One) view_step(p, pos + k, v);
    const double* col = p.tile + ((size_t)k * W + w) * B * M + m;
    const double* mk = p.mask + (size_t)v.s * B;
    double sum = 0.0;
    for (int b = 0; b < v.members; ++b) sum = sum + col[(size_t)b * M] * mk[b];
    rows.umean[(size_t)k * wm + cell] = p.valid[(size_t)v.a * M + m] ? sum / v.size : -INFINITY;
  }
  __syncthreads();

  // D. Each position's first maximum over its preference permutation
  // (none without one: the caller picks from the means).
  if (p.pref == nullptr) return;
  for (int k = k0 + tid; k < kn; k += blockDim.x) {
    if (!One) view_step(p, pos + k, v);
    const int64_t* pr = p.pref + (size_t)v.a * wm;
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

// score_steps over positions [k0, kn), through the one-position instance
// when the run has one.
__device__ __forceinline__ void score(const ScanArgs& p, const StepRows& rows, int pos, int k0,
                                      int kn, const double* t, int ts, const int64_t* r, int rs,
                                      int* picks) {
  if (kn - k0 == 1) {
    score_steps<true>(p, rows, pos, k0, kn, t, ts, r, rs, picks);
  } else {
    score_steps<false>(p, rows, pos, k0, kn, t, ts, r, rs, picks);
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
