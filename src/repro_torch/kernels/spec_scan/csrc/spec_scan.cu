// The chunked (speculative) selection scan of the compiled window pipeline,
// for Hopper, sm_90a.
//
// Replaces the compiled speculative drivers of the reference's window
// programs (src/repro/core/pipeline.py:244 `_spec_select`, used by
// `_per_request_program` :459 and `_grouped_program` :543, and :691
// `_spec_select_mw`, used by `_multiworker_program` :639; a
// `lax.while_loop`, no Pallas kernel).  The decisions are the sequential
// scan's (../../selection_scan/csrc/selection_scan.cu), taken C = `chunk`
// at a time with the same step (../../selection_scan/csrc/step.cuh and,
// for its warp instance, ahead.cuh):
//
//   round at position p, over the kn = min(C, S - p) positions left:
//     speculate   every position k < kn scored against the boundary carry
//                 (t, res): the (kn, W, M) completions, the (kn, W, B, M)
//                 Eq. 2 tile, the member means, a pick per position;
//     reconstruct the pre-state (t_k, res_k) of each position k >= 1 from
//                 the speculated picks before it, one after the other;
//     validate    every position k >= 1 scored again, against its own
//                 pre-state;
//     accept      a = first mismatch + 1, or kn; the outputs of positions
//                 < a; the carry moves to the last accepted decision
//                 applied to its pre-state.
//
// Position 0's pre-state is the boundary carry itself, so its speculated
// pick is already the validated one: it is not scored twice and never
// conflicts, and a round of one position (C = 1, or the window's last) is
// one scoring pass, the sequential scan's step.  The reference pads its
// tables by C inert rows and compares all C positions; a padded row picks
// column 0 in both passes, so it never conflicts, and the accepted count
// is clamped to S - p.  This kernel runs the kn real positions only, which
// gives the same a, the same rounds and the same conflicts.
//
// Numerics: bit-identical to the sequential scan by the reference's
// induction.  An accepted position's pre-state is exact (every decision
// before it matched), and its validation takes the sequential step's
// instructions (step.cuh or ahead.cuh's `warp_pick`, compiled with
// --fmad=false here too); the rebuild takes step.cuh's update (lru.cuh's
// rule, from one state's slots into the next's).
//
// What bounds it: a chain of dependent decisions, traded for rounds: with
// no conflict a round takes C decisions for two scoring passes over C
// positions in parallel plus one thread's chain of C - 1 carry updates;
// each conflict costs a round that accepts fewer.  The second design
// keeps everything off that thread's chain that can be:
//   * the chain's inputs are staged: while the speculation pass runs, the
//     thread or lane that picks a position writes its decision's model id,
//     raw swap and latency into shared memory, and the LRU byte sizes are
//     copied there at the start; the rebuild then reads shared memory
//     only, and writes each position's pre-state slots there too (in
//     device memory when they do not fit beside the carry);
//   * the accept is parallel: warp 0 finds the first conflict with a
//     ballot, and the accepted rows are written a thread each (every
//     row's start is its pre-state tail, all known after the rebuild);
//   * warp instance (a step's W * B * M cells fit one warp: per-request
//     tables on up to five workers): a round's positions go a warp each,
//     lane (w * B + b) * M + m owning cell (w, b, m), ahead.cuh's
//     `warp_pick` scoring a position with shuffles and no block barrier;
//     min(C, 16) warps, so a round of LO-EDF's 16 positions pays no idle
//     threads at its barriers.  A warp keeps its first position's tables
//     in registers from the speculation to the validation, and while the
//     rebuild runs fetches its first position of the next round (the
//     position it will score if no conflict comes);
//   * block instance (wider steps: grouped and pooled tables): step.cuh's
//     block routines, the Eq. 2 tile in device memory, phases B and C
//     spread over a thread-block cluster of `blocks` blocks (neighbouring
//     SMs): the leader block holds the carry and the round's rows and
//     publishes each pass (position, first position, count, cells a
//     worker) in its shared memory; every block copies its completions
//     through distributed shared memory and writes its slice of the
//     pass's tile cells; after a cluster barrier every warp of the
//     cluster sums columns (one chain of adds per column, in member order,
//     the members' values loaded 32 at a time by the warp's lanes) and
//     writes the means into the leader's shared memory; a cluster barrier
//     comes before the leader's picks.  The rebuild of a one-worker round
//     carries the tail (and the slot1 id) in registers.
// The launch uses the caller's stream, synchronises nothing and allocates
// nothing; the kernel writes its rounds and conflicts after the
// decisions, so one read-back brings both.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../selection_scan/csrc/ahead.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;     // the block instance's threads a block
constexpr int kMaxWarps = 16;     // the warp instance's warps (a position each)
constexpr int kMaxBlocks = 8;     // blocks of a cluster (the portable size)
constexpr size_t kNone = ~size_t(0);  // a region left in device memory

size_t align8(size_t n) { return (n + 7) & ~size_t(7); }

// Shared bytes the wrapper checks (P7): the (W, K) slots; the round's
// (C, W) pre-state tails, (C, W, M) completions and means, C speculated
// and C validated picks, and (C, W, M) residency flags — the block
// instance's layout, which the warp instance's stays under.
size_t spec_smem_bytes(int C, int W, int K, int M) {
  const size_t cells = (size_t)C * W * M;
  return 8 * ((size_t)W * K + (size_t)C * W + 2 * cells + C) + cells;
}

// Byte offsets of one launch's shared memory.  The first part is the
// instance's own (at most spec_smem_bytes); then, each where it still
// fits the device's per-block maximum, the staged chain inputs (model id,
// raw swap, latency a position), the pre-state slots of positions 1..C-1
// and the LRU byte sizes; a region that does not fit stays in device
// memory (kNone).
struct SpecLayout {
  size_t t_st, comp, umean, flag, done, gval, pick_s, pick_t, was;
  size_t stage, rst, sizes;
  size_t bytes;
};

SpecLayout spec_layout(bool warp, int C, int W, int K, int M, int G, bool lru, size_t optin) {
  SpecLayout L;
  const size_t cells = (size_t)C * W * M;
  size_t at = 8 * (size_t)W * K;  // the carry's slots first
  L.t_st = at;
  at += 8 * (size_t)C * W;
  L.comp = L.umean = L.flag = L.done = L.gval = L.was = kNone;
  if (warp) {
    L.done = at;
    at += 8 * (size_t)C;
    L.gval = at;
    at += 8 * (size_t)C;
  } else {
    L.comp = at;
    at += 8 * cells;
    L.umean = at;
    at += 8 * cells;
  }
  L.pick_s = at;
  at += 4 * (size_t)C;
  L.pick_t = at;
  at += 4 * (size_t)C;
  if (warp) {
    L.was = at;
    at += C;
  } else {
    L.flag = at;
    at += cells;
  }
  // The optional regions leave room for the kernels' static shared memory.
  const size_t room = optin > 1024 ? optin - 1024 : 0;
  auto place = [&](size_t bytes) {
    const size_t off = align8(at);
    if (off + bytes > room) return kNone;
    at = off + bytes;
    return off;
  };
  L.stage = place(24 * (size_t)C);
  L.rst = place(8 * (size_t)(C - 1) * W * K);
  L.sizes = lru ? place(8 * (size_t)W * G) : kNone;
  L.bytes = at;
  return L;
}

// Device-memory homes of the regions a layout leaves out of shared memory.
struct SpecBufs {
  int64_t* rst;   // (C - 1, W, K) pre-state slots of positions 1..C-1
  double* stage;  // (3, C): model ids (as int64), raw swaps, latencies
};

// The round's chain inputs and pre-states wherever the layout put them.
struct RoundMem {
  int64_t* sg;   // (C,) the speculated decision's model id
  double* ssw;   // (C,) its raw swap
  double* slt;   // (C,) its latency
  int64_t* rst;  // (C - 1, W, K)
};

__device__ __forceinline__ RoundMem round_mem(unsigned char* smem, const SpecLayout& L,
                                              const SpecBufs& bufs, int C) {
  RoundMem r;
  double* stage = L.stage != kNone ? reinterpret_cast<double*>(smem + L.stage) : bufs.stage;
  r.sg = reinterpret_cast<int64_t*>(stage);
  r.ssw = stage + C;
  r.slt = stage + 2 * C;
  r.rst = L.rst != kNone ? reinterpret_cast<int64_t*>(smem + L.rst) : bufs.rst;
  return r;
}

// The kernel's copy of the arguments, its LRU sizes read from shared
// memory where the layout staged them (copied by the whole block; the
// caller synchronises before use).
__device__ __forceinline__ ScanArgs stage_sizes(const ScanArgs& p, unsigned char* smem,
                                                const SpecLayout& L) {
  ScanArgs q = p;
  if (L.sizes != kNone) {
    double* s = reinterpret_cast<double*>(smem + L.sizes);
    for (int i = threadIdx.x; i < p.W * p.G; i += blockDim.x) s[i] = p.sizes[i];
    q.sizes = s;
  }
  return q;
}

// The pre-state slots of position k of the round: the carry for k = 0.
__device__ __forceinline__ int64_t* state_row(int64_t* res, int64_t* rst, int k, int wk) {
  return k ? rst + (size_t)(k - 1) * wk : res;
}

// Thread 0: the pre-states of positions 1..kn-1 from the speculated picks
// before them, one after the other, from the staged inputs: position k + 1
// takes position k's tails and slots with decision k applied (the
// completion (t + (resident ? 0 : swap)) + lat on its worker, the slot1 id
// or the LRU touch).
// rebuild on one worker: the tail carried in a register (and the slot1
// id), the inputs loaded ahead of the chain (four positions' at a time
// with one slot, a position ahead with LRU slots), so the chain waits on
// its float64 adds and not on shared memory.
__device__ void rebuild_one(const ScanArgs& q, int kn, const RoundMem& mem, double* t_st,
                            const int64_t* res) {
  const int K = q.K;
  double t = t_st[0];
  if (q.slot1) {  // four positions' inputs loaded together
    constexpr int kU = 4;
    int64_t slot = res[0];
    int k = 0;
    for (; k + kU < kn; k += kU) {
      int64_t gs[kU];
      double sws[kU], lts[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        gs[u] = mem.sg[k + u];
        sws[u] = mem.ssw[k + u];
        lts[u] = mem.slt[k + u];
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        t = (t + (slot == gs[u] ? 0.0 : sws[u])) + lts[u];
        slot = gs[u];
        t_st[k + u + 1] = t;
        mem.rst[k + u] = slot;
      }
    }
    for (; k + 1 < kn; ++k) {
      const int64_t g = mem.sg[k];
      t = (t + (slot == g ? 0.0 : mem.ssw[k])) + mem.slt[k];
      slot = g;
      t_st[k + 1] = t;
      mem.rst[k] = slot;
    }
    return;
  }
  int64_t g = mem.sg[0];
  double sw = mem.ssw[0], lt = mem.slt[0];
  for (int k = 0; k + 1 < kn; ++k) {
    const int64_t g_next = mem.sg[k + 1];
    const double sw_next = mem.ssw[k + 1], lt_next = mem.slt[k + 1];
    const int64_t* rin = k ? mem.rst + (size_t)(k - 1) * K : res;
    const bool was = resident_in(q, rin, g);
    t = (t + (was ? 0.0 : sw)) + lt;
    t_st[k + 1] = t;
    touch_lru_copy(rin, mem.rst + (size_t)k * K, K, g, was, q.sizes, q.cap);
    g = g_next;
    sw = sw_next;
    lt = lt_next;
  }
}

__device__ void rebuild(const ScanArgs& q, int kn, const int* pick_s, const RoundMem& mem,
                        double* t_st, int64_t* res) {
  const int W = q.W, M = q.M, K = q.K;
  const int wk = W * K;
  if (W == 1) {
    rebuild_one(q, kn, mem, t_st, res);
    return;
  }
  for (int k = 0; k + 1 < kn; ++k) {
    const int wi = pick_s[k] / M;
    const int64_t g = mem.sg[k];
    const double sw = mem.ssw[k];
    const double lt = mem.slt[k];
    const int64_t* rin = state_row(res, mem.rst, k, wk);
    int64_t* rout = mem.rst + (size_t)k * wk;
    const double* tin = t_st + (size_t)k * W;
    double* tout = t_st + (size_t)(k + 1) * W;
    for (int i = 0; i < W; ++i) tout[i] = tin[i];
    const bool was = resident_in(q, rin + (size_t)wi * K, g);
    tout[wi] = (tin[wi] + (was ? 0.0 : sw)) + lt;
    for (int w = 0; w < W; ++w) {
      if (w == wi) continue;
#pragma unroll 4
      for (int i = 0; i < K; ++i) rout[(size_t)w * K + i] = rin[(size_t)w * K + i];
    }
    if (q.slot1) {
      rout[wi] = g;
    } else {
      touch_lru_copy(rin + (size_t)wi * K, rout + (size_t)wi * K, K, g, was,
                     q.sizes + (size_t)wi * q.G, q.cap);
    }
  }
}

// Warp 0: the first position k in [1, kn) whose validated pick differs
// from its speculated one, by ballots 32 positions at a time; kn if none.
__device__ __forceinline__ int first_conflict(const int* pick_s, const int* pick_t, int kn) {
  const int lane = threadIdx.x % warpSize;
  for (int k0 = 1; k0 < kn; k0 += warpSize) {
    const int k = k0 + lane;
    const unsigned mis = __ballot_sync(kFullWarp, k < kn && pick_t[k] != pick_s[k]);
    if (mis) return k0 + __ffs(mis) - 1;
  }
  return kn;
}

// The whole block: the carry becomes the pre-state of position k (k >= 1).
__device__ __forceinline__ void load_state(int64_t* res, const int64_t* rst, double* t_st, int k,
                                           int W, int wk) {
  if (k == 0) return;
  const int64_t* row = rst + (size_t)(k - 1) * wk;
  for (int i = threadIdx.x; i < wk; i += blockDim.x) res[i] = row[i];
  for (int i = threadIdx.x; i < W; i += blockDim.x) t_st[i] = t_st[(size_t)k * W + i];
}

__device__ __forceinline__ void write_counts(const ScanArgs& p, long long rounds,
                                             long long conflicts) {
  p.out[p.S] = static_cast<double>(rounds);
  p.out[(size_t)p.ld + p.S] = static_cast<double>(conflicts);
  p.out[2 * (size_t)p.ld + p.S] = 0.0;
  p.out[3 * (size_t)p.ld + p.S] = 0.0;
}

// ---------------------------------------------------------- warp instance

__global__ void __launch_bounds__(kMaxWarps * 32)
    spec_scan_warp_kernel(ScanArgs p, int C, SpecLayout L, SpecBufs bufs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = p.W, M = p.M, K = p.K, B = p.B;
  const int wk = W * K;
  int64_t* res = reinterpret_cast<int64_t*>(smem_raw);              // (W, K) carry slots
  double* t_st = reinterpret_cast<double*>(smem_raw + L.t_st);      // (C, W) pre-state tails
  double* done = reinterpret_cast<double*>(smem_raw + L.done);      // (C,) completions
  int64_t* gval = reinterpret_cast<int64_t*>(smem_raw + L.gval);    // (C,) model ids
  int* pick_s = reinterpret_cast<int*>(smem_raw + L.pick_s);        // (C,)
  int* pick_t = reinterpret_cast<int*>(smem_raw + L.pick_t);        // (C,)
  unsigned char* was = smem_raw + L.was;                            // (C,) resident flags
  const RoundMem mem = round_mem(smem_raw, L, bufs, C);
  __shared__ int s_pos, s_a, s_conflict;
  __shared__ long long s_rounds, s_conflicts;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int nw = blockDim.x / 32;

  const ScanArgs q = stage_sizes(p, smem_raw, L);
  for (int i = tid; i < wk; i += blockDim.x) res[i] = p.res0[i];
  for (int i = tid; i < W; i += blockDim.x) t_st[i] = p.t0[i];
  if (tid == 0) {
    s_pos = 0;
    s_rounds = 0;
    s_conflicts = 0;
  }
  LaneCell c;
  c.on = lane < W * B * M;
  c.m = lane % M;
  c.b = (lane / M) % B;
  c.w = lane / (B * M);
  c.inv_m = 1.0f / M;
  const int span = pow2_span(W * M);
  // `cur` holds the tables of the warp's first position of the round
  // (speculated, then validated); `nxt` those of its first position of the
  // next round if no conflict comes, fetched while the rebuild runs.
  LaneStep cur, nxt;
  int nxt_s = -1;
  __syncthreads();

  // Lane 0 of the position's warp records its decision: the speculated
  // pick and the chain's inputs (raw swap and latency from the lane that
  // owns (wi, 0, mi)), or the validated pick and what the accept needs.
  auto speculate = [&](int k, const LaneStep& v) {
    const WarpPick d = warp_pick(p, v, c, lane, span, t_st, res);
    const int owner = (d.wi * B) * M + d.mi;
    const double sw = __shfl_sync(kFullWarp, v.swap, owner);
    const double lt = __shfl_sync(kFullWarp, v.lat, owner);
    if (lane == 0) {
      pick_s[k] = d.wi * M + d.mi;
      mem.sg[k] = d.g;
      mem.ssw[k] = sw;
      mem.slt[k] = lt;
      if (k == 0) {
        pick_t[0] = d.wi * M + d.mi;
        done[0] = d.done;
        gval[0] = d.g;
        was[0] = d.was;
      }
    }
  };
  auto validate = [&](int k, const LaneStep& v) {
    const WarpPick d = warp_pick(p, v, c, lane, span, t_st + (size_t)k * W,
                                 state_row(res, mem.rst, k, wk));
    if (lane == 0) {
      pick_t[k] = d.wi * M + d.mi;
      done[k] = d.done;
      gval[k] = d.g;
      was[k] = d.was;
    }
  };

  for (;;) {
    const int pos = s_pos;
    if (pos >= p.S) break;
    const int kn = min(C, p.S - pos);

    // 1. Speculate under the boundary carry, a warp a position.
    for (int k = warp; k < kn; k += nw) {
      const int s = pos + k;
      if (k == warp) {
        if (nxt_s == s) {
          cur = nxt;
        } else {
          fetch_lane(p, s, p.step_app[s], c, lane, cur);
        }
        speculate(k, cur);
      } else {
        LaneStep v;
        fetch_lane(p, s, p.step_app[s], c, lane, v);
        speculate(k, v);
      }
    }
    __syncthreads();
    {  // the warp's first position of the next round, if no conflict comes
      const int s = pos + kn + warp;
      nxt_s = -1;
      if (s < p.S) {
        fetch_lane(p, s, p.step_app[s], c, lane, nxt);
        nxt_s = s;
      }
    }

    if (kn > 1) {
      // 2. Rebuild the pre-states from the staged picks.
      if (tid == 0) rebuild(q, kn, pick_s, mem, t_st, res);
      __syncthreads();
      // 3. Validate positions k >= 1 under their pre-states.
      for (int k = warp; k < kn; k += nw) {
        if (k == 0) continue;
        if (k == warp) {
          validate(k, cur);
        } else {
          LaneStep v;
          fetch_lane(p, pos + k, p.step_app[pos + k], c, lane, v);
          validate(k, v);
        }
      }
      __syncthreads();
    }

    // 4. Accept through the first conflict, inclusive; a row a thread.
    if (warp == 0) {
      const int first = first_conflict(pick_s, pick_t, kn);
      if (lane == 0) {
        s_a = first < kn ? first + 1 : kn;
        s_conflict = first < kn;
      }
    }
    __syncthreads();
    const int a = s_a;
    for (int k = tid; k < a; k += blockDim.x) {
      const int pick = pick_t[k];
      emit(p, pos + k, pick, t_st[(size_t)k * W + pick / M], done[k]);
    }
    __syncthreads();
    // The carry: the last accepted decision on its pre-state.
    const int k = a - 1;
    load_state(res, mem.rst, t_st, k, W, wk);
    __syncthreads();
    if (tid == 0) {
      advance(q, pick_t[k] / M, gval[k], was[k] != 0, done[k], t_st, res);
      s_rounds += 1;
      s_conflicts += s_conflict;
      s_pos = pos + a;
    }
    __syncthreads();
  }
  if (tid == 0) write_counts(p, s_rounds, s_conflicts);
}

// --------------------------------------------------------- block instance

// A pass the leader publishes to the cluster: state 1 a pass over
// positions [k0, kn) of the round at `pos`, per_w cells a worker; state 0
// the end of the window.
struct Pass {
  int state, pos, k0, kn;
  unsigned per_w;
};

// This block's slice of a pass's (kn - k0) * W * per_w tile cells.
__device__ __forceinline__ void pass_slice(const ScanArgs& p, const double* comp, const Pass& q,
                                           unsigned rank, unsigned blocks) {
  const unsigned long long cells = (unsigned long long)(q.kn - q.k0) * p.W * q.per_w;
  pass_tile(p, comp, q.pos, q.k0, q.kn, q.per_w, static_cast<unsigned>(cells * rank / blocks),
            static_cast<unsigned>(cells * (rank + 1) / blocks));
}

// Phases B and C of a pass on one block of the cluster: its slice of the
// tile, a cluster barrier (every slice written), its warps' columns summed
// into the leader's means `umean`, a cluster barrier (every mean written).
__device__ void pass_cluster(cg::cluster_group& cl, const ScanArgs& p, const double* comp,
                             double* umean, const Pass& q) {
  const unsigned rank = cl.block_rank(), blocks = cl.num_blocks();
  pass_slice(p, comp, q, rank, blocks);
  __threadfence();
  cl.sync();  // every slice of the tile is written
  const int warps = blockDim.x / warpSize;
  pass_means_warps(p, p.tile, umean, q.pos, q.k0, q.kn,
                   static_cast<int>(rank) * warps + threadIdx.x / warpSize,
                   static_cast<int>(blocks) * warps);
  cl.sync();  // every mean is in the leader's shared memory
}

// The leader's part of a pass whose completions are in its rows (and
// synchronised): publish it, then its part of phases B and C.
__device__ void leader_pass(cg::cluster_group& cl, const ScanArgs& p, const StepRows& rows,
                            Pass* s_pass, int pos, int k0, int kn, unsigned per_w) {
  if (threadIdx.x == 0) *s_pass = Pass{1, pos, k0, kn, per_w};
  cl.sync();  // the pass and its completions are visible to the cluster
  pass_cluster(cl, p, rows.comp, rows.umean, *s_pass);
}

// The other blocks of the cluster: their part of every pass, from the
// leader's completions copied through distributed shared memory, their
// columns' means written back there.
__device__ void follower(cg::cluster_group& cl, const ScanArgs& p, double* comp, double* umean,
                         Pass* s_pass) {
  const int wm = p.W * p.M;
  const Pass* lp = cl.map_shared_rank(s_pass, 0);
  const double* lcomp = cl.map_shared_rank(comp, 0);
  double* lumean = cl.map_shared_rank(umean, 0);
  for (;;) {
    cl.sync();  // a pass published
    const Pass q = *lp;
    if (!q.state) break;
    for (int i = q.k0 * wm + threadIdx.x; i < q.kn * wm; i += blockDim.x) comp[i] = lcomp[i];
    __syncthreads();
    pass_cluster(cl, p, comp, lumean, q);
  }
}

__global__ void __launch_bounds__(kThreads)
    spec_scan_block_kernel(ScanArgs p, int C, SpecLayout L, SpecBufs bufs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  const int W = p.W, M = p.M, K = p.K;
  const int wk = W * K;
  const int wm = W * M;
  StepRows rows;
  rows.comp = reinterpret_cast<double*>(smem_raw + L.comp);   // (C, W, M)
  rows.umean = reinterpret_cast<double*>(smem_raw + L.umean); // (C, W, M)
  rows.flag = smem_raw + L.flag;                              // (C, W, M)
  __shared__ Pass s_pass;
  __shared__ unsigned s_most;
  __shared__ int s_pos, s_a, s_conflict;
  __shared__ long long s_rounds, s_conflicts;
  const int tid = threadIdx.x;
  cl.sync();  // every block runs before any reads another's shared memory
  if (cl.block_rank() != 0) {
    follower(cl, p, rows.comp, rows.umean, &s_pass);
    cl.sync();  // the leader leaves after every block has read its last pass
    return;
  }

  int64_t* res = reinterpret_cast<int64_t*>(smem_raw);          // (W, K) carry slots
  double* t_st = reinterpret_cast<double*>(smem_raw + L.t_st);  // (C, W) pre-state tails
  int* pick_s = reinterpret_cast<int*>(smem_raw + L.pick_s);    // (C,)
  int* pick_t = reinterpret_cast<int*>(smem_raw + L.pick_t);    // (C,)
  const RoundMem mem = round_mem(smem_raw, L, bufs, C);
  const ScanArgs q = stage_sizes(p, smem_raw, L);
  for (int i = tid; i < wk; i += blockDim.x) res[i] = p.res0[i];
  for (int i = tid; i < W; i += blockDim.x) t_st[i] = p.t0[i];
  if (tid == 0) {
    s_pos = 0;
    s_rounds = 0;
    s_conflicts = 0;
  }
  const bool scored = p.fixed == nullptr;
  __syncthreads();

  for (;;) {
    const int pos = s_pos;
    if (pos >= p.S) break;
    const int kn = min(C, p.S - pos);

    // 1. Speculate under the boundary carry.
    pass_completions(p, rows, pos, 0, kn, t_st, 0, res, 0);
    if (tid < 32) {
      const unsigned most = run_most(p, pos, kn);
      if (tid == 0) s_most = most;
    }
    __syncthreads();
    const unsigned per_w = s_most * M;
    if (scored) leader_pass(cl, p, rows, &s_pass, pos, 0, kn, per_w);
    pass_picks(p, rows, pos, 0, kn, pick_s);
    // The thread that picked position k stages its chain inputs.
    for (int k = tid; k + 1 < kn; k += blockDim.x) {
      const int s = pos + k;
      const int wi = pick_s[k] / M;
      const int mi = pick_s[k] - wi * M;
      const int64_t a = p.step_app[s];
      mem.sg[k] = p.gid[(size_t)a * M + mi];
      mem.ssw[k] = p.swap[((size_t)a * W + wi) * M + mi];
      mem.slt[k] = p.lat[((size_t)s * W + wi) * M + mi];
    }
    __syncthreads();

    if (kn > 1) {
      // 2. Rebuild the pre-states from the staged picks.
      if (tid == 0) rebuild(q, kn, pick_s, mem, t_st, res);
      __syncthreads();
      // 3. Validate positions k >= 1 under their pre-states.
      pass_completions(p, rows, pos, 1, kn, t_st + W, W, mem.rst, wk);
      __syncthreads();
      if (scored) leader_pass(cl, p, rows, &s_pass, pos, 1, kn, per_w);
      pass_picks(p, rows, pos, 1, kn, pick_t);
      __syncthreads();
    }

    // 4. Accept through the first conflict, inclusive; a row a thread.
    if (tid < 32) {
      const int first = first_conflict(pick_s, pick_t, kn);
      if (tid == 0) {
        s_a = first < kn ? first + 1 : kn;
        s_conflict = first < kn;
      }
    }
    __syncthreads();
    const int a = s_a;
    for (int k = tid; k < a; k += blockDim.x) {
      const int pick = k ? pick_t[k] : pick_s[0];
      emit(p, pos + k, pick, t_st[(size_t)k * W + pick / M], rows.comp[(size_t)k * wm + pick]);
    }
    __syncthreads();
    // The carry: the last accepted decision on its pre-state.
    const int k = a - 1;
    load_state(res, mem.rst, t_st, k, W, wk);
    __syncthreads();
    if (tid == 0) {
      const int pick = k ? pick_t[k] : pick_s[0];
      advance(q, pick / M, pick_id(p, pos + k, pick), rows.flag[(size_t)k * wm + pick] != 0,
              rows.comp[(size_t)k * wm + pick], t_st, res);
      s_rounds += 1;
      s_conflicts += s_conflict;
      s_pos = pos + a;
    }
    __syncthreads();
  }
  if (tid == 0) {
    write_counts(p, s_rounds, s_conflicts);
    s_pass.state = 0;
  }
  cl.sync();  // the end published
  cl.sync();  // every block has read it
}

}  // namespace

extern "C" {

// Every pointer is a contiguous tensor on the current device, shaped as
// ScanArgs says (`out` (4, S + 1)); `fixed` may be null; `res_st` holds
// (C - 1, W, K) int64 pre-state slots and `stage` (3, C) float64 chain
// inputs, used where they do not fit shared memory.  `warp` runs the
// warp instance (W * B * M <= 32: min(C, 16) warps, a position each),
// otherwise the block instance runs in a cluster of `blocks` blocks (1 to
// 8) of kThreads threads.  Returns a cudaError_t (0 on success).
int spec_scan_f64(const void* t0, const void* res0, const void* sizes, double cap,
                  const void* acc, const void* mask, const void* deadlines, const void* bsize,
                  const void* lat, const void* step_app, const void* swap, const void* gid,
                  const void* valid, const void* pen, const void* pref, const void* fixed,
                  void* tile, void* out, void* res_st, void* stage, int S, int B, int M, int W,
                  int K, int G, int slot1, int C, int warp, int blocks, void* stream) {
  if (S < 1 || B < 1 || M < 1 || W < 1 || K < 1 || C < 1 || (slot1 && K != 1) ||
      (!slot1 && G < 1) || (size_t)C * W * B * M >> 32 || blocks < 1 || blocks > kMaxBlocks ||
      (warp && ((size_t)W * B * M > 32 || blocks != 1))) {
    return (int)cudaErrorInvalidValue;
  }
  // The carry's slots and the round's rows live in shared memory sized
  // from C, W, K and M; past the default 48 KiB the kernel opts in to the
  // device's per-block maximum, and a sum beyond that is refused (the
  // wrapper refuses it first).  What else fits is staged there too.
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return (int)err;
  if (spec_smem_bytes(C, W, K, M) > (size_t)optin) return (int)cudaErrorInvalidValue;
  const SpecLayout L = spec_layout(warp != 0, C, W, K, M, G, !slot1, (size_t)optin);
  const void* kernel = warp ? reinterpret_cast<const void*>(spec_scan_warp_kernel)
                            : reinterpret_cast<const void*>(spec_scan_block_kernel);
  if (L.bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)L.bytes);
    if (err != cudaSuccess) return (int)err;
  }
  ScanArgs a;
  a.t0 = static_cast<const double*>(t0);
  a.res0 = static_cast<const int64_t*>(res0);
  a.sizes = static_cast<const double*>(sizes);
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
  a.pref = static_cast<const int64_t*>(pref);
  a.fixed = static_cast<const int64_t*>(fixed);
  a.tile = static_cast<double*>(tile);
  a.out = static_cast<double*>(out);
  a.cap = cap;
  a.S = S;
  a.B = B;
  a.M = M;
  a.W = W;
  a.K = K;
  a.G = G;
  a.slot1 = slot1;
  a.ld = S + 1;
  SpecBufs bufs;
  bufs.rst = static_cast<int64_t*>(res_st);
  bufs.stage = static_cast<double*>(stage);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (warp) {
    spec_scan_warp_kernel<<<1, 32 * (C < kMaxWarps ? C : kMaxWarps), L.bytes, st>>>(a, C, L,
                                                                                     bufs);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = L.bytes;
  config.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, spec_scan_block_kernel, a, C, L, bufs);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
