// The chunked (speculative) selection scan of the compiled window pipeline,
// for Hopper, sm_90a.
//
// Replaces the compiled speculative drivers of the reference's window
// programs (src/repro/core/pipeline.py:244 `_spec_select`, used by
// `_per_request_program` :459 and `_grouped_program` :543, and :691
// `_spec_select_mw`, used by `_multiworker_program` :639; a
// `lax.while_loop`, no Pallas kernel).  The decisions are the sequential
// scan's (../../selection_scan/csrc/selection_scan.cu), taken C = `chunk`
// at a time with the same step (../../selection_scan/csrc/step.cuh):
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
// instructions (step.cuh, compiled with --fmad=false here too).
//
// What bounds it: like the sequential scan, a chain of dependent decisions.
// Chunking trades it for rounds: with no conflict a round takes C
// decisions for two passes over C positions' tiles in parallel, four
// barriers each, plus one thread's chain of C - 1 carry updates; each
// conflict costs a round that accepts fewer.  The design is the simple
// one: one block of kThreads threads runs the window's rounds in one
// launch.  Shared memory holds the carry's (W, K) slots, which the
// reconstruct chain advances in place, and the round's per-position rows:
// (C, W) pre-state tails, (C, W, M) completions, means and flags, the
// speculated and validated picks.  The pre-state slots of every position,
// (C, W, K), go to a scratch buffer in device memory, written by the
// chain and read by the validation and the accept, never read back by
// the chain; so the ids K do not multiply by the chunk in P7's sum.  The
// tile lives in device memory too (a group of 1,300 members on four
// workers at C = 64 is 15 MB).  One thread reconstructs the chain and
// accepts.  The launch uses the caller's stream, synchronises nothing and
// allocates nothing; the kernel writes its rounds and conflicts after the
// decisions, so one read-back brings both.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../../selection_scan/csrc/step.cuh"

namespace {

constexpr int kThreads = 512;

// Shared bytes of one launch: the (W, K) slots; the round's (C, W)
// pre-state tails, (C, W, M) completions and means, C speculated and C
// validated picks, and (C, W, M) residency flags.
size_t spec_smem_bytes(int C, int W, int K, int M) {
  const size_t cells = (size_t)C * W * M;
  return 8 * ((size_t)W * K + (size_t)C * W + 2 * cells + C) + cells;
}

__global__ void __launch_bounds__(kThreads) spec_scan_kernel(ScanArgs p, int C,
                                                             int64_t* res_st) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = p.W, M = p.M, K = p.K;
  const int wk = W * K;
  const int wm = W * M;
  const size_t cells = (size_t)C * wm;
  int64_t* res = reinterpret_cast<int64_t*>(smem_raw);  // (W, K) carry slots
  double* t_st = reinterpret_cast<double*>(res + wk);   // (C, W) pre-state tails
  StepRows rows;
  rows.comp = t_st + (size_t)C * W;                     // (C, W, M)
  rows.umean = rows.comp + cells;                       // (C, W, M)
  int* pick_s = reinterpret_cast<int*>(rows.umean + cells);  // (C,)
  int* pick_t = pick_s + C;                                  // (C,)
  rows.flag = reinterpret_cast<unsigned char*>(pick_t + C);  // (C, W, M)
  __shared__ int s_pos;
  __shared__ long long s_rounds, s_conflicts;
  const int tid = threadIdx.x;

  // Row 0 of the tails and `res` hold the boundary carry between rounds.
  for (int i = tid; i < wk; i += blockDim.x) res[i] = p.res0[i];
  for (int i = tid; i < W; i += blockDim.x) t_st[i] = p.t0[i];
  if (tid == 0) {
    s_pos = 0;
    s_rounds = 0;
    s_conflicts = 0;
  }
  __syncthreads();

  while (s_pos < p.S) {
    const int pos = s_pos;
    const int kn = min(C, p.S - pos);

    // 1. Speculate under the boundary carry.
    score(p, rows, pos, 0, kn, t_st, 0, res, 0, pick_s);

    // A round of one position has nothing to reconstruct or validate, and
    // its pick is thread 0's own: it goes straight to the accept.
    if (kn > 1) {
      __syncthreads();
      // 2. Reconstruct: the slots advance in place through the speculated
      // picks, each position's pre-state slots written out (row 0, the
      // boundary, first), its tails kept in row k.
      if (tid == 0) {
        for (int k = 0;; ++k) {
          // The position's table values first: the row's store below may
          // alias them as far as the compiler knows.
          const int s = pos + k;
          const int pick = pick_s[k];
          const int wi = pick / M;
          const int mi = pick - wi * M;
          const int a = static_cast<int>(p.step_app[s]);
          const int64_t g = p.gid[(size_t)a * M + mi];
          const double sw = p.swap[((size_t)a * W + wi) * M + mi];
          const double lt = p.lat[((size_t)s * W + wi) * M + mi];
          int64_t* row = res_st + (size_t)k * wk;
          for (int i = 0; i < wk; ++i) row[i] = res[i];
          if (k + 1 == kn) break;
          const double* t_in = t_st + (size_t)k * W;
          double* t_out = t_st + (size_t)(k + 1) * W;
          for (int i = 0; i < W; ++i) t_out[i] = t_in[i];
          const bool was = resident_in(p, res + (size_t)wi * K, g);
          advance(p, wi, g, was, (t_in[wi] + (was ? 0.0 : sw)) + lt, t_out, res);
        }
      }
      __syncthreads();

      // 3. Validate positions k >= 1 under their pre-states.
      score(p, rows, pos, 1, kn, t_st + W, W, res_st + wk, wk, pick_t);
      __syncthreads();
    }

    // 4. Accept through the first conflict, inclusive; move the carry.
    if (tid == 0) {
      int a = kn;
      bool conflict = false;
      for (int k = 1; k < kn; ++k) {
        if (pick_t[k] != pick_s[k]) {
          a = k + 1;
          conflict = true;
          break;
        }
      }
      for (int k = 0; k < a; ++k) {
        const int pick = k ? pick_t[k] : pick_s[0];
        emit(p, pos + k, pick, t_st[(size_t)k * W + pick / M], rows.comp[(size_t)k * wm + pick]);
      }
      // The carry: the last accepted decision on its pre-state.  The slots
      // in `res` are position kn - 1's pre-state; an earlier one is read
      // back from its row.
      const int k = a - 1;
      const int pick = k ? pick_t[k] : pick_s[0];
      if (k + 1 < kn) {
        const int64_t* row = res_st + (size_t)k * wk;
        for (int i = 0; i < wk; ++i) res[i] = row[i];
      }
      for (int i = 0; i < W; ++i) t_st[i] = t_st[(size_t)k * W + i];
      advance(p, pick / M, pick_id(p, pos + k, pick), rows.flag[(size_t)k * wm + pick] != 0,
              rows.comp[(size_t)k * wm + pick], t_st, res);
      s_rounds += 1;
      s_conflicts += conflict ? 1 : 0;
      s_pos = pos + a;
    }
    __syncthreads();
  }
  if (tid == 0) {
    p.out[p.S] = static_cast<double>(s_rounds);
    p.out[(size_t)p.ld + p.S] = static_cast<double>(s_conflicts);
    p.out[2 * (size_t)p.ld + p.S] = 0.0;
    p.out[3 * (size_t)p.ld + p.S] = 0.0;
  }
}

}  // namespace

extern "C" {

// Every pointer is a contiguous tensor on the current device, shaped as
// ScanArgs says (`out` (4, S + 1)); `fixed` may be null; `res_st` holds
// (C, W, K) int64 pre-state slots.  One block of kThreads threads
// runs the window's rounds.  Returns a cudaError_t (0 on success).
int spec_scan_f64(const void* t0, const void* res0, const void* sizes, double cap,
                  const void* acc, const void* mask, const void* deadlines, const void* bsize,
                  const void* lat, const void* step_app, const void* swap, const void* gid,
                  const void* valid, const void* pen, const void* pref, const void* fixed,
                  void* tile, void* out, void* res_st, int S, int B, int M, int W, int K,
                  int G, int slot1, int C, void* stream) {
  if (S < 1 || B < 1 || M < 1 || W < 1 || K < 1 || C < 1 || (slot1 && K != 1) ||
      (!slot1 && G < 1) || (size_t)C * W * B * M >> 32) {
    return (int)cudaErrorInvalidValue;
  }
  // The carry's slots and the round's rows live in shared memory sized
  // from C, W, K and M; past the default 48 KiB the kernel opts in to the
  // device's per-block maximum, and a sum beyond that is refused (the
  // wrapper refuses it first).
  const size_t smem = spec_smem_bytes(C, W, K, M);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(spec_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
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
  spec_scan_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a, C, static_cast<int64_t*>(res_st));
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
