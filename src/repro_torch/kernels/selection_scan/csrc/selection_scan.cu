// The sequential selection scan of the compiled window pipeline, for Hopper,
// sm_90a.
//
// Replaces the compiled `lax.scan`s of the reference's window programs
// (src/repro/core/pipeline.py:519 `_per_request_program`, :599
// `_grouped_program`, :681 `_multiworker_program`; no Pallas kernel): the
// Eq. 2/13 selection of one scheduling window, step after step, each step's
// choice moving the queue tail and the model residency the next step is
// scored against.  The three scans run as one form here:
//
//   step s, of application a = step_app[s], with n = bsize[s] members:
//     swap_eff[w, m] = resident(w, gid[a, m]) ? 0 : swap[a, w, m]
//     E[w, m]        = (t[w] + swap_eff[w, m]) + lat[s, w, m]
//     U[w, b, m]     = acc[s, b, m] * (1 - clip(gamma(d[s, b], E[w, m]), 0, 1))
//     mean[w, m]     = ((0 + U[w,0,m]*mask[s,0]) + U[w,1,m]*mask[s,1] ...) / bsize[s]
//     pick           = first maximum of mean (invalid models -inf) over the
//                      permutation pref[a] of the W*M (worker, model) cells,
//                      or fixed[s] (MaxAcc's carry-free choice)
//     start = t[wi]; t[wi] = E[wi, mi]; residency of wi touches gid[a, mi]
//
// The per-request scan is W = 1, B = 1 with the window's order applied to
// the step tables; the grouped scan is W = 1 with one application per
// group; the multi-worker scan is the general case, whose permutation is
// the Eq. 15 tie-break (u, -scaled latency, name, -wid).
//
// Numerics: the reference's float64 programs equal the numpy fast path and
// the scalar loops bit for bit, and so must this.  The file is compiled
// with --fmad=false; the Eq. 2 arithmetic is K1's (penalty.cuh, ratio^-3 by
// multiply and divide); completions keep the (t + swap) + lat association
// and the latency tables are the host's scaled l(m, b), so the card only
// adds; a member mean is one thread's chain of adds in member order, then
// one divide.  Members past n contribute exact zero adds in the reference
// and are skipped.  Residency follows `touch_lru_array`
// (src/repro_torch/core/residency.py:64): a resident touch moves the id to
// the MRU tail; a load appends it and evicts oldest-first while the byte
// total, less the evictable bytes before each entry, exceeds the capacity.
// That sum is exact because sizes are integer byte counts below 2^53,
// which the wrapper checks.
//
// What bounds it: neither bytes nor operations.  A window's tables are at
// most a few MB and its tiles a few hundred thousand Eq. 2 values; what
// cannot be shortened is the chain of S dependent steps, each of which
// needs the carry the one before it wrote.  The design keeps the whole
// chain in ONE block of one launch per window, so no step pays a launch or
// a host round trip, and keeps the carry (queue tails, LRU slots) in shared
// memory.  Within a step, four phases separated by __syncthreads:
//   A. one thread per (worker, model) cell: swap_eff, the completion, and
//      the residency flag that D's LRU touch reuses;
//   B. every thread over the step's W x n x M cells: the Eq. 2 values, into
//      a scratch tile in device memory (a group of 1,300 members on four
//      workers does not fit shared memory);
//   C. one thread per (worker, model) column: the ordered member sum and
//      the mean, or -inf for an invalid (padded) model;
//   D. thread 0: the first maximum over the permutation, the outputs, the
//      carry.
// The card runs one step's phases on one SM while the others idle: the
// scan is a latency chain, and its time is S times a step's latency.
// The launch uses the caller's stream, synchronises nothing and allocates
// nothing; the wrapper (ops.py) allocates the outputs and the scratch tile.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../utility/csrc/penalty.cuh"

namespace {

constexpr int kThreads = 256;

// Shared bytes of one launch: the (W, K) LRU slots, the (W,) queue tails,
// the step's (W, M) completions and member means, and its (W, M)
// residency flags.
size_t scan_smem_bytes(int W, int K, int M) {
  return (size_t)W * K * sizeof(int64_t) + ((size_t)W + 2 * (size_t)W * M) * sizeof(double) +
         (size_t)W * M;
}

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
  const int64_t* pref;       // (A, W * M) preference permutations
  const int64_t* fixed;      // (S,) fixed choices, or null
  double* tile;              // (W, B, M) scratch
  double* out;               // (4, S): worker, model, start, latency
  double cap;
  int S, B, M, W, K, G, slot1;
};

// One load of id g on a worker's LRU slots r[0..K): touch_lru_array's rule,
// in place.  `was` says whether g is resident (phase A found it).  The
// slots are compacted oldest first with g appended at the MRU tail; the
// write index never passes the read index, so no copy is needed.  K >= the
// window's model ids (the wrapper checks), so a loaded id finds a slot.
__device__ void touch_lru(int64_t* r, int K, int64_t g, bool was, const double* sizes,
                          double cap) {
  int kept = 0;
  if (was) {  // a resident touch is a pure MRU reorder: no size is read
    for (int k = 0; k < K; ++k) {
      const int64_t id = r[k];
      if (id >= 0 && id != g) r[kept++] = id;
    }
  } else {
    // A load evicts oldest-first while the total less the evictable bytes
    // before the entry exceeds the capacity.
    double total = sizes[g];
    for (int k = 0; k < K; ++k) {
      if (r[k] >= 0) total += sizes[r[k]];
    }
    double freed_before = 0.0;
    for (int k = 0; k < K; ++k) {
      const int64_t id = r[k];
      if (id < 0) continue;
      const bool evict = total - freed_before > cap;
      freed_before += sizes[id];
      if (!evict) r[kept++] = id;
    }
  }
  r[kept++] = g;
  for (int k = kept; k < K; ++k) r[k] = -1;
}

__global__ void __launch_bounds__(kThreads) selection_scan_kernel(ScanArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = p.W, M = p.M, K = p.K, B = p.B;
  const int wm = W * M;
  int64_t* res = reinterpret_cast<int64_t*>(smem_raw);  // (W, K)
  double* t = reinterpret_cast<double*>(res + W * K);   // (W,)
  double* comp = t + W;                                 // (W, M)
  double* umean = comp + wm;                            // (W, M)
  unsigned char* res_flag = reinterpret_cast<unsigned char*>(umean + wm);  // (W, M)
  const int tid = threadIdx.x;

  for (int i = tid; i < W * K; i += blockDim.x) res[i] = p.res0[i];
  for (int i = tid; i < W; i += blockDim.x) t[i] = p.t0[i];
  __syncthreads();

  for (int s = 0; s < p.S; ++s) {
    const int a = static_cast<int>(p.step_app[s]);
    const int64_t* gid = p.gid + (size_t)a * M;

    // A. Completions if the step ran next on each (worker, model).
    for (int c = tid; c < wm; c += blockDim.x) {
      const int w = c / M;
      const int m = c - w * M;
      const int64_t g = gid[m];
      bool resident = false;
      if (p.slot1) {
        resident = res[w * K] == g;
      } else {
        for (int k = 0; k < K; ++k) resident |= res[w * K + k] == g;
      }
      res_flag[c] = resident;
      const double sw = resident ? 0.0 : p.swap[((size_t)a * W + w) * M + m];
      comp[c] = (t[w] + sw) + p.lat[((size_t)s * W + w) * M + m];
    }
    __syncthreads();

    if (p.fixed == nullptr) {
      // B. The step's Eq. 2 tile over its real members.
      const int n = static_cast<int>(p.bsize[s]);
      const int pen = static_cast<int>(p.pen[a]);
      const int nm = n * M;
      const double* acc = p.acc + (size_t)s * B * M;
      const double* dl = p.deadlines + (size_t)s * B;
      for (int c = tid; c < W * nm; c += blockDim.x) {
        const int w = c / nm;
        const int r = c - w * nm;
        const int b = r / M;
        const int m = r - b * M;
        p.tile[((size_t)w * B + b) * M + m] =
            eq2_utility<double>(pen, acc[(size_t)b * M + m], dl[b], comp[w * M + m]);
      }
      __syncthreads();

      // C. Member means, each column one chain of adds in member order.
      const double* mk = p.mask + (size_t)s * B;
      const double size = p.bsize[s];
      for (int c = tid; c < wm; c += blockDim.x) {
        const int w = c / M;
        const int m = c - w * M;
        const double* col = p.tile + (size_t)w * B * M + m;
        double sum = 0.0;
        for (int b = 0; b < n; ++b) sum = sum + col[(size_t)b * M] * mk[b];
        umean[c] = p.valid[(size_t)a * M + m] ? sum / size : -INFINITY;
      }
      __syncthreads();
    }

    // D. The pick and the carry.
    if (tid == 0) {
      int pick;
      if (p.fixed != nullptr) {
        pick = static_cast<int>(p.fixed[s]);
      } else {
        const int64_t* pr = p.pref + (size_t)a * wm;
        pick = static_cast<int>(pr[0]);
        double best = umean[pick];
        for (int i = 1; i < wm; ++i) {
          const int c = static_cast<int>(pr[i]);
          if (umean[c] > best) {
            best = umean[c];
            pick = c;
          }
        }
      }
      const int wi = pick / M;
      const int mi = pick - wi * M;
      const double start = t[wi];
      const double done = comp[pick];
      p.out[s] = wi;
      p.out[p.S + s] = mi;
      p.out[2 * (size_t)p.S + s] = start;
      p.out[3 * (size_t)p.S + s] = done - start;
      t[wi] = done;
      if (p.slot1) {
        res[wi * K] = gid[mi];
      } else {
        touch_lru(res + wi * K, K, gid[mi], res_flag[pick] != 0, p.sizes + (size_t)wi * p.G,
                  p.cap);
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Every pointer is a contiguous tensor on the current device, shaped as
// ScanArgs says; `fixed` may be null.  One block of kThreads threads runs
// the S steps.  Returns a cudaError_t (0 on success).
int selection_scan_f64(const void* t0, const void* res0, const void* sizes, double cap,
                       const void* acc, const void* mask, const void* deadlines,
                       const void* bsize, const void* lat, const void* step_app,
                       const void* swap, const void* gid, const void* valid, const void* pen,
                       const void* pref, const void* fixed, void* tile, void* out, int S, int B,
                       int M, int W, int K, int G, int slot1, void* stream) {
  if (S < 1 || B < 1 || M < 1 || W < 1 || K < 1 || (slot1 && K != 1) || (!slot1 && G < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  // The carry and the step's (W, M) rows live in shared memory, sized from
  // W, K and M; past the default 48 KiB the kernel opts in to the device's
  // per-block maximum (227 KiB on Hopper), and a carry beyond that is
  // refused (the wrapper refuses it first).
  const size_t smem = scan_smem_bytes(W, K, M);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(selection_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  selection_scan_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
