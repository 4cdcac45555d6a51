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
// adds; a member mean is one chain of adds in member order, then one
// divide.  Residency follows `touch_lru_array`
// (src/repro_torch/core/residency.py:64), in lru.cuh; `advance` and `emit`
// are step.cuh's, shared with the chunked scan
// (../../spec_scan/csrc/spec_scan.cu) and the sharded rounds.
//
// What bounds it: neither bytes nor operations.  A window's tables are at
// most a few MB and its tiles a few hundred thousand Eq. 2 values; what
// cannot be shortened is the chain of S dependent steps, each of which
// needs the carry the one before it wrote: the float64 operations from
// the carry to the next carry.  The design keeps the whole chain in ONE
// block of one launch per window, so no step pays a launch or a host
// round trip, keeps the carry (queue tails, LRU slots) in shared memory,
// and takes everything else off the chain:
//   * the step's tables (application, member count, penalty, accuracies,
//     deadlines, masks, latencies, the application's ids, swaps, validity
//     and preference row) do not depend on the carry, so each is loaded
//     a few steps ahead into a ring of registers (ahead.cuh; the loop is
//     unrolled as deep as the ring, so no register is copied while its load
//     is in flight), and the chain waits on no device memory;
//   * a step whose W * B * M cells fit one warp (per-request windows, on
//     one worker or a pool of up to five: W * M <= 32) runs in ONE warp:
//     a lane a cell, the Eq. 2 value in registers, the member means and
//     the pick by shuffles, the warp synchronised once a step; the chain
//     is then the step's float64 operations and a few shuffles.  A wider
//     step (grouped windows of up to 1,232 members) runs in a block of
//     kThreads: step.cuh's four phases, the Eq. 2 tile in a scratch buffer
//     in device memory, the member chain's loads issued kDepth at a time.
// The wrapper (ops.py) picks the instance from the shapes.  The card runs
// the chain on one SM while the others idle: the scan's time is S times a
// step's latency.  On an H100 80GB HBM3 at 700 W a warp step takes about
// 1.0 us (benchmarks/torch_kernel_probe.py scan-step, on
// benchmarks/torch_scan_ab.py's per-request tables): the Eq. 2 value about
// 0.2 (a sigmoid penalty's four correctly rounded divisions), the pick's
// reduction about 0.1, and about 0.5 the rest of one warp's instruction
// stream (completion, shuffles, carry update, the fetches); the LRU touch
// on lane 0 adds about 1.2 over 18 ids.  The launch uses the caller's stream, synchronises
// nothing and allocates nothing; the wrapper allocates the outputs and,
// for the block instance, the scratch tile.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ahead.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
// Steps whose tables are in flight before they are scored: the warp
// instance's steps are short and its registers few, the block's steps long.
constexpr int kWarpAhead = 2;
constexpr int kBlockAhead = 8;

// Shared bytes of a block launch: the (W, K) LRU slots, the (W,) queue
// tails, the step's (W, M) completions and member means, and its (W, M)
// residency flags.  The warp instance keeps the slots and tails only.
size_t scan_smem_bytes(int W, int K, int M, bool warp) {
  const size_t carry = (size_t)W * K * sizeof(int64_t) + (size_t)W * sizeof(double);
  return warp ? carry : carry + 2 * (size_t)W * M * sizeof(double) + (size_t)W * M;
}

__global__ void __launch_bounds__(kWarp) selection_scan_warp_kernel(ScanArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = p.W, M = p.M, K = p.K, B = p.B;
  int64_t* res = reinterpret_cast<int64_t*>(smem_raw);  // (W, K)
  double* t = reinterpret_cast<double*>(res + W * K);   // (W,)
  const int lane = threadIdx.x;
  for (int i = lane; i < W * K; i += kWarp) res[i] = p.res0[i];
  for (int i = lane; i < W; i += kWarp) t[i] = p.t0[i];
  LaneCell c;
  c.on = lane < W * B * M;
  c.m = lane % M;
  c.b = (lane / M) % B;
  c.w = lane / (B * M);
  c.inv_m = 1.0f / M;
  const int span = pow2_span(W * M);
  // Ring slot j holds the tables of the steps s = j (mod kAhead), fetched
  // kAhead steps before s; app[j] the application of step s + kAhead.
  constexpr int kAhead = kWarpAhead;
  LaneStep ring[kAhead];
  int64_t app[kAhead];
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    if (j < p.S) fetch_lane(p, j, p.step_app[j], c, lane, ring[j]);
    app[j] = j + kAhead < p.S ? p.step_app[j + kAhead] : 0;
  }
  __syncwarp();

  for (int s0 = 0; s0 < p.S; s0 += kAhead) {
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int s = s0 + j;
      if (s < p.S) {
        warp_step(p, s, ring[j], c, lane, span, t, res);
        __syncwarp();
        const int ahead = s + kAhead;
        if (ahead < p.S) {
          fetch_lane(p, ahead, app[j], c, lane, ring[j]);
          app[j] = ahead + kAhead < p.S ? p.step_app[ahead + kAhead] : 0;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) selection_scan_kernel(ScanArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = p.W, M = p.M, K = p.K;
  const int wm = W * M;
  int64_t* res = reinterpret_cast<int64_t*>(smem_raw);  // (W, K)
  double* t = reinterpret_cast<double*>(res + W * K);   // (W,)
  StepRows rows;
  rows.comp = t + W;                                    // (W, M)
  rows.umean = rows.comp + wm;                          // (W, M)
  rows.flag = reinterpret_cast<unsigned char*>(rows.umean + wm);  // (W, M)
  const int tid = threadIdx.x;

  for (int i = tid; i < W * K; i += blockDim.x) res[i] = p.res0[i];
  for (int i = tid; i < W; i += blockDim.x) t[i] = p.t0[i];
  constexpr int kAhead = kBlockAhead;
  ThreadStep ring[kAhead];  // as the warp instance's ring
  int64_t app[kAhead];
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    if (j < p.S) fetch_thread(p, j, p.step_app[j], tid, ring[j]);
    app[j] = j + kAhead < p.S ? p.step_app[j + kAhead] : 0;
  }
  __syncthreads();

  for (int s0 = 0; s0 < p.S; s0 += kAhead) {
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int s = s0 + j;
      if (s < p.S) {
        const int pick = block_step(p, s, ring[j], rows, t, res);
        // The pick is thread 0's, which moves the carry.
        if (tid == 0) {
          const int64_t g = p.gid[(size_t)ring[j].a * M + pick % M];
          emit(p, s, pick, t[pick / M], rows.comp[pick]);
          advance(p, pick / M, g, rows.flag[pick] != 0, rows.comp[pick], t, res);
        }
        __syncthreads();
        const int ahead = s + kAhead;
        if (ahead < p.S) {
          fetch_thread(p, ahead, app[j], tid, ring[j]);
          app[j] = ahead + kAhead < p.S ? p.step_app[ahead + kAhead] : 0;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Every pointer is a contiguous tensor on the current device, shaped as
// ScanArgs says; `fixed` may be null, and `tile` is unused (null) by the
// warp instance.  `warp` runs the S steps in one warp (W * B * M <= 32),
// otherwise one block of kThreads threads runs them.  Returns a
// cudaError_t (0 on success).
int selection_scan_f64(const void* t0, const void* res0, const void* sizes, double cap,
                       const void* acc, const void* mask, const void* deadlines,
                       const void* bsize, const void* lat, const void* step_app,
                       const void* swap, const void* gid, const void* valid, const void* pen,
                       const void* pref, const void* fixed, void* tile, void* out, int S, int B,
                       int M, int W, int K, int G, int slot1, int warp, void* stream) {
  if (S < 1 || B < 1 || M < 1 || W < 1 || K < 1 || (slot1 && K != 1) || (!slot1 && G < 1) ||
      (size_t)W * B * M >> 32 || (warp && (size_t)W * B * M > kWarp) ||
      (!warp && tile == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  // The carry and the step's (W, M) rows live in shared memory, sized from
  // W, K and M; past the default 48 KiB the kernel opts in to the device's
  // per-block maximum (227 KiB on Hopper), and a carry beyond that is
  // refused (the wrapper refuses it first).
  const size_t smem = scan_smem_bytes(W, K, M, warp != 0);
  const void* kernel = warp ? reinterpret_cast<const void*>(selection_scan_warp_kernel)
                            : reinterpret_cast<const void*>(selection_scan_kernel);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
  a.ld = S;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (warp) {
    selection_scan_warp_kernel<<<1, kWarp, smem, st>>>(a);
  } else {
    selection_scan_kernel<<<1, kThreads, smem, st>>>(a);
  }
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
