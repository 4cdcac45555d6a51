// The LRU residency touch of the port's scans: `touch_lru_array`'s rule
// (src/repro_torch/core/residency.py:64) on one worker's slot vector, in
// place (`touch_lru`) or from one vector into another (`touch_lru_copy`,
// the chains that keep every state).  Included through step.cuh by
// selection_scan.cu, ../../spec_scan/csrc/spec_scan.cu and
// ../../shard_round/csrc/shard_round.cu; all are compiled with
// --fmad=false.
#pragma once

#include <stdint.h>

// One load of id g on a worker's LRU slots r[0..K) (oldest first, -1
// empty, empties packed at the tail).  `was` says whether g is resident.
// A resident touch moves g to the MRU tail; a load appends it and evicts
// oldest-first while the byte total, less the evictable bytes before each
// entry, exceeds the capacity.  That sum is exact because sizes are integer
// byte counts below 2^53, which the wrappers check.  The slots are
// compacted oldest first with g appended at the MRU tail; the write index
// never passes the read index, so no copy is needed.  K >= the window's
// model ids (the wrappers check), so a loaded id finds a slot.
__device__ __forceinline__ void touch_lru(int64_t* r, int K, int64_t g, bool was,
                                          const double* sizes, double cap) {
  int kept = 0;
  if (was) {  // a resident touch is a pure MRU reorder: no size is read
    for (int k = 0; k < K; ++k) {
      const int64_t id = r[k];
      if (id >= 0 && id != g) r[kept++] = id;
    }
  } else {
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

// touch_lru's rule with the old slots read from `src` and the new ones
// written to `dst` (two distinct vectors of K slots): the same comparisons
// and the same float64 adds in the same order, so the same slots.  The
// slots are read kTouchBatch at a time, and their sizes loaded together,
// before the batch's compares and adds: a thread issues in order, so the
// loads of a batch wait once, not once a slot.  A slot past K reads as
// empty (-1), which every loop skips, as it skips an empty slot.
constexpr int kTouchBatch = 8;

__device__ __forceinline__ void touch_lru_copy(const int64_t* __restrict__ src,
                                               int64_t* __restrict__ dst, int K, int64_t g,
                                               bool was, const double* __restrict__ sizes,
                                               double cap) {
  int kept = 0;
  if (was) {
    for (int k0 = 0; k0 < K; k0 += kTouchBatch) {
      int64_t id[kTouchBatch];
#pragma unroll
      for (int u = 0; u < kTouchBatch; ++u) id[u] = k0 + u < K ? src[k0 + u] : -1;
#pragma unroll
      for (int u = 0; u < kTouchBatch; ++u) {
        if (id[u] >= 0 && id[u] != g) dst[kept++] = id[u];
      }
    }
  } else {
    double total = sizes[g];
    for (int k0 = 0; k0 < K; k0 += kTouchBatch) {
      int64_t id[kTouchBatch];
      double sz[kTouchBatch];
#pragma unroll
      for (int u = 0; u < kTouchBatch; ++u) id[u] = k0 + u < K ? src[k0 + u] : -1;
#pragma unroll
      for (int u = 0; u < kTouchBatch; ++u) sz[u] = sizes[id[u] >= 0 ? id[u] : 0];
#pragma unroll
      for (int u = 0; u < kTouchBatch; ++u) {
        if (id[u] >= 0) total += sz[u];
      }
    }
    double freed_before = 0.0;
    for (int k0 = 0; k0 < K; k0 += kTouchBatch) {
      int64_t id[kTouchBatch];
      double sz[kTouchBatch];
#pragma unroll
      for (int u = 0; u < kTouchBatch; ++u) id[u] = k0 + u < K ? src[k0 + u] : -1;
#pragma unroll
      for (int u = 0; u < kTouchBatch; ++u) sz[u] = sizes[id[u] >= 0 ? id[u] : 0];
#pragma unroll
      for (int u = 0; u < kTouchBatch; ++u) {
        if (id[u] < 0) continue;
        const bool evict = total - freed_before > cap;
        freed_before += sz[u];
        if (!evict) dst[kept++] = id[u];
      }
    }
  }
  dst[kept++] = g;
  for (int k = kept; k < K; ++k) dst[k] = -1;
}
