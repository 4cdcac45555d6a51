// The LRU residency touch of the port's scans: `touch_lru_array`'s rule
// (src/repro_torch/core/residency.py:64) on one worker's slot vector, in
// place.  Included through step.cuh by selection_scan.cu and
// ../../spec_scan/csrc/spec_scan.cu; both are compiled with --fmad=false.
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
