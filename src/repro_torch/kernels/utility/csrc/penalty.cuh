// The Eq. 2 arithmetic shared by the port's kernels: the deadline penalty
// gamma(d, e) of core/utility.py and the utility a * (1 - clip(gamma, 0, 1)),
// in the one form that equals the scalar and numpy forms bit for bit in
// double.  Included by utility.cu (K1) and by
// ../../selection_scan/csrc/selection_scan.cu; both are compiled with
// --fmad=false, so no multiply-add is fused, and the sigmoid's ratio^-3 uses
// only `*` and `/` (correctly rounded, never pow).
#pragma once

// Penalty codes: core/utility.py PENALTY_CODES.
enum Penalty { kNone = 0, kStep = 1, kLinear = 2, kSigmoid = 3 };

// gamma(d, e) of core/utility.py, as selects: every quantity a branch of
// the plain version would compute is computed, and the same one is kept, so
// the rows of a thread carry no branch and their divisions overlap.
template <typename T>
__device__ __forceinline__ T penalty_gamma(int penalty, T d, T e) {
  if (penalty == kNone) return T(0);
  if (penalty == kStep) return d < e ? T(1) : T(0);
  const T x = (e - d) / d;
  T g;
  if (penalty == kLinear) {
    g = x < T(1) ? x : T(1);
  } else {  // sigmoid
    const T ratio = x / (T(1) - x);
    const T inner = T(1) / (T(1) + T(1) / (ratio * ratio * ratio));
    g = x >= T(1) ? T(1) : (x <= T(0) ? T(0) : (inner < T(1) ? inner : T(1)));
  }
  return e <= d ? T(0) : (d <= T(0) ? T(1) : g);
}

// Eq. 2: u = a * (1 - clip(gamma(d, e), 0, 1)).
template <typename T>
__device__ __forceinline__ T eq2_utility(int penalty, T a, T d, T e) {
  T g = penalty_gamma<T>(penalty, d, e);
  g = g < T(0) ? T(0) : (g > T(1) ? T(1) : g);
  return a * (T(1) - g);
}
