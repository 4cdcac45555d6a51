// The RG-LRU scan of the Griffin recurrent block, for Hopper, sm_90a.
//
// Replaces the reference's recurrence of src/repro/models/rglru.py
// (`_gates` :65 and the `jax.lax.associative_scan` of `rglru_forward` :77;
// `rglru_decode_step` :100 is the same step at S = 1; no Pallas kernel):
//
//   per (batch b, channel c), over t = 0 .. S-1, in float32:
//     r = sigmoid(u * a_w + a_b)        i = sigmoid(u * x_w + x_b)
//     a = exp(-8 * softplus(Lambda) * r)
//     h = a * h + sqrt(clip(1 - a^2, 1e-12, 1)) * i * u
//     y = h * gelu_tanh(g)               (rounded to the model's type)
//   h starts at h0 (or 0) and the last h is written out in float32.
//
// What bounds it: bytes, then the special-function unit.  Each step reads
// u and g once and writes y once (2 bytes each in bf16) for about thirty
// float32 operations: at B = 8, S = 1024, L = 4096 that is 201 MB, 0.060 ms
// at 3.35 TB/s.  A sequential walk of S per (batch, channel) cannot reach
// it: B * L threads (32,768 at that shape, 4,096 for a lone prompt) are a
// few warps an SM, each with a few loads in flight, so memory latency, not
// the one-FMA recurrence, sets the time.  The gates take five
// special-function operations an element (three exponentials, a
// reciprocal, a reciprocal square root; the GeLU two more), at 16 a clock
// an SM: 0.040 ms for the summary pass and 0.056 ms for the scan pass at
// that shape, which is what the passes come near once the bytes are in
// flight (on an H100 80GB HBM3 at 700 W: 0.067 and 0.105 ms;
// benchmarks/torch_kernel_probe.py rglru).  With the accurate library
// functions (expf, an IEEE divide, sqrtf, tanhf) the same passes took 0.097
// and 0.147 ms, so the gates use the unit's approximations, within a few
// ulp each, far inside the kernel's tolerances.
//
// The design: a chunked two-pass scan.  S is cut into chunks of kChunk
// steps (a compile-time constant, chosen by measurement:
// benchmarks/torch_kernel_probe.py rglru), and every (batch, chunk,
// channel) is a thread, so B * L * ceil(S / kChunk) threads fill the card
// whatever the batch.
//   pass 1 (rglru_summary_kernel, chunks 0 .. nc-2): from u alone, the
//     chunk's gates folded into its summary, A = prod a and H = the
//     chunk's h from a zero start, written in float32 to a (2, B, nc-1, L)
//     scratch the wrapper allocates (4 MB at the shape above: it stays in
//     L2);
//   pass 2 (rglru_scan_kernel, every chunk): the carry h0 (or 0) pushed
//     through the summaries of the chunks before it (h = A * h + H, at most
//     nc - 1 FMAs), then the chunk's recurrence again from that carry,
//     reading u and g and writing y; the last chunk writes h_last.
// So u is read twice: 4 * 2 bytes an element in bf16 against the bound's
// 3 * 2 (0.080 ms of bytes at the shape above, against 0.060).  Neighbouring
// threads take neighbouring channels, so a warp's row is contiguous.  When
// a row is a whole number of 16-byte pieces (and u and g start on 16
// bytes), a block stages its chunk's u and g tiles through shared memory by
// cp.async, 16 rows at a time, two tiles in flight: the next tile is
// copying while the current one is scanned, and the first one while the
// carry is pushed through the summaries, so the bytes in flight do not hang
// on the loop's unroll depth.  Other widths read u and g straight from
// device memory (the same arithmetic).  At S <= kChunk (the decode step)
// pass 2 runs alone, with no summaries: one launch.  The grid depends on
// the shapes only and nothing is read back, so the decode step can be
// captured in a CUDA graph.  For training, pass 2 also writes the carry
// entering every kCarry = 16 steps (rglru.cuh), (B, ceil(S / 16), L)
// float32: the first at the chunk's start, the others at the ends of its
// staged tiles, outside the step loop, in an instance of its own (prefill
// and decode, which save nothing, run one without it).  From them the backward
// (rglru_scan_bwd.cu) recomputes h, each warp over its own 16 steps; the
// gate arithmetic lives in rglru.cuh, shared with it, so the two kernels'
// h agree bit for bit.
//
// Numerics: the chunk combine adds the products in another order than a
// sequential loop, and the reference's associative scan in a third, so the
// three agree within float32 rounding (1e-4 held on the CPU through the
// plain chunked form, ref.py's rglru_scan_chunked_ref, and on the card
// against the sequential plain version).  The launches use the caller's
// stream, synchronise nothing and allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rglru.cuh"

namespace {

using namespace rglru;

constexpr int kRows = 16;   // rows of a staged tile
static_assert(kChunk % kRows == 0, "a chunk is a whole number of staged tiles");
static_assert(kRows == kCarry, "a carry is saved at each staged tile's end");
constexpr int kCarriesPerChunk = kChunk / kCarry;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most one group of copies is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <typename T>
struct Args {
  const T *u, *g, *a_w, *a_b, *x_w, *x_b, *lam;
  const float* h0;  // (B, L) or null
  T* y;
  float* h_last;
  float* sum_a;  // (B, nc - 1, L): each chunk's prod a
  float* sum_h;  // (B, nc - 1, L): each chunk's h from a zero start
  float* carries;  // (B, ncar, L): the h entering every kCarry steps, for the backward; or null
  int B, S, L, nc, ncar;
};

// cp.async of `rows` rows of the block's kCh channels of u (and g, into the
// second half of the tile), starting at row `row` of the (B * S, L) rows.
// The width is a whole number of 16-byte pieces, so a piece is in or out.
template <typename T, bool kGate>
__device__ __forceinline__ void stage(T* tile, const Args<T>& p, size_t row, int rows, int c0) {
  constexpr int kPer = 16 / sizeof(T);  // elements of a piece
  constexpr int kPieces = kCh / kPer;   // pieces of a row
  for (int i = threadIdx.x; i < rows * kPieces; i += kCh) {
    const int r = i / kPieces;
    const int q = i - r * kPieces;
    const int ch = c0 + q * kPer;
    if (ch >= p.L) continue;
    const size_t off = (row + r) * p.L + ch;
    cp_async16(tile + r * kCh + q * kPer, p.u + off);
    if (kGate) cp_async16(tile + (kRows + r) * kCh + q * kPer, p.g + off);
  }
}

// One (batch, chunk, channel) a thread: pass 1 (kGate false) or pass 2.
// kStaged: u and g come through shared memory by cp.async.  kSave: pass 2
// also writes the carries for the backward (an instance of its own, so
// prefill and decode run no code of it).
template <typename T, bool kStaged, bool kGate, bool kSave = false>
__device__ __forceinline__ void chunk(const Args<T>& p) {
  constexpr int kTile = (kGate ? 2 : 1) * kRows * kCh;  // elements of a staged tile
  __shared__ __align__(16) unsigned char raw[2 * kTile * sizeof(T)];
  T* const tiles = reinterpret_cast<T*>(raw);  // two tiles, one after the other
  const int b = blockIdx.z;
  const int k = blockIdx.y;
  const int c0 = blockIdx.x * kCh;
  const int c = c0 + threadIdx.x;
  const bool live = c < p.L;
  const int n = min(kChunk, p.S - k * kChunk);  // the chunk's steps
  const int tiles_n = (n + kRows - 1) / kRows;
  const size_t row0 = (size_t)b * p.S + (size_t)k * kChunk;
  if (kStaged) {
    stage<T, kGate>(tiles, p, row0, min(kRows, n), c0);
    cp_async_commit();
    if (tiles_n > 1) stage<T, kGate>(tiles + kTile, p, row0 + kRows, min(kRows, n - kRows), c0);
    cp_async_commit();
  }
  Gates q{};
  float h = 0.0f, prod = 1.0f;
  if (live) {
    q = load_gates(p.a_w, p.a_b, p.x_w, p.x_b, p.lam, c);
    if (kGate) {
      // The carry into this chunk: h0 through the summaries before it.
      h = p.h0 != nullptr ? p.h0[(size_t)b * p.L + c] : 0.0f;
      const size_t base = (size_t)b * (p.nc - 1) * p.L + c;
#pragma unroll 4
      for (int j = 0; j < k; ++j) {
        h = step(p.sum_a[base + (size_t)j * p.L], h, p.sum_h[base + (size_t)j * p.L]);
      }
      if (kSave) p.carries[((size_t)b * p.ncar + (size_t)k * kCarriesPerChunk) * p.L + c] = h;
    }
  }
  for (int tt = 0; tt < tiles_n; ++tt) {
    const int r0 = tt * kRows;
    const int rows = min(kRows, n - r0);
    const T* tile = tiles + (tt & 1) * kTile;
    if (kStaged) {
      cp_async_wait_one();
      __syncthreads();
    }
    if (live) {
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        const size_t off = (row0 + r0 + r) * p.L + c;
        const float uf = to_f(kStaged ? tile[r * kCh + threadIdx.x] : p.u[off]);
        const GateParts gp = gate_parts(q, uf);
        const float a = gp.a;
        h = step(a, h, gate_bx(gp, uf));
        if (kGate) {
          const float gf = to_f(kStaged ? tile[(kRows + r) * kCh + threadIdx.x] : p.g[off]);
          p.y[off] = from_f<T>(h * gelu_tanh(gf));
        } else {
          prod = prod * a;
        }
      }
      if (kSave && tt + 1 < tiles_n) {  // entering the next kCarry steps
        p.carries[((size_t)b * p.ncar + (size_t)k * kCarriesPerChunk + tt + 1) * p.L + c] = h;
      }
    }
    if (kStaged) {
      __syncthreads();  // every thread is done with this tile before it is refilled
      if (tt + 2 < tiles_n) {
        const int r2 = r0 + 2 * kRows;
        stage<T, kGate>(tiles + (tt & 1) * kTile, p, row0 + r2, min(kRows, n - r2), c0);
      }
      cp_async_commit();
    }
  }
  if (!live) return;
  if (kGate) {
    if (k == p.nc - 1) p.h_last[(size_t)b * p.L + c] = h;
  } else {
    const size_t at = ((size_t)b * (p.nc - 1) + k) * p.L + c;
    p.sum_a[at] = prod;
    p.sum_h[at] = h;
  }
}

template <typename T, bool kStaged>
__global__ void __launch_bounds__(kCh) rglru_summary_kernel(Args<T> p) {
  chunk<T, kStaged, false>(p);
}

template <typename T, bool kStaged, bool kSave>
__global__ void __launch_bounds__(kCh) rglru_scan_kernel(Args<T> p) {
  chunk<T, kStaged, true, kSave>(p);
}

template <typename T, bool kStaged>
int launch(const Args<T>& p, cudaStream_t stream) {
  dim3 grid((p.L + kCh - 1) / kCh, p.nc - 1, p.B);
  if (p.nc > 1) {
    rglru_summary_kernel<T, kStaged><<<grid, kCh, 0, stream>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  grid.y = p.nc;
  if (p.carries != nullptr) {
    rglru_scan_kernel<T, kStaged, true><<<grid, kCh, 0, stream>>>(p);
  } else {
    rglru_scan_kernel<T, kStaged, false><<<grid, kCh, 0, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* u, const void* g, const void* a_w, const void* a_b, const void* x_w,
           const void* x_b, const void* lam, const void* h0, void* y, void* h_last,
           void* scratch, void* carries, int B, int S, int L, cudaStream_t stream) {
  Args<T> p;
  p.u = static_cast<const T*>(u);
  p.g = static_cast<const T*>(g);
  p.a_w = static_cast<const T*>(a_w);
  p.a_b = static_cast<const T*>(a_b);
  p.x_w = static_cast<const T*>(x_w);
  p.x_b = static_cast<const T*>(x_b);
  p.lam = static_cast<const T*>(lam);
  p.h0 = static_cast<const float*>(h0);
  p.y = static_cast<T*>(y);
  p.h_last = static_cast<float*>(h_last);
  p.B = B;
  p.S = S;
  p.L = L;
  p.nc = (S + kChunk - 1) / kChunk;
  p.ncar = (S + kCarry - 1) / kCarry;
  p.sum_a = static_cast<float*>(scratch);
  p.sum_h = p.sum_a + (size_t)B * (p.nc - 1) * L;
  p.carries = static_cast<float*>(carries);
  const bool staged = (L * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(u) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(g) % 16 == 0;
  return staged ? launch<T, true>(p, stream) : launch<T, false>(p, stream);
}

}  // namespace

extern "C" {

// The chunk length the kernels were built with: the wrapper sizes the
// scratch from it.
int rglru_scan_chunk() { return kChunk; }

// The steps between the carries it saves for the backward.
int rglru_scan_carry() { return kCarry; }

// u, g, y: (B, S, L); a_w, a_b, x_w, x_b, lam: (L,), all of `dtype` (0
// float32, 1 bfloat16); h0 (B, L) float32 or null; h_last (B, L) float32;
// scratch (2, B, ceil(S / chunk) - 1, L) float32, null when S <= chunk;
// carries (B, ceil(S / carry), L) float32, the h entering every carry
// steps, which the backward (rglru_scan_bwd.cu) reads, or null.  Returns a cudaError_t
// (0 on success).
int rglru_scan(const void* u, const void* g, const void* a_w, const void* a_b, const void* x_w,
               const void* x_b, const void* lam, const void* h0, void* y, void* h_last,
               void* scratch, void* carries, int B, int S, int L, int dtype, void* stream) {
  const int nc = S >= 1 ? (S + kChunk - 1) / kChunk : 0;
  if (B < 1 || S < 1 || L < 1 || B > 65535 || nc > 65535 || (nc > 1 && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(u, g, a_w, a_b, x_w, x_b, lam, h0, y, h_last, scratch, carries, B, S,
                         L, st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(u, g, a_w, a_b, x_w, x_b, lam, h0, y, h_last, scratch, carries,
                                 B, S, L, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
