"""Probes of what bounds K2 (k-NN), K1 (Eq. 2 utility) and K5b (the SSD
backward) on one NVIDIA GPU.

    python3 benchmarks/torch_kernel_probe.py knn --source OLD/knn.cu
    python3 benchmarks/torch_kernel_probe.py knn-design
    python3 benchmarks/torch_kernel_probe.py utility
    python3 benchmarks/torch_kernel_probe.py chain
    python3 benchmarks/torch_kernel_probe.py ssd-bwd

``knn`` takes a k-NN source of the first design (``knn.cu`` as it was
before the query-tiled design, e.g. from an archive of an earlier commit:
one block per 8 queries and per slice, a per-thread top-k in registers,
the training tile staged one float at a time), builds it as it is and in
variants made by text edits of that source, and times each at the
scheduling window's shape (Q = 1365, N = 80,000, D = 32, k = 5) under
``torch.profiler``:

* ``as_is``;
* ``no_topk``: the per-thread top-k update replaced by a running minimum,
  so the distances are still computed and used;
* ``f4_staging``: the tile staged by 16-byte copies with no per-element
  division, rows padded to an odd number of float4s, read back as float4;
* ``no_topk_f4``: both.

It prints each build's ``ptxas`` line, the occupancy those registers and
that shared memory allow, and the SASS opcode mix of the search kernel
(whole function, and the span from its first to its last FFMA, which is
the distance loop).

``knn-design`` takes the current ``knn.cu`` (the query-tiled design) and
times it at the same shape, search and slice merge apart, as it is, with
the admission test never passing (``no_admit``: the distance work and the
staging alone), with ``__launch_bounds__`` asking one or three blocks
per SM (``lb1``, ``lb3``), and under other launch plans than
``knn_plan``'s.

``utility`` takes the current ``utility.cu`` (the cluster design) and
times it at R = 1250, M = 6, f64, sigmoid, as it is, with only the M
column threads walking (``walker_m``), without the column walk
(``no_walk``), and runs it once with ``%globaltimer`` and ``clock64``
stamps of block 0 (entry, the cluster barrier, each chunk's arrival and
walk, exit) and of each filling block.

``chain`` times a chain of dependent float64 adds, the floor of K1's
ordered column sum: cycles per add from ``clock64`` in one thread; the
device time of one launch that adds 1, 1250 or 4096 values read from
shared memory in groups of 8 (1250 is the main path's group size); the
same walk with a stride of M = 6 doubles, on 1 to 32 threads; and a walk
that issues one group's loads before the other group's adds.

``ssd-bwd`` takes the current ``ssd_bwd.cu`` and builds it as it is
(each product stage's ``__launch_bounds__`` asking for its own number of
resident blocks an SM) and with every product stage asking for 1, 2, 3
or 4; it prints each build's ``ptxas`` registers and spills by stage,
then times each build at mamba2-130m's training shape (B = 8, S = 1024,
H = 24, P = 64, N = 128, chunk 128) under ``torch.profiler``, stage by
stage, in turns (as it is, 1, 2, 3, 4, 4, 3, 2, 1, as it is), each
checked against ``ssd_chunk_bwd_ref`` first.

Builds into ``build/probe/``.  Needs a card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

OUT = ROOT / "build" / "probe"

# Text edits of the first design's knn.cu (each anchor must be present).
_TOPK = """        if (d < bd[qq][K - 1]) {
          bd[qq][K - 1] = d;
          bi[qq][K - 1] = j;
#pragma unroll
          for (int s = K - 1; s > 0; --s) {
            if (bd[qq][s] < bd[qq][s - 1]) {
              float td = bd[qq][s]; bd[qq][s] = bd[qq][s - 1]; bd[qq][s - 1] = td;
              int ti = bi[qq][s]; bi[qq][s] = bi[qq][s - 1]; bi[qq][s - 1] = ti;
            }
          }
        }"""
_MIN = "        bd[qq][0] = fminf(bd[qq][0], d);"
_STRIDE = "  const int stride = D + 1;"
_STRIDE_F4 = "  const int stride = ((Dp / 4) & 1) ? Dp : Dp + 4;  // odd float4 count"
_STAGE = """    for (int i = tid; i < rows * D; i += kThreads) {
      int r = i / D;
      xs[r * stride + (i - r * D)] = x[(size_t)base * D + i];
    }"""
_STAGE_F4 = """    {
      const int c4n = D >> 2;  // D % 4 == 0 and c4n divides kThreads (D = 32)
      const int rstep = kThreads / c4n;
      const int c4 = tid % c4n;
      for (int r = tid / c4n; r < rows; r += rstep)
        reinterpret_cast<float4*>(xs + r * stride)[c4] =
            reinterpret_cast<const float4*>(x + (size_t)(base + r) * D)[c4];
    }"""
_READ = """        const float x0 = xr[c];
        const float x1 = c + 1 < D ? xr[c + 1] : 0.0f;
        const float x2 = c + 2 < D ? xr[c + 2] : 0.0f;
        const float x3 = c + 3 < D ? xr[c + 3] : 0.0f;"""
_READ_F4 = """        const float4 xv = *reinterpret_cast<const float4*>(xr + c);
        const float x0 = xv.x, x1 = xv.y, x2 = xv.z, x3 = xv.w;"""
_SMEM = "(size_t)kTile * (D + 1)"
_SMEM_F4 = "(size_t)kTile * (((((D + 3) & ~3) / 4) & 1) ? ((D + 3) & ~3) : ((D + 3) & ~3) + 4)"

VARIANTS = {
    "as_is": [],
    "no_topk": [(_TOPK, _MIN)],
    "f4_staging": [(_STRIDE, _STRIDE_F4), (_STAGE, _STAGE_F4), (_READ, _READ_F4),
                   (_SMEM, _SMEM_F4)],
    "no_topk_f4": [(_TOPK, _MIN), (_STRIDE, _STRIDE_F4), (_STAGE, _STAGE_F4),
                   (_READ, _READ_F4), (_SMEM, _SMEM_F4)],
}

_CHAIN_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// One thread: n dependent adds of a value the compiler cannot fold.
__global__ void chain_clock(const double* v, double* out, long long* cycles, int n) {
  double s = 0.0;
  const double b = v[0];
  const long long t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < n; ++i) s = s + b;
  const long long t1 = clock64();
  out[0] = s;
  cycles[0] = t1 - t0;
}
// The column sum's shape: rows read from shared memory 8 ahead, added in order.
__global__ void chain_rows(const double* v, double* out, int n) {
  __shared__ double rows[4096];
  for (int i = threadIdx.x; i < n; i += blockDim.x) rows[i] = v[i];
  __syncthreads();
  if (threadIdx.x != 0) return;
  double s = 0.0;
  int r = 0;
  for (; r + 8 <= n; r += 8) {
    double w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j] = rows[r + j];
#pragma unroll
    for (int j = 0; j < 8; ++j) s = s + w[j];
  }
  for (; r < n; ++r) s = s + rows[r];
  out[0] = s;
}
// Rows of M doubles, thread l (l < lanes) on column l < M ? l : 0: the
// same walk, with a stride of M.
__global__ void chain_cols(const double* v, double* out, int n, int M, int lanes) {
  __shared__ double tile[6000];
  for (int i = threadIdx.x; i < n * M; i += blockDim.x) tile[i] = v[i];
  __syncthreads();
  if (threadIdx.x >= lanes) return;
  const double* src = tile + (threadIdx.x < M ? threadIdx.x : 0);
  double s = 0.0;
  int r = 0;
  for (; r + 8 <= n; r += 8) {
    double w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j] = src[(r + j) * M];
#pragma unroll
    for (int j = 0; j < 8; ++j) s = s + w[j];
  }
  for (; r < n; ++r) s = s + src[r * M];
  out[threadIdx.x] = s;
}
// A contiguous column walked in groups of 8 rows (16-byte loads), two groups
// in turn: one group's loads go out before the other group's adds.
__global__ void chain_interleaved(const double* v, double* out, int n, int lanes) {
  __shared__ __align__(16) double col[4096];
  for (int i = threadIdx.x; i < 4096; i += blockDim.x) col[i] = v[i];
  __syncthreads();
  if (threadIdx.x >= lanes) return;
  const double2* p = reinterpret_cast<const double2*>(col);
  const int groups = n / 8;
  double2 a[4], b[4];
  double s = 0.0;
#pragma unroll
  for (int j = 0; j < 4; ++j) a[j] = p[j];
  for (int g = 0; g < groups; g += 2) {
    if (g + 1 < groups) {
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = p[(g + 1) * 4 + j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) s = (s + a[j].x) + a[j].y;
    if (g + 1 >= groups) break;
    if (g + 2 < groups) {
#pragma unroll
      for (int j = 0; j < 4; ++j) a[j] = p[(g + 2) * 4 + j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) s = (s + b[j].x) + b[j].y;
  }
  out[threadIdx.x] = s;
}
extern "C" int probe_chain_cols(const void* v, void* out, int n, int M, int lanes, void* st) {
  if (n * M > 6000) return (int)cudaErrorInvalidValue;
  chain_cols<<<1, 256, 0, (cudaStream_t)st>>>((const double*)v, (double*)out, n, M, lanes);
  return (int)cudaGetLastError();
}
extern "C" int probe_chain_interleaved(const void* v, void* out, int n, int lanes, void* st) {
  if (n > 4096 || n % 8 != 0) return (int)cudaErrorInvalidValue;
  chain_interleaved<<<1, 256, 0, (cudaStream_t)st>>>((const double*)v, (double*)out, n, lanes);
  return (int)cudaGetLastError();
}
extern "C" int probe_chain_clock(const void* v, void* out, void* cycles, int n, void* st) {
  chain_clock<<<1, 1, 0, (cudaStream_t)st>>>((const double*)v, (double*)out,
                                             (long long*)cycles, n);
  return (int)cudaGetLastError();
}
extern "C" int probe_chain_rows(const void* v, void* out, int n, void* st) {
  if (n > 4096) return (int)cudaErrorInvalidValue;
  chain_rows<<<1, 256, 0, (cudaStream_t)st>>>((const double*)v, (double*)out, n);
  return (int)cudaGetLastError();
}
"""


def _build(name: str, source: str, flags=()) -> Path:
    from repro_torch.kernels.nvcc import _ARCH, _COMMON, _nvcc

    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / f"{name}.cu"
    cu.write_text(source)
    lib = OUT / f"lib{name}.so"
    log = subprocess.run([_nvcc(), *_ARCH, *_COMMON, *flags, "-o", str(lib), str(cu)],
                         capture_output=True, text=True, timeout=600)
    if log.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{log.stdout}{log.stderr}")
    (OUT / f"{name}.log").write_text(log.stdout + log.stderr)
    return lib


def _ptxas(name: str, kernel_key: str):
    """(registers, shared bytes) ptxas reported for the kernel named like ``kernel_key``."""
    text = (OUT / f"{name}.log").read_text()
    for block in re.split(r"ptxas info\s*: Compiling entry function", text)[1:]:
        head = block.split("\n", 1)[0]
        if kernel_key not in head:
            continue
        regs = re.search(r"Used (\d+) registers", block)
        smem = re.search(r"(\d+) bytes smem", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        return (int(regs.group(1)) if regs else None, int(smem.group(1)) if smem else 0,
                int(spill.group(1)) if spill else 0)
    return None, None, None


def _sass_mix(lib: Path, kernel_key: str):
    from torch.utils.cpp_extension import CUDA_HOME

    tool = str(Path(CUDA_HOME) / "bin" / "cuobjdump") if CUDA_HOME else "cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", sass)
    body = next((f for f in funcs[1:] if kernel_key in f.split("\n", 1)[0]), None)
    if body is None:
        return None, None
    ops = []
    for line in body.splitlines():
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", line)
        if m:
            ops.append(m.group(2).split(".")[0])
    ffma = [i for i, op in enumerate(ops) if op == "FFMA"]
    loop = Counter(ops[ffma[0]:ffma[-1] + 1]) if ffma else Counter()
    return Counter(ops), loop


def _fmt(c: Counter, top=14) -> str:
    return ", ".join(f"{op} {n}" for op, n in c.most_common(top)) + f" (total {sum(c.values())})"


def probe_knn(source: Path, iters: int) -> None:
    import torch

    from chip_smoke import device_ms

    src = source.read_text()
    libs = {}
    for name, edits in VARIANTS.items():
        s = src
        for a, b in edits:
            if a not in s:
                raise SystemExit(f"{name}: anchor not found in {source}: {a.splitlines()[0]!r}")
            s = s.replace(a, b)
        libs[name] = _build(f"knn_{name}", s)
    g = torch.Generator(device="cuda").manual_seed(0)
    Q, N, D, K = 1365, 80_000, 32, 5
    q = torch.randn((Q, D), generator=g, device="cuda")
    x = torch.randn((N, D), generator=g, device="cuda")
    xn = (x * x).sum(dim=1)
    y = torch.randint(0, 7, (N,), generator=g, device="cuda", dtype=torch.int32)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    P, I = ctypes.c_void_p, ctypes.c_int
    outs = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        lib.knn_slice_count.argtypes = [I, I, I, I]
        lib.knn_slice_count.restype = I
        fn = lib.knn_topk_f32
        fn.argtypes = [P] * 8 + [I] * 5 + [P]
        fn.restype = I
        slices = lib.knn_slice_count(Q, N, K, sms)
        od = torch.empty((Q, K), device="cuda")
        ol = torch.empty((Q, K), device="cuda", dtype=torch.int32)
        pd = torch.empty((Q, slices, K), device="cuda")
        pi = torch.empty((Q, slices, K), device="cuda", dtype=torch.int32)

        def call(fn=fn, od=od, ol=ol, pd=pd, pi=pi, slices=slices):
            err = fn(q.data_ptr(), x.data_ptr(), xn.data_ptr(), y.data_ptr(), od.data_ptr(),
                     ol.data_ptr(), pd.data_ptr(), pi.data_ptr(), Q, N, D, K, slices,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")

        ms = device_ms(call, "knn_", iters=iters)
        outs[name] = (od.clone(), ol.clone())
        regs, smem_static, spill = _ptxas(f"knn_{name}", "knn_topk_kernelILi5E")
        dyn = 4 * (8 * 32 + 256 * ((36 if "f4" in name else 33)))
        warps_regs = (65536 // (((regs * 32 + 255) // 256) * 256)) // 8 if regs else None
        by_smem = (233472 // (dyn + 1024))
        print(f"  {name}: {ms:.6f} ms (Q={Q} N={N} D={D} k={K}, {slices} slices, "
              f"grid {(Q + 7) // 8}x{slices}); ptxas {regs} registers, {spill} B spilled, "
              f"{dyn} B dynamic shared; blocks per SM by registers {warps_regs}, "
              f"by shared memory {by_smem}")
    same = torch.equal(outs["as_is"][0], outs["f4_staging"][0]) and torch.equal(
        outs["as_is"][1], outs["f4_staging"][1])
    print(f"  f4_staging equals as_is bit for bit: {same}")
    whole, loop = _sass_mix(libs["as_is"], "knn_topk_kernelILi5E")
    if whole is not None:
        print(f"  SASS as_is, knn_topk_kernel<5> whole: {_fmt(whole)}")
        print(f"  SASS as_is, first..last FFMA (distance loop): {_fmt(loop)}")
    whole, loop = _sass_mix(libs["f4_staging"], "knn_topk_kernelILi5E")
    if whole is not None:
        print(f"  SASS f4_staging, first..last FFMA: {_fmt(loop)}")


DESIGN_VARIANTS = {
    "as_is": [],
    "no_admit": [("        if (d <= thr && idx < hi", "        if (d < -3.0e38f && idx < hi")],
    "lb1": [("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)")],
    "lb3": [("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 3)")],
}


def probe_knn_design(iters: int) -> None:
    import torch

    from chip_smoke import device_ms
    from repro_torch.kernels.knn import ops as knn_ops

    src = (ROOT / "src" / "repro_torch" / "kernels" / "knn" / "csrc" / "knn.cu").read_text()
    libs = {}
    for name, edits in DESIGN_VARIANTS.items():
        s = src
        for a, b in edits:
            if a not in s:
                raise SystemExit(f"{name}: anchor not found: {a!r}")
            s = s.replace(a, b)
        libs[name] = _build(f"knnd_{name}", s)
    g = torch.Generator(device="cuda").manual_seed(0)
    Q, N, D, K = 1365, 80_000, 32, 5
    q = torch.randn((Q, D), generator=g, device="cuda")
    x = torch.randn((N, D), generator=g, device="cuda")
    xn = (x * x).sum(dim=1)
    y = torch.randint(0, 7, (N,), generator=g, device="cuda", dtype=torch.int32)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    base = knn_ops.knn_plan(Q, N, D, K, sms)
    plans = {"plan": base}
    tiles = -(-N // knn_ops.TILE_ROWS)
    for label, tile, stages, target in (("1 block/SM, 3 stages", 128, 3, 12),
                                        ("tile 64, 2 stages", 64, 2, 12),
                                        ("tile 64, 3/SM", 64, 2, 18),
                                        ("half the slices", 128, 2, base.slices // 2),
                                        ("twice the slices", 128, 2, base.slices * 2)):
        per = -(-tiles // target)
        plans[label] = knn_ops.KnnPlan(tile, stages, -(-tiles // per), per * knn_ops.TILE_ROWS,
                                       knn_ops.knn_smem_bytes(tile, D, stages, K))
    P, I = ctypes.c_void_p, ctypes.c_int
    ref = None
    for name, path in libs.items():
        fn = ctypes.CDLL(str(path)).knn_topk_f32
        fn.argtypes = [P] * 8 + [I] * 8 + [ctypes.c_longlong, P]
        fn.restype = I
        runs = {"as_is": plans.items(), "lb3": [("tile 64, 3/SM", plans["tile 64, 3/SM"]),
                                                 ("plan", base)]}
        for label, plan in runs.get(name, [("plan", base)]):
            od = torch.empty((Q, K), device="cuda")
            ol = torch.empty((Q, K), device="cuda", dtype=torch.int32)
            pd = torch.empty((Q, plan.slices, K), device="cuda")
            pi = torch.empty((Q, plan.slices, K), device="cuda", dtype=torch.int32)

            def call(fn=fn, od=od, ol=ol, pd=pd, pi=pi, plan=plan):
                err = fn(q.data_ptr(), x.data_ptr(), xn.data_ptr(), y.data_ptr(), od.data_ptr(),
                         ol.data_ptr(), pd.data_ptr(), pi.data_ptr(), Q, N, D, K,
                         plan.query_tile, plan.stages, plan.slices, plan.slice_rows,
                         plan.smem_bytes, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name} {plan}: CUDA error {err}")

            ms, parts = device_ms(call, "knn_", iters=iters, parts=("knn_search", "knn_merge"))
            if name == "as_is":
                ref = ref or (od.clone(), ol.clone())
                same = torch.equal(od, ref[0]) and torch.equal(ol, ref[1])
            else:
                same = "n/a"
            regs, _, spill = _ptxas(f"knnd_{name}", "knn_search_kernelILi8E")
            print(f"  {name}, {label} ({plan.query_tile} x {plan.stages} stages x "
                  f"{plan.slices} slices, grid {plan.grid(Q)}, {plan.smem_bytes} B): "
                  f"{ms:.6f} ms = search {parts['knn_search']:.6f} + merge "
                  f"{parts['knn_merge']:.6f}; ptxas {regs} registers, {spill} B spilled; "
                  f"equal to the plan's output: {same}")
    whole, loop = _sass_mix(libs["as_is"], "knn_search_kernelILi8E")
    if whole is not None:
        print(f"  SASS knn_search_kernel<8> whole: {_fmt(whole, 20)}")
        print(f"  SASS first..last FFMA: {_fmt(loop, 20)}")


_STAMP_DEFS = """namespace cg = cooperative_groups;
__device__ unsigned long long g_stamp[512];
__device__ __forceinline__ unsigned long long probe_timer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(i) if (tid == 0) { g_stamp[rank * 64 + (i)] = probe_timer(); \\
                                 g_clock[rank * 64 + (i)] = clock64(); }
__device__ long long g_clock[512];
"""
UTILITY_VARIANTS = {
    "as_is": [],
    "walker_m": [("    const bool walker = tid < ((M + 31) & ~31);",
                  "    const bool walker = tid < M;")],
    "no_walk": [("        s = add_column<T>(buf", "        if (R < 0) s = add_column<T>(buf")],
    "stamped": [
        ("namespace cg = cooperative_groups;\n", _STAMP_DEFS),
        ("  const int slot_elems = M * stride;\n",
         "  const int slot_elems = M * stride;\n  STAMP(0);\n"),
        ("  cluster_wait();\n\n  if (rank == 0) {", "  cluster_wait();\n  STAMP(1);\n  if (rank == 0) {"),
        ("        mbar_wait(&full[slot], (t / slots) & 1);\n",
         "        mbar_wait(&full[slot], (t / slots) & 1);\n        STAMP(2 + min(c, 23));\n"),
        ("                          min(chunk_rows, R - c * chunk_rows), s);\n",
         "                          min(chunk_rows, R - c * chunk_rows), s);\n"
         "        STAMP(26 + min(c, 23));\n"),
        ("                   stride, r0, min(R, r0 + chunk_rows), M, penalty);\n",
         "                   stride, r0, min(R, r0 + chunk_rows), M, penalty);\n"
         "      STAMP(2 + min(t, 23));\n"),
        ("  // No block leaves while its shared memory may still be written.\n",
         "  STAMP(60);\n"),
    ],
}
_STAMP_READ = """
extern "C" int probe_stamps(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_stamp, sizeof(g_stamp));
}
extern "C" int probe_clocks(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_clock, sizeof(g_clock));
}
"""


def _sass_text(lib: Path, kernel_key: str) -> str:
    """The SASS of the kernel whose mangled name contains ``kernel_key``."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = str(Path(CUDA_HOME) / "bin" / "cuobjdump") if CUDA_HOME else "cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", sass)
    return next((f for f in funcs[1:] if kernel_key in f.split("\n", 1)[0]), "")


def probe_utility(iters: int) -> None:
    import numpy as np
    import torch

    from chip_smoke import device_ms
    from repro_torch.core.utility import PENALTY_CODES
    from repro_torch.kernels.utility import ops as util_ops

    src = (ROOT / "src" / "repro_torch" / "kernels" / "utility" / "csrc" /
           "utility.cu").read_text()
    libs = {}
    for name, edits in UTILITY_VARIANTS.items():
        s = src
        for a, b in edits:
            if a not in s:
                raise SystemExit(f"{name}: anchor not found: {a!r}")
            s = s.replace(a, b)
        if name == "stamped":
            s += _STAMP_READ
        libs[name] = _build(f"util_{name}", s, ("--fmad=false",))
    r, m = 1250, 6
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.uniform(0, 1, (r, m)), device="cuda")
    d = torch.as_tensor(rng.uniform(0.01, 0.3, r), device="cuda")
    e = torch.as_tensor(rng.uniform(0.0, 0.6, m), device="cuda")
    u = torch.empty_like(a)
    sums = torch.empty(m, dtype=torch.float64, device="cuda")
    plan = util_ops.utility_plan(r, m, 8, True)
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        fn = lib.utility_scores_f64
        fn.argtypes = [P, P, P, I, P, P] + [I] * 8 + [P]
        fn.restype = I

        def call(fn=fn):
            err = fn(a.data_ptr(), d.data_ptr(), e.data_ptr(), 0, u.data_ptr(), sums.data_ptr(),
                     r, m, PENALTY_CODES["sigmoid"], plan.block_rows, plan.cluster,
                     plan.chunk_rows, plan.blocks, plan.slots,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")

        if name != "stamped":
            ms = device_ms(call, "utility_", iters=iters)
            print(f"  {name}: {ms:.6f} ms (R={r} M={m} f64 sigmoid, {plan})")
            if name == "as_is":
                text = _sass_text(path, "utility_sums_kernelIdE")
                (OUT / "utility_sums_f64.sass").write_text(text)
                print(f"  SASS utility_sums_kernel<double>: {_fmt(_sass_mix(path, 'utility_sums_kernelIdE')[0], 20)}; "
                      f"written to {OUT / 'utility_sums_f64.sass'}")
            continue
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        lib.probe_stamps.argtypes = [P]
        lib.probe_clocks.argtypes = [P]
        buf = (ctypes.c_ulonglong * 512)()
        clk = (ctypes.c_longlong * 512)()
        if lib.probe_stamps(buf) or lib.probe_clocks(clk):
            raise RuntimeError("could not read the stamps")
        t0 = buf[0]
        rel = lambda v: f"{(v - t0) / 1e3:.3f}" if v else "-"  # noqa: E731
        n = len(plan.chunks(r))
        walk = [(clk[26 + c] - clk[2 + c], buf[26 + c] - buf[2 + c]) for c in range(min(n, 24))]
        print("  block 0 walk per chunk, SM cycles / ns: "
              + " ".join(f"{cy}/{ns}" for cy, ns in walk))
        print("  stamped, us from block 0's entry: barrier " + rel(buf[1])
              + "; chunk ready " + " ".join(rel(buf[2 + c]) for c in range(min(n, 24)))
              + "; walked " + " ".join(rel(buf[26 + c]) for c in range(min(n, 24)))
              + "; exit " + rel(buf[60]))
        for b in range(1, plan.cluster):
            row = buf[64 * b: 64 * b + 64]
            print(f"    block {b}: barrier {rel(row[1])} filled "
                  + " ".join(rel(row[2 + t]) for t in range(3)) + f"; exit {rel(row[60])}")


def probe_chain() -> None:
    import torch

    from chip_smoke import device_ms

    lib = ctypes.CDLL(str(_build("chain", _CHAIN_SRC, ("--fmad=false",))))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.probe_chain_clock.argtypes = [P, P, P, I, P]
    lib.probe_chain_rows.argtypes = [P, P, I, P]
    v = torch.rand(4096, dtype=torch.float64, device="cuda") + 0.5
    out = torch.zeros(1, dtype=torch.float64, device="cuda")
    cyc = torch.zeros(1, dtype=torch.int64, device="cuda")
    st = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for n in (1 << 16, 1 << 20):
        if lib.probe_chain_clock(v.data_ptr(), out.data_ptr(), cyc.data_ptr(), n, st()):
            raise RuntimeError("chain_clock did not launch")
        torch.cuda.synchronize()
        print(f"  dependent f64 adds, one thread, n={n}: {int(cyc) / n:.3f} cycles per add")
    n = 1 << 20
    ms = device_ms(lambda: lib.probe_chain_clock(v.data_ptr(), out.data_ptr(), cyc.data_ptr(),
                                                 n, st()), "chain_clock", iters=5)
    print(f"  dependent f64 adds: {ms * 1e6 / n:.4f} ns per add ({n} adds in {ms:.6f} ms)")
    for n in (1, 1250, 4096):
        ms = device_ms(lambda n=n: lib.probe_chain_rows(v.data_ptr(), out.data_ptr(), n, st()),
                       "chain_rows", iters=200)
        print(f"  one launch: {n} rows from shared memory added in order: {ms:.6f} ms")
    lib.probe_chain_cols.argtypes = [P, P, I, I, I, P]
    lib.probe_chain_interleaved.argtypes = [P, P, I, I, P]
    outs = torch.zeros(256, dtype=torch.float64, device="cuda")
    for m, lanes in ((1, 1), (6, 1), (6, 6), (6, 32)):
        ms = device_ms(lambda m=m, lanes=lanes: lib.probe_chain_cols(
            v.data_ptr(), outs.data_ptr(), 1000, m, lanes, st()), "chain_cols", iters=200)
        print(f"  one launch: 1000 rows of {m} columns, {lanes} lanes walking: {ms:.6f} ms")
    for lanes in (1, 32):
        ms = device_ms(lambda lanes=lanes: lib.probe_chain_interleaved(
            v.data_ptr(), outs.data_ptr(), 1000, lanes, st()), "chain_interleaved", iters=200)
        print(f"  one launch: 1000 rows, two groups of 8 in turn, {lanes} lanes: {ms:.6f} ms")


def probe_ssd_bwd() -> None:
    import torch

    from chip_smoke import K5B_STAGES, SSD_ATOL, SSD_RTOL, _close, _ssd_inputs, device_ms
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_chunk_bwd_ref

    src = nvcc.SOURCES["ssd_bwd"].path.read_text()
    bound = re.compile(r"__launch_bounds__\(kThreads, \d\)")
    if not bound.search(src):
        raise SystemExit("ssd-bwd: no product stage with a minimum of resident blocks")
    sources = {"as_is": src, **{f"min{n}": bound.sub(f"__launch_bounds__(kThreads, {n})", src)
                                for n in (1, 2, 3, 4)}}
    libs = {}
    for name, text in sources.items():
        libs[name] = ctypes.CDLL(str(_build(f"ssd_bwd_{name}", text)))
        libs[name].repro_cuda_error_string.argtypes = [ctypes.c_int]
        libs[name].repro_cuda_error_string.restype = ctypes.c_char_p
        print(f"{name}: " + "; ".join(
            f"{stage.removeprefix('ssd_chunk_bwd_')} {regs} regs, {spill} B spilled"
            for stage in K5B_STAGES
            for regs, _, spill in [_ptxas(f"ssd_bwd_{name}", stage + "_kernel")]))
    gen = torch.Generator(device="cuda").manual_seed(16)
    b, s, h, p, n, chunk = 8, 1024, 24, 64, 128, 128
    x, dt, a_log, bm, cm = _ssd_inputs(gen, b, s, h, p, n)
    dA = (dt * -torch.exp(a_log)).contiguous()
    xdt = (x * dt[..., None]).contiguous()
    dy = torch.randn((b, s, h, p), generator=gen, device="cuda")
    _, _, cum, entering = ssd_ops.ssd_chunk_scan_saving(xdt, dA, bm, cm, chunk)
    refs = ssd_chunk_bwd_ref(xdt, bm, cm, dy, cum, entering, chunk)
    built = nvcc._LIBS.get("ssd_bwd")
    try:
        for name in ("as_is", "min1", "min2", "min3", "min4", "min4", "min3", "min2", "min1",
                     "as_is"):
            nvcc._LIBS["ssd_bwd"] = libs[name]
            args = (xdt, bm, cm, dy, cum, entering, chunk)
            err = max(_close(g, r, SSD_ATOL, f"K5b {name}", SSD_RTOL)
                      for g, r in zip(ssd_ops.ssd_chunk_bwd(*args), refs))
            ms, stage_ms = device_ms(lambda: ssd_ops.ssd_chunk_bwd(*args), "ssd_chunk_bwd",
                                     iters=5, parts=K5B_STAGES)
            print(f"{name}: {ms:.6f} ms, max |d| {err:.3g}; "
                  + ", ".join(f"{k.removeprefix('ssd_chunk_bwd_')} {v:.6f}"
                              for k, v in stage_ms.items()))
    finally:
        if built is None:
            nvcc._LIBS.pop("ssd_bwd", None)
        else:
            nvcc._LIBS["ssd_bwd"] = built


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="what", required=True)
    k = sub.add_parser("knn")
    k.add_argument("--source", type=Path,
                   default=ROOT / "src" / "repro_torch" / "kernels" / "knn" / "csrc" / "knn.cu")
    k.add_argument("--iters", type=int, default=20)
    sub.add_parser("knn-design").add_argument("--iters", type=int, default=20)
    sub.add_parser("utility").add_argument("--iters", type=int, default=200)
    sub.add_parser("chain")
    sub.add_parser("ssd-bwd")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_probe: needs a CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import card_line

    print(card_line())
    if args.what == "knn":
        probe_knn(args.source, args.iters)
    elif args.what == "knn-design":
        probe_knn_design(args.iters)
    elif args.what == "utility":
        probe_utility(args.iters)
    elif args.what == "ssd-bwd":
        probe_ssd_bwd()
    else:
        probe_chain()
    return 0


if __name__ == "__main__":
    sys.exit(main())
