"""Probes of what bounds K2 (k-NN), K1 (Eq. 2 utility), K5b (the SSD
backward), the RG-LRU scan and K3's bf16 instance at head dim 256, of
K3b in training, and A/B timings of K3's, K4's, K3b's and the RG-LRU
backward's designs, on one NVIDIA GPU.

    python3 benchmarks/torch_kernel_probe.py knn --source OLD/knn.cu
    python3 benchmarks/torch_kernel_probe.py knn-design
    python3 benchmarks/torch_kernel_probe.py utility
    python3 benchmarks/torch_kernel_probe.py chain
    python3 benchmarks/torch_kernel_probe.py ssd-bwd
    python3 benchmarks/torch_kernel_probe.py rglru [--old OLD/rglru_scan.cu]
    python3 benchmarks/torch_kernel_probe.py scan-step
    python3 benchmarks/torch_kernel_probe.py k3b-train [--steps 24] [--lr 1e-3]
    python3 benchmarks/torch_kernel_probe.py k3 --old OLD/flash_attention.cu
    python3 benchmarks/torch_kernel_probe.py k3-split [--old OLD/flash_attention.cu]
    python3 benchmarks/torch_kernel_probe.py k3-phases
    python3 benchmarks/torch_kernel_probe.py wgmma-rate
    python3 benchmarks/torch_kernel_probe.py k4 --old OLD/decode_attention.cu
    python3 benchmarks/torch_kernel_probe.py f32-split [--tiles]
    python3 benchmarks/torch_kernel_probe.py k3b --old OLD/flash_attention_bwd.cu
    python3 benchmarks/torch_kernel_probe.py rglru-bwd --old OLD/rglru_scan_bwd.cu

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

``rglru`` takes the current ``rglru_scan.cu`` (the chunked two-pass
scan) and builds it with each chunk length T in 32, 64, 128 and 256 (a
text edit of ``kChunk`` in its header ``rglru.cuh``, inlined), prints
each build's ``ptxas`` registers of the two passes, then times each
build under ``torch.profiler`` at phase 14's three shapes in bf16 (B =
8, S = 1024; B = 8, S = 1; B = 1, S = 1024; L = 4096), pass by pass,
in turns (32, 64, 128, 256, 256, 128, 64, 32), each checked against
``rglru_scan_ref`` first.  With ``--old``, the ``rglru_scan.cu`` of an
earlier commit is built too and timed at the same shapes at the start
and the end of the turns: the one-thread-a-(batch, channel) source (its
C entry has no scratch), a chunked one (its C entry takes the summary
scratch, sized by its own ``rglru_scan_chunk``) or one whose entry also
takes the carries for the backward (passed null, as prefill and decode
pass them), built in its own directory for its headers, and the SASS instruction counts of its
kernels are printed beside those of the current source's T = 64 build.

``k3 --old`` and ``k3b --old`` build an earlier tree's
``flash_attention.cu`` or ``flash_attention_bwd.cu`` as it is (its own
directory on the include path; a C entry of this tree's signature: the
backward's takes the head groups) and time it against this tree's in one
process, in turns (old, new, new, old), under ``torch.profiler``, kernel
by kernel, each checked against the plain version first (reported, not
failed on), beside one PyTorch call on the same inputs (SDPA in the
shape's type: the forward; the backward as forward and backward less the
forward): ``k3`` at ``K3_AB_SHAPES`` (float32: tinyllama's prefill shape,
B = 8, S = 1024, 32 over 4, D = 64, causal and not, and gemma-7b's, 16
over 16, D = 256; bf16: tinyllama's and llama4's, which must stay
bit-identical, and at D = 256 gemma-7b's causal and not,
recurrentgemma-9b's local layers, 16 over 1, and gemma3-4b's window of
1024), printing max |old - new| and whether two calls of this tree's are
bit-identical; ``k3b`` at phase 16 (a)'s float32 shapes (tinyllama's,
and B = 1, S = 1024, 16 over 16, D = 256).  ``k4 --old`` does the same for
an earlier ``decode_attention.cu`` (with the old split rule, every block
an SM of its own) at ``K4_AB_SHAPES`` (bf16 at D = 256 with G = 1, 2, 4
and 16, and the instances that must stay bit-identical: bf16 at D = 64
and 128, f32 at 64 and 256), phase 7's lengths, beside SDPA with a
mask and the bound; it then times this tree's bf16 D = 256 instances at
every split count from 1 to 8 and with one valid position per row.
``k3-split`` builds this tree's ``flash_attention.cu`` (and with
``--old`` an earlier one) as it is and with parts of a tile's work
dropped by text edits (``K3_SPLIT_EDITS``: the warpgroups' order, S, P.V,
the softmax's exponentials and rescale, then the products alone, S alone
and P.V alone; the sums are wrong), prints each build's registers and
times them in turns at gemma-7b's prefill and recurrentgemma-9b's local
shape.  ``k3-phases`` builds it with clock64 stamps at its phases
(``K3_PHASE_EDITS``) and prints each phase's cycles an iteration, per
warpgroup.  ``wgmma-rate`` runs K3's product chains alone
(``_WGMMA_RATE_SRC``) on one and two warpgroups an SM: the tensor cores'
rate on those shapes.  ``k3b --old`` then takes
``tests/test_torch_cuda.py``'s head-dim-256 cases at G = 16
(recurrentgemma-9b's training shape and B = 2, S = 3000; its seeds) in
float32 and reports without failing, gradient by gradient, each design's
largest difference from a plain version and the share of the card
test's tolerance it uses (1 is the limit): against
``flash_attention_bwd_ref`` in float32, in float64 and with
``rounding="tf32x3"`` (this design's arithmetic), and the float32 plain
version against the float64 one.  ``rglru-bwd --old`` times an earlier
tree's ``rglru_scan_bwd.cu`` against this one at the training shape (B =
8, S = 1024, L = 4096) and a lone prompt's (B = 1), the earlier design
fed every 64th step's carry; the new one is also run twice
bit-identically.

``f32-split`` builds K3's and K3b's sources as they are and in variants
made by text edits of ``mma.cuh``'s split and 3xTF32 product: ``cvt``
(each split by ``cvt.rna.tf32.f32``, the PTX instruction, where the
source rounds with two integer ops to the same bits), ``no_split`` (hi the
raw bits, lo 0: no split work, wrong sums) and ``one_pass`` (hi.hi alone:
a third of the products, wrong sums), prints each build's ptxas registers
and spills of the float32 kernels, and times each in turns (as it is,
cvt, no_split, one_pass, one_pass, no_split, cvt, as it is) under
``torch.profiler``, kernel by kernel: K3 f32 at tinyllama's prefill shape
and gemma-7b's (B = 8, 16 over 16, D = 256), K3b f32 at phase 16 (a)'s
two shapes; each variant's largest difference from the plain version is
printed.  With ``--tiles`` the variants keep the arithmetic and change
tile sizes at D = 64 (dkdv's query tiles 64 or 16, dq's key tiles 64,
the forward's key tiles 32) or how many n-tiles ``mma_pairs_add`` sums
together (always 4, or 8; as built, 8 where a warp holds 16 or more).

``k3b-train`` trains gemma-7b at phase 16 (c)'s cut depth and shape (3
layers, bf16, B = 8, S = 1024, LMDataset's markov stream, the same seed)
through ``make_train_step`` at ``--lr`` (1e-3 by default) for
``--steps`` steps twice: with the attention backward through K3b, then
through its plain version (``flash_attention_bwd_ref``, on the card).
It first compares the two routes' gradients at the first step, leaf by
leaf, then prints both runs' losses step by step, so a loss that rises
with the kernel and not with the plain version points at the kernel.

``scan-step`` takes the current ``selection_scan.cu`` and its headers and
builds them as they are and in variants made by text edits of
``ahead.cuh``'s warp step, each of which drops one part of a step's
dependent chain: ``no_eq2`` (the Eq. 2 value replaced by acc - completion),
``no_mean_div`` (the member mean's divide dropped), ``no_reduce`` (the
pick's warp reduction replaced by one shuffle) and ``skeleton`` (no
scoring: the pick is the first cell of the permutation, so a step is the
completion, the shuffles of the carry update and the warp's
synchronisation); the rings of fetched steps, the warp's one and four
deep (as it is, two) and the block's two and sixteen (as it is, eight);
and of the block step, ``depth4`` and ``depth16`` (the member loads phase
C issues before its adds).  It times each, in turns,
on ``torch_scan_ab.py``'s tables (per-request, S = 4,095, on one worker
and on four; grouped, on one and on four; single-slot and LRU carry),
and prints ns a step; ``as_is`` is checked bit for bit against the plain
version first.

Builds into ``build/probe/``.  Needs a card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
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


RGLRU_CHUNKS = (32, 64, 128, 256)


def probe_rglru(old: Path | None) -> None:
    import torch

    from chip_smoke import RGLRU_PASSES, RGLRU_SHAPES, _close, device_ms
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.rglru_scan import ops as rglru_ops
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

    path = nvcc.SOURCES["rglru_scan"].path
    header = (path.parent / "rglru.cuh").read_text().replace("#pragma once\n", "")
    chunk_line = re.compile(r"constexpr int kChunk = \d+;")
    if not chunk_line.search(header):
        raise SystemExit("rglru: no kChunk constant in rglru.cuh")
    libs = {}
    for t in RGLRU_CHUNKS:
        name = f"rglru_T{t}"
        # The shared header inlined with its chunk length edited.
        src = path.read_text().replace('#include "rglru.cuh"',
                                       chunk_line.sub(f"constexpr int kChunk = {t};", header))
        lib = ctypes.CDLL(str(_build(name, src)))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        libs[t] = lib
        print(f"T={t}: " + "; ".join(
            f"{k} {regs} regs, {spill} B spilled"
            for k in RGLRU_PASSES for regs, _, spill in [_ptxas(name, k)]))
    old_fn = old_chunk = None
    if old is not None:
        old_src = old.read_text()
        old_lib = _build_in_place("rglru_old", old)  # (its headers beside it)
        old_lib_path = OUT / "librglru_old.so"
        old_fn = old_lib.rglru_scan
        chunked = "void* scratch" in old_src
        saving = "void* carries" in old_src  # passed null: prefill and decode save none
        old_fn.argtypes = ([ctypes.c_void_p] * (10 + chunked + saving) + [ctypes.c_int] * 4
                           + [ctypes.c_void_p])
        old_fn.restype = ctypes.c_int
        if chunked:
            old_lib.rglru_scan_chunk.restype = ctypes.c_int
            old_chunk = old_lib.rglru_scan_chunk()
        # The bf16 staged instances prefill runs (the current scan kernel's
        # without the carries' store; an earlier source has one instance).
        for k in RGLRU_PASSES:
            key = f"{k}I13__nv_bfloat16Lb1E"
            for label, lib_path, want in (("old", old_lib_path, key),
                                          ("T=64", OUT / "librglru_T64.so",
                                           key + ("Lb0E" if k == "rglru_scan_kernel" else ""))):
                total, _ = _sass_mix(lib_path, want)
                print(f"{label} {want} SASS: " + (_fmt(total) if total else "none"))
    gen = torch.Generator(device="cuda").manual_seed(26)
    cases = {}
    for key, (b, s, width) in RGLRU_SHAPES.items():
        u, gp = (torch.randn((b, s, width), generator=gen, device="cuda").to(torch.bfloat16)
                 for _ in range(2))
        vecs = [(torch.randn(width, generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
                for _ in range(5)]
        h0 = torch.randn((b, width), generator=gen, device="cuda")
        cases[key] = (u, gp, vecs, h0, rglru_scan_ref(u, gp, *vecs, h0))

    def time_old(label):
        for key, (u, gp, vecs, h0, (y_ref, h_ref)) in cases.items():
            b, s, width = u.shape
            y = torch.empty_like(u)
            h = torch.empty((b, width), dtype=torch.float32, device="cuda")
            nc = -(-s // old_chunk) if old_chunk else 1
            buf = (torch.empty((2, b, nc - 1, width), device="cuda")
                   if old_chunk and nc > 1 else None)
            scratch = [buf.data_ptr() if buf is not None else None] if old_chunk else []
            scratch += [None] if saving else []

            def call(u=u, gp=gp, vecs=vecs, h0=h0, y=y, h=h, b=b, s=s, width=width,
                     scratch=scratch, buf=buf):
                err = old_fn(u.data_ptr(), gp.data_ptr(), *[v.data_ptr() for v in vecs],
                             h0.data_ptr(), y.data_ptr(), h.data_ptr(), *scratch, b, s, width,
                             1, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"old rglru_scan: CUDA error {err}")

            call()
            _close(y.float(), y_ref.float(), 2e-2, f"old rglru_scan y {key}")
            ms = device_ms(call, "rglru_", iters=20)
            print(f"old {label}, {key} (B={b} S={s} L={width}): {ms:.6f} ms")

    built = nvcc._LIBS.get("rglru_scan")
    try:
        if old_fn is not None:
            time_old("first")
        for t in RGLRU_CHUNKS + RGLRU_CHUNKS[::-1]:
            nvcc._LIBS["rglru_scan"] = libs[t]  # the wrapper sizes its scratch by its chunk
            assert rglru_ops.chunk_len() == t
            for key, (u, gp, vecs, h0, (y_ref, h_ref)) in cases.items():
                b, s, width = u.shape
                y, h = rglru_ops.rglru_scan(u, gp, *vecs, h0)
                err = _close(y.float(), y_ref.float(), 2e-2, f"rglru_scan y T={t} {key}")
                _close(h, h_ref, 1e-4, f"rglru_scan h_last T={t} {key}")
                passes = RGLRU_PASSES if -(-s // t) > 1 else RGLRU_PASSES[1:]
                ms, pass_ms = device_ms(lambda: rglru_ops.rglru_scan(u, gp, *vecs, h0), "rglru_",
                                        iters=20, parts=passes)
                print(f"T={t}, {key} (B={b} S={s} L={width}): {ms:.6f} ms, max |d| {err:.3g}; "
                      + ", ".join(f"{k} {v:.6f}" for k, v in pass_ms.items()))
        if old_fn is not None:
            time_old("last")
    finally:
        if built is None:
            nvcc._LIBS.pop("rglru_scan", None)
        else:
            nvcc._LIBS["rglru_scan"] = built


def _build_in_place(name: str, source: Path) -> ctypes.CDLL:
    """An earlier tree's CUDA source built as it is (its own directory on the
    include path, for its headers) into ``OUT``, loaded."""
    from repro_torch.kernels.nvcc import _ARCH, _COMMON, _nvcc

    OUT.mkdir(parents=True, exist_ok=True)
    lib_path = OUT / f"lib{name}.so"
    log = subprocess.run([_nvcc(), *_ARCH, *_COMMON, "-I", str(source.parent), "-o",
                          str(lib_path), str(source)], capture_output=True, text=True,
                         timeout=600)
    if log.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{log.stdout}{log.stderr}")
    (OUT / f"{name}.log").write_text(log.stdout + log.stderr)
    lib = ctypes.CDLL(str(lib_path))
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _accuracy_report(key, pairs, tol):
    """For each (label, grads, refs): per gradient the largest |d| and the
    largest |d| / (tol + tol |ref|), the share of the card test's
    tolerance used (past 1 the test fails), with the element where it is
    largest."""
    for label, grads, refs in pairs:
        for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
            g, r = g.double(), r.double()
            d = (g - r).abs()
            share = d / (tol + tol * r.abs())
            i = int(share.flatten().argmax())
            print(f"  {key} {name} {label}: max |d| {d.max().item():.6g}, tolerance share "
                  f"{share.flatten()[i].item():.4f} (at {g.flatten()[i].item():.7g} against "
                  f"{r.flatten()[i].item():.7g})")


def _ab_turns(key, call_old, call_new, kernel, iters, parts=()):
    """Device ms of the old and the new design in turns (old, new, new,
    old) under ``torch.profiler``; prints each turn and the means."""
    from chip_smoke import device_ms

    times = {"old": [], "new": []}
    for label, fn in (("old", call_old), ("new", call_new), ("new", call_new),
                      ("old", call_old)):
        got = device_ms(fn, kernel, iters=iters, parts=parts)
        ms, stage_ms = got if parts else (got, {})
        times[label].append(ms)
        print(f"{key} {label}: {ms:.6f} ms"
              + (" (" + ", ".join(f"{k.removeprefix(kernel + '_')} {v:.6f}"
                                  for k, v in stage_ms.items()) + ")" if stage_ms else ""))
    old_ms, new_ms = (sum(times[k]) / 2 for k in ("old", "new"))
    print(f"{key}: old {old_ms:.6f} ms, new {new_ms:.6f} ms, {old_ms / new_ms:.3f} times faster")
    return old_ms, new_ms


# K3's shapes of ``k3 --old``: (B, S, Hq, Hkv, D, causal, window, dtype).
# The float32 instances and bf16 below D = 256 must stay bit-identical to
# an earlier tree's where it did not change them; the bf16 D = 256 shapes
# are gemma-7b's prefill, recurrentgemma-9b's local layers and gemma3-4b's.
K3_AB_SHAPES = {"tinyllama causal": (8, 1024, 32, 4, 64, True, 0, "float32"),
                "tinyllama non-causal": (8, 1024, 32, 4, 64, False, 0, "float32"),
                "gemma7b causal": (8, 1024, 16, 16, 256, True, 0, "float32"),
                "tinyllama bf16": (8, 1024, 32, 4, 64, True, 0, "bfloat16"),
                "llama4 bf16": (8, 1024, 40, 8, 128, True, 0, "bfloat16"),
                "gemma7b bf16": (8, 1024, 16, 16, 256, True, 0, "bfloat16"),
                "gemma7b bf16 non-causal": (8, 1024, 16, 16, 256, False, 0, "bfloat16"),
                "recurrentgemma local bf16": (8, 1024, 16, 1, 256, True, 2048, "bfloat16"),
                "gemma3 window bf16": (1, 1536, 8, 4, 256, True, 1024, "bfloat16")}


def _k3_inputs(gen, b, s, hq, hkv, d, dtype):
    import torch

    q = torch.randn((b, s, hq, d), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    return q, k, v


def _k3_flops(b, s, hq, d, causal, window):
    keys = sum(min(i + 1, window) if window else (i + 1 if causal else s) for i in range(s))
    return 4 * b * hq * keys * d


def _k3_entry(lib):
    fn = lib.flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _k3_call(fn, q, k, v, out, causal, window, what):
    """A closure launching the C entry ``fn`` of K3 on q, k, v into ``out``."""
    import torch

    b, s, hq, d = q.shape
    hkv = k.shape[2]
    dtype = 1 if q.dtype == torch.bfloat16 else 0

    def call():
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, dtype, b, s, s,
                 hq, hkv, d, int(causal), window, d ** -0.5,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{what} flash_attention_fwd: CUDA error {err}")
    return call


def probe_k3_old(old: Path) -> None:
    """K3: an earlier tree's ``flash_attention.cu`` against this tree's, in
    one process, at ``K3_AB_SHAPES``, each checked against the plain
    version, with max |old - new|, timed old, new, new, old under
    ``torch.profiler``, beside SDPA in the shape's type and the bound."""
    import torch
    import torch.nn.functional as F

    from chip_smoke import (BF16_FLOP_PER_S, HBM_BYTES_PER_S, _flash_plain, f32_ops_s,
                            timed_ms)
    from repro_torch.kernels.flash_attention import ops as flash_ops

    old_fn = _k3_entry(_build_in_place("k3_old", old))
    gen = torch.Generator(device="cuda").manual_seed(33)
    for key, (b, s, hq, hkv, d, causal, window, dt) in K3_AB_SHAPES.items():
        dtype = getattr(torch, dt)
        q, k, v = _k3_inputs(gen, b, s, hq, hkv, d, dtype)
        old_out = torch.empty_like(q)
        call_old = _k3_call(old_fn, q, k, v, old_out, causal, window, "old")

        def call_new():
            return flash_ops.flash_attention(q, k, v, causal=causal, window=window)

        call_old()
        new_out = call_new()
        plain = _flash_plain(q, k, v, window, causal)
        for label, out in (("old", old_out), ("new", new_out)):
            print(f"{key} {label} - plain: max |d| {(out - plain).float().abs().max().item():.6g}")
        print(f"{key}: max |old - new| {(old_out - new_out).float().abs().max().item():.6g}; "
              f"new twice bit-identical: {torch.equal(new_out, call_new())}")
        del plain, new_out
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if window and window < s:
            pos = torch.arange(s, device="cuda")
            mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
            sdpa_call = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask, enable_gqa=True)
        else:
            sdpa_call = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=causal, enable_gqa=True)
        sdpa = timed_ms(sdpa_call, iters=10)
        flops = _k3_flops(b, s, hq, d, causal, window)
        byts = q.element_size() * (2 * b * s * hq * d + 2 * b * s * hkv * d)
        ops_s = flops / BF16_FLOP_PER_S if dt == "bfloat16" else f32_ops_s(flops)
        _ab_turns(f"K3 {dt} {key} (B={b} S={s} {hq} over {hkv}, D={d}, window {window})",
                  call_old, call_new, "flash_attention", iters=10)
        bound = max(ops_s, byts / HBM_BYTES_PER_S) * 1e3
        print(f"K3 {key}: SDPA {dt} {sdpa:.6f} ms, bound {bound:.6f} ms "
              f"({'operations' if ops_s > byts / HBM_BYTES_PER_S else 'bytes'})")
        del q, k, v, old_out
        torch.cuda.empty_cache()


# Text edits of K3's bf16 instance at D = 256 for ``k3-split``: each drops
# one part of a tile's work (the sums are wrong; only the time is read).
# "tree" is this tree's wgmma instance, "old" an earlier tree's mma.sync one.
K3_SPLIT_EDITS = {
    "tree": {
        "no_order": [("  if (grp == 1) wg::bar_sync(kOrderBar, kWgThreads);\n", ""),
                     ("  if (grp == 0) wg::bar_arrive(kOrderBar, kWgThreads);\n", "")],
        "no_qk": [("      wg::wgmma_m64n64k16_ss(s, k_step(dq, kk), k_step(dk, kk), kk > 0);\n", "")],
        "no_pv": [("      for (int kk = 0; kk < 4; ++kk) wg::wgmma_m64n256k16_rs(acc, pa[kk], "
                   "mn_step(dvs, kk), 1);\n", "")],
        "no_softmax_alu": [("x = ex2(fmaf(x, scale_log2, -m_new));", "x = fmaf(x, scale_log2, -m_new);"),
                           ("      acc[4 * j + 2 * rr] *= alpha;\n"
                            "      acc[4 * j + 2 * rr + 1] *= alpha;\n", "")],
    },
    "old": {
        "no_pv": [("        mma_bf16(oacc[2 * nd], pa, bf[0], bf[1]);\n"
                   "        mma_bf16(oacc[2 * nd + 1], pa, bf[2], bf[3]);\n", "")],
        "no_exp": [("exp2f(s - m_new)", "(s - m_new)")],
        "no_rescale": [("        oacc[j][2 * rr] *= alpha;\n"
                        "        oacc[j][2 * rr + 1] *= alpha;\n", "")],
    },
}
# The products alone: no softmax arithmetic, no ordering; then S alone and
# P.V alone.
_GEMM_ONLY = K3_SPLIT_EDITS["tree"]["no_softmax_alu"] + K3_SPLIT_EDITS["tree"]["no_order"]
K3_SPLIT_EDITS["tree"] |= {"gemm_only": _GEMM_ONLY,
                           "s_only": _GEMM_ONLY + K3_SPLIT_EDITS["tree"]["no_pv"],
                           "pv_only": _GEMM_ONLY + K3_SPLIT_EDITS["tree"]["no_qk"]}


def _build_edited(name: str, source: Path, edits) -> ctypes.CDLL:
    """``source`` with each (old, new) text edit made once (the first
    occurrence: the bf16 instance comes first), built beside its headers."""
    from repro_torch.kernels.nvcc import _ARCH, _COMMON, _nvcc

    text = source.read_text()
    for a, b in edits:
        if a not in text:
            raise SystemExit(f"{name}: edit not found in {source}: {a[:60]!r}")
        text = text.replace(a, b, 1)
    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / f"{name}.cu"
    cu.write_text(text)
    lib_path = OUT / f"lib{name}.so"
    log = subprocess.run([_nvcc(), *_ARCH, *_COMMON, "-I", str(source.parent), "-o",
                          str(lib_path), str(cu)], capture_output=True, text=True, timeout=600)
    if log.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{log.stdout}{log.stderr}")
    (OUT / f"{name}.log").write_text(log.stdout + log.stderr)
    lib = ctypes.CDLL(str(lib_path))
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def probe_k3_split(old: Path | None) -> None:
    """Where K3's bf16 instance at D = 256 spends its time: this tree's
    source (and an earlier tree's) as it is and with one part of a tile's
    work dropped (``K3_SPLIT_EDITS``), each build's ptxas registers, timed
    in turns (as it is, the variants, then back) under ``torch.profiler`` at
    gemma-7b's prefill (B = 8, S = 1024, 16 over 16) and recurrentgemma-9b's
    local layers (16 over 1)."""
    import torch

    from chip_smoke import device_ms

    tree = ROOT / "src" / "repro_torch" / "kernels" / "flash_attention" / "csrc"
    tree = tree / "flash_attention.cu"
    sources = {"tree": tree} | ({"old": old} if old is not None else {})
    gen = torch.Generator(device="cuda").manual_seed(35)
    shapes = {"gemma7b": (8, 1024, 16, 16), "recurrentgemma local": (8, 1024, 16, 1)}
    inputs = {key: _k3_inputs(gen, b, s, hq, hkv, 256, torch.bfloat16)
              for key, (b, s, hq, hkv) in shapes.items()}
    for label, source in sources.items():
        variants = {"as_is": []} | K3_SPLIT_EDITS[label]
        with ThreadPoolExecutor(len(variants)) as pool:  # one nvcc a variant, all at once
            libs = dict(zip(variants, pool.map(
                lambda kv: _build_edited(f"k3_split_{label}_{kv[0]}", source, kv[1]),
                variants.items())))
        fns = {}
        for name, lib in libs.items():
            fns[name] = _k3_entry(lib)
            key = "Li256ELb1E" if label == "old" else "wgmma_kernelILb1E"
            regs, _, spill = _ptxas(f"k3_split_{label}_{name}", key)
            print(f"{label} {name}: causal D = 256 bf16 kernel {regs} registers, {spill} B spilled")
        order = list(variants) + list(variants)[::-1]
        for key, (q, k, v) in inputs.items():
            out = torch.empty_like(q)
            times = {n: [] for n in variants}
            for name in order:
                times[name].append(device_ms(_k3_call(fns[name], q, k, v, out, True, 0, name),
                                             "flash_attention", iters=10))
            base = sum(times["as_is"]) / 2
            for name in variants:
                ms = sum(times[name]) / 2
                print(f"{label} {key} {name}: {ms:.6f} ms ({base - ms:+.6f} ms dropped)")


# ``wgmma-rate``: K3's products alone, on one or two warpgroups a block and
# one block an SM, in a loop of committed and waited groups: MODE 0 the S
# chain (16 m64n64k16 with both operands in shared memory on one
# accumulator), 1 the same on two accumulators (8 each), 2 the P.V chain (4
# m64n256k16, A in registers, B MN-major), 3 both in one group, 4 both
# with a wait between (S, then P.V).  Operands are bf16 1.0 in shared
# memory; clock64 around the loop gives cycles an iteration.
_WGMMA_RATE_SRC = r"""
#include <stdint.h>
#include "wgmma.cuh"
namespace wg = repro_wgmma;

__device__ __forceinline__ uint64_t kstep(uint64_t d, int kk) {
  return d + (uint64_t)(((kk >> 2) * 8192 + (kk & 3) * 32) >> 4);
}

template <int MODE>
__global__ void __launch_bounds__(256, 1) rate_kernel(float* out, long long* cycles, int iters) {
  extern __shared__ __align__(16) unsigned char raw[];
  unsigned char* base = raw + ((1024 - (repro_mma::smem_u32(raw) & 1023)) & 1023);
  const int wgi = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);
  uint32_t* fill = reinterpret_cast<uint32_t*>(base);
  for (int i = threadIdx.x; i < (int)(blockDim.x / 128) * 16384; i += blockDim.x) fill[i] = 0x3F803F80u;
  wg::fence_proxy_async();
  __syncthreads();
  const unsigned char* a = base + wgi * 65536;
  const unsigned char* b = a + 32768;
  const uint64_t da = wg::desc_k<64>(a, 0), db = wg::desc_k<64>(b, 0), dm = wg::desc_mn<64>(b, 0);
  float s[32], s2[32], acc[128];
  uint32_t pa[4][4];
  for (int i = 0; i < 32; ++i) s[i] = s2[i] = 0.0f;
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) pa[i][j] = 0x3F803F80u;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    wg::fence();
    if (MODE == 0 || MODE == 3 || MODE == 4) {
#pragma unroll
      for (int kk = 0; kk < 16; ++kk) wg::wgmma_m64n64k16_ss(s, kstep(da, kk), kstep(db, kk), 1);
    }
    if (MODE == 1) {
#pragma unroll
      for (int kk = 0; kk < 16; kk += 2) {
        wg::wgmma_m64n64k16_ss(s, kstep(da, kk), kstep(db, kk), 1);
        wg::wgmma_m64n64k16_ss(s2, kstep(da, kk + 1), kstep(db, kk + 1), 1);
      }
    }
    if (MODE == 4) {
      wg::commit();
      wg::wait<0>();
      wg::keep(s);
      wg::fence();
    }
    if (MODE >= 2) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wg::wgmma_m64n256k16_rs(acc, pa[kk], dm + kk * 128, 1);
    }
    wg::commit();
    wg::wait<0>();
    wg::keep(s);
    wg::keep(s2);
    wg::keep(acc);
  }
  const long long t1 = clock64();
  float sum = 0.0f;
  for (int i = 0; i < 32; ++i) sum += s[i] + s2[i];
  for (int i = 0; i < 128; ++i) sum += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

template <int MODE>
static int launch_rate(int wgs, float* out, long long* cyc, int iters, void* stream) {
  const int smem = 1024 + wgs * 65536;
  cudaError_t err = cudaFuncSetAttribute(rate_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  rate_kernel<MODE><<<132, wgs * 128, smem, (cudaStream_t)stream>>>(out, cyc, iters);
  return (int)cudaGetLastError();
}

extern "C" int wgmma_rate(int mode, int wgs, void* out, void* cyc, int iters, void* stream) {
  float* o = (float*)out;
  long long* c = (long long*)cyc;
  switch (mode) {
    case 0: return launch_rate<0>(wgs, o, c, iters, stream);
    case 1: return launch_rate<1>(wgs, o, c, iters, stream);
    case 2: return launch_rate<2>(wgs, o, c, iters, stream);
    case 3: return launch_rate<3>(wgs, o, c, iters, stream);
    case 4: return launch_rate<4>(wgs, o, c, iters, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
"""
# MACs an iteration of each mode, per warpgroup.
_WGMMA_RATE_MACS = {0: 16 * 64 * 64 * 16, 1: 16 * 64 * 64 * 16, 2: 4 * 64 * 256 * 16,
                    3: 16 * 64 * 64 * 16 + 4 * 64 * 256 * 16,
                    4: 16 * 64 * 64 * 16 + 4 * 64 * 256 * 16}


def probe_wgmma_rate(iters: int = 2000) -> None:
    """Cycles an iteration of K3's product chains (``_WGMMA_RATE_SRC``) on
    one and two warpgroups a block, and the MACs a cycle an SM they reach
    against the bf16 peak (2,048 an SM a cycle: 989 TFLOP/s at 1.83 GHz)."""
    import statistics

    import torch

    csrc = ROOT / "src" / "repro_torch" / "kernels" / "flash_attention" / "csrc"
    lib = ctypes.CDLL(str(_build("wgmma_rate", _WGMMA_RATE_SRC, ("-I", str(csrc)))))
    lib.wgmma_rate.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_int,
                                                                              ctypes.c_void_p]
    lib.wgmma_rate.restype = ctypes.c_int
    out = torch.empty(132 * 256, device="cuda")
    cyc = torch.empty(132, dtype=torch.int64, device="cuda")
    names = {0: "S chain", 1: "S on two accumulators", 2: "P.V chain", 3: "S and P.V, one group",
             4: "S, wait, P.V"}
    for mode in range(5):
        for wgs in (1, 2):
            err = lib.wgmma_rate(mode, wgs, out.data_ptr(), cyc.data_ptr(), iters,
                                 torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"wgmma_rate mode {mode}: CUDA error {err}")
            per_it = statistics.median(cyc.tolist()) / iters
            macs = wgs * _WGMMA_RATE_MACS[mode]
            print(f"wgmma-rate {names[mode]}, {wgs} warpgroup(s): {per_it:.1f} cycles an "
                  f"iteration, {macs / per_it:.1f} MAC a cycle an SM "
                  f"({macs / per_it / 2048:.3f} of the peak)")


# ``k3-phases``: this tree's bf16 D = 256 instance with clock64 stamps at
# its loop's phase boundaries, summed per warpgroup (thread 0 of each) over
# every block into a device array the library hands back.
K3_PHASE_EDITS = [
    ("    __syncthreads();  // both warpgroups are done with tile it - 1's stages\n",
     "    long long c0 = clock64();\n    __syncthreads();\n    long long c1 = clock64();\n"
     "    ph[0] += c1 - c0;\n"),
    ("    load(ks, bar_k, &tk, it + 2);\n",
     "    load(ks, bar_k, &tk, it + 2);\n    long long c2 = clock64();\n    ph[1] += c2 - c1;\n"),
    ("    issue_scores(sn, next, grp, dq, dk + ((it + 1) & 1) * (kWgTile >> 4));\n",
     "    issue_scores(sn, next, grp, dq, dk + ((it + 1) & 1) * (kWgTile >> 4));\n"
     "    long long c3 = clock64();\n    ph[2] += c3 - c2;\n"),
    ("      // O += P . V: p rounded", "      ph[3] += clock64() - c3;\n      // O += P . V: p rounded"),
    ("    wg::wait<0>();\n    wg::keep(acc);\n",
     "    long long c5 = clock64();\n    wg::wait<0>();\n    wg::keep(acc);\n"
     "    ph[4] += clock64() - c5;\n    ph[6] += 1;\n"),
    ("  for (int it = 0; it < n_tiles; ++it) {\n    const int k0 = k_start + it * kWgRows;\n",
     "  ph[7] += clock64() - c_entry;\n  const long long cl = clock64();\n"
     "  for (int it = 0; it < n_tiles; ++it) {\n    const int k0 = k_start + it * kWgRows;\n"),
    ("  uint64_t* bar_v = bar_q + 3;  // two stages\n",
     "  uint64_t* bar_v = bar_q + 3;  // two stages\n"
     "  long long ph[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};\n  const long long c_entry = clock64();\n"),
    ("  if (!has_rows) return;\n  unsigned char* ot = qs + grp * kWgTile;\n",
     "  ph[5] = clock64() - cl;\n  const long long c_epi = clock64();\n"
     "  if (!has_rows) return;\n  unsigned char* ot = qs + grp * kWgTile;\n"),
    ('    asm volatile("cp.async.bulk.wait_group.read 0;\\n" ::: "memory");  '
     '// before the tile is freed\n  }\n}\n',
     '    asm volatile("cp.async.bulk.wait_group.read 0;\\n" ::: "memory");\n  }\n'
     "  ph[8] = clock64() - c_epi;\n  if (wt == 0)\n    for (int i = 0; i < 9; ++i) "
     "atomicAdd(&g_phase[grp][i], (unsigned long long)ph[i]);\n}\n"),
    ("__device__ __forceinline__ unsigned char* align_tiles(",
     "__device__ unsigned long long g_phase[2][9];\n\n"
     "__device__ __forceinline__ unsigned char* align_tiles("),
    ('extern "C" {\n', 'extern "C" {\n\nint k3_phases(void* dst, int reset) {\n  if (reset) {\n'
     '    static const unsigned long long zero[2][9] = {};\n'
     '    return (int)cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));\n  }\n'
     '  return (int)cudaMemcpyFromSymbol(dst, g_phase, sizeof(g_phase));\n}\n'),
]
K3_PHASES = ("barrier", "loads issued", "K landed, S issued (in turn)", "softmax",
             "P.V issued", "the walk", "iterations", "set-up, Q landed and the first S",
             "the output written")


def probe_k3_phases() -> None:
    """Cycles of each phase of the bf16 D = 256 instance's loop, per
    warpgroup and iteration, at gemma-7b's prefill shape (B = 8, S = 1024,
    16 over 16) and recurrentgemma-9b's local shape (16 over 1)."""
    import torch

    tree = ROOT / "src" / "repro_torch" / "kernels" / "flash_attention" / "csrc"
    lib = _build_edited("k3_phases", tree / "flash_attention.cu", K3_PHASE_EDITS)
    fn = _k3_entry(lib)
    lib.k3_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.k3_phases.restype = ctypes.c_int
    regs, _, spill = _ptxas("k3_phases", "wgmma_kernelILb1E")
    print(f"k3-phases build: {regs} registers, {spill} B spilled")
    gen = torch.Generator(device="cuda").manual_seed(36)
    for key, (b, s, hq, hkv) in {"gemma7b": (8, 1024, 16, 16),
                                 "recurrentgemma local": (8, 1024, 16, 1)}.items():
        q, k, v = _k3_inputs(gen, b, s, hq, hkv, 256, torch.bfloat16)
        out = torch.empty_like(q)
        call = _k3_call(fn, q, k, v, out, True, 0, "k3-phases")
        call()
        torch.cuda.synchronize()
        host = torch.zeros(18, dtype=torch.int64)
        lib.k3_phases(None, 1)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        torch.cuda.synchronize()
        if lib.k3_phases(host.data_ptr(), 0):
            raise RuntimeError("k3_phases: copy failed")
        for grp in range(2):
            row = host[9 * grp:9 * grp + 9].tolist()
            its = max(row[6], 1)
            print(f"k3-phases {key} warpgroup {grp} ({its} iterations, {start.elapsed_time(end):.4f} "
                  "ms with stamps): " + ", ".join(f"{name} {row[i] / its:.0f}"
                                                  for i, name in enumerate(K3_PHASES)
                                                  if i != 6)
                  + " cycles an iteration")


# K4's shapes of ``k4 --old``: (B, Hkv, G, S, D, dtype), phase 7's lengths.
# bf16 at D = 256 is the fitted instance; the others must stay
# bit-identical to an earlier tree's where it did not change them.
K4_AB_SHAPES = {"gemma7b": (8, 16, 1, 1040, 256, "bfloat16"),
                "gemma3 G=2": (8, 4, 2, 1040, 256, "bfloat16"),
                "G=4": (8, 4, 4, 1040, 256, "bfloat16"),
                "recurrentgemma local": (8, 1, 16, 1040, 256, "bfloat16"),
                "tinyllama": (8, 4, 8, 1040, 64, "bfloat16"),
                "llama4": (8, 8, 5, 1040, 128, "bfloat16"),
                "tinyllama f32": (8, 4, 8, 1040, 64, "float32"),
                "gemma7b f32": (8, 16, 1, 1040, 256, "float32")}
K4_LENGTHS = [1040, 129, 700, 1024, 300, 1039, 512, 890]


def probe_k4_old(old: Path) -> None:
    """K4: an earlier tree's ``decode_attention.cu`` (with its own split
    rule: every block an SM of its own) against this tree's, in one
    process, at ``K4_AB_SHAPES``, each checked against the plain version,
    with max |old - new|, timed old, new, new, old under ``torch.profiler``
    beside SDPA and the bound; then the fitted instances at every split
    count 1-8, and with one valid position per row."""
    import torch
    import torch.nn.functional as F

    from chip_smoke import _decode_bound, _decode_plain, device_ms, timed_ms
    from repro_torch.kernels.decode_attention import ops as decode_ops

    lib = _build_in_place("k4_old", old)
    old_fn = lib.decode_attention_fwd
    old_fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                                     ctypes.c_int, ctypes.c_void_p]
    old_fn.restype = ctypes.c_int
    new_lib, _ = decode_ops._library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(34)
    lengths = torch.tensor(K4_LENGTHS, dtype=torch.int32, device="cuda")
    for key, (b, hkv, g, s, d, dt) in K4_AB_SHAPES.items():
        dtype = getattr(torch, dt)
        q = torch.randn((b, 1, hkv * g, d), generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        old_out = torch.empty_like(q)
        old_splits = max(1, min(8, sms // (b * hkv), -(-s // 32)))

        def launch(fn, out, splits, lens=lengths, what="old"):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(),
                     int(dtype == torch.bfloat16), b, s, hkv, g, d, 0, d ** -0.5, splits,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{what} decode_attention_fwd: CUDA error {err}")

        def call_old():
            launch(old_fn, old_out, old_splits)

        def call_new():
            return decode_ops.decode_attention(q, k, v, lengths)

        call_old()
        new_out = call_new()
        plain = _decode_plain(q, k, v, lengths, 0)
        for label, out in (("old", old_out), ("new", new_out)):
            print(f"{key} {label} - plain: max |d| {(out - plain).float().abs().max().item():.6g}")
        inst = decode_ops.instance(dtype, d, g)
        splits = decode_ops.split_count(b, hkv, s, sms, inst)
        print(f"{key}: instance {inst}, splits {splits} (old {old_splits}); max |old - new| "
              f"{(old_out - new_out).float().abs().max().item():.6g}")
        mask = (torch.arange(s, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        sdpa = timed_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=g > 1), iters=50)
        _ab_turns(f"K4 {dt} {key} (B={b} Hkv={hkv} G={g} D={d} S={s})", call_old, call_new,
                  "decode_", iters=50)
        bound = ("bound {:.6f} ms ({})".format(*_decode_bound(lengths, hkv, g, d))
                 if dt == "bfloat16" else "")
        print(f"K4 {key}: SDPA {dt} {sdpa:.6f} ms {bound}")
        if inst["fitted"]:
            out = torch.empty_like(q)
            by_split = []
            for n in range(1, 9):
                by_split.append(device_ms(lambda n=n: launch(new_lib.decode_attention_fwd, out,
                                                             n, what="new"),
                                          "decode_", iters=50))
            print(f"K4 {key} fitted instance by splits 1-8: "
                  + ", ".join(f"{n + 1}: {ms:.6f}" for n, ms in enumerate(by_split)))
            ones = torch.ones_like(lengths)
            one = device_ms(lambda: decode_ops.decode_attention(q, k, v, ones), "decode_",
                            iters=50)
            print(f"K4 {key}: one valid position per row {one:.6f} ms (the fixed cost)")
        del q, k, v, old_out, new_out, plain
        torch.cuda.empty_cache()


# K3b's float32 shapes of ``k3b --old``, phase 16 (a)'s: (B, S, Hq, Hkv, D).
K3B_AB_SHAPES = {"tinyllama": (8, 1024, 32, 4, 64), "d256": (1, 1024, 16, 16, 256)}


def probe_k3b_old(old: Path) -> None:
    """K3b's float32 instance: an earlier tree's ``flash_attention_bwd.cu``
    against this tree's, in one process, at ``K3B_AB_SHAPES``, timed old,
    new, new, old under ``torch.profiler``, beside SDPA's float32
    backward; then the card test's two G = 16 cases at head dim 256 against
    the plain version in float32, float64 and with the new arithmetic."""
    import torch
    import torch.nn.functional as F

    from chip_smoke import K3B_STAGES, _flash_bwd_plain, f32_ops_s, timed_ms
    from repro_torch.kernels.flash_attention import ops as flash_ops

    old_fn = _build_in_place("k3b_old", old).flash_attention_bwd
    old_fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_float,
                                                                      ctypes.c_void_p]
    old_fn.restype = ctypes.c_int

    def old_grads(q, k, v, out, do, lse, window):
        b, s, hq, d = q.shape
        grads = [torch.empty_like(t) for t in (q, k, v)]
        drow = torch.empty((b, hq, s), dtype=torch.float32, device="cuda")
        err = old_fn(*(t.data_ptr() for t in (q, k, v, out, do, lse, drow, *grads)), None, 0,
                     b, s, s, hq, k.shape[2], d, window, 1, d ** -0.5,
                     torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old flash_attention_bwd: CUDA error {err}")
        return grads

    gen = torch.Generator(device="cuda").manual_seed(34)
    for key, (b, s, hq, hkv, d) in K3B_AB_SHAPES.items():
        q, do = (torch.randn((b, s, hq, d), generator=gen, device="cuda") for _ in range(2))
        k, v = (torch.randn((b, s, hkv, d), generator=gen, device="cuda") for _ in range(2))
        out, lse = flash_ops.flash_attention(q, k, v, return_lse=True)

        def call_new():
            return flash_ops.flash_attention_bwd(q, k, v, out, do, lse)

        refs = _flash_bwd_plain(q, k, v, out, do, lse, 0)
        _accuracy_report(key, [("old - plain", old_grads(q, k, v, out, do, lse, 0), refs),
                               ("new - plain", call_new(), refs)], 2e-5)
        del refs
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

        sdpa_bwd = (timed_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot), iters=10)
                    - timed_ms(sdpa, iters=10))
        flops = 10 * b * hq * (s * (s + 1) // 2) * d
        _ab_turns(f"K3b f32 {key} (B={b} S={s} {hq} over {hkv}, D={d})",
                  lambda: old_grads(q, k, v, out, do, lse, 0), call_new,
                  "flash_attention_bwd", iters=5, parts=K3B_STAGES)
        print(f"K3b f32 {key}: SDPA f32 backward {sdpa_bwd:.6f} ms, bound "
              f"{f32_ops_s(flops) * 1e3:.6f} ms (3xTF32; one fp32 pass "
              f"{flops / 67e12 * 1e3:.6f})")
        del q, k, v, do, out, lse, qt, kt, vt, dot
        torch.cuda.empty_cache()

    # tests/test_torch_cuda.py's head-dim-256 cases at G = 16 (its seeds).
    for b, s, hq, hkv, window in ((8, 1024, 16, 1, 2048), (2, 3000, 16, 1, 0)):
        gen = torch.Generator(device="cuda").manual_seed(s * 5 + hq)
        q, do = (torch.randn((b, s, hq, 256), generator=gen, device="cuda") for _ in range(2))
        k, v = (torch.randn((b, s, hkv, 256), generator=gen, device="cuda") for _ in range(2))
        out, lse = flash_ops.flash_attention(q, k, v, window=window, return_lse=True)
        olds = old_grads(q, k, v, out, do, lse, window)
        news = flash_ops.flash_attention_bwd(q, k, v, out, do, lse, window=window)
        wide = [t.double() for t in (q, k, v, out, do, lse)]
        refs = {"plain f32": _flash_bwd_plain(q, k, v, out, do, lse, window),
                "plain f64": _flash_bwd_plain(*wide, window),
                "plain tf32x3": _flash_bwd_plain(q, k, v, out, do, lse, window,
                                                 rounding="tf32x3")}
        pairs = [(f"{label} - {side}", grads, r) for label, grads in (("old", olds),
                                                                       ("new", news))
                 for side, r in refs.items()]
        pairs.append(("plain f32 - plain f64", refs["plain f32"], refs["plain f64"]))
        _accuracy_report(f"card test B={b} S={s} {hq} over {hkv}, window {window}, float32",
                         pairs, 2e-5)
        del q, k, v, do, out, lse, olds, news, refs, wide
        torch.cuda.empty_cache()


def probe_rglru_bwd_old(old: Path) -> None:
    """``rglru_scan_bwd``: an earlier tree's ``rglru_scan_bwd.cu`` (the first
    design: a summary and a scan kernel, the carries every 64 steps) against
    this tree's, in one process, at phase 16 (a)'s training shape and a lone
    prompt's, timed old, new, new, old under ``torch.profiler``, each
    checked against the plain reverse loop and both run twice
    bit-identically."""
    import torch

    from chip_smoke import RGLRU_BWD_TOL, _close, device_ms
    from repro_torch.kernels.rglru_scan import ops as rglru_ops
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_bwd_ref

    old_lib = _build_in_place("rglru_bwd_old", old)
    old_fn = old_lib.rglru_scan_bwd
    old_fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    old_fn.restype = ctypes.c_int
    old_lib.rglru_scan_bwd_chunk.restype = ctypes.c_int
    old_chunk = old_lib.rglru_scan_bwd_chunk()
    gen = torch.Generator(device="cuda").manual_seed(29)
    atol, rtol = RGLRU_BWD_TOL["bfloat16"]
    for key, (b, s, width) in {"train": (8, 1024, 4096), "lone_prompt": (1, 1024, 4096)}.items():
        u, gp, dy = (torch.randn((b, s, width), generator=gen, device="cuda").to(torch.bfloat16)
                     for _ in range(3))
        vecs = [(torch.randn(width, generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
                for _ in range(5)]
        _, _, carries = rglru_ops.rglru_scan_saving(u, gp, *vecs)
        # The first design reads the h entering each of its chunks: every
        # (chunk / carry)-th of this tree's carries.
        old_carries = carries[:, ::old_chunk // rglru_ops.carry_len()].contiguous()
        nc = -(-s // old_chunk)
        scratch = torch.empty(((5 * nc + 2 * (nc - 1)) * b * width,), device="cuda")
        ins = [t.contiguous() for t in (u, gp, dy, *vecs)]
        outs = [torch.empty_like(u), torch.empty_like(gp)] + [torch.empty_like(x) for x in vecs]
        in_ptrs = (ctypes.c_void_p * len(ins))(*(t.data_ptr() for t in ins))
        out_ptrs = (ctypes.c_void_p * len(outs))(*(t.data_ptr() for t in outs))

        def call_old():
            err = old_fn(in_ptrs, old_carries.data_ptr(), None, out_ptrs, None,
                         scratch.data_ptr(), b, s, width, 1,
                         torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"old rglru_scan_bwd: CUDA error {err}")

        def call_new():
            return rglru_ops.rglru_scan_bwd(u, gp, *vecs, carries, dy)

        call_old()
        got = call_new()
        again = call_new()
        if not all(x is None or torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"rglru_scan_bwd {key}: two calls differ")
        want = rglru_scan_bwd_ref(u, gp, *vecs, dy)
        names = ("du", "dgpre", "da_w", "da_b", "dx_w", "dx_b", "dlam")
        for name, o, n, r in zip(names, outs, got, want):
            _close(o.float(), r.float(), atol, f"old rglru_scan_bwd {key} {name}", rtol)
            _close(n.float(), r.float(), atol, f"new rglru_scan_bwd {key} {name}", rtol)
        del got, again, want
        times = []
        for label, fn in (("old", call_old), ("new", call_new), ("new", call_new),
                          ("old", call_old)):
            ms = device_ms(fn, "rglru_bwd", iters=10)
            times.append(ms)
            print(f"rglru_scan_bwd {key} (B={b} S={s} L={width} bf16) {label}: {ms:.6f} ms")
        old_ms, new_ms = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
        print(f"rglru_scan_bwd {key}: old {old_ms:.6f} ms, new {new_ms:.6f} ms, "
              f"{old_ms / new_ms:.3f} times faster")


def probe_k3b_train(steps: int, lr: float) -> None:
    import dataclasses
    import gc

    import torch

    from chip_smoke import NEW_TRAIN, TRAIN_BATCH, TRAIN_SEQ, _flash_bwd_plain
    from repro_torch.configs import ARCHS
    from repro_torch.data import LMDataConfig, LMDataset
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import LM
    from repro_torch.training import OptimizerConfig, init_opt_state
    from repro_torch.training.optimizer import tree_leaves

    cfg = dataclasses.replace(ARCHS["gemma-7b"], num_layers=NEW_TRAIN["gemma-7b"][0])
    # phase 16 (c)'s optimizer settings, at ``lr``
    opt = OptimizerConfig(learning_rate=lr, warmup_steps=3, total_steps=1000)
    lm = LM(cfg)
    data = LMDataset(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, seed=0))
    kernel_bwd = flash_ops.flash_attention_bwd

    def plain_bwd(q, k, v, o, do, lse, *, window=0, scale=None):
        return _flash_bwd_plain(q, k, v, o, do, lse, window)

    routes = {"kernel": kernel_bwd, "plain": plain_bwd}

    def batch_at(step):
        return {k: torch.as_tensor(v, device="cuda") for k, v in data.batch_at(step).items()}

    print(f"gemma-7b, {cfg.num_layers} layers at full width, bf16, B={TRAIN_BATCH} "
          f"S={TRAIN_SEQ}, lr {lr:g}, {steps} steps a route")
    try:
        grads = {}
        for name, fn in routes.items():
            flash_ops.flash_attention_bwd = fn
            params = lm.init(0, device="cuda")
            params.requires_grad_(True)
            loss, _ = lm.loss(params, batch_at(0))
            loss.backward()
            grads[name] = [g.float() for g in tree_leaves(params.grad_tree())]
            print(f"{name}: first loss {loss.item():.6f}")
            del params, loss
            gc.collect()
            torch.cuda.empty_cache()
        for i, (g, r) in enumerate(zip(grads["kernel"], grads["plain"])):
            scale = float(r.abs().max())
            diff = float((g - r).abs().max())
            print(f"gradient leaf {i} {tuple(g.shape)}: max |kernel - plain| {diff:.4g}, "
                  f"max |plain| {scale:.4g}, relative {diff / max(scale, 1e-30):.4g}")
        del grads
        losses = {}
        for name, fn in routes.items():
            flash_ops.flash_attention_bwd = fn
            params = lm.init(0, device="cuda")
            state = init_opt_state(params.to_tree(), opt)
            step_fn = make_train_step(lm, opt)
            losses[name] = []
            for step in range(steps):
                params, state, metrics = step_fn(params, state, batch_at(step))
                losses[name].append(float(metrics["loss"]))
            del params, state, step_fn
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        flash_ops.flash_attention_bwd = kernel_bwd
    for name, xs in losses.items():
        tail = sum(xs[-5:]) / len(xs[-5:])
        print(f"{name}: losses {' '.join(f'{x:.4f}' for x in xs)}; first {xs[0]:.4f}, "
              f"last 5 mean {tail:.4f} ({'falls' if tail < xs[0] else 'rises'})")


# Text edits of mma.cuh's fp32 split and product (each anchor must be present).
_SPLIT = """  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));"""
_CVT = """  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));"""
_PASSES = """  mma_tf32(c, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(c, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(c, a.hi, b.hi[0], b.hi[1]);"""
_DKDV_COLS = "constexpr int f32_dkdv_cols() { return D <= 32 ? 64 : D <= 128 ? 32 : 16; }"
_DQ_COLS = "constexpr int f32_dq_cols() { return D <= 32 ? 64 : D <= 128 ? 32 : 16; }"
_KEYS = "constexpr int f32_keys() { return D <= 64 ? 64 : 32; }"
_NG = "constexpr int NG = NW >= 16 ? 8 : NW < 4 ? NW : 4;"
_M, _B, _F = "mma.cuh", "flash_attention_bwd.cu", "flash_attention.cu"
# (file, old text, new text) edits of each variant.
F32_VARIANTS = {
    "as_is": [],
    "cvt": [(_M, _SPLIT, _CVT)],
    "no_split": [(_M, _SPLIT, "  hi = __float_as_uint(x);\n  lo = 0u;")],
    "one_pass": [(_M, _PASSES, "  mma_tf32(c, a.hi, b.hi[0], b.hi[1]);")],
}
# Tile sizes and accumulator groups of the same arithmetic (``--tiles``).
F32_TILE_VARIANTS = {
    "as_is": [],
    "dkdv_q64": [(_B, _DKDV_COLS, _DKDV_COLS.replace("D <= 32 ? 64", "D <= 64 ? 64"))],
    "dkdv_q16": [(_B, _DKDV_COLS, _DKDV_COLS.replace("D <= 128 ? 32", "D <= 32 ? 32"))],
    "dq_k64": [(_B, _DQ_COLS, _DQ_COLS.replace("D <= 32 ? 64", "D <= 64 ? 64"))],
    "fwd_k32": [(_F, _KEYS, _KEYS.replace("D <= 64 ? 64", "D <= 32 ? 64"))],
    "groups4": [(_M, _NG, "constexpr int NG = NW < 4 ? NW : 4;")],
    "groups8": [(_M, _NG, "constexpr int NG = NW < 8 ? NW : 8;")],
}


def _build_f32_variant(name: str, edits) -> dict:
    """K3's and K3b's sources built from a copy of their directory with
    ``edits`` (file name, old text, new text) made: {source: library}."""
    from repro_torch.kernels.nvcc import _ARCH, _COMMON, SOURCES, _nvcc

    csrc = SOURCES["flash_attention"].path.parent
    tree = OUT / "f32" / name
    tree.mkdir(parents=True, exist_ok=True)
    for path in csrc.iterdir():
        text = path.read_text()
        for file, old, new in edits:
            if file != path.name:
                continue
            if old not in text:
                raise SystemExit(f"f32-split {name}: anchor not found in {file}: {old}")
            text = text.replace(old, new)
        (tree / path.name).write_text(text)
    procs = {}
    for src in ("flash_attention", "flash_attention_bwd"):
        lib = tree / f"lib{src}.so"
        procs[src] = (lib, subprocess.Popen(
            [_nvcc(), *_ARCH, *_COMMON, "-o", str(lib), str(tree / f"{src}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for src, (lib, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"f32-split {name} {src}: nvcc failed\n{out}")
        (tree / f"{src}.log").write_text(out)
        for block in re.split(r"Compiling entry function", out)[1:]:
            m = re.search(r"(\w+_f32_kernelILi\d+E\w{0,4})", block.split("\n", 1)[0])
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores", block)
            if m and regs:
                key = m.group(1).split("flash_attention_", 1)[-1]
                print(f"{name} {key}: {regs.group(1)} registers, "
                      f"{spill.group(1) if spill else 0} bytes spill stores")
        libs[src] = lib
    return libs


def probe_f32_split(tiles: bool = False) -> None:
    """K3's and K3b's float32 instances with their split and product
    edited (``F32_VARIANTS``), or with ``tiles`` their tile sizes and
    accumulator groups (``F32_TILE_VARIANTS``), timed in turns under
    ``torch.profiler``."""
    import torch

    from chip_smoke import K3B_STAGES, _flash_bwd_plain, _flash_plain, device_ms
    from repro_torch.kernels.flash_attention import ops as flash_ops

    variants = F32_TILE_VARIANTS if tiles else F32_VARIANTS
    calls = {}
    for name, edits in variants.items():
        libs = _build_f32_variant(name, edits)
        fwd = ctypes.CDLL(str(libs["flash_attention"])).flash_attention_fwd
        fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_float,
                                                                     ctypes.c_void_p]
        bwd = ctypes.CDLL(str(libs["flash_attention_bwd"])).flash_attention_bwd
        bwd.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_float,
                                                                      ctypes.c_void_p]
        calls[name] = (fwd, bwd)
    gen = torch.Generator(device="cuda").manual_seed(35)
    order = list(variants) + list(variants)[::-1]
    for what, (b, s, hq, hkv, d) in (("K3", (8, 1024, 32, 4, 64)), ("K3", (8, 1024, 16, 16, 256)),
                                     ("K3b", (8, 1024, 32, 4, 64)),
                                     ("K3b", (1, 1024, 16, 16, 256))):
        q, do = (torch.randn((b, s, hq, d), generator=gen, device="cuda") for _ in range(2))
        k, v = (torch.randn((b, s, hkv, d), generator=gen, device="cuda") for _ in range(2))
        o, lse = flash_ops.flash_attention(q, k, v, return_lse=True)
        out = torch.empty_like(q)
        grads = [torch.empty_like(t) for t in (q, k, v)]
        drow = torch.empty_like(lse)
        ref = (_flash_plain(q, k, v, 0),) if what == "K3" else _flash_bwd_plain(q, k, v, o, do,
                                                                               lse, 0)

        def run(name):
            fwd, bwd = calls[name]
            stream = torch.cuda.current_stream().cuda_stream
            if what == "K3":
                err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, 0, b, s,
                          s, hq, hkv, d, 1, 0, d ** -0.5, stream)
            else:
                err = bwd(*(t.data_ptr() for t in (q, k, v, o, do, lse, drow, *grads)), None, 0,
                          b, s, s, hq, hkv, d, 0, 1, d ** -0.5, stream)
            if err:
                raise RuntimeError(f"f32-split {name}: CUDA error {err}")

        for name in variants:
            run(name)
            torch.cuda.synchronize()
            got = (out,) if what == "K3" else grads
            print(f"{what} B={b} S={s} {hq} over {hkv} D={d} {name}: max |d| from the plain "
                  "version " + ", ".join(f"{(g - r).abs().max().item():.3g}"
                                         for g, r in zip(got, ref)))
        del ref
        for name in order:
            if what == "K3":
                ms = device_ms(lambda: run(name), "flash_attention_f32", iters=10)
                print(f"{what} B={b} S={s} {hq} over {hkv} D={d} {name}: {ms:.6f} ms")
            else:
                ms, stage_ms = device_ms(lambda: run(name), "flash_attention_bwd", iters=5,
                                         parts=K3B_STAGES)
                print(f"{what} B={b} S={s} {hq} over {hkv} D={d} {name}: {ms:.6f} ms ("
                      + ", ".join(f"{k.removeprefix('flash_attention_bwd_')} {x:.6f}"
                                  for k, x in stage_ms.items()) + ")")
        del q, k, v, do, o, lse, out, grads, drow
        torch.cuda.empty_cache()


# Text edits of ahead.cuh's warp step (each anchor must be present).
_EQ2 = "eq2_utility<double>(static_cast<int>(v.pen), v.acc, v.dl, comp)"
_MEAN = "const double mean = v.valid ? (v.size == 1.0 ? sum : sum / v.size) : -INFINITY;"
_REDUCE = "warp_first(ranked ? ranked_value(u, lane) : -INFINITY, ranked ? lane : wm, span)"
_DEPTH = "constexpr int kDepth = 8;"
_WARP_AHEAD = "constexpr int kWarpAhead = 2;"
_BLOCK_AHEAD = "constexpr int kBlockAhead = 8;"
_H, _CU = "ahead.cuh", "selection_scan.cu"
SCAN_VARIANTS = {
    "as_is": [],
    "no_eq2": [(_H, _EQ2, "(v.acc - comp)")],
    "no_mean_div": [(_H, _MEAN, "const double mean = v.valid ? sum : -INFINITY;")],
    "no_reduce": [(_H, _REDUCE, "__shfl_sync(kFullWarp, u > 0.5 ? 1 : 0, 0)")],
    "skeleton": [(_H, _EQ2, "(v.acc - comp)"), (_H, _MEAN, "const double mean = sum;"),
                 (_H, _REDUCE, "0")],
    "warp_ahead1": [(_CU, _WARP_AHEAD, "constexpr int kWarpAhead = 1;")],
    "warp_ahead4": [(_CU, _WARP_AHEAD, "constexpr int kWarpAhead = 4;")],
    "block_ahead2": [(_CU, _BLOCK_AHEAD, "constexpr int kBlockAhead = 2;")],
    "block_ahead16": [(_CU, _BLOCK_AHEAD, "constexpr int kBlockAhead = 16;")],
    "depth4": [(_H, _DEPTH, "constexpr int kDepth = 4;")],
    "depth16": [(_H, _DEPTH, "constexpr int kDepth = 16;")],
}


def _build_scan_variant(name: str, edits) -> Path:
    """selection_scan.cu built from a copy of its tree with ``edits``
    (file name, old text, new text) made."""
    from repro_torch.kernels.nvcc import _ARCH, _COMMON, SOURCES, _nvcc

    src = SOURCES["selection_scan"]
    kernels = src.path.parents[2]
    tree = OUT / name / "kernels"
    for rel in ("selection_scan/csrc", "utility/csrc"):
        (tree / rel).mkdir(parents=True, exist_ok=True)
    for path in (src.path, *src.headers):
        text = path.read_text()
        for file, old, new in edits:
            if file != path.name:
                continue
            if old not in text:
                raise SystemExit(f"scan-step {name}: anchor not found in {file}: {old}")
            text = text.replace(old, new)
        (tree / path.relative_to(kernels)).write_text(text)
    lib = OUT / f"lib{name}.so"
    log = subprocess.run([_nvcc(), *_ARCH, *_COMMON, *src.flags, "-o", str(lib),
                          str(tree / src.path.relative_to(kernels))],
                         capture_output=True, text=True, timeout=600)
    if log.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{log.stdout}{log.stderr}")
    (OUT / f"{name}.log").write_text(log.stdout + log.stderr)
    return lib


def probe_scan_step() -> None:
    import statistics

    import torch

    from benchmarks.torch_scan_ab import tables
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.selection_scan import ops as scan_ops

    libs = {}
    for name, edits in SCAN_VARIANTS.items():
        lib = ctypes.CDLL(str(_build_scan_variant(f"scan_{name}", edits)))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
        regs, _, spill = _ptxas(f"scan_{name}", "selection_scan_warp_kernel")
        print(f"{name}: warp kernel {regs} registers, {spill} B spilled")
    cases = {}
    for shape in ("per-request", "per-request on four workers", "grouped", "four workers"):
        for res_mode in ("slot1", "lru"):
            seed, t = tables(shape, res_mode)
            cases[f"{shape}, {res_mode}"] = (
                *seed, res_mode, t["acc"], t["mask"], t["deadlines"], t["bsize"], t["lat"],
                t["step_app"], t["swap"], t["gid"], t["valid"], t["pen"], t["pref"])

    def median_ms(call, iters=10):
        for _ in range(2):
            call()
        times = []
        for _ in range(iters):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    built = nvcc._LIBS.get("selection_scan")
    try:
        for name in list(SCAN_VARIANTS) + list(SCAN_VARIANTS)[::-1]:
            nvcc._LIBS["selection_scan"] = libs[name]
            for case, args in cases.items():
                if name == "as_is":
                    host = [x.cpu() if torch.is_tensor(x) else x for x in args]
                    if not torch.equal(scan_ops.selection_scan(*args).cpu(),
                                       scan_ops.selection_scan(*host)):
                        raise SystemExit(f"scan-step: as_is differs from the plain version "
                                         f"({case})")
                ms = median_ms(lambda: scan_ops.selection_scan(*args))
                steps = args[5].shape[0]
                print(f"{name}, {case}: {ms:.6f} ms, {ms * 1e6 / steps:.1f} ns a step")
    finally:
        if built is None:
            nvcc._LIBS.pop("selection_scan", None)
        else:
            nvcc._LIBS["selection_scan"] = built


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
    sub.add_parser("rglru").add_argument("--old", type=Path, default=None)
    sub.add_parser("scan-step")
    t = sub.add_parser("k3b-train")
    t.add_argument("--steps", type=int, default=24)
    t.add_argument("--lr", type=float, default=1e-3)
    sub.add_parser("k3").add_argument("--old", type=Path, required=True)
    sub.add_parser("k3-split").add_argument("--old", type=Path, default=None)
    sub.add_parser("k4").add_argument("--old", type=Path, required=True)
    sub.add_parser("wgmma-rate")
    sub.add_parser("k3-phases")
    sub.add_parser("f32-split").add_argument("--tiles", action="store_true")
    sub.add_parser("k3b").add_argument("--old", type=Path, required=True)
    sub.add_parser("rglru-bwd").add_argument("--old", type=Path, required=True)
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
    elif args.what == "rglru":
        probe_rglru(args.old)
    elif args.what == "scan-step":
        probe_scan_step()
    elif args.what == "k3b-train":
        probe_k3b_train(args.steps, args.lr)
    elif args.what == "k3":
        probe_k3_old(args.old)
    elif args.what == "k3-split":
        probe_k3_split(args.old)
    elif args.what == "k4":
        probe_k4_old(args.old)
    elif args.what == "wgmma-rate":
        probe_wgmma_rate()
    elif args.what == "k3-phases":
        probe_k3_phases()
    elif args.what == "f32-split":
        probe_f32_split(args.tiles)
    elif args.what == "k3b":
        probe_k3b_old(args.old)
    elif args.what == "rglru-bwd":
        probe_rglru_bwd_old(args.old)
    else:
        probe_chain()
    return 0


if __name__ == "__main__":
    sys.exit(main())
