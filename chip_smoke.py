#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # the full check, on one card

Builds the port's twelve CUDA kernel sources from the checkout, holds
each kernel against its plain PyTorch version at its path's shapes and
times both, then drives the paths of the port on the card:

* scheduling (phases 3-5): a SneakPeek ``Simulation`` over a stream of
  4096-request windows against k-NN training sets of 100,000 points per
  application (K2, K1), plus one window of each other policy;
* serving (phases 6-9): K3 (its bf16 instance and its f32 one, 3xTF32,
  both on the tensor cores), K4 and K5 (five kernels per call, each stage
  also held against its plain stage and timed) against their plain
  versions, K3 and K4 also at head dim 256 (gemma-7b's shapes, gemma3-4b's windowed
  prefill), K4 also at the serving backend's bucketed capacity, float32
  models at tinyllama's, mamba2's, gemma-7b's and gemma3-4b's widths
  (one period of 5 sliding-window layers and 1 global, a wrapped ring)
  on the card, eager and replayed from a CUDA graph, against the host,
  then ``EdgeServer`` serving 64 requests with SneakPeek over a k-NN
  model on three families at full width, mamba2-130m (24 SSD layers,
  prefill scan through K5), tinyllama-1.1b (22 attention layers) and
  gemma-7b (28 attention layers of 16 heads of 256; prefill through K3,
  decode through K4), all bf16, decode replayed from CUDA graphs, and
  the same traffic on each family alone, with the peak device memory of
  each run;
* the pool (phase 10): ``EdgeServer(workers=[Worker(0), Worker(1,
  speed=2.0)])`` placing each window by Eq. 15 (one K1 launch per
  placement step) on mamba2-130m and tinyllama-1.1b, its lanes run from
  two threads on one card, then as two spawned processes (mamba2-130m
  alone), then through ``CompiledBackend``, with exact launch counts per
  lane and every window's placement held against the host path;
* the closed loop (phase 11): ``EdgeServer(preempt=True, faults=...,
  health=True)``, synchronous and overlapped: on ``SimulatedBackend``
  lanes the card's decisions, records, counters and fired faults equal
  the host's; on mamba2-130m and tinyllama-1.1b at full width, with
  speculative scheduling beside the lanes, every request recorded once,
  every failure an injected one, exact launch counts;
* the compiled window pipeline (phase 12): ``selection_scan`` bit-identical
  to its plain version on phase 5's window (per-request, grouped and
  four-worker scans, single-slot and LRU residency), then
  ``Simulation(pipeline=True)`` over phase 5's trace for the five
  policies, every window's schedule equal to ``pipeline=False``'s with
  one scan launch per window that does not take the brute-force branch,
  ``prebatch=4`` deciding as ``prebatch=0``, and ``EdgeServer(pipeline=
  True)`` on phase 11 (a)'s lanes recording what phase 11 (a) recorded;
* the chunked window (phase 13): ``spec_scan`` (speculative chunked
  selection) bit-identical to its plain version and to the sequential
  scan on phase 12 (a)'s inputs for chunks 1, 4, 16 and 64, with its
  rounds and conflicts, then ``Simulation(pipeline=True, chunk=16)``
  deciding as ``chunk=0`` with one launch per window, and
  ``EdgeServer(pipeline=True, chunk=16)`` recording what phase 11 (a)
  recorded;
* the recurrent and sparse mixers (phase 14): one period of
  recurrentgemma-9b and one layer of llama4-scout in float32, card
  against host, graphed decode against eager, expert routing equal;
  ``rglru_scan`` against its plain version at recurrentgemma-9b's width;
  ``EdgeServer`` serving recurrentgemma-9b (38 layers) and llama4-scout
  (full width, 6 layers) in bf16 from CUDA graphs with exact launch
  counts; llama4-maverick's one period (128 experts) alone, graphed
  decode against eager;
* sharded window scheduling (phase 15): the ``shard_round`` kernel's two
  entry points (``score_block``, ``chain``) bit-identical to their plain
  versions on the calls the sharded selectors make for phase 5's first
  window, the sharded selectors at 2, 4 and 8 shard blocks on the card (chunks 0
  and 16, single-slot and LRU carries) deciding as the unsharded scans,
  then ``Simulation(shard=4, chunk=16)`` over phase 5's trace and
  ``shard=True`` on this card (one shard: the unsharded launches);
* training (phase 16): the backward kernels, K3b (flash attention; bf16
  on the tensor cores) and K5b (the SSD chunk scan; 3xTF32 products),
  against their plain versions at tinyllama's, llama4's and mamba2's
  training shapes, timed beside SDPA's backward and beside their first
  designs' times, two calls bit-identical; K3b at head dim 256 (gemma-7b's,
  recurrentgemma-9b's local and gemma3-4b's shapes, and float32) and the
  RG-LRU scan's backward (``rglru_scan_bwd``) the same, the latter also
  through its autograd function card against host;
  one training step of float32 models at full width, card against host
  (loss, every gradient, the weights after 3 AdamW steps): 2 layers of
  mamba2, tinyllama and gemma-7b, and recurrentgemma-9b's one period;
  then mamba2-130m (24 layers) through ``Trainer`` with checkpoints and
  an injected fault restored from one, and tinyllama-1.1b (22 layers),
  recurrentgemma-9b (one period) and gemma-7b (3 layers) through
  ``make_train_step``, all bf16 at B=8 S=1024 on LMDataset's markov
  stream, with falling loss and exact K3/K3b/K5/K5b/RG-LRU launches;
* the launchers (phase 17): ``python -m repro_torch.launch.train`` at
  mamba2-130m's full width on a one-rank NCCL mesh (``--mesh
  data,model=1,1``: ZeRO-3 through DTensors) beside the unsharded
  ``Trainer`` on the same seed and steps (tokens/s, peak memory, losses
  within 1e-4); ``python -m repro_torch.launch.serve`` (K1-K4 launched,
  K5 by the train launcher); ``EdgeServer`` over ``CostModelBackend``
  lanes on two workers, card against host;
* the dry run (phase 18): in a child process, ``launch.dryrun`` on
  mamba2-130m ``train_4k``, tinyllama-1.1b ``decode_32k`` and gemma-7b
  ``prefill_32k`` over a fake (16, 16) world, each record ``ok``; then its
  predictions for a one-rank mesh against the real steps on this card:
  mamba2-130m's ZeRO-3 train step (B=8 S=1024) and tinyllama-1.1b's
  sharded bf16 prefill (B=8 S=1024), the predicted peaks within 10 % of
  ``torch.cuda.max_memory_allocated``, the fake launches equal to the
  real ones, the roofline's ``t_max`` beside the measured seconds;
* the examples (phase 19): the six counterparts of the JAX package's
  examples (``examples/torch_*.py``) imported by path and run through
  their ``main`` in this process, ``torch_edge_serving`` (mamba2-130m,
  tinyllama-1.1b and gemma-7b) and ``torch_executor_backends`` at
  published widths, each with its seconds, launches and peak device
  memory; the other four also with ``--device cpu``, their decision lines
  (``examples/_example_lines.py``) equal to the card's.

Every check raises on failure.  The last three lines of standard output
are the card's name and power limit, the kernel table and
``{"ok": true, "device": {...}}``.

Imports nothing of the JAX package.  Exits non-zero, printing no
result, when CUDA is absent or the port's sources are not beside it.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12  # CUDA cores, no tensor cores (no TF32)
FP64_FLOP_PER_S = 34e12  # CUDA cores
BF16_FLOP_PER_S = 989e12  # tensor cores, dense
TF32_FLOP_PER_S = 495e12  # tensor cores, dense


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--train-n", type=int, default=100_000,
                   help="k-NN training set size per application (before the 20%% holdout)")
    p.add_argument("--per-app", type=int, default=1365,
                   help="requests per application per window (3 apps)")
    p.add_argument("--windows", type=int, default=8, help="windows of the main-path trace")
    p.add_argument("--k", type=int, default=5, help="k-NN neighbours")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--serve-requests", type=int, default=64,
                   help="requests of the serving main path (phase 9)")
    return p.parse_args(argv)


def timed_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call between CUDA events recorded around ``iters``
    back-to-back calls of ``fn``: the device's time when the device is the
    bottleneck, the host's launch rate when the host is."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# Small kernels launched inside the profiler's window before the timed
# calls: the first window of a measurement has lost its first ~15-20
# kernel records, with or without 50 ms of host time before the calls.
PROFILE_PRIMING_LAUNCHES = 64


def device_ms(fn, kernel: str, iters: int, parts=(), attempts: int = 8):
    """Mean device time per call, in ms, of the kernels whose name contains
    ``kernel`` (``torch.profiler``), over ``iters`` calls of ``fn``: the
    kernel's own time, whatever the host spends around each launch.  With
    ``parts``, also ``{part: ms}`` for the kernels whose name contains each
    part (a kernel's stages).  ``PROFILE_PRIMING_LAUNCHES`` elementwise
    kernels (which no ``kernel`` name matches) open each window.  A window
    in which the profiler still recorded fewer kernels than were launched
    is measured again, up to ``attempts`` times, and never averaged; if
    none records them all, the check fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    priming = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_PRIMING_LAUNCHES):
                priming.add_(1)
            torch.cuda.synchronize()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA and kernel in e.name]
        counts = {part: sum(part in e.name for e in events) for part in parts}
        if len(events) >= iters and all(n == iters for n in counts.values()):
            break
        names = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                names[e.name[:50]] = names.get(e.name[:50], 0) + 1
        print(f"    profiler saw {len(events)} {kernel} kernels ({counts}) for {iters} calls "
              f"(attempt {attempt} of {attempts}); its CUDA events: {names}")
    require(len(events) >= iters, f"profiler saw {len(events)} {kernel} kernels for {iters} calls")
    total = sum(e.time_range.elapsed_us() for e in events) / 1e3 / iters
    if not parts:
        return total
    by_part = {}
    for part in parts:
        spans = [e.time_range.elapsed_us() for e in events if part in e.name]
        require(len(spans) == iters, f"profiler saw {len(spans)} {part} kernels for {iters} calls")
        by_part[part] = sum(spans) / 1e3 / iters
    return total, by_part


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _sass(lib_path) -> str | None:
    """``cuobjdump -sass`` of a built library, or None where the toolkit has
    no ``cuobjdump``."""
    import shutil

    from torch.utils.cpp_extension import CUDA_HOME

    tool = shutil.which("cuobjdump")
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "cuobjdump").is_file():
        tool = str(Path(CUDA_HOME) / "bin" / "cuobjdump")
    if tool is None:
        return None
    return subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=120, check=True).stdout


def hmma_count(lib_path, op: str = "HMMA") -> int | None:
    """Tensor-core instructions (``op``: HMMA for mma.sync, HGMMA for
    wgmma) in a built library's SASS, or None without ``cuobjdump``."""
    sass = _sass(lib_path)
    if sass is None:
        return None
    return sum(f" {op}." in line or f" {op} " in line for line in sass.splitlines())


def sass_counts(lib_path, keys, op: str = "HMMA", kind: str = "TF32") -> dict | None:
    """{key: the ``op`` instructions of type ``kind`` (``HMMA.1688.F32.TF32``
    for mma.sync.m16n8k8 on TF32) in the SASS of the kernel whose mangled
    name contains key}, the kernel's own and not its library's; None
    without ``cuobjdump``."""
    sass = _sass(lib_path)
    if sass is None:
        return None
    out = {}
    for body in sass.split("Function : ")[1:]:
        head = body.split("\n", 1)[0]
        for key in keys:
            if key in head:
                out[key] = sum(f" {op}." in line and kind in line for line in body.splitlines())
    return out


def ptxas_registers(name: str, keys) -> dict:
    """{key: ptxas's "Used N registers, ..." line and its spill line} for the
    kernels of source ``name`` whose mangled name contains each key (from
    the build log)."""
    from repro_torch.kernels import nvcc

    text = (nvcc.BUILD_DIR / f"{name}.log").read_text()
    out = {}
    for block in text.split("Compiling entry function")[1:]:
        head = block.split("\n", 1)[0]
        for key in keys:
            if key in head:
                lines = block.splitlines()
                regs = next((ln for ln in lines if "registers" in ln), "")
                spill = next((ln for ln in lines if "spill" in ln), "")
                out[key] = f"{regs.split(':', 1)[-1].strip()}; {spill.strip()}"
    return out


# The head-dim-256 instances of K3 (causal and not: Lb1 and Lb0), K4 and
# K3b (mangled-name keys): ptxas's registers and spills are printed in
# phase 2.
D256_INSTANCES = {
    "flash_attention": ("flash_attention_bf16_kernelILi256ELb1E",
                        "flash_attention_bf16_kernelILi256ELb0E",
                        "flash_attention_f32_kernelILi256ELb1E",
                        "flash_attention_f32_kernelILi256ELb0E"),
    "decode_attention": ("decode_attention_kernelI13__nv_bfloat16Li256E",
                         "decode_attention_kernelIfLi256E"),
    "flash_attention_bwd": ("flash_attention_bwd_dkdv_wgmma_kernel",
                            "flash_attention_bwd_dq_wgmma_kernel",
                            "flash_attention_bwd_dkdv_f32_kernelILi256EE",
                            "flash_attention_bwd_dq_f32_kernelILi256EE"),
}

# K3's and K3b's float32 instances (mangled-name keys), every product as
# three TF32 products on mma.sync: phase 2 counts the TF32 HMMA in each
# one's own SASS (more than none), prints ptxas's registers and spills and
# fails on a spill at D <= 128.
F32_INSTANCES = {
    "flash_attention": tuple(f"flash_attention_f32_kernelILi{d}ELb{c}E"
                             for d in (16, 32, 64, 128, 256) for c in (1, 0)),
    "flash_attention_bwd": tuple(f"flash_attention_bwd_{part}_f32_kernelILi{d}EE"
                                 for d in (16, 32, 64, 128, 256) for part in ("dkdv", "dq")),
}


# K3b's bf16 instances (mangled-name keys): ptxas's registers are printed
# in phase 2, and a spill fails it.  Head dims 16-128 on mma.sync, 256 on
# warpgroup products (wgmma).
K3B_BF16_INSTANCES = tuple(f"flash_attention_bwd_{part}_bf16_kernelILi{d}E"
                           for d in (16, 32, 64, 128) for part in ("dkdv", "dq")) + (
    "flash_attention_bwd_dkdv_wgmma_kernel", "flash_attention_bwd_dq_wgmma_kernel")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    require(bool(out), "nvidia-smi printed no card")
    return out[0]


def shifted_window(specs, per_app, window, window_s, seed, make_requests):
    """One window of requests whose arrivals fall in window ``window``."""
    reqs = make_requests(specs, per_app=per_app, window_s=window_s,
                         deadline_std_s=0.05, seed=seed + window,
                         start_rid=window * per_app * len(specs))
    off = window * window_s
    for r in reqs:
        r.arrival_s += off
        r.deadline_s += off
    return reqs


def check_knn(sneaks, windows_feats, k, rows):
    """K2 against its plain version at the main path's shapes."""
    import torch

    from repro_torch.kernels.knn import ops as knn_ops
    from repro_torch.kernels.knn.ref import knn_topk_ref

    tol = 1e-3  # fp32 distances, as tests/test_kernels.py holds knn_pallas
    timing = None
    max_err = 0.0
    for app, sp in sneaks.items():
        q = torch.as_tensor(windows_feats[app], device="cuda").contiguous()
        dk, lk = knn_ops.knn_topk(q, sp._x, sp._xn, sp._y, k)
        dr, lr = knn_topk_ref(q, sp._x, sp._xn, sp._y, k + 1)
        torch.cuda.synchronize()
        err = float((dk - dr[:, :k]).abs().max())
        require(err <= tol, f"{app}: k-NN distances differ by {err} > {tol}")
        max_err = max(max_err, err)
        # Rows whose k-th and (k+1)-th neighbours are closer than the
        # tolerance may legitimately pick either; all others must agree.
        clear = (dr[:, k] - dr[:, k - 1]) > tol
        vk = knn_ops.votes_from_labels(lk, sp.num_classes)
        vr = knn_ops.votes_from_labels(lr[:, :k], sp.num_classes)
        bad = int(((vk != vr).any(dim=1) & clear).sum())
        require(bad == 0, f"{app}: {bad} clear rows vote differently")
        excluded = int((~clear).sum())
        print(f"  k-NN {app}: Q={q.shape[0]} N={sp._x.shape[0]} D={q.shape[1]} "
              f"max|dd|={err:.3g} excluded near-tie rows={excluded}")
        if timing is None or q.shape[1] > timing[0].shape[1]:
            timing = (q, sp)

    # Duplicated training points: every neighbour has an exact twin with
    # another label, so identical labels pin the (distance, index) rule.
    q, sp = timing
    g = torch.Generator(device="cuda").manual_seed(7)
    base = sp._x[:2000]
    x = torch.cat([base, base]).contiguous()
    xn = (x * x).sum(dim=1)
    y0 = sp._y[:2000]
    y = torch.cat([y0, (y0 + 1) % sp.num_classes]).contiguous()
    qd = (base[torch.randint(0, 2000, (rows,), device="cuda", generator=g)]
          + 0.05 * torch.randn((rows, base.shape[1]), device="cuda", generator=g))
    dk, lk = knn_ops.knn_topk(qd.contiguous(), x, xn, y, k)
    dr, lr = knn_topk_ref(qd.contiguous(), x, xn, y, k)
    torch.cuda.synchronize()
    require(torch.equal(lk, lr), "duplicated training points: labels differ from plain")
    print(f"  k-NN ties: {rows} queries over {x.shape[0]} points with exact twins: "
          f"labels identical")

    # Twins on both sides of every slice boundary of the main path's plan,
    # hit by queries on both sides of every query-tile boundary: the
    # nearest two of each such query tie exactly, and their labels differ.
    n, d = sp._x.shape
    qn = q.shape[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = knn_ops.knn_plan(qn, n, d, k, sms)
    require(plan.slices > 1 and qn > plan.query_tile, f"the plan {plan} has no boundary")
    x2, y2 = sp._x.clone(), sp._y.clone()
    bounds = [lo for lo, _ in plan.slice_bounds(n)[1:]]
    for b in bounds:
        x2[b - 1] = x2[b]
        y2[b - 1] = (y2[b] + 1) % sp.num_classes
    xn2 = (x2 * x2).sum(dim=1)
    rows_at = [j * plan.query_tile + o for j in range(1, -(-qn // plan.query_tile))
               for o in (-1, 0) if j * plan.query_tile + o < qn]
    qt = q.clone()
    for i, row in enumerate(rows_at):
        qt[row] = x2[bounds[i % len(bounds)]] + 0.01 * torch.randn(
            d, device="cuda", generator=g)
    dk, lk = knn_ops.knn_topk(qt, x2, xn2, y2, k)
    dr, lr = knn_topk_ref(qt, x2, xn2, y2, k)
    torch.cuda.synchronize()
    at = torch.as_tensor(rows_at, device="cuda")
    require(bool((dr[at, 0] == dr[at, 1]).all()), "slice-boundary twins: no exact tie")
    require(torch.equal(lk[at, :2], lr[at, :2]),
            "slice-boundary twins: labels differ from plain")
    require(float((dk - dr).abs().max()) <= tol, "slice-boundary twins: distances differ")
    print(f"  k-NN ties across boundaries: twins at {len(bounds)} slice boundaries, "
          f"queried from {len(rows_at)} rows beside query-tile boundaries: labels identical")
    print(f"  k-NN plan at Q={qn} N={n} D={d} k={k}: query tile {plan.query_tile}, "
          f"{plan.stages} stages, {plan.slices} slices of {plan.slice_rows} rows, "
          f"{plan.smem_bytes} B shared, grid {plan.grid(qn)}; ptxas "
          + "; ".join(f"{key}: {regs}" for key, regs in
                      ptxas_registers("knn", ("knn_search_kernelILi8E",
                                              "knn_search_kernelILi4E")).items()))

    # Times at the largest application's window shapes.
    call = lambda: knn_ops.knn_topk(q, sp._x, sp._xn, sp._y, k)  # noqa: E731
    ms = device_ms(call, "knn_", iters=20)  # the search and, if sliced, the merge
    call_ms = timed_ms(call, iters=20)
    plain_ms = timed_ms(lambda: knn_topk_ref(q, sp._x, sp._xn, sp._y, k), iters=3, warmup=1)
    xf = sp._x

    def library():
        return torch.topk(torch.cdist(q, xf), k, dim=1, largest=False)

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        library_ms = timed_ms(library, iters=5, warmup=1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    bytes_moved = 4 * (qn * d + n * d + 2 * n + 2 * qn * k)
    flops = 2 * qn * n * d + 2 * qn * n
    bound = max(bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S) * 1e3
    return {
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound,
        "bound_by": "operations" if flops / FP32_FLOP_PER_S > bytes_moved / HBM_BYTES_PER_S
        else "bytes",
        "max_abs_err": max_err, "shape": f"Q={qn} N={n} D={d} k={k}", "call_ms": call_ms,
    }


def check_utility(group_shape, seed):
    """K1 against its plain version: f64 bit-identical, f32 within 1e-6."""
    import numpy as np
    import torch

    from repro_torch.kernels.utility import ops as util_ops
    from repro_torch.kernels.utility.ref import utility_scores_ref, utility_tile_ref

    rng = np.random.default_rng(seed)
    # R on both sides of the row counts where the plan changes for M = 6 in
    # f64: the cluster reaches its 7 filling blocks, and the tile no longer
    # fits the summing block (a ring of two slots per filling block).
    split = (util_ops.MAX_CLUSTER - 1) * (util_ops.THREADS // 6)

    def ring(r):
        p = util_ops.utility_plan(r, 6, 8, True)
        return p.slots < -(-len(p.chunks(r)) // (p.cluster - 1))

    chunked = next(r for r in range(split, 1 << 16) if ring(r))
    shapes = [(4096, 6, "tile", True), (group_shape[0], group_shape[1], "row", True),
              (1365, 1, "tile", True), (7, 3, "row", True), (4096, 1, "tile", False),
              (1250, 256, "tile", True)]
    shapes += [(r, 6, "tile", True) for r in (split - 1, split, split + 1, chunked - 1,
                                              chunked, chunked + 1)]
    timing = {}
    for penalty in ("step", "linear", "sigmoid", "none"):
        for r, m, comp_kind, with_means in shapes:
            acc = rng.uniform(0, 1, (r, m))
            dl = rng.uniform(-0.05, 0.3, r)
            comp = rng.uniform(0.0, 0.6, (r, m) if comp_kind == "tile" else (m,))
            for dtype, exact in ((torch.float64, True), (torch.float32, False)):
                a, d, e = (torch.as_tensor(v, dtype=dtype, device="cuda")
                           for v in (acc, dl, comp))
                uk, mk = util_ops.utility_scores(a, d, e, penalty, with_means=with_means)
                if with_means:
                    ur, mr = utility_scores_ref(a, d, e, penalty)
                else:
                    ur, mr = utility_tile_ref(a, d, e, penalty), None
                    require(mk is None, "utility without means returned means")
                    mk = mr = torch.zeros(1, dtype=dtype, device="cuda")
                torch.cuda.synchronize()
                if exact:
                    require(torch.equal(uk, ur) and torch.equal(mk, mr),
                            f"f64 utility {penalty} {(r, m)}: not bit-identical")
                else:
                    err = max(float((uk - ur).abs().max()), float((mk - mr).abs().max()))
                    require(err <= 1e-6, f"f32 utility {penalty} {(r, m)}: {err} > 1e-6")
    print("  Eq. 2 utility: f64 bit-identical and f32 within 1e-6, 4 penalties x "
          f"{[(r, m) if w else (r, m, 'no sums') for r, m, _, w in shapes]}")
    # Times at the main path's largest group tile, sigmoid, f64; then the
    # same tile's fill alone, and evaluate's per-entry shape (fill only).
    r, m = group_shape
    plan = util_ops.utility_plan(r, m, 8, True)
    print(f"  utility plan at R={r} M={m} f64: blocks of {m}x{plan.block_rows} threads, "
          f"cluster of {plan.cluster}, chunks of {plan.chunk_rows} rows, "
          f"{plan.smem_bytes} B shared")
    a = torch.as_tensor(rng.uniform(0, 1, (r, m)), device="cuda")
    d = torch.as_tensor(rng.uniform(0.01, 0.3, r), device="cuda")
    e = torch.as_tensor(rng.uniform(0.0, 0.6, m), device="cuda")
    call = lambda: util_ops.utility_scores(a, d, e, "sigmoid")  # noqa: E731
    timing["ms"] = device_ms(call, "utility_", iters=200)
    timing["call_ms"] = timed_ms(call, iters=200)  # wrapper, launch and means
    timing["plain_ms"] = timed_ms(lambda: utility_scores_ref(a, d, e, "sigmoid"), iters=5)
    timing["fill_ms"] = device_ms(
        lambda: util_ops.utility_scores(a, d, e, "sigmoid", with_means=False), "utility_",
        iters=200)
    a1 = torch.as_tensor(rng.uniform(0, 1, (4096, 1)), device="cuda")
    d1 = torch.as_tensor(rng.uniform(0.01, 0.3, 4096), device="cuda")
    e1 = torch.as_tensor(rng.uniform(0.0, 0.6, (4096, 1)), device="cuda")
    timing["entry_ms"] = device_ms(
        lambda: util_ops.utility_scores(a1, d1, e1, "sigmoid", with_means=False), "utility_",
        iters=200)
    bytes_moved = 8 * (2 * r * m + r + m + m)
    flops = 12 * r * m + r * m  # penalty chain per pair, plus the column sums
    timing["bound_ms"] = max(bytes_moved / HBM_BYTES_PER_S, flops / FP64_FLOP_PER_S) * 1e3
    timing["bound_by"] = ("operations" if flops / FP64_FLOP_PER_S > bytes_moved / HBM_BYTES_PER_S
                          else "bytes")
    uk, mk = util_ops.utility_scores(a, d, e, "sigmoid")
    ur, mr = utility_scores_ref(a, d, e, "sigmoid")
    timing["max_abs_err"] = max(float((uk - ur).abs().max()), float((mk - mr).abs().max()))
    timing["library_ms"] = None  # no single PyTorch call computes Eq. 2
    timing["shape"] = f"R={r} M={m}"
    timing["placement"] = _placement_timing(rng)
    return timing


# A placement step's tile in phase 10: B rows (the largest group of a
# 64-request window on the pool is 7 rows) by W*M = 2 workers x 2 models.
PLACEMENT_SHAPE = (8, 4)


def _placement_timing(rng):
    """K1 timed at ``PLACEMENT_SHAPE`` with its sums, sigmoid, f64."""
    import torch

    from repro_torch.kernels.utility import ops as util_ops
    from repro_torch.kernels.utility.ref import utility_scores_ref

    b, cols = PLACEMENT_SHAPE
    a = torch.as_tensor(rng.uniform(0.3, 1.0, (b, cols)), device="cuda")
    d = torch.as_tensor(rng.uniform(0.01, 1.0, b), device="cuda")
    e = torch.as_tensor(rng.uniform(0.0, 1.2, cols), device="cuda")
    call = lambda: util_ops.utility_scores(a, d, e, "sigmoid")  # noqa: E731
    bytes_moved = 8 * (b * cols + b + cols + b * cols + cols)
    flops = 12 * b * cols + b * cols
    uk, mk = call()
    ur, mr = utility_scores_ref(a, d, e, "sigmoid")
    t = {"shape": f"R={b} M={cols} (B x W*M)", "library_ms": None,
         "max_abs_err": max(float((uk - ur).abs().max()), float((mk - mr).abs().max())),
         "ms": device_ms(call, "utility_", iters=200), "call_ms": timed_ms(call, iters=200),
         "plain_ms": timed_ms(lambda: utility_scores_ref(a, d, e, "sigmoid"), iters=20),
         "bound_ms": max(bytes_moved / HBM_BYTES_PER_S, flops / FP64_FLOP_PER_S) * 1e3,
         "bound_by": ("operations" if flops / FP64_FLOP_PER_S > bytes_moved / HBM_BYTES_PER_S
                      else "bytes")}
    return t


def small_reference_check(seed):
    """The port on the card against its plain version on the host, one
    small window of every policy: identical decisions, utilities to 1e-12."""
    import numpy as np

    from repro_torch.core.evaluation import evaluate
    from repro_torch.core.scheduler import POLICY_NAMES, make_policy, schedule_window
    from repro_torch.data.applications import APP_SPECS, build_benchmark_suite, make_requests

    def sig(s):
        return [(e.request.rid, e.model, e.order, e.batch_id, e.est_start_s, e.est_latency_s)
                for e in s.sorted_entries()]

    suites = {dev: build_benchmark_suite(seed=seed, train_n=3000, device=dev)
              for dev in ("cuda", "cpu")}
    for name in POLICY_NAMES:
        out = {}
        for dev, (apps, sneaks) in suites.items():
            reqs = make_requests(list(APP_SPECS.values()), per_app=60,
                                 deadline_std_s=0.05, seed=seed + 3)
            sched, eff = schedule_window(make_policy(name), reqs, apps, 0.1,
                                         sneakpeeks=sneaks, short_circuit=True, device=dev)
            out[dev] = (sig(sched), evaluate(sched, eff, 0.1, device=dev).utilities)
        require(out["cuda"][0] == out["cpu"][0], f"{name}: card and host decisions differ")
        err = float(np.abs(out["cuda"][1] - out["cpu"][1]).max())
        require(err <= 1e-12, f"{name}: card and host utilities differ by {err}")
    print("  small window, 5 policies: card decisions == host plain-path decisions")


# Tolerances of tests/test_kernels.py:15, by input type.
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _close(out, ref, tol: float, what: str, rtol: float | None = None) -> float:
    """max |out - ref|, after requiring finite values and |out - ref| <=
    tol + rtol * |ref| everywhere (assert_allclose with atol = tol and
    rtol, which defaults to tol)."""
    import torch

    rtol = tol if rtol is None else rtol
    require(bool(torch.isfinite(out.float()).all()), f"{what}: non-finite values")
    diff = (out.float() - ref.float()).abs()
    bad = int((diff > tol + rtol * ref.float().abs()).sum())
    require(bad == 0, f"{what}: {bad} values outside atol {tol}, rtol {rtol}")
    return float(diff.max())


def _flash_plain(q, k, v, window, causal=True):
    """K3's plain version, model layout in and out."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qk = q.reshape(b, sq, hkv, hq // hkv, d).permute(0, 2, 3, 1, 4)
    out = flash_attention_ref(qk, k.transpose(1, 2), v.transpose(1, 2), causal=causal,
                              window=window)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)


def _decode_plain(q, k, v, lengths, window):
    """K4's plain version, model layout in and out."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    b, _, hq, d = q.shape
    hkv = k.shape[2]
    out = decode_attention_ref(q.reshape(b, hkv, hq // hkv, d), k.transpose(1, 2),
                               v.transpose(1, 2), lengths, window=window)
    return out.reshape(b, 1, hq, d)


def f32_ops_s(flops: float) -> float:
    """The least seconds for ``flops`` of products at fp32's accuracy: three
    TF32 passes of an error-compensated split (3xTF32) at the TF32
    tensor-core peak, or one fp32 pass at the CUDA cores', whichever is
    shorter (K3's, K3b's and K5b's float32 products)."""
    return min(3 * flops / TF32_FLOP_PER_S, flops / FP32_FLOP_PER_S)


def _flash_timing(q, k, v, window, flops, library, causal=True):
    """K3 at one shape, checked against its plain version: device time,
    wrapper time, plain time, ``library`` time, and the bound from
    ``flops`` (bf16 at the tensor cores' peak; f32 at fp32's accuracy,
    ``f32_ops_s``) and the bytes of q, k, v and o."""
    import torch

    from repro_torch.kernels.flash_attention import ops as flash_ops

    b, s, hq, d = q.shape
    hkv = k.shape[2]
    name = str(q.dtype).split(".")[1]
    ops_s = flops / BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else f32_ops_s(flops)
    out = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
    err = _close(out, _flash_plain(q, k, v, window, causal), ATTN_TOL[name],
                 f"K3 at {tuple(q.shape)} {name} causal={causal} window {window}")
    torch.testing.assert_close(library().transpose(1, 2).float(), out.float(),
                               atol=ATTN_TOL["bfloat16"], rtol=ATTN_TOL["bfloat16"])
    call = lambda: flash_ops.flash_attention(q, k, v, causal=causal, window=window)  # noqa: E731
    bytes_moved = q.element_size() * (2 * b * s * hq * d + 2 * b * s * hkv * d)
    return {
        "ms": device_ms(call, "flash_attention", iters=10),
        "call_ms": timed_ms(call, iters=10),
        "plain_ms": timed_ms(lambda: _flash_plain(q, k, v, window, causal), iters=3, warmup=1),
        "library_ms": timed_ms(library, iters=10),
        "bound_ms": max(ops_s, bytes_moved / HBM_BYTES_PER_S) * 1e3,
        "bound_by": "operations" if ops_s > bytes_moved / HBM_BYTES_PER_S else "bytes",
        "max_abs_err": err,
        "shape": f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} {name} "
                 + ("causal" if causal else "non-causal")
                 + (f" window={window}" if window else ""),
    }


# K3's first float32 design's times (fp32 on the CUDA cores) at phase 6's
# f32 shapes, printed in brackets beside this run's
# (benchmarks/torch_kernel_probe.py k3 --old, NVIDIA H100 80GB HBM3,
# 700.00 W; PERF.md).
K3_F32_FIRST_MS = {"f32": 1.574682, "f32_non_causal": 2.791151, "f32_d256": 3.791087}


def check_flash(seed):
    """K3 against its plain version: the sweep of tests/test_kernels.py:22
    in f32 (3xTF32) and bf16, at its head dims and again at 256, causal
    and not (with one Sq < Skv case each); then the serving shapes in bf16,
    timed beside SDPA: tinyllama's, gemma-7b's and gemma3-4b's windowed
    prefill; then tinyllama's shape not causal in bf16, and in f32 causal
    and not, and gemma-7b's in f32, each beside SDPA in f32."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as flash_ops

    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    sweep = [(2, 128, 4, 4, 32, 0), (1, 256, 8, 2, 64, 0), (2, 96, 4, 1, 32, 0),
             (1, 256, 4, 2, 32, 64), (1, 130, 2, 2, 16, 32)]
    for causal in (True, False):
        # Sq < Skv: 37 queries at the last positions of 200 keys.
        cases = [(b, s, s, hq, hkv, d, w) for b, s, hq, hkv, d, w in sweep]
        cases.append((2, 37, 200, 4, 2, 32, 0 if causal else 64))
        for dims in ("its head dims", "head dim 256"):
            for dtype in (torch.float32, torch.bfloat16):
                name = str(dtype).split(".")[1]
                errs = []
                for b, sq, skv, hq, hkv, d, window in cases:
                    d = d if dims == "its head dims" else 256
                    q = torch.randn((b, sq, hq, d), generator=gen, device="cuda").to(dtype)
                    k, v = (torch.randn((b, skv, hkv, d), generator=gen,
                                        device="cuda").to(dtype) for _ in range(2))
                    out = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
                    errs.append(_close(out, _flash_plain(q, k, v, window, causal),
                                       ATTN_TOL[name], f"K3 {name} causal={causal} "
                                       f"{(b, sq, skv, hq, hkv, d, window)}"))
                print(f"  K3 {name} {'causal' if causal else 'non-causal'}: the 5 "
                      f"configurations of tests/test_kernels.py and Sq < Skv at {dims} within "
                      f"{ATTN_TOL[name]}, max |d| {max(errs):.3g}")

    def inputs(b, s, hq, hkv, d):
        q = torch.randn((b, s, hq, d), generator=gen, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        return q, k, v

    def causal(q, k, v, is_causal=True):
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=is_causal,
                                                      enable_gqa=True)

    b, s, hq, hkv, d = 8, 1024, 32, 4, 64
    q, k, v = inputs(b, s, hq, hkv, d)
    # causal: half of QK^T and PV over the square
    t = _flash_timing(q, k, v, 0, 2 * b * hq * s * s * d, causal(q, k, v))
    print(f"  K3 serving shape {t['shape']}: max |d| {t['max_abs_err']:.3g} (tolerance 2e-2); "
          "SDPA agrees within 2e-2")
    # Not causal: the full square, 4 B Hq S^2 D; SDPA with is_causal=False.
    t["non_causal"] = _flash_timing(q, k, v, 0, 4 * b * hq * s * s * d,
                                    causal(q, k, v, False), causal=False)
    # The f32 instance (3xTF32 on the tensor cores) at the same shape, causal
    # and not, beside SDPA in f32.
    qf, kf, vf = (x.float() for x in (q, k, v))
    t["f32"] = _flash_timing(qf, kf, vf, 0, 2 * b * hq * s * s * d, causal(qf, kf, vf))
    t["f32_non_causal"] = _flash_timing(qf, kf, vf, 0, 4 * b * hq * s * s * d,
                                        causal(qf, kf, vf, False), causal=False)
    for key in ("non_causal", "f32", "f32_non_causal"):
        first = K3_F32_FIRST_MS.get(key)
        print(f"  K3 serving shape {t[key]['shape']}: max |d| {t[key]['max_abs_err']:.3g} "
              f"(tolerance {ATTN_TOL['bfloat16' if key == 'non_causal' else 'float32']}); "
              f"SDPA agrees within 2e-2; {t[key]['ms']:.6f} ms"
              + (f" [first design: {first}]" if first else ""))
    del q, k, v, qf, kf, vf

    b, s, hq, hkv, d = 8, 1024, 16, 16, 256  # gemma-7b's prefill, MHA
    q, k, v = inputs(b, s, hq, hkv, d)
    t["at_d256"] = _flash_timing(q, k, v, 0, 2 * b * hq * s * s * d, causal(q, k, v))
    print(f"  K3 gemma-7b shape {t['at_d256']['shape']}: max |d| "
          f"{t['at_d256']['max_abs_err']:.3g} (tolerance 2e-2); SDPA agrees within 2e-2")
    qf, kf, vf = (x.float() for x in (q, k, v))
    del q, k, v
    t["f32_d256"] = _flash_timing(qf, kf, vf, 0, 2 * b * hq * s * s * d, causal(qf, kf, vf))
    first = K3_F32_FIRST_MS.get("f32_d256")
    print(f"  K3 gemma-7b shape {t['f32_d256']['shape']}: max |d| "
          f"{t['f32_d256']['max_abs_err']:.3g} (tolerance 2e-5); SDPA agrees within 2e-2; "
          f"{t['f32_d256']['ms']:.6f} ms" + (f" [first design: {first}]" if first else ""))
    del qf, kf, vf

    b, s, hq, hkv, d, window = 1, 1536, 8, 4, 256, 1024  # gemma3-4b's local layers
    q, k, v = inputs(b, s, hq, hkv, d)
    pos = torch.arange(s, device="cuda")
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    keys = int(torch.clamp(pos + 1, max=window).sum())  # keys each query sees, summed
    t["windowed"] = _flash_timing(
        q, k, v, window, 4 * b * hq * keys * d,
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True))
    print(f"  K3 gemma3-4b windowed shape {t['windowed']['shape']}: max |d| "
          f"{t['windowed']['max_abs_err']:.3g} (tolerance 2e-2); SDPA with the window as a "
          "mask agrees within 2e-2")
    return t


def _decode_bound(lengths, hkv, g, d):
    """(bound ms, what bounds it) of K4 in bf16 for these valid lengths."""
    b = lengths.numel()
    valid = int(lengths.sum())
    bytes_moved = 2 * (2 * valid * hkv * d + 2 * b * hkv * g * d) + 4 * b
    flops = 4 * valid * hkv * g * d
    return (max(flops / BF16_FLOP_PER_S, bytes_moved / HBM_BYTES_PER_S) * 1e3,
            "operations" if flops / BF16_FLOP_PER_S > bytes_moved / HBM_BYTES_PER_S
            else "bytes")


def check_decode(seed):
    """K4 against its plain version: the sweep of tests/test_kernels.py:65
    in f32 and bf16, at its head dims and at 256, then the serving shape
    with mixed lengths, timed, and timed again at the serving backend's
    bucketed capacity; then gemma-7b's decode shape (head dim 256, MHA)."""
    import torch

    from repro_torch.kernels.decode_attention import ops as decode_ops

    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    sweep = [(2, 2, 4, 256, 32, 0), (3, 1, 8, 300, 64, 0), (2, 4, 1, 128, 32, 0),
             (2, 2, 2, 256, 32, 64)]
    for dims in ("its head dims", "head dim 256"):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            errs = []
            for b, hkv, g, s, d, window in sweep:
                d = d if dims == "its head dims" else 256
                q = torch.randn((b, 1, hkv * g, d), generator=gen, device="cuda").to(dtype)
                k, v = (torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(dtype)
                        for _ in range(2))
                lengths = torch.randint(max(window, 1), s + 1, (b,), generator=gen,
                                        device="cuda", dtype=torch.int32)
                out = decode_ops.decode_attention(q, k, v, lengths, window=window)
                errs.append(_close(out, _decode_plain(q, k, v, lengths, window),
                                   ATTN_TOL[name], f"K4 {name} {(b, hkv, g, s, d, window)}"))
            print(f"  K4 {name}: 4 configurations of tests/test_kernels.py at {dims} within "
                  f"{ATTN_TOL[name]}, max |d| {max(errs):.3g}")

    b, hkv, g, d, s = 8, 4, 8, 64, 1040
    q = torch.randn((b, 1, hkv * g, d), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    lengths = torch.tensor([1040, 129, 700, 1024, 300, 1039, 512, 890], dtype=torch.int32,
                           device="cuda")
    call = lambda: decode_ops.decode_attention(q, k, v, lengths)  # noqa: E731
    # The same call at the serving backend's bucketed capacity (1040 rounded
    # up to a multiple of 256): the blocks split the valid lengths, so it
    # must cost no more.  Each capacity timed twice, in turns (1040, 1280,
    # 1280, 1040); parts= requires exactly one K4 kernel per call.
    cap = 1280
    kb, vb = (torch.zeros((b, cap, hkv, d), dtype=torch.bfloat16, device="cuda")
              for _ in range(2))
    kb[:, :s], vb[:, :s] = k, v
    _close(decode_ops.decode_attention(q, kb, vb, lengths), _decode_plain(q, kb, vb, lengths, 0),
           ATTN_TOL["bfloat16"], f"K4 at capacity {cap}")
    call_cap = lambda: decode_ops.decode_attention(q, kb, vb, lengths)  # noqa: E731
    turns = [device_ms(fn, "decode_", iters=50, parts=("decode_",))[0]
             for fn in (call, call_cap, call_cap, call)]
    ms, ms_cap = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    print(f"  K4 device ms at capacity {s}: {turns[0]:.6f}, {turns[3]:.6f}; at capacity {cap}: "
          f"{turns[1]:.6f}, {turns[2]:.6f} (one kernel per call)")
    # The fixed cost of a call: one valid position per row, the same grid.
    ones = torch.ones_like(lengths)
    ms_one = device_ms(lambda: decode_ops.decode_attention(q, k, v, ones), "decode_", iters=50,
                       parts=("decode_",))[0]
    print(f"  K4 device ms with one valid position per row (the call's fixed cost): {ms_one:.6f}")
    # 5 %: the spread of back-to-back profiler means of one few-microsecond kernel.
    require(ms_cap <= 1.05 * ms, f"K4 costs more at capacity {cap} ({ms_cap:.6f} ms) than at "
            f"{s} ({ms:.6f} ms)")
    mask = (torch.arange(s, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
    t = _decode_timing(q, k, v, lengths, mask, "serving shape", ms=ms)
    t.update(ms_at_capacity_1280=ms_cap, ms_one_position=ms_one)
    del q, k, v, kb, vb

    # gemma-7b's decode: 16 KV heads of 256, one query head each, the same lengths.
    hkv, g, d = 16, 1, 256
    q = torch.randn((b, 1, hkv * g, d), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    t["at_d256"] = _decode_timing(q, k, v, lengths, mask, "gemma-7b shape")
    return t


def _decode_timing(q, k, v, lengths, mask, what, ms=None):
    """K4 in bf16 at one shape, checked against its plain version and SDPA
    (``mask`` the valid positions): device time (``ms`` when the caller
    measured it), wrapper time, plain time, SDPA time, and the bound for
    this run's lengths."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops as decode_ops

    b, _, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    out = decode_ops.decode_attention(q, k, v, lengths)
    err = _close(out, _decode_plain(q, k, v, lengths, 0), ATTN_TOL["bfloat16"], f"K4 {what}")
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=g > 1)

    torch.testing.assert_close(library().transpose(1, 2).float(), out.float(),
                               atol=ATTN_TOL["bfloat16"], rtol=ATTN_TOL["bfloat16"])
    call = lambda: decode_ops.decode_attention(q, k, v, lengths)  # noqa: E731
    bound_ms, bound_by = _decode_bound(lengths, hkv, g, d)
    t = {
        "ms": ms if ms is not None
        else device_ms(call, "decode_", iters=50, parts=("decode_",))[0],
        "call_ms": timed_ms(call, iters=50),
        "plain_ms": timed_ms(lambda: _decode_plain(q, k, v, lengths, 0), iters=10),
        "library_ms": timed_ms(library, iters=50),
        "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
        "shape": f"B={b} Hkv={hkv} G={g} D={d} S={s} bf16 lengths={lengths.tolist()}",
    }
    print(f"  K4 {what} {t['shape']}: max |d| {err:.3g} (tolerance 2e-2); "
          "SDPA agrees within 2e-2")
    return t


# K5 against its plain version: tests/test_kernels.py:192.
SSD_ATOL, SSD_RTOL = 2e-4, 1e-3
# K5's five kernels, launched in this order by one ssd_chunk_scan call.
# Phase 7b and 16 (a): K5 and K5b with B and C of this many groups.
SSD_GROUPS = (2, 4)
SSD_STAGES = ("ssd_chunk_scan_cumsum", "ssd_chunk_scan_scores", "ssd_chunk_scan_states",
              "ssd_chunk_scan_pass", "ssd_chunk_scan_output")


def _ssd_inputs(gen, b, s, h, p, n):
    """Model-facing K5 inputs on the card, drawn as tests/test_kernels.py:185
    draws them: x, dt (positive), a_log, B and C."""
    import torch

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    return (randn(b, s, h, p), randn(b, s, h).abs() * 0.5 + 0.1, randn(h) * 0.3,
            randn(b, s, n) * 0.3, randn(b, s, n) * 0.3)


def check_ssd(seed):
    """K5 against its plain version: the sweep of tests/test_kernels.py:181,
    a length that is no multiple of the chunk through ``models.ssd``'s
    padding (card against host), then the serving shape: each of the five
    kernels against its plain stage, and the whole call and each stage
    timed; then the serving shape with B and C of 2 and 4 groups, two calls
    bit-identical, timed beside one group."""
    import torch

    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import (
        chunk_cumsum,
        chunk_scores,
        chunk_states,
        ssd_chunk_ref,
        state_passing,
    )
    from repro_torch.models.ssd import ssd_scan

    gen = torch.Generator(device="cuda").manual_seed(seed + 8)

    def plain(x, dt, a_log, bm, cm, chunk):
        dt = dt.float()
        return ssd_chunk_ref(x * dt[..., None], dt * -torch.exp(a_log), bm, cm, chunk)

    errs = []
    for b, s, h, p, n, chunk in [(2, 64, 4, 8, 16, 16), (1, 128, 2, 16, 8, 32),
                                 (2, 48, 8, 8, 32, 16)]:
        args = _ssd_inputs(gen, b, s, h, p, n)
        y, st = ssd_ops.ssd(*args, chunk=chunk)
        y_ref, st_ref = plain(*args, chunk)
        what = f"K5 {(b, s, h, p, n, chunk)}"
        errs.append(max(_close(y, y_ref, SSD_ATOL, what + " y", SSD_RTOL),
                        _close(st, st_ref, SSD_ATOL, what + " state", SSD_RTOL)))
    print(f"  K5: 3 configurations of tests/test_kernels.py within atol {SSD_ATOL}, rtol "
          f"{SSD_RTOL}, max |d| {max(errs):.3g}")

    x, dt, a_log, bm, cm = _ssd_inputs(gen, 3, 300, 24, 64, 128)
    a = -torch.exp(a_log)
    args = (x, dt, a, bm[:, :, None], cm[:, :, None])
    y, st = ssd_scan(*args, 128)
    y_host, st_host = ssd_scan(*(t.cpu() for t in args), 128)
    err = max(_close(y.cpu(), y_host, SSD_ATOL, "K5 ragged y", SSD_RTOL),
              _close(st.cpu(), st_host, SSD_ATOL, "K5 ragged state", SSD_RTOL))
    print(f"  K5 through models.ssd.ssd_scan, B=3 S=300 (padded to 384 with dt = 0) H=24 "
          f"P=64 N=128: y and final state card against host, max |d| {err:.3g}")

    b, s, h, p, n, chunk = 8, 1024, 24, 64, 128, 128
    args = _ssd_inputs(gen, b, s, h, p, n)
    y, st = ssd_ops.ssd(*args, chunk=chunk)
    y_ref, st_ref = plain(*args, chunk)
    err = max(_close(y, y_ref, SSD_ATOL, "K5 serving shape y", SSD_RTOL),
              _close(st, st_ref, SSD_ATOL, "K5 serving shape state", SSD_RTOL))
    x, dt, a_log, bm, cm = args
    dA = (dt * -torch.exp(a_log)).contiguous()
    xdt = (x * dt[..., None]).contiguous()
    # Each of K5's five kernels against its plain stage at the serving shape.
    out = ssd_ops.ssd_chunk_scan_stages(xdt, dA, bm, cm, chunk)
    cum = chunk_cumsum(dA, chunk)
    lower = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device="cuda"))
    entering, final_state = state_passing(chunk_states(xdt, bm, cum, chunk), cum)
    stage_errs = {
        "cumsum": _close(out.cum, cum, SSD_ATOL, "K5 stage cumsum", SSD_RTOL),
        "scores": _close(out.scores[..., lower], chunk_scores(bm, cm, chunk)[..., lower],
                         SSD_ATOL, "K5 stage scores", SSD_RTOL),
        "entering states": _close(out.entering, entering, SSD_ATOL, "K5 stage pass",
                                  SSD_RTOL),
        "final state": _close(out.final_state, final_state, SSD_ATOL, "K5 stage final",
                              SSD_RTOL),
        "y": _close(out.y, y_ref, SSD_ATOL, "K5 stage output", SSD_RTOL),
    }
    del out, cum, entering, final_state
    print("  K5 stages at the serving shape against the plain stages, max |d|: "
          + ", ".join(f"{k} {v:.3g}" for k, v in stage_errs.items()))
    call = lambda: ssd_ops.ssd_chunk_scan(xdt, dA, bm, cm, chunk)  # noqa: E731
    nc, tri = s // chunk, chunk * (chunk + 1) // 2
    # Causal work: scores C.B^T once per (batch row, chunk) over the lower
    # triangle (ngroups = 1), then per head y_diag over the triangle,
    # y_off and the state update, l.P.N each; multiply-adds count 2.
    flops = 2 * b * nc * tri * n + 2 * b * h * nc * (tri * p + 2 * chunk * p * n)
    bytes_moved = 4 * (2 * b * s * h * p + b * s * h + 2 * b * s * n + b * h * p * n)
    # Every one of K5's kernels has a name containing "ssd_chunk_scan", so
    # this sums the five kernels of each call; the stages are read apart.
    ms, stage_ms = device_ms(call, "ssd_chunk_scan", iters=10, parts=SSD_STAGES)
    t = {
        "ms": ms,
        "stage_ms": stage_ms,
        "call_ms": timed_ms(call, iters=10),
        "plain_ms": timed_ms(lambda: ssd_chunk_ref(xdt, dA, bm, cm, chunk), iters=3, warmup=1),
        "library_ms": None,  # no single PyTorch call computes the SSD scan
        "bound_ms": max(flops / FP32_FLOP_PER_S, bytes_moved / HBM_BYTES_PER_S) * 1e3,
        "bound_by": ("operations" if flops / FP32_FLOP_PER_S > bytes_moved / HBM_BYTES_PER_S
                     else "bytes"),
        "max_abs_err": err,
        "shape": f"B={b} S={s} H={h} P={p} N={n} chunk={chunk} f32",
    }
    print(f"  K5 serving shape {t['shape']}: y and final state within atol {SSD_ATOL}, rtol "
          f"{SSD_RTOL}, max |d| {err:.3g}; {flops / 1e9:.3f} GFLOP, {bytes_moved / 1e6:.1f} MB")
    print("  K5 device ms by stage: " + ", ".join(
        f"{k.removeprefix('ssd_chunk_scan_')} {v:.6f}" for k, v in stage_ms.items()))
    t["groups"] = {}
    for g in SSD_GROUPS:
        # B and C of g groups, head h reading group h // (H / g): the scores
        # once per (batch row, chunk, group).
        bg, cg = (torch.randn((b, s, g, n), generator=gen, device="cuda") * 0.3
                  for _ in range(2))
        y, st = ssd_ops.ssd_chunk_scan(xdt, dA, bg, cg, chunk)
        again = ssd_ops.ssd_chunk_scan(xdt, dA, bg, cg, chunk)
        require(torch.equal(y, again[0]) and torch.equal(st, again[1]),
                f"K5 with {g} groups: two calls differ")
        y_ref, st_ref = ssd_chunk_ref(xdt, dA, bg, cg, chunk)
        gerr = max(_close(y, y_ref, SSD_ATOL, f"K5 {g} groups y", SSD_RTOL),
                   _close(st, st_ref, SSD_ATOL, f"K5 {g} groups state", SSD_RTOL))
        del y, st, again, y_ref, st_ref
        call = lambda: ssd_ops.ssd_chunk_scan(xdt, dA, bg, cg, chunk)  # noqa: E731
        gflops = flops + 2 * b * nc * (g - 1) * tri * n
        gbytes = bytes_moved + 4 * 2 * b * s * (g - 1) * n
        gms, gstage = device_ms(call, "ssd_chunk_scan", iters=10, parts=SSD_STAGES)
        t["groups"][g] = {
            "ms": gms, "stage_ms": gstage,
            "plain_ms": timed_ms(lambda: ssd_chunk_ref(xdt, dA, bg, cg, chunk), iters=3,
                                 warmup=1),
            "library_ms": None,
            "bound_ms": max(gflops / FP32_FLOP_PER_S, gbytes / HBM_BYTES_PER_S) * 1e3,
            "bound_by": ("operations" if gflops / FP32_FLOP_PER_S > gbytes / HBM_BYTES_PER_S
                         else "bytes"),
            "max_abs_err": gerr, "shape": f"{t['shape']} G={g}",
        }
        print(f"  K5 with {g} groups at {t['shape']}: within atol {SSD_ATOL}, rtol {SSD_RTOL}, "
              f"max |d| {gerr:.3g}; two calls bit-identical; {gms:.6f} ms on the device "
              f"(one group {ms:.6f}), bound {t['groups'][g]['bound_ms']:.6f} ms; by stage: "
              + ", ".join(f"{k.removeprefix('ssd_chunk_scan_')} {v:.6f}"
                          for k, v in gstage.items()))
        del bg, cg
    return t


class RouteRecorder:
    """Records the expert choices and kept flags of every MoE routing
    (``models.moe._routes``) made while ``on``, by device type; restores
    the function on exit."""

    def __enter__(self):
        from repro_torch.models import moe

        self.on, self.seen, self._real = False, {"cuda": [], "cpu": []}, moe._routes

        def record(probs, *args):
            routes = self._real(probs, *args)
            if self.on:
                self.seen[probs.device.type].append(
                    [(e.cpu(), k.cpu()) for e, _, k, _ in routes])
            return routes

        moe._routes = record
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe._routes = self._real
        return False


def check_model_card_vs_host(seed, arch, seq, caches, layers=2, compare=(1,), routes=False):
    """A float32 model of ``layers`` layers at ``arch``'s widths, one set of
    weights: prefill of 2 x ``seq`` tokens and 4 decode steps on the card,
    eager (the kernels) and replayed from a CUDA graph (``DecodeGraph``:
    one eager step, a capture, replays), against the host (plain
    versions), every step fed the host's token: logits and the ``caches``
    of the layers in ``compare`` (None: every cache of those layers).
    With ``routes``, the MoE's expert choices and dropped tokens of the
    card's eager prefill and steps must equal the host's.  Tolerance 1e-3
    against the host: float32 sums over the model's widths taken in other
    orders, a few layers deep; 1e-5 between graph and eager, which run the
    same kernels on the same inputs."""
    import torch

    with RouteRecorder() as rec:
        _card_vs_host(seed, arch, seq, caches, layers, compare, rec)
    if routes:
        card, host = rec.seen["cuda"], rec.seen["cpu"]
        require(len(card) == len(host) > 0, f"{arch}: {len(card)} card routings, {len(host)} "
                "host routings")
        for step, (a, b) in enumerate(zip(card, host)):
            for (ea, ka), (eb, kb) in zip(a, b):
                require(torch.equal(ea, eb) and torch.equal(ka, kb),
                        f"{arch}: MoE routing {step} differs between card and host")
        tokens = sum(e.numel() for r in card for e, _ in r)
        print(f"    {arch}: expert routing equal, card against host, on {len(card)} routings "
              f"(prefill and {len(card) - 1} steps, {tokens} token choices, "
              f"{sum(int((~k).sum()) for r in card for _, k in r)} dropped)")


def _card_vs_host(seed, arch, seq, caches, layers, compare, rec):
    import dataclasses

    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.models import LM
    from repro_torch.serving.backends import DecodeGraph

    tol, graph_tol = 1e-3, 1e-5
    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for float32 matmuls")
    cfg = dataclasses.replace(ARCHS[arch], num_layers=layers, dtype="float32")
    lm = LM(cfg)
    card = lm.init(seed=seed, device="cuda")
    host = LM(cfg).init(seed=seed, device="cuda").to("cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, seq),
                           generator=torch.Generator().manual_seed(seed))
    steps = 4
    max_len = tokens.shape[1] + steps
    rec.on = True
    lc, cc = lm.prefill(card, tokens.cuda(), max_len=max_len)
    lh, ch = lm.prefill(host, tokens, max_len=max_len)
    rec.on = False
    graph = DecodeGraph(card, cfg, 2, max_len, torch.device("cuda", torch.cuda.current_device()),
                        torch.cuda.graph_pool_handle(), torch.cuda.Stream())
    graph.load(cc, lh.argmax(dim=-1, keepdim=True).cuda())
    errs, graph_errs, checked = [], [], 0
    for step in range(steps + 1):
        lc_host = lc.cpu()
        errs.append(_close(lc_host, lh, tol, f"model logits, step {step}"))
        top2 = torch.topk(lh, 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > tol
        require(torch.equal(lc_host.argmax(-1)[clear], lh.argmax(-1)[clear]),
                f"greedy tokens differ at step {step}")
        checked += int(clear.sum())
        if step > 0:
            errs.append(_close(graph.logits.cpu(), lh, tol, f"graphed logits, step {step}"))
            graph_errs.append(_close(graph.logits, lc, graph_tol,
                                     f"graphed against eager logits, step {step}"))
            require(torch.equal(graph.tok[:, 0], lc.argmax(-1).to(torch.int32)),
                    f"graphed and eager greedy tokens differ at step {step}")
        if step < steps:
            tok = lh.argmax(dim=-1, keepdim=True)
            graph.tok.copy_(tok)
            graph.step()
            rec.on = True
            lc, cc = lm.decode_step(card, cc, tok.cuda())
            lh, ch = lm.decode_step(host, ch, tok)
            rec.on = False
    for i in compare:
        for name in caches or tuple(cc["layers"][i]):
            errs.append(_close(cc["layers"][i][name].cpu(), ch["layers"][i][name], tol,
                               f"layer {i} cache {name}"))
            graph_errs.append(_close(graph.cache["layers"][i][name], cc["layers"][i][name],
                                     graph_tol, f"graphed layer {i} cache {name}"))
    require(graph.captures == 1 and graph.replays == steps - 1,
            f"graphed decode: {graph.captures} captures, {graph.replays} replays")
    shapes = {i: {n: tuple(t.shape) for n, t in cc["layers"][i].items()
                  if n in (caches or cc["layers"][i])} for i in compare}
    print(f"  {arch} widths, {layers} layers, f32: prefill of 2 x {seq} tokens and {steps} "
          f"decode steps, logits and the caches of layers {shapes} within {tol} "
          f"(max |d| {max(errs):.3g}); greedy "
          f"tokens equal on the {checked} of {2 * (steps + 1)} picks with a top-2 margin over "
          f"{tol}; the graphed decode (1 eager step, 1 capture, {graph.replays} replays) "
          f"within {graph_tol} of the eager one (max |d| {max(graph_errs):.3g}), same tokens")
    del card, host, graph


# Kernel kinds of a trace, by a substring of the kernel's name.
KERNEL_KINDS = (
    ("ssd", ("ssd_chunk_scan",)), ("flash_attention", ("flash_attention",)),
    ("decode_attention", ("decode_",)), ("knn", ("knn_",)), ("utility", ("utility_",)),
    ("matmul", ("nvjet", "gemm", "cutlass", "xmma")), ("copy", ("memcpy", "memset")),
)


def device_seconds_by_kind(events) -> dict:
    """{kind: device seconds} of a trace's CUDA kernels (``KERNEL_KINDS``,
    else "other")."""
    from torch.autograd import DeviceType

    out = {}
    for e in events:
        if e.device_type != DeviceType.CUDA:
            continue
        low = e.name.lower()
        kind = next((k for k, keys in KERNEL_KINDS if any(key in low for key in keys)), "other")
        out[kind] = out.get(kind, 0.0) + e.time_range.elapsed_us() / 1e6
    return out


def _two_class_set(rng, n, dim, sep):
    """n points of two Gaussian classes, unit variance, centres at -sep and
    +sep in every one of ``dim`` coordinates."""
    import numpy as np

    labels = rng.integers(0, 2, n)
    centres = np.stack([np.full(dim, -sep), np.full(dim, sep)])
    return (centres[labels] + rng.normal(size=(n, dim))).astype(np.float32), labels


def serving_prompt_fn(vocab):
    """Prompts of 128-1024 tokens below ``vocab``, seeded per request (the
    pool's lanes call it from several threads)."""
    import numpy as np

    def prompt_fn(req):
        rng = np.random.default_rng(req.rid)
        return rng.integers(0, vocab, int(rng.integers(128, 1025))).astype(np.int32)

    return prompt_fn


def serving_sneakpeek(args):
    """The serving phases' k-NN SneakPeek model: 20,000 two-class points,
    D = 32, on the card."""
    import numpy as np

    from repro_torch.core.sneakpeek import KNNSneakPeek

    rng = np.random.default_rng(args.seed + 9)
    train_x, train_y = _two_class_set(rng, 20_000, 32, 0.25)
    return KNNSneakPeek(train_x, train_y, 2, k=args.k, device="cuda")


def serving_trace(args, rid0, slack_scale=1.0):
    """The serving traffic: ``args.serve_requests`` requests 10 ms apart,
    deadlines 0.2, 0.5 or 1.0 s after arrival, times ``slack_scale``; ids
    from ``rid0``."""
    import numpy as np

    from repro_torch.core.types import Request

    trng = np.random.default_rng(args.seed + 10)
    feats, labels = _two_class_set(trng, args.serve_requests, 32, 0.25)
    slack = trng.choice([0.2, 0.5, 1.0], size=args.serve_requests)
    return [Request(rid=rid0 + i, app="assistant", arrival_s=0.01 * i,
                    deadline_s=0.01 * i + float(slack[i]) * slack_scale, features=feats[i],
                    true_label=int(labels[i]))
            for i in range(args.serve_requests)]


def serve_main_path(args):
    """Phase 9: ``EdgeServer`` serving one application from mamba2-130m,
    tinyllama-1.1b and gemma-7b at full width, then the same traffic on
    each family alone.  Every launch count is set to 0 just before each
    run and read just after; each run's launches must be exactly what its
    batches need.  Returns the launches of the three-family run, the main
    path, and the fitted profiles of the three families."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.core.scheduler import make_policy
    from repro_torch.core.types import Application
    from repro_torch.serving.backends import ProfiledBackend, bucket_capacity
    from repro_torch.serving.runtime import LMExecutor
    from repro_torch.serving.server import EdgeServer

    mamba, llama, gemma = "mamba2-130m", "tinyllama-1.1b", "gemma-7b"
    variants = {mamba: (ARCHS[mamba], 0), llama: (ARCHS[llama], 1), gemma: (ARCHS[gemma], 2)}
    # Per-class recalls: each family the more accurate on one of the two
    # classes, so SneakPeek's k-NN evidence (the data-aware selection its
    # scheduler exists for) sends requests to both.  With the recalls of
    # examples/edge_serving.py ([0.72, 0.70] and [0.84, 0.82]) tinyllama-1.1b
    # wins on both classes: with decode compiled it meets the deadlines and
    # serves every request; an eager decode had split the traffic only
    # because every choice missed its deadline.  gemma-7b keeps the recalls
    # of examples/edge_serving.py.
    recalls = {mamba: [0.88, 0.70], llama: [0.78, 0.86], gemma: [0.94, 0.92]}
    new_tokens = 16
    # Prompt tokens below the smaller vocabulary (tinyllama's 32,000), so
    # every prompt is valid for both families.
    vocab = min(cfg.vocab_size for cfg, _ in variants.values())

    prompt_fn = serving_prompt_fn(vocab)

    t0 = time.perf_counter()
    warm = np.random.default_rng(args.seed).integers(0, vocab, (8, 512)).astype(np.int32)
    # A key's first batch pays one-time costs (library initialisation,
    # lazily loaded kernels, the capture of its decode graph): run the
    # warm-up batches once, then fit the profiles on two more rounds, whose
    # decode steps all replay graphs.  The larger batch comes first, so the
    # cache that a (variant, capacity)'s graphs share is made at 8 rows at
    # once and the batch of 1 never retires a graph.
    backend = ProfiledBackend(variants, new_tokens=new_tokens, device="cuda")
    step_s = {}  # (model, batch size) -> decode seconds per step of the replayed rounds
    for rnd in range(3):
        if rnd == 1:
            backend.clear_observations()
            captured = backend.graph_stats()["captures"]
        timed = []
        for name in variants:
            for bsz in (8, 1):
                r = backend.run_batch(name, warm[:bsz], list(range(bsz)))
                timed.append(f"({name}, {bsz}, {r.prefill_s:.4f}, {r.decode_s:.4f})")
                if rnd:
                    step_s.setdefault((name, bsz), []).append(r.decode_s / (new_tokens - 1))
        print(f"    warm-up round {rnd + 1} (model, size, prefill s, decode s): " + " ".join(timed))
    recaptured = backend.graph_stats()["captures"] - captured
    require(recaptured == 0, f"the two fitted rounds captured {recaptured} decode graphs; "
            "their steps must all replay")
    step_ms = {key: 1e3 * sum(v) / len(v) for key, v in step_s.items()}
    faster = all(step_ms[(mamba, bsz)] < step_ms[(llama, bsz)] for bsz in (1, 8))
    print("    P4: decode ms per step, replayed graphs, 512-token prompts: " + ", ".join(
        f"{name} B={bsz} {step_ms[(name, bsz)]:.4f}" for name in variants for bsz in (1, 8))
        + f"; {mamba} decodes {'faster' if faster else 'NOT faster'} than {llama} per step "
        "at both batch sizes")
    profiles = {name: backend.profile(name, recalls[name]) for name in variants}
    for p in profiles.values():
        fixed, per_item = p.latency_model
        print(f"  profile {p.name}: {fixed:.6f} s + {per_item:.6f} s per request "
              f"(512-token prompts, {new_tokens} new tokens), weights "
              f"{p.memory_bytes / 1e9:.3f} GB, load {p.load_latency_s:.6f} s")
    print(f"    set-up (weights on the card, warm-up batches) {time.perf_counter() - t0:.2f} s; "
          f"decode graphs {backend.graph_stats()}")

    # What one replayed step runs (its kernels, their device time, and the
    # bytes of the weights it must read), and what a whole batch runs.
    for name in variants:
        dec = backend.decoder(name, 8, bucket_capacity(warm.shape[1] + new_tokens))
        require(dec.graph is not None, f"{name}: the warm-up left no decode graph")
        batches = [(f"one batch of {bsz} x 512 tokens, prefill and {new_tokens - 1} replayed "
                    "steps", lambda n=name, k=bsz: backend.run_batch(n, warm[:k], list(range(k))))
                   for bsz in (1, 8)]
        for what, fn in [("one replayed decode step at batch 8", dec.step)] + batches:
            torch.cuda.synchronize()
            t = time.perf_counter()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            wall = time.perf_counter() - t
            spans = [e.time_range.elapsed_us() for e in prof.events()
                     if e.device_type == DeviceType.CUDA]
            print(f"    {name}, {what}: {len(spans)} kernels, {sum(spans) / 1e3:.4f} ms of "
                  f"device time in {wall * 1e3:.4f} ms under torch.profiler")
            if what.startswith("one replayed"):
                kinds = device_seconds_by_kind(prof.events())
                print("      device ms by kind: " + ", ".join(
                    f"{k} {v * 1e3:.4f}" for k, v in sorted(kinds.items(), key=lambda x: -x[1])))
        print(f"    {name}: all its weights read once take "
              f"{backend.model_bytes(name) / HBM_BYTES_PER_S * 1e3:.4f} ms at "
              f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s")

    sneak = serving_sneakpeek(args)

    def trace(rid0):
        return serving_trace(args, rid0)

    def serve(names, reqs):
        app = Application(name="assistant", models=[profiles[n] for n in names],
                          penalty="sigmoid")
        server = EdgeServer({"assistant": app}, make_policy("SneakPeek"),
                            executor=LMExecutor(backend=backend),
                            sneakpeeks={"assistant": sneak}, prompt_fn=prompt_fn,
                            device="cuda")
        t = time.perf_counter()
        outs, stats = server.run(reqs)
        torch.cuda.synchronize()
        return outs, stats, time.perf_counter() - t

    def layer_count(cfg, mixers):
        return sum(cfg.layer_kind(i).partition(":")[0] in mixers for i in range(cfg.num_layers))

    ssd_layers = {name: layer_count(cfg, ("ssd",)) for name, (cfg, _) in variants.items()}
    attn_layers = {name: layer_count(cfg, ("attn", "local")) for name, (cfg, _) in variants.items()}
    layers = {name: cfg.num_layers for name, (cfg, _) in variants.items()}

    def counted(label, names, reqs):
        """Serve; check the outputs and that this run launched K5 once per
        SSD layer of every batch's prefill, K3 once per attention layer of
        every batch's prefill and K4 once per attention layer of each of
        its decode steps.  Returns the run's requests per model and its
        launches."""
        torch.cuda.synchronize()
        graphs0 = backend.graph_stats()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        outs, stats, wall = serve(names, reqs)
        launches = kernels.launch_counts()
        graphs = {k: v - graphs0[k] for k, v in backend.graph_stats().items()}
        reports = [r for o in outs for r in (o["reports"] or [])]
        want_ssd = sum(ssd_layers[r.model] for r in reports)
        want_flash = sum(attn_layers[r.model] for r in reports)
        want_decode = (new_tokens - 1) * want_flash
        prefill_s = sum(r.prefill_s for r in reports)
        decode_s = sum(r.decode_s for r in reports)
        tokens = sum(r.tokens.size for r in reports)
        by_model = {name: sum(r.batch_size for r in reports if r.model == name)
                    for name in variants}
        print(f"    {label}: windows={stats.windows} requests={stats.requests} "
              f"mean_utility={stats.mean_utility:.6f} violations={stats.violations} "
              f"swaps={stats.swaps} batches={len(reports)} requests per model {by_model}")
        print(f"    prefill {prefill_s:.6f} s, decode {decode_s:.6f} s, {tokens} tokens "
              f"generated, {tokens / (prefill_s + decode_s):.1f} tokens/s over execution; "
              f"wall {wall:.3f} s (scheduling {stats.sched_wall_s:.6f} s)")
        print("    batches (model, size, prefill s, decode s): " + " ".join(
            f"({r.model}, {r.batch_size}, {r.prefill_s:.4f}, {r.decode_s:.4f})"
            for r in reports))
        print(f"    launches: {launches}")
        print(f"    peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB "
              f"(torch.cuda.max_memory_allocated) of "
              f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.3f} GB")
        print(f"    decode graphs: {graphs['captures']} captured in {graphs['capture_s']:.6f} s, "
              f"{graphs['replays']} replays")
        for name in names:
            mine = [r for r in reports if r.model == name]
            if mine:
                print(f"    {name}: decode {sum(r.decode_s for r in mine) / len(mine):.6f} s per "
                      f"batch of {new_tokens - 1} steps over {len(mine)} batches (captures "
                      f"included), prefill {sum(r.prefill_s for r in mine) / len(mine):.6f} s "
                      "per batch")
        require(graphs["replays"] > 0, f"{label}: decode replayed no CUDA graph")
        require(stats.requests == len(reqs), "not every request was served")
        require(sum(by_model.values()) == len(reqs), "a request ran on no model")
        require(0.0 <= stats.mean_utility <= 1.0, f"mean utility {stats.mean_utility}")
        for r in reports:
            require(r.tokens.shape == (r.batch_size, new_tokens), f"tokens {r.tokens.shape}")
            require(bool(((r.tokens >= 0) & (r.tokens < variants[r.model][0].vocab_size)).all()),
                    "token outside the vocab")
        for name, want in (("ssd", want_ssd), ("flash_attention", want_flash),
                           ("decode_attention", want_decode)):
            require(launches.get(name, 0) == want,
                    f"{label}: {name} launched {launches.get(name)} times, expected {want}")
        require(launches.get("knn_topk", 0) > 0, "serving launched no k-NN kernel")
        require(launches.get("utility_scores", 0) > 0, "serving launched no utility kernel")
        return by_model, launches

    by_model, launches = counted("three families", list(variants), trace(0))
    print("    three-family split (requests per model): "
          + ", ".join(f"{name} {n}" for name, n in by_model.items()))
    for name in ("ssd", "flash_attention", "decode_attention", "knn_topk", "utility_scores"):
        require(launches.get(name, 0) > 0, f"the three-family run launched no {name} kernel")
    # The policy may route every request to one family; the same traffic
    # on each family alone sends every batch through its kernels (gemma-7b
    # alone: every K3 and K4 launch at head dim 256).
    for rid0, name in ((20_000, mamba), (30_000, llama), (40_000, gemma)):
        by_model, alone = counted(f"{name} ({layers[name]} layers) the only variant", [name],
                                  trace(rid0))
        require(by_model[name] == args.serve_requests,
                f"{name} alone did not serve every request")
        if name == gemma:
            require(alone.get("flash_attention", 0) > 0 and alone.get("decode_attention", 0) > 0,
                    "gemma-7b alone launched no K3 or K4 at head dim 256")

    # The three-family traffic again under the profiler: the card's busy share.
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, traced_wall = serve(list(variants), trace(10_000))
    traced_k4 = kernels.launch_counts().get("decode_attention", 0)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:
        lo = max(lo, end)
        if hi > lo:
            busy_us += hi - lo
        end = max(end, hi)
    busy = busy_us / 1e6 / traced_wall
    by_kind = device_seconds_by_kind(prof.events())
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / 1e6
    seen_k4 = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                  and "decode_" in e.name)
    if traced_k4 and not seen_k4:
        print(f"    three families under torch.profiler: the trace holds none of the {traced_k4} "
              "K4 kernels the card ran: kernels of CUDA graph replays are not traced, so no "
              "busy share or device seconds by kind are given for this run")
    else:  # the profiler may drop a few events of a long trace: say how many
        print(f"    three families under torch.profiler: wall {traced_wall:.3f} s, card busy "
              f"{busy_us / 1e6:.6f} s ({100 * busy:.2f} %); device seconds by kind: "
              + ", ".join(f"{k} {v:.6f}"
                          for k, v in sorted(by_kind.items(), key=lambda x: -x[1]))
              + f"; K4 kernels traced {seen_k4} of {traced_k4} launched")
        top = sorted(by_name.items(), key=lambda x: -x[1])[:8]
        print("    top kernels: " + "; ".join(f"{n} {v:.6f} s" for n, v in top))
    return launches, profiles


def _launches_wanted(layer_counts, models, new_tokens):
    """{kernel: launches} of prefill and greedy decode of one forward per
    entry of ``models``: K5 once per SSD layer and K3 once per attention
    layer of each prefill, K4 once per attention layer of each of its
    ``new_tokens - 1`` decode steps."""
    ssd = sum(layer_counts[m][0] for m in models)
    attn = sum(layer_counts[m][1] for m in models)
    return {"ssd": ssd, "flash_attention": attn, "decode_attention": (new_tokens - 1) * attn}


def _placement_sig(sched):
    return [(e.request.rid, e.model, e.order, e.batch_id, e.worker, e.est_start_s,
             e.est_latency_s) for e in sched.sorted_entries()]


def check_placement_kernel(b, cols, seed):
    """K1 at a placement step's shape, one (B, W*M) tile against (W*M,)
    completions with the column sums, against its plain version: f64
    bit-identical."""
    import numpy as np
    import torch

    from repro_torch.kernels.utility import ops as util_ops
    from repro_torch.kernels.utility.ref import utility_scores_ref

    rng = np.random.default_rng(seed)
    for penalty in ("step", "linear", "sigmoid", "none"):
        a = torch.as_tensor(rng.uniform(0.3, 1.0, (b, cols)), device="cuda")
        d = torch.as_tensor(rng.uniform(0.01, 1.0, b), device="cuda")
        e = torch.as_tensor(rng.uniform(0.0, 1.2, cols), device="cuda")
        uk, mk = util_ops.utility_scores(a, d, e, penalty)
        ur, mr = utility_scores_ref(a, d, e, penalty)
        torch.cuda.synchronize()
        require(torch.equal(uk, ur) and torch.equal(mk, mr),
                f"K1 at the placement shape {(b, cols)}, {penalty}: not bit-identical")


def serve_pool_path(args, profiles):
    """Phase 10: the multi-worker pool on the card.  Two workers, one twice
    as fast (a pool of tests/test_pipeline.py), SneakPeek's Eq. 15
    placement (one K1 launch per placement step), the phase 9 traffic.

    (a) thread lanes at full width on mamba2-130m and tinyllama-1.1b, two
    runs over one pool (the first captures the lanes' decode graphs); (b)
    process lanes on mamba2-130m alone against thread lanes on the same
    traffic; (c) the pool through ``CompiledBackend`` lanes.  Every run
    sets the launch counts to 0 just before it and reads them just after:
    K3/K4/K5 exactly what each lane's batches need, K1 one launch per
    placement step plus the commit's one per window; every window's
    placement equals the host path's (``device="cpu"``) on the same
    requests and state; peak device memory under 80 GB.  Returns the
    launches of run (a) 2 and run (a)'s pool, warm and open, for phase 11."""
    import copy
    import gc

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.core.multiworker import Worker
    from repro_torch.core.scheduler import make_policy
    from repro_torch.core.types import Application
    from repro_torch.serving.backends import CompiledBackend, ProfiledBackend
    from repro_torch.serving.runtime import ExecutorPool, LMExecutor
    from repro_torch.serving.server import EdgeServer

    mamba, llama = "mamba2-130m", "tinyllama-1.1b"
    variants = {mamba: (ARCHS[mamba], 0), llama: (ARCHS[llama], 1)}
    new_tokens = 16
    prompt_fn = serving_prompt_fn(min(cfg.vocab_size for cfg, _ in variants.values()))
    sneak = serving_sneakpeek(args)
    workers = [Worker(0), Worker(1, speed=2.0)]
    speed = {w.wid: w.speed for w in workers}
    layer_counts = {
        name: tuple(sum(cfg.layer_kind(i).partition(":")[0] in kinds
                        for i in range(cfg.num_layers)) for kinds in (("ssd",), ("attn", "local")))
        for name, (cfg, _) in variants.items()}
    limit = 80e9

    def app_of(names):
        return {"assistant": Application(name="assistant", models=[profiles[n] for n in names],
                                         penalty="sigmoid")}

    def serve(label, names, rid0, pool, expect_from_reports=True):
        """One run over ``pool``; checks and prints it.  Returns (per-window
        schedules, reports, launches)."""
        reqs = serving_trace(args, rid0)
        server = EdgeServer(app_of(names), make_policy("SneakPeek"), executor=pool,
                            workers=workers, sneakpeeks={"assistant": sneak},
                            prompt_fn=prompt_fn, device="cuda")
        lane0 = pool.launch_counts
        busy0, swaps0, wall0 = pool.busy_s, pool.swap_counts, pool.wall_s
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t = time.perf_counter()
        outs, stats = server.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        lanes = {w: {k: n - lane0[w].get(k, 0) for k, n in c.items() if n != lane0[w].get(k, 0)}
                 for w, c in pool.launch_counts.items()}
        reports = [r for o in outs for r in (o["reports"] or [])]
        scheds = [o["schedule"] for o in outs]
        steps = sum(len({e.batch_id for e in s.entries}) for s in scheds)
        groups = [sum(1 for e in s.entries if e.batch_id == b)
                  for s in scheds for b in {e.batch_id for e in s.entries}]
        tokens = sum(r.tokens.size for r in reports)
        raw = {w: sum((r.prefill_s + r.decode_s) * speed[w] for r in reports if r.worker == w)
               for w in speed}
        busy = {w: pool.busy_s[w] - busy0[w] for w in speed}
        util = {w: busy[w] / max(pool.wall_s - wall0, 1e-12) for w in speed}
        print(f"    {label}: windows={stats.windows} requests={stats.requests} "
              f"mean_utility={stats.mean_utility:.6f} violations={stats.violations} "
              f"batches={len(reports)} placement steps={steps} (groups of "
              f"{min(groups)}-{max(groups)}) wall {wall:.3f} s")
        for w in speed:
            mine = [r for r in reports if r.worker == w]
            print(f"      worker {w} (speed {speed[w]}): batches {len(mine)}, requests per model "
                  f"{ {n: sum(r.batch_size for r in mine if r.model == n) for n in names} }, "
                  f"swaps {pool.swap_counts[w] - swaps0[w]}, busy {busy[w]:.6f} s (speed-scaled; "
                  f"measured {raw[w]:.6f} s), utilisation {util[w]:.4f} of the pool's wall, "
                  f"launches {lanes[w]}")
        print(f"      exec_wall_s {stats.exec_wall_s:.6f} s against {sum(raw.values()):.6f} s of "
              f"the lanes' measured seconds summed (overlap "
              f"{sum(raw.values()) / max(stats.exec_wall_s, 1e-12):.3f}x); {tokens} tokens, "
              f"{tokens / max(stats.exec_wall_s, 1e-12):.1f} tokens/s over execution; "
              f"scheduling {stats.sched_wall_s:.6f} s; peak device memory {peak / 1e9:.3f} GB")
        print(f"      launches: {launches}")
        require(stats.requests == len(reqs), f"{label}: not every request was served")
        require(sum(r.batch_size for r in reports) == len(reqs), f"{label}: a request ran nowhere")
        require(0.0 <= stats.mean_utility <= 1.0, f"{label}: mean utility {stats.mean_utility}")
        require(peak < limit, f"{label}: peak device memory {peak / 1e9:.3f} GB")
        for r in reports:
            require(r.tokens.shape == (r.batch_size, new_tokens), f"tokens {r.tokens.shape}")
            require(bool(((r.tokens >= 0) & (r.tokens < variants[r.model][0].vocab_size)).all()),
                    "token outside the vocab")
        require(launches.get("utility_scores", 0) == steps + stats.windows,
                f"{label}: K1 launched {launches.get('utility_scores')} times, expected "
                f"{steps} placement steps + {stats.windows} commits")
        require(launches.get("knn_topk", 0) > 0, f"{label}: no k-NN kernel")
        if expect_from_reports:
            total = {}
            for w in speed:
                want = _launches_wanted(layer_counts, [r.model for r in reports if r.worker == w],
                                        new_tokens)
                for k, n in want.items():
                    require(lanes[w].get(k, 0) == n,
                            f"{label}: worker {w} launched {k} {lanes[w].get(k, 0)} times, "
                            f"expected {n}")
                    total[k] = total.get(k, 0) + n
            for k, n in total.items():
                require(launches.get(k, 0) == n,
                        f"{label}: {k} launched {launches.get(k, 0)} times, expected {n}")
        # The same windows on the host path: the card's evidence, no k-NN.
        host = EdgeServer(app_of(names), make_policy("SneakPeek"), workers=workers,
                          device="cpu")
        host_outs, _ = host.run(copy.deepcopy(reqs))
        require([_placement_sig(o["schedule"]) for o in host_outs] ==
                [_placement_sig(s) for s in scheds],
                f"{label}: the card's placements differ from the host path's")
        print(f"      {len(scheds)} windows: the card's placements == the host path's")
        return scheds, reports, launches, max(groups)

    # (a) Thread lanes at full width: two runs over one pool.
    t0 = time.perf_counter()
    base = ProfiledBackend(variants, new_tokens=new_tokens, device="cuda")
    pool = ExecutorPool.from_executor(LMExecutor(backend=base), workers, lane="thread")
    print(f"  (a) thread lanes, {mamba} and {llama}, workers {workers}")
    serve("run 1 (captures the lanes' decode graphs)", [mamba, llama], 50_000, pool)
    _, reports, launches, biggest = serve("run 2", [mamba, llama], 60_000, pool)
    for w, lane in pool.lanes.items():
        print(f"      worker {w} decode graphs: {lane.executor.backend.graph_stats()}")
    for w in speed:
        require(any(r.worker == w for r in reports), f"worker {w} served no batch")
    for k in ("ssd", "flash_attention", "decode_attention"):
        require(launches.get(k, 0) > 0, f"the pool launched no {k} kernel")
    check_placement_kernel(biggest, len(workers) * len(variants), args.seed)
    print(f"    K1 at the largest placement step, R={biggest} M={len(workers) * len(variants)} "
          "(B x W*M): f64 bit-identical to its plain version, 4 penalties (timed in phase 4)")
    warm_pool = pool
    del base, pool
    gc.collect()
    torch.cuda.empty_cache()
    print(f"    (a) {time.perf_counter() - t0:.1f} s")

    # (b) Process lanes, mamba2-130m alone, against thread lanes.
    t0 = time.perf_counter()
    print(f"  (b) process lanes, {mamba} alone, against thread lanes on the same traffic")
    runs = {}
    for lane in ("thread", "process"):
        lane_pool = ExecutorPool.from_executor(
            LMExecutor(backend=ProfiledBackend({mamba: variants[mamba]}, new_tokens=new_tokens,
                                               device="cuda")), workers, lane=lane)
        try:
            runs[lane] = serve(f"{lane} lanes", [mamba], 70_000, lane_pool)
        finally:
            lane_pool.close()
    (ts, tr, _, _), (ps, pr, _, _) = runs["thread"], runs["process"]
    require([_placement_sig(s) for s in ps] == [_placement_sig(s) for s in ts],
            "process lanes: the schedule differs from the thread lanes'")
    require([(r.worker, r.request_ids) for r in pr] == [(r.worker, r.request_ids) for r in tr],
            "process lanes: the batches differ from the thread lanes'")
    for a, b in zip(pr, tr):
        require(np.array_equal(a.tokens, b.tokens),
                f"process lanes: tokens of batch {a.request_ids} differ from the thread lanes'")
    print(f"    process lanes: the same {len(ps)} windows' schedule and the same tokens in all "
          f"{len(pr)} batches as the thread lanes; the children's launches arrived exactly")
    print(f"    (b) {time.perf_counter() - t0:.1f} s")

    # (c) CompiledBackend lanes.
    t0 = time.perf_counter()
    compiled = CompiledBackend(variants, new_tokens=new_tokens, device="cuda")
    cpool = ExecutorPool(workers, backend_factory=compiled.spawn, lane="thread")
    forwards = {}
    for w, lane in cpool.lanes.items():
        be = lane.executor.backend
        forwards[w] = []

        def counted(model_name, padded, class_token_ids, be=be, log=forwards[w]):
            log.append(model_name)
            return type(be)._forward(be, model_name, padded, class_token_ids)

        be._forward = counted
    print(f"  (c) CompiledBackend lanes (batch to a power of two, length to a multiple of "
          f"{compiled.seq_multiple}; a lane runs its batches one by one, as the reference's "
          f"lanes do), {mamba} and {llama}")
    _, creports, claunches, _ = serve("compiled lanes", [mamba, llama], 80_000, cpool,
                                      expect_from_reports=False)
    total = {}
    for w, lane in cpool.lanes.items():
        be = lane.executor.backend
        keys = sorted(be._decoders, key=str)
        print(f"      worker {w}: bucketed shapes seen {sorted(be._warm)}; decode graphs "
              f"{be.graph_stats()} over keys {keys}; {len(forwards[w])} forwards for "
              f"{sum(r.worker == w for r in creports)} scheduled batches")
        require(all(d.captures <= 1 for d in be._decoders.values()),
                f"worker {w}: a (variant, bucketed batch, capacity) was captured twice")
        obs = sum(len(v) for v in be._obs.values())
        require(obs == len(forwards[w]) - len(be._warm),
                f"worker {w}: the fit holds {obs} observations for {len(forwards[w])} "
                f"forwards over {len(be._warm)} shapes: a first run was recorded")
        for k, n in _launches_wanted(layer_counts, forwards[w], new_tokens).items():
            total[k] = total.get(k, 0) + n
    for k, n in total.items():
        require(claunches.get(k, 0) == n,
                f"compiled lanes: {k} launched {claunches.get(k, 0)} times, expected {n}")
    cpool.close()
    del compiled, cpool
    gc.collect()
    torch.cuda.empty_cache()
    print(f"    (c) {time.perf_counter() - t0:.1f} s")
    return launches, warm_pool


def _closed_loop_plan(hang: bool):
    """Phase 11's faults: a crash on worker 1 at window 1, seeded
    transients (rate 0.1, seed 7) and, with ``hang``, a straggler pinned
    to worker 2 (every batch 1 s late, no real sleep)."""
    from repro_torch.serving.faults import FaultPlan, FaultSpec

    specs = [FaultSpec("crash", window=1, worker=1, batch=0)]
    if hang:
        specs.append(FaultSpec("hang", worker=2, delay_s=1.0, count=None))
    return FaultPlan(specs=tuple(specs), rates={"transient": 0.1}, seed=7)


def _pass_counting_server():
    """``EdgeServer`` keeping every schedule its scheduling passes made,
    the overlapped loop's discarded speculations included: each placement
    step of each one launched K1 once."""
    from repro_torch.serving.server import EdgeServer

    class PassCountingServer(EdgeServer):
        def _schedule_requests(self, requests, now, state):
            out = super()._schedule_requests(requests, now, state)
            self.passes = getattr(self, "passes", []) + [out[0]]
            return out

    return PassCountingServer


def _closed_loop_view(server, outs, stats):
    """What phase 11 (a) holds equal across its runs: the per-request
    records, the decisions, the counters and the fired faults (sorted:
    thread lanes poll in any order)."""
    return {
        "records": dict(server._records),
        "decisions": [(e.request.rid, e.model, e.worker, e.order, e.batch_id)
                      for o in outs for e in o["schedule"].sorted_entries()],
        "counters": {k: getattr(stats, k) for k in ("preempted", "dropped", "failed_batches",
                                                    "retries", "dropped_after_retry")},
        "faults": sorted(server.injector.log),
    }


def serve_closed_loop_simulated(args, profiles, sneak, pipeline=False, want=None, chunk=0):
    """Phase 11 (a): the closed loop on ``SimulatedBackend`` lanes, whose
    reports carry the profiles' modelled seconds, so no decision depends
    on the clock.  Three workers (one twice as fast), phase 9's
    application, SneakPeek and traffic, ``preempt=True``, a crash, a
    straggler pinned to worker 2, seeded transients and health tracking;
    synchronous and overlapped, on the card (SneakPeek through K2,
    scheduling and commits through K1) and on the host (``device="cpu"``,
    the card's evidence carried on copies of the requests).  The four runs
    must agree exactly, worker 2 must be quarantined at some close, and
    preemption, failures and retries must all happen.  Returns the view
    they agree on.

    Phase 12 (d): with ``pipeline=True``, the same servers on the card
    only, scheduling through one persistent ``WindowPipeline`` (one
    ``selection_scan`` launch per scheduling pass, K1 for the commits
    alone); their views must equal ``want``, phase 11 (a)'s.  Phase 13
    (c): the same with ``chunk``, one ``spec_scan`` launch per pass and no
    ``selection_scan``."""
    import copy

    import torch

    from repro_torch import kernels
    from repro_torch.core.multiworker import Worker
    from repro_torch.core.scheduler import make_policy
    from repro_torch.core.types import Application
    from repro_torch.serving.backends import SimulatedBackend

    server_cls = _pass_counting_server()
    app = {"assistant": Application(name="assistant", models=list(profiles.values()),
                                    penalty="sigmoid")}
    workers = [Worker(0), Worker(1, speed=2.0), Worker(2)]
    vocab = 32_000
    views, evidenced = {}, None
    for device in ("cuda",) if pipeline else ("cuda", "cpu"):
        for overlap in (False, True):
            label = (f"{device}{', pipeline' if pipeline else ''}"
                     f"{f', chunk={chunk}' if chunk else ''}, "
                     f"{'overlapped' if overlap else 'synchronous'}")
            on_card = device == "cuda"
            reqs = serving_trace(args, 90_000) if on_card else copy.deepcopy(evidenced)
            server = server_cls(app, make_policy("SneakPeek"),
                                backend=SimulatedBackend(profiles, occupancy="none"),
                                sneakpeeks={"assistant": sneak} if on_card else None,
                                prompt_fn=serving_prompt_fn(vocab), workers=workers,
                                preempt=True, faults=_closed_loop_plan(hang=True), health=True,
                                overlap=overlap, pipeline=pipeline, chunk=chunk,
                                device=device)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t = time.perf_counter()
            with server:
                outs, stats = server.run(reqs)
            wall = time.perf_counter() - t
            launches = kernels.launch_counts()
            if on_card and evidenced is None:
                evidenced = copy.deepcopy(reqs)
            views[label] = view = _closed_loop_view(server, outs, stats)
            steps = sum(len({e.batch_id for e in s.entries}) for s in server.passes)
            q2 = server.health._health[2].quarantines
            print(f"    {label}: windows={stats.windows} requests={stats.requests} "
                  f"mean_utility={stats.mean_utility:.6f} violations={stats.violations} "
                  f"{view['counters']} fallbacks={stats.fallbacks} faults fired "
                  f"{len(view['faults'])}, worker 2 quarantined {q2} times; "
                  f"{len(server.passes)} scheduling passes, {steps} placement steps; "
                  f"wall {wall:.3f} s, scheduling {stats.sched_wall_s:.6f} s, overlap saved "
                  f"{stats.overlap_saved_s:.6f} s; launches {launches}")
            require(sorted(view["records"]) == sorted(r.rid for r in reqs),
                    f"{label}: not every request has exactly one record")
            require(q2 >= 1, f"{label}: worker 2, the straggler, was never quarantined")
            for key in ("preempted", "failed_batches", "retries"):
                require(view["counters"][key] > 0, f"{label}: {key} is 0")
            if on_card and pipeline:
                passes = sum(1 for sched in server.passes if sched.entries)
                require(launches.get("knn_topk", 0) > 0, f"{label}: no k-NN kernel")
                scan, other = ("spec_scan", "selection_scan") if chunk else \
                    ("selection_scan", "spec_scan")
                require(launches.get(scan, 0) == passes and not launches.get(other, 0),
                        f"{label}: {scan} launched {launches.get(scan)} times and {other} "
                        f"{launches.get(other)}, expected one {scan} per scheduling pass "
                        f"({passes})")
                require(launches.get("utility_scores", 0) == stats.windows,
                        f"{label}: K1 launched {launches.get('utility_scores')} times, expected "
                        f"{stats.windows} commits")
            elif on_card:
                require(launches.get("knn_topk", 0) > 0, f"{label}: no k-NN kernel")
                require(launches.get("utility_scores", 0) == steps + stats.windows,
                        f"{label}: K1 launched {launches.get('utility_scores')} times, expected "
                        f"{steps} placement steps + {stats.windows} commits")
            else:
                require(not any(launches.values()), f"{label}: the host run launched {launches}")
    first = want if want is not None else next(iter(views.values()))
    for label, view in views.items():
        for key, value in view.items():
            phase = "13 (c)" if chunk else "12 (d)" if pipeline else "11 (a)"
            require(value == first[key], f"phase {phase}: "
                    f"{label}'s {key} differ from the card's synchronous run's"
                    f"{' in phase 11 (a)' if pipeline else ''}")
    print(f"    the {len(views)} runs agree{' with phase 11 (a)' if pipeline else ''}: "
          f"{len(first['records'])} records, "
          f"{len(first['decisions'])} decisions, counters {first['counters']}, "
          f"{len(first['faults'])} faults fired "
          f"({sorted({f[3] for f in first['faults']})})")
    return first


def serve_closed_loop_models(args, profiles, pool):
    """Phase 11 (b): the closed loop on real models at full width:
    mamba2-130m and tinyllama-1.1b on phase 10's warm thread-lane pool
    (two workers, one twice as fast), phase 9's profiles and traffic,
    ``preempt=True``, ``health=True``, ``overlap=True``, a crash on worker
    1 at window 1 and seeded transients.  Speculative scheduling (K1, K2)
    runs on this thread while the lanes run prefill and replay decode
    graphs on their own streams.  Every request is recorded once; every
    failure is an injected fault or a cascade from one; each lane launched
    exactly the K3, K4 and K5 kernels its successful batches need; K1
    launched once per placement step of every scheduling pass (discarded
    speculations included) plus once per commit; the overlap hid some
    scheduling time; peak device memory under 80 GB."""
    import torch

    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.core.scheduler import make_policy
    from repro_torch.core.types import Application

    mamba, llama = "mamba2-130m", "tinyllama-1.1b"
    new_tokens = 16
    layer_counts = {
        name: tuple(sum(ARCHS[name].layer_kind(i).partition(":")[0] in kinds
                        for i in range(ARCHS[name].num_layers))
                    for kinds in (("ssd",), ("attn", "local")))
        for name in (mamba, llama)}
    app = {"assistant": Application(name="assistant", models=[profiles[mamba], profiles[llama]],
                                    penalty="sigmoid")}
    workers = [lane.worker for _, lane in sorted(pool.lanes.items())]
    reqs = serving_trace(args, 100_000)
    server = _pass_counting_server()(
        app, make_policy("SneakPeek"), executor=pool, workers=workers,
        sneakpeeks={"assistant": serving_sneakpeek(args)},
        prompt_fn=serving_prompt_fn(ARCHS[llama].vocab_size), preempt=True, health=True,
        overlap=True, faults=_closed_loop_plan(hang=False), device="cuda")
    lane0 = pool.launch_counts
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    outs, stats = server.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    lanes = {w: {k: n - lane0[w].get(k, 0) for k, n in c.items() if n != lane0[w].get(k, 0)}
             for w, c in pool.launch_counts.items()}
    outcomes = [o["pending"].result() for o in outs]
    reports = [r for oc in outcomes for r in oc.reports]
    failures = [f for oc in outcomes for f in oc.failures]
    served = [rid for r in reports for rid in r.request_ids]
    fired = {(w, b, kind, rids) for _, w, b, kind, rids in server.injector.log}
    tokens = sum(r.tokens.size for r in reports)
    steps = sum(len({e.batch_id for e in s.entries}) for s in server.passes)
    d = stats.as_dict()
    print("    ServeStats: " + ", ".join(
        f"{k}={d[k]}" for k in ("windows", "requests", "violations", "mean_utility", "preempted",
                                "dropped", "failed_batches", "retries", "dropped_after_retry",
                                "fallbacks", "quarantined_workers", "realized_over_profiled",
                                "sched_wall_s", "exec_wall_s", "overlap_saved_s")))
    print(f"    {len(reports)} batches served, {len(failures)} failed "
          f"({sorted((f.worker, f.kind, f.cascaded) for f in failures)}); faults fired "
          f"{sorted(server.injector.log)}; {len(server.passes)} scheduling passes for "
          f"{stats.windows} commits, {steps} placement steps; {tokens} tokens, "
          f"{tokens / max(stats.exec_wall_s, 1e-12):.1f} tokens/s over exec_wall_s; wall "
          f"{wall:.3f} s; peak device memory {peak / 1e9:.3f} GB")
    for w in sorted(lanes):
        mine = [r for r in reports if r.worker == w]
        print(f"      worker {w}: batches {len(mine)}, launches {lanes[w]}")
    print(f"      launches: {launches}")
    require(sorted(server._records) == sorted(r.rid for r in reqs),
            "phase 11 (b): a request has no record")
    require(len(served) == len(set(served)), "phase 11 (b): a request was served twice")
    dropped = stats.dropped + stats.dropped_after_retry
    require(len(served) + dropped == len(reqs),
            f"phase 11 (b): {len(served)} served + {dropped} dropped != {len(reqs)} requests")
    require(all(server._records[rid] == (0.0, True) for rid in set(server._records) - set(served)),
            "phase 11 (b): a request neither served nor dropped")
    for oc in outcomes:
        crashed = {f.worker: f.batch_index for f in oc.failures
                   if f.kind == "crash" and not f.cascaded}
        for f in oc.failures:
            require(f.kind not in ("error", "lane"), f"phase 11 (b): a {f.kind} failure: {f}")
            if f.cascaded:
                require(f.kind == "crash" and crashed.get(f.worker, f.batch_index) < f.batch_index,
                        f"phase 11 (b): a cascade without its crash: {f}")
            else:
                require((f.worker, f.batch_index, f.kind, tuple(f.request_ids)) in fired,
                        f"phase 11 (b): a failure no fault fired: {f}")
    total = {}
    for w in lanes:
        want = _launches_wanted(layer_counts, [r.model for r in reports if r.worker == w],
                                new_tokens)
        for k, n in want.items():
            require(lanes[w].get(k, 0) == n, f"phase 11 (b): worker {w} launched {k} "
                    f"{lanes[w].get(k, 0)} times, expected {n}")
            total[k] = total.get(k, 0) + n
    for k, n in total.items():
        require(launches.get(k, 0) == n,
                f"phase 11 (b): {k} launched {launches.get(k, 0)} times, expected {n}")
    require(launches.get("utility_scores", 0) == steps + stats.windows,
            f"phase 11 (b): K1 launched {launches.get('utility_scores')} times, expected "
            f"{steps} placement steps + {stats.windows} commits")
    require(launches.get("knn_topk", 0) > 0, "phase 11 (b): no k-NN kernel")
    require(stats.overlap_saved_s > 0, "phase 11 (b): the overlap hid no scheduling time")
    require(peak < 80e9, f"phase 11 (b): peak device memory {peak / 1e9:.3f} GB")
    for r in reports:
        require(r.tokens.shape == (r.batch_size, new_tokens), f"tokens {r.tokens.shape}")
        require(bool(((r.tokens >= 0) & (r.tokens < ARCHS[r.model].vocab_size)).all()),
                "token outside the vocab")
    return launches


# The selection scan's dependent chain, per step: two adds for the
# completion, eleven dependent operations of the sigmoid's Eq. 2 (each
# division counted as one), one add per member, the divide by the group
# size, a compare per (worker, model) cell and the carry's store; each at
# least one dependent f64 operation of 8.2 cycles (PR 17's chain probe,
# benchmarks/torch_kernel_probe.py chain).
SCAN_CHAIN_FIXED_OPS = 16
F64_DEP_CYCLES = 8.2
# Windows of phase 5's trace that phase 12 (b) runs Grouped on.
GROUPED_WINDOWS = 2
# Float64 operations of one Eq. 2 cell (the sigmoid, the widest form) and
# its member-mean multiply-add.
SCAN_CELL_FLOPS = 14


def sm_clock_hz() -> float:
    """The card's maximum SM clock, from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.split()
    return float(out[0]) * 1e6


class ScanCapture:
    """Records the positional arguments of every scan launch the pipeline
    makes while it is entered (``core.pipeline._scan``), then restores it."""

    def __enter__(self):
        from repro_torch.core import pipeline as tpipe

        self.calls, self._real = [], tpipe._scan

        def record(*call, **kw):
            self.calls.append(call)
            return self._real(*call, **kw)

        tpipe._scan = record
        return self

    def __exit__(self, *exc):
        from repro_torch.core import pipeline as tpipe

        tpipe._scan = self._real
        return False


def _step_depths(call):
    """The dependent f64 operations of each step of one scan's inputs:
    SCAN_CHAIN_FIXED_OPS, one add per member and a compare per (worker,
    real model) cell; with fixed choices the completion's two adds and the
    carry's store."""
    import numpy as np

    _, _, _, _, _, acc, _, _, bsize, lat, step_app, _, _, valid, _, _, *fixed = call
    if fixed and fixed[0] is not None:
        return np.full(acc.shape[0], 3.0)
    mv = valid.cpu().numpy().sum(axis=1)[step_app.cpu().numpy()]
    return SCAN_CHAIN_FIXED_OPS + bsize.cpu().numpy() + lat.shape[1] * mv


def _scan_numbers(call, clock_hz):
    """Bytes, operations and the dependent chain of one scan's inputs:
    (bound ms, bound_by, chain ms, shape).  The bytes are those the
    function needs, each read once: the real members' accuracies (of the
    real models) and deadlines, the member counts of groups, the distinct
    latency rows, the swap, id, validity, penalty and preference rows of
    the applications the steps use, the steps' application ids (and fixed
    choices), the carry seed and the (4, S) output; not the padding, nor
    per-step copies of one application's row."""
    import numpy as np

    res_mode, t0, res0, sizes, cap, acc, mask, deadlines, bsize, lat, step_app, swap, gid, \
        valid, pen, pref, *fixed = call
    fixed = fixed[0] if fixed else None
    n = bsize.cpu().numpy()
    s_steps, b_max, m = acc.shape
    n_w = lat.shape[1]
    app = step_app.cpu().numpy()
    m_valid = valid.cpu().numpy().sum(axis=1)  # real models per application
    mv = m_valid[app]
    used = np.unique(app)
    lat_rows = np.unique(np.column_stack([app, lat.cpu().numpy().reshape(s_steps, -1)]), axis=0)
    nbytes = 8 * (n_w * m_valid[lat_rows[:, 0].astype(np.int64)]).sum()  # distinct l(m, b)
    nbytes += 8 * (2 * n_w * m_valid[used] + m_valid[used] + 1).sum() + m_valid[used].sum()
    nbytes += 8 * s_steps * (1 + 4 + (fixed is not None) + (b_max > 1))
    nbytes += np.asarray(t0).nbytes + np.asarray(res0).nbytes
    if res_mode == "lru":
        nbytes += np.asarray(sizes).nbytes
    if fixed is None:
        nbytes += 8 * ((n * mv).sum() + n.sum())  # real members' accuracies and deadlines
        ops = float((n_w * n * mv).sum()) * SCAN_CELL_FLOPS
    else:
        ops = 2.0 * s_steps  # MaxAcc: the completion's two adds per step
    byte_ms, op_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP64_FLOP_PER_S * 1e3
    chain = float(_step_depths(call).sum()) * F64_DEP_CYCLES
    shape = f"S={s_steps} B={b_max} M={m} W={n_w} {res_mode}"
    return (float(max(byte_ms, op_ms)), "bytes" if byte_ms >= op_ms else "operations",
            chain / clock_hz * 1e3, shape)


def check_scan(apps, reqs, now):
    """Phase 12 (a): ``selection_scan`` against its plain version on the
    card, on the inputs the pipeline gives it for one window of phase 5
    (LO-EDF's per-request scan, SneakPeek's grouped scan, SneakPeek
    placed on a four-worker pool), each with the single-slot and the LRU
    residency carry: every output bit-identical.  Times the kernel on the
    device and the plain version, and works out each case's bounds."""
    import torch

    from repro_torch.core.multiworker import Worker
    from repro_torch.core.scheduler import make_policy, schedule_window
    from repro_torch.core.streaming import StreamingState
    from repro_torch.kernels.selection_scan import ops as scan_ops
    from repro_torch.kernels.selection_scan.ref import selection_scan_ref

    clock = sm_clock_hz()
    pool = [Worker(0), Worker(1, speed=2.0), Worker(2, speed=0.5), Worker(3, load_scale=2.0)]
    out = {}
    for res_mode, cap in (("slot1", None), ("lru", 400 * 2**20)):
        for label, policy, workers in (("LO-EDF", "LO-EDF", None),
                                       ("SneakPeek", "SneakPeek", None),
                                       ("SneakPeek on 4 workers", "SneakPeek", pool)):
            state = None
            if cap is not None:
                state = StreamingState(worker_ids=[w.wid for w in workers] if workers else None,
                                       memory_capacity_bytes=cap)
            with ScanCapture() as cap_calls:
                schedule_window(make_policy(policy, pipeline=True), reqs, apps, now,
                                workers=workers, state=state, device="cuda")
            require(len(cap_calls.calls) == 1, f"{label}: {len(cap_calls.calls)} scans, expected 1")
            call = cap_calls.calls[0]
            require(call[0] == res_mode, f"{label}: residency {call[0]}, expected {res_mode}")
            mode, t0, res0, sizes, capacity, *tabs = call

            kind = scan_ops.instance(tabs[4].shape[1], *tabs[0].shape[1:])
            got = scan_ops.selection_scan(t0, res0, sizes, capacity, mode, *tabs)
            seed = [torch.as_tensor(x, device="cuda") for x in (t0, res0, sizes)]

            def kernel():
                return scan_ops.launch(seed, capacity, mode, *tabs)

            torch.cuda.synchronize()
            t = time.perf_counter()
            want = selection_scan_ref(*seed, capacity, mode == "slot1", *tabs)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t) * 1e3
            require(torch.equal(got, want), f"{label}, {res_mode}: the scan differs from its "
                    "plain version")
            # CUDA events around back-to-back launches whose seed is already
            # on the card: each launch is 0.3-11 ms, its host side ~0.05 ms.
            ms = timed_ms(kernel, iters=5, warmup=1)
            bound_ms, bound_by, chain_ms, shape = _scan_numbers(call, clock)
            out[f"{label}, {res_mode}"] = {
                "shape": shape, "instance": kind, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "chain_bound_ms": chain_ms,
                "max_abs_err": 0.0, "library_ms": None}
            print(f"    {label}, {res_mode} ({shape}), {kind} instance: bit-identical; kernel "
                  f"{ms:.6f} ms on the device, plain {plain_ms:.3f} ms, bound {bound_ms:.6f} ms "
                  f"({bound_by}), dependent chain {chain_ms:.6f} ms")
    return out


def check_pipeline_simulation(apps, sneaks, trace, seed):
    """Phase 12 (b): ``Simulation(pipeline=True)`` over phase 5's trace for
    the five policies against ``Simulation(pipeline=False)``: every
    window's schedule equal, one scan launch per window that does not take
    the brute-force branch, scheduling seconds per window side by side.
    Grouped runs the first ``GROUPED_WINDOWS`` windows: it takes the
    host's brute-force branch on both routes.
    Phase 12 (c): SneakPeek with ``prebatch=4`` decides as ``prebatch=0``,
    with and without the pipeline, and the stacked Eq. 9/12 rows equal
    the lazy ones on the card.  Returns (SneakPeek's scan launches,
    {policy: launches}, {policy: (pipeline s per window, fast path s)},
    {policy: every window's schedule})."""
    import torch

    from repro_torch import kernels
    from repro_torch.core import simulator as tsim
    from repro_torch.core.fastpath import WindowArrays, precompute_windows
    from repro_torch.core.grouping import group_by_app, split_groups_by_label
    from repro_torch.core.scheduler import POLICY_NAMES, effective_apps, make_policy

    def run(policy, reqs, **kwargs):
        seen, real = [], tsim.evaluate

        def spy(sched, *a, **kw):
            seen.append([(e.request.rid, e.model, e.order, e.batch_id, e.worker,
                          e.est_start_s, e.est_latency_s) for e in sched.sorted_entries()])
            return real(sched, *a, **kw)

        tsim.evaluate = spy
        try:
            sim = tsim.Simulation(make_policy(policy), apps, sneakpeeks=sneaks,
                                  short_circuit=True, seed=seed, device="cuda", **kwargs)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            agg = sim.run(reqs)
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
        finally:
            tsim.evaluate = real
        return sim, agg, seen, launches

    eff = effective_apps(apps, sneaks, True)
    per_policy, seconds, sigs = {}, {}, {}
    all_windows = tsim.Simulation(make_policy("SneakPeek"), apps, device="cuda") \
        ._window_batches(trace, None)
    for policy in POLICY_NAMES:
        # Grouped takes the brute-force branch (3 groups <= tau) on the
        # host on both routes, ~2.5 s a window: its first GROUPED_WINDOWS
        # windows only.
        reqs = trace if policy != "Grouped" else \
            [r for _, batch in all_windows[:GROUPED_WINDOWS] for r in batch]
        fast, fast_agg, fast_seen, _ = run(policy, reqs)
        pipe, pipe_agg, pipe_seen, launches = run(policy, reqs, pipeline=True)
        windows = fast._window_batches(reqs, None)
        require(len(pipe_seen) == len(windows), f"{policy}: {len(pipe_seen)} windows scheduled")
        for w, (a, b) in enumerate(zip(pipe_seen, fast_seen)):
            require(a == b, f"{policy}: window {w}'s pipeline schedule differs from the fast path's")
        require(pipe_agg == fast_agg, f"{policy}: aggregates differ: {pipe_agg} {fast_agg}")
        policy_obj = make_policy(policy)
        brute = 0
        for _, batch in windows:
            if policy_obj.grouped:
                groups = group_by_app(batch)
                if policy_obj.split_by_label:
                    groups = split_groups_by_label(groups, eff)
                brute += len(groups) <= policy_obj.tau
        want = len(windows) - brute
        require(launches.get("selection_scan", 0) == want,
                f"{policy}: {launches.get('selection_scan', 0)} scan launches, expected {want} "
                f"({brute} brute-force windows)")
        per_policy[policy] = launches.get("selection_scan", 0)
        seconds[policy] = ([row["overhead_s"] for row in pipe.log],
                           [row["overhead_s"] for row in fast.log])
        sigs[policy] = pipe_seen
        print(f"    {policy}: {len(windows)} windows equal, {want} scans "
              f"({brute} brute-force windows); launches {launches}")
        print("      scheduling s per window, pipeline: "
              + " ".join(f"{x:.4f}" for x in seconds[policy][0]))
        print("      scheduling s per window, fast path: "
              + " ".join(f"{x:.4f}" for x in seconds[policy][1]))
    print("  (c) prebatch=4, SneakPeek, with and without the pipeline")
    for pipeline in (False, True):
        sim, _, seen, launches = run("SneakPeek", trace, prebatch=4, prebatch_backend="jax",
                                     pipeline=pipeline)
        want = sigs["SneakPeek"]
        require(seen == want, f"prebatch=4 (pipeline={pipeline}) decides otherwise than "
                "prebatch=0")
        print(f"    pipeline={pipeline}: {len(seen)} windows decide as prebatch=0; "
              f"launches {launches}")
    windows = sim._window_batches(trace, None)[:4]
    stacked = precompute_windows([(b, (w + 1) * 0.1) for w, b in windows], eff,
                                 data_aware=True, backend="numpy", device="cuda")
    for (w, batch), wa in zip(windows, stacked):
        lazy = WindowArrays(batch, eff, (w + 1) * 0.1, device="cuda")
        require((lazy.priorities(True) == wa.priorities(True)).all(),
                f"window {w}: stacked priorities differ from the lazy ones")
        for name in wa.req_idx:
            require(torch.equal(wa.acc_matrix(name, "sharpened"),
                                lazy.acc_matrix(name, "sharpened")),
                    f"window {w}, {name}: stacked Eq. 9 rows differ from the lazy ones")
    print(f"    stacked Eq. 9/12 rows of {len(windows)} windows == the lazy rows, bit for bit")
    return per_policy["SneakPeek"], per_policy, seconds, sigs


# Chunk sizes of phase 13 (a) and the one the chunked pipeline runs in (b), (c).
SPEC_CHUNKS = (1, 4, 16, 64)
PIPELINE_CHUNK = 16


def check_spec_scan(apps, reqs, now, seq_t):
    """Phase 13 (a): the chunked scan (``spec_scan``) on the inputs the
    pipeline gives ``selection_scan`` in phase 12 (a) — LO-EDF's 4,095-step
    per-request scan, SneakPeek's grouped scan and SneakPeek on four
    workers, each with the single-slot and the LRU carry — for every chunk
    of ``SPEC_CHUNKS``: its rows bit-identical to the sequential kernel's
    on the card and to its plain version's (on host copies of the same
    inputs), its rounds and conflicts equal to the plain version's.  Times
    the kernel on the device beside the sequential scan's (``seq_t``,
    phase 12 (a)) and the plain version on the host."""
    import torch

    from repro_torch.core.multiworker import Worker
    from repro_torch.core.scheduler import make_policy, schedule_window
    from repro_torch.core.streaming import StreamingState
    from repro_torch.kernels.selection_scan import ops as scan_ops
    from repro_torch.kernels.spec_scan import ops as spec_ops

    clock = sm_clock_hz()
    pool = [Worker(0), Worker(1, speed=2.0), Worker(2, speed=0.5), Worker(3, load_scale=2.0)]
    out = {}
    for res_mode, cap in (("slot1", None), ("lru", 400 * 2**20)):
        for label, policy, workers in (("LO-EDF", "LO-EDF", None),
                                       ("SneakPeek", "SneakPeek", None),
                                       ("SneakPeek on 4 workers", "SneakPeek", pool)):
            state = None
            if cap is not None:
                state = StreamingState(worker_ids=[w.wid for w in workers] if workers else None,
                                       memory_capacity_bytes=cap)
            with ScanCapture() as cap_calls:
                schedule_window(make_policy(policy, pipeline=True), reqs, apps, now,
                                workers=workers, state=state, device="cuda")
            call = cap_calls.calls[0]
            least_depth = float(_step_depths(call).min())
            mode, t0, res0, sizes, capacity, *tabs = call
            seq = scan_ops.selection_scan(t0, res0, sizes, capacity, mode, *tabs)
            host_tabs = [t.cpu() if t is not None else None for t in tabs]
            seed = [torch.as_tensor(x, device="cuda") for x in (t0, res0, sizes)]
            bound_ms, bound_by, _, shape = _scan_numbers(call, 1.0)
            seq_ms = seq_t[f"{label}, {res_mode}"]["ms"]
            for chunk in SPEC_CHUNKS:
                got = spec_ops.spec_scan(t0, res0, sizes, capacity, mode, *tabs, chunk=chunk)
                t = time.perf_counter()
                want = spec_ops.spec_scan(t0, res0, sizes, capacity, mode, *host_tabs,
                                          chunk=chunk)
                plain_ms = (time.perf_counter() - t) * 1e3
                got_h = got.cpu()
                require(torch.equal(got_h, want), f"{label}, {res_mode}, chunk {chunk}: the "
                        "chunked scan differs from its plain version")
                require(torch.equal(got[:, :-1], seq), f"{label}, {res_mode}, chunk {chunk}: "
                        "the chunked scan differs from the sequential scan")
                k_eff = min(chunk, tabs[0].shape[0])

                def kernel(k=k_eff):
                    return spec_ops.launch(seed, capacity, mode, *tabs, chunk=k)

                ms = timed_ms(kernel, iters=5, warmup=1)
                n_w, (b, m) = tabs[4].shape[1], tabs[0].shape[1:]
                kind = spec_ops.instance(n_w, b, m)
                fixed = tabs[11] if len(tabs) > 11 else None
                n_blocks = spec_ops.blocks(k_eff, n_w, b, m, fixed is not None)
                rounds, conflicts = int(got_h[0, -1]), int(got_h[1, -1])
                # The dependent chain: every round scores its positions once
                # (twice when it has more than one: speculation, then
                # validation; only the window's last round may have one),
                # each pass at least the least step's depth, and its chain
                # carries the rounds' other positions, the completion's two
                # adds and the carry's store each.
                s_steps = tabs[0].shape[0]
                passes = rounds if k_eff == 1 else 2 * rounds - 1
                chain_ms = ((passes * least_depth + 3.0 * (s_steps - rounds))
                            * F64_DEP_CYCLES / clock * 1e3)
                out[f"{label}, {res_mode}, chunk {chunk}"] = {
                    "shape": f"{shape} K={chunk}", "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": 0.0,
                    "library_ms": None, "sequential_ms": seq_ms, "rounds": rounds,
                    "conflicts": conflicts, "chain_bound_ms": chain_ms, "instance": kind,
                    "cluster_blocks": n_blocks}
                print(f"    {label}, {res_mode}, chunk {chunk} ({shape}; {kind} instance, "
                      f"{n_blocks} block(s)): bit-identical to its "
                      f"plain version and to the sequential scan; {rounds} rounds, {conflicts} "
                      f"conflicts ({conflicts / rounds:.3f}); kernel {ms:.6f} ms on the device "
                      f"against the sequential {seq_ms:.6f} ms; plain {plain_ms:.1f} ms on the "
                      f"host; bound {bound_ms:.6f} ms ({bound_by}), dependent chain "
                      f"{chain_ms:.6f} ms")
    return out


def check_chunked_simulation(apps, sneaks, trace, seed, want_sigs):
    """Phase 13 (b): ``Simulation(pipeline=True, chunk=PIPELINE_CHUNK)``
    over phase 5's trace for the five policies: every window's schedule
    equal to phase 12 (b)'s ``chunk=0`` schedules (``want_sigs``), one
    ``spec_scan`` launch per window outside the brute-force branch and no
    ``selection_scan``.  Returns ({policy: spec_scan launches}, {policy:
    the chunk stats of every window})."""
    import torch

    from repro_torch import kernels
    from repro_torch.core import simulator as tsim
    from repro_torch.core.scheduler import POLICY_NAMES, make_policy

    launches_by, stats_by = {}, {}
    all_windows = tsim.Simulation(make_policy("SneakPeek"), apps, device="cuda") \
        ._window_batches(trace, None)
    for policy in POLICY_NAMES:
        reqs = trace if policy != "Grouped" else \
            [r for _, batch in all_windows[:GROUPED_WINDOWS] for r in batch]
        seen, stats, real_eval = [], [], tsim.evaluate

        def spy(sched, *a, **kw):
            seen.append([(e.request.rid, e.model, e.order, e.batch_id, e.worker,
                          e.est_start_s, e.est_latency_s) for e in sched.sorted_entries()])
            stats.append(sched.chunk_stats)
            return real_eval(sched, *a, **kw)

        tsim.evaluate = spy
        try:
            sim = tsim.Simulation(make_policy(policy), apps, sneakpeeks=sneaks,
                                  short_circuit=True, seed=seed, pipeline=True,
                                  chunk=PIPELINE_CHUNK, device="cuda")
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            sim.run(reqs)
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
        finally:
            tsim.evaluate = real_eval
        require(seen == want_sigs[policy], f"{policy}: chunk={PIPELINE_CHUNK} schedules differ "
                "from chunk=0's")
        scanned = sum(st is not None for st in stats)
        require(launches.get("spec_scan", 0) == scanned and not launches.get("selection_scan"),
                f"{policy}: spec_scan {launches.get('spec_scan')} and selection_scan "
                f"{launches.get('selection_scan')} launches, expected {scanned} and 0")
        launches_by[policy], stats_by[policy] = launches.get("spec_scan", 0), stats
        rounds = [st["rounds"] for st in stats if st]
        rate = [round(st["conflict_rate"], 4) for st in stats if st]
        print(f"    {policy}: {len(seen)} windows equal to chunk=0's, {scanned} spec_scan "
              f"launches; rounds per window {rounds}, conflict rate {rate}")
        print("      scheduling s per window, chunk="
              f"{PIPELINE_CHUNK}: " + " ".join(f"{row['overhead_s']:.4f}" for row in sim.log))
    return launches_by, stats_by


# recurrentgemma-9b's shapes in phase 14 (batch, length, LRU width): a
# prefill, a decode step and a lone prompt.
RGLRU_SHAPES = {"prefill": (8, 1024, 4096), "decode": (8, 1, 4096),
                "lone_prompt": (1, 1024, 4096)}
# The RG-LRU scan's two kernels (device-time names): the chunk summaries
# (not launched when S fits one chunk) and the chunked scan.
RGLRU_PASSES = ("rglru_summary_kernel", "rglru_scan_kernel")


def check_rglru(seed):
    """Phase 14: ``rglru_scan`` against its plain version on the card, at
    recurrentgemma-9b's width in bf16 (B = 8, S = 1024, L = 4096), at S = 1
    (a decode step) and for a lone prompt (B = 1): y within 2e-2 (its bf16
    rounding), the last state within 1e-4 (float32 kept in both; the
    chunked kernel adds its products in another order, and the kernel's
    and PyTorch's transcendental functions differ in the last bits).  Times
    each, pass by pass; the bound is the bytes (u and g read, y written, in
    bf16; the gate vectors; h0 read and h written in float32) against about
    thirty float32 operations an element, and the design's own bytes read u
    a second time (its summaries read and written in float32 besides).  The
    device time is ``torch.profiler``'s; back-to-back wrapper calls show the
    host's rate at S = 1."""
    import torch

    from repro_torch.kernels.rglru_scan import ops as rglru_ops
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

    gen = torch.Generator(device="cuda").manual_seed(seed + 14)
    out = {}
    chunk = rglru_ops.chunk_len()
    for key, (b, s, width) in RGLRU_SHAPES.items():
        u, gp = (torch.randn((b, s, width), generator=gen, device="cuda").to(torch.bfloat16)
                 for _ in range(2))
        vecs = [(torch.randn(width, generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
                for _ in range(5)]
        h0 = torch.randn((b, width), generator=gen, device="cuda")
        y, h = rglru_ops.rglru_scan(u, gp, *vecs, h0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        y_ref, h_ref = rglru_scan_ref(u, gp, *vecs, h0)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t) * 1e3
        err = _close(y.float(), y_ref.float(), 2e-2, f"rglru_scan y at S={s}")
        _close(h, h_ref, 1e-4, f"rglru_scan h_last at S={s}")
        def kernel():
            return rglru_ops.rglru_scan(u, gp, *vecs, h0)

        n_chunks = -(-s // chunk)
        passes = RGLRU_PASSES if n_chunks > 1 else RGLRU_PASSES[1:]
        ms, pass_ms = device_ms(kernel, "rglru_", iters=20, parts=passes)
        call_ms = timed_ms(kernel, iters=20, warmup=3)
        nbytes = 3 * 2 * b * s * width + 5 * 2 * width + 2 * 4 * b * width
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        # The design's bytes: u read twice, and each summary (A, H) written
        # once and read by the chunks after it (from L2, counted once).
        design_ms = (nbytes + 2 * b * s * width + 2 * 2 * 4 * b * (n_chunks - 1) * width) \
            / HBM_BYTES_PER_S * 1e3
        op_ms = 30.0 * b * s * width / FP32_FLOP_PER_S * 1e3
        out[key] = {"shape": f"B={b} S={s} L={width} bf16", "ms": ms, "call_ms": call_ms,
                    "pass_ms": pass_ms, "chunk": chunk, "plain_ms": plain_ms,
                    "bound_ms": max(bound_ms, op_ms),
                    "bound_by": "bytes" if bound_ms >= op_ms else "operations",
                    "design_bytes_ms": design_ms, "max_abs_err": err, "library_ms": None}
        print(f"    rglru_scan at B={b} S={s} L={width} bf16, chunk {chunk}: y within 2e-2 (max "
              f"|d| {err:.3g}), h within 1e-4; kernel {ms:.6f} ms on the device ("
              + ", ".join(f"{k} {v:.6f}" for k, v in pass_ms.items())
              + f"), {call_ms:.6f} ms per wrapper call back to back, plain {plain_ms:.3f} ms, "
              f"bound {max(bound_ms, op_ms):.6f} ms ({out[key]['bound_by']}), the design's "
              f"bytes {design_ms:.6f} ms, no library call")
    return out


def check_new_attention_shapes(seed):
    """Phase 14 (a): K3 and K4 in bf16 (the tensor-core instance of K3) at
    the shapes phase 14 (b) gives them, each against its plain version at
    2e-2 and against SDPA, timed as phases 6-7 time them:
    recurrentgemma-9b's local layers (MQA: Hq = 16 over Hkv = 1, D = 256,
    window 2048, which a 1,024-token prefill does not reach) and llama4's
    attention (Hq = 40 over Hkv = 8, G = 5, D = 128), prefill at B = 8, S =
    1024 and decode at phase 7's eight lengths up to 1,040."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed + 15)
    flash, decode = {}, {}
    b, s, cap = 8, 1024, 1040
    lengths = torch.tensor([1040, 129, 700, 1024, 300, 1039, 512, 890], dtype=torch.int32,
                           device="cuda")
    mask = (torch.arange(cap, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
    for key, hq, hkv, d, window in (("recurrentgemma_local", 16, 1, 256, 2048),
                                    ("llama4", 40, 8, 128, 0)):
        q = torch.randn((b, s, hq, d), generator=gen, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        pos = torch.arange(s, device="cuda")
        keys = int(torch.clamp(pos + 1, max=window or s).sum())  # keys each query sees, summed
        # window >= S: the windowed causal mask is the causal one, SDPA's is_causal.
        flash[key] = _flash_timing(
            q, k, v, window, 4 * b * hq * keys * d,
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True))
        print(f"  K3 {key} shape {flash[key]['shape']}: max |d| {flash[key]['max_abs_err']:.3g} "
              f"(tolerance 2e-2); SDPA agrees within 2e-2; {flash[key]['ms']:.6f} ms on the "
              f"device, plain {flash[key]['plain_ms']:.3f} ms, SDPA "
              f"{flash[key]['library_ms']:.6f} ms, bound {flash[key]['bound_ms']:.6f} ms "
              f"({flash[key]['bound_by']})")
        del q, k, v, qt, kt, vt
        q = torch.randn((b, 1, hq, d), generator=gen, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn((b, cap, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        decode[key] = _decode_timing(q, k, v, lengths, mask, f"{key} shape")
        print(f"    K4 {key}: {decode[key]['ms']:.6f} ms on the device, plain "
              f"{decode[key]['plain_ms']:.3f} ms, SDPA {decode[key]['library_ms']:.6f} ms, "
              f"bound {decode[key]['bound_ms']:.6f} ms ({decode[key]['bound_by']})")
        del q, k, v
    return flash, decode


# Phase 14 (b)'s llama4-scout depth: full width, 6 of its 48 layers.
SCOUT_LAYERS = 6
# Phase 14 (b)'s deadline slack, times phase 9's.  A batch of these models
# takes about 0.35 s and a cold load 0.7 s (recurrentgemma-9b) or 1.2 s
# (scout), so phase 9's 0.2-1.0 s slack misses nearly every deadline and
# SneakPeek keeps the first model it loads; at six times the slack the
# accuracy decides, and both families win requests (class 0 goes to
# recurrentgemma-9b, class 1 to scout).
NEW_FAMILY_SLACK = 6.0


def serve_new_families(args):
    """Phase 14 (b): ``EdgeServer`` serving phase 9's traffic, its slack
    times ``NEW_FAMILY_SLACK``, on one application offering
    recurrentgemma-9b (all 38 layers, 17.0 GB) and llama4-scout-17b-16e
    (full width, ``SCOUT_LAYERS`` layers, 30.6 GB), bf16, decode replayed
    from CUDA graphs, after phase 9's warm-up and profile fit.  Phase 9's
    prompts of 128-1,024 tokens: the backend right-pads a scout batch to
    whole groups of 512 tokens (``moe_group``), which the MoE layers
    require, as the reference's do.  Both families must serve requests in
    the two-family run.  Then the same traffic on each family alone.  Every
    launch count is set to 0 just before each run and read just after:
    ``rglru_scan`` once per RG-LRU layer of every prefill and decode step,
    K3 once per attention layer of every prefill, K4 once per attention
    layer of every decode step.  Returns the two-family run's launches."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.core.scheduler import make_policy
    from repro_torch.core.types import Application
    from repro_torch.serving.backends import ProfiledBackend
    from repro_torch.serving.runtime import LMExecutor
    from repro_torch.serving.server import EdgeServer

    rg, scout = "recurrentgemma-9b", "llama4-scout-17b-16e"
    variants = {rg: (ARCHS[rg], 5),
                scout: (dataclasses.replace(ARCHS[scout], num_layers=SCOUT_LAYERS), 6)}
    recalls = {rg: [0.90, 0.78], scout: [0.80, 0.93]}
    new_tokens = 16
    vocab = min(cfg.vocab_size for cfg, _ in variants.values())
    t0 = time.perf_counter()
    backend = ProfiledBackend(variants, new_tokens=new_tokens, device="cuda")
    warm = np.random.default_rng(args.seed).integers(0, vocab, (8, 512)).astype(np.int32)
    for rnd in range(3):
        if rnd == 1:
            backend.clear_observations()
            captured = backend.graph_stats()["captures"]
        timed = []
        for name in variants:
            for bsz in (8, 1):
                r = backend.run_batch(name, warm[:bsz], list(range(bsz)))
                timed.append(f"({name}, {bsz}, {r.prefill_s:.4f}, {r.decode_s:.4f})")
        print(f"    warm-up round {rnd + 1} (model, size, prefill s, decode s): " + " ".join(timed))
    require(backend.graph_stats()["captures"] == captured,
            "the two fitted rounds captured decode graphs; their steps must all replay")
    profiles = {name: backend.profile(name, recalls[name]) for name in variants}
    for p in profiles.values():
        fixed, per_item = p.latency_model
        print(f"  profile {p.name}: {fixed:.6f} s + {per_item:.6f} s per request "
              f"(512-token prompts, {new_tokens} new tokens), weights "
              f"{p.memory_bytes / 1e9:.3f} GB")
    print(f"    set-up (weights on the card, warm-up batches) {time.perf_counter() - t0:.2f} s")

    def layer_count(cfg, mixers):
        return sum(cfg.layer_kind(i).partition(":")[0] in mixers for i in range(cfg.num_layers))

    rec_layers = {n: layer_count(cfg, ("rglru",)) for n, (cfg, _) in variants.items()}
    attn_layers = {n: layer_count(cfg, ("attn", "local")) for n, (cfg, _) in variants.items()}
    sneak = serving_sneakpeek(args)

    def counted(label, names, rid0):
        app = Application(name="assistant", models=[profiles[n] for n in names],
                          penalty="sigmoid")
        server = EdgeServer({"assistant": app}, make_policy("SneakPeek"),
                            executor=LMExecutor(backend=backend),
                            sneakpeeks={"assistant": sneak},
                            prompt_fn=serving_prompt_fn(vocab), device="cuda")
        reqs = serving_trace(args, rid0, NEW_FAMILY_SLACK)
        torch.cuda.synchronize()
        graphs0 = backend.graph_stats()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t = time.perf_counter()
        outs, stats = server.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        graphs = {k: v - graphs0[k] for k, v in backend.graph_stats().items()}
        reports = [r for o in outs for r in (o["reports"] or [])]
        by_model = {n: sum(r.batch_size for r in reports if r.model == n) for n in variants}
        prefill_s = sum(r.prefill_s for r in reports)
        decode_s = sum(r.decode_s for r in reports)
        tokens = sum(r.tokens.size for r in reports)
        print(f"    {label}: windows={stats.windows} requests={stats.requests} "
              f"mean_utility={stats.mean_utility:.6f} violations={stats.violations} "
              f"swaps={stats.swaps} batches={len(reports)} requests per model {by_model}")
        print(f"    prefill {prefill_s:.6f} s, decode {decode_s:.6f} s, {tokens} tokens "
              f"generated, {tokens / (prefill_s + decode_s):.1f} tokens/s over execution; "
              f"wall {wall:.3f} s")
        print("    batches (model, size, prefill s, decode s): " + " ".join(
            f"({r.model}, {r.batch_size}, {r.prefill_s:.4f}, {r.decode_s:.4f})"
            for r in reports))
        print(f"    launches: {launches}")
        print(f"    peak device memory {peak / 1e9:.3f} GB (torch.cuda.max_memory_allocated); "
              f"decode graphs: {graphs['captures']} captured, {graphs['replays']} replays")
        want = {
            "rglru_scan": sum(rec_layers[r.model] * new_tokens for r in reports),
            "flash_attention": sum(attn_layers[r.model] for r in reports),
            "decode_attention": sum(attn_layers[r.model] * (new_tokens - 1) for r in reports),
        }
        for name, n in want.items():
            require(launches.get(name, 0) == n,
                    f"{label}: {name} launched {launches.get(name)} times, expected {n}")
        require(graphs["replays"] > 0, f"{label}: decode replayed no CUDA graph")
        require(stats.requests == len(reqs) and sum(by_model.values()) == len(reqs),
                f"{label}: not every request was served once")
        require(all(by_model[n] > 0 for n in names), f"{label}: a family served nothing")
        require(peak < 80e9, f"{label}: peak device memory {peak / 1e9:.3f} GB")
        for r in reports:
            require(r.tokens.shape == (r.batch_size, new_tokens), f"tokens {r.tokens.shape}")
            require(bool(((r.tokens >= 0) & (r.tokens < variants[r.model][0].vocab_size)).all()),
                    "token outside the vocab")
        print(f"    launch counts exact: {want}")
        return launches

    launches = counted("both families", list(variants), 140_000)
    for k, name in enumerate(variants):
        counted(f"{name} alone", [name], 150_000 + 10_000 * k)
    del backend
    return launches


def check_maverick(seed):
    """Phase 14 (c): llama4-maverick-400b-128e, one period (``attn:mlp`` at
    dense_d_ff 16,384, ``attn:moe`` with 128 experts) at full width in
    bf16, 37.4 GB, alone on the card: prefill of 2 x 512 tokens (two MoE
    groups), then 4 greedy steps replayed from a CUDA graph against the
    eager steps: logits within 1e-5 (the same kernels on the same
    inputs), the same tokens."""
    import dataclasses

    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.models import LM
    from repro_torch.serving.backends import DecodeGraph, bucket_capacity

    cfg = dataclasses.replace(ARCHS["llama4-maverick-400b-128e"], num_layers=2)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = LM(cfg)
    params = lm.init(seed=seed, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = torch.randint(0, cfg.vocab_size, (2, 512),
                           generator=torch.Generator().manual_seed(seed)).cuda()
    steps = 4
    capacity = bucket_capacity(512 + steps + 1)
    with torch.inference_mode():
        logits, cache = lm.prefill(params, tokens, max_len=capacity)
        require(bool(torch.isfinite(logits.float()).all()), "maverick: non-finite prefill logits")
        tok = logits.argmax(dim=-1, keepdim=True).to(torch.int32)
        dec = DecodeGraph(params, cfg, 2, capacity, torch.device("cuda", 0),
                          torch.cuda.graph_pool_handle(), torch.cuda.Stream())
        dec.load(cache, tok)
        errs = []
        for step in range(steps):
            dec.step()
            logits, cache = lm.decode_step(params, cache, tok)
            tok = logits.argmax(dim=-1, keepdim=True).to(torch.int32)
            errs.append(_close(dec.logits.float(), logits.float(), 1e-5,
                               f"maverick graphed logits, step {step}"))
            require(torch.equal(dec.tok, tok), f"maverick: graphed token differs at step {step}")
    require(dec.captures == 1 and dec.replays == steps - 1, "maverick: graph counts")
    peak = torch.cuda.max_memory_allocated()
    print(f"    maverick one period ({cfg.pattern}, 128 experts, dense_d_ff {cfg.dense_d_ff}), "
          f"bf16, weights made in {init_s:.2f} s: prefill 2 x 512 tokens, {steps} graphed steps "
          f"(1 capture, {dec.replays} replays) within 1e-5 of eager (max |d| {max(errs):.3g}), "
          f"same tokens; peak {peak / 1e9:.3f} GB")
    del lm, params, dec, cache


# Shard counts and chunks of phase 15 (b); the shard count of (a) and (c).
SHARD_COUNTS = (2, 4, 8)
SHARD_CHUNKS = (0, PIPELINE_CHUNK)
MAIN_SHARDS = 4


class ShardRoundCapture:
    """Records the arguments of every ``shard_round`` call the sharded
    selectors make while entered (``core.shard``'s ``score_block``,
    ``chain`` and ``accept``; a graph's replays call none), then restores
    them."""

    def __enter__(self):
        from repro_torch.core import shard as tshard

        self.score, self.chain, self.accept = [], [], []
        self._real = (tshard.score_block, tshard.chain, tshard.accept)

        def record(calls, real):
            def call(*a, **kw):
                calls.append((a, kw))
                return real(*a, **kw)
            return call

        tshard.score_block, tshard.chain, tshard.accept = (
            record(calls, real) for calls, real in zip((self.score, self.chain, self.accept),
                                                      self._real))
        return self

    def __exit__(self, *exc):
        from repro_torch.core import shard as tshard

        tshard.score_block, tshard.chain, tshard.accept = self._real
        return False


def _from_start(args, kw):
    """A recorded round call made to run from the window's first position:
    its position tensor replaced by a fresh 0 (the recorded one has reached
    the window's end) and its outputs by fresh ones."""
    import torch

    if kw.get("pos") is None:
        return args, kw
    kw = dict(kw, pos=torch.zeros_like(kw["pos"]))
    kw.pop("out", None)
    return args, kw


def _accept_fresh(args):
    """A recorded ``accept`` call on clones of the state it moves (position
    0, the carry, the rows and counts), so every call starts alike."""
    import torch

    pos, total, span, spec, val, t_st, r_st, sizes, cap, slot1, t, res, out, stats, m = args
    t, res = t.clone(), res.clone()
    if span == 1:  # the round's pre-state is the carry itself
        t_st, r_st = t[None], res[None]
    return (torch.zeros_like(pos), total, span, spec, val, t_st, r_st, sizes, cap, slot1, t, res,
            out.clone(), stats.clone(), m)


def _score_numbers(args, kw):
    """(bound ms, bound_by, shape) of one ``score_block`` call, counted as
    ``_scan_numbers`` counts a scan: each input the function needs read
    once — the rows' real members' accuracies and deadlines (none for
    fixed choices), the member counts of groups (B > 1), the rows'
    application ids and fixed choices, the distinct latency rows of the
    real models, the swap, id, validity, penalty and rank rows of the
    applications the rows use, the carry (one row when every row shares
    it) — and the (8, R) outputs written once; the operations are the
    Eq. 2 cells of the real members and models, SCAN_CELL_FLOPS each
    (MaxAcc: the completions' two adds)."""
    import numpy as np

    t, res, _, acc, _, _, bsize, lat, step_app, swap, gid, valid, pen, rank, *rest = args
    fixed = kw.get("fixed", rest[1] if len(rest) > 1 else None)
    if kw.get("pos") is not None:  # only the rows of the round the block holds
        p, lo, hi, row0 = int(kw["pos"].item()), kw["lo"], kw["hi"], kw["row0"]
        g0, g1 = max(p + lo, row0), min(p + hi, row0 + acc.shape[0], kw["total"])
        loc, rel = slice(g0 - row0, g1 - row0), slice(g0 - p - lo, g1 - p - lo)
        acc, bsize, lat, step_app = acc[loc], bsize[loc], lat[loc], step_app[loc]
        fixed = None if fixed is None else fixed[loc]
        t, res = t[rel], res[rel]
    rows, b_max, m = acc.shape
    n_w = lat.shape[1]
    n = bsize.cpu().numpy()
    app = step_app.cpu().numpy()
    m_valid = valid.cpu().numpy().sum(axis=1)  # real models per application
    mv = m_valid[app]
    used = np.unique(app)
    lat_rows = np.unique(np.column_stack([app, lat.cpu().numpy().reshape(rows, -1)]), axis=0)
    nbytes = 8 * (n_w * m_valid[lat_rows[:, 0].astype(np.int64)]).sum()  # distinct l(m, b)
    nbytes += 8 * (2 * n_w * m_valid[used] + m_valid[used] + 1).sum() + m_valid[used].sum()
    nbytes += 8 * rows * (1 + (fixed is not None) + (b_max > 1)) + 8 * 8 * rows
    shared = rows > 1 and t.stride(0) == 0
    nbytes += 8 * (1 if shared else rows) * (t.shape[1] + res.shape[1] * res.shape[2])
    if fixed is None:
        nbytes += 8 * ((n * mv).sum() + n.sum())  # real members' accuracies and deadlines
        ops = float((n_w * n * mv).sum()) * SCAN_CELL_FLOPS
    else:
        ops = 2.0 * rows * n_w * m
    byte_ms, op_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP64_FLOP_PER_S * 1e3
    shape = (f"R={rows} B={b_max} M={m} W={n_w} K={res.shape[2]}"
             f"{' shared carry' if shared else ''}")
    return float(max(byte_ms, op_ms)), "bytes" if byte_ms >= op_ms else "operations", shape


def score_rows(args, kw):
    """(workers, padded members, models) of a recorded ``score_block`` call."""
    acc, lat = args[3], args[7]
    return lat.shape[1], acc.shape[1], acc.shape[2]


def _accept_bytes(args) -> int:
    """Bytes one ``accept`` call must move, each read or written once: the
    picks of the positions it compares (cell of each; the accepted ones'
    effective swap and latency), their pre-state tails, the last accepted
    position's slots, id, raw swap and latency, the carry written, the
    accepted rows (4 float64 each), the position and counts."""
    pos, total, span, spec, val, t_st, r_st, sizes, cap, slot1, t, res, out, stats, m = args
    n_w, k = res.shape
    a = int(pos.item())  # the call ran from position 0: it accepted pos rows
    return (8 * span + 8 * 2 * a + 8 * a + 8 * (k + 3) + 8 * (n_w + n_w * k) + 32 * a
            + 8 * 2 + 8 * 4)


def check_shard_round(apps, reqs, now):
    """Phase 15 (a): ``shard_round`` against its plain version on the card,
    on the calls the sharded selectors make for phase 5's first window at
    MAIN_SHARDS shards, ``chunk=0`` — LO-EDF's per-request rows, SneakPeek's
    grouped rows, SneakPeek on four workers — each with the single-slot
    and the LRU carry: the first speculation's ``score_block`` (the
    largest block), the longest ``chain`` and the widest ``accept``, each
    run from the window's first position, every output bit-identical.
    Times each on the device (its kernel only) and the plain version on
    the card, and works out the bounds: the block's bytes and operations,
    and the chain's dependent operations (the completion's two adds and
    the carry's store per position, F64_DEP_CYCLES each, as phase 12 (a)
    counts a fixed-choice step)."""
    import torch

    from repro_torch.core import shard as tshard
    from repro_torch.core.multiworker import Worker
    from repro_torch.core.scheduler import make_policy, schedule_window
    from repro_torch.core.streaming import StreamingState
    from repro_torch.kernels.shard_round import ops as shard_ops
    from repro_torch.kernels.shard_round.ref import accept_ref, chain_ref, score_block_ref

    clock = sm_clock_hz()
    pool = [Worker(0), Worker(1, speed=2.0), Worker(2, speed=0.5), Worker(3, load_scale=2.0)]
    out = {}
    prev = tshard.force_shard_devices(MAIN_SHARDS)
    try:
        for res_mode, cap in (("slot1", None), ("lru", 400 * 2**20)):
            for label, policy, workers in (("LO-EDF", "LO-EDF", None),
                                           ("SneakPeek", "SneakPeek", None),
                                           ("SneakPeek on 4 workers", "SneakPeek", pool)):
                state = None
                if cap is not None:
                    state = StreamingState(
                        worker_ids=[w.wid for w in workers] if workers else None,
                        memory_capacity_bytes=cap)
                with ShardRoundCapture() as calls:
                    schedule_window(make_policy(policy, shard=MAIN_SHARDS), reqs, apps, now,
                                    workers=workers, state=state, device="cuda")
                s_args, s_kw = _from_start(*max(calls.score, key=lambda c: c[0][3].shape[0]))
                a_args = max(calls.accept, key=lambda c: c[0][2])[0]
                got = shard_ops.score_block(*s_args, **s_kw)
                torch.cuda.synchronize()
                t = time.perf_counter()
                want = score_block_ref(*s_args, **s_kw)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t) * 1e3
                require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                        f"{label}, {res_mode}: score_block differs from its plain version")
                # Rounds of one position (the pool's placement at chunk 0) chain
                # nothing: the accept moves the carry.
                n_pos, chain_ms, chain_plain_ms, chain_bound = 0, None, None, None
                if calls.chain:
                    c_args, c_kw = _from_start(*max(calls.chain, key=lambda c: c[0][5].shape[0]))
                    got_c = shard_ops.chain(*c_args, **c_kw)
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    want_c = chain_ref(*c_args, **c_kw)
                    torch.cuda.synchronize()
                    chain_plain_ms = (time.perf_counter() - t) * 1e3
                    require(torch.equal(got_c[0], want_c[0]) and torch.equal(got_c[1], want_c[1]),
                            f"{label}, {res_mode}: chain differs from its plain version")
                    chain_ms = device_ms(lambda: shard_ops.chain(*c_args, **c_kw),
                                         "shard_round_chain", iters=5)
                    n_pos = c_args[5].shape[0]
                    chain_bound = 3.0 * n_pos * F64_DEP_CYCLES / clock * 1e3
                got_a, want_a = _accept_fresh(a_args), _accept_fresh(a_args)
                shard_ops.accept(*got_a)
                torch.cuda.synchronize()
                t = time.perf_counter()
                accept_ref(*want_a)
                torch.cuda.synchronize()
                accept_plain_ms = (time.perf_counter() - t) * 1e3
                moved = (0, 10, 11, 12, 13)  # pos, t, res, out, stats
                require(all(torch.equal(got_a[i], want_a[i]) for i in moved),
                        f"{label}, {res_mode}: accept differs from its plain version")
                ms = device_ms(lambda: shard_ops.score_block(*s_args, **s_kw),
                               "shard_round_score", iters=5)
                accept_ms = device_ms(lambda: shard_ops.accept(*_accept_fresh(a_args)),
                                      "shard_round_accept", iters=5)
                bound_ms, bound_by, shape = _score_numbers(s_args, s_kw)
                accept_bound = _accept_bytes(got_a) / HBM_BYTES_PER_S * 1e3
                rows = score_rows(s_args, s_kw)
                out[f"{label}, {res_mode}"] = {
                    "shape": shape, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "max_abs_err": 0.0, "library_ms": None,
                    "instance": shard_ops.score_instance(*rows),
                    "cluster_blocks": shard_ops.score_blocks(*rows),
                    "chain_positions": n_pos, "chain_ms": chain_ms,
                    "chain_plain_ms": chain_plain_ms, "chain_bound_ms": chain_bound,
                    "accept_span": a_args[2], "accept_ms": accept_ms,
                    "accept_plain_ms": accept_plain_ms, "accept_bound_ms": accept_bound,
                    "calls": (len(calls.score), len(calls.chain), len(calls.accept))}
                chain_text = ("no chain (rounds of one position)" if not n_pos else
                              f"chain {chain_ms:.6f} ms, plain {chain_plain_ms:.3f} ms, dependent "
                              f"chain {chain_bound:.6f} ms")
                print(f"    {label}, {res_mode}: score_block ({shape}, "
                      f"{out[f'{label}, {res_mode}']['instance']} instance, "
                      f"{out[f'{label}, {res_mode}']['cluster_blocks']} block(s) a row), chain "
                      f"({n_pos} positions) and accept ({a_args[2]} positions) bit-identical to "
                      f"their plain versions; score_block {ms:.6f} ms on the device, plain "
                      f"{plain_ms:.3f} ms, bound {bound_ms:.6f} ms ({bound_by}); {chain_text}; "
                      f"accept {accept_ms:.6f} ms, plain "
                      f"{accept_plain_ms:.3f} ms, bound {accept_bound:.6f} ms (bytes); the window "
                      f"made {len(calls.score)} score_block, {len(calls.chain)} chain and "
                      f"{len(calls.accept)} accept calls")
    finally:
        tshard.force_shard_devices(prev)
    return out


def _sched_sig(sched):
    return [(e.request.rid, e.model, e.order, e.batch_id, e.worker, e.est_start_s,
             e.est_latency_s) for e in sched.sorted_entries()]


def check_sharded_selectors(apps, reqs, now):
    """Phase 15 (b): the sharded selectors on the card at SHARD_COUNTS
    shard blocks (``force_shard_devices``), ``chunk`` 0 and 16, the
    single-slot and the LRU carry, on phase 12 (a)'s three shapes: every
    schedule (workers, models, starts, latencies) equal to the unsharded
    route's on the card (``selection_scan`` / ``spec_scan``) and its
    ``chunk_stats`` too; at MAIN_SHARDS shards, on one chunk per shape, the
    shard stats equal the same selector's on the host.  Returns {case:
    (seconds per window, shard_round launches, shard stats, read-backs)}."""
    import torch

    from repro_torch.core import shard as tshard
    from repro_torch.core.multiworker import Worker
    from repro_torch.core.scheduler import make_policy, schedule_window
    from repro_torch.core.streaming import StreamingState
    from repro_torch.kernels.shard_round import ops as shard_ops

    pool = [Worker(0), Worker(1, speed=2.0), Worker(2, speed=0.5), Worker(3, load_scale=2.0)]
    # The chunk whose host run is compared, per shape: the plain chain
    # takes milliseconds a position on the host.
    host_chunk = {"LO-EDF": PIPELINE_CHUNK, "SneakPeek": 0,
                  "SneakPeek on 4 workers": PIPELINE_CHUNK}
    out = {}
    prev = tshard.force_shard_devices(max(SHARD_COUNTS))
    try:
        for res_mode, cap in (("slot1", None), ("lru", 400 * 2**20)):
            for label, policy, workers in (("LO-EDF", "LO-EDF", None),
                                           ("SneakPeek", "SneakPeek", None),
                                           ("SneakPeek on 4 workers", "SneakPeek", pool)):
                state = None
                if cap is not None:
                    state = StreamingState(
                        worker_ids=[w.wid for w in workers] if workers else None,
                        memory_capacity_bytes=cap)
                for chunk in SHARD_CHUNKS:
                    want, _ = schedule_window(make_policy(policy, pipeline=True, chunk=chunk),
                                              reqs, apps, now, workers=workers, state=state,
                                              device="cuda")
                    for shards in SHARD_COUNTS:
                        pipe = tshard.ShardedWindowPipeline(
                            apps, policy=make_policy(policy, pipeline=True), workers=workers,
                            chunk=chunk, shard=shards, device="cuda")
                        torch.cuda.synchronize()
                        before = shard_ops.counter.count
                        t = time.perf_counter()
                        got = pipe.schedule(reqs, now, state=state)
                        torch.cuda.synchronize()
                        secs = time.perf_counter() - t
                        launched = shard_ops.counter.count - before
                        key = f"{label}, {res_mode}, chunk {chunk}, {shards} shards"
                        require(_sched_sig(got) == _sched_sig(want),
                                f"{key}: the sharded schedule differs from the unsharded one")
                        require(got.chunk_stats == want.chunk_stats,
                                f"{key}: chunk stats {got.chunk_stats} != {want.chunk_stats}")
                        require(launched > 0, f"{key}: no shard_round launch")
                        stats = pipe.last_shard_stats
                        if shards == MAIN_SHARDS and chunk == host_chunk[label]:
                            host = tshard.ShardedWindowPipeline(
                                apps, policy=make_policy(policy, pipeline=True),
                                workers=workers, chunk=chunk, shard=shards, device="cpu")
                            host.schedule(reqs, now, state=state)
                            require(host.last_shard_stats == stats,
                                    f"{key}: shard stats {stats} != the host's "
                                    f"{host.last_shard_stats}")
                        out[key] = (secs, launched, stats, pipe.last_read_backs)
                        print(f"    {key}: equal to the unsharded route; {secs:.4f} s, "
                              f"{launched} shard_round launches, {pipe.last_read_backs} "
                              f"read-backs of the position, {stats}"
                              + (" = the host's" if shards == MAIN_SHARDS
                                 and chunk == host_chunk[label] else ""))
    finally:
        tshard.force_shard_devices(prev)
    return out


def check_sharded_simulation(apps, sneaks, trace, seed, want_sigs):
    """Phase 15 (c): ``Simulation(shard=MAIN_SHARDS, chunk=16)`` over phase
    5's trace on the card (shard blocks sharing it): every window's
    schedule equal to phase 12 (b)'s SneakPeek schedules (``want_sigs``),
    counts set to 0 just before and read just after, ``shard_round``
    launched and no scan; then ``shard=1`` launching exactly what
    ``pipeline=True`` launches, and no ``shard_round``; then ``shard=True``
    on every card of the host: on one card the same delegation, on several
    one shard per card, ``shard_round`` launched on each and the same
    schedules.  Returns (the sharded run's launches, its scheduling seconds
    per window)."""
    import torch

    from repro_torch import kernels
    from repro_torch.core import shard as tshard
    from repro_torch.core import simulator as tsim
    from repro_torch.core.scheduler import make_policy

    def run(**kwargs):
        seen, real_eval = [], tsim.evaluate

        def spy(sched, *a, **kw):
            seen.append(_sched_sig(sched))
            return real_eval(sched, *a, **kw)

        tsim.evaluate = spy
        try:
            sim = tsim.Simulation(make_policy("SneakPeek"), apps, sneakpeeks=sneaks,
                                  short_circuit=True, seed=seed, chunk=PIPELINE_CHUNK,
                                  device="cuda", **kwargs)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            sim.run(trace)
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
        finally:
            tsim.evaluate = real_eval
        return sim, seen, {k: n for k, n in launches.items() if n}

    prev = tshard.force_shard_devices(MAIN_SHARDS)
    try:
        sim, seen, launches = run(shard=MAIN_SHARDS)
    finally:
        tshard.force_shard_devices(prev)
    require(seen == want_sigs, f"shard={MAIN_SHARDS}: schedules differ from phase 12 (b)'s")
    require(launches.get("shard_round", 0) > 0 and not launches.get("spec_scan")
            and not launches.get("selection_scan"),
            f"shard={MAIN_SHARDS}: launches {launches}")
    seconds = [row["overhead_s"] for row in sim.log]
    print(f"    shard={MAIN_SHARDS}: {len(seen)} windows equal to phase 12 (b)'s; launches "
          f"{launches}; shard stats of the last window {sim._pipeline.last_shard_stats}")
    print("      scheduling s per window: " + " ".join(f"{x:.4f}" for x in seconds))
    _, pipe_seen, pipe_launches = run(pipeline=True)
    one, one_seen, one_launches = run(shard=1)
    require(one._pipeline.num_shards() == 1 and one_seen == pipe_seen == want_sigs
            and one_launches == pipe_launches and "shard_round" not in one_launches,
            f"shard=1 launched {one_launches}, pipeline=True {pipe_launches}")
    every, every_seen, every_launches = run(shard=True)
    n_dev = torch.cuda.device_count()
    require(every._pipeline.num_shards() == n_dev, f"shard=True resolved to "
            f"{every._pipeline.num_shards()} shards on {n_dev} device(s)")
    require(every_seen == want_sigs, "shard=True schedules differ")
    if n_dev == 1:  # one device: one shard, delegated
        require(every_launches == pipe_launches,
                f"shard=True launched {every_launches}, pipeline=True {pipe_launches}")
    else:  # one shard per card, the blocks copied between them
        require(every_launches.get("shard_round", 0) > 0 and not every_launches.get("spec_scan"),
                f"shard=True on {n_dev} devices launched {every_launches}")
    print(f"    shard=1: the same schedules and launches as pipeline=True: {one_launches}; "
          f"shard=True on {n_dev} device(s): {n_dev} shard(s), the same schedules, launches "
          f"{every_launches}")
    return launches, seconds


# ---------------------------------------------------------------- phase 16: training

K3B_STAGES = ("flash_attention_bwd_dot", "flash_attention_bwd_dkdv", "flash_attention_bwd_dq")
K5B_STAGES = ("ssd_chunk_bwd_scores", "ssd_chunk_bwd_dstate", "ssd_chunk_bwd_pass",
              "ssd_chunk_bwd_dx", "ssd_chunk_bwd_dscores", "ssd_chunk_bwd_dbc",
              "ssd_chunk_bwd_dcum", "ssd_chunk_bwd_dgsum", "ssd_chunk_bwd_dbm_dcm")
# The first designs' times (fp32 on the CUDA cores) at phase 16 (a)'s
# shapes, from PERF.md's kernel table (NVIDIA H100 80GB HBM3, 700.00 W),
# printed in brackets beside this run's times; the f32 one the first f32
# design's last measured time (PR 32's run).
K3B_FIRST_MS = {"tinyllama": 7.091728, "f32": 7.176184, "llama4": 5.685508, "windowed": 5.121812}
K5B_FIRST_MS = 2.239300
# K3b at head dim 256 (batch, length, query heads, KV heads, window, dtype):
# gemma-7b's training shape (MHA), recurrentgemma-9b's training shape (16
# over 1 at B = 8, S = 1024, where its 2048 window does not bind: causal),
# its local layers at S = 4096 (a window that binds), gemma3-4b's local
# layers (8 over 4, window 1024), and float32 at gemma-7b's width.
K3B_D256_SHAPES = {"gemma7b": (8, 1024, 16, 16, 0, "bfloat16"),
                   "recurrentgemma_train": (8, 1024, 16, 1, 2048, "bfloat16"),
                   "recurrentgemma_local": (2, 4096, 16, 1, 2048, "bfloat16"),
                   "gemma3": (2, 2048, 8, 4, 1024, "bfloat16"),
                   "f32_d256": (1, 1024, 16, 16, 0, "float32")}
# The first bf16 design's times at head dim 256 (mma.sync; its chip_smoke.py run, NVIDIA
# H100 80GB HBM3, 700.00 W; PERF.md), and the first f32 design's (CUDA
# cores, PR 32's run), printed in brackets beside this run's.
K3B_D256_FIRST_MS = {"gemma7b": 1.682459, "recurrentgemma_local": 5.177276,
                     "gemma3": 0.687855, "f32_d256": 3.207369}
# rglru_scan_bwd's cases (batch, length, LRU width, dtype, h0, dh_last):
# recurrentgemma-9b's training shape (timed), a length off a multiple of the
# chunk, one below a chunk, and float32 with both states given.
RGLRU_BWD_CASES = {"train": (8, 1024, 4096, "bfloat16", False, False),
                   "ragged": (2, 300, 512, "bfloat16", True, False),
                   "one_chunk": (3, 40, 256, "bfloat16", False, True),
                   "f32": (2, 300, 200, "float32", True, True)}
# Its tolerances against the plain reverse loop (tests/test_torch_cuda.py).
RGLRU_BWD_TOL = {"float32": (1e-4, 1e-3), "bfloat16": (2e-2, 2e-2)}
RGLRU_BWD_PARTS = ("rglru_bwd_chain", "rglru_bwd_reduce")
# Its first design's time at the training shape (three kernels; its chip_smoke.py run,
# NVIDIA H100 80GB HBM3, 700.00 W; PERF.md), printed in brackets.
RGLRU_BWD_FIRST_MS = 0.442952
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
MAMBA_STEPS, MAMBA_FAULT_AT, TINY_STEPS = 30, 15, 20
# The two families trained through make_train_step at published widths and
# cut depths.  At the update one card holds the weights, the gradients, the
# stacked trees and AdamW's fp32 master and two moments, old and new side
# by side: about 35 bytes a parameter at the peak on the H100, beside the
# 4.2 GB logit chunks of a 256,000-token vocabulary.  So recurrentgemma-9b
# runs its one period (3 of 38 layers: rglru, rglru, local; 1.64 B
# parameters) and gemma-7b 3 of 28 layers (1.62 B; 4 layers, 1.89 B, would
# need about 66 GB).  Each with its learning rate: gemma-7b's loss rose
# at the other runs' 1e-3 (last 5 steps' mean 13.022 against the first
# step's 12.931 over 12 steps, NVIDIA H100 80GB HBM3, 700.00 W), so it
# takes 3e-4.  It rises as much with the attention backward through K3b's
# plain version (benchmarks/torch_kernel_probe.py k3b-train: 24 steps at
# 1e-3, last 5 means 13.539 through K3b and 13.477 through the plain
# version, the first step's gradients within 0.7 % of each other, same
# card): the model and optimizer's, not the kernel's.
NEW_TRAIN = {"recurrentgemma-9b": (3, 1e-3), "gemma-7b": (3, 3e-4)}
# Their tokens/s with the first designs of both kernels (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md),
# printed beside this run's.
NEW_TRAIN_FIRST_TOKENS_PER_S = {"recurrentgemma-9b": 18947.6, "gemma-7b": 21643.9}
NEW_TRAIN_STEPS = 12
TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd", "ssd", "ssd_bwd", "rglru_scan",
                 "rglru_scan_bwd")


def _flash_bwd_plain(q, k, v, o, do, lse, window, rounding=None):
    """K3b's plain version, model layout in and out (``rounding``: that of
    ``flash_attention_bwd_ref``)."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref

    b, sq, hq, d = q.shape
    hkv = k.shape[2]

    def gqa(t):
        return t.reshape(b, sq, hkv, hq // hkv, d).permute(0, 2, 3, 1, 4)

    dq, dk, dv = flash_attention_bwd_ref(gqa(q), k.transpose(1, 2), v.transpose(1, 2), gqa(o),
                                         gqa(do), lse.reshape(b, hkv, hq // hkv, sq),
                                         window=window, rounding=rounding)
    return dq.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d), dk.transpose(1, 2), dv.transpose(1, 2)


def _flash_bwd_case(gen, b, s, hq, hkv, d, window, dtype, timed=False, plain_once=False):
    """K3b at one shape against its plain version on the same forward
    output and logsumexp, and two calls bit-identical; with ``timed``, its
    device time (and by kernel),
    the plain version's (one call, not warmed up, with ``plain_once``),
    SDPA's backward (forward and backward less the forward; with a window,
    through a boolean causal-and-window mask) and the bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as flash_ops

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q, k, v, do = randn(b, s, hq, d), randn(b, s, hkv, d), randn(b, s, hkv, d), randn(b, s, hq, d)
    name = str(dtype).split(".")[1]
    out, lse = flash_ops.flash_attention(q, k, v, window=window, return_lse=True)
    grads = flash_ops.flash_attention_bwd(q, k, v, out, do, lse, window=window)
    again = flash_ops.flash_attention_bwd(q, k, v, out, do, lse, window=window)
    require(all(torch.equal(x, y) for x, y in zip(grads, again)),
            f"K3b {(b, s, hq, hkv, d, window)} {dtype}: two calls differ")
    del again
    refs = _flash_bwd_plain(q, k, v, out, do, lse, window)
    err = max(_close(g, r, ATTN_TOL[name], f"K3b {name} {(b, s, hq, hkv, d, window)} {n}")
              for n, g, r in zip(("dq", "dk", "dv"), grads, refs))
    t = {"max_abs_err": err,
         "shape": f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} {name} causal"
                  + (f" window={window}" if window else "")}
    if not timed:
        return t
    del grads, refs
    pos = torch.arange(s, device="cuda")
    keys = int((torch.clamp(pos + 1, max=window) if window else pos + 1).sum())
    flops = 10 * b * hq * keys * d  # five products over the visible (query, key) pairs
    item = q.element_size()
    # q, o, dO read and dq written (Hq wide); k, v read and dk, dv written
    # (Hkv wide); the float32 logsumexp read
    bytes_moved = item * (4 * b * s * hq * d + 4 * b * s * hkv * d) + 4 * b * hq * s
    ops_s = flops / BF16_FLOP_PER_S if dtype == torch.bfloat16 else f32_ops_s(flops)
    call = lambda: flash_ops.flash_attention_bwd(q, k, v, out, do, lse, window=window)  # noqa: E731
    plan = flash_ops.bwd_plan(b, s, hq, hkv, d, dtype,
                              torch.cuda.get_device_properties(0).multi_processor_count)
    parts = K3B_STAGES + (("flash_attention_bwd_sum",) if plan["groups"] > 1 else ())
    ms, stage_ms = device_ms(call, "flash_attention_bwd", iters=5, parts=parts)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2)

    if window:
        mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < window)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)
    else:
        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

    t.update({
        "ms": ms, "stage_ms": stage_ms, "head_groups": plan["groups"],
        "plain_ms": timed_ms(lambda: _flash_bwd_plain(q, k, v, out, do, lse, window),
                             iters=1 if plain_once else 2, warmup=0 if plain_once else 1),
        "library_ms": timed_ms(sdpa_fwd_bwd, iters=10) - timed_ms(sdpa, iters=10),
        "bound_ms": max(ops_s, bytes_moved / HBM_BYTES_PER_S) * 1e3,
        "bound_by": "operations" if ops_s > bytes_moved / HBM_BYTES_PER_S else "bytes",
    })
    return t


def _ssd_bwd_flops(b, s, h, p, n, chunk, g=1):
    """The multiply-adds K5b's stages do, times 2: per (batch row, chunk,
    group) the scores and the two d(scores) products over the lower 64 x 64
    tiles; per head dE, the two products of dx, d(scores) and the two of
    dC/dB."""
    nc, nt = s // chunk, -(-chunk // 64)
    tiles = nt * (nt + 1) // 2
    per_chunk = 2 * g * (tiles * 64 * 64 * n + 2 * tiles * 64 * 64 * n)
    per_head = 2 * (chunk * p * n + sum(chunk - 64 * j for j in range(nt)) * 64 * p
                    + chunk * n * p + tiles * 64 * 64 * p + 2 * chunk * p * n)
    return b * nc * per_chunk + b * nc * h * per_head


def check_backward_kernels(seed):
    """Phase 16 (a): K3b and K5b against their plain versions at the
    training shapes, each timed beside its plain version and its bound."""
    import torch

    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_chunk_bwd_ref
    from repro_torch.models.ssd import ssd_scan

    gen = torch.Generator(device="cuda").manual_seed(seed + 16)
    k3b = _flash_bwd_case(gen, 8, 1024, 32, 4, 64, 0, torch.bfloat16, timed=True)
    print(f"  K3b tinyllama shape {k3b['shape']}: dq, dk, dv within 2e-2 of the plain version, "
          f"max |d| {k3b['max_abs_err']:.3g}; two calls bit-identical; {k3b['ms']:.6f} ms "
          f"[first design: {K3B_FIRST_MS['tinyllama']}]")
    k3b["f32"] = _flash_bwd_case(gen, 8, 1024, 32, 4, 64, 0, torch.float32, timed=True)
    k3b["llama4"] = _flash_bwd_case(gen, 2, 1024, 40, 8, 128, 0, torch.bfloat16, timed=True)
    k3b["windowed"] = _flash_bwd_case(gen, 2, 2048, 32, 4, 64, 1024, torch.bfloat16, timed=True)
    for key in ("f32", "llama4", "windowed"):
        print(f"  K3b {k3b[key]['shape']}: within {2e-5 if key == 'f32' else 2e-2}, max |d| "
              f"{k3b[key]['max_abs_err']:.3g}; two calls bit-identical; {k3b[key]['ms']:.6f} ms "
              f"[first design: {K3B_FIRST_MS[key]}]")
    for key, (b, s, hq, hkv, window, dtype) in K3B_D256_SHAPES.items():
        k3b[key] = t = _flash_bwd_case(gen, b, s, hq, hkv, 256, window, getattr(torch, dtype),
                                       timed=True, plain_once=key == "recurrentgemma_train")
        first = K3B_D256_FIRST_MS.get(key)
        print(f"  K3b {t['shape']}: within {ATTN_TOL[dtype]}, max |d| {t['max_abs_err']:.3g}; "
              f"two calls bit-identical; {t['ms']:.6f} ms on the device"
              + (f" [first design: {first}]" if first else "") + " ("
              + ", ".join(f"{k.removeprefix('flash_attention_bwd_')} {v:.6f}"
                          for k, v in t["stage_ms"].items())
              + f"; {t['head_groups']} head group{'s' if t['head_groups'] > 1 else ''}), bound "
              f"{t['bound_ms']:.6f} ms ({t['bound_by']}), SDPA backward "
              f"{t['library_ms']:.6f} ms, plain {t['plain_ms']:.3f} ms")
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()

    b, s, h, p, n, chunk = 8, 1024, 24, 64, 128, 128
    x, dt, a_log, bm, cm = _ssd_inputs(gen, b, s, h, p, n)
    dA = (dt * -torch.exp(a_log)).contiguous()
    xdt = (x * dt[..., None]).contiguous()
    dy = torch.randn((b, s, h, p), generator=gen, device="cuda")
    _, _, cum, entering = ssd_ops.ssd_chunk_scan_saving(xdt, dA, bm, cm, chunk)
    grads = ssd_ops.ssd_chunk_bwd(xdt, bm, cm, dy, cum, entering, chunk)
    again = ssd_ops.ssd_chunk_bwd(xdt, bm, cm, dy, cum, entering, chunk)
    require(all(torch.equal(x, y) for x, y in zip(grads, again)), "K5b: two calls differ")
    del again
    refs = ssd_chunk_bwd_ref(xdt, bm, cm, dy, cum, entering, chunk)
    errs = {name: _close(g, r, SSD_ATOL, f"K5b {name}", SSD_RTOL)
            for name, g, r in zip(("dxdt", "ddA", "dbm", "dcm"), grads, refs)}
    del grads, refs
    print("  K5b mamba2 shape, gradient by gradient within atol 2e-4, rtol 1e-3, max |d|: "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + "; two calls bit-identical")
    call = lambda: ssd_ops.ssd_chunk_bwd(xdt, bm, cm, dy, cum, entering, chunk)  # noqa: E731
    ms, stage_ms = device_ms(call, "ssd_chunk_bwd", iters=5, parts=K5B_STAGES)
    flops = _ssd_bwd_flops(b, s, h, p, n, chunk)
    bytes_moved = 4 * (2 * b * s * h * p + 2 * b * s * n + b * h * s + b * h * p * n * (s // chunk)
                       + b * s * h * p + b * s * h + 2 * b * s * n)
    # K5b must keep fp32 accuracy (fault P3), so its least time is that of
    # the faster fp32-accurate route for its products: three TF32 passes of
    # an error-compensated split at the TF32 tensor-core peak, or one fp32
    # pass at the CUDA cores'; or its inputs' and outputs' bytes, if larger.
    ops_s = f32_ops_s(flops)
    k5b = {
        "ms": ms, "stage_ms": stage_ms,
        "plain_ms": timed_ms(lambda: ssd_chunk_bwd_ref(xdt, bm, cm, dy, cum, entering, chunk),
                             iters=2, warmup=1),
        "library_ms": None,  # no single PyTorch call computes the SSD scan's gradient
        "bound_ms": max(ops_s, bytes_moved / HBM_BYTES_PER_S) * 1e3,
        "bound_by": "operations" if ops_s > bytes_moved / HBM_BYTES_PER_S else "bytes",
        "max_abs_err": max(errs.values()),
        "shape": f"B={b} S={s} H={h} P={p} N={n} chunk={chunk} f32",
    }
    print(f"  K5b: {flops / 1e9:.3f} GFLOP, {bytes_moved / 1e6:.1f} MB; {ms:.6f} ms [first design: "
          f"{K5B_FIRST_MS}], bound {k5b['bound_ms']:.6f} ms (3xTF32); device ms by kernel: "
          + ", ".join(f"{k.removeprefix('ssd_chunk_bwd_')} {v:.6f}" for k, v in stage_ms.items()))
    # B and C of 2 and 4 groups: d(scores), dB and dC summed over a group's
    # heads in head order, no atomics.
    k5b["groups"] = {}
    for g in SSD_GROUPS:
        bg, cg = (torch.randn((b, s, g, n), generator=gen, device="cuda") * 0.3
                  for _ in range(2))
        _, _, cum, entering = ssd_ops.ssd_chunk_scan_saving(xdt, dA, bg, cg, chunk)
        grads = ssd_ops.ssd_chunk_bwd(xdt, bg, cg, dy, cum, entering, chunk)
        again = ssd_ops.ssd_chunk_bwd(xdt, bg, cg, dy, cum, entering, chunk)
        require(all(torch.equal(x, y) for x, y in zip(grads, again)),
                f"K5b with {g} groups: two calls differ")
        refs = ssd_chunk_bwd_ref(xdt, bg, cg, dy, cum, entering, chunk)
        gerrs = {name: _close(gr, r, SSD_ATOL, f"K5b {g} groups {name}", SSD_RTOL)
                 for name, gr, r in zip(("dxdt", "ddA", "dbm", "dcm"), grads, refs)}
        del grads, again, refs
        call = lambda: ssd_ops.ssd_chunk_bwd(xdt, bg, cg, dy, cum, entering, chunk)  # noqa: E731
        gms, gstage = device_ms(call, "ssd_chunk_bwd", iters=5, parts=K5B_STAGES)
        gflops = _ssd_bwd_flops(b, s, h, p, n, chunk, g)
        gbytes = bytes_moved + 4 * 4 * b * s * (g - 1) * n
        gops = f32_ops_s(gflops)
        k5b["groups"][g] = {
            "ms": gms, "stage_ms": gstage,
            "plain_ms": timed_ms(lambda: ssd_chunk_bwd_ref(xdt, bg, cg, dy, cum, entering,
                                                           chunk), iters=2, warmup=1),
            "library_ms": None,
            "bound_ms": max(gops, gbytes / HBM_BYTES_PER_S) * 1e3,
            "bound_by": "operations" if gops > gbytes / HBM_BYTES_PER_S else "bytes",
            "max_abs_err": max(gerrs.values()), "shape": f"{k5b['shape']} G={g}",
        }
        print(f"  K5b with {g} groups: gradient by gradient within atol 2e-4, rtol 1e-3, max "
              "|d|: " + ", ".join(f"{k} {v:.3g}" for k, v in gerrs.items())
              + f"; two calls bit-identical; {gms:.6f} ms on the device (one group {ms:.6f}), "
              f"bound {k5b['groups'][g]['bound_ms']:.6f} ms; by kernel: "
              + ", ".join(f"{k.removeprefix('ssd_chunk_bwd_')} {v:.6f}"
                          for k, v in gstage.items()))
        del bg, cg, cum, entering
    del x, dt, a_log, bm, cm, dA, xdt, dy

    # A length padded with dt = 0, through models.ssd's autograd function
    # (K5 then K5b): every input's gradient, card against host.
    x, dt, a_log, bm, cm = _ssd_inputs(gen, 2, 300, h, p, n)
    dy = torch.randn((2, 300, h, p), generator=gen, device="cuda")
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.detach().to(dev).requires_grad_() for t in (x, dt, a_log, bm, cm)]
        xx, dd, al, bb, cc = leaves
        y, _ = ssd_scan(xx, dd, -torch.exp(al), bb[:, :, None], cc[:, :, None], chunk)
        (y * dy.to(dev)).sum().backward()
        grads[dev] = [t.grad.cpu() for t in leaves]
    err = max(_close(g, r, SSD_ATOL, f"K5b padded {name}", SSD_RTOL)
              for name, g, r in zip(("x", "dt", "a_log", "B", "C"), grads["cuda"], grads["cpu"]))
    print(f"  K5b through models.ssd.ssd_scan, B=2 S=300 (padded to 384 with dt = 0): the "
          f"gradients of x, dt, a_log, B and C card against host, max |d| {err:.3g}")
    return k3b, k5b, check_rglru_backward(gen)


def check_rglru_backward(gen):
    """Phase 16 (a): ``rglru_scan_bwd`` against ``rglru_scan_bwd_ref`` on
    the card at ``RGLRU_BWD_CASES``, on the carries the forward kept: all
    eight gradients within ``RGLRU_BWD_TOL``, one launch a call, two calls
    bit-identical; the training shape timed, kernel by kernel, beside the
    plain version and the bytes bound (u, gpre and dy read, du and dgpre
    written, the carries and vectors besides); then the model's autograd
    function (``rglru_scan_autograd``: the forward kernel keeping its
    carries, then the backward) card against host at recurrentgemma-9b's
    width in float32."""
    import torch

    from repro_torch.kernels.rglru_scan import ops as rglru_ops
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_bwd_ref

    names = ("du", "dgpre", "da_w", "da_b", "dx_w", "dx_b", "dlam", "dh0")
    out = {}
    for key, (b, s, width, dtype, with_h0, with_dh) in RGLRU_BWD_CASES.items():
        dt = getattr(torch, dtype)

        def randn(*shape, scale=1.0):
            return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dt)

        u, gp, dy = randn(b, s, width), randn(b, s, width), randn(b, s, width)
        vecs = [randn(width, scale=0.5) for _ in range(5)]
        h0 = torch.randn((b, width), generator=gen, device="cuda") if with_h0 else None
        dh = torch.randn((b, width), generator=gen, device="cuda") if with_dh else None
        _, _, carries = rglru_ops.rglru_scan_saving(u, gp, *vecs, h0)
        before = rglru_ops.bwd_counter.count
        got = rglru_ops.rglru_scan_bwd(u, gp, *vecs, carries, dy, dh, want_dh0=with_h0)
        again = rglru_ops.rglru_scan_bwd(u, gp, *vecs, carries, dy, dh, want_dh0=with_h0)
        torch.cuda.synchronize()
        launched = rglru_ops.bwd_counter.count - before
        require(launched == 2, f"rglru_scan_bwd {key}: {launched} launches for 2 calls")
        require(all(x is None or torch.equal(x, y) for x, y in zip(got, again)),
                f"rglru_scan_bwd {key}: two calls differ")
        del again
        want = rglru_scan_bwd_ref(u, gp, *vecs, dy, h0=h0, dh_last=dh)
        atol, rtol = RGLRU_BWD_TOL[dtype]
        errs = {n: _close(x, r, atol, f"rglru_scan_bwd {key} {n}", rtol)
                for n, x, r in zip(names, got, want) if r is not None}
        shape = f"B={b} S={s} L={width} {dtype}" + (" h0" if with_h0 else "") \
            + (" dh_last" if with_dh else "")
        out[key] = t = {"shape": shape, "max_abs_err": max(errs.values())}
        print(f"  rglru_scan_bwd {shape}: {len(errs)} gradients within {atol} + {rtol} |ref| of "
              f"the plain reverse loop, max |d| {t['max_abs_err']:.3g}; one launch a call, two "
              f"calls bit-identical")
        if key != "train":
            continue
        del got, want

        def call():
            return rglru_ops.rglru_scan_bwd(u, gp, *vecs, carries, dy, dh, want_dh0=with_h0)

        ms, part_ms = device_ms(call, "rglru_bwd", iters=10, parts=RGLRU_BWD_PARTS)
        item = u.element_size()
        nbytes = 5 * item * b * s * width + 4 * carries.numel() + 2 * 5 * item * width
        t.update({"ms": ms, "stage_ms": part_ms, "library_ms": None,
                  "plain_ms": timed_ms(lambda: rglru_scan_bwd_ref(u, gp, *vecs, dy, h0=h0,
                                                                  dh_last=dh),
                                       iters=2, warmup=1),
                  "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"})
        print(f"    {nbytes / 1e6:.1f} MB; kernel {ms:.6f} ms on the device "
              f"[first design: {RGLRU_BWD_FIRST_MS}] ("
              + ", ".join(f"{k.removeprefix('rglru_bwd_')} {v:.6f}" for k, v in part_ms.items())
              + f"), bound {t['bound_ms']:.6f} ms (bytes), plain {t['plain_ms']:.3f} ms, no "
              "library call")
        del u, gp, dy, carries
        torch.cuda.empty_cache()

    # The model's autograd function, card against host, float32.
    b, s, width = 2, 300, 4096
    ins = [torch.randn((b, s, width), generator=gen, device="cuda") for _ in range(2)]
    ins += [torch.randn(width, generator=gen, device="cuda") * 0.5 for _ in range(5)]
    ins += [torch.randn((b, width), generator=gen, device="cuda")]
    dy = torch.randn((b, s, width), generator=gen, device="cuda")
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.detach().to(dev).requires_grad_() for t in ins]
        before = rglru_ops.bwd_counter.count
        y, h_last = rglru_ops.rglru_scan_autograd(*leaves)
        ((y * dy.to(dev)).sum() + h_last.sum()).backward()
        if dev == "cuda":
            require(rglru_ops.bwd_counter.count == before + 1,
                    "rglru_scan_autograd: not one rglru_scan_bwd launch on the card")
        grads[dev] = [t.grad.cpu() for t in leaves]
    err = max(_close(g, h, 1e-4, f"rglru_scan_autograd {n}", 1e-3)
              for n, g, h in zip(("u", "gpre", "a_w", "a_b", "x_w", "x_b", "Lambda", "h0"),
                                 grads["cuda"], grads["cpu"]))
    out["train"]["autograd_card_vs_host_err"] = err
    print(f"  rglru_scan_autograd B={b} S={s} L={width} float32 with h0, the gradients of its "
          f"eight inputs card against host within 1e-4 + 1e-3 |ref|, max |d| {err:.3g}")
    return out


def check_train_step_card_vs_host(seed, arch, layers=2, batch=2, seq=256, steps=3,
                                  regrad=True, groups=1):
    """Phase 16 (b): one training step of a float32 model at ``arch``'s
    widths (an SSD's B and C in ``groups`` groups), ``layers`` layers, card
    against host: the loss within 1e-4,
    every gradient leaf within atol 1e-4 + rtol 1e-3, and the weights after
    ``steps`` AdamW steps within 1e-4.  The learning rate is 1e-3 from the
    first step, so the steps move the weights by more than ten times that
    tolerance (required): a missing, reversed or misscaled update on the
    card would show.  Adam's eps is 1e-4: the first update is
    g / (|g| + eps), whose change with g is at most 1 / eps, so at eps 1e-8
    a gradient of ~1e-8 that differs by float32 rounding between card and
    host moves its weight by a different ~lr (21 embedding values past 1e-4
    on the card); at 1e-4 the gradients' measured agreement (< 2e-7) bounds
    the weights' difference to ~lr * 2e-3 a step.  The first step applies
    the gradients just compared, as ``make_train_step``'s step applies its
    own (``adamw_step``, then ``load_tree_``).  With ``regrad`` the others
    run through ``make_train_step`` on the next batches; without, they
    apply the same gradients again, so the host runs one float32 forward
    and backward rather than ``steps`` (the families with a 256,000-token
    vocabulary, whose host steps take tens of seconds each).  The weights
    are made on the card and copied to the host, and both sides' gradients
    and weights are compared on the card.  The seconds spent on each side
    are returned."""
    import dataclasses

    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.data import LMDataConfig, LMDataset
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import LM
    from repro_torch.models.transformer import TransformerParams
    from repro_torch.training import OptimizerConfig, adamw_step, init_opt_state
    from repro_torch.training.optimizer import tree_leaves, tree_map

    cfg = dataclasses.replace(ARCHS[arch], num_layers=layers, dtype="float32",
                              ssd_ngroups=groups)
    lm = LM(cfg)
    seconds = {"card": 0.0, "host": 0.0}
    card = lm.init(seed, device="cuda")
    host = TransformerParams(cfg, tree_map(lambda t: t.cpu(), card.to_tree()))
    data = LMDataset(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
                                  seed=seed))
    opt = OptimizerConfig(learning_rate=1e-3, warmup_steps=1, eps=1e-4)
    start = [t.clone() for t in tree_leaves(card.to_tree())]
    step_fn = make_train_step(lm, opt)
    params = {"card": card, "host": host}
    devices = {"card": "cuda", "host": "cpu"}

    def batch_at(step, dev):
        return {"tokens": torch.as_tensor(data.batch_at(step)["tokens"], device=dev)}

    out, states = {}, {}
    for name, dev in devices.items():
        t0 = time.perf_counter()
        model = params[name]
        model.requires_grad_(True)
        loss, _ = lm.loss(model, batch_at(0, dev))
        loss.backward()
        grads = model.grad_tree()
        out[name] = (loss.item(), tree_leaves(grads))
        model.zero_grad(set_to_none=True)
        states[name] = init_opt_state(model.to_tree(), opt)
        for step in range(steps):
            if step == 0 or not regrad:
                new_tree, states[name], _ = adamw_step(grads, states[name], model.to_tree(), opt)
                model.load_tree_(new_tree)
                del new_tree
            else:
                params[name], states[name], _ = step_fn(params[name], states[name],
                                                        batch_at(step, dev))
        del grads
        if dev == "cuda":
            torch.cuda.synchronize()
        seconds[name] += time.perf_counter() - t0
    card, host = params["card"], params["host"]
    loss_err = abs(out["card"][0] - out["host"][0])
    require(loss_err <= 1e-4, f"{arch}: the loss {out['card'][0]} on the card, "
                              f"{out['host'][0]} on the host")
    grad_err = max(_close(g, h.to("cuda"), 1e-4, f"{arch} gradient leaf {i}", rtol=1e-3)
                   for i, (g, h) in enumerate(zip(out["card"][1], out["host"][1])))
    n_leaves, card_loss = len(out["card"][1]), out["card"][0]
    del out
    weight_err = moved = 0.0
    for i, (c, h, w0) in enumerate(zip(tree_leaves(card.to_tree()), tree_leaves(host.to_tree()),
                                       start)):
        h = h.to("cuda")
        weight_err = max(weight_err, _close(c, h, 1e-4, f"{arch} weight leaf {i} after {steps} "
                                                        f"steps", rtol=0.0))
        moved = max(moved, float((h - w0).abs().max()))
    require(moved >= 1e-3, f"{arch}: {steps} AdamW steps moved no weight by 1e-3 (max {moved})")
    how = ("the others through make_train_step" if regrad
           else "the others on the same gradients")
    print(f"  {arch}, {layers} layers at full width, float32, B={batch} S={seq}: loss "
          f"{card_loss:.6f}, |d| {loss_err:.3g}; {n_leaves} gradient leaves, max |d| "
          f"{grad_err:.3g}; weights after {steps} AdamW steps at lr 1e-3, eps 1e-4 ({how}; "
          f"moved up to {moved:.3g}), max |d| card against host {weight_err:.3g}; "
          f"{seconds['card']:.1f} s on the card, {seconds['host']:.1f} s on the host")
    return {"loss_err": loss_err, "grad_err": grad_err, "weight_err": weight_err,
            "weights_moved": moved, "card_s": seconds["card"], "host_s": seconds["host"]}


# glibc's mallopt parameters: the mmap threshold count, the trim threshold
# and the pad kept at the heap's top on a trim, with their defaults.
_M_TRIM_THRESHOLD, _M_TOP_PAD, _M_MMAP_MAX = -1, -2, -4
_MMAP_MAX_DEFAULT, _TRIM_THRESHOLD_DEFAULT, _TOP_PAD_DEFAULT = 65536, 128 * 1024, 128 * 1024


@contextlib.contextmanager
def heap_allocations():
    """This process's large host allocations from glibc's heap, kept there
    when freed (up to 2 GB at its top), instead of a fresh ``mmap`` each:
    phase 16 (b)'s host steps allocate and free tensors of up to 4.2 GB
    many times, and each fresh mapping is faulted in page by page.  The
    defaults come back after, and the heap is trimmed."""
    import ctypes

    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:  # not glibc: allocations as they were
        yield
        return
    libc.mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    libc.malloc_trim.argtypes = [ctypes.c_size_t]
    for param, value in ((_M_MMAP_MAX, 0), (_M_TRIM_THRESHOLD, 2**31 - 1),
                         (_M_TOP_PAD, 2**31 - 1)):
        libc.mallopt(param, value)
    try:
        yield
    finally:
        for param, value in ((_M_MMAP_MAX, _MMAP_MAX_DEFAULT),
                             (_M_TRIM_THRESHOLD, _TRIM_THRESHOLD_DEFAULT),
                             (_M_TOP_PAD, _TOP_PAD_DEFAULT)):
            libc.mallopt(param, value)
        gc.collect()
        libc.malloc_trim(0)


def _training_summary(arch, losses, step_s, peak_gb, launches, per_step, executed):
    import numpy as np

    require(all(np.isfinite(losses)), f"{arch}: a non-finite loss")
    tail = float(np.mean(losses[-5:]))
    require(tail < losses[0], f"{arch}: the last 5 steps' mean loss {tail} is not below the "
                              f"first step's {losses[0]}")
    for name, n in per_step.items():
        require(launches.get(name, 0) == n * executed,
                f"{arch}: {launches.get(name, 0)} {name} launches, expected {n} a step x "
                f"{executed} steps")
    med = float(np.median(step_s))
    first = NEW_TRAIN_FIRST_TOKENS_PER_S.get(arch)
    print(f"  {arch}: losses {losses[0]:.4f} -> {losses[-1]:.4f} (last 5 mean {tail:.4f}); "
          f"median step {med:.4f} s, {TRAIN_BATCH * TRAIN_SEQ / med:.1f} tokens/s"
          + (f" [first designs: {first}]" if first else "") + "; peak "
          f"{peak_gb:.3f} GB; launches a step: "
          + ", ".join(f"{k} {launches.get(k, 0) / executed:g}" for k in TRAIN_KERNELS))
    return {"first_loss": losses[0], "last5_loss": tail, "step_s_median": med,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med, "peak_gb": peak_gb,
            "steps_run": executed, "launches": launches}


def train_full_width(seed):
    """Phase 16 (c): mamba2-130m through ``Trainer`` (checkpoints every 10
    steps, a fault injected at step 15 that restores step 10) and
    tinyllama-1.1b, then recurrentgemma-9b and gemma-7b at ``NEW_TRAIN``'s
    depths, through ``make_train_step``, all at full width in bf16 on
    LMDataset's markov stream, B=8 S=1024, with exact launches a step (K3
    and ``rglru_scan`` twice a layer with remat, their backwards once)."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.data import LMDataConfig, LMDataset
    from repro_torch.models import LM
    from repro_torch.training import OptimizerConfig, Trainer, TrainerConfig

    opt = OptimizerConfig(learning_rate=1e-3, warmup_steps=3, total_steps=1000)
    out = {}

    cfg = ARCHS["mamba2-130m"]
    data = LMDataset(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, seed=seed))
    attempts, fired = [], []

    def fault(step):
        attempts.append(step)
        if step == MAMBA_FAULT_AT and not fired:
            fired.append(step)
            raise RuntimeError(f"injected fault at step {step}")

    with tempfile.TemporaryDirectory() as d:
        trainer = Trainer(LM(cfg), data, opt_cfg=opt,
                          cfg=TrainerConfig(total_steps=MAMBA_STEPS, checkpoint_every=10,
                                            checkpoint_dir=d, log_every=1),
                          fault_hook=fault, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        step, _, _, summary = trainer.train(seed=seed)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
    executed = len(attempts) - len(fired)
    require(step == MAMBA_STEPS - 1 and summary["restarts"] == 1 and fired == [MAMBA_FAULT_AT],
            f"mamba2-130m: final step {step}, restarts {summary['restarts']}, faults {fired}")
    require(attempts[MAMBA_FAULT_AT + 1] == 11, "the fault did not restore step 10")
    out["mamba2-130m"] = _training_summary(
        "mamba2-130m", summary["losses"], trainer.step_times, peak, launches,
        {**dict.fromkeys(TRAIN_KERNELS, 0), "ssd": 2 * cfg.num_layers,
         "ssd_bwd": cfg.num_layers}, executed)
    out["mamba2-130m"].update({"wall_s": wall, "restarts": summary["restarts"],
                               "stragglers": summary["stragglers"]})
    print(f"    mamba2-130m: {executed} steps run ({MAMBA_STEPS} + the {MAMBA_FAULT_AT - 11} "
          f"after the checkpoint of step 10, again), checkpoints at 0, 10, 20 and "
          f"{MAMBA_STEPS - 1}, {wall:.1f} s")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    out["tinyllama-1.1b"] = train_through_steps(seed, ARCHS["tinyllama-1.1b"], opt, TINY_STEPS)
    for arch, (layers, lr) in NEW_TRAIN.items():
        out[arch] = train_through_steps(seed, dataclasses.replace(ARCHS[arch], num_layers=layers),
                                        dataclasses.replace(opt, learning_rate=lr),
                                        NEW_TRAIN_STEPS)
    return out


def train_through_steps(seed, cfg, opt, steps):
    """``steps`` bf16 training steps of ``cfg`` at full width through
    ``make_train_step`` on LMDataset's markov stream, B=8 S=1024: the loss
    falling, peak device memory under 80 GB, and the launches a step exact
    (with remat K3 and ``rglru_scan`` twice a layer, K3b and
    ``rglru_scan_bwd`` once)."""
    import torch

    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.data import LMDataConfig, LMDataset
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import LM
    from repro_torch.training import init_opt_state

    lm = LM(cfg)
    data = LMDataset(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, seed=seed))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init(seed, device="cuda")
    n_params = sum(t.numel() for t in params.parameters())
    state = init_opt_state(params.to_tree(), opt)
    step_fn = make_train_step(lm, opt)
    kernels.reset_launch_counts()
    losses, times = [], []
    t0 = time.perf_counter()
    for step in range(steps):
        t1 = time.perf_counter()
        batch = {k: torch.as_tensor(v, device="cuda") for k, v in data.batch_at(step).items()}
        params, state, metrics = step_fn(params, state, batch)
        losses.append(float(metrics["loss"]))
        times.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    require(peak < 80.0, f"{cfg.name}: peak device memory {peak:.3f} GB")
    kinds = [cfg.layer_kind(i).split(":")[0] for i in range(cfg.num_layers)]
    attn = sum(k in ("attn", "local") for k in kinds)
    rec = kinds.count("rglru")
    out = _training_summary(
        cfg.name, losses, times, peak, launches,
        {**dict.fromkeys(TRAIN_KERNELS, 0), "flash_attention": 2 * attn,
         "flash_attention_bwd": attn, "rglru_scan": 2 * rec, "rglru_scan_bwd": rec}, steps)
    out.update({"wall_s": wall, "layers": cfg.num_layers, "params": n_params,
                "learning_rate": opt.learning_rate, "losses": losses})
    print(f"    {cfg.name}: {cfg.num_layers} of {ARCHS[cfg.name].num_layers} layers at full width "
          f"({n_params / 1e9:.3f} B parameters), {steps} steps through make_train_step at lr "
          f"{opt.learning_rate:g}, no checkpoint, {wall:.1f} s; losses "
          + " ".join(f"{x:.4f}" for x in losses))
    del params, state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 17: the launchers

# Phase 17 (a): the train launcher's run at full width; the unsharded
# Trainer beside it takes the launcher's config (lr 3e-3, warmup
# max(steps // 20, 1), checkpoints every 50 steps, seed 0).
LAUNCH_ARCH, LAUNCH_STEPS, LAUNCH_BATCH, LAUNCH_SEQ = "mamba2-130m", 10, 8, 1024
# The sharded Trainer's losses against the unsharded one's, as
# tests/test_torch_launch.py holds them on gloo ranks.
LAUNCH_LOSS_TOL = 1e-4
# Phase 17 (b): the serve launcher's arguments.
LAUNCH_SERVE = ["--policy", "SneakPeek", "--requests", "24", "--windows", "3"]
# The kernels the two launchers' runs must launch between them (K1-K5).
LAUNCHER_KERNELS = ("utility_scores", "knn_topk", "flash_attention", "decode_attention", "ssd")


def _launcher(module: str, args: list, timeout: float) -> tuple[list, float]:
    """``python -m module args`` from the checkout: its standard output's
    lines and its seconds; it must exit 0."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    require(proc.returncode == 0, f"{module} exited {proc.returncode}: {proc.stderr[-3000:]}")
    return proc.stdout.splitlines(), wall


def _run_numbers(losses, step_s, peak_bytes, launches, steps):
    """tokens/s at the median step, peak GB (above what the process held
    before the run) and the launches a step."""
    import statistics

    return {"losses": losses, "step_s": step_s,
            "tokens_per_s": LAUNCH_BATCH * LAUNCH_SEQ / statistics.median(step_s),
            "peak_gb": peak_bytes / 1e9,
            "per_step": {k: v / steps for k, v in launches.items() if v}}


def check_train_launcher():
    """Phase 17 (a): ``python -m repro_torch.launch.train`` at mamba2-130m's
    full width, B=8 S=1024, 10 steps, ``--mesh data,model=1,1``: a real NCCL
    group of one rank and the DTensor route (ZeRO-3 on one card), with its
    checkpoints; then the unsharded ``Trainer`` on the same seed, config and
    steps in this process.  Both runs' tokens/s, peak memory and losses;
    the largest loss difference within ``LAUNCH_LOSS_TOL``; the launches a
    step equal.  Returns both runs' numbers, the difference and the
    launcher's launches."""
    import tempfile

    import torch

    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.data import LMDataConfig, LMDataset
    from repro_torch.models import LM
    from repro_torch.training import OptimizerConfig, Trainer, TrainerConfig

    shape = ["--arch", LAUNCH_ARCH, "--steps", str(LAUNCH_STEPS), "--batch", str(LAUNCH_BATCH),
             "--seq", str(LAUNCH_SEQ)]
    with tempfile.TemporaryDirectory() as d:
        lines, wall = _launcher("repro_torch.launch.train",
                                shape + ["--mesh", "data,model=1,1", "--ckpt-dir", d], 900)
        saved = sorted(p.name for p in Path(d).iterdir())
    require(any(line.startswith(f"arch={LAUNCH_ARCH} ") and line.endswith(" devices=1")
                for line in lines), f"no arch line: {lines[:3]}")
    require(any(line.startswith(f"done @ step {LAUNCH_STEPS - 1}:") for line in lines),
            "no done line")
    require(saved == ["LATEST", "step_00000000", f"step_{LAUNCH_STEPS - 1:08d}"],
            f"the sharded run's checkpoints: {saved}")
    got = json.loads(lines[-1].removeprefix("summary "))
    sharded = _run_numbers(got["losses"], got["step_s"], got["peak_bytes"], got["launches"],
                           LAUNCH_STEPS)

    cfg = ARCHS[LAUNCH_ARCH]
    data = LMDataset(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=LAUNCH_SEQ,
                                  global_batch=LAUNCH_BATCH, kind="markov"))
    opt = OptimizerConfig(learning_rate=3e-3, warmup_steps=max(LAUNCH_STEPS // 20, 1),
                          total_steps=LAUNCH_STEPS)
    with tempfile.TemporaryDirectory() as d:
        trainer = Trainer(LM(cfg), data, opt_cfg=opt,
                          cfg=TrainerConfig(total_steps=LAUNCH_STEPS, checkpoint_every=50,
                                            checkpoint_dir=d, log_every=1), device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # earlier phases' tensors, not this run's
        kernels.reset_launch_counts()
        step, _, _, summary = trainer.train()
        torch.cuda.synchronize()
        unsharded = _run_numbers(summary["losses"], trainer.step_times,
                                 torch.cuda.max_memory_allocated() - held,
                                 kernels.launch_counts(), LAUNCH_STEPS)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    require(step == LAUNCH_STEPS - 1, f"the unsharded run stopped at step {step}")
    require(len(sharded["losses"]) == len(unsharded["losses"]) == LAUNCH_STEPS,
            "a run logged another number of losses")
    diff = max(abs(a - b) for a, b in zip(sharded["losses"], unsharded["losses"]))
    for label, run in (("launcher, data,model=1,1", sharded), ("unsharded Trainer", unsharded)):
        print(f"    {label}: {run['tokens_per_s']:.1f} tokens/s at the median step, peak "
              f"{run['peak_gb']:.3f} GB, launches a step {run['per_step']}; losses "
              + " ".join(f"{x:.6f}" for x in run["losses"]))
    print(f"    largest loss difference {diff:.3g} (tolerance {LAUNCH_LOSS_TOL:g}); the "
          f"launcher's process {wall:.1f} s; its weights and AdamW state on the card "
          f"{got['state_bytes'] / 1e9:.3f} GB")
    require(diff <= LAUNCH_LOSS_TOL, f"the sharded losses differ from the unsharded by {diff}")
    require(sharded["per_step"] == unsharded["per_step"],
            f"launches a step: sharded {sharded['per_step']}, unsharded {unsharded['per_step']}")
    require(sharded["per_step"].get("ssd") == 2 * cfg.num_layers
            and sharded["per_step"].get("ssd_bwd") == cfg.num_layers,
            f"K5/K5b a step: {sharded['per_step']}")
    return {"sharded": sharded, "unsharded": unsharded, "max_loss_diff": diff,
            "launcher_s": wall, "state_gb": got["state_bytes"] / 1e9}, got["launches"]


def check_serve_launcher():
    """Phase 17 (b): ``python -m repro_torch.launch.serve --policy SneakPeek
    --requests 24 --windows 3`` on the card: the ``mean utility`` and
    ``batch[`` lines, and the launches its last line counts."""
    lines, wall = _launcher("repro_torch.launch.serve", LAUNCH_SERVE, 600)
    require(any(line.startswith("mean utility ") for line in lines), "no mean utility line")
    batches = [line for line in lines if line.strip().startswith("batch[")]
    require(batches, "no batch[ line")
    launches = json.loads(lines[-1].removeprefix("kernel launches "))
    for line in lines:
        if line.startswith(("variant ", "policy=", "mean utility ")):
            print(f"    {line}")
    print(f"    {len(batches)} batches; launches {launches}; {wall:.1f} s")
    return launches, wall


def serve_costmodel_pool(args, sneak):
    """Phase 17 (c): ``EdgeServer`` over ``CostModelBackend`` lanes on two
    workers (one twice as fast), mamba2-130m, tinyllama-1.1b and gemma-7b
    at full width as modelled by ``serving.profiles`` (no model runs),
    SneakPeek on phase 9's traffic, on the card (SneakPeek through K2,
    placement steps and commits through K1) and on the host (the card's
    evidence carried on copies of the requests): every request decided
    once, decisions and the served stats equal, the host launching
    nothing."""
    import copy

    import torch

    from repro_torch import kernels
    from repro_torch.core.multiworker import Worker
    from repro_torch.core.scheduler import make_policy
    from repro_torch.core.types import Application
    from repro_torch.serving.backends import CostModelBackend

    variants = {name: name for name in ("mamba2-130m", "tinyllama-1.1b", "gemma-7b")}
    recalls = {"mamba2-130m": [0.72, 0.70], "tinyllama-1.1b": [0.84, 0.82],
               "gemma-7b": [0.94, 0.92]}
    profiles = CostModelBackend(variants).profiles(recalls)
    app = {"assistant": Application(name="assistant", models=list(profiles.values()),
                                    penalty="sigmoid")}
    workers = [Worker(0), Worker(1, speed=2.0)]
    server_cls = _pass_counting_server()
    views, evidenced = {}, None
    for device in ("cuda", "cpu"):
        on_card = device == "cuda"
        reqs = serving_trace(args, 95_000) if on_card else copy.deepcopy(evidenced)
        server = server_cls(app, make_policy("SneakPeek"), backend=CostModelBackend(variants),
                            sneakpeeks={"assistant": sneak} if on_card else None,
                            prompt_fn=serving_prompt_fn(32_000), workers=workers,
                            device=device)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t = time.perf_counter()
        with server:
            outs, stats = server.run(reqs)
        wall = time.perf_counter() - t
        launches = kernels.launch_counts()
        if on_card:
            evidenced = copy.deepcopy(reqs)
        views[device] = {
            "stats": {k: getattr(stats, k) for k in ("windows", "requests", "mean_utility",
                                                     "violations", "swaps")},
            "decisions": [(e.request.rid, e.model, e.worker, e.order, e.batch_id)
                          for o in outs for e in o["schedule"].sorted_entries()]}
        steps = sum(len({e.batch_id for e in sched.entries}) for sched in server.passes)
        models = sorted({d[1] for d in views[device]["decisions"]})
        print(f"    {device}: windows={stats.windows} requests={stats.requests} "
              f"mean_utility={stats.mean_utility:.6f} violations={stats.violations} "
              f"swaps={stats.swaps}; models {models}; {len(server.passes)} scheduling passes, "
              f"{steps} placement steps; wall {wall:.3f} s; launches {launches}")
        require(sorted(d[0] for d in views[device]["decisions"]) == sorted(r.rid for r in reqs),
                f"{device}: not every request was decided exactly once")
        if on_card:
            require(launches.get("knn_topk", 0) > 0, "the cost-model pool ran no k-NN kernel")
            require(launches.get("utility_scores", 0) == steps + stats.windows,
                    f"K1 launched {launches.get('utility_scores')} times, expected {steps} "
                    f"placement steps + {stats.windows} commits")
        else:
            require(not any(launches.values()), f"the host run launched {launches}")
    for key in ("stats", "decisions"):
        require(views["cuda"][key] == views["cpu"][key],
                f"phase 17 (c): the host's {key} differ from the card's")
    print(f"    card and host agree: {len(views['cuda']['decisions'])} decisions, "
          f"{views['cuda']['stats']}")
    return {"decisions": len(views["cuda"]["decisions"]), **views["cuda"]["stats"]}


# ---------------------------------------------------------------- phase 18: the dry run

# Phase 18 (a): five production cells of the dry run on the (16, 16) pod,
# in a child process (a fake world of 256 ranks, fake tensors); the two of
# llama4-scout run its routed MoE on each rank's shards under the ep_tp
# rules (torch 2.11 has no DTensor strategy for the dispatch's index_put_).
DRYRUN_CELLS = (("mamba2-130m", "train_4k"), ("tinyllama-1.1b", "decode_32k"),
                ("gemma-7b", "prefill_32k"), ("llama4-scout-17b-16e", "prefill_32k"),
                ("llama4-scout-17b-16e", "decode_32k"))
# Phase 18 (b) and (c): the dry run's prediction for a one-rank mesh at
# phase 17 (a)'s cell (the ZeRO-3 train step) and at tinyllama-1.1b's
# prefill (the tensor-parallel prefill step), against the real steps on
# the card: the peaks within PREDICT_TOL of torch.cuda.max_memory_allocated.
PREDICT = {"train": ("mamba2-130m", "train", 8, 1024),
           "prefill": ("tinyllama-1.1b", "prefill", 8, 1024)}
PREDICT_TOL = 0.10
# The sharded prefill's logits against the unsharded prefill's on the same
# weights (one rank: the same kernels on the same tensors).
PREFILL_LOGITS_TOL = 1e-3

_DRYRUN_CHILD = """
import json, sys, tempfile
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch.dryrun import dry_run, run_cell
job = json.loads(sys.argv[1])
out = {"cells": [], "predictions": {}}
with tempfile.TemporaryDirectory() as d:
    for arch, shape in job["cells"]:
        rec = run_cell(arch, shape, "pod", force=True, out_dir=d)
        out["cells"].append({k: rec.get(k) for k in (
            "arch", "shape", "status", "error", "total_s", "compile_s", "hbm_per_device_bytes",
            "roofline", "launches", "collectives", "cost_analysis", "model_flops_per_device")})
for name, (arch, step, b, s) in job["predict"].items():
    rec = dry_run(get_config(arch), ShapeSpec(name, s, b, step), {"data": 1, "model": 1})
    out["predictions"][name] = {k: rec[k] for k in (
        "hbm_per_device_bytes", "memory_analysis", "launches", "roofline", "cost_analysis")}
print("RESULT " + json.dumps(out))
"""


def run_dryrun_child() -> tuple[dict, float]:
    """Phase 18 (a) and the predictions of (b) and (c), in one child
    process from the checkout (the dry run starts a process group of its
    own, which this process must not hold)."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    job = {"cells": DRYRUN_CELLS, "predict": PREDICT}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _DRYRUN_CHILD, json.dumps(job)], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    require(proc.returncode == 0, f"the dry run exited {proc.returncode}: {proc.stderr[-3000:]}")
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")][-1]
    return json.loads(line.removeprefix("RESULT ")), wall


@contextlib.contextmanager
def one_rank_group():
    """A one-rank NCCL process group on this card, and its (1, 1) mesh."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", store=dist.FileStore(str(Path(d) / "store"), 1),
                                rank=0, world_size=1)
        try:
            yield make_mesh((1, 1), ("data", "model"), device="cuda")
        finally:
            dist.destroy_process_group()


def measure_sharded_train(mesh, seed: int) -> dict:
    """Phase 18 (b): the ZeRO-3 train step (``make_sharded_train_step``) at
    phase 17 (a)'s cell on the one-rank mesh, its state built as
    ``Trainer(shardings=)`` builds it: the peak above what the process held
    before the state (the state included), the launches of one step and
    the median of four steps' seconds."""
    import statistics

    import torch

    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.data import LMDataConfig, LMDataset
    from repro_torch.distributed.policies import make_policy
    from repro_torch.distributed.sharding import named_sharding_tree
    from repro_torch.launch import shardings as shd
    from repro_torch.launch.steps import make_sharded_train_step
    from repro_torch.models import LM
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.trainer import sharded_opt_state

    arch, _, b, s = PREDICT["train"]
    cfg = ARCHS[arch]
    model, opt_cfg = LM(cfg), OptimizerConfig(quantize_moments=cfg.param_count() > 100e9)
    policy = make_policy(cfg, "train", mesh)
    p_sh = named_sharding_tree(shd.param_pspecs(model, policy, mesh), mesh)
    o_sh = named_sharding_tree(shd.opt_state_pspecs(model, policy, mesh, opt_cfg), mesh)
    data = LMDataset(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b,
                                  kind="markov"))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    params = model.init(seed, device="cuda", shardings=p_sh)
    opt = sharded_opt_state(model, params, o_sh, opt_cfg, "cuda")
    step = make_sharded_train_step(model, opt_cfg, (p_sh, o_sh), policy)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses, launches = [], [], None
    for i in range(5):
        batch = {k: torch.as_tensor(v, device="cuda") for k, v in data.batch_at(i).items()}
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["total_loss"]))
        if i == 1:
            launches = {k: v for k, v in kernels.launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated() - held
    require(all(map(lambda x: x == x and abs(x) < 1e4, losses)), f"losses {losses}")
    del params, opt, batch, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return {"peak_bytes": peak, "launches": launches, "median_step_s": statistics.median(times[1:]),
            "losses": losses}


def measure_sharded_prefill(mesh, seed: int) -> dict:
    """Phase 18 (c): the tensor-parallel prefill step
    (``make_sharded_prefill_step``) at tinyllama-1.1b's bf16 B=8 S=1024 on
    the one-rank mesh: the peak above what the process held before the
    weights, K3's launches, the median of three calls' seconds, and the
    logits against the unsharded prefill's on the same weights."""
    import statistics

    import torch

    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.launch import shardings as shd
    from repro_torch.launch.steps import make_prefill_step, make_sharded_prefill_step
    from repro_torch.models import LM

    arch, _, b, s = PREDICT["prefill"]
    cfg = ARCHS[arch]
    model = LM(cfg)
    p_sh, serve_sh = shd.serve_shardings(model, mesh, b, s, step="prefill")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda",
                           dtype=torch.int32)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    params = model.init(seed, device="cuda", shardings=p_sh)
    step = make_sharded_prefill_step(model, s, serve_sh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    logits, cache = step(params, tokens)
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated() - held
    sharded = logits.full_tensor().float()
    del logits, cache
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = step(params, tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del out
    del params
    gc.collect()
    torch.cuda.empty_cache()
    whole = model.init(seed, device="cuda")
    plain = make_prefill_step(model, s)(whole, tokens)[0].float()
    diff = float((sharded - plain).abs().max())
    require(bool(torch.isfinite(sharded).all()) and tuple(sharded.shape) == (b, cfg.vocab_size),
            f"the sharded prefill's logits: {tuple(sharded.shape)}")
    del whole, plain, sharded
    gc.collect()
    torch.cuda.empty_cache()
    return {"peak_bytes": peak, "launches": launches, "median_s": statistics.median(times),
            "logits_max_diff": diff}


def check_dryrun(seed: int, card: str) -> dict:
    """Phase 18: (a) the child's five production records, each ``ok``; (b)
    and (c) the one-rank predictions against the real steps: peaks within
    ``PREDICT_TOL``, fake launches equal to the real ones."""
    res, wall = run_dryrun_child()
    for rec in res["cells"]:
        require(rec["status"] == "ok", f"dry run {rec['arch']} {rec['shape']}: {rec['error']}")
        rt = rec["roofline"]
        print(f"    (a) {rec['arch']} {rec['shape']} pod: {rec['total_s']} s (trace "
              f"{rec['compile_s']} s), hbm_per_device_bytes {rec['hbm_per_device_bytes']}, "
              f"bound {rt['bound']}, roofline_fraction {rt['roofline_fraction']:.6f}, "
              f"t_max {rt['t_max_s']:.6g} s, fake launches {rec['launches']}, collectives "
              f"{rec['collectives']['total_bytes']} B ({card})")
    print(f"    (a) the child process {wall:.1f} s")
    out = {"cells": res["cells"], "child_s": wall, "predictions": res["predictions"]}
    with one_rank_group() as mesh:
        for name, measure, launch_keys in (("train", measure_sharded_train, ("ssd", "ssd_bwd")),
                                           ("prefill", measure_sharded_prefill,
                                            ("flash_attention",))):
            pred = res["predictions"][name]
            t0 = time.perf_counter()
            got = measure(mesh, seed)
            ratio = pred["hbm_per_device_bytes"] / got["peak_bytes"]
            real = {k: got["launches"].get(k, 0) for k in launch_keys}
            fake = {k: pred["launches"].get(k, 0) for k in launch_keys}
            arch, _, b, s = PREDICT[name]
            print(f"    ({'b' if name == 'train' else 'c'}) {arch} {name} B={b} S={s}, "
                  f"data,model=1,1: predicted peak {pred['hbm_per_device_bytes']} B, measured "
                  f"{got['peak_bytes']} B (torch.cuda.max_memory_allocated above the process's "
                  f"earlier tensors), ratio {ratio:.4f}; fake launches {fake}, real {real}; "
                  f"roofline t_max {pred['roofline']['t_max_s']:.6g} s ({pred['roofline']['bound']})"
                  f", measured median {got.get('median_step_s', got.get('median_s')):.6f} s; "
                  + (f"losses {got['losses']}" if name == "train"
                     else f"logits against the unsharded prefill {got['logits_max_diff']:.3g}")
                  + f"; {time.perf_counter() - t0:.1f} s ({card})")
            require(abs(ratio - 1.0) <= PREDICT_TOL,
                    f"phase 18 {name}: the predicted peak is {ratio:.4f} of the measured")
            require(fake == real and all(real.values()),
                    f"phase 18 {name}: fake launches {fake}, real {real}")
            if name == "prefill":
                require(got["logits_max_diff"] <= PREFILL_LOGITS_TOL,
                        f"the sharded prefill's logits differ by {got['logits_max_diff']}")
            out[name] = {**got, "predicted_bytes": pred["hbm_per_device_bytes"], "ratio": ratio,
                         "t_max_s": pred["roofline"]["t_max_s"]}
    return out


# ---------------------------------------------------------------- phase 19: the examples

# The port's examples as phase 19 runs them: examples/torch_<name>.py, its
# arguments and the kernels it must launch on the card.  Those run at their
# default width run again with --device cpu, and the lines that carry
# their decisions must be equal.
EXAMPLE_RUNS = (
    ("quickstart", (), ("knn_topk", "utility_scores")),
    ("multiworker_sim", (), ("knn_topk", "utility_scores", "ssd")),
    ("edge_serving", ("--full",),
     ("utility_scores", "flash_attention", "decode_attention", "ssd")),
    ("async_serving", (), ("utility_scores",)),
    ("executor_backends", ("--full",), ("flash_attention", "decode_attention", "ssd")),
    ("fault_tolerant_serving", (), ("utility_scores",)),
)
EXAMPLE_FAMILIES = ("mamba2-130m", "tinyllama-1.1b", "gemma-7b")  # torch_edge_serving's


def load_example(name: str):
    """``examples/<name>.py`` imported by path, afresh."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_example(name: str, argv) -> tuple[str, object, float]:
    """``main(argv)`` of examples/torch_<name>.py: its output, what it
    returned, its seconds (the card synchronised at the end)."""
    import io

    import torch

    module = load_example(f"torch_{name}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = module.main(list(argv))
    if "cpu" not in argv:
        torch.cuda.synchronize()
    return buf.getvalue(), result, time.perf_counter() - t0


def run_examples(card: str) -> tuple[dict, dict]:
    """Phase 19: each example on the card, its launch counts set to 0 just
    before and read just after, its seconds and peak device memory; the
    kernels of ``EXAMPLE_RUNS`` launched; the default-width ones' decision
    lines equal to a ``--device cpu`` run's.  Returns each example's
    numbers and the launches of all the card runs."""
    import torch

    from repro_torch import kernels

    lines = load_example("_example_lines")
    numbers, total = {}, {}
    for name, argv, wanted in EXAMPLE_RUNS:
        label = " ".join([f"torch_{name}", *argv])
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        out, result, secs = _run_example(name, argv)
        launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() - held
        for line in out.splitlines():
            print(f"      | {line}")
        missing = [k for k in wanted if not launches.get(k)]
        require(not missing, f"{label} launched no {missing}")
        row = {"argv": list(argv), "s": secs, "launches": launches, "peak_bytes": peak}
        if name in ("multiworker_sim", "edge_serving"):
            problems = lines.closed_loop_problems(result)
            require(not problems, f"{label}'s closed loop: {problems}")
        if name == "edge_serving":
            ran = set().union(*map(set, result["models_ran"].values()))
            require(ran == set(EXAMPLE_FAMILIES), f"torch_edge_serving --full ran only {ran}")
            row["models_ran"] = result["models_ran"]
        if "--full" not in argv:
            cpu_out, cpu_result, cpu_s = _run_example(name, ["--device", "cpu", *argv])
            card_lines, cpu_lines = lines.decision_lines(out), lines.decision_lines(cpu_out)
            differ = [(a, b) for a, b in zip(card_lines, cpu_lines) if a != b]
            require(len(card_lines) == len(cpu_lines) and not differ,
                    f"{label}: the card's decision lines differ from the CPU's: {differ}")
            if name == "multiworker_sim":
                problems = lines.closed_loop_problems(cpu_result)
                require(not problems, f"{label} --device cpu's closed loop: {problems}")
            row.update(cpu_s=cpu_s, decision_lines=len(card_lines))
        print(f"    {label}: {secs:.3f} s on the card, peak "
              f"{peak / 1e9:.3f} GB above the {held / 1e9:.3f} GB held, launches {launches}"
              + (f"; --device cpu {row['cpu_s']:.3f} s, {row['decision_lines']} decision lines "
                 "equal" if "cpu_s" in row else "") + f" ({card})")
        numbers[name] = row
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    return numbers, total


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no port sources under {src}; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import numpy as np

    from repro_torch import kernels
    from repro_torch.core.grouping import group_by_app, split_groups_by_label
    from repro_torch.core.scheduler import POLICY_NAMES, effective_apps, make_policy
    from repro_torch.core.simulator import Simulation, run_window
    from repro_torch.core.sneakpeek import ingest_window
    from repro_torch.data.applications import (
        APP_SPECS,
        build_benchmark_suite,
        make_requests,
    )
    from repro_torch.kernels import nvcc

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[1] device: {kind}; nvidia-smi: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    built = nvcc.build()
    print(f"[2] built {sorted(built)} in {time.perf_counter() - t0:.2f} s "
          f"(per source: {', '.join(f'{n} {s:.2f} s' for n, s in sorted(built.items()))})")
    hmma = hmma_count(nvcc.SOURCES["flash_attention"].library_path())
    if hmma is None:
        print("    cuobjdump not found: K3's SASS not inspected")
    else:
        require(hmma > 0, "K3's library holds no HMMA (tensor-core) instruction")
        print(f"    K3 library SASS: {hmma} HMMA (tensor-core) instructions")
    for name in sorted(built):
        log = (nvcc.BUILD_DIR / f"{name}.log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"    ptxas {name}: {line.strip()}")
    for name, keys in D256_INSTANCES.items():
        found = ptxas_registers(name, keys)
        require(sorted(found) == sorted(keys), f"ptxas reported no {set(keys) - set(found)}")
        for key, line in found.items():
            print(f"    ptxas head dim 256, {key}: {line}")
    for key, line in ptxas_registers("flash_attention",
                                     D256_INSTANCES["flash_attention"][:2]).items():
        require(" 0 bytes spill stores" in line,
                f"K3's bf16 instance at head dim 256 spills registers ({key})")
    for name, what, op in (("flash_attention_bwd", "K3b", "HMMA"),
                           ("flash_attention_bwd", "K3b", "HGMMA"), ("ssd_bwd", "K5b", "HMMA")):
        hmma = hmma_count(nvcc.SOURCES[name].library_path(), op)
        if hmma is None:
            print(f"    cuobjdump not found: {what}'s SASS not inspected")
        else:
            require(hmma > 0, f"{what}'s library holds no {op} (tensor-core) instruction")
            print(f"    {what} library SASS: {hmma} {op} (tensor-core) instructions")
    k3b_bf16 = ptxas_registers("flash_attention_bwd", K3B_BF16_INSTANCES)
    require(sorted(k3b_bf16) == sorted(K3B_BF16_INSTANCES),
            f"ptxas reported no {set(K3B_BF16_INSTANCES) - set(k3b_bf16)}")
    for key, line in k3b_bf16.items():
        print(f"    ptxas K3b bf16, {key}: {line}")
        require(" 0 bytes spill stores" in line, f"K3b's bf16 instance {key} spills registers")
    for name, keys in F32_INSTANCES.items():
        what = "K3" if name == "flash_attention" else "K3b"
        regs = ptxas_registers(name, keys)
        require(sorted(regs) == sorted(keys), f"ptxas reported no {set(keys) - set(regs)}")
        tf32 = sass_counts(nvcc.SOURCES[name].library_path(), keys)
        if tf32 is None:
            print(f"    cuobjdump not found: {what}'s f32 SASS not inspected")
        for key in keys:
            print(f"    ptxas {what} f32, {key}: {regs[key]}"
                  + ("" if tf32 is None else f"; {tf32.get(key, 0)} HMMA TF32 in its SASS"))
            if tf32 is not None:
                require(tf32.get(key, 0) > 0, f"{what}'s f32 instance {key} holds no TF32 HMMA")
            if "ILi256E" not in key:
                require(" 0 bytes spill stores" in regs[key],
                        f"{what}'s f32 instance {key} spills registers")

    t0 = time.perf_counter()
    specs = list(APP_SPECS.values())
    apps, sneaks = build_benchmark_suite(seed=args.seed, k=args.k, train_n=args.train_n,
                                         device="cuda")
    torch.cuda.synchronize()
    print(f"    set-up: 3 apps, k-NN train_n={args.train_n} on the card "
          f"in {time.perf_counter() - t0:.2f} s")

    # Shapes of the main path: one window's queries per app, and its groups.
    probe = shifted_window(specs, args.per_app, 0, 0.1, args.seed, make_requests)
    feats = {}
    for app in apps:
        feats[app] = np.stack([r.features for r in probe if r.app == app]).astype(np.float32)

    print("[3] k-NN kernel (K2) against its plain version")
    knn_t = check_knn(sneaks, feats, args.k, rows=512)

    ingest_window(probe, apps, sneaks, device="cuda")
    groups = split_groups_by_label(group_by_app(probe), apps)
    big = max(groups.values(), key=len)
    group_shape = (len(big), len(apps[big[0].app].models) + 1)  # + short-circuit
    print(f"    window groups: {len(groups)}, largest {group_shape}")

    print("[4] Eq. 2 utility kernel (K1) against its plain version")
    util_t = check_utility(group_shape, args.seed)
    small_reference_check(args.seed)

    print(f"[5] main path: SneakPeek Simulation, {args.windows} windows x "
          f"{args.per_app * len(specs)} requests, train_n={args.train_n}, k={args.k}")
    trace = [r for w in range(args.windows)
             for r in shifted_window(specs, args.per_app, w, 0.1, args.seed + 100,
                                     make_requests)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sim = Simulation(make_policy("SneakPeek"), apps, sneakpeeks=sneaks,
                     short_circuit=True, seed=args.seed, device="cuda")
    agg = sim.run(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    sched_s = [row["overhead_s"] for row in sim.log]
    print(f"    windows={len(sim.log)} requests={agg['count']} "
          f"utility={agg['utility']:.6f} accuracy={agg['accuracy']:.6f} "
          f"violations={agg['violations']} wall={wall:.3f} s")
    print("    scheduling s per window: " + " ".join(f"{s:.4f}" for s in sched_s))
    print(f"    launches: {launches}")
    require(len(sim.log) == args.windows, f"{len(sim.log)} windows, expected {args.windows}")
    require(agg["count"] == len(trace), "not every request was scheduled")
    for key in ("utility", "accuracy"):
        require(0.0 <= agg[key] <= 1.0 and np.isfinite(agg[key]), f"{key} {agg[key]} out of range")
    for row in sim.log:
        require(np.isfinite(row["utility"]), "non-finite window utility")
    require(launches.get("knn_topk", 0) > 0, "the main path launched no k-NN kernel")
    require(launches.get("utility_scores", 0) > 0, "the main path launched no utility kernel")

    for name in POLICY_NAMES:
        if name == "SneakPeek":
            continue
        reqs = shifted_window(specs, args.per_app, 0, 0.1, args.seed + 200, make_requests)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = run_window(make_policy(name), reqs, apps, 0.1, sneakpeeks=sneaks, device="cuda")
        torch.cuda.synchronize()
        u = res.result.utilities
        require(len(u) == len(reqs) and bool(np.isfinite(u).all()), f"{name}: bad utilities")
        print(f"    run_window {name}: utility={res.mean_utility:.6f} "
              f"violations={res.result.violations} sched={res.overhead_s:.4f} s "
              f"wall={time.perf_counter() - t0:.3f} s launches={kernels.launch_counts()}")

    for t, name in ((knn_t, "knn_topk"), (util_t, "utility_scores")):
        print(f"    {name} at {t['shape']}: kernel {t['ms']:.6f} ms on the device, "
              f"{t['call_ms']:.6f} ms per wrapper call back to back, plain "
              f"{t['plain_ms']:.6f} ms, bound {t['bound_ms']:.6f} ms ({t['bound_by']})")
    print(f"    utility_scores without the sums: {util_t['fill_ms']:.6f} ms at {util_t['shape']}, "
          f"{util_t['entry_ms']:.6f} ms at R=4096 M=1 (evaluate's per-entry tile)")
    pt = util_t["placement"]
    print(f"    utility_scores at a placement step's shape {pt['shape']}: kernel {pt['ms']:.6f} ms "
          f"on the device, {pt['call_ms']:.6f} ms per wrapper call back to back, plain "
          f"{pt['plain_ms']:.6f} ms, bound {pt['bound_ms']:.3e} ms ({pt['bound_by']})")
    print(f"    phases 1-5 {time.perf_counter() - t_start:.1f} s")

    print("[6] prefill flash-attention kernel (K3) against its plain version")
    flash_t = check_flash(args.seed)
    print("[7] flash-decode kernel (K4) against its plain version")
    decode_t = check_decode(args.seed)
    for t, name in ((flash_t, "flash_attention"), (flash_t["at_d256"], "flash_attention"),
                    (flash_t["windowed"], "flash_attention"),
                    (flash_t["non_causal"], "flash_attention"),
                    (flash_t["f32"], "flash_attention"),
                    (flash_t["f32_non_causal"], "flash_attention"),
                    (flash_t["f32_d256"], "flash_attention"), (decode_t, "decode_attention"),
                    (decode_t["at_d256"], "decode_attention")):
        print(f"    {name} at {t['shape']}: kernel {t['ms']:.6f} ms on the device, "
              f"{t['call_ms']:.6f} ms per wrapper call back to back, plain "
              f"{t['plain_ms']:.6f} ms, SDPA {t['library_ms']:.6f} ms, bound "
              f"{t['bound_ms']:.6f} ms ({t['bound_by']})")
    print(f"    decode_attention at capacity 1280, same lengths: "
          f"{decode_t['ms_at_capacity_1280']:.6f} ms on the device")
    print("[7b] Mamba-2 SSD chunk-scan kernel (K5) against its plain version")
    ssd_t = check_ssd(args.seed)
    print(f"    ssd at {ssd_t['shape']}: kernel {ssd_t['ms']:.6f} ms on the device, "
          f"{ssd_t['call_ms']:.6f} ms per wrapper call back to back, plain "
          f"{ssd_t['plain_ms']:.6f} ms, no library call, bound {ssd_t['bound_ms']:.6f} ms "
          f"({ssd_t['bound_by']})")
    print(f"    phases 6-7b {time.perf_counter() - t_start:.1f} s")
    print("[8] whole models, card against host")
    check_model_card_vs_host(args.seed, "tinyllama-1.1b", 77, ("k", "v"))
    check_model_card_vs_host(args.seed, "mamba2-130m", 200, ("conv", "state"))
    check_model_card_vs_host(args.seed, "gemma-7b", 77, ("k", "v"))
    # One period of gemma3-4b (5 local layers, window 1024, then 1 global) on
    # prompts longer than the window, so prefill packs a wrapped ring: the
    # ring of layer 0 and the full cache of layer 5.
    check_model_card_vs_host(args.seed, "gemma3-4b", 1030, ("k", "v"), layers=6, compare=(0, 5))
    print(f"    phases 1-8 {time.perf_counter() - t_start:.1f} s")
    print(f"[9] serving main path: EdgeServer, SneakPeek, {args.serve_requests} requests on "
          "mamba2-130m (24 layers), tinyllama-1.1b (22 layers) and gemma-7b (28 layers), "
          "bf16, then on each alone")
    serve_launches, profiles = serve_main_path(args)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"    phases 1-9 {time.perf_counter() - t_start:.1f} s")
    print(f"[10] the pool: EdgeServer(workers=[Worker(0), Worker(1, speed=2.0)]), SneakPeek, "
          f"{args.serve_requests} requests on mamba2-130m and tinyllama-1.1b (gemma-7b stays in "
          "phase 9's single-executor runs), thread lanes, process lanes, CompiledBackend lanes")
    pool, warm_pool = serve_pool_path(args, profiles)
    print(f"    phases 1-10 {time.perf_counter() - t_start:.1f} s")
    print("[11] closed-loop serving: EdgeServer(preempt=True, faults=FaultPlan(...), "
          "health=True), synchronous and overlapped")
    t0 = time.perf_counter()
    print("  (a) SimulatedBackend lanes on workers [Worker(0), Worker(1, speed=2.0), Worker(2)], "
          "phase 9's three-family application, a crash, a straggler pinned to worker 2 and "
          "seeded transients: the card against the host")
    closed_sneak = serving_sneakpeek(args)
    closed_view = serve_closed_loop_simulated(args, profiles, closed_sneak)
    print(f"    (a) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print("  (b) mamba2-130m and tinyllama-1.1b at full width on phase 10's warm thread lanes, "
          "overlapped, a crash and seeded transients")
    closed = serve_closed_loop_models(args, profiles, warm_pool)
    warm_pool.close()
    print(f"    (b) {time.perf_counter() - t0:.1f} s")
    print(f"    phases 1-11 {time.perf_counter() - t_start:.1f} s")

    print("[12] the compiled window pipeline: one selection_scan launch per window")
    t0 = time.perf_counter()
    print(f"  (a) the scan against its plain version on phase 5's first window "
          f"({args.per_app * len(specs)} requests)")
    scan_t = check_scan(effective_apps(apps, sneaks, True), trace[: args.per_app * len(specs)],
                        0.1)
    print(f"    (a) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print(f"  (b) Simulation(pipeline=True) against pipeline=False over phase 5's trace, "
          f"5 policies")
    scan_launches, scan_by_policy, scan_seconds, scan_sigs = check_pipeline_simulation(
        apps, sneaks, trace, args.seed)
    print(f"    (b, c) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print("  (d) EdgeServer(pipeline=True) on phase 11 (a)'s SimulatedBackend lanes")
    serve_closed_loop_simulated(args, profiles, closed_sneak, pipeline=True, want=closed_view)
    print(f"    (d) {time.perf_counter() - t0:.1f} s")
    print(f"    phases 1-12 {time.perf_counter() - t_start:.1f} s")

    print("[13] the chunked window: speculative chunked selection, one spec_scan launch per "
          "window")
    t0 = time.perf_counter()
    print(f"  (a) the chunked scan against its plain version and the sequential scan on phase "
          f"12 (a)'s inputs, chunks {SPEC_CHUNKS}")
    spec_t = check_spec_scan(effective_apps(apps, sneaks, True),
                             trace[: args.per_app * len(specs)], 0.1, scan_t)
    print(f"    (a) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print(f"  (b) Simulation(pipeline=True, chunk={PIPELINE_CHUNK}) against phase 12 (b)'s "
          "chunk=0 schedules, 5 policies")
    spec_by_policy, _ = check_chunked_simulation(apps, sneaks, trace, args.seed, scan_sigs)
    print(f"    (b) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print(f"  (c) EdgeServer(pipeline=True, chunk={PIPELINE_CHUNK}) on phase 11 (a)'s "
          "SimulatedBackend lanes")
    serve_closed_loop_simulated(args, profiles, closed_sneak, pipeline=True, want=closed_view,
                                chunk=PIPELINE_CHUNK)
    print(f"    (c) {time.perf_counter() - t0:.1f} s")
    print(f"    phases 1-13 {time.perf_counter() - t_start:.1f} s")

    print("[14] the recurrent and sparse mixers: recurrentgemma-9b and llama4")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    print("  (a) float32 models, card against host: one period of recurrentgemma-9b (rglru, "
          "rglru, local), one layer of llama4-scout-17b-16e (attn:moe, 16 experts)")
    check_model_card_vs_host(args.seed, "recurrentgemma-9b", 300, None, layers=3,
                             compare=(0, 1, 2))
    check_model_card_vs_host(args.seed, "llama4-scout-17b-16e", 256, None, layers=1,
                             compare=(0,), routes=True)
    gc.collect()
    torch.cuda.empty_cache()
    rglru_t = check_rglru(args.seed)
    flash_new, decode_new = check_new_attention_shapes(args.seed)
    flash_t.update(flash_new)
    decode_t.update(decode_new)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"    (a) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print(f"  (b) EdgeServer, SneakPeek, {args.serve_requests} requests on recurrentgemma-9b "
          f"(38 layers) and llama4-scout-17b-16e (full width, {SCOUT_LAYERS} layers), bf16, "
          "then on each alone")
    rec_launches = serve_new_families(args)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"    (b) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print("  (c) llama4-maverick-400b-128e, one period, alone")
    check_maverick(args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"    (c) {time.perf_counter() - t0:.1f} s")

    print("[15] sharded window scheduling: ShardedWindowPipeline, the shard_round kernel")
    gc.collect()
    torch.cuda.empty_cache()
    window0 = trace[: args.per_app * len(specs)]
    t0 = time.perf_counter()
    print(f"  (a) shard_round against its plain version on phase 5's first window, "
          f"{MAIN_SHARDS} shards, chunk 0")
    shard_t = check_shard_round(effective_apps(apps, sneaks, True), window0, 0.1)
    print(f"    (a) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print(f"  (b) the sharded selectors at {SHARD_COUNTS} shards, chunks {SHARD_CHUNKS}, against "
          "the unsharded route")
    shard_b = check_sharded_selectors(effective_apps(apps, sneaks, True), window0, 0.1)
    print(f"    (b) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print(f"  (c) Simulation(shard={MAIN_SHARDS}, chunk={PIPELINE_CHUNK}) over phase 5's trace; "
          "shard=True on this card")
    shard_launches, _ = check_sharded_simulation(apps, sneaks, trace, args.seed,
                                                 scan_sigs["SneakPeek"])
    print(f"    (c) {time.perf_counter() - t0:.1f} s")

    print("[16] training: the backward kernels K3b, K5b and rglru_scan_bwd, a step card against "
          "host, then mamba2-130m, tinyllama-1.1b, recurrentgemma-9b and gemma-7b trained at "
          "full width in bf16")
    gc.collect()
    torch.cuda.empty_cache()
    t16 = time.perf_counter()
    t0 = time.perf_counter()
    print("  (a) K3b (head dims 64, 128 and 256), K5b and rglru_scan_bwd against their plain "
          "versions at the training shapes")
    k3b_t, k5b_t, rglru_bwd_t = check_backward_kernels(args.seed)
    print(f"    (a) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print("  (b) one training step, float32, at full width, card against host: 2 layers "
          "(mamba2-130m also with 2 SSD groups), and recurrentgemma-9b's one period")
    with heap_allocations():
        step_checks = {
            label: check_train_step_card_vs_host(args.seed, arch, layers=layers, regrad=regrad,
                                                 groups=groups)
            for label, arch, layers, regrad, groups in (
                ("mamba2-130m", "mamba2-130m", 2, True, 1),
                ("mamba2-130m/g2", "mamba2-130m", 2, True, 2),
                ("tinyllama-1.1b", "tinyllama-1.1b", 2, True, 1),
                ("recurrentgemma-9b", "recurrentgemma-9b", 3, False, 1),
                ("gemma-7b", "gemma-7b", 2, False, 1))}
    gc.collect()
    torch.cuda.empty_cache()
    print(f"    (b) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print(f"  (c) training at full width, bf16, LMDataset's markov stream, B={TRAIN_BATCH} "
          f"S={TRAIN_SEQ}")
    trained = train_full_width(args.seed)
    print(f"    (c) {time.perf_counter() - t0:.1f} s; phase 16 {time.perf_counter() - t16:.1f} s")
    for t, name in ((k3b_t, "flash_attention_bwd"), (k5b_t, "ssd_bwd"),
                    (rglru_bwd_t["train"], "rglru_scan_bwd")):
        print(f"    {name} at {t['shape']}: kernel {t['ms']:.6f} ms on the device, plain "
              f"{t['plain_ms']:.6f} ms, library "
              + ("none" if t["library_ms"] is None else f"{t['library_ms']:.6f} ms (SDPA backward)")
              + f", bound {t['bound_ms']:.6f} ms ({t['bound_by']})")
    train_launches = {name: sum(run["launches"].get(name, 0) for run in trained.values())
                      for name in TRAIN_KERNELS}

    print("[17] the launchers: python -m repro_torch.launch.train --mesh data,model=1,1 beside "
          "the unsharded Trainer, python -m repro_torch.launch.serve, EdgeServer over "
          "CostModelBackend lanes")
    gc.collect()
    torch.cuda.empty_cache()
    t17 = time.perf_counter()
    t0 = time.perf_counter()
    print(f"  (a) {LAUNCH_ARCH} at full width, B={LAUNCH_BATCH} S={LAUNCH_SEQ}, {LAUNCH_STEPS} "
          "steps: the train launcher on a one-rank NCCL mesh, then the unsharded Trainer")
    launch_train, train_cli_launches = check_train_launcher()
    print(f"    (a) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print(f"  (b) python -m repro_torch.launch.serve {' '.join(LAUNCH_SERVE)}")
    serve_cli_launches, serve_cli_s = check_serve_launcher()
    print(f"    (b) {time.perf_counter() - t0:.1f} s")
    launcher_launches = {name: train_cli_launches.get(name, 0) + serve_cli_launches.get(name, 0)
                         for name in set(train_cli_launches) | set(serve_cli_launches)}
    missing = [name for name in LAUNCHER_KERNELS if not launcher_launches.get(name)]
    require(not missing, f"the launchers' runs launched no {missing}")
    t0 = time.perf_counter()
    print("  (c) EdgeServer over CostModelBackend lanes, two workers, card against host")
    costmodel_pool = serve_costmodel_pool(args, closed_sneak)
    print(f"    (c) {time.perf_counter() - t0:.1f} s; phase 17 {time.perf_counter() - t17:.1f} s")

    print("[18] the dry run: five production cells on a fake (16, 16) world, and its "
          "one-rank predictions against the sharded train and prefill steps on the card")
    gc.collect()
    torch.cuda.empty_cache()
    t18 = time.perf_counter()
    dry = check_dryrun(args.seed, card)
    print(f"    phase 18 {time.perf_counter() - t18:.1f} s")

    print("[19] the examples: examples/torch_*.py through their main, edge_serving and "
          "executor_backends at published widths, the other four card against host")
    gc.collect()
    torch.cuda.empty_cache()
    t19 = time.perf_counter()
    examples, examples_launches = run_examples(card)
    print(f"    phase 19 {time.perf_counter() - t19:.1f} s")

    rows = [
        ("knn_topk", "knn/csrc/knn.cu", "knn/kernel.py:92", launches, knn_t),
        ("utility_scores", "utility/csrc/utility.cu", "utility/kernel.py:56", launches, util_t),
        ("flash_attention", "flash_attention/csrc/flash_attention.cu",
         "flash_attention/kernel.py:89", serve_launches, flash_t),
        ("decode_attention", "decode_attention/csrc/decode_attention.cu",
         "decode_attention/kernel.py:71", serve_launches, decode_t),
        ("ssd", "ssd/csrc/ssd.cu", "ssd/kernel.py:91", serve_launches, ssd_t),
    ]
    table = {"kernels": [
        {"name": name, "route": "cuda", "source": f"src/repro_torch/kernels/{source}",
         "replaces": f"src/repro/kernels/{replaces}", "launches": counts[name],
         "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
         "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
         "shape": t["shape"],
         **{key: t[key] for key in ("stage_ms", "at_d256", "windowed", "placement",
                                    "recurrentgemma_local", "llama4", "non_causal", "f32",
                                    "f32_non_causal", "f32_d256", "groups")
            if key in t}}
        for name, source, replaces, counts, t in rows
    ]}
    for row in table["kernels"]:  # phase 10's run (a) 2 and phase 11 (b), counted from 0
        row["launches_pool"] = pool.get(row["name"], 0)
        row["launches_closed_loop"] = closed.get(row["name"], 0)
        row["launches_new_families"] = rec_launches.get(row["name"], 0)  # phase 14 (b)
        row["launches_training"] = train_launches.get(row["name"], 0)  # phase 16 (c)
        row["launches_launchers"] = launcher_launches.get(row["name"], 0)  # phase 17 (a), (b)
    # The scan replaces the compiled lax.scans of the reference's window
    # programs (no Pallas kernel); its launches are phase 12 (b)'s SneakPeek
    # run, its times those of LO-EDF's 4095-step scan in phase 12 (a).
    main_scan = scan_t["LO-EDF, slot1"]
    table["kernels"].append({
        "name": "selection_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/selection_scan/csrc/selection_scan.cu",
        "replaces": "src/repro/core/pipeline.py:519", "launches": scan_launches,
        **{key: main_scan[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms", "shape",
                                           "chain_bound_ms")},
        "programs": scan_t, "launches_by_policy": scan_by_policy})
    # The chunked scan replaces the reference's speculative drivers (no
    # Pallas kernel); its launches are phase 13 (b)'s SneakPeek run, its
    # times those of LO-EDF's per-request scan at chunk 16 in phase 13 (a).
    main_spec = spec_t[f"LO-EDF, slot1, chunk {PIPELINE_CHUNK}"]
    table["kernels"].append({
        "name": "spec_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/spec_scan/csrc/spec_scan.cu",
        "replaces": "src/repro/core/pipeline.py:244", "launches": spec_by_policy["SneakPeek"],
        **{key: main_spec[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms", "shape", "sequential_ms",
                                           "rounds", "conflicts", "chain_bound_ms")},
        "programs": spec_t, "launches_by_policy": spec_by_policy})
    # The RG-LRU scan replaces the reference's associative scan (no Pallas
    # kernel); its launches are phase 14 (b)'s run, its times those of
    # recurrentgemma-9b's prefill shape.
    table["kernels"].append({
        "name": "rglru_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
        "replaces": "src/repro/models/rglru.py:77", "launches": rec_launches.get("rglru_scan", 0),
        **rglru_t["prefill"], "decode": rglru_t["decode"], "lone_prompt": rglru_t["lone_prompt"]})
    # The sharded rounds replace the per-shard programs of the reference's
    # sharded pipeline (no Pallas kernel); the launches are phase 15 (c)'s
    # run, the times those of LO-EDF's largest block and longest chain in
    # phase 15 (a).
    main_shard = shard_t["LO-EDF, slot1"]
    table["kernels"].append({
        "name": "shard_round", "route": "cuda",
        "source": "src/repro_torch/kernels/shard_round/csrc/shard_round.cu",
        "replaces": "src/repro/core/shard.py:162", "launches": shard_launches["shard_round"],
        **{key: main_shard[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms", "shape",
                                            "chain_bound_ms", "chain_ms", "chain_plain_ms",
                                            "accept_ms", "accept_plain_ms", "accept_bound_ms",
                                            "instance", "cluster_blocks")},
        "programs": shard_t,
        "selectors": {key: {"s": secs, "launches": n, "stats": st, "read_backs": rb}
                      for key, (secs, n, st, rb) in shard_b.items()}})
    # The backward kernels replace the reference's gradients (its flash
    # attention's custom VJP; jax.grad through its SSD scan and its RG-LRU
    # gates and associative scan); their launches are phase 16 (c)'s
    # training runs, their times phase 16 (a)'s.
    for name, source, replaces, t in (
            ("flash_attention_bwd", "flash_attention/csrc/flash_attention_bwd.cu",
             "src/repro/models/attention.py:265", k3b_t),
            ("ssd_bwd", "ssd/csrc/ssd_bwd.cu", "src/repro/models/ssd.py:83", k5b_t),
            ("rglru_scan_bwd", "rglru_scan/csrc/rglru_scan_bwd.cu",
             "src/repro/models/rglru.py:77", {**rglru_bwd_t["train"], "cases": rglru_bwd_t})):
        table["kernels"].append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/{source}",
            "replaces": replaces, "launches": train_launches[name],
            **{key: t[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                       "library_ms", "shape", "stage_ms")},
            **{key: t[key] for key in ("f32", "llama4", "windowed", "cases", "groups",
                                       *K3B_D256_SHAPES)
               if key in t}})
    table["launchers"] = {"train": launch_train, "train_launches": train_cli_launches,
                          "serve_launches": serve_cli_launches, "serve_s": serve_cli_s,
                          "costmodel_pool": costmodel_pool}
    table["dry_run"] = dry
    table["examples"] = examples
    for row in table["kernels"]:  # phase 19: the card's runs of the six examples
        row["launches_examples"] = examples_launches.get(row["name"], 0)
    for row in table["kernels"]:  # phase 18 (b), (c): the real steps' launches
        row["launches_dry_run_steps"] = sum(
            dry[k]["launches"].get(row["name"], 0) for k in ("train", "prefill"))
    table["training"] = {"step_card_vs_host": step_checks, **{
        arch: {k: v for k, v in run.items() if k != "launches"} for arch, run in trained.items()}}
    print(f"    total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
