#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # the full check, on one card

Builds the port's eleven CUDA kernel sources from the checkout, holds
each kernel against its plain PyTorch version at its path's shapes and
times both, then drives the paths of the port on the card:

* scheduling (phases 3-5): a SneakPeek ``Simulation`` over a stream of
  4096-request windows against k-NN training sets of 100,000 points per
  application (K2, K1), plus one window of each other policy;
* serving (phases 6-9): K3 (its bf16 tensor-core instance and its f32
  CUDA-core one), K4 and K5 (five kernels per call, each stage also held
  against its plain stage and timed) against their plain versions, K3
  and K4 also at head dim 256 (gemma-7b's shapes, gemma3-4b's windowed
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
  designs' times, two calls bit-identical;
  one training step of 2-layer float32 models at full width, card
  against host (loss, every gradient, the weights after 3 AdamW steps);
  then mamba2-130m (24 layers) through ``Trainer`` with checkpoints and
  an injected fault restored from one, and tinyllama-1.1b (22 layers)
  through ``make_train_step``, both bf16 at B=8 S=1024 on LMDataset's
  markov stream, with falling loss and exact K3/K3b/K5/K5b launches.

Every check raises on failure.  The last three lines of standard output
are the card's name and power limit, the kernel table and
``{"ok": true, "device": {...}}``.

Imports nothing of the JAX package.  Exits non-zero, printing no
result, when CUDA is absent or the port's sources are not beside it.
"""
from __future__ import annotations

import argparse
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


def hmma_count(lib_path) -> int | None:
    """Tensor-core (HMMA) instructions in a built library's SASS, or None
    where the toolkit has no ``cuobjdump``."""
    import shutil

    from torch.utils.cpp_extension import CUDA_HOME

    tool = shutil.which("cuobjdump")
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "cuobjdump").is_file():
        tool = str(Path(CUDA_HOME) / "bin" / "cuobjdump")
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    return sum("HMMA" in line for line in sass.splitlines())


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


# The head-dim-256 instances of K3 and K4 (mangled-name keys): ptxas's
# registers and spills are printed in phase 2.
D256_INSTANCES = {
    "flash_attention": ("flash_attention_bf16_kernelILi256E", "flash_attention_f32_kernelILi256E"),
    "decode_attention": ("decode_attention_kernelI13__nv_bfloat16Li256E",
                         "decode_attention_kernelIfLi256E"),
}


# K3b's bf16 instances (mangled-name keys): ptxas's registers are printed
# in phase 2, and a spill fails it.
K3B_BF16_INSTANCES = tuple(f"flash_attention_bwd_{part}_bf16_kernelILi{d}E"
                           for d in (16, 32, 64, 128) for part in ("dkdv", "dq"))


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


def _flash_plain(q, k, v, window):
    """K3's plain version, model layout in and out."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qk = q.reshape(b, sq, hkv, hq // hkv, d).permute(0, 2, 3, 1, 4)
    out = flash_attention_ref(qk, k.transpose(1, 2), v.transpose(1, 2), window=window)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)


def _decode_plain(q, k, v, lengths, window):
    """K4's plain version, model layout in and out."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    b, _, hq, d = q.shape
    hkv = k.shape[2]
    out = decode_attention_ref(q.reshape(b, hkv, hq // hkv, d), k.transpose(1, 2),
                               v.transpose(1, 2), lengths, window=window)
    return out.reshape(b, 1, hq, d)


def _flash_timing(q, k, v, window, flops, library):
    """K3 at one shape, checked against its plain version: device time,
    wrapper time, plain time, ``library`` time, and the bound from
    ``flops`` (bf16 operations) and the bytes of q, k, v and o."""
    import torch

    from repro_torch.kernels.flash_attention import ops as flash_ops

    b, s, hq, d = q.shape
    hkv = k.shape[2]
    out = flash_ops.flash_attention(q, k, v, window=window)
    err = _close(out, _flash_plain(q, k, v, window), ATTN_TOL["bfloat16"],
                 f"K3 at {tuple(q.shape)} window {window}")
    torch.testing.assert_close(library().transpose(1, 2).float(), out.float(),
                               atol=ATTN_TOL["bfloat16"], rtol=ATTN_TOL["bfloat16"])
    call = lambda: flash_ops.flash_attention(q, k, v, window=window)  # noqa: E731
    bytes_moved = 2 * (2 * b * s * hq * d + 2 * b * s * hkv * d)
    return {
        "ms": device_ms(call, "flash_attention", iters=10),
        "call_ms": timed_ms(call, iters=10),
        "plain_ms": timed_ms(lambda: _flash_plain(q, k, v, window), iters=3, warmup=1),
        "library_ms": timed_ms(library, iters=10),
        "bound_ms": max(flops / BF16_FLOP_PER_S, bytes_moved / HBM_BYTES_PER_S) * 1e3,
        "bound_by": ("operations" if flops / BF16_FLOP_PER_S > bytes_moved / HBM_BYTES_PER_S
                     else "bytes"),
        "max_abs_err": err,
        "shape": f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} bf16 causal"
                 + (f" window={window}" if window else ""),
    }


def check_flash(seed):
    """K3 against its plain version: the sweep of tests/test_kernels.py:22
    in f32 (the CUDA-core instance) and bf16 (the tensor-core instance),
    at its head dims and again at 256; then the serving shapes in bf16,
    timed beside SDPA: tinyllama's, gemma-7b's and gemma3-4b's windowed
    prefill."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as flash_ops

    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    sweep = [(2, 128, 4, 4, 32, 0), (1, 256, 8, 2, 64, 0), (2, 96, 4, 1, 32, 0),
             (1, 256, 4, 2, 32, 64), (1, 130, 2, 2, 16, 32)]
    for dims in ("its head dims", "head dim 256"):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            errs = []
            for b, s, hq, hkv, d, window in sweep:
                d = d if dims == "its head dims" else 256
                q = torch.randn((b, s, hq, d), generator=gen, device="cuda").to(dtype)
                k, v = (torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(dtype)
                        for _ in range(2))
                out = flash_ops.flash_attention(q, k, v, window=window)
                errs.append(_close(out, _flash_plain(q, k, v, window), ATTN_TOL[name],
                                   f"K3 {name} {(b, s, hq, hkv, d, window)}"))
            print(f"  K3 {name}: 5 configurations of tests/test_kernels.py at {dims} within "
                  f"{ATTN_TOL[name]}, max |d| {max(errs):.3g}")

    def inputs(b, s, hq, hkv, d):
        q = torch.randn((b, s, hq, d), generator=gen, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        return q, k, v

    def causal(q, k, v):
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                      enable_gqa=True)

    b, s, hq, hkv, d = 8, 1024, 32, 4, 64
    q, k, v = inputs(b, s, hq, hkv, d)
    # causal: half of QK^T and PV over the square
    t = _flash_timing(q, k, v, 0, 2 * b * hq * s * s * d, causal(q, k, v))
    print(f"  K3 serving shape {t['shape']}: max |d| {t['max_abs_err']:.3g} (tolerance 2e-2); "
          "SDPA agrees within 2e-2")
    del q, k, v

    b, s, hq, hkv, d = 8, 1024, 16, 16, 256  # gemma-7b's prefill, MHA
    q, k, v = inputs(b, s, hq, hkv, d)
    t["at_d256"] = _flash_timing(q, k, v, 0, 2 * b * hq * s * s * d, causal(q, k, v))
    print(f"  K3 gemma-7b shape {t['at_d256']['shape']}: max |d| "
          f"{t['at_d256']['max_abs_err']:.3g} (tolerance 2e-2); SDPA agrees within 2e-2")
    del q, k, v

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
    timed."""
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
                "shape": shape, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "chain_bound_ms": chain_ms, "max_abs_err": 0.0,
                "library_ms": None}
            print(f"    {label}, {res_mode} ({shape}): bit-identical; kernel {ms:.6f} ms on the "
                  f"device, plain {plain_ms:.3f} ms, bound {bound_ms:.6f} ms ({bound_by}), "
                  f"dependent chain {chain_ms:.6f} ms")
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
                    "conflicts": conflicts, "chain_bound_ms": chain_ms}
                print(f"    {label}, {res_mode}, chunk {chunk} ({shape}): bit-identical to its "
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


# recurrentgemma-9b's shapes in phase 14: batch, prefill length, LRU width.
RGLRU_SHAPE = (8, 1024, 4096)


def check_rglru(seed):
    """Phase 14: ``rglru_scan`` against its plain version on the card, at
    recurrentgemma-9b's width in bf16 (B = 8, S = 1024, L = 4096) and at
    S = 1 (a decode step): y within 2e-2 (its bf16 rounding), the last
    state within 1e-4 (float32 kept in both; the kernel's and PyTorch's
    transcendental functions differ in the last bits).  Times both; the
    bound is the bytes (u and g read, y written, in bf16; the gate vectors;
    h0 read and h written in float32) against about thirty float32
    operations an element.  The device time is ``torch.profiler``'s;
    back-to-back wrapper calls show the host's rate at S = 1."""
    import torch

    from repro_torch.kernels.rglru_scan import ops as rglru_ops
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

    gen = torch.Generator(device="cuda").manual_seed(seed + 14)
    out = {}
    for b, s, width in (RGLRU_SHAPE, RGLRU_SHAPE[:1] + (1,) + RGLRU_SHAPE[2:]):
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

        ms = device_ms(kernel, "rglru_scan_kernel", iters=20)
        call_ms = timed_ms(kernel, iters=20, warmup=3)
        nbytes = 3 * 2 * b * s * width + 5 * 2 * width + 2 * 4 * b * width
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        op_ms = 30.0 * b * s * width / FP32_FLOP_PER_S * 1e3
        key = "decode" if s == 1 else "prefill"
        out[key] = {"shape": f"B={b} S={s} L={width} bf16", "ms": ms, "call_ms": call_ms,
                    "plain_ms": plain_ms,
                    "bound_ms": max(bound_ms, op_ms),
                    "bound_by": "bytes" if bound_ms >= op_ms else "operations",
                    "max_abs_err": err, "library_ms": None}
        print(f"    rglru_scan at B={b} S={s} L={width} bf16: y within 2e-2 (max |d| {err:.3g}), "
              f"h within 1e-4; kernel {ms:.6f} ms on the device, {call_ms:.6f} ms per wrapper "
              f"call back to back, plain {plain_ms:.3f} ms, bound {max(bound_ms, op_ms):.6f} ms "
              f"({out[key]['bound_by']}), no library call")
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
    selectors make while entered (``core.shard``'s ``score_block`` and
    ``chain``), then restores them."""

    def __enter__(self):
        from repro_torch.core import shard as tshard

        self.score, self.chain = [], []
        self._real = (tshard.score_block, tshard.chain)

        def score(*a, **kw):
            self.score.append((a, kw))
            return self._real[0](*a, **kw)

        def chain(*a, **kw):
            self.chain.append((a, kw))
            return self._real[1](*a, **kw)

        tshard.score_block, tshard.chain = score, chain
        return self

    def __exit__(self, *exc):
        from repro_torch.core import shard as tshard

        tshard.score_block, tshard.chain = self._real
        return False


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


def check_shard_round(apps, reqs, now):
    """Phase 15 (a): ``shard_round`` against its plain version on the card,
    on the calls the sharded selectors make for phase 5's first window at
    MAIN_SHARDS shards, ``chunk=0`` — LO-EDF's per-request rows, SneakPeek's
    grouped rows, SneakPeek on four workers — each with the single-slot
    and the LRU carry: the first speculation's ``score_block`` (the
    largest block) and the longest ``chain``, every output bit-identical.
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
    from repro_torch.kernels.shard_round.ref import chain_ref, score_block_ref

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
                s_args, s_kw = max(calls.score, key=lambda c: c[0][3].shape[0])
                c_args, c_kw = max(calls.chain, key=lambda c: c[0][5].shape[0])
                got = shard_ops.score_block(*s_args, **s_kw)
                torch.cuda.synchronize()
                t = time.perf_counter()
                want = score_block_ref(*s_args, **s_kw)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t) * 1e3
                require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                        f"{label}, {res_mode}: score_block differs from its plain version")
                got_c = shard_ops.chain(*c_args, **c_kw)
                torch.cuda.synchronize()
                t = time.perf_counter()
                want_c = chain_ref(*c_args, **c_kw)
                torch.cuda.synchronize()
                chain_plain_ms = (time.perf_counter() - t) * 1e3
                require(torch.equal(got_c[0], want_c[0]) and torch.equal(got_c[1], want_c[1]),
                        f"{label}, {res_mode}: chain differs from its plain version")
                ms = device_ms(lambda: shard_ops.score_block(*s_args, **s_kw),
                               "shard_round_score", iters=5)
                chain_ms = device_ms(lambda: shard_ops.chain(*c_args, **c_kw),
                                     "shard_round_chain", iters=5)
                bound_ms, bound_by, shape = _score_numbers(s_args, s_kw)
                n_pos = c_args[5].shape[0]
                chain_bound = 3.0 * n_pos * F64_DEP_CYCLES / clock * 1e3
                out[f"{label}, {res_mode}"] = {
                    "shape": shape, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "max_abs_err": 0.0, "library_ms": None,
                    "chain_positions": n_pos, "chain_ms": chain_ms,
                    "chain_plain_ms": chain_plain_ms, "chain_bound_ms": chain_bound,
                    "calls": (len(calls.score), len(calls.chain))}
                print(f"    {label}, {res_mode}: score_block ({shape}) and chain ({n_pos} "
                      f"positions) bit-identical to their plain versions; score_block "
                      f"{ms:.6f} ms on the device, plain {plain_ms:.3f} ms, bound "
                      f"{bound_ms:.6f} ms ({bound_by}); chain {chain_ms:.6f} ms, plain "
                      f"{chain_plain_ms:.3f} ms, dependent chain {chain_bound:.6f} ms; the "
                      f"window made {len(calls.score)} score_block and {len(calls.chain)} "
                      "chain calls")
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
    (seconds per window, shard_round launches, shard stats)}."""
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
                        out[key] = (secs, launched, stats)
                        print(f"    {key}: equal to the unsharded route; {secs:.4f} s, "
                              f"{launched} shard_round launches, {stats}"
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
# printed in brackets beside this run's times.
K3B_FIRST_MS = {"tinyllama": 7.091728, "f32": 7.265763, "llama4": 5.685508, "windowed": 5.121812}
K5B_FIRST_MS = 2.239300
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
MAMBA_STEPS, MAMBA_FAULT_AT, TINY_STEPS = 30, 15, 20


def _flash_bwd_plain(q, k, v, o, do, lse, window):
    """K3b's plain version, model layout in and out."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref

    b, sq, hq, d = q.shape
    hkv = k.shape[2]

    def gqa(t):
        return t.reshape(b, sq, hkv, hq // hkv, d).permute(0, 2, 3, 1, 4)

    dq, dk, dv = flash_attention_bwd_ref(gqa(q), k.transpose(1, 2), v.transpose(1, 2), gqa(o),
                                         gqa(do), lse.reshape(b, hkv, hq // hkv, sq),
                                         window=window)
    return dq.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d), dk.transpose(1, 2), dv.transpose(1, 2)


def _flash_bwd_case(gen, b, s, hq, hkv, d, window, dtype, timed=False):
    """K3b at one shape against its plain version on the same forward
    output and logsumexp, and two calls bit-identical; with ``timed``, its
    device time (and by kernel),
    the plain version's, SDPA's backward (forward and backward less the
    forward; with a window, through a boolean causal-and-window mask) and
    the bound."""
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
    bytes_moved = item * (2 * (3 * b * s * hq * d + 2 * b * s * hkv * d)) + 4 * b * hq * s
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    call = lambda: flash_ops.flash_attention_bwd(q, k, v, out, do, lse, window=window)  # noqa: E731
    ms, stage_ms = device_ms(call, "flash_attention_bwd", iters=5, parts=K3B_STAGES)
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
        "ms": ms, "stage_ms": stage_ms,
        "plain_ms": timed_ms(lambda: _flash_bwd_plain(q, k, v, out, do, lse, window), iters=2,
                             warmup=1),
        "library_ms": timed_ms(sdpa_fwd_bwd, iters=10) - timed_ms(sdpa, iters=10),
        "bound_ms": max(flops / peak, bytes_moved / HBM_BYTES_PER_S) * 1e3,
        "bound_by": "operations" if flops / peak > bytes_moved / HBM_BYTES_PER_S else "bytes",
    })
    return t


def _ssd_bwd_flops(b, s, h, p, n, chunk):
    """The multiply-adds K5b's stages do, times 2: per (batch row, chunk)
    the scores and the two d(scores) products over the lower 64 x 64 tiles;
    per head dE, the two products of dx, d(scores) and the two of dC/dB."""
    nc, nt = s // chunk, -(-chunk // 64)
    tiles = nt * (nt + 1) // 2
    per_chunk = 2 * (tiles * 64 * 64 * n + 2 * tiles * 64 * 64 * n)
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
    ops_s = min(3 * flops / TF32_FLOP_PER_S, flops / FP32_FLOP_PER_S)
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
    del x, dt, a_log, bm, cm, dA, xdt, dy, cum, entering

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
    return k3b, k5b


def check_train_step_card_vs_host(seed, arch, layers=2, batch=2, seq=256, steps=3):
    """Phase 16 (b): one training step of a float32 model at ``arch``'s
    widths, ``layers`` layers, card against host: the loss within 1e-4,
    every gradient leaf within atol 1e-4 + rtol 1e-3, and the weights after
    ``steps`` AdamW steps within 1e-4.  The learning rate is 1e-3 from the
    first step, so the steps move the weights by more than ten times that
    tolerance (required): a missing, reversed or misscaled update on the
    card would show.  Adam's eps is 1e-4: the first update is
    g / (|g| + eps), whose change with g is at most 1 / eps, so at eps 1e-8
    a gradient of ~1e-8 that differs by float32 rounding between card and
    host moves its weight by a different ~lr (21 embedding values past 1e-4
    on the card); at 1e-4 the gradients' measured agreement (< 2e-7) bounds
    the weights' difference to ~lr * 2e-3 a step."""
    import dataclasses

    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.data import LMDataConfig, LMDataset
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import LM
    from repro_torch.models.transformer import TransformerParams
    from repro_torch.training import OptimizerConfig, init_opt_state
    from repro_torch.training.optimizer import tree_leaves, tree_map

    cfg = dataclasses.replace(ARCHS[arch], num_layers=layers, dtype="float32")
    lm = LM(cfg)
    host = lm.init(seed, device="cpu")
    card = TransformerParams(cfg, tree_map(lambda t: t.to("cuda"), host.to_tree()))
    data = LMDataset(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
                                  seed=seed))

    def batch_at(step, dev):
        return {"tokens": torch.as_tensor(data.batch_at(step)["tokens"], device=dev)}

    out = {}
    for name, params, dev in (("card", card, "cuda"), ("host", host, "cpu")):
        params.requires_grad_(True)
        loss, _ = lm.loss(params, batch_at(0, dev))
        loss.backward()
        out[name] = (loss.item(), [g.cpu() for g in tree_leaves(params.grad_tree())])
        params.zero_grad(set_to_none=True)
    loss_err = abs(out["card"][0] - out["host"][0])
    require(loss_err <= 1e-4, f"{arch}: the loss {out['card'][0]} on the card, "
                              f"{out['host'][0]} on the host")
    grad_err = max(_close(g, h, 1e-4, f"{arch} gradient leaf {i}", rtol=1e-3)
                   for i, (g, h) in enumerate(zip(out["card"][1], out["host"][1])))
    opt = OptimizerConfig(learning_rate=1e-3, warmup_steps=1, eps=1e-4)
    start = [t.clone() for t in tree_leaves(host.to_tree())]
    step_fn = make_train_step(lm, opt)
    states = {"card": init_opt_state(card.to_tree(), opt),
              "host": init_opt_state(host.to_tree(), opt)}
    for step in range(steps):
        card, states["card"], _ = step_fn(card, states["card"], batch_at(step, "cuda"))
        host, states["host"], _ = step_fn(host, states["host"], batch_at(step, "cpu"))
    weight_err = max(_close(c.cpu(), h, 1e-4, f"{arch} weight leaf {i} after {steps} steps",
                            rtol=0.0)
                     for i, (c, h) in enumerate(zip(tree_leaves(card.to_tree()),
                                                    tree_leaves(host.to_tree()))))
    moved = max(float((h - w0).abs().max()) for h, w0 in zip(tree_leaves(host.to_tree()), start))
    require(moved >= 1e-3, f"{arch}: {steps} AdamW steps moved no weight by 1e-3 (max {moved})")
    print(f"  {arch}, {layers} layers at full width, float32, B={batch} S={seq}: loss "
          f"{out['card'][0]:.6f}, |d| {loss_err:.3g}; {len(out['card'][1])} gradient leaves, "
          f"max |d| {grad_err:.3g}; weights after {steps} AdamW steps at lr 1e-3, eps 1e-4 "
          f"(moved up to {moved:.3g}), max |d| card against host {weight_err:.3g}")
    return {"loss_err": loss_err, "grad_err": grad_err, "weight_err": weight_err,
            "weights_moved": moved}


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
    print(f"  {arch}: losses {losses[0]:.4f} -> {losses[-1]:.4f} (last 5 mean {tail:.4f}); "
          f"median step {med:.4f} s, {TRAIN_BATCH * TRAIN_SEQ / med:.1f} tokens/s; peak "
          f"{peak_gb:.3f} GB; launches a step: "
          + ", ".join(f"{k} {launches.get(k, 0) / executed:g}" for k in
                      ("flash_attention", "flash_attention_bwd", "ssd", "ssd_bwd")))
    return {"first_loss": losses[0], "last5_loss": tail, "step_s_median": med,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med, "peak_gb": peak_gb,
            "steps_run": executed, "launches": launches}


def train_full_width(seed):
    """Phase 16 (c): mamba2-130m through ``Trainer`` (checkpoints every 10
    steps, a fault injected at step 15 that restores step 10) and
    tinyllama-1.1b through ``make_train_step``, both at full width in bf16
    on LMDataset's markov stream, B=8 S=1024."""
    import tempfile

    import torch

    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.data import LMDataConfig, LMDataset
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import LM
    from repro_torch.training import OptimizerConfig, Trainer, TrainerConfig, init_opt_state

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
        {"ssd": 2 * cfg.num_layers, "ssd_bwd": cfg.num_layers, "flash_attention": 0,
         "flash_attention_bwd": 0}, executed)
    out["mamba2-130m"].update({"wall_s": wall, "restarts": summary["restarts"],
                               "stragglers": summary["stragglers"]})
    print(f"    mamba2-130m: {executed} steps run ({MAMBA_STEPS} + the {MAMBA_FAULT_AT - 11} "
          f"after the checkpoint of step 10, again), checkpoints at 0, 10, 20 and "
          f"{MAMBA_STEPS - 1}, {wall:.1f} s")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    cfg = ARCHS["tinyllama-1.1b"]
    lm = LM(cfg)
    data = LMDataset(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, seed=seed))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init(seed, device="cuda")
    state = init_opt_state(params.to_tree(), opt)
    step_fn = make_train_step(lm, opt)
    kernels.reset_launch_counts()
    losses, times = [], []
    t0 = time.perf_counter()
    for step in range(TINY_STEPS):
        t1 = time.perf_counter()
        batch = {k: torch.as_tensor(v, device="cuda") for k, v in data.batch_at(step).items()}
        params, state, metrics = step_fn(params, state, batch)
        losses.append(float(metrics["loss"]))
        times.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    out["tinyllama-1.1b"] = _training_summary(
        "tinyllama-1.1b", losses, times, peak, launches,
        {"flash_attention": 2 * cfg.num_layers, "flash_attention_bwd": cfg.num_layers,
         "ssd": 0, "ssd_bwd": 0}, TINY_STEPS)
    out["tinyllama-1.1b"]["wall_s"] = wall
    print(f"    tinyllama-1.1b: {TINY_STEPS} steps through make_train_step, no checkpoint, "
          f"{wall:.1f} s")
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


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
    k3_bf16 = ptxas_registers("flash_attention", D256_INSTANCES["flash_attention"][:1])
    require(" 0 bytes spill stores" in next(iter(k3_bf16.values())),
            "K3's bf16 instance at head dim 256 spills registers")
    for name, what in (("flash_attention_bwd", "K3b"), ("ssd_bwd", "K5b")):
        hmma = hmma_count(nvcc.SOURCES[name].library_path())
        if hmma is None:
            print(f"    cuobjdump not found: {what}'s SASS not inspected")
        else:
            require(hmma > 0, f"{what}'s library holds no HMMA (tensor-core) instruction")
            print(f"    {what} library SASS: {hmma} HMMA (tensor-core) instructions")
    k3b_bf16 = ptxas_registers("flash_attention_bwd", K3B_BF16_INSTANCES)
    require(sorted(k3b_bf16) == sorted(K3B_BF16_INSTANCES),
            f"ptxas reported no {set(K3B_BF16_INSTANCES) - set(k3b_bf16)}")
    for key, line in k3b_bf16.items():
        print(f"    ptxas K3b bf16, {key}: {line}")
        require(" 0 bytes spill stores" in line, f"K3b's bf16 instance {key} spills registers")

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
                    (flash_t["windowed"], "flash_attention"), (decode_t, "decode_attention"),
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

    print("[16] training: the backward kernels K3b and K5b, a step card against host, then "
          "mamba2-130m and tinyllama-1.1b trained at full width in bf16")
    gc.collect()
    torch.cuda.empty_cache()
    t16 = time.perf_counter()
    t0 = time.perf_counter()
    print("  (a) K3b and K5b against their plain versions at the training shapes")
    k3b_t, k5b_t = check_backward_kernels(args.seed)
    print(f"    (a) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print("  (b) one training step, float32, 2 layers at full width, card against host")
    step_checks = {arch: check_train_step_card_vs_host(args.seed, arch)
                   for arch in ("mamba2-130m", "tinyllama-1.1b")}
    gc.collect()
    torch.cuda.empty_cache()
    print(f"    (b) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print(f"  (c) training at full width, bf16, LMDataset's markov stream, B={TRAIN_BATCH} "
          f"S={TRAIN_SEQ}")
    trained = train_full_width(args.seed)
    print(f"    (c) {time.perf_counter() - t0:.1f} s; phase 16 {time.perf_counter() - t16:.1f} s")
    for t, name in ((k3b_t, "flash_attention_bwd"), (k5b_t, "ssd_bwd")):
        print(f"    {name} at {t['shape']}: kernel {t['ms']:.6f} ms on the device, plain "
              f"{t['plain_ms']:.6f} ms, library "
              + ("none" if t["library_ms"] is None else f"{t['library_ms']:.6f} ms (SDPA backward)")
              + f", bound {t['bound_ms']:.6f} ms ({t['bound_by']})")
    train_launches = {name: sum(run["launches"].get(name, 0) for run in trained.values())
                      for name in ("flash_attention", "flash_attention_bwd", "ssd", "ssd_bwd")}

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
                                    "recurrentgemma_local", "llama4")
            if key in t}}
        for name, source, replaces, counts, t in rows
    ]}
    for row in table["kernels"]:  # phase 10's run (a) 2 and phase 11 (b), counted from 0
        row["launches_pool"] = pool.get(row["name"], 0)
        row["launches_closed_loop"] = closed.get(row["name"], 0)
        row["launches_new_families"] = rec_launches.get(row["name"], 0)  # phase 14 (b)
        row["launches_training"] = train_launches.get(row["name"], 0)  # phase 16 (c)
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
        **rglru_t["prefill"], "decode": rglru_t["decode"]})
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
                                            "chain_bound_ms", "chain_ms", "chain_plain_ms")},
        "programs": shard_t,
        "selectors": {key: {"s": secs, "launches": n, "stats": st}
                    for key, (secs, n, st) in shard_b.items()}})
    # The backward kernels replace the reference's gradients (its flash
    # attention's custom VJP; jax.grad through its SSD scan); their launches
    # are phase 16 (c)'s training runs, their times phase 16 (a)'s.
    for name, source, replaces, t in (
            ("flash_attention_bwd", "flash_attention/csrc/flash_attention_bwd.cu",
             "src/repro/models/attention.py:265", k3b_t),
            ("ssd_bwd", "ssd/csrc/ssd_bwd.cu", "src/repro/models/ssd.py:83", k5b_t)):
        table["kernels"].append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/{source}",
            "replaces": replaces, "launches": train_launches[name],
            **{key: t[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                       "library_ms", "shape", "stage_ms")},
            **{key: t[key] for key in ("f32", "llama4", "windowed") if key in t}})
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
