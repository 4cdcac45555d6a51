#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # the full check, on one card

Builds the port's CUDA kernels from the checkout's sources, holds each
against its plain PyTorch version at the main path's shapes and times
both, then drives the main path: a SneakPeek ``Simulation`` over a
stream of 4096-request windows against k-NN training sets of 100,000
points per application, plus one window of each other policy.  Every
check raises on failure.  The last two lines of standard output are the
kernel table and ``{"ok": true, "device": {...}}``.

Imports nothing of the JAX package.  Exits non-zero, printing no
result, when CUDA is absent or the port's sources are not beside it.
"""
from __future__ import annotations

import argparse
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


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--train-n", type=int, default=100_000,
                   help="k-NN training set size per application (before the 20%% holdout)")
    p.add_argument("--per-app", type=int, default=1365,
                   help="requests per application per window (3 apps)")
    p.add_argument("--windows", type=int, default=8, help="windows of the main-path trace")
    p.add_argument("--k", type=int, default=5, help="k-NN neighbours")
    p.add_argument("--seed", type=int, default=0)
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


def device_ms(fn, kernel: str, iters: int) -> float:
    """Mean device time per call, in ms, of the kernels whose name contains
    ``kernel`` (``torch.profiler``), over ``iters`` calls of ``fn``: the
    kernel's own time, whatever the host spends around each launch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and kernel in e.name]
    require(len(spans) >= iters, f"profiler saw {len(spans)} {kernel} kernels for {iters} calls")
    return sum(spans) / 1e3 / iters


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


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

    # Times at the largest application's window shapes.
    n, d = sp._x.shape
    qn = q.shape[0]
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
    from repro_torch.kernels.utility.ref import utility_scores_ref

    rng = np.random.default_rng(seed)
    shapes = [(4096, 6, "tile"), (group_shape[0], group_shape[1], "row"),
              (1365, 1, "tile"), (7, 3, "row")]
    timing = {}
    for penalty in ("step", "linear", "sigmoid", "none"):
        for r, m, comp_kind in shapes:
            acc = rng.uniform(0, 1, (r, m))
            dl = rng.uniform(-0.05, 0.3, r)
            comp = rng.uniform(0.0, 0.6, (r, m) if comp_kind == "tile" else (m,))
            for dtype, exact in ((torch.float64, True), (torch.float32, False)):
                a, d, e = (torch.as_tensor(v, dtype=dtype, device="cuda")
                           for v in (acc, dl, comp))
                uk, mk = util_ops.utility_scores(a, d, e, penalty)
                ur, mr = utility_scores_ref(a, d, e, penalty)
                torch.cuda.synchronize()
                if exact:
                    require(torch.equal(uk, ur) and torch.equal(mk, mr),
                            f"f64 utility {penalty} {(r, m)}: not bit-identical")
                else:
                    err = max(float((uk - ur).abs().max()), float((mk - mr).abs().max()))
                    require(err <= 1e-6, f"f32 utility {penalty} {(r, m)}: {err} > 1e-6")
    print("  Eq. 2 utility: f64 bit-identical and f32 within 1e-6, 4 penalties x "
          f"{[(r, m) for r, m, _ in shapes]}")
    # Times at the main path's largest group tile, sigmoid, f64.
    r, m = group_shape
    a = torch.as_tensor(rng.uniform(0, 1, (r, m)), device="cuda")
    d = torch.as_tensor(rng.uniform(0.01, 0.3, r), device="cuda")
    e = torch.as_tensor(rng.uniform(0.0, 0.6, m), device="cuda")
    call = lambda: util_ops.utility_scores(a, d, e, "sigmoid")  # noqa: E731
    timing["ms"] = device_ms(call, "utility_kernel", iters=200)
    timing["call_ms"] = timed_ms(call, iters=200)  # wrapper, launch and means
    timing["plain_ms"] = timed_ms(lambda: utility_scores_ref(a, d, e, "sigmoid"), iters=5)
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
    return timing


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
    from repro_torch.core.scheduler import POLICY_NAMES, make_policy
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
    for name in sorted(built):
        log = (nvcc.BUILD_DIR / f"{name}.log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"    ptxas {name}: {line.strip()}")

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

    table = {"kernels": [
        {"name": "knn_topk", "route": "cuda",
         "source": "src/repro_torch/kernels/knn/csrc/knn.cu",
         "replaces": "src/repro/kernels/knn/kernel.py:92",
         "launches": launches["knn_topk"], "max_abs_err": knn_t["max_abs_err"],
         "ms": knn_t["ms"], "plain_ms": knn_t["plain_ms"], "bound_ms": knn_t["bound_ms"],
         "bound_by": knn_t["bound_by"], "library_ms": knn_t["library_ms"],
         "shape": knn_t["shape"]},
        {"name": "utility_scores", "route": "cuda",
         "source": "src/repro_torch/kernels/utility/csrc/utility.cu",
         "replaces": "src/repro/kernels/utility/kernel.py:56",
         "launches": launches["utility_scores"], "max_abs_err": util_t["max_abs_err"],
         "ms": util_t["ms"], "plain_ms": util_t["plain_ms"], "bound_ms": util_t["bound_ms"],
         "bound_by": util_t["bound_by"], "library_ms": util_t["library_ms"],
         "shape": util_t["shape"]},
    ]}
    for t, name in ((knn_t, "knn_topk"), (util_t, "utility_scores")):
        print(f"    {name} at {t['shape']}: kernel {t['ms']:.6f} ms on the device, "
              f"{t['call_ms']:.6f} ms per wrapper call back to back, plain "
              f"{t['plain_ms']:.6f} ms, bound {t['bound_ms']:.6f} ms ({t['bound_by']})")
    print(f"    total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
