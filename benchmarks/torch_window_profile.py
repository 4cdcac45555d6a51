"""Where one SneakPeek window's time goes in the PyTorch port.

Drives the port's main path (the configuration of ``chip_smoke.py``:
three applications, k-NN training sets of ``--train-n`` points, windows
of ``--per-app`` requests per application, short-circuit on) through a
``Simulation`` and reports, per window, the SneakPeek stage, the
scheduling pass and the commit (``evaluate``) on the host clock; then
profiles the same windows with ``cProfile`` (host functions by own
time) and, on a card, with ``torch.profiler`` (device time by kernel,
and the device's busy share of the wall time).

    python3 benchmarks/torch_window_profile.py              # on the card
    python3 benchmarks/torch_window_profile.py --device cpu --train-n 3000

Host-clock numbers from ``--device cpu`` describe the host code only.
Writes the full tables to ``--out`` (default ``build/profile/``).
"""
from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def make_trace(specs, per_app, windows, seed, make_requests):
    trace = []
    for w in range(windows):
        reqs = make_requests(specs, per_app=per_app, deadline_std_s=0.05,
                             seed=seed + w, start_rid=w * per_app * len(specs))
        for r in reqs:
            r.arrival_s += 0.1 * w
            r.deadline_s += 0.1 * w
        trace.extend(reqs)
    return trace


def run_windows(sim, trace, sync):
    """Per-window (ingest, schedule, evaluate) host seconds of ``sim``'s stream."""
    from repro_torch.core.evaluation import evaluate
    from repro_torch.core.scheduler import schedule_window
    from repro_torch.core.sneakpeek import attach_sneakpeek

    rows = []
    for w, batch in sim._window_batches(trace, None):
        close = (w + 1) * sim.window_s
        t0 = time.perf_counter()
        attach_sneakpeek(batch, sim.apps, sim.sneakpeeks, device=sim.device)
        sync()
        t1 = time.perf_counter()
        sched, eff = schedule_window(sim.policy, batch, sim._eff_apps, close,
                                     state=sim.state, device=sim.device)
        sync()
        t2 = time.perf_counter()
        evaluate(sched, eff, close, acc_mode="oracle", state=sim.state, device=sim.device)
        sync()
        t3 = time.perf_counter()
        rows.append({"window": w, "n": len(batch), "ingest_s": t1 - t0,
                     "schedule_s": t2 - t1, "evaluate_s": t3 - t2})
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--train-n", type=int, default=100_000)
    p.add_argument("--per-app", type=int, default=1365)
    p.add_argument("--windows", type=int, default=4)
    p.add_argument("--policy", default="SneakPeek")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=str(ROOT / "build" / "profile"))
    args = p.parse_args(argv)

    import torch

    from repro_torch.core.scheduler import make_policy
    from repro_torch.core.simulator import Simulation
    from repro_torch.data.applications import APP_SPECS, build_benchmark_suite, make_requests
    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    specs = list(APP_SPECS.values())
    apps, sneaks = build_benchmark_suite(seed=args.seed, train_n=args.train_n, device=dev)
    report = {"device": torch.cuda.get_device_name(0) if on_card else "cpu",
              "config": vars(args)}

    def fresh(seed):
        sim = Simulation(make_policy(args.policy), apps, sneakpeeks=sneaks,
                         short_circuit=True, seed=args.seed, device=dev)
        return sim, make_trace(specs, args.per_app, args.windows, seed, make_requests)

    sim, trace = fresh(args.seed + 1)  # warm-up: builds kernels, fills caches
    run_windows(sim, trace, sync)

    sim, trace = fresh(args.seed + 2)
    rows = run_windows(sim, trace, sync)
    report["windows"] = rows
    for row in rows:
        print(json.dumps(row))

    sim, trace = fresh(args.seed + 3)
    prof = cProfile.Profile()
    prof.enable()
    run_windows(sim, trace, sync)
    prof.disable()
    buf = io.StringIO()
    pstats.Stats(prof, stream=buf).sort_stats("tottime").print_stats(25)
    (out / "window_profile_host.txt").write_text(buf.getvalue())
    print("\n".join(buf.getvalue().splitlines()[:45]))

    if on_card:
        from torch.profiler import ProfilerActivity, profile

        sim, trace = fresh(args.seed + 4)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
            traced = run_windows(sim, trace, sync)
        # The windows' own host time; the profiler's start and stop are not in it.
        wall = sum(r["ingest_s"] + r["schedule_s"] + r["evaluate_s"] for r in traced)
        from torch.autograd import DeviceType

        # Device busy time: the union of the intervals of the events that
        # ran on the card (kernels and copies), so nothing is counted twice.
        spans = sorted((e.time_range.start, e.time_range.end) for e in tp.events()
                       if e.device_type == DeviceType.CUDA)
        device_us, end = 0.0, float("-inf")
        for lo, hi in spans:
            lo = max(lo, end)
            if hi > lo:
                device_us += hi - lo
            end = max(end, hi)
        table = tp.key_averages().table(sort_by="self_device_time_total", row_limit=25)
        (out / "window_profile_device.txt").write_text(table)
        print(table)
        tp.export_chrome_trace(str(out / "window_trace.json"))
        report["profiled_wall_s"] = wall
        report["device_busy_s"] = device_us / 1e6
        report["device_busy_share"] = device_us / 1e6 / wall
        print(f"traced windows {wall:.6f} s (host clock, profiler on), device busy "
              f"{device_us / 1e6:.6f} s ({100 * device_us / 1e6 / wall:.2f} %)")
    (out / "window_profile.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
