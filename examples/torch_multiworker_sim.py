"""Multi-worker scheduling (paper §VII) on the PyTorch port: heterogeneous
workers, greedy grouped placement (Eq. 15), pool utilization, a
streaming multi-window run with per-worker state carry-over, and the
executor pool actually running a placed schedule on real models —
per-worker swap counts and lane utilization included.

The counterpart of ``examples/multiworker_sim.py``.  On the card the
placement steps and commits run K1 (``utility``), the SneakPeek stage
K2 (``knn``), and the executor pool's mamba2 variants K5 (``ssd``) for
their prefill.  By default the LM sections serve a width-reduced
mamba2-130m; ``--full`` serves the published config (bf16, random
weights).  ``--device cpu`` runs the plain versions on the host.

    PYTHONPATH=src python examples/torch_multiworker_sim.py
    PYTHONPATH=src python examples/torch_multiworker_sim.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.configs import ARCHS
from repro_torch.core import (
    Application,
    ModelProfile,
    Request,
    Simulation,
    Worker,
    evaluate,
    make_policy,
    multiworker_schedule,
)
from repro_torch.data.applications import APP_SPECS, build_benchmark_suite, make_requests
from repro_torch.device import resolve_device
from repro_torch.serving import EdgeServer, FaultPlan, FaultSpec, LMExecutor


def fresh(reqs):
    return [Request(r.rid, r.app, r.arrival_s, r.deadline_s, r.features, r.true_label)
            for r in reqs]


def main(argv=None):
    """Returns the closed loop's submitted and recorded request ids and its
    failure counts, which its realized latencies decide."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--full", action="store_true",
                    help="serve the published mamba2-130m in the LM sections")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # backend="auto": K2 on the card, its plain version on the CPU.  The
    # reference's backend="numpy" names the host's k-NN, which the port
    # runs only when the CPU is named.
    apps, sneaks = build_benchmark_suite(backend="auto", device=device)
    reqs = make_requests(list(APP_SPECS.values()), per_app=6, mean_deadline_s=0.12, seed=0)

    print("workers -> mean utility (grouped multiworker scheduling)")
    for n in (1, 2, 3, 4):
        workers = [Worker(i) for i in range(n)]
        sched = multiworker_schedule(fresh(reqs), apps, workers, now=0.1, device=device)
        res = evaluate(sched, apps, 0.1, acc_mode="oracle", num_workers=n, device=device)
        by_worker = {}
        for e in sched.entries:
            by_worker[e.worker] = by_worker.get(e.worker, 0) + 1
        print(f"  {n}: utility={res.mean_utility:.3f} violations={res.violations:2d} "
              f"utilization={res.utilization:.2f} load={dict(sorted(by_worker.items()))}")

    print("\nheterogeneous pool: worker1 is 4x faster")
    workers = [Worker(0, speed=1.0), Worker(1, speed=4.0)]
    sched = multiworker_schedule(fresh(reqs), apps, workers, now=0.1, device=device)
    res = evaluate(sched, apps, 0.1, acc_mode="oracle", num_workers=2, device=device)
    fast = sum(1 for e in sched.entries if e.worker == 1)
    print(f"  utility={res.mean_utility:.3f}; {fast}/{len(sched.entries)} requests "
          f"placed on the fast worker")

    print("\nstreaming: 4 windows over 2 workers, state carried across windows")
    trace = []
    for w in range(4):
        batch = make_requests(list(APP_SPECS.values()), per_app=3,
                              mean_deadline_s=0.2, seed=w, start_rid=w * 9)
        for r in batch:
            r.arrival_s += w * 0.1
        trace.extend(batch)
    sim = Simulation(make_policy("SneakPeek"), apps, window_s=0.1,
                     sneakpeeks=sneaks, short_circuit=True, seed=0,
                     workers=[Worker(0), Worker(1, speed=2.0)], device=device)
    out = sim.run(trace)
    for entry in sim.log:
        print(f"  window {entry['window']}: n={entry['n']:2d} "
              f"utility={entry['utility']:.3f} backlog={entry['backlog_s']*1e3:5.1f}ms "
              f"utilization={entry['utilization']:.2f}")
    print(f"  total: utility={out['utility']:.3f} "
          f"violation_rate={out['violation_rate']:.2f}")
    print(f"  final state: {sim.state}")

    print("\nEdgeServer: same trace, per-worker utilization from ServeStats")
    server = EdgeServer(apps, make_policy("SneakPeek"), sneakpeeks=sneaks,
                        short_circuit=True, window_s=0.1,
                        workers=[Worker(0), Worker(1, speed=2.0)], device=device)
    _, stats = server.run(fresh(trace))
    per_worker = " ".join(
        f"w{w}={u:.2f}" for w, u in stats.worker_utilization.items()
    )
    print(f"  windows={stats.windows} requests={stats.requests} "
          f"violations={stats.violations} utility={stats.mean_utility:.3f}")
    print(f"  span={stats.span_s*1e3:.1f}ms per-worker utilization: {per_worker}")

    print("\nexecutor pool: the placed schedule actually runs, one lane per worker")
    cfg = ARCHS["mamba2-130m"] if args.full else ARCHS["mamba2-130m"].reduced()
    lm_app = Application(name="lm", models=[
        ModelProfile("small", recalls=[0.72, 0.70], latency_s=0.010, load_latency_s=0.02),
        ModelProfile("big", recalls=[0.92, 0.90], latency_s=0.050, load_latency_s=0.08),
    ], penalty="sigmoid")

    def prompt_fn(req):
        # Seeded per request: pool lanes call this concurrently.
        return np.random.default_rng(req.rid).integers(
            0, cfg.vocab_size, 8).astype(np.int32)

    lm_reqs = [Request(rid=i, app="lm", arrival_s=0.01 * i, deadline_s=0.25,
                       true_label=i % 2) for i in range(8)]
    # Context manager: lane resources released on exit.
    with EdgeServer(
        {"lm": lm_app}, make_policy("LO-EDF"),
        executor=LMExecutor({"small": (cfg, 0), "big": (cfg, 1)}, new_tokens=2,
                            device=device),
        prompt_fn=prompt_fn, workers=[Worker(0), Worker(1, speed=2.0)], device=device,
    ) as pool_srv:
        _, pstats = pool_srv.run(lm_reqs)
        util = pool_srv.pool.utilization()
        for w in sorted(pstats.worker_swaps):
            print(f"  worker {w}: swaps={pstats.worker_swaps[w]} "
                  f"busy={pstats.pool_busy_s[w]*1e3:6.1f}ms "
                  f"lane-utilization={util[w]:.2f}")
        print(f"  total swaps={pstats.swaps} "
              f"wall={pool_srv.pool.wall_s*1e3:.1f}ms")
        print(f"  sched wall={pstats.sched_wall_s*1e3:.1f}ms "
              f"exec wall={pstats.exec_wall_s*1e3:.1f}ms "
              f"(overlap saved={pstats.overlap_saved_s*1e3:.1f}ms)")

    print("\nclosed loop: transient faults on the fast lane, retries + drift EWMA")
    # Worker 1 is 2x faster and takes the placements, so that is the lane
    # worth faulting: its first two dispatched batches fail and retry.
    ft_reqs = [Request(rid=100 + i, app="lm", arrival_s=0.01 * i, deadline_s=1.0,
                       true_label=i % 2) for i in range(8)]
    with EdgeServer(
        {"lm": lm_app}, make_policy("LO-EDF"),
        executor=LMExecutor({"small": (cfg, 0), "big": (cfg, 1)}, new_tokens=2,
                            device=device),
        prompt_fn=prompt_fn, workers=[Worker(0), Worker(1, speed=2.0)],
        faults=FaultPlan(specs=(FaultSpec(kind="transient", worker=1, count=2),)),
        health=True, device=device,
    ) as ft_srv:
        _, fstats = ft_srv.run(ft_reqs)
        recorded = sorted(ft_srv._records)
    print(f"  requests={fstats.requests} failed_batches={fstats.failed_batches} "
          f"retries={fstats.retries} dropped={fstats.dropped_after_retry} "
          f"quarantined={fstats.quarantined_workers}")
    ratios = " ".join(f"w{w}={r:.2f}"
                      for w, r in sorted(fstats.realized_over_profiled.items()))
    print(f"  realized/profiled EWMA: {ratios}")
    return {"closed_loop": {"submitted": [r.rid for r in ft_reqs], "recorded": recorded,
                            "failed_batches": fstats.failed_batches,
                            "retries": fstats.retries}}


if __name__ == "__main__":
    main()
