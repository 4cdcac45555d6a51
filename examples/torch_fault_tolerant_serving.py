"""Fault-tolerant closed-loop serving on the PyTorch port, end to end.

The counterpart of ``examples/fault_tolerant_serving.py``.  A seeded
``FaultPlan`` (crash + stochastic transients + a straggler hang) is
injected into a 3-worker ``ExecutorPool`` while the health tracker
drives quarantine masking and realized-latency drift correction.
Short-circuit variants keep the run deterministic and instant (the
scheduler sees ordinary profiled latencies; the executor answers from
the SneakPeek stage), so this doubles as a fault-injection smoke: every
submitted request must be accounted exactly once, crashes and retries
included.  The server's placement steps and commits run K1
(``utility``) on the card, or its plain version with ``--device cpu``.

    PYTHONPATH=src python examples/torch_fault_tolerant_serving.py
    PYTHONPATH=src python examples/torch_fault_tolerant_serving.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.core import Application, ModelProfile, Request, Worker, make_policy
from repro_torch.device import resolve_device
from repro_torch.serving import EdgeServer, ExecutorPool, FaultPlan, FaultSpec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    device = resolve_device(ap.parse_args(argv).device)

    models = [
        ModelProfile("fast:short_circuit", recalls=np.array([0.75, 0.75]),
                     latency_s=0.02, load_latency_s=0.01),
        ModelProfile("acc:short_circuit", recalls=np.array([0.95, 0.95]),
                     latency_s=0.09, load_latency_s=0.04),
    ]
    apps = {"a": Application(name="a", models=models, penalty="step")}
    workers = [Worker(0), Worker(1), Worker(2, speed=2.0)]

    # Worker 2 (the fast lane) takes the first placements: crash it in
    # window 0, then make it a straggler in window 1 — the health tracker
    # should quarantine it and the pool keep serving on workers 0/1.
    plan = FaultPlan(
        specs=(
            FaultSpec(kind="crash", window=0, worker=2, batch=0),
            FaultSpec(kind="hang", worker=2, window=1, delay_s=1.0, count=None),
        ),
        rates={"transient": 0.15},
        seed=7,
    )
    srv = EdgeServer(
        apps, make_policy("SneakPeek"),
        executor=ExecutorPool(workers, variants={}, device=device),
        prompt_fn=lambda r: None, workers=workers,
        faults=plan, health=True, retry_budget=2, device=device,
    )
    trace = [Request(rid=i, app="a", arrival_s=0.015 * i, deadline_s=4.0,
                     true_label=i % 2) for i in range(24)]
    with srv:
        outs, stats = srv.run(trace)

    print(f"windows={stats.windows} requests={stats.requests} "
          f"violations={stats.violations} utility={stats.mean_utility:.3f}")
    print(f"failed_batches={stats.failed_batches} retries={stats.retries} "
          f"dropped_after_retry={stats.dropped_after_retry} "
          f"fallbacks={stats.fallbacks} quarantined={stats.quarantined_workers}")
    ratios = " ".join(f"w{w}={r:.2f}"
                      for w, r in sorted(stats.realized_over_profiled.items()))
    print(f"realized/profiled EWMA: {ratios}")
    print("injected faults:")
    for window, worker, batch, kind, rids in srv.injector.log:
        print(f"  window={window} worker={worker} batch={batch} "
              f"kind={kind} rids={list(rids)}")

    quarantines = {w: h.quarantines for w, h in sorted(srv.health._health.items())}
    states = {w: srv.health.state_of(w) for w in sorted(srv.health._health)}
    print(f"quarantine episodes: {quarantines}  final states: {states}")

    # Smoke invariants: nothing lost, nothing double-counted, and the
    # crashed lane really went through quarantine.
    assert sorted(srv._records) == [r.rid for r in trace], "request lost/duplicated"
    assert stats.requests == len(trace)
    assert stats.failed_batches >= 1 and stats.retries >= 1
    assert quarantines[2] >= 1, "crashed lane was never quarantined"
    print("OK: every request accounted exactly once under injected faults")


if __name__ == "__main__":
    main()
