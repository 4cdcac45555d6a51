"""Overlapped async window serving on the PyTorch port: schedule window
k+1 while k executes.

The counterpart of ``examples/async_serving.py``.  The synchronous
``EdgeServer`` loop serializes each window — drain, schedule, commit,
then block until the executor lanes finish.  With ``overlap=True`` the
server instead speculates: while window k runs on the lanes, the host
drains and schedules window k+1 against a snapshot of the committed
timelines, then reconciles when k's outcome lands.  If nothing the
outcome changed feeds back into scheduling (no preemption withdrawals,
no due fault retries, no health/drift movement, timelines untouched),
the speculative schedule IS the synchronous decision and commits as-is;
otherwise it is discarded and the window is re-scheduled exactly as the
sync loop would — so ``overlap=True`` changes WHEN work happens, never
WHAT is decided.

This example serves one trace three ways and shows:

  * sync vs overlap produce identical per-request decisions, utilities,
    and violation counts (the regression contract), while the overlap
    run's ``ServeStats.overlap_saved_s`` shows host scheduling time that
    ran concurrently with lane execution;
  * the ``lane="serial"`` strategy — same decisions again, lanes run
    inline in the dispatching thread (useful for debugging);
  * a model-free ``SimulatedBackend`` substrate, whose reports always
    carry the modelled latency, keeping every variant bit-identical.

The lanes run no model, so they take no device; the server's Eq. 15
placement and commits run K1 (``utility``) on the card, or its plain
version with ``--device cpu``.

    PYTHONPATH=src python examples/torch_async_serving.py
    PYTHONPATH=src python examples/torch_async_serving.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.core import Application, ModelProfile, Request, Worker, make_policy
from repro_torch.device import resolve_device
from repro_torch.serving import EdgeServer, LMExecutor, SimulatedBackend


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    device = resolve_device(ap.parse_args(argv).device)

    profiles = {
        "small": ModelProfile("small", recalls=[0.74, 0.72], latency_s=0.010,
                              load_latency_s=0.02),
        "big": ModelProfile("big", recalls=[0.93, 0.91], latency_s=0.045,
                            load_latency_s=0.08),
    }
    app = Application(name="lm", models=list(profiles.values()), penalty="sigmoid")

    def prompt_fn(req):
        # Seeded per request: pool lanes call this concurrently.
        return np.random.default_rng(req.rid).integers(0, 256, 8).astype(np.int32)

    def make_requests():
        # Three windows' worth of arrivals so the loop actually pipelines.
        return [Request(rid=i, app="lm", arrival_s=0.01 * i, deadline_s=0.01 * i + 0.3,
                        true_label=i % 2) for i in range(24)]

    def serve(overlap, lane="thread"):
        # occupancy="sleep" really occupies the lane for the modelled
        # duration, so the overlap run has execution time to hide
        # scheduling under; reported seconds stay the modelled latency,
        # so decisions are identical across every variant.
        backend = SimulatedBackend(profiles, occupancy="sleep", time_scale=0.2)
        with EdgeServer(
            {"lm": app}, make_policy("LO-EDF"),
            executor=LMExecutor(backend=backend), prompt_fn=prompt_fn,
            workers=[Worker(0), Worker(1, speed=2.0)],
            overlap=overlap, lane=lane, device=device,
        ) as srv:
            outs, stats = srv.run(make_requests())
        decisions = [
            (e.request.rid, e.model, e.worker, e.order)
            for o in outs for e in o["schedule"].sorted_entries()
        ]
        return decisions, stats

    sync_dec, sync_stats = serve(overlap=False)
    over_dec, over_stats = serve(overlap=True)
    serial_dec, serial_stats = serve(overlap=True, lane="serial")

    print(f"sync    : utility {sync_stats.mean_utility:.3f} "
          f"violations {sync_stats.violations} "
          f"sched wall {sync_stats.sched_wall_s*1e3:6.1f}ms "
          f"exec wall {sync_stats.exec_wall_s*1e3:6.1f}ms")
    print(f"overlap : utility {over_stats.mean_utility:.3f} "
          f"violations {over_stats.violations} "
          f"sched wall {over_stats.sched_wall_s*1e3:6.1f}ms "
          f"exec wall {over_stats.exec_wall_s*1e3:6.1f}ms "
          f"(hidden under execution: {over_stats.overlap_saved_s*1e3:.1f}ms)")
    print(f"serial  : utility {serial_stats.mean_utility:.3f} "
          f"violations {serial_stats.violations} (lanes run inline)")

    assert sync_dec == over_dec == serial_dec, "overlap must not change decisions"
    assert sync_stats.violations == over_stats.violations
    print(f"\n{len(sync_dec)} per-request decisions identical across "
          f"sync, overlap, and serial-lane runs")


if __name__ == "__main__":
    main()
