"""EdgeServer: the end-to-end serving loop (paper Fig. 1).

    data streams -> SneakPeek stage -> window queue -> scheduler
        -> (grouped, model-selected, placed) schedule -> executor -> results

The counterpart of ``repro.serving.server``.  The SneakPeek stage is the
port's ``attach_sneakpeek`` (k-NN evidence through K2), scheduling is the
port's ``schedule_window`` (Eq. 2 tiles through K1; with ``workers=[...]``
the Eq. 15 placement, one K1 tile per group), the commit is the port's
``evaluate`` against a carried ``StreamingState``, and the executor runs
the port's ``LM`` on the card (attention prefill through K3 and decode
through K4, SSD prefill through K5): a single ``LMExecutor``, or with
``workers`` an ``ExecutorPool`` whose lanes run each worker's share.
The reference's compiled pipeline, preemption, fault-tolerant closed
loop and overlapped loop are not ported yet: their options raise
``NotImplementedError`` naming the ROADMAP item that brings each.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Mapping, Optional

import numpy as np

from repro_torch.core.evaluation import evaluate
from repro_torch.core.scheduler import (
    NOT_PORTED as SCHEDULER_NOT_PORTED,
    SchedulerPolicy,
    effective_apps,
    not_ported,
    schedule_window,
)
from repro_torch.core.sneakpeek import attach_sneakpeek
from repro_torch.core.streaming import StreamingState
from repro_torch.core.types import Application, Request
from repro_torch.device import resolve_device
from repro_torch.serving.runtime import ExecutorPool, LMExecutor, WindowQueue

__all__ = ["EdgeServer", "ServeStats", "NOT_PORTED"]

# Serving options of the reference this port does not have yet, with the
# ROADMAP item ("Open items" -> "Modules to port") that brings each.
NOT_PORTED: dict[str, str] = {
    "pipeline": SCHEDULER_NOT_PORTED["pipeline"],
    "chunk": SCHEDULER_NOT_PORTED["chunk"],
    "shard": SCHEDULER_NOT_PORTED["shard"],
    "preempt": "item 14 (closed-loop serving: preemption, faults, health, overlap)",
    "faults": "item 14 (closed-loop serving: preemption, faults, health, overlap)",
    "health": "item 14 (closed-loop serving: preemption, faults, health, overlap)",
    "overlap": "item 14 (closed-loop serving: preemption, faults, health, overlap)",
}


@dataclasses.dataclass
class ServeStats:
    """Aggregate serving metrics accumulated across windows.

    The reference's preemption and closed-loop fields come with their
    options (ROADMAP item 14)."""

    windows: int = 0
    requests: int = 0
    violations: int = 0
    swaps: int = 0
    mean_utility: float = 0.0
    scheduling_overhead_s: float = 0.0
    wall_s: float = 0.0
    # Per-worker busy seconds (swap + execution) accumulated at commit
    # time from the streaming state's replay, and the served makespan
    # (the busiest worker's committed busy-until time).
    worker_busy_s: dict = dataclasses.field(default_factory=dict)
    span_s: float = 0.0
    # Executor-pool realized metrics: per-lane weight-swap counts and
    # scaled busy seconds, read from the pool after each window.
    worker_swaps: dict = dataclasses.field(default_factory=dict)
    pool_busy_s: dict = dataclasses.field(default_factory=dict)
    # Per-variant latency provenance ({model name -> profiled|costmodel|
    # realized}).
    profile_provenance: dict = dataclasses.field(default_factory=dict)
    # Host seconds spent in the decision phases (drain + schedule +
    # commit) and seconds spent executing dispatched windows.
    sched_wall_s: float = 0.0
    exec_wall_s: float = 0.0

    @property
    def worker_utilization(self) -> dict:
        """Busy-time / span fraction per worker id over the served span
        (0.0 for workers that never received work)."""
        if self.span_s <= 0:
            return {w: 0.0 for w in sorted(self.worker_busy_s)}
        return {w: busy / self.span_s for w, busy in sorted(self.worker_busy_s.items())}


class EdgeServer:
    """Windowed serving loop: queue -> scheduler -> streaming commit -> executor."""

    def __init__(
        self,
        apps: Mapping[str, Application],
        policy: SchedulerPolicy,
        executor: Optional[LMExecutor] = None,
        sneakpeeks=None,
        short_circuit: bool = False,
        window_s: float = 0.1,
        prompt_fn: Optional[Callable[[Request], np.ndarray]] = None,
        workers=None,
        memory_capacity_bytes: int | None = None,
        pipeline: bool = False,
        chunk: int | None = None,
        shard=False,
        preempt: bool = False,
        faults=None,
        health=False,
        backend=None,
        overlap: bool = False,
        lane: str = "thread",
        device=None,
    ):
        """``device`` is where the SneakPeek stage and the batched
        scheduling equations run (the card unless ``"cpu"`` is named);
        the executor's backend has its own.

        ``workers`` (a sequence of ``multiworker.Worker``) switches
        scheduling to §VII multi-worker placement; ``executor`` may then be
        a single ``LMExecutor``, wrapped into an ``ExecutorPool`` with one
        lane per worker (``lane`` picks their strategy,
        ``runtime.LANE_NAMES``), or an ``ExecutorPool``.
        ``memory_capacity_bytes`` sizes each worker's residency for the
        scheduler (None: the single-slot model) and the executor's swap
        manager when ``backend`` builds it.  ``backend`` (any
        ``ExecutorBackend``) builds the ``LMExecutor`` instead of passing
        one; a backend other than the profiled one knows its variants'
        footprints (weights and KV cache), so the scheduler's residency
        sizes are registered from ``backend.model_bytes``.  The options
        of the reference's other paths raise."""
        for option, unported in (
            ("pipeline", bool(pipeline)),
            ("chunk", chunk is not None),
            ("shard", bool(shard)),
            ("preempt", bool(preempt)),
            ("faults", faults is not None),
            ("health", bool(health)),
            ("overlap", bool(overlap)),
        ):
            if unported:
                not_ported(option, NOT_PORTED)
        self.device = resolve_device(device)
        self.apps = dict(apps)
        self.policy = policy
        if backend is not None:
            if executor is not None:
                raise ValueError("pass either executor=... or backend=..., not both")
            executor = LMExecutor(capacity_bytes=memory_capacity_bytes, backend=backend)
        self.executor = executor
        self.sneakpeeks = sneakpeeks
        self.short_circuit = short_circuit
        self.queue = WindowQueue(window_s)
        self.prompt_fn = prompt_fn
        self.stats = ServeStats()
        self._utility_sum = 0.0
        self.workers = list(workers) if workers else None
        self.pool = None
        if self.workers and executor is not None:
            if isinstance(executor, ExecutorPool):
                if lane != "thread" and executor.lane != lane:
                    raise ValueError(
                        f"lane={lane!r} conflicts with the passed pool's "
                        f"lane={executor.lane!r}; set it on the ExecutorPool")
                self.pool = executor
            else:
                self.pool = ExecutorPool.from_executor(executor, self.workers, lane=lane)
        elif isinstance(executor, ExecutorPool):
            raise ValueError("ExecutorPool requires workers=[...] placement")
        # Streaming state: per-worker backlog + model residency carried
        # across windows (scheduling peeks it, evaluation commits to it).
        self.state = StreamingState(
            num_workers=len(self.workers) if self.workers else 1,
            memory_capacity_bytes=memory_capacity_bytes,
            worker_ids=[w.wid for w in self.workers] if self.workers else None,
        )
        self._eff_apps = effective_apps(self.apps, sneakpeeks, short_circuit)
        self.stats.profile_provenance = {
            m.name: m.provenance for app in self._eff_apps.values() for m in app.models
        }
        # A backend other than the profiled one knows each variant's true
        # footprint (weights + KV cache): the scheduler's residency sizes
        # come from it rather than from the profiles.
        exec_backend = getattr(self.executor, "backend", None)
        if exec_backend is not None and exec_backend.provenance != "profiled":
            self.state.register_sizes({
                name: int(exec_backend.model_bytes(name)) for name in exec_backend.variants
            })

    def submit(self, request: Request):
        """Enqueue one request for the window containing its arrival."""
        self.queue.submit(request)

    def run_window(self, now: float):
        """Close the current window: drain, SneakPeek stage, schedule,
        commit, and execute the schedule.  Returns ``{"schedule", "eval",
        "reports"}``, or None when no request arrived."""
        t_host0 = time.perf_counter()
        requests = self.queue.drain_window(now)
        if not requests:
            return None
        if self.sneakpeeks:
            attach_sneakpeek(requests, self.apps, self.sneakpeeks, device=self.device)
        sched, eff_apps = schedule_window(self.policy, requests, self._eff_apps, now,
                                          state=self.state, device=self.device,
                                          workers=self.workers)
        res = evaluate(sched, eff_apps, now, acc_mode="oracle", state=self.state,
                       device=self.device)
        self.stats.windows += 1
        self.stats.requests += len(res.utilities)
        self.stats.violations += res.violations
        self._utility_sum += res.utilities.sum()
        self.stats.mean_utility = self._utility_sum / max(self.stats.requests, 1)
        self.stats.scheduling_overhead_s += sched.scheduling_overhead_s
        for w, busy in res.worker_busy_s.items():
            self.stats.worker_busy_s[w] = self.stats.worker_busy_s.get(w, 0.0) + busy
        self.stats.span_s = max(self.stats.span_s, max(tl.t for _, tl in self.state.items()))
        self.stats.sched_wall_s += time.perf_counter() - t_host0

        reports = None
        if self.pool is not None and self.prompt_fn is not None:
            # Multi-worker execution plane: each lane runs its share of the
            # placed schedule.
            t1 = time.perf_counter()
            reports = self.pool.execute_schedule(sched, self.prompt_fn)
            self.stats.swaps = sum(self.pool.swap_counts.values())
            self.stats.worker_swaps = dict(self.pool.swap_counts)
            self.stats.pool_busy_s = dict(self.pool.busy_s)
            dt = time.perf_counter() - t1
            self.stats.wall_s += dt
            self.stats.exec_wall_s += dt
        elif self.executor is not None and self.prompt_fn is not None:
            t1 = time.perf_counter()
            reports = self.executor.execute_schedule(sched, self.prompt_fn)
            self.stats.swaps = self.executor.swaps.swap_count
            dt = time.perf_counter() - t1
            self.stats.wall_s += dt
            self.stats.exec_wall_s += dt
        return {"schedule": sched, "eval": res, "reports": reports}

    def close(self) -> None:
        """Tear down the pool's lanes (threads, worker processes) or the
        executor's backend.  Idempotent."""
        if self.pool is not None:
            self.pool.close()
        elif self.executor is not None:
            self.executor.close()

    def __enter__(self) -> "EdgeServer":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False

    def run(self, requests, horizon_s: float | None = None):
        """Feed a request trace through windowed scheduling.

        ``horizon_s=None`` serves until the last arrival; an explicit
        horizon, including ``0.0``, is honoured as given.  Returns
        (per-window outputs, stats)."""
        for r in sorted(requests, key=lambda x: x.arrival_s):
            self.submit(r)
        t_end = horizon_s if horizon_s is not None else max(r.arrival_s for r in requests)
        n_windows = int(np.ceil(t_end / self.queue.window_s)) or 1
        outs = []
        for w in range(1, n_windows + 1):
            out = self.run_window(w * self.queue.window_s)
            if out:
                outs.append(out)
        return outs, self.stats
