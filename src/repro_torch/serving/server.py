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

The loop closes as the reference's does: ``preempt=True`` withdraws
committed-but-unstarted work at every window close and re-schedules it;
``faults=`` and ``health=`` supervise the pool's lanes (failed batches
withdrawn and retried, stragglers quarantined, profiled latencies
corrected from realized ones); ``overlap=True`` schedules window k+1
while window k runs on the lanes.  ``pipeline=True`` feeds every window
through one persistent ``core.pipeline.WindowPipeline`` (one
``selection_scan`` launch per scheduling pass, or one ``spec_scan``
launch with ``chunk`` > 0), on every loop mode; ``shard`` feeds them
through ``core.shard.ShardedWindowPipeline`` instead (the tiles split
across shards, bit-identical decisions).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Mapping, Optional

import numpy as np

from repro_torch.core.evaluation import evaluate
from repro_torch.core.health import HealthTracker
from repro_torch.core.scheduler import SchedulerPolicy, effective_apps, schedule_window
from repro_torch.core.sneakpeek import attach_sneakpeek
from repro_torch.core.streaming import StreamingState
from repro_torch.core.types import Application, Request
from repro_torch.device import resolve_device
from repro_torch.serving.faults import FaultInjector, FaultPlan
from repro_torch.serving.runtime import ExecutorPool, LMExecutor, WindowQueue

__all__ = ["EdgeServer", "ServeStats"]


@dataclasses.dataclass
class ServeStats:
    """Aggregate serving metrics accumulated across windows."""

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
    # Window-close preemption: requests withdrawn for re-scheduling, and
    # withdrawn requests dropped because their deadline had passed (each
    # dropped request keeps a recorded violation and zero utility).
    preempted: int = 0
    dropped: int = 0
    # The fault-tolerant closed loop (``faults``/``health``): batch
    # failures seen on the lanes, failed requests re-admitted for retry,
    # requests dropped after the retry budget (or their deadline), retries
    # whose original variant no longer fit the remaining slack, workers
    # currently quarantined, and the per-worker realized/committed latency
    # EWMA driving drift correction.
    failed_batches: int = 0
    retries: int = 0
    dropped_after_retry: int = 0
    fallbacks: int = 0
    quarantined_workers: int = 0
    realized_over_profiled: dict = dataclasses.field(default_factory=dict)
    # Per-variant latency provenance ({model name -> profiled|costmodel|
    # realized}).
    profile_provenance: dict = dataclasses.field(default_factory=dict)
    # Host seconds spent in the decision phases (drain + schedule +
    # commit), seconds spent executing dispatched windows, and — with
    # ``overlap=True`` — the decision seconds that ran hidden under the
    # previous window's lane execution.
    sched_wall_s: float = 0.0
    exec_wall_s: float = 0.0
    overlap_saved_s: float = 0.0

    @property
    def worker_utilization(self) -> dict:
        """Busy-time / span fraction per worker id over the served span
        (0.0 for workers that never received work)."""
        if self.span_s <= 0:
            return {w: 0.0 for w in sorted(self.worker_busy_s)}
        return {w: busy / self.span_s for w, busy in sorted(self.worker_busy_s.items())}

    def as_dict(self):
        """Dataclass fields plus the derived per-worker utilization."""
        out = dataclasses.asdict(self)
        out["worker_utilization"] = self.worker_utilization
        return out


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
        retry_budget: int = 2,
        lane_timeout_s: float | None = None,
        backend=None,
        overlap: bool = False,
        lane: str = "thread",
        *,
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
        sizes are registered from ``backend.model_bytes``.

        ``preempt=True`` enables window-close preemption: at every close,
        backlogged-but-unstarted entries (committed by the scheduler but
        not yet dispatched by the pool) are withdrawn, merged into the
        next window's queue and re-scheduled under the fresh posteriors
        and pool state; withdrawn entries already past their deadline are
        dropped with a recorded violation.

        ``faults`` (a ``serving.faults.FaultPlan`` or ``FaultInjector``)
        and/or ``health`` (True, or a ``core.health.HealthTracker``)
        switch execution to the fault-tolerant closed loop: lanes run
        under ``ExecutorPool.execute_supervised`` (per-batch fault
        isolation and the ``lane_timeout_s`` shared deadline), failed
        batches are withdrawn from the committed timelines
        (``StreamingState.withdraw``) and re-admitted with exponential
        backoff up to ``retry_budget`` retries (then dropped with a
        recorded violation), and the tracker's realized/committed EWMA
        feeds drift-corrected latency scales and quarantine masks back
        into the next window's scheduling.

        ``overlap=True`` double-buffers the loop: while window k's lanes
        run (``ExecutorPool.execute_async``), the host drains and
        schedules window k+1 against a copy of the committed timelines,
        then reconciles at k+1's commit: window k's outcome (realized
        latencies, health changes, withdrawals, retries) lands first, and
        the speculative schedule is kept only when none of it changed the
        scheduling inputs; otherwise it is recomputed, giving exactly the
        synchronous decision.

        ``pipeline=True`` keeps one ``core.pipeline.WindowPipeline`` for
        the server's life: its ingest is the SneakPeek stage and its
        compiled programs schedule every window (decision-identical to
        the fast path).  ``chunk`` sizes the pipeline's speculative
        chunked selection (bit-identical decisions; ``None`` defers to the
        policy's ``chunk`` field, 0 = the sequential scan).  ``shard``
        keeps a ``core.shard.ShardedWindowPipeline`` instead (True = every
        device of ``device``'s kind, N = N shards; implies ``pipeline``).

        Every option defaults off, leaving the plain loop's decisions
        unchanged."""
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
        self.preempt = bool(preempt)
        # Per-request realized (utility, violated) records — the unit of
        # account when work can be re-scheduled: a re-scheduled request
        # OVERWRITES its record, so withdrawn work is never counted twice.
        # The aggregates are kept incrementally (_set_record).
        self._records: dict[int, tuple[float, bool]] = {}
        self._records_utility = 0.0
        self._records_violations = 0
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
        self.overlap = bool(overlap)
        if self.overlap and (self.pool is None or self.prompt_fn is None):
            raise ValueError(
                "overlap=True requires workers=[...], an executor, and "
                "prompt_fn=... (the overlapped loop dispatches windows to "
                "ExecutorPool lanes asynchronously)")
        # The overlapped window in flight: (PendingExecution, its schedule,
        # its close time), settled by _join_inflight before the next
        # window's commit.
        self._inflight = None
        self.retry_budget = int(retry_budget)
        self.lane_timeout_s = lane_timeout_s
        self.injector = None
        if faults is not None:
            self.injector = FaultInjector(faults) if isinstance(faults, FaultPlan) else faults
        self.health = None
        if health:
            if isinstance(health, HealthTracker):
                self.health = health
            else:
                self.health = HealthTracker([w.wid for w in self.workers] if self.workers
                                            else [0])
        self._closed_loop = self.injector is not None or self.health is not None
        if self._closed_loop and self.pool is None:
            raise ValueError(
                "faults/health require workers=[...] and an executor "
                "(the closed loop supervises ExecutorPool lanes)")
        # Per-request records whenever work can be re-scheduled
        # (preemption or the closed loop's retries).
        self._use_records = self.preempt or self._closed_loop
        self._window_index = 0
        self._attempts: dict[int, int] = {}
        self._retry_ready: list[tuple[float, Request]] = []
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
        self._pipeline = None
        if shard:
            from repro_torch.core.shard import ShardedWindowPipeline

            self._pipeline = ShardedWindowPipeline(
                self._eff_apps, sneakpeeks=sneakpeeks, policy=policy,
                workers=self.workers, chunk=chunk, shard=shard, device=self.device,
            )
        elif pipeline:
            from repro_torch.core.pipeline import WindowPipeline

            self._pipeline = WindowPipeline(
                self._eff_apps, sneakpeeks=sneakpeeks, policy=policy,
                workers=self.workers, chunk=chunk, device=self.device,
            )

    def submit(self, request: Request):
        """Enqueue one request for the window containing its arrival."""
        self.queue.submit(request)

    def _preempt_window(self, now: float) -> int:
        """Window-close preemption: withdraw committed-but-unstarted work
        from the streaming state, drop what already expired (recorded
        violation, zero utility), re-admit the rest through the queue.
        Returns the withdrawal count (the overlapped loop keeps its
        speculative schedule only when it is zero)."""
        readmit, expired = self.state.preempt(now)
        self.stats.preempted += len(readmit) + len(expired)
        for r in expired:
            # A close can drop work even when it drains no new request, so
            # the aggregates update here too, not only in _account.
            self._set_record(r.rid, 0.0, True)
        self.stats.dropped += len(expired)
        if readmit:
            self.queue.readmit(readmit)
        return len(readmit) + len(expired)

    def _set_record(self, rid: int, utility: float, violated: bool) -> None:
        """Insert or overwrite one per-request record, adjusting the
        running aggregates (a re-scheduled request's stale contribution
        is taken off before its new one is added)."""
        old = self._records.get(rid)
        if old is not None:
            self._records_utility -= old[0]
            self._records_violations -= int(old[1])
        self._records[rid] = (utility, violated)
        self._records_utility += utility
        self._records_violations += int(violated)
        self.stats.requests = len(self._records)
        self.stats.violations = self._records_violations
        self.stats.mean_utility = self._records_utility / len(self._records)

    def _account(self, sched, res) -> None:
        """Fold one evaluated window into the aggregate stats: sums when a
        request is scheduled exactly once, per-request records (the last
        commitment of each request counts) under preemption or the closed
        loop."""
        if not self._use_records:
            self.stats.requests += len(res.utilities)
            self.stats.violations += res.violations
            self._utility_sum += res.utilities.sum()
            self.stats.mean_utility = self._utility_sum / max(self.stats.requests, 1)
            return
        over = res.completions > res.deadlines
        for e, u, miss in zip(sched.sorted_entries(), res.utilities, over):
            self._set_record(e.request.rid, float(u), bool(miss))

    def _schedule_requests(self, requests, now: float, state):
        """The decision phase of both loop modes: SneakPeek stage, then the
        policy against ``state`` under the current drift scales and
        quarantine mask.  Returns ``(schedule, effective apps, evaluate's
        latency-scale function)``.  Re-admitted requests keep the
        evidence drawn at their first window."""
        lat_scale = mask = scale_fn = None
        if self.health is not None:
            scale_fn = self.health.scale_fn()
            if self.workers:
                lat_scale = self.health.latency_scale()
                mask = self.health.active_wids(self.workers)
        if self._pipeline is not None:
            # The pipeline's batched ingest (re-admitted requests keep their
            # evidence), then its compiled program against ``state``.
            self._pipeline.ingest(requests)
            sched = self._pipeline.schedule(
                requests, now, state=state, lat_scale=lat_scale, worker_mask=mask,
            )
            return sched, self._eff_apps, scale_fn
        if self.sneakpeeks:
            attach_sneakpeek(requests, self.apps, self.sneakpeeks, device=self.device)
        sched, eff_apps = schedule_window(
            self.policy, requests, self._eff_apps, now,
            workers=self.workers, state=state, device=self.device,
            lat_scale=lat_scale, worker_mask=mask,
        )
        return sched, eff_apps, scale_fn

    def _commit_window(self, sched, eff_apps, now: float, scale_fn):
        """Evaluate a scheduled window against the committed state and fold
        the result into the aggregate stats (both loop modes)."""
        res = evaluate(sched, eff_apps, now, acc_mode="oracle", state=self.state,
                       latency_scale=scale_fn, device=self.device)
        self.stats.windows += 1
        self._account(sched, res)
        self.stats.scheduling_overhead_s += sched.scheduling_overhead_s
        for w, busy in res.worker_busy_s.items():
            self.stats.worker_busy_s[w] = self.stats.worker_busy_s.get(w, 0.0) + busy
        self.stats.span_s = max(self.stats.span_s, max(tl.t for _, tl in self.state.items()))
        return res

    def _readmit_due_retries(self, now: float) -> list[Request]:
        """Backed-off retries whose ready time has come re-enter through
        the queue, as preempted work does.  Returns them."""
        due = [r for t, r in self._retry_ready if t <= now]
        if due:
            self._retry_ready = [(t, r) for t, r in self._retry_ready if t > now]
            self.queue.readmit(sorted(due, key=lambda r: (r.arrival_s, r.rid)))
        return due

    def _pool_stats(self, seconds: float) -> None:
        """Read the pool's swaps and busy seconds after a window ran, and
        add its execution seconds."""
        self.stats.swaps = sum(self.pool.swap_counts.values())
        self.stats.worker_swaps = dict(self.pool.swap_counts)
        self.stats.pool_busy_s = dict(self.pool.busy_s)
        self.stats.wall_s += seconds
        self.stats.exec_wall_s += seconds

    def run_window(self, now: float):
        """Close the current window: preempt (``preempt=True``), re-admit
        due retries, drain, schedule (drift-corrected, health-masked),
        commit and execute (supervised under the closed loop).  Returns
        ``{"schedule", "eval", "reports", "outcome"}``, or None when no
        request was drained.  With ``overlap=True`` execution is dispatched
        asynchronously (``"pending"``) and the next close schedules while
        it runs."""
        if self.overlap:
            return self._run_window_overlap(now)
        widx = self._window_index
        self._window_index += 1
        t_host0 = time.perf_counter()
        if self.preempt:
            self._preempt_window(now)
        self._readmit_due_retries(now)
        requests = self.queue.drain_window(now)
        if not requests:
            self._close_health_window()
            return None
        sched, eff_apps, scale_fn = self._schedule_requests(requests, now, self.state)
        res = self._commit_window(sched, eff_apps, now, scale_fn)
        self.stats.sched_wall_s += time.perf_counter() - t_host0

        reports = None
        outcome = None
        gate = {"until": now + self.queue.window_s if self.preempt else None,
                "on_dispatch": self.state.mark_dispatched if self.preempt else None}
        if self.pool is not None and self.prompt_fn is not None:
            # Multi-worker execution plane: each lane runs its share of the
            # placed schedule.  Under preemption only the batches committed
            # to start inside the coming window are dispatched (and marked
            # so in the state); the rest stays revisable at the next close.
            t1 = time.perf_counter()
            if self._closed_loop:
                outcome = self.pool.execute_supervised(
                    sched, self.prompt_fn, injector=self.injector, window=widx,
                    timeout_s=self.lane_timeout_s, **gate)
                reports = outcome.reports
            else:
                reports = self.pool.execute_schedule(sched, self.prompt_fn, **gate)
            self._pool_stats(time.perf_counter() - t1)
            if outcome is not None:
                self._absorb_outcome(outcome, sched, now)
        elif self.executor is not None and self.prompt_fn is not None:
            t1 = time.perf_counter()
            reports = self.executor.execute_schedule(sched, self.prompt_fn)
            self.stats.swaps = self.executor.swaps.swap_count
            dt = time.perf_counter() - t1
            self.stats.wall_s += dt
            self.stats.exec_wall_s += dt
        self._close_health_window()
        return {"schedule": sched, "eval": res, "reports": reports, "outcome": outcome}

    def _health_signature(self):
        """Equality token over the health tracker's scheduler-facing state
        (quarantine mask + quantized drift scales); None without one."""
        if self.health is None:
            return None
        return self.health.control_signature(self.workers or [])

    def _speculate(self, now: float):
        """Drain the coming window and schedule it against a clone of the
        committed timelines while the previous window's lanes still run,
        noting the scheduling inputs (timelines and health control state)
        the reconcile step compares after the outcome lands.

        Safe beside the lanes: they only set dispatch marks (never
        timelines), scheduling only peeks the clone, and nothing commits
        here.  On the card its K1 and K2 launches go to this thread's
        current stream while the lanes run on streams of their own."""
        requests = self.queue.drain_window(now)
        if not requests:
            return None
        state_sig = self.state.signature()
        health_sig = self._health_signature()
        sched, eff_apps, _ = self._schedule_requests(requests, now, self.state.clone())
        return {"requests": requests, "sched": sched, "eff_apps": eff_apps,
                "state_sig": state_sig, "health_sig": health_sig}

    def _join_inflight(self) -> None:
        """Settle the overlapped window in flight as the synchronous loop
        would have at its close: join the lanes, read the pool's stats,
        absorb the supervised outcome (stamped with that window's own
        close time, so retry backoffs match the synchronous loop) and pay
        the owed health tick."""
        if self._inflight is None:
            return
        pending, sched, now_k = self._inflight
        self._inflight = None
        outcome = pending.result()
        self._pool_stats(pending.finished_at - pending.started_at)
        if self._closed_loop:
            self._absorb_outcome(outcome, sched, now_k)
        self._close_health_window()

    def _run_window_overlap(self, now: float):
        """One close of the double-buffered loop: (1) speculate — drain
        and schedule this window against a copy while the previous
        window's lanes still run; (2) join — settle the outcome in flight;
        (3) reconcile — keep the speculative schedule only if nothing the
        join (or preemption, or a due retry) did changed this window's
        scheduling inputs, else re-admit the drained requests and schedule
        again, which reproduces the synchronous decision exactly; (4)
        commit and dispatch asynchronously."""
        widx = self._window_index
        self._window_index += 1
        t_spec0 = time.perf_counter()
        spec = self._speculate(now) if self._inflight is not None else None
        t_spec1 = time.perf_counter()
        pending_prev = self._inflight[0] if self._inflight is not None else None
        self._join_inflight()
        if pending_prev is not None and pending_prev.finished_at is not None:
            # Decision time that ran while the lanes were still busy.
            self.stats.overlap_saved_s += max(
                0.0,
                min(t_spec1, pending_prev.finished_at) - max(t_spec0, pending_prev.started_at),
            )
        t_host0 = time.perf_counter()
        withdrawn = self._preempt_window(now) if self.preempt else 0
        due = self._readmit_due_retries(now)
        valid = (
            spec is not None
            and withdrawn == 0
            and not due
            and spec["health_sig"] == self._health_signature()
            and spec["state_sig"] == self.state.signature()
        )
        if valid:
            sched, eff_apps = spec["sched"], spec["eff_apps"]
            scale_fn = self.health.scale_fn() if self.health is not None else None
        else:
            if spec is not None:
                # The speculative drain goes back through the queue; the
                # drain below merges it with preempted and retried work
                # under the same (arrival, rid) order.
                self.queue.readmit(spec["requests"])
            requests = self.queue.drain_window(now)
            if not requests:
                self._close_health_window()
                self.stats.sched_wall_s += (t_spec1 - t_spec0) + (
                    time.perf_counter() - t_host0)
                return None
            sched, eff_apps, scale_fn = self._schedule_requests(requests, now, self.state)
        res = self._commit_window(sched, eff_apps, now, scale_fn)
        pending = self.pool.execute_async(
            sched,
            self.prompt_fn,
            until=now + self.queue.window_s if self.preempt else None,
            on_dispatch=self.state.mark_dispatched if self.preempt else None,
            injector=self.injector if self._closed_loop else None,
            window=widx,
            timeout_s=self.lane_timeout_s if self._closed_loop else None,
            supervised=self._closed_loop,
        )
        self._inflight = (pending, sched, now)
        self.stats.sched_wall_s += (t_spec1 - t_spec0) + (time.perf_counter() - t_host0)
        return {"schedule": sched, "eval": res, "reports": None, "outcome": None,
                "pending": pending}

    def close(self) -> None:
        """Join an overlapped window in flight, then tear down the pool's
        lanes (threads, worker processes) and the executor's backend.
        Idempotent."""
        self._join_inflight()
        if self.pool is not None:
            self.pool.close()
        if self.executor is not None and not isinstance(self.executor, ExecutorPool):
            self.executor.close()

    def __enter__(self) -> "EdgeServer":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False

    def _close_health_window(self) -> None:
        """Tick the health tracker at window close (quarantine cooldowns
        count down, released workers re-probe) and refresh the fault and
        drift stats."""
        if self.health is None:
            return
        self.health.close_window()
        self.stats.quarantined_workers = len(self.health.quarantined())
        self.stats.realized_over_profiled = self.health.ratio_snapshot()

    def _absorb_outcome(self, outcome, sched, now: float) -> None:
        """Fold one supervised window back into the closed loop: the
        successful reports feed the drift EWMA (realized against committed
        latency per (worker, model)), failures and lane timeouts feed the
        health state machine, and every failed request's batch is
        withdrawn from the committed timelines and sent through
        ``_retry``."""
        ent_by_rid = {e.request.rid: e for e in sched.sorted_entries()}
        if self.health is not None:
            for rep in outcome.reports:
                if not rep.request_ids:
                    continue
                e = ent_by_rid.get(rep.request_ids[0])
                if e is not None and rep.worker >= 0:
                    self.health.observe(rep.worker, rep.model, rep.total_s, e.est_latency_s)
            for wid in outcome.timed_out:
                self.health.record_failure(wid, "timeout")
        failed_model: dict[int, str] = {}
        for f in outcome.failures:
            self.stats.failed_batches += 1
            if self.health is not None and not f.cascaded:
                self.health.record_failure(f.worker, f.kind)
            for rid in f.request_ids:
                failed_model[rid] = f.model
        if not failed_model:
            return
        for r in self.state.withdraw(set(failed_model)):
            self._retry(r, failed_model.get(r.rid, ""), now)

    def _retry(self, r: Request, model: str, now: float) -> None:
        """Deadline-aware retry with the accuracy-scaling fallback.

        The request is dropped (recorded violation, zero utility) when its
        deadline passed, the retry budget is spent, or even the cheapest
        variant cannot finish in the remaining slack.  Otherwise it is
        re-admitted after an exponential backoff of ``(2**(attempts-1) -
        1) * window_s``; if the original variant no longer fits the slack,
        the re-schedule prefers a cheaper one — counted as a fallback."""
        attempts = self._attempts.get(r.rid, 0) + 1
        self._attempts[r.rid] = attempts
        app = self._eff_apps[r.app]
        min_lat = min(m.latency_s for m in app.models)
        if (
            r.deadline_s <= now
            or attempts > self.retry_budget
            or now + min_lat > r.deadline_s
        ):
            self._set_record(r.rid, 0.0, True)
            self.stats.dropped_after_retry += 1
            return
        orig = next((m for m in app.models if m.name == model), None)
        if orig is not None and now + orig.latency_s > r.deadline_s:
            self.stats.fallbacks += 1
        self.stats.retries += 1
        backoff = (2 ** (attempts - 1) - 1) * self.queue.window_s
        self._retry_ready.append((now + backoff, r))

    def run(self, requests, horizon_s: float | None = None):
        """Feed a request trace through windowed scheduling.

        ``horizon_s=None`` serves until the last arrival; an explicit
        horizon, including ``0.0``, is honoured as given.  Returns
        (per-window outputs, stats).

        A preemptive server with a pool gates dispatch to the coming
        window, and the closed loop re-admits retries, so after the
        horizon they keep closing windows until every committed batch has
        been dispatched (or withdrawn and dropped) and no retry waits —
        otherwise work gated out of the final window would never run
        while counting as served."""
        for r in sorted(requests, key=lambda x: x.arrival_s):
            self.submit(r)
        t_end = horizon_s if horizon_s is not None else max(r.arrival_s for r in requests)
        n_windows = int(np.ceil(t_end / self.queue.window_s)) or 1
        outs = []
        for w in range(1, n_windows + 1):
            out = self.run_window(w * self.queue.window_s)
            if out:
                outs.append(out)
        if (self.preempt or self._closed_loop) and self.pool is not None \
                and self.prompt_fn is not None:
            # Flush: each extra close withdraws and re-schedules the
            # undispatched tail (preempt), re-admits due retries (closed
            # loop) and dispatches what now starts inside the next window.
            # Retry budgets and the committed horizon are finite, so this
            # ends; the cap is a safety net.  The overlapped loop joins its
            # window in flight first: the condition reads retry and backlog
            # state that settles only once the outcome is absorbed.
            while w < n_windows + 10_000:
                self._join_inflight()
                if not (len(self.queue) or self._retry_ready
                        or (self.preempt and self.state.undispatched_backlog())):
                    break
                w += 1
                out = self.run_window(w * self.queue.window_s)
                if out:
                    outs.append(out)
        # Overlap: the final window may still be running.
        self._join_inflight()
        return outs, self.stats
