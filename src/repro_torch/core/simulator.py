"""Discrete-event simulation of the serving loop (drives the evaluation).

The port of ``repro.core.simulator``:

  * ``run_window`` — one scheduling window (default 100 ms) of enqueued
    requests, scheduled at window close, scored with *oracle* utilities
    (Eq. 9 with one-hot true-label theta) and realized completion times
    from the worker timeline.  Deterministic.
  * ``Simulation`` — multi-window streaming execution over a persistent
    ``StreamingState``: backlog and model residency carry across windows,
    with sampled per-request outcomes (correct with probability
    recall[true_label]) drawn from a seeded numpy generator, the
    reference's stream; optionally over a heterogeneous worker pool
    (``workers=``, Eq. 15 placement) with capacity-limited residency
    (``memory_capacity_bytes=``), multi-window-batched (``prebatch=``:
    several windows' Eq. 9/12 matrices as one stacked program,
    ``fastpath.precompute_windows``) and through the compiled window
    pipeline (``pipeline=True``, ``core.pipeline``, with ``chunk=`` its
    speculative chunked selection), sharded or not (``shard=``,
    ``core.shard``).

Both take ``device=``: the k-NN search, the batched equations and the
pipeline's selection scan run there (the card unless ``"cpu"`` is
named).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core.evaluation import EvalResult, evaluate
from repro_torch.core.scheduler import (
    SchedulerPolicy,
    effective_apps,
    schedule_window,
)
from repro_torch.core.streaming import StreamingState
from repro_torch.core.types import Application, Request, Schedule
from repro_torch.device import resolve_device

__all__ = ["WindowResult", "run_window", "Simulation"]


@dataclasses.dataclass
class WindowResult:
    """One scheduled + oracle-scored window (``run_window`` output)."""

    schedule: Schedule
    result: EvalResult
    overhead_s: float

    @property
    def mean_utility(self) -> float:
        """Mean oracle utility of the window (Eq. 3 objective)."""
        return self.result.mean_utility


def run_window(
    policy: SchedulerPolicy,
    requests: Sequence[Request],
    apps: Mapping[str, Application],
    now: float,
    sneakpeeks=None,
    short_circuit: bool = False,
    *,
    device=None,
) -> WindowResult:
    """Schedule one window and score it with oracle accuracies."""
    dev = resolve_device(device)
    sched, eff_apps = schedule_window(
        policy, requests, apps, now, sneakpeeks=sneakpeeks,
        short_circuit=short_circuit, device=dev,
    )
    res = evaluate(sched, eff_apps, now, acc_mode="oracle", device=dev)
    return WindowResult(schedule=sched, result=res, overhead_s=sched.scheduling_overhead_s)


class Simulation:
    """Streaming multi-window simulation with sampled inference outcomes.

    Scheduling happens at window close against the CARRIED state: the
    worker's next batch starts at ``max(busy_until, window_close)`` and a
    model left resident by an earlier window is not re-charged its swap
    latency.  ``evaluate(..., state=...)`` commits realized executions
    back to the state.

    Args:
      workers: optional ``multiworker.Worker`` pool — generalizes the
        policy to §VII multi-worker placement (Eq. 15).
      num_workers: pool size when ``workers`` is not given (ids 0..n-1;
        single-worker policies only ever use worker 0; idle workers
        count toward utilization).
      memory_capacity_bytes: per-worker residency capacity (None = the
        paper's conservative single-slot model).
      prebatch: >1 stacks that many upcoming windows' Eq. 9/12 matrices
        into one program (``fastpath.precompute_windows``) before the
        sequential scheduling pass; ``prebatch_backend`` ("numpy", the
        default, or "jax") names the reference's route, and both run the
        same float64 program on ``device``, row-identical to the lazy
        per-window compute.
      pipeline: feed every window through one persistent
        ``pipeline.WindowPipeline`` (with ``workers``, its compiled
        Eq. 15 placement).
      chunk: speculative chunked selection size for the pipeline
        (``pipeline.WindowPipeline``'s ``chunk``): ``None`` defers to the
        policy's ``chunk`` field, 0 forces the sequential scan; without
        ``pipeline`` it is not used, as in the reference.
      shard: sharded window scheduling (``core.shard``): True splits the
        pipeline's tiles across every device of ``device``'s kind, an int
        pins the shard count; implies ``pipeline`` and composes with
        ``workers`` and ``chunk``.
      device: where the SneakPeek stage, the batched equations and the
        pipeline's scan run.
    """

    def __init__(
        self,
        policy: SchedulerPolicy,
        apps: Mapping[str, Application],
        window_s: float = 0.1,
        sneakpeeks=None,
        short_circuit: bool = False,
        seed: int = 0,
        workers=None,
        num_workers: int = 1,
        memory_capacity_bytes: int | None = None,
        prebatch: int = 0,
        prebatch_backend: str = "numpy",
        pipeline: bool = False,
        chunk: int | None = None,
        shard=False,
        *,
        device=None,
    ):
        if prebatch_backend not in ("numpy", "jax"):
            raise ValueError(f"unknown precompute backend {prebatch_backend!r}")
        self.policy = policy
        self.apps = dict(apps)
        self.window_s = window_s
        self.sneakpeeks = sneakpeeks
        self.short_circuit = short_circuit
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(seed)
        self.workers = list(workers) if workers else None
        self.prebatch = int(prebatch)
        self.prebatch_backend = prebatch_backend
        self.state = StreamingState(
            num_workers=len(self.workers) if self.workers else max(1, num_workers),
            now=0.0,
            memory_capacity_bytes=memory_capacity_bytes,
            worker_ids=[w.wid for w in self.workers] if self.workers else None,
        )
        # Scheduled against a fixed app map: short-circuit augmentation is
        # deterministic, so it must not be rebuilt per window (fresh
        # Application objects would also defeat AppArrays memoization).
        self._eff_apps = effective_apps(self.apps, sneakpeeks, short_circuit)
        self._pipeline = None
        if shard:
            from repro_torch.core.shard import ShardedWindowPipeline

            self._pipeline = ShardedWindowPipeline(
                self._eff_apps, policy=policy, workers=self.workers, chunk=chunk, shard=shard,
                device=self.device,
            )
        elif pipeline:
            from repro_torch.core.pipeline import WindowPipeline

            self._pipeline = WindowPipeline(
                self._eff_apps, policy=policy, workers=self.workers, chunk=chunk,
                device=self.device,
            )
        self.log: list[dict] = []

    @property
    def backlog_t(self) -> float:
        """Busiest worker's busy-until time."""
        return max(tl.t for _, tl in self.state.items())

    def _window_batches(self, requests: Sequence[Request], horizon_s: float | None):
        requests = sorted(requests, key=lambda r: r.arrival_s)
        t_end = horizon_s if horizon_s is not None else requests[-1].arrival_s
        n_windows = int(np.ceil((t_end + 1e-9) / self.window_s)) or 1
        idx = 0
        out: list[tuple[int, list[Request]]] = []
        for w in range(n_windows):
            window_close = (w + 1) * self.window_s
            batch = []
            while idx < len(requests) and requests[idx].arrival_s <= window_close:
                batch.append(requests[idx])
                idx += 1
            if batch:
                out.append((w, batch))
        return out

    def run(self, requests: Sequence[Request], horizon_s: float | None = None) -> dict:
        """Consume a request trace; returns aggregate realized metrics."""
        if not requests:
            return {"utility": 0.0, "accuracy": 0.0, "violations": 0, "count": 0}
        from repro_torch.core.sneakpeek import attach_sneakpeek

        windows = self._window_batches(requests, horizon_s)
        total_u, total_correct, violations, count = 0.0, 0.0, 0, 0
        chunk = max(1, self.prebatch)
        for c0 in range(0, len(windows), chunk):
            group = windows[c0 : c0 + chunk]
            # SneakPeek stage per window (exactly once per request — the
            # evidence draw may be stochastic).
            if self.sneakpeeks:
                for _, batch in group:
                    attach_sneakpeek(batch, self.apps, self.sneakpeeks, device=self.device)
            arrays_list = [None] * len(group)
            if self.prebatch > 1:
                from repro_torch.core.fastpath import precompute_windows

                arrays_list = precompute_windows(
                    [(batch, (w + 1) * self.window_s) for w, batch in group],
                    self._eff_apps,
                    data_aware=self.policy.data_aware,
                    backend=self.prebatch_backend,
                    device=self.device,
                )
            for (w, batch), arrays in zip(group, arrays_list):
                window_close = (w + 1) * self.window_s
                carried = self.state.backlog_s(window_close)
                if self._pipeline is not None:
                    eff_apps = self._eff_apps
                    sched = self._pipeline.schedule(
                        batch, window_close, state=self.state, arrays=arrays
                    )
                else:
                    sched, eff_apps = schedule_window(
                        self.policy, batch, self._eff_apps, window_close,
                        workers=self.workers, state=self.state, arrays=arrays,
                        device=self.device,
                    )
                # The state owns the pool: every timeline (idle or not)
                # counts toward the logged utilization.
                res = evaluate(
                    sched, eff_apps, window_close, acc_mode="oracle", state=self.state,
                    device=self.device,
                )
                # Sample realized outcomes for accuracy accounting.
                for e, u in zip(sched.sorted_entries(), res.utilities):
                    r = e.request
                    profile = eff_apps[r.app].model(e.model)
                    p_correct = (
                        profile.recalls[r.true_label]
                        if r.true_label is not None
                        else profile.profiled_accuracy()
                    )
                    correct = self.rng.random() < p_correct
                    total_correct += float(correct)
                    total_u += u
                    if e.est_completion_s > r.deadline_s:
                        violations += 1
                    count += 1
                self.log.append(
                    {
                        "window": w,
                        "n": len(batch),
                        "utility": res.mean_utility,
                        "violations": res.violations,
                        "overhead_s": sched.scheduling_overhead_s,
                        "backlog_s": carried,
                        "utilization": res.utilization,
                    }
                )
        return {
            "utility": total_u / max(1, count),
            "accuracy": total_correct / max(1, count),
            "violations": violations,
            "violation_rate": violations / max(1, count),
            "count": count,
        }
