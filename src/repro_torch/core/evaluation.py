"""Schedule timing + utility evaluation (paper Eq. 1-3).

Centralizes the execution-time model shared by every policy, the brute
force solver, and the simulator:

  * Eq. 1 start times — sequential execution per worker; each entry's
    start is the completion of everything ordered before it.
  * l(m) includes the model-swap (load) cost whenever the model is not
    resident (the paper's "context switch time required to swap the model
    variant into GPU memory").
  * Batched entries (same ``batch_id``) execute as one inference: a
    single swap + one batched latency l(m, b); all member requests
    complete when the batch completes.

Accuracy modes:
  * "profiled"  — data-oblivious estimate (test-set theta), Eq. 7.
  * "sharpened" — SneakPeek posterior estimate when request.theta is set
    (falls back to profiled otherwise); short-circuit variants always
    profiled (§V-C1).
  * "oracle"    — Eq. 9 with theta one-hot at the true label, i.e. the
    per-class recall.  This is the paper's "true model accuracy" used for
    reporting (Fig. 6 and the utility figures).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Sequence

import numpy as np

from repro_torch.core.accuracy import ModelProfile, expected_accuracy
from repro_torch.core.residency import evict_lru
from repro_torch.core.types import Application, Request, Schedule, ScheduleEntry
from repro_torch.device import resolve_device

__all__ = ["WorkerTimeline", "estimate_accuracy", "evaluate", "EvalResult"]


class WorkerTimeline:
    """Sequential execution timeline of one worker with LRU model residency.

    Residency follows ``residency.evict_lru``: MRU reorder on a resident
    hit; append + oldest-first eviction on a load, the just-loaded model
    protected.  Plain host bookkeeping, as in the reference.
    """

    def __init__(
        self,
        now: float,
        memory_capacity_bytes: int | None = None,
        resident: Iterable[str] = (),
    ):
        self.t = float(now)
        self.capacity = memory_capacity_bytes
        # LRU order: oldest first.  With capacity=None we model a
        # single-slot residency (swap whenever the model changes), the
        # paper's conservative default.
        self._resident: list[str] = list(resident)
        # Model byte sizes for capacity eviction; filled by register_sizes.
        self._profiles: dict[str, int] = {}

    def _is_resident(self, name: str) -> bool:
        return name in self._resident

    def _touch(self, profile: ModelProfile) -> float:
        """Returns the swap latency for running ``profile`` and updates residency."""
        name = profile.name
        if self._is_resident(name):
            self._resident.remove(name)
            self._resident.append(name)
            return 0.0
        swap = profile.load_latency_s
        if self.capacity is None:
            self._resident = [name]
        else:
            # Byte sizes come from the profile unless register_sizes
            # overrode them; profiles without memory_bytes contribute 0
            # (eviction then never fires — effectively unlimited memory).
            self._profiles.setdefault(name, profile.memory_bytes)
            self._resident.append(name)
            evict_lru(self._resident, self._profiles, self.capacity, protect=name)
        return swap

    def register_sizes(self, sizes: Mapping[str, int]) -> None:
        """Override model byte sizes used for capacity eviction."""
        self._profiles = dict(sizes)

    def clone(self) -> "WorkerTimeline":
        """Independent copy: speculative scheduling peeks a clone so the
        committed (streaming) timeline is never mutated."""
        out = WorkerTimeline(self.t, self.capacity, self._resident)
        out._profiles = dict(self._profiles)
        return out

    def advance(self, now: float) -> None:
        """An idle worker becomes ready at ``now``; a backlogged worker
        keeps its later busy-until time.  Residency is untouched."""
        self.t = max(self.t, float(now))

    @property
    def mru(self) -> str | None:
        """Most-recently-used resident model (None when empty)."""
        return self._resident[-1] if self._resident else None

    def swap_vector(self, names: Sequence[str], swaps: np.ndarray) -> np.ndarray:
        """(M,) swap latencies peek_batch would charge each model if it ran
        next — the batched counterpart the fast path scores Eq. 13 with."""
        return np.array(
            [0.0 if self._is_resident(n) else s for n, s in zip(names, swaps)]
        )

    def peek_batch(self, profile: ModelProfile, batch_size: int) -> tuple[float, float]:
        """(start, completion) if a batch ran next, WITHOUT committing."""
        swap = 0.0 if self._is_resident(profile.name) else profile.load_latency_s
        lat = profile.latency(batch_size)
        return self.t, self.t + swap + lat

    def run_batch(self, profile: ModelProfile, batch_size: int) -> tuple[float, float]:
        """Commit a batch execution; returns (start, completion)."""
        start = self.t
        swap = self._touch(profile)
        self.t = start + swap + profile.latency(batch_size)
        return start, self.t


def estimate_accuracy(
    request: Request, app: Application, profile: ModelProfile, mode: str
) -> float:
    """Accuracy estimate for (request, model) under the given mode."""
    if mode == "profiled" or profile.is_short_circuit:
        return profile.profiled_accuracy()
    if mode == "sharpened":
        if request.theta is None:
            return profile.profiled_accuracy()
        return expected_accuracy(profile.recalls, request.theta)
    if mode == "oracle":
        if request.true_label is None:
            return profile.profiled_accuracy()
        return float(profile.recalls[request.true_label])
    raise ValueError(f"unknown accuracy mode {mode!r}")


@dataclasses.dataclass
class EvalResult:
    """Scored replay of one schedule (Eq. 3 terms + realized timing)."""

    mean_utility: float
    utilities: np.ndarray
    completions: np.ndarray
    deadlines: np.ndarray
    accuracies: np.ndarray
    violations: int
    violation_time_s: float
    # Per-worker busy seconds accrued by this replay (swap + execution).
    # Pre-created idle workers (``num_workers``) appear with 0.0, so pool
    # utilization reflects workers that never received work.
    worker_busy_s: dict = dataclasses.field(default_factory=dict)
    span_s: float = 0.0  # makespan of the replay: max completion - now

    @property
    def violation_rate(self) -> float:
        """Fraction of scheduled requests that missed their deadline."""
        return self.violations / max(1, len(self.utilities))

    @property
    def utilization(self) -> float:
        """Mean fraction of the makespan each worker spent busy."""
        if not self.worker_busy_s or self.span_s <= 0:
            return 0.0
        busy = sum(self.worker_busy_s.values())
        return busy / (len(self.worker_busy_s) * self.span_s)


def _scale_profile_latency(profile: ModelProfile, scale: float) -> ModelProfile:
    """``profile`` with inference latency multiplied by ``scale``.

    Swap (load) latency is untouched — the drift EWMA observes execution
    time, not host-to-device transfers.  ``latency_model`` coefficients
    scale with the base latency so batched timing stays consistent.
    """
    lm = profile.latency_model
    return dataclasses.replace(
        profile,
        latency_s=profile.latency_s * scale,
        latency_model=None if lm is None else (lm[0] * scale, lm[1] * scale),
    )


def evaluate(
    schedule: Schedule,
    apps: Mapping[str, Application],
    now: float,
    acc_mode: str = "oracle",
    memory_capacity_bytes: int | None = None,
    num_workers: int | None = None,
    state=None,
    latency_scale=None,
    device=None,
) -> EvalResult:
    """Replay a schedule through worker timelines and score it (Eq. 3).

    Entries are executed per worker in ``order``; consecutive entries with
    the same (worker, batch_id >= 0, model) form one batched inference.

    ``num_workers`` pre-creates that many timelines (ids 0..n-1) so idle
    workers show up in ``EvalResult.worker_busy_s`` / ``utilization``.

    ``state`` (a ``streaming.StreamingState``) replays onto the
    persistent per-worker timelines instead of fresh ones: batches start
    after each worker's carried backlog, resident models are not
    re-charged their swap, and the realized executions are COMMITTED to
    the state (residency + busy-until carry to the next window).  Each
    committed batch is also logged to the state's preemption backlog
    (``StreamingState.record_batch`` with a pre-batch rollback snapshot)
    so the serving loop's ``preempt=True`` mode can withdraw and
    re-schedule committed-but-unstarted work at the next window close
    with its utility re-accounted there.  The
    state OWNS the pool: its existing timelines all count toward
    utilization, ``num_workers`` is ignored, and residency capacity must
    be configured on the StreamingState, not here.

    ``latency_scale`` (a callable ``(wid, model_name) -> float``, from
    ``HealthTracker.scale_fn``) multiplies each batch's inference latency
    during replay — the closed loop's drift-corrected committed timeline.
    Swap latency is never scaled.

    ``device`` is where the batched Eq. 9/Eq. 2 scoring runs
    (``device.resolve_device``: the card unless ``"cpu"`` is named); the
    timeline replay and the returned arrays stay on the host.
    """
    entries = schedule.sorted_entries()
    if state is not None:
        if memory_capacity_bytes is not None:
            raise ValueError(
                "memory_capacity_bytes is owned by the streaming state; "
                "set it on StreamingState instead"
            )
        state.advance(now)
        workers = state.timelines
    else:
        workers = {}
        if num_workers:
            workers = {
                w: WorkerTimeline(now, memory_capacity_bytes) for w in range(num_workers)
            }
    busy = {w: 0.0 for w in workers}
    if not entries:
        return EvalResult(
            0.0, np.zeros(0), np.zeros(0), np.zeros(0), np.zeros(0), 0, 0.0,
            worker_busy_s=busy,
        )

    # Group consecutive same-batch entries per worker.
    batches: list[list[ScheduleEntry]] = []
    for e in entries:
        if (
            batches
            and batches[-1][0].worker == e.worker
            and batches[-1][0].batch_id == e.batch_id
            and e.batch_id >= 0
            and batches[-1][0].model == e.model
        ):
            batches[-1].append(e)
        else:
            batches.append([e])

    # Eq. 1 replay: sequential per-worker timing (stateful, cheap) ...
    for batch in batches:
        w = batch[0].worker
        if w not in workers:
            workers[w] = (
                state.timeline(w) if state is not None
                else WorkerTimeline(now, memory_capacity_bytes)
            )
            busy.setdefault(w, 0.0)
        profile = apps[batch[0].request.app].model(batch[0].model)
        if latency_scale is not None:
            s = latency_scale(w, batch[0].model)
            if s != 1.0:
                profile = _scale_profile_latency(profile, s)
        tl = workers[w]
        # Pre-batch snapshot for the streaming backlog log: window-close
        # preemption rolls the timeline back to exactly this point when
        # the batch is withdrawn before starting (streaming.preempt).
        t_before = tl.t
        residency_before = list(tl._resident) if state is not None else ()
        start, completion = tl.run_batch(profile, len(batch))
        busy[w] += completion - start
        if state is not None:
            state.record_batch(
                w,
                [e.request for e in batch],
                batch[0].model,
                batch[0].batch_id,
                start,
                completion - start,
                t_before,
                residency_before,
            )
        for e in batch:
            e.est_start_s = start
            e.est_latency_s = completion - start

    # ... then batched Eq. 9 accuracy estimation + Eq. 2 scoring over the
    # whole schedule at once, on the device (the Eq. 2 kernel).
    from repro_torch.core.fastpath import score_entries

    accs, utilities, completions, deadlines = score_entries(
        entries, apps, acc_mode, device=resolve_device(device)
    )
    over = completions - deadlines
    missed = over > 0
    return EvalResult(
        mean_utility=float(utilities.mean()),
        utilities=utilities,
        completions=completions,
        deadlines=deadlines,
        accuracies=accs,
        violations=int(missed.sum()),
        violation_time_s=float(over[missed].sum()),
        worker_busy_s=busy,
        span_s=max(0.0, float(completions.max()) - float(now)),
    )
