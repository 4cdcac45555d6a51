"""Cross-window streaming state (the substrate of every streaming experiment).

A single scheduling window is stateless: the policy builds fresh
``WorkerTimeline``s at window close and the evaluator replays the schedule
on fresh timelines.  Streaming execution is not — two pieces of worker
state survive window boundaries and change both the schedule (estimated
swap costs) and the realized metrics:

  * **Backlog**: each worker's busy-until time.  A window's batches start
    at ``max(busy_until, window_close)`` *per worker*; collapsing the pool
    into one scalar backlog serializes multi-worker schedules.
  * **Residency**: the models left in each worker's memory.  Rebuilding
    timelines fresh each window re-charges the model swap on every window
    boundary, silently cancelling the swap amortization that grouped
    scheduling exists to win.

``StreamingState`` owns one persistent ``WorkerTimeline`` per worker and
is threaded through ``Simulation``, ``evaluate`` and the serving loop:
schedulers *peek* it (via ``clone()``d timelines, so speculative placement
never mutates it) and ``evaluate(..., state=...)`` *commits* realized
executions to it.

Each committed batch is also logged per worker (``BacklogBatch``) with
its pre-batch timeline snapshot, and pruned once it has finished.
``to_arrays`` encodes the pool for the multi-worker fast path
(``fastpath.PoolArrays``).  Window-close preemption, ``withdraw`` and
the backlog's array encoding of the reference (``repro.core.streaming``)
come with ROADMAP item 14.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Mapping, Sequence

import numpy as np

from repro_torch.core.evaluation import WorkerTimeline
from repro_torch.core.types import Request

__all__ = ["BacklogBatch", "StreamingState"]


@dataclasses.dataclass
class BacklogBatch:
    """One committed batch execution a worker has not finished yet.

    Records the member requests, the timing the evaluator committed and
    the *pre-batch* timeline snapshot (busy-until time and LRU residency)
    that a later rollback would restore.
    """

    requests: list[Request]
    model: str
    batch_id: int
    est_start_s: float
    est_latency_s: float
    t_before: float
    residency_before: list[str]

    @property
    def est_completion_s(self) -> float:
        """Committed completion time of the batch."""
        return self.est_start_s + self.est_latency_s

    @property
    def rids(self) -> list[int]:
        """Member request ids, schedule order."""
        return [r.rid for r in self.requests]


class StreamingState:
    """Per-worker timelines (busy-until + LRU residency) carried across windows."""

    def __init__(
        self,
        num_workers: int = 1,
        now: float = 0.0,
        memory_capacity_bytes: int | None = None,
        worker_ids: Sequence[int] | None = None,
    ):
        """``worker_ids`` pins the pool to explicit ids (heterogeneous
        pools whose Worker.wid values are not 0..n-1); otherwise ids are
        0..num_workers-1."""
        ids = list(worker_ids) if worker_ids is not None else list(range(num_workers))
        if not ids:
            raise ValueError("streaming state needs at least one worker")
        self.capacity = memory_capacity_bytes
        self._now = float(now)
        self.timelines: dict[int, WorkerTimeline] = {
            w: WorkerTimeline(now, memory_capacity_bytes) for w in ids
        }
        # Per-worker committed-but-unfinished batches, commit order
        # (est_start_s nondecreasing per worker — execution is sequential).
        self.backlog: dict[int, list[BacklogBatch]] = {w: [] for w in ids}

    @property
    def num_workers(self) -> int:
        """Number of workers in the carried pool."""
        return len(self.timelines)

    def timeline(self, wid: int) -> WorkerTimeline:
        """The persistent timeline of worker ``wid`` (created on demand)."""
        tl = self.timelines.get(wid)
        if tl is None:
            tl = WorkerTimeline(self._now, self.capacity)
            self.timelines[wid] = tl
        return tl

    def peek_timeline(self, wid: int) -> WorkerTimeline:
        """Read-only view of worker ``wid``: the tracked timeline when it
        exists, else a FRESH idle one that is NOT inserted — scheduling
        peeks must leave the committed pool untouched (``timeline`` is
        the committing accessor)."""
        tl = self.timelines.get(wid)
        return tl if tl is not None else WorkerTimeline(self._now, self.capacity)

    def advance(self, now: float) -> None:
        """Move the clock: idle workers become ready at ``now``; busy
        workers keep their backlog (their next batch starts later).
        Backlog records whose committed completion has passed are pruned."""
        self._now = max(self._now, float(now))
        for tl in self.timelines.values():
            tl.advance(now)
        for w, batches in self.backlog.items():
            if batches:
                self.backlog[w] = [
                    b for b in batches if b.est_completion_s > self._now
                ]

    # -- backlog log ------------------------------------------------------
    def record_batch(
        self,
        wid: int,
        requests: Sequence[Request],
        model: str,
        batch_id: int,
        est_start_s: float,
        est_latency_s: float,
        t_before: float,
        residency_before: Sequence[str],
    ) -> None:
        """Log one committed batch execution on worker ``wid`` (called by
        ``evaluate(..., state=...)`` as it replays the schedule), with
        the pre-batch timeline snapshot."""
        self.backlog.setdefault(wid, []).append(
            BacklogBatch(
                requests=list(requests),
                model=model,
                batch_id=batch_id,
                est_start_s=float(est_start_s),
                est_latency_s=float(est_latency_s),
                t_before=float(t_before),
                residency_before=list(residency_before),
            )
        )

    def backlog_s(self, now: float) -> float:
        """Worst-case carried backlog: how far the busiest worker's
        busy-until time extends past ``now`` (0 when all are idle)."""
        return max(0.0, max(tl.t for tl in self.timelines.values()) - float(now))

    def resident_models(self) -> dict[int, list[str]]:
        """Per-worker resident model names, LRU order (oldest first)."""
        return {w: list(tl._resident) for w, tl in self.timelines.items()}

    def register_sizes(self, sizes: Mapping[str, int]) -> None:
        """Propagate model byte sizes to every worker timeline."""
        for tl in self.timelines.values():
            tl.register_sizes(sizes)

    def to_arrays(
        self,
        gids: Mapping[str, int],
        wids: Sequence[int] | None = None,
        slots: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Encode the pool as ``(t, res, reg)`` arrays.

        ``gids`` maps model name -> integer id (every resident name must
        be covered); ``wids`` fixes the worker-row order (default: sorted
        ids); ``slots`` the LRU slot count (default ``len(gids)``).
        Returns ``t`` (W,) float64 busy-until times, ``res`` (W, K) int64
        resident ids, LRU oldest first, ``-1`` padding at the tail, and
        ``reg`` (W, G) float64 registered byte sizes, ``-1`` where a model
        has none (``WorkerTimeline._touch`` would take the profile's).
        """
        ids = list(wids) if wids is not None else [w for w, _ in self.items()]
        k = slots if slots is not None else max(1, len(gids))
        t = np.zeros(len(ids), dtype=np.float64)
        res = np.full((len(ids), k), -1, dtype=np.int64)
        reg = np.full((len(ids), max(1, len(gids))), -1.0, dtype=np.float64)
        for row, w in enumerate(ids):
            tl = self.peek_timeline(w)  # encoding never mutates the pool
            t[row] = tl.t
            for j, name in enumerate(tl._resident):
                res[row, j] = gids[name]
            for name, size in tl._profiles.items():
                g = gids.get(name)
                if g is not None:
                    reg[row, g] = float(size)
        return t, res, reg

    def clone(self) -> "StreamingState":
        """Deep copy for speculative scheduling: mutating the clone's
        timelines or backlog log leaves the committed state untouched
        (the member ``Request`` objects themselves are shared)."""
        out = StreamingState.__new__(StreamingState)
        out.capacity = self.capacity
        out._now = self._now
        out.timelines = {w: tl.clone() for w, tl in self.timelines.items()}
        out.backlog = {
            w: [
                dataclasses.replace(
                    b,
                    requests=list(b.requests),
                    residency_before=list(b.residency_before),
                )
                for b in batches
            ]
            for w, batches in self.backlog.items()
        }
        return out

    def items(self) -> Iterator[tuple[int, WorkerTimeline]]:
        """(wid, timeline) pairs, ascending worker id."""
        return iter(sorted(self.timelines.items()))

    def __repr__(self) -> str:
        parts = ", ".join(
            f"w{w}: t={tl.t:.4f} resident={list(tl._resident)}"
            for w, tl in sorted(self.timelines.items())
        )
        return f"StreamingState({parts})"
