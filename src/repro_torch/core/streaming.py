"""Cross-window streaming state (the substrate of every streaming experiment).

The counterpart of ``repro.core.streaming``.  A single scheduling window
is stateless: the policy builds fresh ``WorkerTimeline``s at window
close and the evaluator replays the schedule on fresh timelines.
Streaming execution is not — two pieces of worker state survive window
boundaries and change both the schedule (estimated swap costs) and the
realized metrics:

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

A third piece of state supports **window-close preemption** (the serving
loop's ``preempt=True`` mode): the per-worker *backlog log* of committed
batches that have not finished yet (``BacklogBatch``).  Each record
carries a *dispatch mark* — set by the executor pool when the batch
actually begins running — distinguishing *started* work (never
withdrawn) from work the scheduler merely committed speculatively.
``preempt(now)`` withdraws the committed-but-unstarted tail of each
worker's backlog, rolling the timeline (busy-until time AND LRU
residency) back to the snapshot taken before the first withdrawn batch,
so the withdrawn requests can be merged into the next window's queue and
re-scheduled under fresh posteriors; ``withdraw(rids)`` removes the
batches of failed executions.  All of it is host bookkeeping, as in the
reference: nothing here touches the card.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Mapping, Sequence

import numpy as np

from repro_torch.core.evaluation import WorkerTimeline
from repro_torch.core.types import Request

__all__ = ["BacklogBatch", "StreamingState"]

# Tolerance for "has this batch started by ``now``" comparisons: window
# closes land exactly on batch start times (a batch committed to start at
# the close instant has NOT started yet and is withdrawable).
_START_EPS = 1e-12


@dataclasses.dataclass
class BacklogBatch:
    """One committed batch execution a worker has not finished yet.

    Records everything preemption needs: the member requests (so a
    withdrawn batch can be re-admitted), the timing the evaluator
    committed, the *pre-batch* timeline snapshot (busy-until time and LRU
    residency, for exact rollback), and the dispatch mark set by the
    executor pool when the batch physically starts.
    """

    requests: list[Request]
    model: str
    batch_id: int
    est_start_s: float
    est_latency_s: float
    t_before: float
    residency_before: list[str]
    dispatched: bool = False

    @property
    def est_completion_s(self) -> float:
        """Committed completion time of the batch."""
        return self.est_start_s + self.est_latency_s

    @property
    def rids(self) -> list[int]:
        """Member request ids, schedule order."""
        return [r.rid for r in self.requests]

    def started(self, now: float) -> bool:
        """Whether the batch is beyond withdrawal at time ``now``: either
        physically dispatched by the executor pool or already started in
        committed (simulated) time."""
        return self.dispatched or self.est_start_s < now - _START_EPS


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
        Backlog records whose committed completion has passed are pruned
        (finished work can never be withdrawn)."""
        self._now = max(self._now, float(now))
        for tl in self.timelines.values():
            tl.advance(now)
        for w, batches in self.backlog.items():
            if batches:
                self.backlog[w] = [
                    b for b in batches if b.est_completion_s > self._now
                ]

    # -- backlog log (window-close preemption substrate) -----------------
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
        ``evaluate(..., state=...)`` as it replays the schedule).  The
        pre-batch timeline snapshot makes later withdrawal exact."""
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

    def mark_dispatched(self, rids: Sequence[int]) -> None:
        """Set the dispatch mark on every backlog batch containing one of
        ``rids`` — the executor pool calls this as a batch begins running,
        making it immune to withdrawal."""
        wanted = set(rids)
        for batches in self.backlog.values():
            for b in batches:
                if not b.dispatched and wanted.intersection(b.rids):
                    b.dispatched = True

    def backlog_requests(self) -> list[Request]:
        """All requests currently committed but unfinished, any worker."""
        return [r for bs in self.backlog.values() for b in bs for r in b.requests]

    def undispatched_backlog(self) -> int:
        """Number of backlog batches no executor lane has dispatched yet —
        the work a preemptive server must keep closing windows for."""
        return sum(1 for bs in self.backlog.values() for b in bs if not b.dispatched)

    def preempt(self, now: float) -> tuple[list[Request], list[Request]]:
        """Withdraw committed-but-unstarted work at window close ``now``.

        Per worker, the maximal contiguous *tail* of backlog batches that
        are neither dispatched nor started in committed time
        (``est_start_s >= now``) is withdrawn; the timeline rolls back to
        the busy-until time and LRU residency snapshot taken before the
        earliest withdrawn batch (exact, because execution is sequential:
        unstarted batches are always a tail).  Started or dispatched
        batches are NEVER withdrawn.

        Returns ``(readmit, expired)``: withdrawn requests whose deadline
        is still ahead of ``now`` (to merge into the next window's queue)
        and those already past it (to drop with a recorded violation),
        each sorted by ``(arrival_s, rid)``.
        """
        now = float(now)
        readmit: list[Request] = []
        expired: list[Request] = []
        for wid, batches in self.backlog.items():
            tl = self.timelines.get(wid)
            while batches and not batches[-1].started(now):
                b = batches.pop()
                for r in b.requests:
                    (expired if r.deadline_s <= now else readmit).append(r)
                if tl is not None:
                    # Popping tail-first means the LAST restore applied is
                    # the earliest withdrawn batch's snapshot — exact.
                    tl.t = b.t_before
                    tl._resident = list(b.residency_before)
        return (
            sorted(readmit, key=lambda r: (r.arrival_s, r.rid)),
            sorted(expired, key=lambda r: (r.arrival_s, r.rid)),
        )

    def withdraw(self, rids) -> list[Request]:
        """Remove the backlog batches containing any of ``rids`` — the
        per-batch generalization of ``preempt`` used when execution
        FAILED (lane fault / injected fault), so dispatch marks and
        committed start times do not protect them.

        Per worker, the maximal contiguous TAIL of failed batches is
        popped with the exact ``preempt``-style rollback (busy-until time
        and LRU residency restored to the pre-batch snapshot — exact
        because execution is sequential, so a popped tail leaves the
        remaining commitments untouched).  Failed batches in the MIDDLE
        of a queue — a transient with later successful work behind it —
        are removed from the log only: the lane really burned the slot,
        so the conservative choice keeps the committed busy-until time.

        Returns the member requests of every removed batch, sorted by
        (arrival, rid) for deterministic re-admission."""
        wanted = set(rids)
        removed: list[Request] = []
        for wid, batches in self.backlog.items():
            tl = self.timelines.get(wid)
            # Exact tail rollback first (crash cascades are tails).
            while batches and wanted.intersection(batches[-1].rids):
                b = batches.pop()
                removed.extend(b.requests)
                if tl is not None:
                    tl.t = b.t_before
                    tl._resident = list(b.residency_before)
            # Mid-queue removals: log-only (no timeline rollback).
            keep = []
            for b in batches:
                if wanted.intersection(b.rids):
                    removed.extend(b.requests)
                else:
                    keep.append(b)
            self.backlog[wid] = keep
        return sorted(removed, key=lambda r: (r.arrival_s, r.rid))

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

    # -- array encoding (the pool-state representation the vectorized ----
    # -- Eq. 15 fast path consumes, ``fastpath.PoolArrays``) -------------
    def to_arrays(
        self,
        gids: Mapping[str, int],
        wids: Sequence[int] | None = None,
        slots: int | None = None,
        include_backlog: bool = False,
    ) -> tuple:
        """Encode the pool as ``(t, res, reg)`` arrays.

        ``gids`` maps model name -> integer id (every resident name must
        be covered); ``wids`` fixes the worker-row order (default: sorted
        ids); ``slots`` the LRU slot count (default ``len(gids)`` — an
        upper bound, residency never holds duplicates).  Returns

          * ``t``   (W,)   float64 busy-until times,
          * ``res`` (W, K) int64 resident ids, LRU oldest first, ``-1``
            padding packed at the tail,
          * ``reg`` (W, G) float64 registered byte sizes, ``-1`` where a
            model has no registered size (``WorkerTimeline._touch`` would
            fall back to the profile's ``memory_bytes``).

        ``include_backlog=True`` appends a fourth element: the backlog-log
        encoding built by ``backlog_to_arrays`` (dispatch marks included),
        for consumers that must round-trip the FULL preemption state, not
        just the pool the fast path reads.

        The encoding is lossless given ``gids``: ``from_arrays`` rebuilds
        an equivalent state (see tests/test_torch_closed_loop.py).
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
        if include_backlog:
            return t, res, reg, self.backlog_to_arrays(gids, wids=ids, slots=k)
        return t, res, reg

    def backlog_to_arrays(
        self,
        gids: Mapping[str, int],
        wids: Sequence[int] | None = None,
        slots: int | None = None,
    ) -> dict[str, np.ndarray]:
        """Array encoding of the backlog log (one row per committed batch).

        Numeric fields — worker id, model id, batch id, committed timing,
        rollback snapshot, dispatch mark — are plain arrays; the member
        ``Request`` objects ride in an object array (``members``, indexed
        by ``offsets``): they are host-side re-admission payload, never
        consumed by the fast path.  ``backlog_from_arrays`` (and
        ``from_arrays(..., backlog=...)``) inverts this losslessly,
        dispatch marks included.
        """
        ids = list(wids) if wids is not None else [w for w, _ in self.items()]
        k = slots if slots is not None else max(1, len(gids))
        batches = [(w, b) for w in ids for b in self.backlog.get(w, [])]
        n = len(batches)
        enc = {
            "wid": np.zeros(n, dtype=np.int64),
            "gid": np.zeros(n, dtype=np.int64),
            "batch_id": np.zeros(n, dtype=np.int64),
            "est_start_s": np.zeros(n, dtype=np.float64),
            "est_latency_s": np.zeros(n, dtype=np.float64),
            "t_before": np.zeros(n, dtype=np.float64),
            "residency_before": np.full((n, k), -1, dtype=np.int64),
            "dispatched": np.zeros(n, dtype=bool),
            "offsets": np.zeros(n + 1, dtype=np.int64),
            "members": np.empty(sum(len(b.requests) for _, b in batches), dtype=object),
        }
        pos = 0
        for row, (w, b) in enumerate(batches):
            enc["wid"][row] = w
            enc["gid"][row] = gids[b.model]
            enc["batch_id"][row] = b.batch_id
            enc["est_start_s"][row] = b.est_start_s
            enc["est_latency_s"][row] = b.est_latency_s
            enc["t_before"][row] = b.t_before
            for j, name in enumerate(b.residency_before):
                enc["residency_before"][row, j] = gids[name]
            enc["dispatched"][row] = b.dispatched
            enc["offsets"][row] = pos
            for r in b.requests:
                enc["members"][pos] = r
                pos += 1
        enc["offsets"][n] = pos
        return enc

    @staticmethod
    def backlog_from_arrays(
        enc: Mapping[str, np.ndarray], gid_names: Sequence[str]
    ) -> dict[int, list[BacklogBatch]]:
        """Inverse of ``backlog_to_arrays`` (``gid_names[g]`` names id ``g``)."""
        out: dict[int, list[BacklogBatch]] = {}
        for row in range(len(enc["wid"])):
            lo, hi = int(enc["offsets"][row]), int(enc["offsets"][row + 1])
            out.setdefault(int(enc["wid"][row]), []).append(
                BacklogBatch(
                    requests=[enc["members"][i] for i in range(lo, hi)],
                    model=gid_names[int(enc["gid"][row])],
                    batch_id=int(enc["batch_id"][row]),
                    est_start_s=float(enc["est_start_s"][row]),
                    est_latency_s=float(enc["est_latency_s"][row]),
                    t_before=float(enc["t_before"][row]),
                    residency_before=[
                        gid_names[int(g)]
                        for g in enc["residency_before"][row]
                        if g >= 0
                    ],
                    dispatched=bool(enc["dispatched"][row]),
                )
            )
        return out

    @classmethod
    def from_arrays(
        cls,
        t: np.ndarray,
        res: np.ndarray,
        reg: np.ndarray,
        gid_names: Sequence[str],
        memory_capacity_bytes: int | None = None,
        wids: Sequence[int] | None = None,
        backlog: Mapping[str, np.ndarray] | None = None,
    ) -> "StreamingState":
        """Inverse of ``to_arrays``: rebuild the per-worker timelines from
        the array encoding (``gid_names[g]`` names model id ``g``).
        ``backlog`` (a ``backlog_to_arrays`` encoding) additionally
        restores the preemption backlog log, dispatch marks included."""
        t = np.asarray(t, dtype=np.float64)
        ids = list(wids) if wids is not None else list(range(len(t)))
        out = cls(
            num_workers=len(ids),
            now=float(t.min()) if len(t) else 0.0,
            memory_capacity_bytes=memory_capacity_bytes,
            worker_ids=ids,
        )
        for row, w in enumerate(ids):
            tl = out.timeline(w)
            tl.t = float(t[row])
            tl._resident = [gid_names[int(g)] for g in res[row] if g >= 0]
            tl._profiles = {
                gid_names[g]: int(reg[row, g])
                for g in range(reg.shape[1])
                if reg[row, g] >= 0
            }
        if backlog is not None:
            for w, batches in cls.backlog_from_arrays(backlog, gid_names).items():
                out.backlog[w] = batches
        return out

    def signature(self) -> tuple:
        """Cheap equality token over the committed pool AS SCHEDULING
        INPUT: per-worker busy-until time and LRU residency order.  Two
        states with equal signatures yield identical schedules for the
        same request set (scheduling peeks exactly these fields) — the
        overlapped serving loop compares the snapshot it speculated
        against with the post-reconcile state to decide whether its
        speculative schedule is still the synchronous decision.  Dispatch
        marks and backlog membership are deliberately excluded: they
        affect future preemption, never the current placement."""
        return tuple(
            (w, tl.t, tuple(tl._resident)) for w, tl in self.items()
        )

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
