"""Per-worker health tracking and realized-latency drift correction.

The counterpart of ``repro.core.health``, line for line: plain Python
floats on the host, in the reference's order of operations, so the
drift scales (and the decisions they steer) are bit-identical.

Closes the serving loop (ROADMAP: "feed realized execution times back
into the committed timelines"): the scheduler's Eq. 15 placements are
committed with *profiled* latencies, but the executor pool reports what
each batch actually took.  ``HealthTracker`` folds those reports into

  * a per-(worker, model) EWMA of the realized/committed latency ratio —
    the **drift scale** ``s[w, m]``, fed back into the next window's
    ``PoolArrays`` latency tables (``lat_scale``) and into ``evaluate``'s
    committed replay (``latency_scale``), so the scheduler's estimates
    track reality:

        s <- (1 - beta) * s + beta * (realized / committed)
        l_hat(w, m, b) = s[w, m] * l(m, b) / speed_w

  * a per-worker **health state machine** — healthy -> degraded ->
    quarantined — driven by consecutive failure counts (crash /
    transient / timeout, from the supervised executor pool) and by a
    per-worker EWMA of the same latency ratio (a straggler whose realized
    time blows past its committed estimate is quarantined even though it
    never "fails").  Quarantined workers are masked out of scheduling
    (``active``/``active_wids`` feed the ``worker_mask`` of
    ``fast_multiworker_schedule``) for
    ``cooldown_windows`` window closes, then released into the degraded
    state with a fresh ratio EWMA — a re-probe: if the fault persists the
    next observation re-quarantines immediately, otherwise the worker
    earns its way back to healthy.

Scales are clamped to [min_scale, max_scale] and quantized to ``quantum``
so the scale signature (which the overlapped loop compares, and the
reference's compiled pipeline keys its table cache on) stabilizes once
the EWMA converges.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

__all__ = ["HealthConfig", "WorkerHealth", "HealthTracker",
           "HEALTHY", "DEGRADED", "QUARANTINED"]

HEALTHY = "healthy"
DEGRADED = "degraded"
QUARANTINED = "quarantined"


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Thresholds of the health state machine and the drift EWMA.

    ``degrade_after``/``quarantine_after`` are CONSECUTIVE failure counts
    (any success resets the streak); ``straggler_ratio`` quarantines a
    worker whose per-worker realized/committed EWMA exceeds it;
    ``cooldown_windows`` is how many window closes a quarantined worker
    sits out before the re-probe release.
    """

    degrade_after: int = 1
    quarantine_after: int = 3
    straggler_ratio: float = 3.0
    cooldown_windows: int = 2
    ewma_beta: float = 0.3
    min_scale: float = 0.25
    max_scale: float = 8.0
    quantum: float = 1e-3


@dataclasses.dataclass
class WorkerHealth:
    """Mutable health record of one worker lane."""

    state: str = HEALTHY
    consecutive_failures: int = 0
    total_failures: int = 0
    ratio_ewma: float | None = None  # per-worker realized/committed EWMA
    cooldown_left: int = 0
    quarantines: int = 0


class HealthTracker:
    """healthy -> degraded -> quarantined state machine + drift EWMAs.

    One instance per server; the serving loop calls ``observe`` /
    ``record_failure`` as execution outcomes arrive, ``close_window``
    once per window close (cooldown clock), and reads ``active_wids`` /
    ``latency_scale`` when scheduling the next window.
    """

    def __init__(self, wids: Sequence[int], config: HealthConfig | None = None,
                 **overrides):
        """``wids`` are the pool's worker ids; thresholds come from
        ``config`` (or a default ``HealthConfig``, with keyword
        overrides: ``HealthTracker([0, 1], straggler_ratio=5.0)``)."""
        base = config if config is not None else HealthConfig()
        self.config = dataclasses.replace(base, **overrides) if overrides else base
        self._health: dict[int, WorkerHealth] = {int(w): WorkerHealth() for w in wids}
        self._pair_ewma: dict[tuple[int, str], float] = {}

    def _get(self, wid: int) -> WorkerHealth:
        h = self._health.get(wid)
        if h is None:
            h = WorkerHealth()
            self._health[wid] = h
        return h

    # -- inputs ----------------------------------------------------------
    def observe(self, wid: int, model: str, realized_s: float,
                committed_s: float) -> None:
        """Fold one successful batch execution into the drift EWMAs.

        ``realized_s`` is the report's total seconds, ``committed_s`` the
        latency the scheduler committed the batch with (est_latency_s).
        Zero-latency commitments (short-circuit variants) carry no drift
        signal and are skipped.  A success resets the worker's
        consecutive-failure streak; a realized/committed EWMA above
        ``straggler_ratio`` quarantines the worker (the straggler path —
        no failure ever fires, the lane is just far slower than profiled).
        """
        if committed_s <= 0.0 or realized_s < 0.0:
            return
        cfg = self.config
        ratio = realized_s / committed_s
        key = (int(wid), model)
        prev = self._pair_ewma.get(key)
        self._pair_ewma[key] = (
            ratio if prev is None
            else (1.0 - cfg.ewma_beta) * prev + cfg.ewma_beta * ratio
        )
        h = self._get(int(wid))
        h.consecutive_failures = 0
        h.ratio_ewma = (
            ratio if h.ratio_ewma is None
            else (1.0 - cfg.ewma_beta) * h.ratio_ewma + cfg.ewma_beta * ratio
        )
        if h.state != QUARANTINED and h.ratio_ewma > cfg.straggler_ratio:
            self._quarantine(h)
        elif h.state == DEGRADED and h.ratio_ewma <= cfg.straggler_ratio:
            h.state = HEALTHY

    def record_failure(self, wid: int, kind: str = "error") -> None:
        """Fold one batch/lane failure (crash, transient, swap failure,
        lane timeout) into the failure streak; crossing ``degrade_after``
        degrades the worker, ``quarantine_after`` quarantines it."""
        h = self._get(int(wid))
        h.consecutive_failures += 1
        h.total_failures += 1
        cfg = self.config
        if h.consecutive_failures >= cfg.quarantine_after or kind == "crash":
            # A crash is terminal for the lane this window: quarantine
            # immediately rather than waiting out the streak.
            self._quarantine(h)
        elif h.state == HEALTHY and h.consecutive_failures >= cfg.degrade_after:
            h.state = DEGRADED

    def _quarantine(self, h: WorkerHealth) -> None:
        if h.state != QUARANTINED:
            h.quarantines += 1
        h.state = QUARANTINED
        h.cooldown_left = self.config.cooldown_windows

    def close_window(self) -> list[int]:
        """Tick the cooldown clock (call once per window close).

        Quarantined workers count down; at zero they are RELEASED into
        the degraded state with a reset failure streak and a fresh
        per-worker ratio EWMA — the re-probe: the next observation either
        re-quarantines (fault persists) or starts earning the worker back
        to healthy.  Returns the released worker ids (ascending)."""
        released = []
        for wid, h in sorted(self._health.items()):
            if h.state != QUARANTINED:
                continue
            h.cooldown_left -= 1
            if h.cooldown_left <= 0:
                h.state = DEGRADED
                h.consecutive_failures = 0
                h.ratio_ewma = None
                released.append(wid)
        return released

    # -- scheduler-facing views ------------------------------------------
    def state_of(self, wid: int) -> str:
        """Current health state of worker ``wid`` (unknown ids: healthy)."""
        h = self._health.get(int(wid))
        return h.state if h is not None else HEALTHY

    def quarantined(self) -> list[int]:
        """Currently quarantined worker ids, ascending."""
        return [w for w, h in sorted(self._health.items()) if h.state == QUARANTINED]

    def active(self, workers: Sequence) -> list:
        """The schedulable subset of ``workers`` (quarantined masked out).

        Never empty: if EVERY worker is quarantined the full pool is
        returned — serving degrades to best-effort rather than halting
        (the cooldown re-probe will sort the lanes out)."""
        act = [w for w in workers if self.state_of(w.wid) != QUARANTINED]
        return act if act else list(workers)

    def active_wids(self, workers: Sequence) -> set[int] | None:
        """The ``worker_mask`` for scheduling: a wid set when any worker
        is quarantined, ``None`` when the whole pool is schedulable (the
        hot path then skips masking entirely — bit-identical arrays)."""
        act = self.active(workers)
        if len(act) == len(workers):
            return None
        return {w.wid for w in act}

    def latency_scale(self) -> dict[tuple[int, str], float] | None:
        """Quantized drift scales for the scheduler's latency tables:
        ``{(wid, model): s}`` with s clamped to [min_scale, max_scale]
        and rounded to ``quantum`` (bounding the churn of the scale
        signature); entries that quantize to exactly 1.0 are dropped and
        ``None`` is returned when nothing deviates (the bit-identical
        fast path)."""
        cfg = self.config
        out = {}
        for key, s in self._pair_ewma.items():
            s = min(cfg.max_scale, max(cfg.min_scale, s))
            s = round(s / cfg.quantum) * cfg.quantum
            if s != 1.0:
                out[key] = s
        return out or None

    def scale_fn(self):
        """Callable ``(wid, model) -> scale`` over the SAME quantized
        values ``latency_scale`` exposes, for ``evaluate``'s committed
        replay — scheduler estimates and commitments drift-correct
        identically.  ``None`` when nothing deviates."""
        scales = self.latency_scale()
        if scales is None:
            return None
        return lambda wid, model: scales.get((int(wid), model), 1.0)

    def control_signature(self, workers: Sequence) -> tuple:
        """Equality token over everything this tracker feeds BACK into
        scheduling: the quarantine mask and the quantized drift scales.
        The overlapped serving loop snapshots it before speculating a
        window and compares after the previous window's outcome lands —
        any change (new quarantine, cooldown release, EWMA movement past
        a quantum) invalidates the speculative schedule."""
        scales = self.latency_scale()
        mask = self.active_wids(workers) if workers else None
        return (
            None if mask is None else frozenset(mask),
            None if scales is None else tuple(sorted(scales.items())),
        )

    def ratio_snapshot(self) -> dict[int, float]:
        """Per-worker realized/committed EWMA (1.0 before any signal) —
        the ``realized_over_profiled`` surface in ``ServeStats``."""
        return {
            w: (h.ratio_ewma if h.ratio_ewma is not None else 1.0)
            for w, h in sorted(self._health.items())
        }
