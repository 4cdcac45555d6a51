"""Multi-worker scheduling (paper §VII, Eq. 15).

The port of ``repro.core.multiworker``.  The schedule gains a worker
index k; each variant is profiled per worker (heterogeneous workers =>
per-(model, worker) latency scaling).  The grouped policy generalizes
greedily: groups in priority order, each placed on the (worker, model)
pair maximizing the group's average utility given that worker's current
timeline, which balances load because a busy worker's later start times
depress utility.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

from repro_torch.core.accuracy import ModelProfile
from repro_torch.core.evaluation import WorkerTimeline, estimate_accuracy
from repro_torch.core.grouping import group_by_app, split_groups_by_label
from repro_torch.core.priority import group_priority, request_priority
from repro_torch.core.types import Application, Request, Schedule, ScheduleEntry
from repro_torch.core.utility import utility as eq2_utility

__all__ = ["Worker", "multiworker_schedule"]


@dataclasses.dataclass(frozen=True)
class Worker:
    """A worker with a relative speed (latency scale) — heterogeneous pools.

    ``speed=2.0`` halves every inference latency on that worker; swap
    latency scales with ``load_scale`` (e.g. shared host-to-device links).
    """

    wid: int
    speed: float = 1.0
    load_scale: float = 1.0

    def scaled(self, profile: ModelProfile) -> ModelProfile:
        """This worker's view of a profile: latency / speed, swap * load_scale."""
        if self.speed == 1.0 and self.load_scale == 1.0:
            return profile
        lm = profile.latency_model
        return dataclasses.replace(
            profile,
            latency_s=profile.latency_s / self.speed,
            load_latency_s=profile.load_latency_s * self.load_scale,
            latency_model=None if lm is None else (lm[0] / self.speed, lm[1] / self.speed),
        )


def multiworker_schedule(
    requests: Sequence[Request],
    apps: Mapping[str, Application],
    workers: Sequence[Worker],
    now: float,
    data_aware: bool = False,
    split_by_label: bool = False,
    per_request: bool = False,
    fastpath: bool = True,
    state=None,
    arrays=None,
    lat_scale=None,
    worker_mask=None,
    device=None,
) -> Schedule:
    """Greedy grouped scheduling over heterogeneous workers (Eq. 15).

    ``per_request=True`` degrades grouping to singletons — the
    locally-optimal multi-worker baseline of Fig. 15.

    ``worker_mask`` (a wid set) restricts placement to the named workers
    on both paths; ``lat_scale`` ({(wid, model): s} drift corrections)
    multiplies the fast path's latency tables and is rejected on the
    scalar reference (which has no table to correct).

    ``fastpath`` (default) delegates to
    ``fastpath.fast_multiworker_schedule``, which scores every (worker,
    model) candidate of a placement step as one Eq. 2 tile through the
    kernel on ``device`` (the card unless ``"cpu"`` is named); pass False
    for this scalar host loop (identical decisions).  ``state``
    (streaming.StreamingState) seeds per-worker backlog and residency;
    ``arrays`` is an optional precomputed ``fastpath.WindowArrays`` (fast
    path only).
    """
    if not requests:
        return Schedule()
    if not workers:
        raise ValueError("multiworker_schedule requires at least one worker")
    if fastpath:
        from repro_torch.core.fastpath import fast_multiworker_schedule

        return fast_multiworker_schedule(
            requests,
            apps,
            workers,
            now,
            data_aware=data_aware,
            split_by_label=split_by_label,
            per_request=per_request,
            arrays=arrays,
            state=state,
            lat_scale=lat_scale,
            worker_mask=worker_mask,
            device=device,
        )
    if lat_scale:
        raise ValueError("lat_scale drift correction requires the fastpath")
    if worker_mask is not None:
        workers = [w for w in workers if w.wid in worker_mask]
        if not workers:
            raise ValueError("worker_mask excludes every worker")
    acc_mode = "sharpened" if data_aware else "profiled"
    if per_request:
        groups = {f"r{r.rid}": [r] for r in requests}
    else:
        groups = group_by_app(requests)
        if split_by_label:
            groups = split_groups_by_label(groups, apps)

    def _gp(item):
        key, members = item
        return (-group_priority(members, apps[members[0].app], now, data_aware), key)

    ordered_groups = sorted(groups.items(), key=_gp)
    timelines: dict[int, WorkerTimeline] = {}
    for w in workers:
        if state is not None:
            tl = state.peek_timeline(w.wid).clone()
            tl.advance(now)
        else:
            tl = WorkerTimeline(now)
        timelines[w.wid] = tl
    orders = {w.wid: 1 for w in workers}
    entries: list[ScheduleEntry] = []

    for batch_id, (key, members) in enumerate(ordered_groups):
        app = apps[members[0].app]
        # Candidate key: (utility, -scaled single-request latency, model
        # name, -worker id): utility ties prefer the lower-latency
        # placement, then the larger model name, then the lower worker id.
        best = None  # (key, worker, scaled_profile)
        for w in workers:
            tl = timelines[w.wid]
            for m in app.models:
                sm = w.scaled(m)
                start, completion = tl.peek_batch(sm, len(members))
                lat = completion - start
                total = 0.0
                for r in members:
                    acc = estimate_accuracy(r, app, m, acc_mode)
                    total += eq2_utility(acc, r.deadline_s, start, lat, app.penalty_fn)
                u = total / len(members)
                cand = (u, -sm.latency_s, m.name, -w.wid)
                if best is None or cand > best[0]:
                    best = (cand, w, sm)
        _, w, sm = best
        tl = timelines[w.wid]
        start, completion = tl.run_batch(sm, len(members))
        ordered_members = sorted(
            members, key=lambda r: (-request_priority(r, app, now, data_aware), r.rid)
        )
        for r in ordered_members:
            entries.append(
                ScheduleEntry(
                    request=r,
                    model=sm.name,
                    order=orders[w.wid],
                    worker=w.wid,
                    batch_id=batch_id,
                    est_start_s=start,
                    est_latency_s=completion - start,
                )
            )
            orders[w.wid] += 1
    sched = Schedule(entries=entries)
    sched.validate()
    return sched
