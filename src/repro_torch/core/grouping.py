"""Grouped scheduling (paper Algorithm 1) and data-aware group splitting (§V-C2).

Requests are partitioned by application (same candidate model set), the
groups ordered by mean priority (Eq. 14), one variant selected per group
by group-level Eq. 13, and all members dispatched as one batched
inference — exploiting model locality and avoiding swap latency.

When the number of groups is at most ``tau`` the group-level problem is
brute-forced exactly.

Data-aware splitting: with SneakPeek posteriors attached, a group is
split into per-predicted-label subgroups when posteriors disagree —
theta_i > 0.5 assigns a request to label-i's subgroup; inconclusive
posteriors (all theta_i <= 0.5) stay in the residual subgroup (Fig. 4).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core.bruteforce import brute_force_groups
from repro_torch.core.evaluation import WorkerTimeline
from repro_torch.core.priority import group_priority, request_priority
from repro_torch.core.selection import group_locally_optimal
from repro_torch.core.types import Application, Request, Schedule, ScheduleEntry

__all__ = ["group_by_app", "split_groups_by_label", "grouped_schedule"]


def group_by_app(requests: Sequence[Request]) -> dict[str, list[Request]]:
    """Partition G: r1, r2 in same group iff same application (model set)."""
    groups: dict[str, list[Request]] = defaultdict(list)
    for r in requests:
        groups[r.app].append(r)
    return dict(groups)


def split_groups_by_label(
    groups: Mapping[str, list[Request]],
    apps: Mapping[str, Application],
    threshold: float = 0.5,
) -> dict[str, list[Request]]:
    """§V-C2: split each app group into per-predicted-label subgroups.

    Subgroup keys are ``f"{app}#label{i}"`` / ``f"{app}#mixed"``; members
    keep identical model sets so each subgroup is still a valid group.
    Requests without a posterior join the residual subgroup.  Groups whose
    members all agree are left unsplit (single key), matching Fig. 4.
    """
    out: dict[str, list[Request]] = {}
    for app_name, members in groups.items():
        buckets: dict[str, list[Request]] = defaultdict(list)
        for r in members:
            if r.theta is None:
                buckets["mixed"].append(r)
                continue
            top = int(np.argmax(r.theta))
            if r.theta[top] > threshold:
                buckets[f"label{top}"].append(r)
            else:
                buckets["mixed"].append(r)
        if len(buckets) == 1:
            out[app_name] = members  # no disagreement -> no split
        else:
            for key, sub in buckets.items():
                out[f"{app_name}#{key}"] = sub
    return out


def grouped_schedule(
    requests: Sequence[Request],
    apps: Mapping[str, Application],
    now: float,
    tau: int = 3,
    data_aware: bool = False,
    split_by_label: bool = False,
    acc_mode: str | None = None,
    use_fastpath: bool = True,
    arrays=None,
    state=None,
    device=None,
) -> Schedule:
    """Algorithm 1 (+ optional §V-C2 splitting when ``split_by_label``).

    ``data_aware`` switches both the priority variance term and the
    group-level utility to SneakPeek-sharpened accuracies.

    ``use_fastpath`` (default) delegates to the vectorized implementation
    in ``fastpath``, which consumes one ``WindowArrays`` precompute
    instead of O(R * M) scalar accuracy/penalty calls; pass False for the
    scalar host path (same schedules).

    ``state`` (streaming.StreamingState) seeds the worker timeline with
    carried backlog and model residency (scheduling peeks a clone; only
    ``evaluate(..., state=...)`` commits).  ``arrays`` optionally supplies
    a precomputed ``fastpath.WindowArrays`` and ``device`` where the fast
    path's batched math runs (fast path only).
    """
    if use_fastpath:
        from repro_torch.core.fastpath import fast_grouped_schedule

        return fast_grouped_schedule(
            requests,
            apps,
            now,
            tau=tau,
            data_aware=data_aware,
            split_by_label=split_by_label,
            acc_mode=acc_mode,
            arrays=arrays,
            state=state,
            device=device,
        )
    if not requests:
        return Schedule()
    if acc_mode is None:
        acc_mode = "sharpened" if data_aware else "profiled"

    groups = group_by_app(requests)
    if split_by_label:
        groups = split_groups_by_label(groups, apps)

    if state is not None:
        tl = state.peek_timeline(0).clone()
        tl.advance(now)
    else:
        tl = WorkerTimeline(now)

    if len(groups) <= tau:
        try:
            return brute_force_groups(groups, apps, now, acc_mode=acc_mode, timeline=tl)
        except ValueError:
            pass  # too many (group-ordering x model) candidates; fall through

    # Eq. 14 once per group — sort keys must not recompute the O(|g|)
    # priority mean on every comparison (and again in the adjacency
    # re-sort below).
    gp = {
        key: group_priority(members, apps[members[0].app], now, data_aware)
        for key, members in groups.items()
    }

    ordered_groups = sorted(groups.items(), key=lambda item: (-gp[item[0]], item[0]))
    # Beyond-paper refinement: keep same-application subgroups ADJACENT
    # (apps ordered by their best subgroup's priority), so label-split
    # subgroups do not alternate across apps and re-pay the model swap.
    if split_by_label and len(ordered_groups) > 1:
        app_rank: dict[str, int] = {}
        for key, members in ordered_groups:
            app_rank.setdefault(members[0].app, len(app_rank))
        ordered_groups.sort(
            key=lambda item: (app_rank[item[1][0].app], -gp[item[0]])
        )

    entries: list[ScheduleEntry] = []
    order = 1
    for batch_id, (key, members) in enumerate(ordered_groups):
        app = apps[members[0].app]
        profile = group_locally_optimal(members, app, tl, acc_mode=acc_mode)
        start, completion = tl.run_batch(profile, len(members))
        ordered_members = sorted(
            members,
            key=lambda r: (-request_priority(r, app, now, data_aware), r.rid),
        )
        for r in ordered_members:
            entries.append(
                ScheduleEntry(
                    request=r,
                    model=profile.name,
                    order=order,
                    batch_id=batch_id,
                    est_start_s=start,
                    est_latency_s=completion - start,
                )
            )
            order += 1
    sched = Schedule(entries=entries)
    sched.validate()
    return sched
