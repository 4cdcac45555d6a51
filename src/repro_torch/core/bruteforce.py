"""Exact (brute-force) solvers for the scheduling problem (paper Eq. 3-6).

Two granularities:

  * ``brute_force_requests`` — the original problem: all request
    permutations x per-request model choices.  n! * prod|M_a| candidates;
    only for tiny n (used by tests to bound the heuristics).
  * ``brute_force_groups`` — Alg. 1's exact path: all *group* permutations
    x one model per group.  |A|! * prod|M_a| candidates; viable because
    |A| << |R| (the paper's tau threshold).
"""
from __future__ import annotations

import itertools
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core.evaluation import WorkerTimeline, estimate_accuracy
from repro_torch.core.types import Application, Request, Schedule, ScheduleEntry
from repro_torch.core.utility import utility as eq2_utility

__all__ = ["brute_force_requests", "brute_force_groups"]


def _score_plan(
    plan: Sequence[tuple[Request, str, int]],
    apps: Mapping[str, Application],
    now: float,
    acc_mode: str,
    arrays=None,
    timeline: WorkerTimeline | None = None,
) -> float:
    """Mean estimated utility of an ordered (request, model, batch_id) plan.

    ``arrays`` (a ``fastpath.WindowArrays``) replaces the per-plan accuracy
    recomputation with the window's memoized, bit-exact estimates: the
    solver enumerates |A|! * prod|M_a| candidate plans but only R * M
    distinct (request, model) accuracies exist.  Timing and accumulation
    stay scalar so candidate ranking is unchanged down to the last bit.

    ``timeline`` seeds each candidate replay with carried streaming state
    (backlog + residency); every plan scores from a fresh clone.
    """
    tl = timeline.clone() if timeline is not None else WorkerTimeline(now)
    total = 0.0
    i = 0
    n = len(plan)
    while i < n:
        j = i
        # batch contiguous same-(model, batch_id>=0) runs
        while (
            j + 1 < n
            and plan[j + 1][1] == plan[i][1]
            and plan[j + 1][2] == plan[i][2]
            and plan[i][2] >= 0
        ):
            j += 1
        members = plan[i : j + 1]
        app = apps[members[0][0].app]
        profile = app.model(members[0][1])
        start, completion = tl.run_batch(profile, len(members))
        lat = completion - start
        for r, _, _ in members:
            if arrays is not None:
                acc = arrays.exact_accuracy(r, profile, acc_mode)
            else:
                acc = estimate_accuracy(r, app, profile, acc_mode)
            total += eq2_utility(acc, r.deadline_s, start, lat, app.penalty_fn)
        i = j + 1
    return total / max(1, n)


def _plan_to_schedule(plan: Sequence[tuple[Request, str, int]]) -> Schedule:
    entries = [
        ScheduleEntry(request=r, model=m, order=k + 1, batch_id=b)
        for k, (r, m, b) in enumerate(plan)
    ]
    return Schedule(entries=entries)


def brute_force_requests(
    requests: Sequence[Request],
    apps: Mapping[str, Application],
    now: float,
    acc_mode: str = "profiled",
    max_candidates: int = 2_000_000,
    arrays=None,
    timeline: WorkerTimeline | None = None,
) -> Schedule:
    """Exact solution of Eq. 3 at request granularity.

    Raises ValueError when the candidate count exceeds ``max_candidates``
    (the caller should fall back to a heuristic).  ``arrays`` is an
    optional ``fastpath.WindowArrays`` accuracy memo (see ``_score_plan``).
    """
    n = len(requests)
    model_sets = [apps[r.app].models for r in requests]
    count = 1.0
    for k in range(1, n + 1):
        count *= k
    for ms in model_sets:
        count *= len(ms)
    if count > max_candidates:
        raise ValueError(f"{count:.3g} candidates exceed max_candidates={max_candidates}")

    best_plan, best_u = None, -np.inf
    idx = list(range(n))
    for perm in itertools.permutations(idx):
        ordered = [requests[i] for i in perm]
        for choice in itertools.product(*[ [m.name for m in apps[r.app].models] for r in ordered ]):
            plan = [(r, m, -1) for r, m in zip(ordered, choice)]
            u = _score_plan(plan, apps, now, acc_mode, arrays=arrays, timeline=timeline)
            if u > best_u:
                best_u, best_plan = u, plan
    sched = _plan_to_schedule(best_plan)
    sched.validate()
    return sched


def brute_force_groups(
    groups: Mapping[str, list[Request]],
    apps: Mapping[str, Application],
    now: float,
    acc_mode: str = "profiled",
    max_candidates: int = 500_000,
    arrays=None,
    timeline: WorkerTimeline | None = None,
) -> Schedule:
    """Exact group-level solution (Alg. 1 fast path).

    Enumerates group orderings x one variant per group; members within a
    group run as one batch, ordered by deadline (earliest first) for the
    per-request utility accounting.  ``arrays`` is an optional
    ``fastpath.WindowArrays`` accuracy memo (see ``_score_plan``).
    """
    keys = sorted(groups.keys())
    count = 1.0
    for k in range(1, len(keys) + 1):
        count *= k
    for key in keys:
        app_name = groups[key][0].app
        count *= len(apps[app_name].models)
    if count > max_candidates:
        raise ValueError(f"{count:.3g} candidates exceed max_candidates={max_candidates}")

    best_plan, best_u = None, -np.inf
    for perm in itertools.permutations(keys):
        model_options = [
            [m.name for m in apps[groups[k][0].app].models] for k in perm
        ]
        for choice in itertools.product(*model_options):
            plan: list[tuple[Request, str, int]] = []
            for b, (k, m) in enumerate(zip(perm, choice)):
                members = sorted(groups[k], key=lambda r: (r.deadline_s, r.rid))
                plan.extend((r, m, b) for r in members)
            u = _score_plan(plan, apps, now, acc_mode, arrays=arrays, timeline=timeline)
            if u > best_u:
                best_u, best_plan = u, plan
    sched = _plan_to_schedule(best_plan)
    sched.validate()
    return sched
