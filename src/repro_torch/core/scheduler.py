"""Policy composition: the five evaluated schedulers (paper §VI-A).

  * MaxAcc-EDF   — max-accuracy selection + EDF ordering.
  * LO-EDF       — locally-optimal (Eq. 13) selection + EDF ordering.
  * LO-Priority  — locally-optimal selection + priority (Eq. 12) ordering.
  * Grouped      — Algorithm 1 (group by app, batch, group-level Eq. 13).
  * SneakPeek    — Grouped + data-awareness (sharpened accuracies,
                   label-split subgroups) + short-circuit inference.

Every policy returns a ``Schedule``; data-awareness is orthogonal and can
be layered on any of them (``data_aware=True``) exactly as the paper's
Fig. 7 incremental study requires.

The port of ``repro.core.scheduler``, with the §VII multi-worker
placement (``schedule_window(workers=...)``, Eq. 15) and the compiled
window pipeline (``pipeline=True``, ``core.pipeline``) with its
speculative chunked selection (``chunk`` > 0) and its sharded form
(``shard``, ``core.shard``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Mapping, Sequence

from repro_torch.core.evaluation import WorkerTimeline
from repro_torch.core.grouping import grouped_schedule
from repro_torch.core.ordering import ORDERINGS
from repro_torch.core.selection import locally_optimal, max_accuracy
from repro_torch.core.types import Application, Request, Schedule, ScheduleEntry

__all__ = [
    "SchedulerPolicy",
    "make_policy",
    "POLICY_NAMES",
    "schedule_window",
    "effective_apps",
]


@dataclasses.dataclass(frozen=True)
class SchedulerPolicy:
    """A (ordering, selection, grouping, data-awareness) combination."""

    name: str
    ordering: str = "edf"  # fcfs | edf | priority
    selection: str = "locally_optimal"  # locally_optimal | max_accuracy
    grouped: bool = False
    data_aware: bool = False
    split_by_label: bool = False
    tau: int = 3  # brute-force threshold for grouped scheduling
    # Vectorized window scheduling (``fastpath``, batched math on the
    # device).  False runs the scalar host loops
    # (``make_policy(name, fastpath=False)``).
    fastpath: bool = True
    # The compiled window pipeline (``core.pipeline``): the Eq. 2/13
    # selection of a window as one ``selection_scan`` launch
    # (``make_policy(name, pipeline=True)``).  Off by default.
    pipeline: bool = False
    # Speculative chunked selection (pipeline only): > 0 replaces the
    # sequential scan with speculate-K/validate/fallback rounds of K
    # decisions (``make_policy(name, pipeline=True, chunk=16)``), one
    # ``spec_scan`` launch per window; decisions stay bit-identical.  0
    # keeps the sequential scan.
    chunk: int = 0
    # Sharded window scheduling (``core.shard``): True splits the tiles
    # across every device of the scheduling device's kind, an int pins the
    # shard count (``make_policy(name, shard=True)``).  Implies the
    # pipeline route; decisions stay bit-identical to the unsharded scan
    # (one shard delegates to the plain pipeline verbatim).
    shard: bool | int = False

    def schedule(
        self,
        requests: Sequence[Request],
        apps: Mapping[str, Application],
        now: float,
        state=None,
        arrays=None,
        *,
        device=None,
    ) -> Schedule:
        """One window pass.  ``state`` (streaming.StreamingState) seeds the
        worker timeline with carried backlog + residency (peeked via a
        clone, never committed); ``arrays`` is an optional precomputed
        ``fastpath.WindowArrays``; ``device`` is where the fast path's
        batched math runs (``device.resolve_device``).  With
        ``pipeline=True`` or ``shard`` the window goes through
        ``pipeline.pipeline_schedule``."""
        t0 = time.perf_counter()
        if self.pipeline or self.shard:
            from repro_torch.core.pipeline import pipeline_schedule

            sched = pipeline_schedule(
                self, requests, apps, now, state=state, arrays=arrays, device=device
            )
        elif self.grouped:
            sched = grouped_schedule(
                requests,
                apps,
                now,
                tau=self.tau,
                data_aware=self.data_aware,
                split_by_label=self.split_by_label,
                use_fastpath=self.fastpath,
                arrays=arrays,
                state=state,
                device=device,
            )
        elif self.fastpath:
            from repro_torch.core.fastpath import fast_per_request_schedule

            sched = fast_per_request_schedule(
                requests,
                apps,
                now,
                ordering=self.ordering,
                selection=self.selection,
                data_aware=self.data_aware,
                arrays=arrays,
                state=state,
                device=device,
            )
        else:
            sched = self._per_request_schedule(requests, apps, now, state=state)
        sched.scheduling_overhead_s = time.perf_counter() - t0
        return sched

    def _per_request_schedule(
        self,
        requests: Sequence[Request],
        apps: Mapping[str, Application],
        now: float,
        state=None,
    ) -> Schedule:
        """Scalar reference path: O(R * M) per-pair estimate/utility calls."""
        acc_mode = "sharpened" if self.data_aware else "profiled"
        order_fn = ORDERINGS[self.ordering]
        select_fn = {
            "locally_optimal": locally_optimal,
            "max_accuracy": max_accuracy,
        }[self.selection]
        ordered = order_fn(requests, apps, now, data_aware=self.data_aware)
        if state is not None:
            tl = state.peek_timeline(0).clone()
            tl.advance(now)
        else:
            tl = WorkerTimeline(now)
        entries = []
        for k, r in enumerate(ordered):
            app = apps[r.app]
            profile = select_fn(r, app, tl, acc_mode=acc_mode)
            start, completion = tl.run_batch(profile, 1)
            entries.append(
                ScheduleEntry(
                    request=r,
                    model=profile.name,
                    order=k + 1,
                    batch_id=-1,
                    est_start_s=start,
                    est_latency_s=completion - start,
                )
            )
        sched = Schedule(entries=entries)
        sched.validate()
        return sched


_POLICIES: dict[str, SchedulerPolicy] = {
    "MaxAcc-EDF": SchedulerPolicy("MaxAcc-EDF", ordering="edf", selection="max_accuracy"),
    "LO-EDF": SchedulerPolicy("LO-EDF", ordering="edf", selection="locally_optimal"),
    "LO-Priority": SchedulerPolicy(
        "LO-Priority", ordering="priority", selection="locally_optimal"
    ),
    "Grouped": SchedulerPolicy("Grouped", grouped=True),
    "SneakPeek": SchedulerPolicy(
        "SneakPeek", grouped=True, data_aware=True, split_by_label=True
    ),
}
POLICY_NAMES = list(_POLICIES)

def make_policy(name: str, **overrides) -> SchedulerPolicy:
    """Look up one of the paper's five policies, optionally overridden
    (e.g. ``make_policy("LO-EDF", data_aware=True)`` for Fig. 7)."""
    base = _POLICIES[name]
    if not overrides:
        return base
    return dataclasses.replace(base, **overrides)


def effective_apps(
    apps: Mapping[str, Application],
    sneakpeeks=None,
    short_circuit: bool = False,
) -> Mapping[str, Application]:
    """The application map the policy actually schedules against.

    With ``short_circuit`` the SneakPeek profiles are appended to each
    application's variant list (zero latency, profiled accuracy) so the
    policy can choose them like any other model (§V-C1).  Deterministic in
    its inputs — streaming callers compute it ONCE and reuse it across
    windows (rebuilding per window would also defeat the fast path's
    per-Application ``AppArrays`` memoization).
    """
    if not (short_circuit and sneakpeeks):
        return apps
    out = {}
    for name, app in apps.items():
        sp = sneakpeeks.get(name)
        if sp is None:
            out[name] = app
            continue
        prof = sp.profile()
        if any(m.name == prof.name for m in app.models):
            out[name] = app
        else:
            out[name] = dataclasses.replace(app, models=app.models + [prof])
    return out


def schedule_window(
    policy: SchedulerPolicy,
    requests: Sequence[Request],
    apps: Mapping[str, Application],
    now: float,
    sneakpeeks=None,
    short_circuit: bool = False,
    workers=None,
    state=None,
    arrays=None,
    lat_scale=None,
    worker_mask=None,
    *,
    device=None,
) -> tuple[Schedule, Mapping[str, Application]]:
    """One scheduling-window pass: SneakPeek stage (if any) then the policy.

    ``workers`` (a sequence of ``multiworker.Worker``) generalizes any
    policy to the paper's §VII multi-worker placement: grouping,
    data-awareness, label-splitting and fastpath come from the policy,
    placement from ``multiworker_schedule`` (``per_request`` for the
    ungrouped policies), or from the compiled placement program
    (``core.pipeline``) when the policy has ``pipeline=True`` or ``shard``.  ``state``
    carries streaming backlog + residency; ``arrays`` is a precomputed ``fastpath.WindowArrays``;
    ``device`` is where the k-NN search and the batched equations run
    (the card unless ``"cpu"`` is named).  ``lat_scale`` ({(wid, model):
    scale} drift corrections) and ``worker_mask`` (a wid set) apply to the
    multi-worker path only.  Returns the schedule and the (possibly
    short-circuit-augmented) application map.
    """
    from repro_torch.core.sneakpeek import attach_sneakpeek
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    if sneakpeeks:
        attach_sneakpeek(requests, apps, sneakpeeks, device=dev)
    eff_apps = effective_apps(apps, sneakpeeks, short_circuit)
    if workers:
        if policy.pipeline or policy.shard:
            from repro_torch.core.pipeline import pipeline_schedule

            sched = pipeline_schedule(
                policy, requests, eff_apps, now, state=state, arrays=arrays,
                workers=workers, lat_scale=lat_scale, worker_mask=worker_mask,
                device=dev,
            )
            return sched, eff_apps
        from repro_torch.core.multiworker import multiworker_schedule

        t0 = time.perf_counter()
        sched = multiworker_schedule(
            requests,
            eff_apps,
            workers,
            now,
            data_aware=policy.data_aware,
            split_by_label=policy.split_by_label,
            per_request=not policy.grouped,
            fastpath=policy.fastpath,
            state=state,
            arrays=arrays,
            lat_scale=lat_scale,
            worker_mask=worker_mask,
            device=dev,
        )
        sched.scheduling_overhead_s = time.perf_counter() - t0
        return sched, eff_apps
    if lat_scale or worker_mask is not None:
        raise ValueError("lat_scale/worker_mask require a multi-worker pool")
    sched = policy.schedule(requests, eff_apps, now, state=state, arrays=arrays, device=dev)
    return sched, eff_apps
