"""Vectorized scheduling fast path: the paper's equations as tensor programs.

The port of ``repro.core.fastpath`` (single worker).  A ``WindowArrays``
bundle is built once per window; the batched equations run as torch
tensors on the window's device, and the decisions are taken on the host
from what they return:

  * Eq. 9  — sharpened accuracies for ALL (request, model) pairs of an
             application as one float64 product ``Theta @ R.T``.
  * Eq. 12 — priorities: row variance of the accuracy matrix (summed in
             numpy's order, ``ordered.row_var``) times ``exp(-d)``.
  * Eq. 2/13 — group utilities through the Eq. 2 kernel
             (``repro_torch.kernels.utility``), whose column sums follow
             the scalar member order; ``score_entries`` scores a whole
             schedule through the same kernel.
  * Eq. 14 — group priorities as host numpy means, in the reference's form.
  * Eq. 15 — multi-worker placement (``fast_multiworker_schedule``): each
             placement step scores every (worker, model) candidate of a
             group as one (B, W*M) tile through the kernel, whose column
             means give the (W, M) member means; the pool's state is
             arrays (``PoolArrays``).

  * ``precompute_windows`` — several windows' Eq. 9/12 matrices stacked
             into ONE float64 program per application on the device,
             row-identical to the lazy per-window compute.

  * ``chunk_layout`` — the chunk-boundary encoding of the pipeline's
             speculative chunked selection (``core.pipeline``).

Decisions equal the reference's decision for decision.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.accuracy import ModelProfile
from repro_torch.core.ordered import row_var, sequential_mean
from repro_torch.core.types import Application, Request, Schedule, ScheduleEntry
from repro_torch.device import SCHED_DTYPE, resolve_device
from repro_torch.kernels.utility.ops import utility_scores

__all__ = [
    "AppArrays",
    "WindowArrays",
    "chunk_layout",
    "sequential_mean",
    "utility_matrix",
    "ordered_group_items",
    "fast_per_request_schedule",
    "fast_grouped_schedule",
    "score_entries",
    "placement_pref",
    "PoolArrays",
    "placement_means",
    "fast_multiworker_schedule",
    "precompute_windows",
]


def chunk_layout(n: int, chunk: int) -> tuple[int, int]:
    """Chunk-boundary encoding shared by the speculative selectors
    (``core.pipeline._spec_select``) and their tests.

    Returns ``(min_rounds, padded_len)`` for a window of ``n`` sequential
    decisions speculated ``chunk`` at a time:

      * ``min_rounds`` — speculate/validate rounds when nothing conflicts,
        ``ceil(n / chunk)``; every conflict costs extra rounds (each round
        still accepts >= 1 decision, so the round count is bounded by
        ``n``).
      * ``padded_len`` — the per-position tables are padded to ``n +
        chunk`` rows so every chunk slice ``[p, p+chunk)`` stays in bounds
        for any accepted prefix ``p < n``.  Padding rows are inert —
        ``valid=False`` (their utilities mask to ``-inf``, so both the
        speculation and the validation pick column 0 on them), ``swap=lat=0``,
        ``gid=-2`` (never resident) — and the accepted count is clamped to
        ``n - p``, so they never reach the carry.
    """
    chunk = int(chunk)
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    n = int(n)
    return -(-n // chunk), n + chunk


def utility_matrix(acc, deadlines, completions, penalty: str) -> torch.Tensor:
    """Eq. 2 through the kernel: acc * (1 - clip(gamma(d, e), 0, 1)).

    Either a tile — ``acc`` (R, M), ``deadlines`` (R,), ``completions``
    (R, M) or (M,) — or per-entry vectors, all (N,), scored as an (N, 1)
    column tile with one deadline per row.  Float64 tensors on one device.
    """
    if acc.ndim == 1:
        u, _ = utility_scores(acc[:, None].contiguous(), deadlines.contiguous(),
                              completions[:, None].contiguous(), penalty,
                              with_means=False)
        return u[:, 0]
    u, _ = utility_scores(acc.contiguous(), deadlines.contiguous(),
                          completions.contiguous(), penalty, with_means=False)
    return u


# --------------------------------------------------------------------------
# Precomputed per-application model arrays
# --------------------------------------------------------------------------


@dataclasses.dataclass
class AppArrays:
    """Model-side arrays of one application, shared by every window.

    Host numpy tables for the sequential decisions, and the Eq. 9 model
    terms as tensors on ``device``.
    """

    app: Application
    R: np.ndarray  # (M, C) per-class recalls — the model term of Eq. 9
    profiled: np.ndarray  # (M,) profiled accuracies (Eq. 9 with test theta)
    sc: np.ndarray  # (M,) bool — short-circuit variants (always profiled)
    latency_s: np.ndarray  # (M,) single-request latency (tie-break key)
    lat1: np.ndarray  # (M,) l(m, 1)
    lat_fixed: np.ndarray  # (M,) affine batch-latency intercept
    lat_item: np.ndarray  # (M,) affine batch-latency slope
    swap: np.ndarray  # (M,) model-load (swap) latency
    names: list[str]
    name_to_idx: dict[str, int]
    # Model indices sorted by descending (-latency_s, name): among
    # utility ties, argmax over U[:, tie_pref] picks exactly the model the
    # scalar key (u, -latency_s, name) would.
    tie_pref: np.ndarray
    device: torch.device
    R_t: torch.Tensor  # (M, C) float64 on ``device``
    profiled_t: torch.Tensor  # (M,) float64 on ``device``
    sc_t: torch.Tensor  # (M,) bool on ``device``
    # The profile objects the arrays were built from, pinned for the memo
    # staleness check (identity against app.models).
    models_pin: tuple = ()

    @classmethod
    def build(cls, app: Application, device: torch.device) -> "AppArrays":
        """Precompute one application's model tables on ``device``."""
        models = app.models
        R = np.stack([m.recalls for m in models])
        lat_s = np.array([m.latency_s for m in models])
        lat_fixed = np.array(
            [0.0 if m.latency_model is None else m.latency_model[0] for m in models]
        )
        lat_item = np.array(
            [m.latency_s if m.latency_model is None else m.latency_model[1] for m in models]
        )
        names = [m.name for m in models]
        pref = sorted(
            range(len(models)), key=lambda i: (-lat_s[i], names[i]), reverse=True
        )
        profiled = np.array([m.profiled_accuracy() for m in models])
        sc = np.array([m.is_short_circuit for m in models], dtype=bool)
        return cls(
            app=app,
            R=R,
            profiled=profiled,
            sc=sc,
            latency_s=lat_s,
            lat1=np.array([m.latency(1) for m in models]),
            lat_fixed=lat_fixed,
            lat_item=lat_item,
            swap=np.array([m.load_latency_s for m in models]),
            names=names,
            name_to_idx={n: i for i, n in enumerate(names)},
            tie_pref=np.asarray(pref, dtype=np.int64),
            device=device,
            R_t=torch.as_tensor(R, dtype=SCHED_DTYPE, device=device),
            profiled_t=torch.as_tensor(profiled, dtype=SCHED_DTYPE, device=device),
            sc_t=torch.as_tensor(sc, device=device),
            models_pin=tuple(models),
        )

    @classmethod
    def of(cls, app: Application, device: torch.device) -> "AppArrays":
        """Memoized build per (application, device): the arrays depend only
        on the Application, so they are cached on the instance and shared
        by every window; the profile-identity guard catches in-place
        ``models`` mutation."""
        memo = getattr(app, "_torch_arrays", None)
        if memo is None:
            memo = app._torch_arrays = {}
        cached = memo.get(device)
        if (
            cached is None
            or len(cached.models_pin) != len(app.models)
            or any(a is not b for a, b in zip(cached.models_pin, app.models))
        ):
            cached = memo[device] = cls.build(app, device)
        return cached

    def batch_latency(self, batch_size: int) -> np.ndarray:
        """l(m, b) for every variant."""
        return self.lat_fixed + self.lat_item * batch_size

    def argbest(self, utilities: np.ndarray) -> int:
        """argmax_m with the scalar tie-break key (u, -latency_s, name)."""
        pref = self.tie_pref
        return int(pref[int(np.argmax(np.asarray(utilities)[pref]))])


# --------------------------------------------------------------------------
# Per-window precompute
# --------------------------------------------------------------------------


class WindowArrays:
    """All per-window request matrices the batched equations consume.

    Host bookkeeping (partitions, deadlines, ids) is numpy; accuracy
    matrices are float64 tensors on ``device``, built lazily per mode and
    cached; the priority vector comes back to the host.
    """

    def __init__(
        self,
        requests: Sequence[Request],
        apps: Mapping[str, Application],
        now: float,
        device=None,
    ):
        self.device = resolve_device(device)
        self.requests = list(requests)
        self.apps = apps
        self.now = float(now)
        n = len(self.requests)
        self.deadlines = np.fromiter(
            (r.deadline_s for r in self.requests), dtype=np.float64, count=n
        )
        self.arrivals = np.fromiter(
            (r.arrival_s for r in self.requests), dtype=np.float64, count=n
        )
        self.rids = np.fromiter(
            (r.rid for r in self.requests), dtype=np.int64, count=n
        )
        self.app_of = [r.app for r in self.requests]
        self.req_idx: dict[str, np.ndarray] = {}
        self.row_of = np.zeros(n, dtype=np.int64)  # position within the app block
        self._pos_cache: dict[int, int] | None = None
        app_names_arr = np.asarray(self.app_of) if n else np.zeros(0, dtype=object)
        by_app = {
            app_name: np.nonzero(app_names_arr == app_name)[0].tolist()
            for app_name in dict.fromkeys(self.app_of)
        }
        self.app_arrays: dict[str, AppArrays] = {}
        self._theta_rows: dict[str, np.ndarray] = {}
        self._theta_mat: dict[str, np.ndarray] = {}
        self._label_rows: dict[str, np.ndarray] = {}
        self._labels: dict[str, np.ndarray] = {}
        reqs = self.requests
        for app_name, idx_list in by_app.items():
            idx = np.asarray(idx_list, dtype=np.int64)
            self.req_idx[app_name] = idx
            self.row_of[idx] = np.arange(len(idx))
            self.app_arrays[app_name] = AppArrays.of(apps[app_name], self.device)
            t_rows: list[int] = []
            thetas: list[np.ndarray] = []
            l_rows: list[int] = []
            labels: list[int] = []
            for row, i in enumerate(idx_list):
                r = reqs[i]
                if r.theta is not None:
                    t_rows.append(row)
                    thetas.append(r.theta)
                if r.true_label is not None:
                    l_rows.append(row)
                    labels.append(int(r.true_label))
            self._theta_rows[app_name] = np.asarray(t_rows, dtype=np.int64)
            self._theta_mat[app_name] = (
                np.asarray(thetas, dtype=np.float64)
                if t_rows
                else np.zeros((0, apps[app_name].num_classes))
            )
            self._label_rows[app_name] = np.asarray(l_rows, dtype=np.int64)
            self._labels[app_name] = np.asarray(labels, dtype=np.int64)
        self._deadlines_t: torch.Tensor | None = None
        self._acc_cache: dict[tuple[str, str], torch.Tensor] = {}
        self._prio_cache: dict[bool, np.ndarray] = {}
        self._exact_acc: dict[tuple[int, str, str], float] = {}  # id(req)-keyed

    @property
    def _pos(self) -> dict[int, int]:
        """id(request) -> window position, built on first use."""
        if self._pos_cache is None:
            self._pos_cache = {id(r): i for i, r in enumerate(self.requests)}
        return self._pos_cache

    def index_of(self, request: Request) -> int:
        """Window position of a request (identity-based, rids may repeat)."""
        return self._pos[id(request)]

    def rows_of(self, requests: Sequence[Request]) -> np.ndarray:
        """Window positions for a request subset (e.g. one group)."""
        pos = self._pos
        return np.asarray([pos[id(r)] for r in requests], dtype=np.int64)

    @property
    def deadlines_t(self) -> torch.Tensor:
        """(R,) float64 deadlines on the window's device."""
        if self._deadlines_t is None:
            self._deadlines_t = torch.as_tensor(
                self.deadlines, dtype=SCHED_DTYPE, device=self.device
            )
        return self._deadlines_t

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # -- Eq. 9 ------------------------------------------------------------
    def acc_matrix(self, app_name: str, mode: str) -> torch.Tensor:
        """(R_app, M) float64 accuracy estimates on the device.

        "sharpened" rows with a posterior are one batched ``Theta @ R.T``
        product; rows without theta and short-circuit columns stay
        profiled, exactly mirroring ``evaluation.estimate_accuracy``.
        """
        key = (app_name, mode)
        cached = self._acc_cache.get(key)
        if cached is not None:
            return cached
        aa = self.app_arrays[app_name]
        n = len(self.req_idx[app_name])
        A = aa.profiled_t.repeat(n, 1)
        if mode == "profiled":
            pass
        elif mode == "sharpened":
            rows = self._theta_rows[app_name]
            if rows.size:
                theta = torch.as_tensor(
                    self._theta_mat[app_name], dtype=SCHED_DTYPE, device=self.device
                )
                S = theta @ aa.R_t.T  # Eq. 9, batched
                if aa.sc.any():
                    S[:, aa.sc_t] = aa.profiled_t[aa.sc_t]
                A[self._tensor(rows)] = S
        elif mode == "oracle":
            rows = self._label_rows[app_name]
            if rows.size:
                S = aa.R_t.T[self._tensor(self._labels[app_name])]  # recall gather
                if aa.sc.any():
                    S[:, aa.sc_t] = aa.profiled_t[aa.sc_t]
                A[self._tensor(rows)] = S
        else:
            raise ValueError(f"unknown accuracy mode {mode!r}")
        self._acc_cache[key] = A
        return A

    def exact_accuracy(self, request: Request, profile: ModelProfile, mode: str) -> float:
        """Memoized host ``evaluation.estimate_accuracy`` — used where
        scalar-path reproducibility matters more than batching (the
        brute-force solver compares many near-tied plans)."""
        key = (id(request), profile.name, mode)
        a = self._exact_acc.get(key)
        if a is None:
            from repro_torch.core.evaluation import estimate_accuracy

            a = estimate_accuracy(request, self.apps[request.app], profile, mode)
            self._exact_acc[key] = a
        return a

    # -- Eq. 12 -----------------------------------------------------------
    def priorities(self, data_aware: bool = False) -> np.ndarray:
        """(R,) host priorities: (1 + Var[Accuracy(M_a)]) * exp(-d), with
        d = max(deadline - now, -60), computed on the device."""
        cached = self._prio_cache.get(data_aware)
        if cached is not None:
            return cached
        mode = "sharpened" if data_aware else "profiled"
        p = np.zeros(len(self.requests))
        for app_name, idx in self.req_idx.items():
            A = self.acc_matrix(app_name, mode)
            var = row_var(A) if A.shape[1] > 1 else torch.zeros_like(A[:, 0])
            d = torch.clamp(self.deadlines_t[self._tensor(idx)] - self.now, min=-60.0)
            p[idx] = ((1.0 + var) * torch.exp(-d)).cpu().numpy()
        self._prio_cache[data_aware] = p
        return p

    # -- orderings --------------------------------------------------------
    def order_indices(self, ordering: str, data_aware: bool = False) -> np.ndarray:
        """Window order as indices into ``requests`` (FCFS/EDF/priority)."""
        if ordering == "fcfs":
            return np.lexsort((self.rids, self.arrivals))
        if ordering == "edf":
            return np.lexsort((self.rids, self.deadlines))
        if ordering == "priority":
            return np.lexsort((self.rids, -self.priorities(data_aware)))
        raise ValueError(f"unknown ordering {ordering!r}")


# --------------------------------------------------------------------------
# Fast per-request policies (MaxAcc / locally-optimal + FCFS/EDF/priority)
# --------------------------------------------------------------------------


def fast_per_request_schedule(
    requests: Sequence[Request],
    apps: Mapping[str, Application],
    now: float,
    ordering: str = "edf",
    selection: str = "locally_optimal",
    data_aware: bool = False,
    arrays: WindowArrays | None = None,
    state=None,
    device=None,
) -> Schedule:
    """Vectorized per-request scheduling, the port of the reference's
    ``fast_per_request_schedule``.

    Ordering and Eq. 9 are batched on the device; the locally-optimal
    selection is sequential by nature (each choice shifts the queue tail
    and residency for the next), so it runs as a scalar host loop over the
    precomputed accuracy rows, with the scalar tie-break key.

    ``state`` (streaming.StreamingState) seeds the queue tail and model
    residency from worker 0's carried timeline (a clone — scheduling never
    commits to the state).
    """
    if not requests:
        return Schedule()
    acc_mode = "sharpened" if data_aware else "profiled"
    wa = arrays if arrays is not None else WindowArrays(requests, apps, now, device)
    order = wa.order_indices(ordering, data_aware)
    tl = None
    if state is not None:
        tl = state.peek_timeline(0).clone()
        tl.advance(now)

    max_acc_choice: dict[str, np.ndarray] = {}
    acc_rows: dict[str, list[list[float]]] = {}
    if selection == "max_accuracy":
        # Deadline-oblivious: argmax over the accuracy matrix, whole window
        # at once (tie key (acc, -latency, name) via the tie_pref gather).
        for app_name in wa.req_idx:
            aa = wa.app_arrays[app_name]
            A = wa.acc_matrix(app_name, acc_mode).cpu().numpy()
            pref = aa.tie_pref
            max_acc_choice[app_name] = pref[np.argmax(A[:, pref], axis=1)]
    elif selection == "locally_optimal":
        acc_rows = {
            app_name: wa.acc_matrix(app_name, acc_mode).cpu().tolist()
            for app_name in wa.req_idx
        }
    else:
        raise ValueError(f"unknown selection {selection!r}")

    tables = {}
    for app_name, aa in wa.app_arrays.items():
        tables[app_name] = (
            aa.names,
            aa.swap.tolist(),
            aa.lat1.tolist(),
            aa.latency_s.tolist(),
            aa.app.penalty_fn,
            aa.app.models,
        )

    entries: list[ScheduleEntry] = []
    t = float(now) if tl is None else tl.t
    resident: str | None = None  # single-slot residency (capacity=None)
    row_of = wa.row_of
    for k, g in enumerate(order):
        g = int(g)
        r = wa.requests[g]
        app_name = wa.app_of[g]
        names, swaps, lat1s, lat_ss, penalty_fn, models = tables[app_name]
        if selection == "max_accuracy":
            sel = int(max_acc_choice[app_name][row_of[g]])
        else:
            # Eq. 13 at the queue tail with the scalar tie-break key
            # (u, -latency, name); accuracies come from the Eq. 9 product.
            row = acc_rows[app_name][row_of[g]]
            deadline = r.deadline_s
            sel, best_key = 0, None
            for m_i in range(len(names)):
                if tl is None:
                    swap_m = 0.0 if resident == names[m_i] else swaps[m_i]
                else:
                    swap_m = 0.0 if tl._is_resident(names[m_i]) else swaps[m_i]
                completion = t + swap_m + lat1s[m_i]
                gam = penalty_fn(deadline, completion)
                u = row[m_i] * (1.0 - min(1.0, max(0.0, gam)))
                key = (u, -lat_ss[m_i], names[m_i])
                if best_key is None or key > best_key:
                    sel, best_key = m_i, key
        if tl is None:
            start = t
            t = start + (0.0 if resident == names[sel] else swaps[sel]) + lat1s[sel]
            resident = names[sel]
        else:
            start, t = tl.run_batch(models[sel], 1)
        entries.append(
            ScheduleEntry(
                request=r,
                model=names[sel],
                order=k + 1,
                batch_id=-1,
                est_start_s=start,
                est_latency_s=t - start,
            )
        )
    sched = Schedule(entries=entries)
    sched.validate()
    return sched


# --------------------------------------------------------------------------
# Fast grouped scheduling (Algorithm 1 + §V-C2 splitting)
# --------------------------------------------------------------------------


def ordered_group_items(
    groups: Mapping[str, list],
    gp: Mapping[str, float],
    split_by_label: bool,
) -> list[tuple[str, list]]:
    """Group execution order: Eq. 14 priority descending, key tie-break;
    with label splitting, same-application subgroups stay ADJACENT (apps
    ordered by their best subgroup's priority) so splitting doesn't re-pay
    the model swap."""
    ordered_groups = sorted(groups.items(), key=lambda item: (-gp[item[0]], item[0]))
    if split_by_label and len(ordered_groups) > 1:
        app_rank: dict[str, int] = {}
        for key, members in ordered_groups:
            app_rank.setdefault(members[0].app, len(app_rank))
        ordered_groups.sort(
            key=lambda item: (app_rank[item[1][0].app], -gp[item[0]])
        )
    return ordered_groups


def fast_grouped_schedule(
    requests: Sequence[Request],
    apps: Mapping[str, Application],
    now: float,
    tau: int = 3,
    data_aware: bool = False,
    split_by_label: bool = False,
    acc_mode: str | None = None,
    arrays: WindowArrays | None = None,
    state=None,
    device=None,
) -> Schedule:
    """Vectorized Algorithm 1, the port of the reference's
    ``fast_grouped_schedule``.

    Group priorities are host means over slices of the window priority
    vector (Eq. 14); each group's variant is chosen from one Eq. 2 tile
    scored by the kernel, its column means and an argmax (Eq. 13).  With
    at most ``tau`` groups the exact brute-force solver runs instead, fed
    the window's memoized accuracies.

    ``state`` seeds the worker timeline (backlog + residency) from the
    carried streaming state — a clone, so scheduling never commits.
    """
    from repro_torch.core.bruteforce import brute_force_groups
    from repro_torch.core.evaluation import WorkerTimeline
    from repro_torch.core.grouping import group_by_app, split_groups_by_label
    from repro_torch.core.selection import group_locally_optimal

    if not requests:
        return Schedule()
    if acc_mode is None:
        acc_mode = "sharpened" if data_aware else "profiled"

    groups = group_by_app(requests)
    if split_by_label:
        groups = split_groups_by_label(groups, apps)

    wa = arrays if arrays is not None else WindowArrays(requests, apps, now, device)
    if state is not None:
        tl = state.peek_timeline(0).clone()
        tl.advance(now)
    else:
        tl = WorkerTimeline(now)

    if len(groups) <= tau:
        try:
            return brute_force_groups(
                groups, apps, now, acc_mode=acc_mode, arrays=wa, timeline=tl
            )
        except ValueError:
            pass  # too many (group-ordering x model) candidates; fall through

    prio = wa.priorities(data_aware)
    member_idx = {key: wa.rows_of(members) for key, members in groups.items()}
    gp = {key: float(np.mean(prio[member_idx[key]])) for key in groups}  # Eq. 14
    ordered_groups = ordered_group_items(groups, gp, split_by_label)

    entries: list[ScheduleEntry] = []
    order = 1
    for batch_id, (key, members) in enumerate(ordered_groups):
        app = apps[members[0].app]
        idx = member_idx[key]
        profile = group_locally_optimal(members, app, tl, acc_mode=acc_mode, arrays=wa)
        start, completion = tl.run_batch(profile, len(members))
        member_order = np.lexsort((wa.rids[idx], -prio[idx]))
        for j in member_order:
            entries.append(
                ScheduleEntry(
                    request=wa.requests[int(idx[int(j)])],
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


# --------------------------------------------------------------------------
# Vectorized schedule scoring (consumed by evaluation.evaluate)
# --------------------------------------------------------------------------


def score_entries(
    entries: Sequence[ScheduleEntry],
    apps: Mapping[str, Application],
    acc_mode: str,
    device=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host (accuracies, utilities, completions, deadlines) for replayed entries.

    Each entry's realized start/latency must already be filled in (the
    timeline replay in ``evaluation.evaluate`` does this).  Eq. 9 uses the
    WindowArrays matrices; Eq. 2 runs once per application through the
    kernel, as an (N, 1) column tile with one deadline per entry.
    """
    n = len(entries)
    accs = np.zeros(n)
    utils = np.zeros(n)
    wa = WindowArrays([e.request for e in entries], apps, now=0.0, device=device)
    completions = np.array([e.est_start_s + e.est_latency_s for e in entries])
    for app_name, idx in wa.req_idx.items():
        aa = wa.app_arrays[app_name]
        A = wa.acc_matrix(app_name, acc_mode)
        model_cols = [aa.name_to_idx[entries[int(i)].model] for i in idx]
        a = A[torch.arange(len(idx), device=wa.device), wa._tensor(np.asarray(model_cols))]
        idx_t = wa._tensor(idx)
        comp = torch.as_tensor(completions[idx], dtype=SCHED_DTYPE, device=wa.device)
        u = utility_matrix(a, wa.deadlines_t[idx_t], comp, aa.app.penalty)
        accs[idx] = a.cpu().numpy()
        utils[idx] = u.cpu().numpy()
    return accs, utils, completions, wa.deadlines


# --------------------------------------------------------------------------
# Fast multi-worker scheduling (paper §VII, Eq. 15)
# --------------------------------------------------------------------------


def placement_pref(
    names: Sequence[str],
    latency_s: np.ndarray,
    speeds: np.ndarray,
    wids: Sequence[int],
    pad_to: int | None = None,
    scale: np.ndarray | None = None,
) -> np.ndarray:
    """Flattened (worker, model) candidate preference permutation — the
    Eq. 15 tie-break after utility: lower scaled latency, then larger
    model name, then lower worker id.  First-max over this order equals
    an argmax under the scalar key (u, -scaled latency, name, -wid).
    ``pad_to`` pads the model axis for the pipeline's stacked tables
    (padded candidates last, through infinite latency).  ``scale`` is an
    optional (W, M) drift-correction multiplier on the scaled latency, so
    the tie-break ranks candidates by the corrected latencies the
    utilities were computed with."""
    m = len(names)
    m_pad = pad_to if pad_to is not None else m
    rank = np.zeros(m_pad, dtype=np.int64)
    for pos, i in enumerate(sorted(range(m), key=lambda i: names[i])):
        rank[i] = pos
    slat = np.full((len(speeds), m_pad), np.inf)
    slat[:, :m] = np.asarray(latency_s)[None, :] / np.asarray(speeds)[:, None]
    if scale is not None:
        slat[:, :m] *= np.asarray(scale)
    wid_flat = np.repeat(np.asarray(wids), m_pad)
    rank_flat = np.tile(rank, len(speeds))
    return np.lexsort((wid_flat, -rank_flat, slat.ravel())).astype(np.int64)


@dataclasses.dataclass
class PoolArrays:
    """Array-encoded worker-pool state, the reference's §VII representation.

    Per-worker busy-until times, fixed-size LRU residency slots (integer
    model ids, oldest first, -1 empty), effective byte sizes, and
    per-(worker, model) latency/swap tables scaled by each worker's
    speed and load.  The capacity-``None`` single-slot residency is
    folded into the same LRU rule via ``residency.single_slot_encoding``
    (capacity 0 + unit sizes), so one update — ``touch_lru_array`` —
    covers both.  Host numpy: the decisions are taken here.
    """

    workers: list  # multiworker.Worker, pool order
    wids: list[int]
    t: np.ndarray  # (W,) busy-until
    res: np.ndarray  # (W, K) LRU slot ids, oldest first, -1 empty
    sizes: np.ndarray  # (W, G) effective byte sizes (or units, single-slot)
    capacity: float  # byte budget (0.0 encodes single-slot)
    gids: dict[str, int]  # model name -> id
    gid_names: list[str]
    # Drift-correction scales {(wid, model name): s} — multiply the scaled
    # latency tables (None: the profiled latencies).
    lat_scale: dict | None = None
    _tables: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def build(cls, workers: Sequence, wa: "WindowArrays", state=None, now: float = 0.0,
              lat_scale: Mapping | None = None):
        """Encode ``state`` (or an idle pool at ``now``) against the
        window's model universe plus any carried resident names."""
        from repro_torch.core.residency import single_slot_encoding

        gids: dict[str, int] = {}
        defaults: list[float] = []
        for app_name in wa.req_idx:
            app = wa.app_arrays[app_name].app
            for m in app.models:
                if m.name not in gids:
                    gids[m.name] = len(gids)
                    defaults.append(float(m.memory_bytes))
        if state is not None:
            # Carried resident names outside the window's model universe
            # still occupy LRU slots; their sizes come from the registered
            # table when known, else 0 bytes (the host rule's
            # ``sizes.get(n, 0)``).
            for w in workers:
                for name in state.peek_timeline(w.wid)._resident:
                    if name not in gids:
                        gids[name] = len(gids)
                        defaults.append(0.0)
        gid_names = list(gids)
        n_ids = len(gid_names)
        n_w = len(workers)
        wids = [w.wid for w in workers]
        if state is not None:
            t, res, reg = state.to_arrays(gids, wids=wids, slots=n_ids)
            t = np.maximum(t, float(now))
        else:
            t = np.full(n_w, float(now))
            res = np.full((n_w, n_ids), -1, dtype=np.int64)
            reg = np.full((n_w, n_ids), -1.0)
        if state is None or state.capacity is None:
            unit, capacity = single_slot_encoding(n_ids)
            sizes = np.tile(unit, (n_w, 1))
        else:
            capacity = float(state.capacity)
            # _touch setdefaults the profile's memory_bytes at load time,
            # so the effective size is the registered one when present.
            sizes = np.where(reg >= 0, reg, np.asarray(defaults)[None, :])
        return cls(
            workers=list(workers),
            wids=wids,
            t=t,
            res=res,
            sizes=sizes,
            capacity=capacity,
            gids=gids,
            gid_names=gid_names,
            lat_scale=dict(lat_scale) if lat_scale else None,
        )

    def scale_matrix(self, aa: AppArrays) -> np.ndarray | None:
        """(W, M) drift-correction multipliers for one application's
        variants (``None`` when no scale applies)."""
        if not self.lat_scale:
            return None
        S = np.ones((len(self.workers), len(aa.names)))
        hit = False
        for wi, w in enumerate(self.workers):
            for mi, name in enumerate(aa.names):
                s = self.lat_scale.get((w.wid, name))
                if s is not None:
                    S[wi, mi] = s
                    hit = True
        return S if hit else None

    def app_table(self, wa: "WindowArrays", app_name: str):
        """Per-(worker, model) scaled tables and the flattened tie-break
        order (``placement_pref``) of one application, cached per pool.
        ``lat_scale`` multiplies the latency tables (and the tie-break
        ranking); swap latencies are left alone."""
        tab = self._tables.get(app_name)
        if tab is None:
            aa = wa.app_arrays[app_name]
            speeds = np.array([w.speed for w in self.workers])
            load_scales = np.array([w.load_scale for w in self.workers])
            slat_fixed = aa.lat_fixed[None, :] / speeds[:, None]  # (W, M)
            slat_item = aa.lat_item[None, :] / speeds[:, None]
            scale = self.scale_matrix(aa)
            if scale is not None:
                slat_fixed = slat_fixed * scale
                slat_item = slat_item * scale
            tab = (
                aa,
                slat_fixed,
                slat_item,
                aa.swap[None, :] * load_scales[:, None],
                placement_pref(aa.names, aa.latency_s, speeds, self.wids, scale=scale),
                np.asarray([self.gids[n] for n in aa.names], dtype=np.int64),
            )
            self._tables[app_name] = tab
        return tab

    def res_mode(self, state) -> str:
        """Residency carry of the pipeline's scan: "slot1" when the
        single-slot encoding applies (no byte capacity on the carried
        state) and no worker carries more than one resident — one id per
        worker — else "lru" (the slot-vector carry).  One rule for every
        program, the reference's."""
        single = state is None or state.capacity is None
        if single and int((self.res >= 0).sum(axis=1).max(initial=0)) <= 1:
            return "slot1"
        return "lru"

    def resident_mask(self, gid_row: np.ndarray) -> np.ndarray:
        """(W, M) bool: is ``gid_row[m]`` resident on worker w?"""
        return (self.res[:, None, :] == gid_row[None, :, None]).any(axis=-1)

    def place(self, wi: int, gid: int, completion: float) -> None:
        """Commit one placement: set worker ``wi``'s busy-until time and
        run the shared LRU residency update."""
        from repro_torch.core.residency import touch_lru_array

        self.t[wi] = completion
        self.res[wi], _ = touch_lru_array(
            self.res[wi], int(gid), self.sizes[wi], self.capacity
        )


def placement_means(acc: torch.Tensor, deadlines: torch.Tensor,
                    completions: np.ndarray, penalty: str) -> np.ndarray:
    """(W*M,) member means of one placement step: the group's (B, M)
    accuracy rows repeated W times along the columns, worker-major (column
    w*M + m), against the (W*M,) completions, through one launch of the
    Eq. 2 kernel with its column sums.  The means add the members in
    order, bit-identical to the reference's ``sequential_mean`` of its
    (W, B, M) tile."""
    n_w = completions.shape[0] // acc.shape[1]
    tile = acc.repeat(1, n_w)  # (B, W*M), worker-major
    comp = torch.as_tensor(completions, dtype=tile.dtype, device=tile.device)
    _, means = utility_scores(tile, deadlines, comp, penalty)
    return means.cpu().numpy()


def fast_multiworker_schedule(
    requests: Sequence[Request],
    apps: Mapping[str, Application],
    workers: Sequence,
    now: float,
    data_aware: bool = False,
    split_by_label: bool = False,
    per_request: bool = False,
    arrays: WindowArrays | None = None,
    state=None,
    lat_scale: Mapping | None = None,
    worker_mask=None,
    device=None,
) -> Schedule:
    """Vectorized Eq. 15, the port of the reference's
    ``fast_multiworker_schedule``.

    Each placement step scores all (worker, model) candidates of a group
    at once: one (B, W*M) Eq. 2 tile, accuracies from the window's Eq. 9
    product, completions from the per-worker latency-scaled model axis,
    reduced by the kernel's column sums to the member means and picked on
    the host with the shared tie-break (utility, -scaled latency, name,
    -wid).  One kernel launch per group, on ``device`` (the card unless
    ``"cpu"`` is named).  Worker state lives in a ``PoolArrays`` bundle
    read from the carried ``state``, which is never mutated: scheduling
    peeks, evaluation commits.

    ``lat_scale`` ({(wid, model): s}) multiplies the per-(worker, model)
    latency tables; ``worker_mask`` (a wid set) restricts placement to the
    named workers.
    """
    from repro_torch.core.grouping import group_by_app, split_groups_by_label

    if not requests:
        return Schedule()
    if worker_mask is not None:
        workers = [w for w in workers if w.wid in worker_mask]
    if not workers:
        raise ValueError("multiworker_schedule requires at least one worker")
    acc_mode = "sharpened" if data_aware else "profiled"
    if per_request:
        groups = {f"r{r.rid}": [r] for r in requests}
    else:
        groups = group_by_app(requests)
        if split_by_label:
            groups = split_groups_by_label(groups, apps)

    wa = arrays if arrays is not None else WindowArrays(requests, apps, now, device)
    dev = wa.device
    prio = wa.priorities(data_aware)
    member_idx = {key: wa.rows_of(members) for key, members in groups.items()}
    gp = {key: float(np.mean(prio[member_idx[key]])) for key in groups}  # Eq. 14
    # Plain Eq. 14 order: placement does not apply the single-worker
    # same-app adjacency rule (groups may land on different workers).
    ordered_groups = ordered_group_items(groups, gp, split_by_label=False)

    pool = PoolArrays.build(workers, wa, state=state, now=now, lat_scale=lat_scale)
    orders = {w.wid: 1 for w in workers}
    entries: list[ScheduleEntry] = []

    for batch_id, (key, members) in enumerate(ordered_groups):
        app_name = members[0].app
        aa, slat_fixed, slat_item, sswap, pref, gid_row = pool.app_table(wa, app_name)
        idx = member_idx[key]
        b = len(members)
        # (W, M) completions if this batch ran next on each candidate, in
        # peek_batch's association: (t + swap) + l(m, b).
        swap_eff = np.where(pool.resident_mask(gid_row), 0.0, sswap)
        lat_b = slat_fixed + slat_item * b
        completions = pool.t[:, None] + swap_eff + lat_b
        A_g = wa.acc_matrix(app_name, acc_mode)[torch.as_tensor(wa.row_of[idx], device=dev)]
        u_mean = placement_means(A_g, wa.deadlines_t[torch.as_tensor(idx, device=dev)],
                                 completions.ravel(), aa.app.penalty)
        # First-max over the preference permutation == argmax with the
        # shared tie-break (utility, -scaled latency, name, -wid).
        pick = int(pref[int(np.argmax(u_mean[pref]))])
        wi, mi = divmod(pick, len(aa.names))
        w = workers[wi]
        start = float(pool.t[wi])
        # run_batch association: (start + swap) + l(m, b).
        completion = (start + float(swap_eff[wi, mi])) + float(lat_b[wi, mi])
        lat = completion - start
        pool.place(wi, int(gid_row[mi]), completion)
        member_order = np.lexsort((wa.rids[idx], -prio[idx]))
        for j in member_order:
            entries.append(
                ScheduleEntry(
                    request=wa.requests[int(idx[int(j)])],
                    model=aa.names[mi],
                    order=orders[w.wid],
                    worker=w.wid,
                    batch_id=batch_id,
                    est_start_s=start,
                    est_latency_s=lat,
                )
            )
            orders[w.wid] += 1
    sched = Schedule(entries=entries)
    sched.validate()
    return sched


# --------------------------------------------------------------------------
# Multi-window batched precompute (streaming fast path)
# --------------------------------------------------------------------------


def _stacked_program(thetas: Sequence[torch.Tensor], has_rows: torch.Tensor, aa: AppArrays,
                     n: int, d_rel: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. 9 and Eq. 12 for ``n`` stacked rows of one application: the
    (n, M) accuracy matrix — profiled, with the rows ``has_rows`` sharpened
    by ``theta @ R.T`` and short-circuit columns kept profiled — and the
    priorities ``(1 + var) * exp(-max(d_rel, -60))``.  The same tensor
    operations, in the same order, as ``WindowArrays.acc_matrix`` and
    ``priorities``, so each row equals the lazy per-window one.

    ``thetas`` holds one window's theta rows each, and Eq. 9 is one
    product per window in the lazy compute's shape: a BLAS product rounds
    a row by how many rows it is given (MKL's products of fewer than four
    rows differ in the last bit from its larger ones), so stacking the
    product would break row identity.  Everything after it is row-wise
    and runs once over the stacked rows."""
    A = aa.profiled_t.repeat(n, 1)
    if has_rows.numel():
        S = torch.cat([theta @ aa.R_t.T for theta in thetas])  # Eq. 9, per window
        if aa.sc.any():
            S[:, aa.sc_t] = aa.profiled_t[aa.sc_t]
        A[has_rows] = S
    var = row_var(A) if A.shape[1] > 1 else torch.zeros_like(A[:, 0])
    return A, (1.0 + var) * torch.exp(-torch.clamp(d_rel, min=-60.0))


def precompute_windows(
    windows: Sequence[tuple[Sequence[Request], float]],
    apps: Mapping[str, Application],
    data_aware: bool = False,
    backend: str = "numpy",
    *,
    device=None,
) -> list[WindowArrays]:
    """Stack several windows' request matrices into ONE program per
    application, the port of the reference's ``precompute_windows``.

    All windows' rows and deadlines of an application run through one
    float64 torch program on ``device`` (``_stacked_program``: Eq. 9 one
    product per window, in the lazy shape, the rest over the stacked
    rows); the results are scattered back into each
    window's ``WindowArrays`` caches, so the sequential scheduling pass
    finds Eq. 9 and Eq. 12 precomputed.  ``windows`` is a sequence of
    (requests, now) pairs.  Both of the reference's ``backend`` values,
    "numpy" and "jax", run this program: its rows equal the lazy
    per-window compute's, where the reference's "jax" route may differ
    on near-ties.

    Returns the per-window ``WindowArrays`` (pass via ``arrays=``).
    """
    if backend not in ("numpy", "jax"):
        raise ValueError(f"unknown precompute backend {backend!r}")
    dev = resolve_device(device)
    mode = "sharpened" if data_aware else "profiled"
    was = [WindowArrays(list(reqs), apps, now, dev) for reqs, now in windows]
    app_names: list[str] = []
    for w in was:
        for name in w.req_idx:
            if name not in app_names:
                app_names.append(name)
    prios = [np.zeros(len(w.requests)) for w in was]
    for app_name in app_names:
        members = [w for w in was if app_name in w.req_idx]
        aa = members[0].app_arrays[app_name]
        thetas, has_rows, d_blocks, sizes = [], [], [], []
        off = 0
        for w in members:
            idx = w.req_idx[app_name]
            rows = w._theta_rows[app_name]
            if rows.size and mode == "sharpened":
                thetas.append(w._theta_mat[app_name])
                has_rows.append(rows + off)
            d_blocks.append(w.deadlines[idx] - w.now)
            sizes.append(len(idx))
            off += len(idx)
        thetas = [torch.as_tensor(t, dtype=SCHED_DTYPE, device=dev) for t in thetas]
        rows_t = torch.as_tensor(
            np.concatenate(has_rows) if has_rows else np.zeros(0, dtype=np.int64), device=dev
        )
        d_rel = torch.as_tensor(np.concatenate(d_blocks), dtype=SCHED_DTYPE, device=dev)
        A_all, prio_all = _stacked_program(thetas, rows_t, aa, off, d_rel)
        prio_host = prio_all.cpu().numpy()
        off = 0
        for w, n in zip(members, sizes):
            w._acc_cache[(app_name, mode)] = A_all[off : off + n]
            prios[was.index(w)][w.req_idx[app_name]] = prio_host[off : off + n]
            off += n
    for w, p in zip(was, prios):
        w._prio_cache[data_aware] = p
    return was
