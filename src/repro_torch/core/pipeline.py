"""The compiled window pipeline: one scheduling window's selection on the device.

The port of ``repro.core.pipeline``.  The fast path (``core.fastpath``)
batches the paper's equations but takes each window's sequential Eq. 13
decisions on the host: a scalar loop per request, or one K1 launch and
one read-back per group.  Here a window's selection is ONE launch of the
``selection_scan`` kernel (``repro_torch.kernels.selection_scan``):

  * **Ingest** — ``sneakpeek.ingest_window`` on the pipeline's device:
    one batched k-NN evidence compute (K2) and one Dirichlet update per
    application.
  * **Per-request policies** (MaxAcc / LO-EDF / LO-Priority,
    ``_per_request_program``) — the Eq. 9 accuracy rows
    (``WindowArrays.acc_matrix``) gathered into one tile on the device in
    tie-preference column order, the window order
    (``WindowArrays.order_indices``, Eq. 12 for LO-Priority), MaxAcc's
    whole-window argmax on the device, then the scan over the ordered
    requests threading the queue tail and residency.
  * **Grouped policies** (Grouped / SneakPeek, ``_grouped_program``) —
    the stacked Eq. 9/12 program (``fastpath.precompute_windows``), the
    brute-force branch (<= tau groups) on the exact host solver, else
    the scan over the ordered groups, each step one (members x models)
    Eq. 2 tile reduced to a member mean and an argmax.
  * **Multi-worker placement** (§VII, Eq. 15, the reference's
    ``_multiworker_program``, here ``_schedule_multiworker``) —
    the scan over the priority-ordered groups scoring the full (worker,
    model) tile and taking the first maximum over the Eq. 15 preference
    permutation, threading per-worker queue tails and LRU slots; the pool
    is the fast path's ``PoolArrays`` encoding.

Residency is array-encoded everywhere: ``res_mode`` "slot1" carries one
id per worker (the paper's single-slot model with at most one carried
resident), "lru" the LRU slot vectors updated by ``touch_lru_array``'s
rule (``_touch_residency`` is its tensor form), the capacity-``None``
single-slot model folded in by ``residency.single_slot_encoding``.

``chunk`` > 0 swaps each sequential scan for speculative chunked
selection (the reference's ``_spec_select`` and ``_spec_select_mw``):
rounds that speculate ``chunk`` decisions against the carry frozen at
the chunk boundary, reconstruct the carries those decisions imply,
re-decide under them and accept through the first conflict.  A window's
rounds are ONE launch of the ``spec_scan`` kernel
(``repro_torch.kernels.spec_scan``), whose plain version is
``_spec_select`` here; the decisions equal the sequential scan's bit for
bit, and ``last_chunk_stats`` / ``Schedule.chunk_stats`` report the
rounds and conflicts.

The heads and the host halves (grouping, ordering, tables, emit) follow
the reference line by line; the scan replaces its ``lax.scan``s.  All of
it is float64 in the reference's association, so schedules equal the
numpy fast path's and the scalar reference's decision for decision and
time for time.  ``set_pipeline_backend("numpy")`` routes every pipeline
schedule through the port's fast path instead.

``shard`` splits the tiles across shards (``core.shard``,
``ShardedWindowPipeline``; bit-identical decisions).
"""
from __future__ import annotations

import time
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.fastpath import (
    PoolArrays,
    WindowArrays,
    chunk_layout,
    fast_grouped_schedule,
    fast_multiworker_schedule,
    fast_per_request_schedule,
    ordered_group_items,
    placement_pref,
    precompute_windows,
)
from repro_torch.core.sneakpeek import ingest_window
from repro_torch.core.types import Application, Request, Schedule, ScheduleEntry
from repro_torch.core.utility import PENALTY_CODES, gamma
from repro_torch.device import SCHED_DTYPE, resolve_device

__all__ = [
    "WindowPipeline",
    "pipeline_schedule",
    "set_pipeline_backend",
    "get_pipeline_backend",
]

_PIPELINE_BACKEND = "auto"
# Per-app-set static tables (swap/latency/residency-id/penalty, tie-pref
# order), window-independent: built once and reused across windows, with
# their device copies.  The cache holds the AppArrays it was built from, so
# the id key stays sound (AppArrays is memoized per Application and
# device); bounded LRU so retired application sets don't pin their arrays.
_TABLES: dict = {}
_TABLES_MAX = 16


def set_pipeline_backend(name: str) -> None:
    """Select the pipeline backend: "auto" and "jax" take the compiled
    route (the selection scan on the pipeline's device), "numpy" the
    port's fast path (decision-identical)."""
    global _PIPELINE_BACKEND
    if name not in ("auto", "jax", "numpy"):
        raise ValueError(f"unknown pipeline backend {name!r}")
    _PIPELINE_BACKEND = name


def get_pipeline_backend() -> str:
    """Current pipeline backend setting ("numpy", "jax" or "auto")."""
    return _PIPELINE_BACKEND


# --------------------------------------------------------------------------
# Plain float64 forms of the programs' steps
# --------------------------------------------------------------------------


def _penalty(pen_id, d, e) -> torch.Tensor:
    """Eq. 2 penalty gamma(d, e) selected by a penalty code
    (``utility.PENALTY_CODES``), branchless: every form is computed by
    ``utility.gamma`` (multiply and divide only) and the code's is kept."""
    pen_id = torch.as_tensor(pen_id, device=e.device)
    out = torch.zeros(torch.broadcast_shapes(d.shape, e.shape), dtype=e.dtype, device=e.device)
    for name, code in PENALTY_CODES.items():
        if name != "none":
            out = torch.where(pen_id == code, gamma(name, d, e), out)
    return out


def _touch_residency(res, gid, sizes, cap):
    """Tensor form of ``residency.touch_lru_array`` — ONE LRU slot-vector
    update per model load.  ``res`` is a (K,) id vector (LRU oldest
    first, -1 empty, empties packed at the tail); ``sizes`` maps id ->
    effective bytes and ``cap`` is the byte budget.  Returns (new_res,
    was_resident)."""
    was = bool((res == gid).any())
    removed = (res == gid) | (res < 0)
    order = torch.argsort(removed.to(torch.int8), stable=True)  # keepers first
    lru = torch.where(removed, -1, res)[order]
    lru[int((~removed).sum())] = gid  # gid at the MRU tail
    szs = torch.where(lru >= 0, sizes[lru.clamp(min=0)], 0.0)
    # Eviction only accompanies a load: the host loop evicts entry i iff
    # it is evictable and the total less the evictable bytes before it
    # still exceeds capacity.
    evictable = (lru >= 0) & (lru != gid) & (not was)
    ev = torch.where(evictable, szs, 0.0)
    evict = evictable & (szs.sum() - (torch.cumsum(ev, 0) - ev) > cap)
    keep = (lru >= 0) & ~evict
    return torch.where(keep, lru, -1)[torch.argsort((~keep).to(torch.int8), stable=True)], was


def _sequential_mean(tile, mask, size, axis):
    """Masked member mean in the SCALAR summation order (``s + u * mask``
    member by member, then one divide), as the host paths sum."""
    take = (lambda j: tile[:, j]) if axis == 1 else (lambda j: tile[j])
    s = torch.zeros_like(take(0))
    for j in range(tile.shape[axis]):
        s = s + take(j) * mask[j]
    return s / size


def _chunk_member_mean(tile, mask, size):
    """``_sequential_mean`` with leading chunk axes: the masked member mean
    over axis -2 of a (..., B, M) tile, member by member (masked members
    add exact zeros), so each chunk row reduces bit for bit like the
    sequential step's mean.  ``mask`` is (..., B), ``size`` (...,)."""
    s = torch.zeros_like(tile[..., 0, :])
    for j in range(tile.shape[-2]):
        s = s + tile[..., j, :] * mask[..., j, None]
    return s / size[..., None]


def _spec_select(chunk: int, slot1: bool, t0, res0, sizes, cap: float, acc, mask, deadlines,
                 bsize, lat, step_app, swap, gid, valid, pen, pref,
                 fixed_sel=None) -> torch.Tensor:
    """Speculative chunked selection, plain: the reference's
    ``_spec_select`` (one worker) and ``_spec_select_mw`` (the pool) in
    the (W, B, M) form of ``selection_scan`` (arguments as its wrapper's,
    the seed as tensors).  Returns ``(4, S + 1)`` float64: columns ``:S``
    the scan's rows (worker, model column, start, latency), column ``S``
    ``[rounds, conflicts, 0, 0]``.

    The per-step tables are gathered per position and padded to ``S +
    chunk`` rows (``fastpath.chunk_layout``: inert rows — invalid models,
    deadline and size 1, gid -2).  Each round over positions ``[p, p +
    chunk)``:

      1. SPECULATE — score all ``chunk`` positions against the carry
         FROZEN at the boundary: one (K, W, B, M) Eq. 2 tile, member means
         in member order, the first maximum over each position's
         preference permutation.  ``fixed_sel`` (MaxAcc's carry-free
         choices) skips the scoring.
      2. RECONSTRUCT — the carries the speculated decisions imply, one
         step after the other: ``(t + swap) + lat`` on the chosen worker,
         and the slot1 id or the LRU touch (``_touch_residency``); each
         position keeps its PRE-state.  The chain runs over the real
         positions only: a padded row's state is never read (its
         validation picks column 0 whatever the state) and touching its
         id -2 could overflow a full slot vector.
      3. VALIDATE — re-decide every position under its reconstructed
         carry with a second tile.
      4. ACCEPT — through the first conflict, inclusive (its carry was
         still exact), clamped to the ``S - p`` real positions left; the
         next boundary carry is the last accepted decision applied to its
         pre-state.

    Bit-identical to the sequential scan by induction: an accepted
    position's carry is exact, and its validation decision uses the
    sequential step's float associations, first maximum and residency
    rule."""
    dev = acc.device
    n_total, _, m = acc.shape
    neg_inf = torch.tensor(float("-inf"), dtype=torch.float64, device=dev)
    out = torch.zeros((4, n_total + 1), dtype=torch.float64, device=dev)
    if n_total == 0:
        return out
    _, n_pad = chunk_layout(n_total, chunk)

    def padr(x, value=0):
        pad = torch.full((n_pad - n_total,) + tuple(x.shape[1:]), value, dtype=x.dtype,
                         device=dev)
        return torch.cat([x, pad])

    tabs = {
        "acc": padr(acc), "mask": padr(mask), "dl": padr(deadlines, 1.0),
        "bsize": padr(bsize, 1.0), "lat": padr(lat), "swap": padr(swap[step_app]),
        "gid": padr(gid[step_app], -2), "valid": padr(valid[step_app], False),
        "pen": padr(pen[step_app]), "pref": padr(pref[step_app]),
    }
    if fixed_sel is not None:
        tabs["sel"] = padr(fixed_sel)
    kk = torch.arange(chunk, device=dev)

    def decide(sl, t_st, res_st):
        # (K, W, M) residency, effective swaps and completions under the
        # per-position carries, then the sequential step's pick per row.
        if slot1:
            is_res = res_st[:, :, :1] == sl["gid"][:, None, :]
        else:
            is_res = (res_st[:, :, None, :] == sl["gid"][:, None, :, None]).any(dim=-1)
        swap_eff = torch.where(is_res, 0.0, sl["swap"])
        comp = (t_st[:, :, None] + swap_eff) + sl["lat"]
        if fixed_sel is not None:
            return sl["sel"], comp
        gam = _penalty(sl["pen"][:, None, None, None], sl["dl"][:, None, :, None],
                       comp[:, :, None, :])
        tile = sl["acc"][:, None] * (1.0 - torch.clamp(gam, 0.0, 1.0))  # (K, W, B, M)
        u = _chunk_member_mean(tile, sl["mask"][:, None, :], sl["bsize"][:, None])
        u_flat = torch.where(sl["valid"][:, None, :], u, neg_inf).reshape(chunk, -1)
        idx = torch.argmax(u_flat.gather(1, sl["pref"]), dim=1)
        return sl["pref"].gather(1, idx[:, None])[:, 0], comp

    t = t0.clone()
    res = res0.clone()
    p = rounds = conflicts = 0
    while p < n_total:
        sl = {k: v[p:p + chunk] for k, v in tabs.items()}
        real = min(chunk, n_total - p)

        # 1. Speculate under the frozen boundary carry.
        picks_s, _ = decide(sl, t.expand(chunk, -1), res.expand(chunk, -1, -1))
        wi_s, mi_s = picks_s // m, picks_s % m
        sw_s = sl["swap"][kk, wi_s, mi_s].tolist()
        lt_s = sl["lat"][kk, wi_s, mi_s].tolist()
        g_s = sl["gid"][kk, mi_s].tolist()
        wi_l = wi_s.tolist()

        # 2. Reconstruct each position's pre-state (a host chain of floats:
        # float64 adds in the scan's association).
        tc = t.tolist()
        rc = res.clone()
        t_rows, r_rows = [], []
        for k in range(chunk):
            t_rows.append(list(tc))
            r_rows.append(rc.clone())
            if k + 1 >= real:
                continue
            w = wi_l[k]
            if slot1:
                was = int(rc[w, 0]) == g_s[k]
                rc[w, 0] = g_s[k]
            else:
                rc[w], was = _touch_residency(rc[w], g_s[k], sizes[w], cap)
            tc[w] = (tc[w] + (0.0 if was else sw_s[k])) + lt_s[k]
        t_st = torch.tensor(t_rows, dtype=torch.float64, device=dev)
        res_st = torch.stack(r_rows)

        # 3. Validate under the reconstructed carries.
        picks_t, comp = decide(sl, t_st, res_st)
        wi_t, mi_t = picks_t // m, picks_t % m
        start = t_st[kk, wi_t]
        done = comp[kk, wi_t, mi_t]

        # 4. Accept through the first conflict, inclusive, clamped to the
        # real positions (padded rows always match: column 0 twice).
        mism = picks_t != picks_s
        any_m = bool(mism.any())
        first = int(torch.argmax(mism.to(torch.int8)))
        a = min(first + 1 if any_m else chunk, n_total - p)
        out[0, p:p + a] = wi_t[:a].to(torch.float64)
        out[1, p:p + a] = mi_t[:a].to(torch.float64)
        out[2, p:p + a] = start[:a]
        out[3, p:p + a] = done[:a] - start[:a]

        # The next boundary: the last accepted decision on its pre-state.
        w = int(wi_t[a - 1])
        g = int(sl["gid"][a - 1, int(mi_t[a - 1])])
        t = t_st[a - 1].clone()
        t[w] = done[a - 1]
        res = res_st[a - 1].clone()
        if slot1:
            res[w, 0] = g
        else:
            res[w], _ = _touch_residency(res[w], g, sizes[w], cap)
        p += a
        rounds += 1
        conflicts += int(any_m)
    out[0, n_total] = rounds
    out[1, n_total] = conflicts
    return out


# --------------------------------------------------------------------------
# The three programs
# --------------------------------------------------------------------------


def _scan(res_mode, t0, res0, sizes, cap, acc, mask, deadlines, bsize, lat, step_app,
          swap, gid, valid, pen, pref, fixed_sel=None, chunk: int = 0):
    """One ``selection_scan`` launch — or, with ``chunk`` > 0, one
    ``spec_scan`` launch (the plain versions on the CPU) — and ONE
    read-back: (the stacked (4, S) rows — worker, model, start, latency —,
    ``[rounds, conflicts]`` of the chunked scan or None)."""
    args = (t0, res0, sizes, cap, res_mode, acc, mask, deadlines, bsize, lat, step_app, swap,
            gid, valid, pen, pref, fixed_sel)
    if not chunk:
        from repro_torch.kernels.selection_scan.ops import selection_scan

        return selection_scan(*args).cpu().numpy(), None
    from repro_torch.kernels.spec_scan.ops import spec_scan

    out = spec_scan(*args, chunk=chunk).cpu().numpy()
    return out[:, :-1], out[:2, -1].astype(np.int64)


def _per_request_head(wa: WindowArrays, ordering, selection, data_aware, app_id, tabs):
    """The per-request program's Eq. 9/12 head, for one window: (order,
    the ordered (N, M) accuracy rows in tie-preference column order, the
    ordered rows' application ids, MaxAcc's carry-free choices or None).
    ``app_id`` (N,) host ints index the device ``tabs`` ("swap", "lat1",
    "gid", "valid", "pen", "pref") of ``_window_tables``."""
    dev = wa.device
    acc_mode = "sharpened" if data_aware else "profiled"
    n_total = len(wa.requests)
    m_max = tabs["swap"].shape[1]
    acc = torch.zeros((n_total, m_max), dtype=SCHED_DTYPE, device=dev)
    for name, idx in wa.req_idx.items():
        aa = wa.app_arrays[name]
        acc[wa._tensor(idx), : len(aa.names)] = wa.acc_matrix(name, acc_mode)[
            :, wa._tensor(aa.tie_pref)
        ]
    order = wa.order_indices(ordering, data_aware)
    order_t = wa._tensor(order)
    aid = wa._tensor(app_id)[order_t]
    fixed = None
    if selection == "max_accuracy":
        # Deadline-oblivious whole-window argmax; columns are in tie-
        # preference order, so the first max is the scalar tie-break.
        neg_inf = torch.tensor(float("-inf"), dtype=SCHED_DTYPE, device=dev)
        fixed = torch.argmax(torch.where(tabs["valid"][aid], acc[order_t], neg_inf), dim=1)
    return order, acc[order_t], aid, fixed


def _per_request_program(wa: WindowArrays, ordering, selection, data_aware, res_mode, seed,
                         app_id, tabs, chunk: int = 0):
    """Eq. 9/12 head -> ordering -> Eq. 2/13 scan, for one window.

    ``seed`` is ``_state_seed``'s carry; ``app_id`` and ``tabs`` as
    ``_per_request_head``'s; ``chunk`` > 0 speculates (MaxAcc's carry-free
    choices are the chunked scan's ``fixed_sel``).  Returns (order,
    stacked scan rows, chunk stats or None)."""
    order, acc, aid, fixed = _per_request_head(wa, ordering, selection, data_aware, app_id, tabs)
    n_total = len(wa.requests)
    ones = torch.ones((n_total, 1), dtype=SCHED_DTYPE, device=wa.device)
    t0, res0, sizes, cap = seed
    out, stats = _scan(
        res_mode, t0, res0, sizes, cap, acc[:, None, :], ones,
        wa.deadlines_t[wa._tensor(order)][:, None], ones[:, 0], tabs["lat1"][aid][:, None, :],
        aid, tabs["swap"][:, None, :], tabs["gid"], tabs["valid"], tabs["pen"], tabs["pref"],
        fixed, chunk=chunk,
    )
    return order, out, stats


def _grouped_program(res_mode, seed, acc, member_mask, deadlines, sizes, lat_tab, step_app,
                     tabs, chunk: int = 0):
    """The scan over ordered groups: one greedy Eq. 13 tile per step.  The
    (G, B_max, M) accuracies are in tie-preference column order and
    ``lat_tab`` (G, M) is the host's l(m, b) per group; ``step_app`` (G,)
    indexes each group's application in the per-app ``tabs`` of
    ``_window_tables`` ("swap", "gid", "valid", "pen", "pref"), as the
    per-request program does; ``chunk`` > 0 speculates.  Returns (the
    stacked scan rows, chunk stats or None)."""
    t0, res0, gsizes, cap = seed
    return _scan(res_mode, t0, res0, gsizes, cap, acc, member_mask, deadlines, sizes,
                 lat_tab[:, None, :], step_app, tabs["swap"][:, None, :], tabs["gid"],
                 tabs["valid"], tabs["pen"], tabs["pref"], chunk=chunk)


def _member_rows(ordered_groups, member_idx, pad: int) -> np.ndarray:
    """(G, B_max) window rows of each group's members, padded with ``pad``."""
    b_max = max(len(members) for _, members in ordered_groups)
    rows = np.full((len(ordered_groups), b_max), pad, dtype=np.int64)
    for gi, (key, _) in enumerate(ordered_groups):
        idx = member_idx[key]
        rows[gi, : len(idx)] = idx
    return rows


def _group_tensors(wa: WindowArrays, ordered_groups, member_idx, acc_mode, m_max,
                   pref_order: bool):
    """The padded group tensors on the device: (G, B_max, M) accuracies
    (tie-preference column order when ``pref_order``), (G, B_max) member
    masks and deadlines (padded members: accuracy 0, deadline 1.0), and
    the (G,) member counts as float64."""
    dev = wa.device
    n = len(wa.requests)
    rows = _member_rows(ordered_groups, member_idx, pad=n)
    acc_w = torch.zeros((n + 1, m_max), dtype=SCHED_DTYPE, device=dev)
    for name, idx in wa.req_idx.items():
        aa = wa.app_arrays[name]
        A = wa.acc_matrix(name, acc_mode)
        if pref_order:
            A = A[:, wa._tensor(aa.tie_pref)]
        acc_w[wa._tensor(idx), : len(aa.names)] = A
    rows_t = wa._tensor(rows)
    counts = (rows < n).sum(axis=1).astype(np.float64)
    return (
        acc_w[rows_t],
        (rows_t < n).to(SCHED_DTYPE),
        torch.as_tensor(np.append(wa.deadlines, 1.0)[rows], dtype=SCHED_DTYPE, device=dev),
        torch.as_tensor(counts, dtype=SCHED_DTYPE, device=dev),
    )


# --------------------------------------------------------------------------
# WindowPipeline
# --------------------------------------------------------------------------


class WindowPipeline:
    """Fused window data plane for one (apps, policy) configuration.

    ``run`` executes the full pipeline (ingest + schedule); ``schedule``
    assumes evidence/theta are already attached (streaming callers run
    the stochastic ingest exactly once per request).  The tables live in
    a module-level cache, so holding one pipeline per ``Simulation`` or
    ``EdgeServer`` reuses them across windows.
    """

    def __init__(
        self,
        apps: Mapping[str, Application],
        sneakpeeks=None,
        policy=None,
        backend: str | None = None,
        workers=None,
        chunk: int | None = None,
        *,
        device=None,
    ):
        """``workers`` (a sequence of ``multiworker.Worker``) switches the
        pipeline to the compiled Eq. 15 placement program: grouping,
        data-awareness and label-splitting come from the policy,
        placement from the (worker, model) utility tiles.

        ``chunk`` > 0 turns on speculative chunked selection (speculate-K/
        validate/fallback rounds instead of the sequential scan, one
        ``spec_scan`` launch per window; bit-identical decisions,
        ``last_chunk_stats`` reports the conflict rate); ``None`` defers
        to the policy's ``chunk`` field, 0 forces the sequential scan.
        ``device`` is where ingest, the heads and the scan run (the card
        unless ``"cpu"`` is named)."""
        self.apps = apps
        self.sneakpeeks = sneakpeeks or {}
        self.policy = policy
        if backend is not None and backend not in ("auto", "jax", "numpy"):
            raise ValueError(f"unknown pipeline backend {backend!r}")
        self.backend = backend
        self.workers = list(workers) if workers else None
        if chunk is not None and int(chunk) < 0:
            raise ValueError(f"chunk must be >= 0, got {chunk}")
        self.chunk = chunk
        self.device = resolve_device(device)
        # Speculation stats of the LAST chunked schedule (None when the
        # sequential scan or the numpy backend ran): chunk, decisions,
        # rounds, conflicts, conflict_rate.
        self.last_chunk_stats: dict | None = None

    def _chunk_of(self, policy) -> int:
        c = self.chunk if self.chunk is not None else getattr(policy, "chunk", 0)
        c = int(c or 0)
        if c < 0:
            raise ValueError(f"chunk must be >= 0, got {c}")
        return c

    def _record_chunk_stats(self, chunk: int, decisions: int, stats) -> None:
        if stats is None:
            return
        rounds, conflicts = (int(x) for x in stats)
        self.last_chunk_stats = {
            "chunk": int(chunk),
            "decisions": int(decisions),
            "rounds": rounds,
            "conflicts": conflicts,
            "conflict_rate": conflicts / rounds if rounds else 0.0,
        }

    def resolved_backend(self) -> str:
        """The route this pipeline takes: "jax" (the compiled programs on
        the pipeline's device) or "numpy" (the port's fast path)."""
        b = self.backend or _PIPELINE_BACKEND
        return "jax" if b == "auto" else b

    # -- stages ------------------------------------------------------------
    def ingest(self, requests: Sequence[Request]) -> None:
        """Batched SneakPeek stage (evidence + Dirichlet posterior)."""
        if self.sneakpeeks:
            ingest_window(requests, self.apps, self.sneakpeeks, device=self.device)

    def run(self, requests: Sequence[Request], now: float, policy=None, state=None) -> Schedule:
        """Full window pass: ingest then schedule."""
        self.ingest(requests)
        return self.schedule(requests, now, policy=policy, state=state)

    # -- scheduling --------------------------------------------------------
    def schedule(
        self,
        requests: Sequence[Request],
        now: float,
        policy=None,
        state=None,
        arrays: WindowArrays | None = None,
        workers=None,
        lat_scale=None,
        worker_mask=None,
    ) -> Schedule:
        """Schedule one window through the compiled programs (decision-
        identical to the fast path, which the "numpy" backend runs).
        ``state`` seeds carried backlog/residency; ``workers`` routes
        through the Eq. 15 placement program.  ``lat_scale`` ({(wid,
        model): s} drift corrections) multiplies its latency tables and
        ``worker_mask`` (a wid set) drops quarantined workers before the
        tables are built — both multi-worker only."""
        policy = policy if policy is not None else self.policy
        if policy is None:
            raise ValueError("WindowPipeline needs a policy (init arg or call arg)")
        workers = workers if workers is not None else self.workers
        t0 = time.perf_counter()
        self.last_chunk_stats = None
        if not requests:
            return Schedule()
        if (lat_scale or worker_mask is not None) and not workers:
            raise ValueError("lat_scale/worker_mask require a multi-worker pipeline")
        if arrays is not None and arrays.device != self.device:
            raise ValueError(f"arrays are on {arrays.device}, the pipeline on {self.device}")
        backend = self.resolved_backend()
        if workers:
            if worker_mask is not None:
                workers = [w for w in workers if w.wid in worker_mask]
                if not workers:
                    raise ValueError("worker_mask excludes every worker")
            if backend == "numpy":
                sched = fast_multiworker_schedule(
                    requests, self.apps, workers, now,
                    data_aware=policy.data_aware, split_by_label=policy.split_by_label,
                    per_request=not policy.grouped, arrays=arrays, state=state,
                    lat_scale=lat_scale, device=self.device,
                )
            else:
                sched = self._schedule_multiworker(
                    policy, requests, now, workers, state, arrays, lat_scale
                )
        elif backend == "numpy":
            sched = self._schedule_numpy(policy, requests, now, state, arrays)
        elif policy.grouped:
            sched = self._schedule_grouped(policy, requests, now, state, arrays)
        else:
            sched = self._schedule_per_request(policy, requests, now, state, arrays)
        sched.chunk_stats = self.last_chunk_stats
        sched.scheduling_overhead_s = time.perf_counter() - t0
        return sched

    def _schedule_numpy(self, policy, requests, now, state, arrays):
        if policy.grouped:
            return fast_grouped_schedule(
                requests, self.apps, now, tau=policy.tau, data_aware=policy.data_aware,
                split_by_label=policy.split_by_label, arrays=arrays, state=state,
                device=self.device,
            )
        return fast_per_request_schedule(
            requests, self.apps, now, ordering=policy.ordering, selection=policy.selection,
            data_aware=policy.data_aware, arrays=arrays, state=state, device=self.device,
        )

    def _state_seed(self, wa: WindowArrays, state, now: float):
        """Array-encoded single-worker seed for the scans: ((t0, residency
        carry, effective sizes, capacity), res_mode).  The ``PoolArrays``
        encoding the Eq. 15 path uses, restricted to worker 0, the
        capacity-``None`` single-slot folding included.  "slot1" carries
        one id, "lru" the slot vector."""
        from repro_torch.core.multiworker import Worker

        pool = PoolArrays.build([Worker(0)], wa, state=state, now=now)
        res_mode = pool.res_mode(state)
        res0 = pool.res[:, :1] if res_mode == "slot1" else pool.res
        return (pool.t, res0, pool.sizes, float(pool.capacity)), res_mode

    def _global_ids(self, wa: WindowArrays) -> dict[str, int]:
        """Residency ids by model NAME (the timelines' residency key)."""
        gids: dict[str, int] = {}
        for app_name in wa.req_idx:
            for name in wa.app_arrays[app_name].names:
                gids.setdefault(name, len(gids))
        return gids

    @staticmethod
    def _cached(key, build):
        ent = _TABLES.get(key)
        if ent is not None:
            _TABLES[key] = _TABLES.pop(key)  # LRU touch
            return ent
        ent = _TABLES[key] = build()
        while len(_TABLES) > _TABLES_MAX:
            _TABLES.pop(next(iter(_TABLES)))
        return ent

    def _window_tables(self, wa: WindowArrays):
        """Window-independent per-app model tables (tie-pref order) and
        their device copies, cached across windows with the same
        application set."""
        app_names = list(wa.req_idx)
        aas = [wa.app_arrays[n] for n in app_names]

        def build():
            gids = self._global_ids(wa)
            n_apps = len(app_names)
            m_max = max(len(a.names) for a in aas)
            swap_tab = np.zeros((n_apps, m_max))
            lat1_tab = np.zeros((n_apps, m_max))
            gid_tab = np.full((n_apps, m_max), -2, dtype=np.int64)  # -2: never resident
            valid_tab = np.zeros((n_apps, m_max), dtype=bool)
            pen_tab = np.zeros(n_apps, dtype=np.int64)
            pref_tab = np.zeros((n_apps, m_max), dtype=np.int64)
            for ai, aa in enumerate(aas):
                pref = aa.tie_pref
                m = len(aa.names)
                swap_tab[ai, :m] = aa.swap[pref]
                lat1_tab[ai, :m] = aa.lat1[pref]
                gid_tab[ai, :m] = [gids[aa.names[int(i)]] for i in pref]
                valid_tab[ai, :m] = True
                pen_tab[ai] = PENALTY_CODES[aa.app.penalty]
                pref_tab[ai, :m] = pref
            dev = wa.device
            return {
                "pin": aas,  # strong refs keep the id key sound
                "app_names": app_names,
                "pref": pref_tab,
                "dev": {
                    "swap": torch.as_tensor(swap_tab, device=dev),
                    "lat1": torch.as_tensor(lat1_tab, device=dev),
                    "gid": torch.as_tensor(gid_tab, device=dev),
                    "valid": torch.as_tensor(valid_tab, device=dev),
                    "pen": torch.as_tensor(pen_tab, device=dev),
                    # Columns are already in tie-preference order.
                    "pref": torch.arange(m_max, device=dev).expand(n_apps, m_max).contiguous(),
                },
            }

        return self._cached(tuple(id(a) for a in aas), build)

    def _mw_tables(self, wa: WindowArrays, workers, pool: PoolArrays):
        """Pool-scaled per-app model tables for the Eq. 15 program —
        (A, W, M_max) latency/swap tiles plus the flattened tie-break
        preference permutations — cached per (application set, pool
        signature, drift scales).  The per-app tables come from
        ``PoolArrays.app_table``, so the scaling and the tie-break have
        one definition, shared with the fast path."""
        app_names = list(wa.req_idx)
        aas = [wa.app_arrays[n] for n in app_names]
        scale_key = (
            tuple(sorted((wid, name, float(s)) for (wid, name), s in pool.lat_scale.items()))
            if pool.lat_scale else None
        )
        key = (
            "mw",
            tuple(id(a) for a in aas),
            tuple((w.wid, w.speed, w.load_scale) for w in workers),
            scale_key,
        )

        def build():
            n_apps = len(app_names)
            n_w = len(workers)
            m_max = max(len(a.names) for a in aas)
            speeds = np.array([w.speed for w in workers])
            slat_fixed = np.zeros((n_apps, n_w, m_max))
            slat_item = np.zeros((n_apps, n_w, m_max))
            sswap = np.zeros((n_apps, n_w, m_max))
            gid_tab = np.full((n_apps, m_max), -2, dtype=np.int64)  # -2: never resident
            valid_tab = np.zeros((n_apps, m_max), dtype=bool)
            pen_tab = np.zeros(n_apps, dtype=np.int64)
            pref_tab = np.zeros((n_apps, n_w * m_max), dtype=np.int64)
            for ai, name in enumerate(app_names):
                aa, a_fixed, a_item, a_swap, _pref, gid_row = pool.app_table(wa, name)
                m = len(aa.names)
                slat_fixed[ai, :, :m] = a_fixed
                slat_item[ai, :, :m] = a_item
                sswap[ai, :, :m] = a_swap
                gid_tab[ai, :m] = gid_row
                valid_tab[ai, :m] = True
                pen_tab[ai] = PENALTY_CODES[aa.app.penalty]
                # The shared Eq. 15 tie-break permutation, padded to m_max
                # and ranked by the drift-corrected latencies of app_table.
                pref_tab[ai] = placement_pref(
                    aa.names, aa.latency_s, speeds, pool.wids, pad_to=m_max,
                    scale=pool.scale_matrix(aa),
                )
            dev = wa.device
            return {
                "pin": aas,  # strong refs keep the id key sound
                "app_names": app_names,
                "m_max": m_max,
                "slat_fixed": slat_fixed,
                "slat_item": slat_item,
                "dev": {
                    "sswap": torch.as_tensor(sswap, device=dev),
                    "gid": torch.as_tensor(gid_tab, device=dev),
                    "valid": torch.as_tensor(valid_tab, device=dev),
                    "pen": torch.as_tensor(pen_tab, device=dev),
                    "pref": torch.as_tensor(pref_tab, device=dev),
                },
            }

        return self._cached(key, build)

    def _window_arrays(self, requests, now, arrays):
        return arrays if arrays is not None else WindowArrays(
            requests, self.apps, now, self.device
        )

    # -- multi-worker --------------------------------------------------------
    def _mw_setup(self, policy, requests, now, workers, state, arrays, lat_scale=None):
        """Host-side half of the Eq. 15 path: grouping, ordering, the pool
        encoding and the padded group tensors — everything up to the
        placement scan."""
        from repro_torch.core.grouping import group_by_app, split_groups_by_label

        acc_mode = "sharpened" if policy.data_aware else "profiled"
        if not policy.grouped:
            groups = {f"r{r.rid}": [r] for r in requests}
        else:
            groups = group_by_app(requests)
            if policy.split_by_label:
                groups = split_groups_by_label(groups, self.apps)
        wa = self._window_arrays(requests, now, arrays)
        prio = wa.priorities(policy.data_aware)
        member_idx = {key: wa.rows_of(members) for key, members in groups.items()}
        gp = {key: float(np.mean(prio[member_idx[key]])) for key in groups}  # Eq. 14
        # The fast path's multi-worker ordering rule, shared verbatim.
        ordered_groups = ordered_group_items(groups, gp, split_by_label=False)

        pool = PoolArrays.build(workers, wa, state=state, now=now, lat_scale=lat_scale)
        tab = self._mw_tables(wa, workers, pool)
        app_pos = {name: ai for ai, name in enumerate(tab["app_names"])}
        n_groups = len(ordered_groups)
        app_id = np.zeros(n_groups, dtype=np.int64)
        lat_tab = np.zeros((n_groups, len(workers), tab["m_max"]))
        for gi, (key, members) in enumerate(ordered_groups):
            ai = app_pos[members[0].app]
            app_id[gi] = ai
            # Scaled l(m, b) for this group, on the host, so the scan's
            # completions match the fast path bit for bit.
            lat_tab[gi] = tab["slat_fixed"][ai] + tab["slat_item"][ai] * len(members)
        acc, member_mask, deadlines, bsizes = _group_tensors(
            wa, ordered_groups, member_idx, acc_mode, tab["m_max"], pref_order=False
        )
        return {
            "wa": wa, "prio": prio, "member_idx": member_idx,
            "ordered_groups": ordered_groups, "pool": pool, "tab": tab,
            "acc": acc, "member_mask": member_mask, "deadlines": deadlines,
            "bsizes": bsizes, "app_id": wa._tensor(app_id),
            "lat_tab": torch.as_tensor(lat_tab, device=wa.device),
        }

    def _mw_emit(self, setup, workers, wsel, sel, starts, lats):
        """Host-side emit of the Eq. 15 path: per-worker order counters and
        the fast path's member ordering rule, from the scan's outputs."""
        wa = setup["wa"]
        prio = setup["prio"]
        member_idx = setup["member_idx"]
        orders = {w.wid: 1 for w in workers}
        entries = []
        for gi, (key, members) in enumerate(setup["ordered_groups"]):
            aa = wa.app_arrays[members[0].app]
            idx = member_idx[key]
            w = workers[int(wsel[gi])]
            model = aa.names[int(sel[gi])]
            member_order = np.lexsort((wa.rids[idx], -prio[idx]))
            for j in member_order:
                entries.append(
                    ScheduleEntry(
                        request=wa.requests[int(idx[int(j)])],
                        model=model,
                        order=orders[w.wid],
                        worker=w.wid,
                        batch_id=gi,
                        est_start_s=float(starts[gi]),
                        est_latency_s=float(lats[gi]),
                    )
                )
                orders[w.wid] += 1
        sched = Schedule(entries=entries)
        sched.validate()
        return sched

    def _schedule_multiworker(self, policy, requests, now, workers, state, arrays,
                              lat_scale=None):
        setup = self._mw_setup(policy, requests, now, workers, state, arrays, lat_scale)
        pool, dt = setup["pool"], setup["tab"]["dev"]
        res_mode = pool.res_mode(state)
        res0 = pool.res[:, :1] if res_mode == "slot1" else pool.res
        # The reference's _multiworker_program: the scan over the priority-
        # ordered groups scoring the full (worker, model) tile, with the
        # first maximum over the Eq. 15 preference permutation (the tie-
        # break (u, -scaled latency, name, -wid)), threading per-worker
        # queue tails and residency; lat_tab (G, W, M) is the host's
        # scaled l(m, b) per group.
        # ``chunk`` > 0: the reference's _spec_select_mw, rounds over the
        # pool carry with (K, W, B, M) tiles.
        chunk = self._chunk_of(policy)
        out, stats = _scan(
            res_mode, pool.t, res0, pool.sizes, float(pool.capacity), setup["acc"],
            setup["member_mask"], setup["deadlines"], setup["bsizes"], setup["lat_tab"],
            setup["app_id"], dt["sswap"], dt["gid"], dt["valid"], dt["pen"], dt["pref"],
            chunk=chunk,
        )
        self._record_chunk_stats(chunk, len(setup["ordered_groups"]), stats)
        return self._mw_emit(setup, workers, out[0].astype(np.int64),
                             out[1].astype(np.int64), out[2], out[3])

    # -- single worker -------------------------------------------------------
    def _schedule_per_request(self, policy, requests, now, state, arrays):
        if policy.selection not in ("locally_optimal", "max_accuracy"):
            raise ValueError(f"unknown selection {policy.selection!r}")
        if policy.ordering not in ("fcfs", "edf", "priority"):
            raise ValueError(f"unknown ordering {policy.ordering!r}")
        wa = self._window_arrays(requests, now, arrays)
        tab = self._window_tables(wa)
        app_id = np.zeros(len(wa.requests), dtype=np.int64)
        for ai, name in enumerate(tab["app_names"]):
            app_id[wa.req_idx[name]] = ai
        seed, res_mode = self._state_seed(wa, state, now)
        chunk = self._chunk_of(policy)
        order, out, stats = _per_request_program(
            wa, policy.ordering, policy.selection, bool(policy.data_aware), res_mode, seed,
            app_id, tab["dev"], chunk,
        )
        self._record_chunk_stats(chunk, len(wa.requests), stats)
        return self._per_request_emit(wa, tab, app_id, order, out[1].astype(np.int64), out[2],
                                      out[3])

    def _per_request_emit(self, wa, tab, app_id, order, sel, starts, lats):
        """Host-side emit of the per-request path: one entry per request in
        the window's order, model names through the tie-pref permutation."""
        local = tab["pref"][app_id[order], sel]
        # Host assembly off bulk tolist(): this loop runs once per request.
        order_l = order.tolist()
        local_l = local.tolist()
        starts_l = np.asarray(starts).tolist()
        lats_l = np.asarray(lats).tolist()
        reqs = wa.requests
        app_of = wa.app_of
        names = {name: wa.app_arrays[name].names for name in wa.req_idx}
        # Positional construction: (request, model, order, worker,
        # batch_id, est_start_s, est_latency_s).
        entries = [
            ScheduleEntry(reqs[g], names[app_of[g]][local_l[k]], k + 1, 0, -1,
                          starts_l[k], lats_l[k])
            for k, g in enumerate(order_l)
        ]
        sched = Schedule(entries=entries)
        sched.validate()
        return sched

    def _grouped_setup(self, policy, requests, now, state, arrays):
        """Host-side half of the grouped path: grouping, the brute-force
        branch (returned as ``{"sched": ...}`` when it applies), ordering,
        the padded group tensors and the carry seed."""
        from repro_torch.core.bruteforce import brute_force_groups
        from repro_torch.core.evaluation import WorkerTimeline
        from repro_torch.core.grouping import group_by_app, split_groups_by_label

        acc_mode = "sharpened" if policy.data_aware else "profiled"
        groups = group_by_app(requests)
        if policy.split_by_label:
            groups = split_groups_by_label(groups, self.apps)
        if arrays is not None:
            wa = arrays
        else:
            # The stacked Eq. 9/12 program on the pipeline's device.
            (wa,) = precompute_windows(
                [(list(requests), now)], self.apps, data_aware=policy.data_aware,
                backend="jax", device=self.device,
            )
        if len(groups) <= policy.tau:
            if state is not None:
                tl = state.peek_timeline(0).clone()
                tl.advance(now)
            else:
                tl = WorkerTimeline(now)
            try:
                sched = brute_force_groups(
                    groups, self.apps, now, acc_mode=acc_mode, arrays=wa, timeline=tl
                )
                return {"sched": sched}
            except ValueError:
                pass  # too many candidates; fall through to the greedy scan

        prio = wa.priorities(policy.data_aware)
        member_idx = {key: wa.rows_of(members) for key, members in groups.items()}
        gp = {key: float(np.mean(prio[member_idx[key]])) for key in groups}  # Eq. 14
        ordered_groups = ordered_group_items(groups, gp, policy.split_by_label)

        tab = self._window_tables(wa)
        app_pos = {name: ai for ai, name in enumerate(tab["app_names"])}
        m_max = tab["dev"]["swap"].shape[1]
        app_id = np.zeros(len(ordered_groups), dtype=np.int64)
        lat_tab = np.zeros((len(ordered_groups), m_max))
        for gi, (key, members) in enumerate(ordered_groups):
            aa = wa.app_arrays[members[0].app]
            app_id[gi] = app_pos[members[0].app]
            # Host-precomputed l(m, b) (batch_latency association).
            lat_tab[gi, : len(aa.names)] = (aa.lat_fixed + aa.lat_item * len(members))[
                aa.tie_pref
            ]
        acc, member_mask, deadlines, sizes = _group_tensors(
            wa, ordered_groups, member_idx, acc_mode, m_max, pref_order=True
        )
        seed, res_mode = self._state_seed(wa, state, now)
        return {
            "sched": None, "wa": wa, "prio": prio, "member_idx": member_idx,
            "ordered_groups": ordered_groups, "seed": seed, "res_mode": res_mode,
            "acc": acc, "member_mask": member_mask, "deadlines": deadlines, "sizes": sizes,
            "app_id": app_id, "lat_tab": torch.as_tensor(lat_tab, device=wa.device),
            "tab": tab,
        }

    def _grouped_emit(self, setup, sel, starts, lats):
        """Host-side emit of the grouped path (single global order
        counter, model names through the tie-pref permutation)."""
        wa = setup["wa"]
        prio = setup["prio"]
        member_idx = setup["member_idx"]
        pref = setup["tab"]["pref"]
        app_id = setup["app_id"]
        entries = []
        order = 1
        for gi, (key, members) in enumerate(setup["ordered_groups"]):
            aa = wa.app_arrays[members[0].app]
            idx = member_idx[key]
            model = aa.names[int(pref[app_id[gi], int(sel[gi])])]
            member_order = np.lexsort((wa.rids[idx], -prio[idx]))
            for j in member_order:
                entries.append(
                    ScheduleEntry(
                        request=wa.requests[int(idx[int(j)])],
                        model=model,
                        order=order,
                        batch_id=gi,
                        est_start_s=float(starts[gi]),
                        est_latency_s=float(lats[gi]),
                    )
                )
                order += 1
        sched = Schedule(entries=entries)
        sched.validate()
        return sched

    def _schedule_grouped(self, policy, requests, now, state, arrays):
        setup = self._grouped_setup(policy, requests, now, state, arrays)
        if setup.get("sched") is not None:  # brute-force branch (<= tau)
            return setup["sched"]
        chunk = self._chunk_of(policy)
        out, stats = _grouped_program(
            setup["res_mode"], setup["seed"], setup["acc"], setup["member_mask"],
            setup["deadlines"], setup["sizes"], setup["lat_tab"],
            setup["wa"]._tensor(setup["app_id"]), setup["tab"]["dev"], chunk,
        )
        self._record_chunk_stats(chunk, len(setup["ordered_groups"]), stats)
        return self._grouped_emit(setup, out[1].astype(np.int64), out[2], out[3])


def pipeline_schedule(
    policy,
    requests: Sequence[Request],
    apps: Mapping[str, Application],
    now: float,
    state=None,
    arrays: WindowArrays | None = None,
    backend: str | None = None,
    workers=None,
    lat_scale=None,
    worker_mask=None,
    chunk: int | None = None,
    shard=None,
    *,
    device=None,
) -> Schedule:
    """One pipelined window pass for ``SchedulerPolicy.schedule`` and
    ``schedule_window`` (``workers`` selects the Eq. 15 placement program;
    ``lat_scale``/``worker_mask`` the closed loop's drift corrections and
    health masking, multi-worker only; ``chunk`` overrides the policy's
    speculative chunked selection size).  ``shard`` (or the policy's
    field) routes through ``core.shard.ShardedWindowPipeline``
    (bit-identical decisions)."""
    shard = shard if shard is not None else getattr(policy, "shard", False)
    if shard:
        from repro_torch.core.shard import ShardedWindowPipeline

        pipe = ShardedWindowPipeline(apps, policy=policy, backend=backend, workers=workers,
                                     chunk=chunk, shard=shard, device=device)
    else:
        pipe = WindowPipeline(apps, policy=policy, backend=backend, workers=workers,
                              chunk=chunk, device=device)
    return pipe.schedule(requests, now, state=state, arrays=arrays, lat_scale=lat_scale,
                         worker_mask=worker_mask)
