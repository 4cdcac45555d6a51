"""Sharded window scheduling: the compiled pipeline's tiles split across shards.

The port of ``repro.core.shard``.  ``ShardedWindowPipeline`` cuts a
window's decision tables into one block per shard and scores each block
on its shard's device, resolving every global decision by exact
comparisons, while keeping each decision BIT-IDENTICAL to the unsharded
pipeline.  The split follows what float arithmetic allows, as the
reference's does:

  * **Elementwise tile phases shard.**  The Eq. 2/13 tiles of the
    single-worker selectors are split by request (or group) rows, the
    Eq. 15 (worker, batch, model) tiles by workers.  A shard computes
    exactly the rows the unsharded scan would, with the same per-row
    float associations (the ``shard_round`` kernel scores a row with the
    selection scan's own step), so cutting the axis changes no bit.
  * **Eq. 9 is never split.**  The accuracy rows come from the
    per-request head (``pipeline._per_request_head``) and the grouped and
    pooled setups, once, on one device, at the unsharded shape: a BLAS
    product rounds a row by how many rows it is given.
  * **Picks reduce exactly.**  Within a block the kernel takes each row's
    maximum utility and, among equal ones, the least tie-break rank; across
    blocks the maximum value, then the least rank among the shards holding
    it (``_pick_allreduce``).  Eq. 15 ranks are the inverse
    ``placement_pref`` permutation, so they are globally unique.  The
    picking shard's swap and latency are copied from it
    (``_owner_bcast``), never recomputed elsewhere.
  * **The carry chain is shared.**  Queue tails and residency are
    sequential: the rounds speculate rows against the carry frozen at the
    round's start, rebuild the carries the speculated picks imply (the
    kernel's ``chain``, from the gathered picks), validate every row under
    its carry and accept through the first conflict (the kernel's
    ``accept``, which also moves the carry and the position).
    With ``chunk=K`` a round accepts at most K decisions (the unsharded
    chunked scan's rounds and conflicts); with ``chunk=0`` one round
    speculates the whole remaining window, so the rounds and conflicts
    are the reference's sharded ones.  The sequential Eq. 15 placement
    (``chunk=0`` on a pool) takes one step per group.

One controller drives every shard: each shard's blocks are tensors on that
shard's device, "all-gather" is each shard writing the rows it holds
into the first shard's buffers (copied there from another device) and
"pmax"/"pmin" are maxima and minima over the stacked per-shard values.
The round's position, the carry and the rounds and conflicts stay in
tensors on the first shard's device: every launch reads the position
there and does nothing once the window is decided, so the host enqueues
the rounds a window needs if none conflicts, reads the position back
once, and repeats (``last_read_backs`` counts the reads).  When every
shard's block is on one card, a round is captured as a CUDA graph after
its first run and replayed.  Copies between devices move exact bits and the
reductions only compare, so the exchange cannot change a decision; no
process group is involved, and the entry points are called as the
reference's are.  A round scores only the rows it can accept (the
reference's blocks also score rows outside the round and discard them);
rows padded up to a shard multiple are never scored, and padded workers
are masked (``-inf`` utility, rank ``RANK_INF``): they never win.

``shard=True`` uses every device of the pipeline's kind (the CUDA
devices, or one CPU); ``shard=N`` uses N and raises beyond them.
``force_shard_devices(n)`` lets n shard blocks share the pipeline's
device, the counterpart of the reference's forced host devices (ROADMAP
§3, P9).  One shard, or the numpy backend, delegates every schedule
verbatim to ``WindowPipeline``: the same launches and table-cache keys.
Wire-up: ``make_policy(name, shard=...)``, ``pipeline_schedule(shard=)``,
``Simulation(shard=)``, ``EdgeServer(shard=)``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.core.pipeline import WindowPipeline, _per_request_head
from repro_torch.device import SCHED_DTYPE, resolve_device
from repro_torch.kernels.selection_scan.ops import _seed
from repro_torch.kernels.shard_round.ops import RANK_INF, accept, chain, score_block

__all__ = [
    "ShardedWindowPipeline",
    "force_shard_devices",
    "resolve_num_shards",
    "shard_mesh",
    "row_specs",
    "pad_rows",
]

# Shard blocks that share one device (``force_shard_devices``); None: one
# block per device of the resolved kind.
_FORCED: int | None = None


def force_shard_devices(n: int | None) -> int | None:
    """Let ``n`` shard blocks share the pipeline's device (the CPU tests
    and the card's single-device runs), or restore one block per device
    (``None``).  Returns the previous setting.  The counterpart of the
    reference's ``--xla_force_host_platform_device_count`` (ROADMAP §3,
    P9): the blocks then run one after the other on that device."""
    global _FORCED
    if n is not None and int(n) < 1:
        raise ValueError(f"forced shard devices must be >= 1, got {n}")
    prev = _FORCED
    _FORCED = None if n is None else int(n)
    return prev


def pad_rows(n: int, shards: int) -> int:
    """Rows after padding ``n`` up to a multiple of ``shards`` (>= 1 row
    per shard, so every shard holds a block even for tiny windows)."""
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    blocks = max(1, -(-n // shards))
    return blocks * shards


def _available(device) -> int:
    if _FORCED is not None:
        return _FORCED
    dev = resolve_device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def resolve_num_shards(shard, device=None) -> int:
    """Resolve the ``shard`` flag (bool | int) to a shard count on the
    devices of ``device``'s kind: True takes them all, N takes N and
    raises beyond them."""
    if shard is True:
        return _available(device)
    n = int(shard)
    if n < 0:
        raise ValueError(f"shard must be True or >= 0, got {shard}")
    if n > 1:
        avail = _available(device)
        if n > avail:
            raise ValueError(
                f"shard={n} exceeds the {avail} available device(s) (call "
                f"repro_torch.core.shard.force_shard_devices({n}) to run {n} shard blocks "
                "on one device; ROADMAP §3, P9)"
            )
    return max(n, 1)


def shard_mesh(num_shards: int, device=None) -> list[torch.device]:
    """The devices of the 1-D scheduling mesh, one per shard: the first N
    CUDA devices, or ``device`` N times under ``force_shard_devices``."""
    dev = resolve_device(device)
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if num_shards == 1 or _FORCED is not None:
        return [dev] * num_shards
    if dev.type != "cuda" or num_shards > torch.cuda.device_count():
        raise ValueError(f"no {num_shards} devices of {dev}'s kind")
    return [torch.device("cuda", i) for i in range(num_shards)]


def row_specs(mesh, shapes: dict, axis: dict | None = None) -> dict:
    """Which dim of each decision table the mesh splits: ``axis`` names it
    per table (default 0; ``None`` replicates), and a dim the shard count
    does not divide is replicated, the distribution layer's rule
    (``src/repro/distributed/sharding.py:78``).  {name: dim or None}."""
    n = len(mesh)
    specs = {}
    for name, shape in shapes.items():
        dim = (axis or {}).get(name, 0)
        ok = dim is not None and dim < len(shape) and shape[dim] % n == 0
        specs[name] = dim if ok else None
    return specs


def _place(mesh, tabs: dict, specs: dict) -> list[dict]:
    """Each shard's blocks of the tables, on its device: a table with a
    split dim is cut into equal contiguous blocks, the others copied."""
    n = len(mesh)
    blocks = [{} for _ in mesh]
    for name, x in tabs.items():
        dim = specs[name]
        for s, dev in enumerate(mesh):
            part = x if dim is None else x.narrow(dim, s * (x.shape[dim] // n),
                                                  x.shape[dim] // n)
            blocks[s][name] = part.to(dev).contiguous()
    return blocks


def _pad(x, rows: int, value=0):
    """``x`` padded along dim 0 to ``rows`` with ``value``."""
    if x.shape[0] == rows:
        return x
    pad = torch.full((rows - x.shape[0],) + tuple(x.shape[1:]), value, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad])


def _pick_allreduce(ub, rb):
    """The exact global first maximum from each shard's block pick ((N,
    ...) utilities and ranks, the kernel's local maximum and least rank
    among its ties): the maximum value, then the least rank among the
    shards that hold it.  Comparisons only."""
    u_star = ub.amax(dim=0)
    return torch.where(ub == u_star, rb, RANK_INF).amin(dim=0)


def _owner_bcast(mine, val):
    """The picking shard's value, copied exactly: the maximum over shards
    of the owner's value against -inf fillers."""
    return torch.where(mine, val, float("-inf")).amax(dim=0)


# --------------------------------------------------------------------------
# The rounds: speculate, rebuild, validate, accept
# --------------------------------------------------------------------------


# Rounds a batch must still hold for its rounds to be captured as a CUDA
# graph (one eager round first, then the capture): a capture costs about
# what a few eager rounds' launches do.
GRAPH_MIN_ROUNDS = 4


def _capture(one_round, dev):
    """A CUDA graph of ``one_round`` on ``dev`` (captured on a side stream
    in thread-local mode, as ``serving.backends.DecodeGraph`` does) and the
    launches one replay makes, taken back off the counts the capture's
    wrappers added (``kernels.add_launches``)."""
    before = kernels.thread_launch_counts()
    graph = torch.cuda.CUDAGraph()
    current = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            one_round()
        finally:
            graph.capture_end()
    current.wait_stream(side)
    after = kernels.thread_launch_counts()
    launches = {name: n - before.get(name, 0) for name, n in after.items()
                if n != before.get(name, 0)}
    kernels.add_launches({name: -n for name, n in launches.items()})
    return graph, launches


def _rounds(mesh, res_mode: str, seed, pick, n_total: int, m: int, k_eff: int):
    """The speculate/validate rounds over ``n_total`` decisions, a round
    covering the next ``min(k_eff, n_total - p)`` of them, p the window's
    next undecided position — held on the first shard's device, with the
    carry, the rows and the rounds and conflicts, and never read inside a
    round.

    ``pick(pos, lo, hi, t, res, bufs)`` scores positions [p + lo, p + hi)
    on every shard's block, position p + lo + j against the carry ``t[j]``
    (W,) tails and ``res[j]`` (W, K) slots, and writes their picks into
    ``bufs`` on the first shard's device, in ``score_block``'s (5, hi - lo)
    float64 and (3, hi - lo) int64 form (the cell ``w * m + model`` and
    model id in int rows 0 and 2; raw swap, effective swap and latency in
    float rows 1-3).  A round scores its positions under the frozen carry;
    the chain rebuilds each position's carry from those picks; positions
    1.. are scored again under their carries; ``accept`` finds the first
    conflict (the least position whose pick changed), writes the accepted
    rows, moves the carry by the last accepted decision and the position
    by the accepted count.  Each batch enqueues the rounds the window
    needs if none conflicts, then reads the position back.  ``seed`` is
    the carry (t0, res0, sizes, cap).  Returns ((4, n_total) host rows:
    worker, model column, start, latency; (rounds, conflicts); the
    position's read-backs)."""
    dev0 = mesh[0]
    slot1 = res_mode == "slot1"
    t0, res0, sizes, cap = _seed(*seed, res_mode)
    t = torch.tensor(t0, device=dev0)
    res = torch.tensor(res0, device=dev0)
    sizes = torch.as_tensor(sizes, device=dev0)
    out = torch.zeros((4, n_total), dtype=SCHED_DTYPE, device=dev0)
    pos = torch.zeros(1, dtype=torch.int64, device=dev0)
    stats = torch.zeros(2, dtype=torch.int64, device=dev0)
    k = k_eff

    def bufs(span):
        return (torch.zeros((5, span), dtype=SCHED_DTYPE, device=dev0),
                torch.zeros((3, span), dtype=torch.int64, device=dev0))

    spec = bufs(k)
    val = bufs(k - 1) if k > 1 else None
    t_frozen, res_frozen = t.expand(k, -1), res.expand(k, -1, -1)

    def one_round():
        # 1. Speculate under the frozen carry.
        pick(pos, 0, k, t_frozen, res_frozen, spec)
        if k > 1:
            # 2. Rebuild each position's carry from the speculated picks;
            # position 0's is the frozen carry itself.
            t_st, r_st = chain(t, res, sizes, cap, slot1, spec[1][0, :-1], spec[1][2, :-1],
                               spec[0][1, :-1], spec[0][3, :-1], models=m, pos=pos,
                               total=n_total)
            # 3. Validate positions 1.. under their carries.
            pick(pos, 1, k, t_st[1:], r_st[1:], val)
        else:
            t_st, r_st = t[None], res[None]
        # 4. Accept through the first conflict, inclusive; move the carry.
        accept(pos, n_total, k, spec, val, t_st, r_st, sizes, cap, slot1, t, res, out, stats, m)

    graphs = dev0.type == "cuda" and all(dev == dev0 for dev in mesh)
    graph, launches, ran = None, {}, False
    p = read_backs = 0
    while p < n_total:
        todo = -(-(n_total - p) // k)
        for i in range(todo):
            if graph is None and graphs and ran and todo - i >= GRAPH_MIN_ROUNDS:
                graph, launches = _capture(one_round, dev0)
            if graph is not None:
                graph.replay()
                kernels.add_launches(launches)
            else:
                one_round()
                ran = True
        p = int(pos.item())
        read_backs += 1
    rounds, conflicts = stats.tolist()
    return out.cpu().numpy(), (rounds, conflicts), read_backs


# --------------------------------------------------------------------------
# Sharded single-carry selection (per-request and grouped policies)
# --------------------------------------------------------------------------


def _sharded_select(mesh, res_mode: str, seed, tabs: dict, k_eff: int):
    """Speculate/validate selection with row-sharded tiles (the
    reference's ``_sharded_select_program``).

    ``tabs`` holds the window's ordered step tables in the selection
    scan's one-worker form — rows "acc" (S, B, M), "mask" and "dl" (S,
    B), "size" (S,), "lat" (S, 1, M), "app" (S,) and, for MaxAcc, "sel"
    (S,); per application "swap" (A, 1, M), "gid", "valid", "pen" and
    "rank" — and ``seed`` the carry (t0, res0, sizes, cap).  Each shard
    scores the rows of a round that it holds (``_rounds``).  Returns
    ``_rounds``' ((4, S) host rows, (rounds, conflicts), read-backs)."""
    n_total, _, m = tabs["acc"].shape
    n_pad = pad_rows(n_total, len(mesh))
    nb = n_pad // len(mesh)
    row_tabs = {"acc": 0, "mask": 0, "dl": 1.0, "size": 1.0, "lat": 0, "app": 0, "sel": 0}
    padded = {k: _pad(v, n_pad, row_tabs[k]) if k in row_tabs else v for k, v in tabs.items()}
    specs = row_specs(mesh, {k: tuple(v.shape) for k, v in padded.items()},
                      axis={k: (0 if k in row_tabs else None) for k in padded})
    blocks = _place(mesh, padded, specs)
    dev0 = mesh[0]
    slot1 = res_mode == "slot1"
    steps = torch.arange(max(k_eff, 1), device=dev0)

    def pick(pos, lo, hi, t, res, bufs):
        # Every shard writes the rows of [p + lo, p + hi) it holds into the
        # first shard's buffers (from another device: where it holds them).
        for s, (dev, blk) in enumerate(zip(mesh, blocks)):
            kw = {"pos": pos.to(dev), "lo": lo, "hi": hi, "row0": s * nb, "total": n_total}
            args = (t.to(dev), res.to(dev), slot1, blk["acc"], blk["mask"], blk["dl"],
                    blk["size"], blk["lat"], blk["app"], blk["swap"], blk["gid"], blk["valid"],
                    blk["pen"], blk["rank"])
            fixed = blk.get("sel")
            if dev == dev0:
                score_block(*args, fixed=fixed, out=bufs, **kw)
                continue
            f, i = score_block(*args, fixed=fixed, **kw)
            row = pos + lo + steps[:hi - lo]
            held = (row >= s * nb) & (row < (s + 1) * nb) & (row < n_total)
            bufs[0].copy_(torch.where(held, f.to(dev0), bufs[0]))
            bufs[1].copy_(torch.where(held, i.to(dev0), bufs[1]))

    return _rounds(mesh, res_mode, seed, pick, n_total, m, k_eff)


# --------------------------------------------------------------------------
# Sharded Eq. 15 placement (multi-worker): worker-axis tiles
# --------------------------------------------------------------------------


def _mw_blocks(mesh, setup, tab, n_w: int):
    """The Eq. 15 tables with the worker axis padded to a shard multiple
    (padded workers: invalid, never resident, rank ``RANK_INF``) and split
    by ``row_specs``'s worker-axis rule; the rest replicated.  Returns
    (blocks, workers per shard, (A, W * M) preference permutations)."""
    dt = tab["dev"]
    m_max = tab["m_max"]
    w_pad = pad_rows(n_w, len(mesh))
    dev = setup["acc"].device

    def padw(x, value=0):
        pad = torch.full((x.shape[0], w_pad - n_w) + tuple(x.shape[2:]), value, dtype=x.dtype,
                         device=dev)
        return torch.cat([x.to(dev), pad], dim=1)

    pref = dt["pref"].to(dev)  # (A, n_w * M): rank -> cell
    n_apps = pref.shape[0]
    rank = torch.empty_like(pref)
    rank.scatter_(1, pref, torch.arange(pref.shape[1], device=dev).expand(n_apps, -1))
    tabs = {
        "acc": setup["acc"], "mask": setup["member_mask"], "dl": setup["deadlines"],
        "size": setup["bsizes"], "app": setup["app_id"], "gid": dt["gid"], "valid": dt["valid"],
        "pen": dt["pen"],
        "lat": padw(setup["lat_tab"]), "swap": padw(dt["sswap"]),
        "rank": padw(rank.reshape(n_apps, n_w, m_max), RANK_INF),
        "wvalid": torch.arange(w_pad, device=dev) < n_w,
    }
    specs = row_specs(mesh, {k: tuple(v.shape) for k, v in tabs.items()},
                      axis={k: {"lat": 1, "swap": 1, "rank": 1, "wvalid": 0}.get(k)
                            for k in tabs})
    blocks = _place(mesh, tabs, specs)
    for blk in blocks:
        blk["rank"] = blk["rank"].reshape(n_apps, -1)
    return blocks, w_pad // len(mesh), pref


def _sharded_mw(mesh, res_mode, seed, blocks, wl, m_max, pref, gid, app, chunk: int):
    """Eq. 15 placement with worker-sharded tiles: with ``chunk`` 0 the
    reference's ``_sharded_mw_program`` (a round per group: the
    cross-shard pick, the owner's swap and latency, the carry moved by the
    chain); with ``chunk`` > 0 its ``_sharded_mw_spec_program`` (rounds of
    ``chunk`` groups over the pool carry, ``_rounds``).  The chain takes
    each pick's RAW swap, as the unsharded chunked scan does.  ``gid`` (A,
    M) and ``app`` (G,) on the first shard's device.  Returns ``_rounds``'
    ((4, G) host rows: worker, model, start, latency; (rounds, conflicts);
    read-backs)."""
    dev0 = mesh[0]
    n_total = app.shape[0]
    k_eff = chunk if chunk else 1
    n_cells = pref.shape[1]
    steps = torch.arange(k_eff, device=dev0)
    shard_ids = torch.arange(len(mesh), device=dev0)[:, None]
    # Each shard's picks of a pass, stacked, by the pass's width.
    stacks = {span: (torch.zeros((len(mesh), 5, span), dtype=SCHED_DTYPE, device=dev0),
                     torch.zeros((len(mesh), 3, span), dtype=torch.int64, device=dev0))
              for span in {k_eff, k_eff - 1} if span > 0}

    def pick(pos, lo, hi, t, res, bufs):
        # Every shard scores its worker block, then the exact cross-shard
        # pick and the owner's values.
        span = hi - lo
        sf, si = stacks[span]
        for s, (dev, blk) in enumerate(zip(mesh, blocks)):
            w0, w1 = s * wl, (s + 1) * wl
            args = (t[:, w0:w1].to(dev), res[:, w0:w1].to(dev), res_mode == "slot1",
                    blk["acc"], blk["mask"], blk["dl"], blk["size"], blk["lat"], blk["app"],
                    blk["swap"], blk["gid"], blk["valid"], blk["pen"], blk["rank"],
                    blk["wvalid"])
            kw = {"pos": pos.to(dev), "lo": lo, "hi": hi, "row0": 0, "total": n_total}
            if dev == dev0:
                score_block(*args, out=(sf[s], si[s]), **kw)
            else:
                f, i = score_block(*args, **kw)
                sf[s].copy_(f)
                si[s].copy_(i)
        # Columns past the window's end hold earlier passes' values; their
        # indices are clamped, and the accept never reads them.
        r_star = _pick_allreduce(sf[:, 0], si[:, 1]).clamp(0, n_cells - 1)
        apps = app[(pos + lo + steps[:span]).clamp(max=n_total - 1)]
        cell = pref[apps].gather(1, r_star[:, None])[:, 0]
        mine = (cell // m_max) // wl == shard_ids
        bufs[1][0].copy_(cell)
        bufs[1][2].copy_(gid[apps, cell % m_max])
        for row in (1, 2, 3):
            bufs[0][row].copy_(_owner_bcast(mine, sf[:, row]))

    return _rounds(mesh, res_mode, seed, pick, n_total, m_max, k_eff)


# --------------------------------------------------------------------------
# ShardedWindowPipeline
# --------------------------------------------------------------------------


class ShardedWindowPipeline(WindowPipeline):
    """``WindowPipeline`` with the batched tile phases split across shards
    (see the module docstring for the bit-identity layout).  ``shard=True``
    uses every device of the pipeline's kind; ``shard=N`` uses N.  One
    shard (or the numpy backend) delegates every schedule verbatim to the
    base class: the same launches, the same cached tables."""

    def __init__(self, apps, sneakpeeks=None, policy=None, backend=None, workers=None,
                 chunk=None, shard=True, *, device=None):
        super().__init__(apps, sneakpeeks=sneakpeeks, policy=policy, backend=backend,
                         workers=workers, chunk=chunk, device=device)
        self.shard = shard
        self._shards: int | None = None
        # Stats of the LAST sharded schedule (None when delegated):
        # num_shards, rounds, conflicts (the single-carry paths record the
        # speculation rounds; the sequential Eq. 15 placement reports
        # rounds = group count, conflicts = 0).
        self.last_shard_stats: dict | None = None
        # How many times the LAST sharded schedule read its round position
        # back to the host (None when delegated).
        self.last_read_backs: int | None = None

    def num_shards(self) -> int:
        """Resolved shard count (1 on the numpy backend)."""
        if self._shards is None:
            if self.resolved_backend() != "jax":
                self._shards = 1
            else:
                self._shards = resolve_num_shards(self.shard, self.device)
        return self._shards

    def schedule(self, requests, now, policy=None, state=None, arrays=None, workers=None,
                 lat_scale=None, worker_mask=None):
        """``WindowPipeline.schedule``, recording ``last_shard_stats`` when
        the window is sharded (None when it delegates)."""
        self.last_shard_stats = None
        self.last_read_backs = None
        return super().schedule(requests, now, policy=policy, state=state, arrays=arrays,
                                workers=workers, lat_scale=lat_scale, worker_mask=worker_mask)

    def _record_shard_stats(self, rounds, conflicts):
        self.last_shard_stats = {
            "num_shards": self.num_shards(),
            "rounds": int(rounds),
            "conflicts": int(conflicts),
        }

    def _mesh(self):
        return shard_mesh(self.num_shards(), self.device)

    # -- per-request policies (request-axis sharding) ----------------------
    def _schedule_per_request(self, policy, requests, now, state, arrays):
        if self.num_shards() <= 1:
            return super()._schedule_per_request(policy, requests, now, state, arrays)
        if policy.selection not in ("locally_optimal", "max_accuracy"):
            raise ValueError(f"unknown selection {policy.selection!r}")
        if policy.ordering not in ("fcfs", "edf", "priority"):
            raise ValueError(f"unknown ordering {policy.ordering!r}")
        wa = self._window_arrays(requests, now, arrays)
        tab = self._window_tables(wa)
        dt = tab["dev"]
        app_id = np.zeros(len(wa.requests), dtype=np.int64)
        for ai, name in enumerate(tab["app_names"]):
            app_id[wa.req_idx[name]] = ai
        seed, res_mode = self._state_seed(wa, state, now)
        chunk = self._chunk_of(policy)
        order, acc, aid, fixed = _per_request_head(
            wa, policy.ordering, policy.selection, bool(policy.data_aware), app_id, dt)
        n_total = len(wa.requests)
        ones = torch.ones((n_total, 1), dtype=SCHED_DTYPE, device=wa.device)
        tabs = {
            "acc": acc[:, None, :], "mask": ones, "dl": wa.deadlines_t[wa._tensor(order)][:, None],
            "size": ones[:, 0], "lat": dt["lat1"][aid][:, None, :], "app": aid,
            "swap": dt["swap"][:, None, :], "gid": dt["gid"], "valid": dt["valid"],
            "pen": dt["pen"], "rank": dt["pref"],  # columns are in tie-preference order
        }
        if fixed is not None:
            tabs["sel"] = fixed
        out, stats, self.last_read_backs = _sharded_select(self._mesh(), res_mode, seed, tabs,
                                                           chunk if chunk else n_total)
        self._record_shard_stats(*stats)
        if chunk:
            self._record_chunk_stats(chunk, n_total, stats)
        return self._per_request_emit(wa, tab, app_id, order, out[1].astype(np.int64), out[2],
                                      out[3])

    # -- grouped policies (group-axis sharding) ----------------------------
    def _schedule_grouped(self, policy, requests, now, state, arrays):
        if self.num_shards() <= 1:
            return super()._schedule_grouped(policy, requests, now, state, arrays)
        setup = self._grouped_setup(policy, requests, now, state, arrays)
        if setup.get("sched") is not None:  # brute-force branch (<= tau)
            return setup["sched"]
        dt = setup["tab"]["dev"]
        n_groups = len(setup["ordered_groups"])
        chunk = self._chunk_of(policy)
        tabs = {
            "acc": setup["acc"], "mask": setup["member_mask"], "dl": setup["deadlines"],
            "size": setup["sizes"], "lat": setup["lat_tab"][:, None, :],
            "app": setup["wa"]._tensor(setup["app_id"]), "swap": dt["swap"][:, None, :],
            "gid": dt["gid"], "valid": dt["valid"], "pen": dt["pen"], "rank": dt["pref"],
        }
        out, stats, self.last_read_backs = _sharded_select(
            self._mesh(), setup["res_mode"], setup["seed"], tabs, chunk if chunk else n_groups)
        self._record_shard_stats(*stats)
        if chunk:
            self._record_chunk_stats(chunk, n_groups, stats)
        return self._grouped_emit(setup, out[1].astype(np.int64), out[2], out[3])

    # -- multi-worker placement (worker-axis sharding) ---------------------
    def _schedule_multiworker(self, policy, requests, now, workers, state, arrays,
                              lat_scale=None):
        if self.num_shards() <= 1:
            return super()._schedule_multiworker(policy, requests, now, workers, state, arrays,
                                                 lat_scale)
        setup = self._mw_setup(policy, requests, now, workers, state, arrays, lat_scale)
        pool, tab = setup["pool"], setup["tab"]
        mesh = self._mesh()
        n_w = len(workers)
        w_pad = pad_rows(n_w, len(mesh))
        res_mode = pool.res_mode(state)
        res0 = pool.res[:, :1] if res_mode == "slot1" else pool.res
        # Padded workers: never valid, never resident, unit sizes.
        seed = (np.pad(pool.t, (0, w_pad - n_w)),
                np.pad(res0, [(0, w_pad - n_w), (0, 0)], constant_values=-1),
                np.pad(pool.sizes, [(0, w_pad - n_w), (0, 0)], constant_values=1.0),
                float(pool.capacity))
        blocks, wl, pref = _mw_blocks(mesh, setup, tab, n_w)
        chunk = self._chunk_of(policy)
        out, stats, self.last_read_backs = _sharded_mw(
            mesh, res_mode, seed, blocks, wl, tab["m_max"], pref.to(mesh[0]),
            tab["dev"]["gid"].to(mesh[0]), setup["app_id"].to(mesh[0]), chunk)
        n_groups = len(setup["ordered_groups"])
        if chunk:
            self._record_chunk_stats(chunk, n_groups, stats)
            self._record_shard_stats(*stats)
        else:
            self._record_shard_stats(n_groups, 0)
        return self._mw_emit(setup, workers, out[0].astype(np.int64), out[1].astype(np.int64),
                             out[2], out[3])
