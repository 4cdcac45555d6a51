"""Plain PyTorch versions of the shard-round kernel's three entry points.

``score_block_ref`` scores a block of rows, each against its own carry,
in the (R, W, B, M) form of the selection scan's step, and takes each
row's pick by the key of the reference's local all-reduce
(``src/repro/core/shard.py:347``): the maximum utility, then the least
tie-break rank, then the first cell.  ``chain_ref`` applies a run of
decisions to a carry one after the other and keeps every state.
``accept_ref`` ends a round: the first conflict, the accepted rows, the
carry moved by the last accepted decision, the position advanced.  With
a position tensor (``pos``) the three read the round's place in the
window from it and do nothing once it has reached the window's end, as
the kernel does.  All are built from the pipeline's plain pieces
(``core.pipeline``: ``_penalty``, ``_chunk_member_mean``,
``_touch_residency``), in float64 with the reference's associations.
Used for tensors on the CPU and, on the card, as the kernel's comparison.
"""
from __future__ import annotations

import torch

__all__ = ["score_block_ref", "chain_ref", "accept_ref", "row_window", "RANK_INF"]

# The tie-break rank of a padded worker: above any real rank, and small
# enough that int64 comparisons never overflow (the reference's _RANK_INF).
RANK_INF = 2**62


def row_window(pos, lo: int, hi: int, row0: int, total: int, rows: int):
    """The rows a position-reading ``score_block`` scores: (first row of
    the window, end, p) with p the position ``pos`` holds — rows [max(p +
    lo, row0), min(p + hi, row0 + rows, total)) — each read at its row less
    ``row0`` and written at its row less p + lo."""
    p = int(pos)
    return max(p + lo, row0), min(p + hi, row0 + rows, total), p


def score_block_ref(t, res, slot1: bool, acc, mask, deadlines, bsize, lat, step_app, swap, gid,
                    valid, pen, rank, wvalid=None, fixed=None, *, pos=None, lo: int = 0,
                    hi: int | None = None, row0: int = 0, total: int | None = None, out=None):
    """Rows of one shard's block scored against their carries: ((5, R)
    float64 — utility, the pick's raw swap, effective swap, latency and
    completion —, (3, R) int64 — the pick (cell ``w * M + m`` of the
    block), its rank and its model id); arguments as ``ops.score_block``.
    With ``pos``, the rows of ``row_window`` into columns of (5, hi - lo)
    and (3, hi - lo) outputs (``out``, or zeros), the others left as they
    are."""
    n_rows = acc.shape[0]
    if pos is None:
        return _score_rows(t, res, slot1, acc, mask, deadlines, bsize, lat, step_app, swap, gid,
                           valid, pen, rank, wvalid, fixed)
    total = row0 + n_rows if total is None else total
    dev = acc.device
    if out is None:
        out = (torch.zeros((5, hi - lo), dtype=torch.float64, device=dev),
               torch.zeros((3, hi - lo), dtype=torch.int64, device=dev))
    g0, g1, p = row_window(pos, lo, hi, row0, total, n_rows)
    if g1 > g0:
        loc, rel = slice(g0 - row0, g1 - row0), slice(g0 - p - lo, g1 - p - lo)
        f, i = _score_rows(t[rel], res[rel], slot1, acc[loc], mask[loc], deadlines[loc],
                           bsize[loc], lat[loc], step_app[loc], swap, gid, valid, pen, rank,
                           wvalid, None if fixed is None else fixed[loc])
        out[0][:, rel] = f
        out[1][:, rel] = i
    return out


def _score_rows(t, res, slot1: bool, acc, mask, deadlines, bsize, lat, step_app, swap, gid,
                valid, pen, rank, wvalid=None, fixed=None):
    from repro_torch.core.pipeline import _chunk_member_mean, _penalty

    n_rows, _, m = acc.shape
    n_w = lat.shape[1]
    dev = acc.device
    rows = torch.arange(n_rows, device=dev)
    gid_r = gid[step_app]  # (R, M)
    if slot1:
        is_res = res[:, :, :1] == gid_r[:, None, :]
    else:
        is_res = (res[:, :, None, :] == gid_r[:, None, :, None]).any(dim=-1)
    swap_r = swap[step_app]  # (R, W, M)
    swap_eff = torch.where(is_res, 0.0, swap_r)
    comp = (t[:, :, None] + swap_eff) + lat
    rank_r = rank[step_app]  # (R, W * M)
    if fixed is None:
        gam = _penalty(pen[step_app][:, None, None, None], deadlines[:, None, :, None],
                       comp[:, :, None, :])
        tile = acc[:, None] * (1.0 - torch.clamp(gam, 0.0, 1.0))  # (R, W, B, M)
        u = _chunk_member_mean(tile, mask[:, None, :], bsize[:, None])
        ok = valid[step_app][:, None, :]
        if wvalid is not None:
            ok = ok & wvalid[None, :, None]
        u = torch.where(ok, u, torch.tensor(float("-inf"), dtype=u.dtype, device=dev))
        u = u.reshape(n_rows, n_w * m)
        ub = u.max(dim=1).values
        rb = torch.where(u == ub[:, None], rank_r, RANK_INF).min(dim=1).values
        cand = (u == ub[:, None]) & (rank_r == rb[:, None])
        pick = torch.argmax(cand.to(torch.int8), dim=1)
    else:
        pick = fixed
        ub = torch.zeros(n_rows, dtype=torch.float64, device=dev)
        rb = rank_r[rows, pick]
    w, mi = pick // m, pick % m
    outf = torch.stack([ub, swap_r[rows, w, mi], swap_eff[rows, w, mi], lat[rows, w, mi],
                        comp[rows, w, mi]])
    outi = torch.stack([pick, rb, gid_r[rows, mi]])
    return outf, outi


def chain_ref(t0, res0, sizes, cap: float, slot1: bool, wi, g, sw, lt, *, models: int = 0,
              pos=None, total: int | None = None):
    """The n + 1 carries of n decisions applied one after the other:
    ((n + 1, W) tails, (n + 1, W, K) slots), row k the state before
    decision k; arguments as ``ops.chain``.  With ``pos``, only the
    decisions before the window's last position, and nothing (zeros) once
    ``pos`` has reached ``total``."""
    from repro_torch.core.pipeline import _touch_residency

    n = wi.shape[0]
    dev = t0.device
    length = n
    if pos is not None:
        p = int(pos)
        length = -1 if p >= total else min(n, max(total - p - 1, 0))
    t_out = torch.zeros((n + 1,) + tuple(t0.shape), dtype=torch.float64, device=dev)
    r_st = torch.zeros((n + 1,) + tuple(res0.shape), dtype=torch.int64, device=dev)
    if length < 0:
        return t_out, r_st
    workers = (wi // models if models else wi)[:length].tolist()
    tc = t0.tolist()
    rc = res0.clone()
    t_rows = []
    # A host chain of floats: float64 adds in the scan's association.
    for k, (w, gk, swk, ltk) in enumerate(zip(workers, g[:length].tolist(), sw[:length].tolist(),
                                              lt[:length].tolist())):
        t_rows.append(list(tc))
        r_st[k] = rc
        if slot1:
            was = int(rc[w, 0]) == gk
            rc[w, 0] = gk
        else:
            rc[w], was = _touch_residency(rc[w], gk, sizes[w], cap)
        tc[w] = (tc[w] + (0.0 if was else swk)) + ltk
    t_rows.append(tc)
    r_st[length] = rc
    t_out[:length + 1] = torch.tensor(t_rows, dtype=torch.float64, device=dev)
    return t_out, r_st


def accept_ref(pos, total: int, span: int, spec, val, t_st, r_st, sizes, cap: float, slot1: bool,
               t, res, out, stats, models: int) -> None:
    """The end of a round at the position ``pos`` holds, in place;
    arguments as ``ops.accept``.  The first position j in [1, kn) whose
    validated cell differs from its speculated one ends the accepted run,
    inclusive (kn = min(span, total - p) when none does); each accepted
    position's row is its worker, model column, start (its pre-state's
    tail) and latency ((start + effective swap) + latency) - start; the
    carry becomes the last accepted position's pre-state with its
    decision applied (the chain's arithmetic); ``pos`` advances and
    ``stats`` counts the round and its conflict."""
    from repro_torch.core.pipeline import _touch_residency

    p = int(pos)
    if p >= total:
        return
    kn = min(span, total - p)
    spec_f, spec_i = spec
    if kn > 1:
        val_f, val_i = val
        cell = torch.cat([spec_i[0, :1], val_i[0, :kn - 1]])
        mism = val_i[0, :kn - 1] != spec_i[0, 1:kn]
        fcol = lambda row: torch.cat([spec_f[row, :1], val_f[row, :kn - 1]])  # noqa: E731
        icol = lambda row: torch.cat([spec_i[row, :1], val_i[row, :kn - 1]])  # noqa: E731
    else:
        cell = spec_i[0, :1]
        mism = torch.zeros(0, dtype=torch.bool, device=cell.device)
        fcol = lambda row: spec_f[row, :1]  # noqa: E731
        icol = lambda row: spec_i[row, :1]  # noqa: E731
    conflict = bool(mism.any())
    a = int(torch.argmax(mism.to(torch.int8))) + 2 if conflict else kn
    wi = cell[:a] // models
    start = t_st[torch.arange(a, device=cell.device), wi]
    swe, lt = fcol(2)[:a], fcol(3)[:a]
    out[0, p:p + a] = wi.to(torch.float64)
    out[1, p:p + a] = (cell[:a] % models).to(torch.float64)
    out[2, p:p + a] = start
    out[3, p:p + a] = ((start + swe) + lt) - start
    k = a - 1
    w, g = int(wi[k]), int(icol(2)[k])
    sw_k, lt_k = float(fcol(1)[k]), float(lt[k])
    tc = t_st[k].tolist()
    rc = r_st[k].clone()
    if slot1:
        was = int(rc[w, 0]) == g
        rc[w, 0] = g
    else:
        rc[w], was = _touch_residency(rc[w], g, sizes[w], cap)
    tc[w] = (tc[w] + (0.0 if was else sw_k)) + lt_k
    t.copy_(torch.tensor(tc, dtype=torch.float64, device=t.device))
    res.copy_(rc)
    pos.fill_(p + a)
    stats[0] += 1
    stats[1] += int(conflict)
