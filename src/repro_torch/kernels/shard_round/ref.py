"""Plain PyTorch versions of the shard-round kernel's two entry points.

``score_block_ref`` scores a block of rows, each against its own carry,
in the (R, W, B, M) form of the selection scan's step, and takes each
row's pick by the key of the reference's local all-reduce
(``src/repro/core/shard.py:347``): the maximum utility, then the least
tie-break rank, then the first cell.  ``chain_ref`` applies a run of
decisions to a carry one after the other and keeps every state.  Both
are built from the pipeline's plain pieces (``core.pipeline``:
``_penalty``, ``_chunk_member_mean``, ``_touch_residency``), in float64
with the reference's associations.  Used for tensors on the CPU and, on
the card, as the kernel's comparison.
"""
from __future__ import annotations

import torch

__all__ = ["score_block_ref", "chain_ref", "RANK_INF"]

# The tie-break rank of a padded worker: above any real rank, and small
# enough that int64 comparisons never overflow (the reference's _RANK_INF).
RANK_INF = 2**62


def score_block_ref(t, res, slot1: bool, acc, mask, deadlines, bsize, lat, step_app, swap, gid,
                    valid, pen, rank, wvalid=None, fixed=None):
    """Rows of one shard's block scored against their carries: ((5, R)
    float64 — utility, the pick's raw swap, effective swap, latency and
    completion —, (3, R) int64 — the pick (cell ``w * M + m`` of the
    block), its rank and its model id); arguments as ``ops.score_block``."""
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


def chain_ref(t0, res0, sizes, cap: float, slot1: bool, wi, g, sw, lt):
    """The n + 1 carries of n decisions applied one after the other:
    ((n + 1, W) tails, (n + 1, W, K) slots), row k the state before
    decision k; arguments as ``ops.chain``."""
    from repro_torch.core.pipeline import _touch_residency

    n = wi.shape[0]
    dev = t0.device
    r_st = torch.empty((n + 1,) + tuple(res0.shape), dtype=torch.int64, device=dev)
    tc = t0.tolist()
    rc = res0.clone()
    t_rows = []
    # A host chain of floats: float64 adds in the scan's association.
    for k, (w, gk, swk, ltk) in enumerate(zip(wi.tolist(), g.tolist(), sw.tolist(),
                                              lt.tolist())):
        t_rows.append(list(tc))
        r_st[k] = rc
        if slot1:
            was = int(rc[w, 0]) == gk
            rc[w, 0] = gk
        else:
            rc[w], was = _touch_residency(rc[w], gk, sizes[w], cap)
        tc[w] = (tc[w] + (0.0 if was else swk)) + ltk
    t_rows.append(tc)
    r_st[n] = rc
    return torch.tensor(t_rows, dtype=torch.float64, device=dev), r_st
