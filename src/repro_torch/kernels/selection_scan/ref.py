"""Plain PyTorch version of the selection-scan kernel.

A Python loop over float64 tensors that takes, step by step, what the
reference's compiled ``step`` functions take (the per-request, grouped
and multi-worker scans, ``src/repro/core/pipeline.py:493``, ``:575`` and
``:646``), in the one form the kernel runs all three in: each step scores
a (W, B, M) tile of (worker, member, model) utilities against the carry,
takes the masked member means in member order, picks the first maximum
over the step's preference permutation (or the fixed MaxAcc choice), and
advances the carry — the per-worker queue-tail times and residency.
Used for tensors on the CPU and, on the card, as the kernel's comparison.
"""
from __future__ import annotations

import torch

__all__ = ["selection_scan_ref"]


def selection_scan_ref(t0, res0, sizes, cap: float, slot1: bool, acc, mask, deadlines,
                       bsize, lat, step_app, swap, gid, valid, pen, pref,
                       fixed_sel=None) -> torch.Tensor:
    """The (4, S) float64 rows (worker index, model column, start,
    latency) of S sequential decisions; arguments as ``ops.selection_scan``."""
    from repro_torch.core.pipeline import _penalty, _sequential_mean, _touch_residency

    n_steps = acc.shape[0]
    n_w, m = lat.shape[1], lat.shape[2]
    t = t0.clone()
    res = res0.clone()
    out = torch.zeros((4, n_steps), dtype=torch.float64, device=acc.device)
    neg_inf = torch.tensor(float("-inf"), dtype=torch.float64, device=acc.device)
    for s in range(n_steps):
        a = int(step_app[s])
        gid_row = gid[a]
        # (W, M): is model m resident on worker w?
        if slot1:
            is_res = res[:, 0:1] == gid_row[None, :]
        else:
            is_res = (res[:, None, :] == gid_row[None, :, None]).any(dim=-1)
        swap_eff = torch.where(is_res, 0.0, swap[a])
        # (t + swap) + l: the fast path's queue-tail association.
        completion = (t[:, None] + swap_eff) + lat[s]
        if fixed_sel is None:
            gam = _penalty(pen[a], deadlines[s][None, :, None], completion[:, None, :])
            tile = acc[s][None, :, :] * (1.0 - torch.clamp(gam, 0.0, 1.0))  # (W, B, M)
            u_mean = _sequential_mean(tile, mask[s], bsize[s], axis=1)
            u_flat = torch.where(valid[a][None, :], u_mean, neg_inf).reshape(-1)
            # First max over the preference permutation: the tie-break
            # (u, -scaled latency, name, -wid), or model order for W = 1.
            p = pref[a]
            pick = int(p[int(torch.argmax(u_flat[p]))])
        else:
            pick = int(fixed_sel[s])
        wi, mi = divmod(pick, m)
        start = t[wi].clone()
        comp = (start + swap_eff[wi, mi]) + lat[s, wi, mi]
        if slot1:
            res[wi, 0] = gid_row[mi]
        else:
            res[wi], _ = _touch_residency(res[wi], gid_row[mi], sizes[wi], cap)
        t[wi] = comp
        out[0, s] = wi
        out[1, s] = mi
        out[2, s] = start
        out[3, s] = comp - start
    return out
