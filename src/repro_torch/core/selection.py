"""Model-selection strategies (paper §V-A2 and §VI-A baselines).

  * ``locally_optimal`` — Eq. 13: argmax_m u(m, d_i, t_i) at the current
    queue-tail time, accounting for swap cost.  Generalizes the
    deadline-aware selectors of [29], [40], [7].
  * ``max_accuracy`` — MaxAcc baseline: always the highest-(estimated)-
    accuracy variant, deadline-oblivious.

``group_locally_optimal`` optionally consumes a precomputed
``fastpath.WindowArrays`` bundle: the group's per-pair accuracy/penalty
work collapses to one Eq. 2 tile on the device, scored by the kernel
(``repro_torch.kernels.utility``), whose column means follow the scalar
member order, with the same (utility, -latency, name) tie-breaking as the
scalar loop.  Without ``arrays`` the scalar host implementation runs; the
per-request selectors are scalar only (the fast path inlines them).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.accuracy import ModelProfile
from repro_torch.core.evaluation import WorkerTimeline, estimate_accuracy
from repro_torch.core.types import Application, Request
from repro_torch.core.utility import utility as eq2_utility

__all__ = ["locally_optimal", "max_accuracy", "group_locally_optimal"]


def locally_optimal(
    request: Request,
    app: Application,
    timeline: WorkerTimeline,
    acc_mode: str = "profiled",
) -> ModelProfile:
    """Eq. 13: the variant maximizing this request's utility if run next.

    Ties break toward lower latency (frees budget for later requests),
    then by name for determinism.
    """
    best, best_u = None, -np.inf
    for m in app.models:
        start, completion = timeline.peek_batch(m, 1)
        acc = estimate_accuracy(request, app, m, acc_mode)
        u = eq2_utility(acc, request.deadline_s, start, completion - start, app.penalty_fn)
        key = (u, -m.latency_s, m.name)
        if best is None or key > (best_u, -best.latency_s, best.name):
            best, best_u = m, u
    return best


def max_accuracy(
    request: Request,
    app: Application,
    timeline: WorkerTimeline,
    acc_mode: str = "profiled",
) -> ModelProfile:
    """MaxAcc baseline: highest estimated accuracy, ignoring deadlines."""
    best, best_a = None, -np.inf
    for m in app.models:
        acc = estimate_accuracy(request, app, m, acc_mode)
        if best is None or (acc, -m.latency_s, m.name) > (best_a, -best.latency_s, best.name):
            best, best_a = m, acc
    return best


def group_locally_optimal(
    requests: Sequence[Request],
    app: Application,
    timeline: WorkerTimeline,
    acc_mode: str = "profiled",
    arrays=None,
) -> ModelProfile:
    """Group-level Eq. 13: argmax_m of the *average* member utility if the
    whole group runs next as one batch (Alg. 1 line "solution to eq. 13
    using avg group utility")."""
    b = len(requests)
    if arrays is not None:
        from repro_torch.kernels.utility.ops import utility_scores

        aa = arrays.app_arrays[app.name]
        rows = arrays.rows_of(requests)
        comp = timeline.t + timeline.swap_vector(aa.names, aa.swap) + aa.batch_latency(b)
        dev = arrays.device
        A_g = arrays.acc_matrix(app.name, acc_mode)[
            torch.as_tensor(arrays.row_of[rows], device=dev)
        ]
        # One Eq. 2 tile; the kernel's column means add the members in
        # scalar order, bit-identical on near-tied utilities.
        _, means = utility_scores(
            A_g,
            arrays.deadlines_t[torch.as_tensor(rows, device=dev)],
            torch.as_tensor(comp, dtype=A_g.dtype, device=dev),
            app.penalty,
        )
        return app.models[aa.argbest(means.cpu().numpy())]
    best, best_u = None, -np.inf
    for m in app.models:
        start, completion = timeline.peek_batch(m, b)
        lat = completion - start
        total = 0.0
        for r in requests:
            acc = estimate_accuracy(r, app, m, acc_mode)
            total += eq2_utility(acc, r.deadline_s, start, lat, app.penalty_fn)
        u = total / b
        key = (u, -m.latency_s, m.name)
        if best is None or key > (best_u, -best.latency_s, best.name):
            best, best_u = m, u
    return best
