"""Request and group priority (paper Eq. 12 and Eq. 14).

    Priority(r_i) = (1 + Var[Accuracy(M_{a_i})]) * exp(-d_i)        (Eq. 12)
    Priority(g)   = mean_{r in g} Priority(r)                       (Eq. 14)

where d_i is the request's time-to-deadline (seconds) and the variance is
the *population* variance of the candidate-model accuracies (footnote 4:
|M| = 1  =>  Var = 0).  Requests close to deadline, or whose model choice
matters (high accuracy spread), are prioritized.

The accuracy set may be profiled (data-oblivious) or SneakPeek-sharpened
(data-aware): sharpened accuracies change the variance term, so
data-awareness composes with priority ordering exactly as the paper's
Fig. 7 "incremental" experiment requires.
"""
from __future__ import annotations

import math
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core.types import Application, Request

__all__ = [
    "accuracy_variance",
    "request_priority",
    "request_priorities",
    "group_priority",
]


def accuracy_variance(accuracies: Sequence[float]) -> float:
    """Population variance of the variant accuracies (footnote 4)."""
    a = np.asarray(accuracies, dtype=np.float64)
    if a.size <= 1:
        return 0.0
    return float(a.var())  # numpy default ddof=0 == population variance


def request_priority(
    request: Request,
    app: Application,
    now: float,
    data_aware: bool = False,
    arrays=None,
) -> float:
    """Eq. 12.  ``d_i`` is time-to-deadline relative to ``now`` in seconds.

    With ``data_aware=True`` and a SneakPeek posterior attached to the
    request, the variance term uses sharpened accuracies.  Passing a
    ``fastpath.WindowArrays`` bundle makes this a thin lookup into the
    window's precomputed priority vector; without it this is the scalar
    host form.
    """
    if arrays is not None:
        return float(arrays.priorities(data_aware)[arrays.index_of(request)])
    theta = request.theta if data_aware else None
    accs = app.accuracies(theta)
    var = accuracy_variance(accs)
    d = request.time_to_deadline(now)
    # Guard the exponential for far-past deadlines (already hopeless
    # requests get maximal urgency rather than inf).
    d = max(d, -60.0)
    return (1.0 + var) * math.exp(-d)


def request_priorities(
    requests: Sequence[Request],
    apps: Mapping[str, Application],
    now: float,
    data_aware: bool = False,
    device=None,
) -> np.ndarray:
    """Batched Eq. 12 for a whole window (one product + row-variance pass
    per application on ``device``) — see ``fastpath.WindowArrays``."""
    from repro_torch.core.fastpath import WindowArrays

    return WindowArrays(requests, apps, now, device).priorities(data_aware)


def group_priority(
    requests: Sequence[Request],
    app: Application,
    now: float,
    data_aware: bool = False,
    arrays=None,
) -> float:
    """Eq. 14: mean of member priorities."""
    if not requests:
        return 0.0
    if arrays is not None:
        return float(np.mean(arrays.priorities(data_aware)[arrays.rows_of(requests)]))
    return float(
        np.mean([request_priority(r, app, now, data_aware) for r in requests])
    )
