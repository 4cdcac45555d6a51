"""Request-ordering policies: FCFS, EDF, and the paper's priority ordering (§V-A1)."""
from __future__ import annotations

from typing import Callable, Mapping, Sequence

from repro_torch.core.priority import request_priority
from repro_torch.core.types import Application, Request

__all__ = ["fcfs", "edf", "priority_order", "ORDERINGS"]


def fcfs(
    requests: Sequence[Request],
    apps: Mapping[str, Application],
    now: float,
    data_aware: bool = False,
) -> list[Request]:
    """First come, first served."""
    return sorted(requests, key=lambda r: (r.arrival_s, r.rid))


def edf(
    requests: Sequence[Request],
    apps: Mapping[str, Application],
    now: float,
    data_aware: bool = False,
) -> list[Request]:
    """Earliest deadline first."""
    return sorted(requests, key=lambda r: (r.deadline_s, r.rid))


def priority_order(
    requests: Sequence[Request],
    apps: Mapping[str, Application],
    now: float,
    data_aware: bool = False,
) -> list[Request]:
    """Paper Eq. 12 ordering, highest priority first (ties by rid for determinism)."""
    return sorted(
        requests,
        key=lambda r: (-request_priority(r, apps[r.app], now, data_aware), r.rid),
    )


ORDERINGS: dict[str, Callable] = {
    "fcfs": fcfs,
    "edf": edf,
    "priority": priority_order,
}
