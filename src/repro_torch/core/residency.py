"""Shared model-residency (LRU eviction) rule.

Residency is LRU-ordered, oldest first.  Loading a non-resident model
appends it, then evicts oldest-first while the resident set exceeds
capacity.  The just-loaded model is never evicted: a variant must occupy
memory to execute, so a single model larger than capacity resides alone.

Host bookkeeping, as in the reference (``repro.core.residency``); the
array encoding used by the multi-worker and compiled paths is not part
of this slice of the port.
"""
from __future__ import annotations

from typing import Mapping

__all__ = ["evict_lru"]


def evict_lru(
    resident: list[str],
    sizes: Mapping[str, int],
    capacity: int | None,
    protect: str,
) -> list[str]:
    """Evict oldest-first from ``resident`` (mutated in place) until the
    byte total fits ``capacity``, never evicting ``protect``.

    Returns the evicted names, oldest first.  ``capacity=None`` means
    unlimited: nothing is evicted.  Models without a registered size
    contribute 0 bytes (eviction then never fires for them).
    """
    evicted: list[str] = []
    if capacity is None:
        return evicted
    total = sum(sizes.get(n, 0) for n in resident)
    i = 0
    while total > capacity and i < len(resident):
        name = resident[i]
        if name == protect:
            i += 1
            continue
        resident.pop(i)
        evicted.append(name)
        total -= sizes.get(name, 0)
    return evicted
