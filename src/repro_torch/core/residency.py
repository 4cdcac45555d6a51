"""Shared model-residency (LRU eviction) rule.

Residency is LRU-ordered, oldest first.  Loading a non-resident model
appends it, then evicts oldest-first while the resident set exceeds
capacity.  The just-loaded model is never evicted: a variant must occupy
memory to execute, so a single model larger than capacity resides alone.

The rule exists in two encodings that must agree, as in the reference
(``repro.core.residency``):

  * ``evict_lru`` — the name-keyed host form (a list, byte sizes by
    name) used by ``WorkerTimeline`` and ``SwapManager``.
  * ``touch_lru_array`` — the array form over fixed-size LRU slots
    (integer model ids, -1 = empty, oldest first) that the multi-worker
    fast path's ``PoolArrays`` updates.  ``single_slot_encoding`` maps
    the capacity-``None`` single-slot model onto the same rule (capacity
    0, unit sizes): after a load, eviction strips every other resident.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np

__all__ = ["evict_lru", "touch_lru_array", "single_slot_encoding"]


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


def single_slot_encoding(n_ids: int) -> tuple[np.ndarray, float]:
    """(sizes, capacity) encoding the capacity-``None`` single-slot model
    for ``touch_lru_array``: unit sizes against capacity 0 make eviction
    strip every resident except the protected (just-loaded) model."""
    return np.ones(n_ids, dtype=np.float64), 0.0


def touch_lru_array(
    res: np.ndarray,
    gid: int,
    sizes: np.ndarray,
    capacity: float,
) -> tuple[np.ndarray, bool]:
    """Array form of the residency rule for ONE model load.

    ``res`` is a fixed-size slot vector of model ids (LRU order, oldest
    first, ``-1`` = empty slot, empties packed at the tail); ``sizes``
    maps id -> bytes.  Returns the new slot vector (same shape, a fresh
    array) and whether ``gid`` was already resident (a swap-free load).

    Decision-identical to ``WorkerTimeline._touch``: a resident model
    moves to the MRU tail; a non-resident one is appended, then evicted
    oldest-first down to ``capacity``, never the just-loaded model.
    """
    res = np.asarray(res)
    was_resident = bool((res == gid).any())
    kept = res[(res >= 0) & (res != gid)]
    lru = np.concatenate([kept, [gid]])  # gid at the MRU tail
    szs = sizes[lru]
    protect = lru == gid
    # Eviction only accompanies a load: touching a resident model is a
    # pure MRU reorder.
    evictable = ~protect if not was_resident else np.zeros(len(lru), dtype=bool)
    # Freed bytes before the scan reaches each entry: the host loop evicts
    # entry i iff it is evictable and the running total still exceeds
    # capacity when the scan arrives there.
    freed = np.cumsum(np.where(evictable, szs, 0.0))
    freed_before = freed - np.where(evictable, szs, 0.0)
    evict = evictable & (szs.sum() - freed_before > capacity)
    survivors = lru[~evict]
    out = np.full(res.shape, -1, dtype=res.dtype)
    out[: len(survivors)] = survivors
    return out, was_resident
