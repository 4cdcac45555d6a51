"""Serving runtime: window queue, model-swap manager, batch executor.

The counterpart of ``repro.serving.runtime`` on the single-executor
path: the scheduler (``repro_torch.core``) decides (model, order,
batch); the runtime charges swaps and dispatches batches to an
``ExecutorBackend`` (``serving.backends``), the port's ``LM`` on the
card by default.  ``ExecutorPool``, ``WorkerExecutor`` and the process
lane are not ported yet (ROADMAP "Modules to port", item 10).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Mapping, Optional, Sequence

import numpy as np

from repro_torch.core.residency import evict_lru
from repro_torch.core.types import Request, Schedule, ScheduleEntry
from repro_torch.serving.backends import ExecutionReport, ExecutorBackend, ProfiledBackend

__all__ = ["WindowQueue", "SwapManager", "LMExecutor", "ExecutionReport",
           "iter_entry_batches"]


class WindowQueue:
    """Scheduling-window request queue (paper §III-B: requests enqueue
    during a window, then are scheduled as a set)."""

    def __init__(self, window_s: float = 0.1):
        self.window_s = window_s
        self._pending: list[Request] = []

    def submit(self, request: Request):
        """Enqueue a request for the window containing its arrival."""
        self._pending.append(request)

    def drain_window(self, now: float) -> list[Request]:
        """Requests that arrived by ``now`` (window close), ordered by
        (arrival, rid): simultaneous arrivals drain deterministically
        whatever the submission order."""
        ready = [r for r in self._pending if r.arrival_s <= now]
        self._pending = [r for r in self._pending if r.arrival_s > now]
        return sorted(ready, key=lambda r: (r.arrival_s, r.rid))


class SwapManager:
    """LRU model residency with byte-accounted capacity.

    ``load(name)`` returns the swap latency charged (0 when resident) and
    updates residency; the weights themselves are made by the backend's
    lazy store.  Eviction follows the shared rule of
    ``core.residency.evict_lru``, the one the scheduler's timelines charge
    swaps by: oldest first, never the model being loaded.
    """

    def __init__(self, capacity_bytes: int | None, sizes: Mapping[str, int],
                 load_latency: Mapping[str, float]):
        self.capacity = capacity_bytes
        self.sizes = dict(sizes)
        self.load_latency = dict(load_latency)
        self._resident: OrderedDict[str, int] = OrderedDict()
        self.swap_count = 0
        self.evictions = 0

    def resident_bytes(self) -> int:
        """Total bytes of currently resident model weights."""
        return sum(self._resident.values())

    def load(self, name: str) -> float:
        """Make ``name`` resident; returns the swap latency charged."""
        if name in self._resident:
            self._resident.move_to_end(name)
            return 0.0
        self.swap_count += 1
        self._resident[name] = self.sizes.get(name, 0)
        order = list(self._resident)
        for victim in evict_lru(order, self.sizes, self.capacity, protect=name):
            del self._resident[victim]
            self.evictions += 1
        return self.load_latency.get(name, 0.0)


class LMExecutor:
    """Executes scheduled batches through an ``ExecutorBackend``.

    The executor owns the residency accounting (its ``SwapManager``, sized
    by ``backend.model_bytes`` and charged at ``backend.swap_cost`` per
    cold load); the backend runs the forward passes.  Without an explicit
    ``backend`` the default is ``ProfiledBackend(variants, new_tokens,
    device)`` ({name: (ModelConfig, seed)}), on the card unless
    ``device="cpu"`` is named.

    Classification convention of the paper's applications: each request
    carries its prompt ids (``prompt_fn``); the predicted class is the
    argmax over the logits of ``class_token_ids`` after prefill.
    """

    def __init__(self, variants: Mapping[str, tuple] | None = None,
                 capacity_bytes: int | None = None, new_tokens: int = 4,
                 backend: ExecutorBackend | None = None, device=None):
        if backend is None:
            if variants is None:
                raise ValueError("LMExecutor needs variants=... or backend=...")
            backend = ProfiledBackend(variants, new_tokens=new_tokens, device=device)
        self.backend = backend
        self.variants = dict(backend.variants)
        self.new_tokens = backend.new_tokens
        sizes = {name: int(backend.model_bytes(name)) for name in self.variants}
        loads = {name: float(backend.swap_cost(name)) for name in self.variants}
        self.swaps = SwapManager(capacity_bytes, sizes, loads)

    def run_batch(self, model_name: str, prompts: np.ndarray, request_ids: list,
                  class_token_ids: Optional[np.ndarray] = None) -> ExecutionReport:
        """prompts: (B, S) int32 (pre-padded)."""
        swap_s = self.swaps.load(model_name)
        report = self.backend.run_batch(model_name, prompts, request_ids, class_token_ids)
        report.swap_s = swap_s
        return report

    @staticmethod
    def _pad(batch: Sequence[ScheduleEntry],
             prompt_fn: Callable[[Request], np.ndarray]) -> np.ndarray:
        """Prompts right-padded with 0 to the longest; the backend reads
        the logits of the last position even for shorter prompts, as the
        reference does."""
        prompts = [prompt_fn(e.request) for e in batch]
        maxlen = max(p.shape[0] for p in prompts)
        padded = np.zeros((len(prompts), maxlen), np.int32)
        for k, p in enumerate(prompts):
            padded[k, :p.shape[0]] = p
        return padded

    def run_entry_batch(self, batch: Sequence[ScheduleEntry],
                        prompt_fn: Callable[[Request], np.ndarray],
                        class_token_ids=None) -> ExecutionReport:
        """Execute ONE batch of schedule entries (same model and batch_id)."""
        if batch[0].model.endswith(":short_circuit"):
            # §V-C1: answered by the SneakPeek stage — no model execution,
            # no swap, no prompt tokenisation or padding.
            return ExecutionReport(
                request_ids=[e.request.rid for e in batch], model=batch[0].model,
                batch_size=len(batch), swap_s=0.0, prefill_s=0.0, decode_s=0.0,
                tokens=np.zeros((len(batch), 0), np.int32),
                predictions=[None] * len(batch))
        return self.run_batch(
            batch[0].model, self._pad(batch, prompt_fn),
            [e.request.rid for e in batch], class_token_ids)

    def execute_schedule(self, schedule: Schedule, prompt_fn: Callable[[Request], np.ndarray],
                         class_token_ids=None) -> list[ExecutionReport]:
        """Run a scheduler-produced schedule batch by batch: entries that
        share a batch_id execute as one padded batch."""
        return [self.run_entry_batch(batch, prompt_fn, class_token_ids)
                for batch in iter_entry_batches(schedule.sorted_entries())]


def iter_entry_batches(entries: Sequence[ScheduleEntry]):
    """Group an ordered entry list into dispatchable batches: maximal runs
    of consecutive entries sharing (batch_id >= 0, model) — the grouping
    rule ``evaluate`` replays with, so realised batches match the
    scheduler's batching decisions."""
    i = 0
    while i < len(entries):
        j = i
        while (
            j + 1 < len(entries)
            and entries[j + 1].batch_id == entries[i].batch_id
            and entries[i].batch_id >= 0
            and entries[j + 1].model == entries[i].model
        ):
            j += 1
        yield entries[i : j + 1]
        i = j + 1
