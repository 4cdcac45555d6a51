"""Deterministic, seedable fault injection for the executor pool.

The counterpart of ``repro.serving.faults``: the same specs, the same
seeded draw, so a plan fires the same faults in the port as in the
reference.

The supervised execution path (``ExecutorPool.execute_supervised``)
polls a ``FaultInjector`` before each batch a lane dispatches; a match
makes the batch fail (or drag) WITHOUT touching the models, so the whole
withdraw -> retry -> health pipeline is exercisable deterministically in
tests, examples and CI smoke runs.

Fault kinds (``FaultSpec.kind``):

  * ``"crash"``      — the lane dies at this batch: the batch and every
    batch after it on the lane fail (the later ones marked ``cascaded``).
  * ``"transient"``  — this one batch fails; the lane continues.
  * ``"swap_fail"``  — the model swap fails; semantically identical to a
    transient at the runtime level (the batch never runs) but reported
    with its own kind so health/retry policies can distinguish it.
  * ``"hang"``       — a straggler: the batch RUNS but its report is
    inflated by ``delay_s`` (no real sleep — the delay flows through the
    realized-latency EWMA exactly like a genuinely slow lane would).

Faults address (window, worker, batch-index) with ``None`` as wildcard,
and fire at most ``count`` times (``None`` = unlimited).  On top of the
deterministic specs, ``FaultPlan.rates`` adds seeded stochastic faults:
the draw is keyed by ``(seed, window, worker, batch)`` so a given plan
produces the SAME fault sequence on every run regardless of lane thread
interleaving.  (Deterministic specs with a shared ``count`` and a
wildcard worker are matched under a lock in poll order, which can vary
across lane threads — pin ``worker`` for strict cross-run determinism.)
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Sequence

import numpy as np

__all__ = ["FaultSpec", "FaultPlan", "FaultInjector", "FAULT_KINDS"]

FAULT_KINDS = ("crash", "transient", "swap_fail", "hang")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injected fault: kind + (window, worker, batch) address.

    ``None`` address fields are wildcards; ``count`` bounds how many
    times the spec fires (``None`` = unlimited).  ``delay_s`` is the
    straggler inflation for ``kind="hang"``."""

    kind: str
    window: int | None = None
    worker: int | None = None
    batch: int | None = None
    delay_s: float = 0.0
    count: int | None = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")

    def matches(self, window: int, worker: int, batch: int) -> bool:
        """Does this spec address (window, worker, batch)?"""
        return (
            (self.window is None or self.window == window)
            and (self.worker is None or self.worker == worker)
            and (self.batch is None or self.batch == batch)
        )


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A reproducible fault scenario: deterministic specs + seeded rates.

    ``specs`` fire first (list order, respecting per-spec counts);
    ``rates`` (``{kind: probability}``) then draw one seeded uniform per
    (window, worker, batch) — fully deterministic given ``seed``.
    ``hang_delay_s`` is the straggler inflation for stochastic hangs."""

    specs: tuple = ()
    seed: int = 0
    rates: tuple = ()  # ((kind, probability), ...) — dicts accepted in __init__
    hang_delay_s: float = 0.05

    def __post_init__(self):
        object.__setattr__(self, "specs", tuple(self.specs))
        rates = self.rates
        if isinstance(rates, dict):
            rates = tuple(sorted(rates.items()))
        object.__setattr__(self, "rates", tuple(rates))
        for kind, p in self.rates:
            if kind not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {kind!r}")
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"rate for {kind!r} outside [0, 1]: {p}")
        if sum(p for _, p in self.rates) > 1.0:
            raise ValueError("fault rates sum past 1.0")


class FaultInjector:
    """Stateful poll interface over a ``FaultPlan`` (thread-safe).

    ``poll(window, worker, batch, rids)`` returns the ``FaultSpec`` to
    apply to that batch (or ``None``), decrementing spec fire counts and
    appending to ``log`` — the fired-fault record tests assert against.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._remaining = [s.count for s in plan.specs]
        self._lock = threading.Lock()
        # Fired faults: (window, worker, batch, kind, rids tuple).
        self.log: list[tuple] = []

    def poll(self, window: int, worker: int, batch: int,
             rids: Sequence[int] = ()) -> FaultSpec | None:
        """The fault (if any) to inject into this (window, worker, batch)."""
        with self._lock:
            for i, spec in enumerate(self.plan.specs):
                if not spec.matches(window, worker, batch):
                    continue
                if self._remaining[i] is not None:
                    if self._remaining[i] <= 0:
                        continue
                    self._remaining[i] -= 1
                self.log.append((window, worker, batch, spec.kind, tuple(rids)))
                return spec
            if self.plan.rates:
                rng = np.random.default_rng(
                    (self.plan.seed, int(window), int(worker), int(batch))
                )
                u = float(rng.random())
                acc = 0.0
                for kind, p in self.plan.rates:
                    acc += p
                    if u < acc:
                        spec = FaultSpec(
                            kind=kind, window=window, worker=worker, batch=batch,
                            delay_s=self.plan.hang_delay_s if kind == "hang" else 0.0,
                        )
                        self.log.append((window, worker, batch, kind, tuple(rids)))
                        return spec
        return None

    def fired(self, kind: str | None = None) -> int:
        """Number of faults fired so far (optionally of one kind)."""
        with self._lock:
            if kind is None:
                return len(self.log)
            return sum(1 for entry in self.log if entry[3] == kind)
