"""Shared scheduler data model: applications, requests, schedules.

Mirrors the paper's system model (§II-B, §III-A): applications register
model variants + profiles + an SLO penalty; requests carry a deadline and
(optionally) the data needed for SneakPeek evidence.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.accuracy import ModelProfile, expected_accuracy
from repro_torch.core.dirichlet import DirichletPrior, jeffreys_prior
from repro_torch.core.utility import PENALTIES, PenaltyFn

__all__ = ["Application", "Request", "ScheduleEntry", "Schedule"]


@dataclasses.dataclass
class Application:
    """A registered application (paper §II-B).

    Attributes:
      name: unique application id.
      models: candidate model variants M_a (ModelProfile each).  Profiles
        carry per-class recalls, latency and swap cost.
      penalty: name of the deadline-penalty gamma_a ("step"/"linear"/
        "sigmoid"/"none").
      prior: Dirichlet prior over class frequencies for SneakPeek updates.
      expected_freqs: the application owner's long-run label distribution
        (used to build weak/strong priors and by benchmarks).
    """

    name: str
    models: list[ModelProfile]
    penalty: str = "sigmoid"
    prior: DirichletPrior | None = None
    expected_freqs: np.ndarray | None = None

    def __post_init__(self):
        if not self.models:
            raise ValueError(f"application {self.name!r} has no model variants")
        ncs = {m.num_classes for m in self.models}
        if len(ncs) != 1:
            raise ValueError(f"variants of {self.name!r} disagree on num_classes: {ncs}")
        if self.penalty not in PENALTIES:
            raise ValueError(f"unknown penalty {self.penalty!r}")
        if self.prior is None:
            self.prior = jeffreys_prior(self.num_classes)
        if self.expected_freqs is not None:
            self.expected_freqs = np.asarray(self.expected_freqs, dtype=np.float64)

    @property
    def num_classes(self) -> int:
        """Number of classes |C| shared by every variant."""
        return self.models[0].num_classes

    @property
    def penalty_fn(self) -> PenaltyFn:
        """The deadline-penalty callable gamma_a (Eq. 2)."""
        return PENALTIES[self.penalty]

    def model(self, name: str) -> ModelProfile:
        """Look up a variant profile by name."""
        for m in self.models:
            if m.name == name:
                return m
        raise KeyError(f"no variant {name!r} in application {self.name!r}")

    def accuracies(self, theta: np.ndarray | None = None) -> np.ndarray:
        """Accuracy(m | theta) for every variant (Eq. 9).

        theta=None -> profiled accuracies (uniform test split assumption
        unless profiles were built with explicit test frequencies).
        Short-circuit variants always use their profiled accuracy (§V-C1:
        "we must rely on profiled accuracy ... for SneakPeek models").
        """
        out = np.empty(len(self.models))
        for i, m in enumerate(self.models):
            if theta is None or m.is_short_circuit:
                out[i] = m.profiled_accuracy()
            else:
                out[i] = expected_accuracy(m.recalls, theta)
        return out


@dataclasses.dataclass(slots=True)
class Request:
    """An inference request r_i with deadline d_i (absolute seconds)."""

    rid: int
    app: str
    arrival_s: float
    deadline_s: float
    features: Optional[np.ndarray] = None
    true_label: Optional[int] = None
    # SneakPeek state, filled by the data-awareness stage:
    evidence: Optional[np.ndarray] = None  # multinomial counts y
    theta: Optional[np.ndarray] = None  # posterior mean E[theta | y]

    def time_to_deadline(self, now: float) -> float:
        """d_i relative to ``now`` (seconds; negative when expired)."""
        return self.deadline_s - now


@dataclasses.dataclass(slots=True)
class ScheduleEntry:
    """One scheduled inference: request -> (model, order, worker).

    ``order`` is the positive integer s_ij of the paper; entries with the
    same ``batch_id`` are dispatched as one batched inference (grouped
    scheduling) and share the model-load cost.
    """

    request: Request
    model: str
    order: int
    worker: int = 0
    batch_id: int = -1
    est_start_s: float = 0.0
    est_latency_s: float = 0.0

    @property
    def est_completion_s(self) -> float:
        """Committed completion time (start + batch latency)."""
        return self.est_start_s + self.est_latency_s


@dataclasses.dataclass
class Schedule:
    """An ordered assignment S = {s_ij} plus bookkeeping."""

    entries: list[ScheduleEntry] = dataclasses.field(default_factory=list)
    scheduling_overhead_s: float = 0.0
    # Speculative chunked-selection statistics of the pipeline (chunk,
    # decisions, rounds, conflicts, conflict_rate), None otherwise.
    chunk_stats: dict | None = None

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def sorted_entries(self) -> list[ScheduleEntry]:
        """Entries in execution order: (worker, order)."""
        return sorted(self.entries, key=lambda e: (e.worker, e.order))

    def validate(self) -> None:
        """Constraints 4-6: unique positive orders per worker, one model per request.

        C-level set/any passes on the happy path (validate runs on every
        scheduled window); a violation falls back to the original scan to
        raise the precise first offender.
        """
        entries = self.entries
        n = len(entries)
        if (
            not any(e.order <= 0 for e in entries)
            and len({e.request.rid for e in entries}) == n
            and len({(e.worker, e.order) for e in entries}) == n
        ):
            return
        seen_req: set[int] = set()
        seen_order: set[tuple[int, int]] = set()
        for e in entries:
            if e.order <= 0:
                raise ValueError(f"order must be positive, got {e.order}")
            if e.request.rid in seen_req:
                raise ValueError(f"request {e.request.rid} scheduled twice")
            seen_req.add(e.request.rid)
            key = (e.worker, e.order)
            if key in seen_order:
                raise ValueError(f"duplicate order {key}")
            seen_order.add(key)
        raise AssertionError("validate fast/slow paths disagree")
