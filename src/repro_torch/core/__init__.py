"""SneakPeek core of the PyTorch port: the scheduling window's modules.

Each module mirrors its namesake in the JAX package (``repro.core``),
and the names the reference's ``repro.core`` exports that the port has
are exported here too.  They are imported on first access, so importing
this package imports nothing and a light module such as
``core.utility`` stays cheap to import.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "accuracy": ("ModelProfile", "accuracy_from_confusion", "confusion_with_accuracy",
                 "expected_accuracy", "recalls_from_confusion"),
    "dirichlet": ("DirichletPrior", "jeffreys_prior", "posterior", "posterior_mean",
                  "strongly_informative_prior", "weakly_informative_prior"),
    "evaluation": ("EvalResult", "WorkerTimeline", "evaluate"),
    "fastpath": ("WindowArrays", "fast_grouped_schedule", "fast_multiworker_schedule",
                 "fast_per_request_schedule"),
    "grouping": ("group_by_app", "grouped_schedule", "split_groups_by_label"),
    "health": ("HealthConfig", "HealthTracker", "WorkerHealth"),
    "multiworker": ("Worker", "multiworker_schedule"),
    "pipeline": ("WindowPipeline", "pipeline_schedule"),
    "priority": ("group_priority", "request_priorities", "request_priority"),
    "scheduler": ("POLICY_NAMES", "SchedulerPolicy", "effective_apps", "make_policy",
                  "schedule_window"),
    "shard": ("ShardedWindowPipeline",),
    "simulator": ("Simulation", "WindowResult", "run_window"),
    "sneakpeek": ("ConfusionSneakPeek", "DecisionRuleSneakPeek", "KNNSneakPeek",
                  "SneakPeekModel", "attach_sneakpeek", "ingest_window"),
    "streaming": ("StreamingState",),
    "types": ("Application", "Request", "Schedule", "ScheduleEntry"),
    "utility": ("PENALTIES", "utility"),
}
_MODULE_OF = {name: module for module, names in _EXPORTS.items() for name in names}
__all__ = sorted(_MODULE_OF)


def __getattr__(name: str):
    module = _MODULE_OF.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
