"""SneakPeek core of the PyTorch port: the scheduling window's modules.

Each module mirrors its namesake in the JAX package (``repro.core``),
and the names the reference's ``repro.core`` exports that the port has
are exported here too.  They are imported on first access, so importing
this package imports only ``core.utility`` and a light module stays
cheap to import.  ``utility`` is also the name of its module, and
importing a submodule binds it on its package, where a lazy name would
then find the module: so the function is bound here at once.

The reference's ``set_utility_backend`` (numpy or Pallas for the batched
Eq. 2 scores) has no counterpart (ROADMAP §3, P15): here the device
decides, K1 on the card and its plain float64 version on the CPU.
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
                 "fast_per_request_schedule", "precompute_windows"),
    "grouping": ("group_by_app", "grouped_schedule", "split_groups_by_label"),
    "health": ("HealthConfig", "HealthTracker", "WorkerHealth"),
    "multiworker": ("Worker", "multiworker_schedule"),
    "pipeline": ("WindowPipeline", "get_pipeline_backend", "pipeline_schedule",
                 "set_pipeline_backend"),
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

from repro_torch.core.utility import utility  # noqa: E402


def __getattr__(name: str):
    module = _MODULE_OF.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
