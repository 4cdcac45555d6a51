"""Serving plane of the port: ``EdgeServer`` over a single ``LMExecutor``
or an ``ExecutorPool`` of worker lanes, the executor backends
(``ProfiledBackend``, ``CompiledBackend``, ``SimulatedBackend``) and the
fault injection of the closed loop (``FaultPlan``, ``FaultInjector``).

The names the reference's ``repro.serving`` exports that the port has
are exported here, imported on first access.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "backends": ("CompiledBackend", "CostModelBackend", "ExecutorBackend",
                 "ProfiledBackend", "SimulatedBackend"),
    "faults": ("FaultInjector", "FaultPlan", "FaultSpec"),
    "runtime": ("LANE_NAMES", "BatchFailure", "ExecutionReport", "ExecutorPool",
                "LMExecutor", "PendingExecution", "PoolOutcome", "ProcessLaneBackend",
                "SwapManager", "WindowQueue", "WorkerExecutor"),
    "server": ("EdgeServer", "ServeStats"),
}
_MODULE_OF = {name: module for module, names in _EXPORTS.items() for name in names}
__all__ = sorted(_MODULE_OF)


def __getattr__(name: str):
    module = _MODULE_OF.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
