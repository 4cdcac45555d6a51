"""Synthetic application testbed of the port (``data.applications``) and
its LM token pipeline (``data.lm_data``).

Exports the names the reference's ``repro.data`` exports.  ``NOT_PORTED``
would name any the port did not have yet, with the ROADMAP label that
brings it; it is empty.
"""
from repro_torch.data.applications import (
    APP_SPECS,
    AppSpec,
    build_benchmark_suite,
    make_application,
    make_dataset,
    make_requests,
    make_sneakpeek,
)
from repro_torch.data.lm_data import LMDataConfig, LMDataset

# Names of the reference's ``repro.data`` this port does not have yet,
# with the ROADMAP item ("Open items" -> "Modules to port") that brings each.
NOT_PORTED: dict[str, str] = {}

__all__ = [
    "APP_SPECS", "AppSpec", "build_benchmark_suite", "make_application",
    "make_dataset", "make_requests", "make_sneakpeek", "LMDataConfig", "LMDataset",
    "NOT_PORTED",
]


def __getattr__(name: str):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"{name!r} is not ported to repro_torch yet: see ROADMAP.md, "
            f"'Modules to port', {NOT_PORTED[name]}"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
