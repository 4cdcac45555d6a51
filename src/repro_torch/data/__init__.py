"""Synthetic application testbed of the port (``data.applications``).

Exports the names the reference's ``repro.data`` exports.  Its LM data
pipeline (``LMDataConfig``, ``LMDataset``) is ROADMAP item 12 and not
ported yet: those names raise under that label (``NOT_PORTED``).
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

# Names of the reference's ``repro.data`` this port does not have yet,
# with the ROADMAP item ("Open items" -> "Modules to port") that brings each.
NOT_PORTED: dict[str, str] = {
    "LMDataConfig": "item 12 (training and distribution, src/repro/data/lm_data.py)",
    "LMDataset": "item 12 (training and distribution, src/repro/data/lm_data.py)",
}

__all__ = [
    "APP_SPECS", "AppSpec", "build_benchmark_suite", "make_application",
    "make_dataset", "make_requests", "make_sneakpeek", "NOT_PORTED",
]


def __getattr__(name: str):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"{name!r} is not ported to repro_torch yet: see ROADMAP.md, "
            f"'Modules to port', {NOT_PORTED[name]}"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
