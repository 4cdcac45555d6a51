"""Hand-written CUDA kernels of the port, one subpackage each.

Each subpackage holds ``csrc/<name>.cu`` (the kernel, built for
``sm_90a`` by ``kernels.nvcc``), ``ref.py`` (its plain PyTorch version)
and ``ops.py`` (the wrapper).  A wrapper runs the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.

Every wrapper counts its launches in a ``LaunchCounter`` registered
here, so a run can show that its main path went through the kernels.  A
CUDA graph replays its kernels without running the wrappers, and its
capture launches nothing: the code that captures a graph takes the
launches its capture counted back off (``add_launches`` with negative
counts) and adds them again at every replay, so the counts stay those
the card executed.
"""
from __future__ import annotations

__all__ = ["LaunchCounter", "launch_counts", "reset_launch_counts", "add_launches"]


class LaunchCounter:
    """Number of times one kernel was launched (host-side, not synchronised)."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        _COUNTERS[name] = self

    def add(self) -> None:
        """Record one launch; wrappers call this right where they launch."""
        self.count += 1


_COUNTERS: dict[str, LaunchCounter] = {}


def launch_counts() -> dict[str, int]:
    """{kernel name: launches} for every kernel whose wrapper was imported."""
    return {name: c.count for name, c in _COUNTERS.items()}


def reset_launch_counts() -> None:
    """Set every launch count to 0 (done just before a measured run)."""
    for c in _COUNTERS.values():
        c.count = 0


def add_launches(counts: dict[str, int]) -> None:
    """Add ``{kernel name: launches}`` to the counts (negative to take
    back what a graph capture counted)."""
    for name, n in counts.items():
        _COUNTERS[name].count += n
