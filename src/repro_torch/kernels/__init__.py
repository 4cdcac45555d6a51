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

The counts are process-wide and several threads may launch at once (the
lanes of an ``ExecutorPool``), so a launch is added under a lock, and
each thread also keeps its own tally (``thread_launch_counts``) of the
launches it caused, replays and ``add_launches`` included: a capture
attributes to its graph only the launches of the thread that captured
it, never a concurrent lane's, and a lane can tell its own launches
apart.  A process lane's launches happen in its own process; its
parent's lane thread adds them with ``add_launches``.

A kernel's output carries no gradient path of its own: only K3, K5 and
the RG-LRU scan have backward kernels (K3b, K5b, ``rglru_scan_bwd``),
reached through the autograd functions of ``models.attention``,
``models.ssd`` and ``models.rglru``.  So every wrapper calls
``refuse_grad`` before it launches on the card, and a CUDA call whose
input requires a gradient raises rather than return an output whose
gradient would silently be zero.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["LaunchCounter", "launch_counts", "reset_launch_counts", "add_launches",
           "thread_launch_counts", "records_grad", "refuse_grad", "GRADIENTS_RULE"]

# The ROADMAP label of the rule for kernels without a backward.
GRADIENTS_RULE = "ROADMAP.md, 'Port rules', Gradients"

_LOCK = threading.Lock()
_LOCAL = threading.local()


class LaunchCounter:
    """Number of times one kernel was launched (host-side, not synchronised).

    Registering a name that ``add_launches`` met first keeps its count."""

    def __init__(self, name: str):
        self.name = name
        with _LOCK:
            old = _COUNTERS.get(name)
            self.count = old.count if old is not None else 0
            _COUNTERS[name] = self

    def add(self) -> None:
        """Record one launch; wrappers call this right where they launch."""
        with _LOCK:
            self.count += 1
        tally = _tally()
        tally[self.name] = tally.get(self.name, 0) + 1


_COUNTERS: dict[str, LaunchCounter] = {}


def _tally() -> dict[str, int]:
    tally = getattr(_LOCAL, "tally", None)
    if tally is None:
        tally = _LOCAL.tally = {}
    return tally


def launch_counts() -> dict[str, int]:
    """{kernel name: launches} for every kernel whose wrapper was imported."""
    with _LOCK:
        return {name: c.count for name, c in _COUNTERS.items()}


def thread_launch_counts() -> dict[str, int]:
    """{kernel name: launches} the calling thread has caused since it
    started: its wrappers' launches and what it passed to ``add_launches``
    (never reset; compare two readings)."""
    return dict(_tally())


def reset_launch_counts() -> None:
    """Set every launch count to 0 (done just before a measured run)."""
    with _LOCK:
        for c in _COUNTERS.values():
            c.count = 0


def add_launches(counts: dict[str, int]) -> None:
    """Add ``{kernel name: launches}`` to the counts (negative to take
    back what a graph capture counted)."""
    for name in counts:
        if name not in _COUNTERS:
            LaunchCounter(name)
    with _LOCK:
        for name, n in counts.items():
            _COUNTERS[name].count += n
    tally = _tally()
    for name, n in counts.items():
        tally[name] = tally.get(name, 0) + n


def records_grad(*tensors) -> bool:
    """Whether autograd is recording and one of ``tensors`` (None allowed)
    requires a gradient."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def refuse_grad(kernel: str, where: str, *tensors) -> None:
    """Raise if ``records_grad(*tensors)``: the CUDA launch of ``kernel``
    would return an output with no gradient path.  ``where`` names what to
    call instead, or the ROADMAP label of the backward still to write."""
    if records_grad(*tensors):
        raise RuntimeError(
            f"{kernel}: an input requires a gradient, and the kernel's output on the card "
            f"would carry none; {where}")
