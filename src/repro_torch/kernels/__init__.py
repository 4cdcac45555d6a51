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

Two more routes exist for tracing a step without running it (the dry
run, ``launch.dryrun``).  On a ``FakeTensor`` (``is_fake``: shapes and
types, no storage) a wrapper takes a branch that only fake tensors reach:
it allocates the kernel's outputs and scratch as fake tensors, calls the
kernel's shape-only operator (``torch.ops.repro_torch.<name>``, whose
work a formula registered with ``torch.utils.flop_counter`` counts) and
counts a launch on its counter's ``fake`` tally (``fake_launch_counts``),
never on the real one.  On a ``DTensor`` (a sharded serving step,
``launch.steps.make_sharded_prefill_step``) a wrapper calls itself on each
rank's shards through ``on_shards``: batch rows over the mesh's data
axes and heads (or channels) over its ``model`` axis where they divide,
so no DTensor reaches a kernel.
"""
from __future__ import annotations

import threading

import torch
from torch._subclasses.fake_tensor import is_fake as _is_fake
from torch.distributed.tensor import DTensor

__all__ = ["LaunchCounter", "launch_counts", "reset_launch_counts", "add_launches",
           "thread_launch_counts", "records_grad", "refuse_grad", "GRADIENTS_RULE",
           "fake_launch_counts", "is_fake", "is_sharded", "on_shards"]

# The ROADMAP label of the rule for kernels without a backward.
GRADIENTS_RULE = "ROADMAP.md, 'Port rules', Gradients"

_LOCK = threading.Lock()
_LOCAL = threading.local()


class LaunchCounter:
    """Number of times one kernel was launched (host-side, not synchronised).

    Registering a name that ``add_launches`` met first keeps its count.
    ``fake`` counts the calls that took the fake-tensor branch instead."""

    def __init__(self, name: str):
        self.name = name
        with _LOCK:
            old = _COUNTERS.get(name)
            self.count = old.count if old is not None else 0
            self.fake = old.fake if old is not None else 0
            _COUNTERS[name] = self

    def add(self) -> None:
        """Record one launch; wrappers call this right where they launch."""
        with _LOCK:
            self.count += 1
        tally = _tally()
        tally[self.name] = tally.get(self.name, 0) + 1

    def add_fake(self) -> None:
        """Record one call of the fake-tensor branch (no launch)."""
        with _LOCK:
            self.fake += 1


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


def fake_launch_counts() -> dict[str, int]:
    """{kernel name: calls of its fake-tensor branch} (the launches a traced
    step would make)."""
    with _LOCK:
        return {name: c.fake for name, c in _COUNTERS.items()}


def reset_launch_counts() -> None:
    """Set every launch count, real and fake, to 0 (done just before a
    measured run)."""
    with _LOCK:
        for c in _COUNTERS.values():
            c.count = 0
            c.fake = 0


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


def is_fake(t) -> bool:
    """Whether ``t`` is a ``FakeTensor`` (a traced step's stand-in), or a
    DTensor whose shards are.  A plain ``torch.Tensor`` is answered at
    once: the wrappers ask on every call."""
    return isinstance(t, torch.Tensor) and type(t) is not torch.Tensor and _is_fake(t)


def is_sharded(t) -> bool:
    """Whether ``t`` is a ``DTensor``."""
    return isinstance(t, DTensor)


def on_shards(fn, args: tuple, dims: tuple, out_dims: tuple):
    """``fn(*args)`` on every rank's shards, through ``local_map``.

    ``dims`` gives, per argument, (batch dim, head dim) or None for an
    argument that is no tensor (None included) or is kept whole; one
    entry of the pair may be None.  The batch dims are split over
    ``distributed.sharding.row_axes`` of every batch size, the head dims
    over ``model`` when every one divides (``heads_divide``); anything
    else is replicated.
    Plain tensors among the arguments count as replicated.  ``out_dims``
    gives the same pairs for ``fn``'s outputs (a tuple of tensors, or one
    tensor when ``out_dims`` has one entry)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.sharding import heads_divide, row_axes, rows_heads

    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    tensors = [(a, d) for a, d in zip(args, dims) if d is not None]
    rows_on = row_axes(mesh, *(a.shape[d[0]] for a, d in tensors if d[0] is not None))
    split_heads = heads_divide(mesh, *(a.shape[d[1]] for a, d in tensors if d[1] is not None))

    def placements(pair):
        if pair is None:
            return None
        return rows_heads(mesh, rows_on, pair[0], pair[1] if split_heads else None)

    ins = []
    for a, d in zip(args, dims):
        if d is not None and not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
        ins.append(a)
    outs = tuple(placements(p) for p in out_dims)
    mapped = local_map(fn, out_placements=outs,
                       in_placements=tuple(placements(d) for d in dims),
                       redistribute_inputs=True, device_mesh=mesh)
    return mapped(*ins)
