"""Wrapper of the selection-scan kernel: the sequential Eq. 2/13 selection
of one scheduling window (``core.pipeline``'s three programs), one launch
per window.

Tensors on the CPU take the plain version (``ref.py``); CUDA tensors
launch ``csrc/selection_scan.cu`` on the current stream, or raise.  There
is no other route.  The kernel has two instances, chosen by ``instance``
from the shapes alone: one warp when a step's W * B * M cells fit it,
else one block.  The wrapper allocates the outputs and, for the block
instance, the kernel's scratch tile with ``torch.empty`` and synchronises
nothing.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import GRADIENTS_RULE, LaunchCounter, nvcc, refuse_grad
from repro_torch.kernels.selection_scan.ref import selection_scan_ref

__all__ = ["selection_scan", "launch", "instance", "counter", "smem_bytes", "MAX_SMEM_BYTES",
           "WARP"]

counter = LaunchCounter("selection_scan")

# The most shared memory one block may opt in to on Hopper (sm_90): the
# scan's carry and step rows must fit it (ROADMAP §3, P7).
MAX_SMEM_BYTES = 227 * 1024
_EXACT = float(2**53)  # integers below it add exactly in float64
WARP = 32  # lanes of a warp: the warp instance's cells a step

_P = ctypes.c_void_p
_I = ctypes.c_int


def smem_bytes(n_w: int, n_slots: int, m: int, chunk: int = 0) -> int:
    """Shared bytes of one launch of the sequential scan (``chunk`` 0;
    csrc: scan_smem_bytes) — the (W, K) LRU slots, the (W,) queue tails,
    the step's (W, M) completions and means (8 bytes each) and its (W, M)
    residency flags (one byte each), which the block instance keeps and
    the warp instance, with the slots and tails alone, stays under — or of
    the chunked scan
    (``kernels.spec_scan``; csrc: spec_smem_bytes): the (W, K) slots, and
    per position of a round, C = ``chunk`` of them, its (W,) pre-state
    tails, (W, M) completions, means and flags and its two picks (4 bytes
    each).  The chunked scan stages more there only where it fits
    beside this sum (the rebuild's inputs, each position's pre-state
    slots, the LRU sizes), and keeps in device memory what does not; so
    what must fit, and what P7 bounds, is this sum, whose ids K do not
    multiply by the chunk."""
    if chunk:
        cells = chunk * n_w * m
        return 8 * (n_w * n_slots + chunk * n_w + 2 * cells + chunk) + cells
    return 8 * (n_w * n_slots + n_w + 2 * n_w * m) + n_w * m


def instance(n_w: int, members: int, m: int) -> str:
    """The kernel instance a scan of ``n_w`` workers, ``members`` (the
    tables' padded member count B) and ``m`` models runs: ``"warp"`` when a
    step's W * B * M cells fit one warp, a lane each, else ``"block"``."""
    return "warp" if n_w * members * m <= WARP else "block"


def _entry():
    lib = nvcc.library("selection_scan")
    fn = lib.selection_scan_f64
    fn.argtypes = [_P, _P, _P, ctypes.c_double] + [_P] * 14 + [_I] * 8 + [_P]
    fn.restype = _I
    return lib, fn


def _seed(t0, res0, sizes, cap, res_mode):
    """Check the carry seed on the host: the LRU rule is exact only for
    integer byte counts whose per-worker total stays below 2^53."""
    if res_mode not in ("slot1", "lru"):
        raise ValueError(f"unknown residency mode {res_mode!r}")
    t0 = np.ascontiguousarray(t0, dtype=np.float64).reshape(-1)
    res0 = np.ascontiguousarray(res0, dtype=np.int64).reshape(len(t0), -1)
    sizes = np.ascontiguousarray(sizes, dtype=np.float64).reshape(len(t0), -1)
    if res_mode == "slot1" and res0.shape[1] != 1:
        raise ValueError(f"slot1 residency carries one id per worker, got {res0.shape}")
    if res_mode == "lru":
        if not (np.all(sizes >= 0) and np.all(sizes == np.floor(sizes))
                and np.all(sizes.sum(axis=1) < _EXACT)):
            raise ValueError("LRU sizes must be integer byte counts whose per-worker "
                             "total is below 2**53")
        if res0.shape[1] < sizes.shape[1]:
            raise ValueError(f"{res0.shape[1]} LRU slots for {sizes.shape[1]} model ids")
    return t0, res0, sizes, float(cap)


def _check_args(acc, mask, deadlines, bsize, lat, step_app, swap, gid, valid, pen, pref,
                fixed_sel, n_w, n_slots, chunk: int = 0):
    s, b, m = acc.shape
    a = gid.shape[0]
    shapes = {
        "mask": (mask, (s, b), torch.float64), "deadlines": (deadlines, (s, b), torch.float64),
        "bsize": (bsize, (s,), torch.float64), "lat": (lat, (s, n_w, m), torch.float64),
        "step_app": (step_app, (s,), torch.int64), "swap": (swap, (a, n_w, m), torch.float64),
        "gid": (gid, (a, m), torch.int64), "valid": (valid, (a, m), torch.bool),
        "pen": (pen, (a,), torch.int64), "pref": (pref, (a, n_w * m), torch.int64),
    }
    if fixed_sel is not None:
        shapes["fixed_sel"] = (fixed_sel, (s,), torch.int64)
    if acc.dtype != torch.float64:
        raise TypeError(f"acc must be float64, got {acc.dtype}")
    for name, (x, shape, dtype) in shapes.items():
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got {tuple(x.shape)} {x.dtype}")
        if x.device != acc.device:
            raise ValueError(f"{name} is on {x.device}, acc on {acc.device}")
    need = smem_bytes(n_w, n_slots, m, chunk)
    if need > MAX_SMEM_BYTES:
        per = f", C={chunk} speculated positions" if chunk else ""
        raise ValueError(
            f"the scan's carry needs {need} bytes of shared memory for W={n_w} workers, "
            f"K={n_slots} model ids and M={m} models{per}, over the {MAX_SMEM_BYTES} one "
            f"block has (ROADMAP §3, P7)")


def selection_scan(t0, res0, sizes, cap: float, res_mode: str, acc, mask, deadlines, bsize,
                   lat, step_app, swap, gid, valid, pen, pref, fixed_sel=None) -> torch.Tensor:
    """The S sequential decisions of one window as a (4, S) float64 tensor
    on ``acc``'s device: worker index, model column, start and latency.

    The carry seed is host data (numpy): ``t0`` (W,) queue-tail times,
    ``res0`` (W, K) resident ids (oldest first, -1 empty; K = 1 with
    ``res_mode="slot1"``), ``sizes`` (W, G) byte sizes per id and ``cap``
    the byte capacity (the "lru" rule; the single-slot model is unit sizes
    against 0).  The step tables are tensors on one device: ``acc`` (S, B,
    M), ``mask`` (S, B) — ones for the first ``bsize[s]`` members —,
    ``deadlines`` (S, B), ``bsize`` (S,), ``lat`` (S, W, M) and
    ``step_app`` (S,), the row of each step in the application tables
    ``swap`` (A, W, M), ``gid`` (A, M), ``valid`` (A, M) bool, ``pen`` (A,)
    penalty codes and ``pref`` (A, W*M) preference permutations.
    ``fixed_sel`` (S,) gives carry-free choices (MaxAcc): the scan then
    threads the carry only.  Float64 throughout: the decisions and times
    equal the reference's bit for bit.
    """
    t0, res0, sizes, cap = _seed(t0, res0, sizes, cap, res_mode)
    n_w = len(t0)
    _check_args(acc, mask, deadlines, bsize, lat, step_app, swap, gid, valid, pen, pref,
                fixed_sel, n_w, res0.shape[1])
    dev = acc.device
    slot1 = res_mode == "slot1"
    if dev.type == "cpu":
        return selection_scan_ref(
            torch.from_numpy(t0), torch.from_numpy(res0), torch.from_numpy(sizes), cap, slot1,
            acc, mask, deadlines, bsize, lat, step_app, swap, gid, valid, pen, pref, fixed_sel,
        )
    if dev.type != "cuda":
        raise ValueError(f"selection_scan runs on CUDA or the CPU, not {dev}")
    if acc.shape[0] == 0:
        return torch.empty((4, 0), dtype=torch.float64, device=dev)
    seed = [torch.as_tensor(x, device=dev) for x in (t0, res0, sizes)]
    return launch(seed, cap, res_mode, acc, mask, deadlines, bsize, lat, step_app, swap, gid,
                  valid, pen, pref, fixed_sel)


def launch(seed, cap: float, res_mode: str, acc, mask, deadlines, bsize, lat, step_app, swap,
           gid, valid, pen, pref, fixed_sel=None) -> torch.Tensor:
    """The kernel's launch for arguments ``selection_scan`` has checked,
    with the carry seed (t0, res0, sizes) already on the card: allocates
    the outputs and, for the block instance, the scratch tile, launches on
    the current stream and returns without synchronising."""
    dev = acc.device
    s, b, m = acc.shape
    n_w = lat.shape[1]
    tabs = [x.contiguous() for x in (acc, mask, deadlines, bsize, lat, step_app, swap, gid,
                                     valid, pen, pref)]
    fixed = fixed_sel.contiguous() if fixed_sel is not None else None
    out = torch.empty((4, s), dtype=torch.float64, device=dev)
    warp = instance(n_w, b, m) == "warp"
    tile = None if warp else torch.empty((n_w, b if fixed is None else 1, m),
                                         dtype=torch.float64, device=dev)
    lib, fn = _entry()
    refuse_grad("selection_scan", f"it has no backward ({GRADIENTS_RULE})", *tabs)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        seed = [x.contiguous() for x in seed]
        err = fn(*[x.data_ptr() for x in seed], cap, *[x.data_ptr() for x in tabs],
                 fixed.data_ptr() if fixed is not None else None,
                 tile.data_ptr() if tile is not None else None, out.data_ptr(),
                 s, b, m, n_w, seed[1].shape[1], seed[2].shape[1], int(res_mode == "slot1"),
                 int(warp), stream)
    counter.add()
    nvcc.check(lib, err, "selection_scan")
    return out
