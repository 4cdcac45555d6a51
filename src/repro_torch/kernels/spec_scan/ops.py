"""Wrapper of the chunked selection-scan kernel: a window's speculative
chunked Eq. 2/13 selection (``core.pipeline`` with ``chunk`` > 0), one
launch per window.

Tensors on the CPU take the plain version (``ref.py``); CUDA tensors
launch ``csrc/spec_scan.cu`` on the current stream, or raise.  There is
no other route.  The arguments are ``selection_scan``'s, checked by its
wrapper's rules (``selection_scan.ops``), with the chunk size; the carry's
slots and a round's per-position rows must fit one block's shared memory
(``selection_scan.ops.smem_bytes``, ROADMAP §3 P7).  The kernel has two
instances, chosen from the shapes alone: a warp a position when a step's
W * B * M cells fit one (``instance``, the sequential scan's rule), else
a block of 512 threads in a cluster of ``blocks`` blocks that share each
pass's Eq. 2 tile, a slice of its cells each, and its member sums, a warp
a column.  The wrapper allocates the output, the kernel's
scratch tile, the (chunk - 1, W, K) pre-state slots and the (3, chunk)
chain inputs (used where they do not fit shared memory) with
``torch.empty`` and synchronises nothing.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import GRADIENTS_RULE, LaunchCounter, nvcc, refuse_grad
from repro_torch.kernels.selection_scan.ops import _check_args, _seed, instance
from repro_torch.kernels.spec_scan.ref import spec_scan_ref

__all__ = ["spec_scan", "launch", "counter", "instance", "blocks", "TILE_CELLS_A_BLOCK",
           "MAX_CLUSTER"]

counter = LaunchCounter("spec_scan")

_P = ctypes.c_void_p
_I = ctypes.c_int
# A round's Eq. 2 tile cells one block of the cluster takes, at most, and
# the cluster's most blocks (the portable size).
TILE_CELLS_A_BLOCK = 8192
MAX_CLUSTER = 8


def blocks(chunk: int, n_w: int, members: int, m: int, fixed: bool = False) -> int:
    """Blocks of the cluster the block instance spreads a round's (chunk,
    W, B, M) Eq. 2 tile over, a slice of its cells each: one per
    TILE_CELLS_A_BLOCK cells, at most MAX_CLUSTER; one for the warp
    instance and for fixed choices (no tile)."""
    if fixed or instance(n_w, members, m) == "warp":
        return 1
    return max(1, min(MAX_CLUSTER, -(-chunk * n_w * members * m // TILE_CELLS_A_BLOCK)))


def _entry():
    lib = nvcc.library("spec_scan")
    fn = lib.spec_scan_f64
    fn.argtypes = [_P, _P, _P, ctypes.c_double] + [_P] * 16 + [_I] * 10 + [_P]
    fn.restype = _I
    return lib, fn


def spec_scan(t0, res0, sizes, cap: float, res_mode: str, acc, mask, deadlines, bsize, lat,
              step_app, swap, gid, valid, pen, pref, fixed_sel=None, *,
              chunk: int) -> torch.Tensor:
    """The S decisions of one window, speculated ``chunk`` at a time, as a
    (4, S + 1) float64 tensor on ``acc``'s device: columns ``:S`` the
    worker index, model column, start and latency of each decision —
    equal bit for bit to ``selection_scan``'s rows on the same arguments
    — and column ``S`` the rounds and conflicts (rows 0 and 1).
    Arguments as ``selection_scan.ops.selection_scan``."""
    chunk = int(chunk)
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    # A round never holds more positions than the window has, so a chunk
    # past S runs as S: the same rounds, conflicts and decisions, and no
    # carry is kept for a position that cannot exist.
    chunk = max(1, min(chunk, acc.shape[0]))
    t0, res0, sizes, cap = _seed(t0, res0, sizes, cap, res_mode)
    n_w = len(t0)
    _check_args(acc, mask, deadlines, bsize, lat, step_app, swap, gid, valid, pen, pref,
                fixed_sel, n_w, res0.shape[1], chunk)
    dev = acc.device
    slot1 = res_mode == "slot1"
    if dev.type == "cpu":
        return spec_scan_ref(
            chunk, torch.from_numpy(t0), torch.from_numpy(res0), torch.from_numpy(sizes), cap,
            slot1, acc, mask, deadlines, bsize, lat, step_app, swap, gid, valid, pen, pref,
            fixed_sel,
        )
    if dev.type != "cuda":
        raise ValueError(f"spec_scan runs on CUDA or the CPU, not {dev}")
    if acc.shape[0] == 0:
        return torch.zeros((4, 1), dtype=torch.float64, device=dev)
    seed = [torch.as_tensor(x, device=dev) for x in (t0, res0, sizes)]
    return launch(seed, cap, res_mode, acc, mask, deadlines, bsize, lat, step_app, swap, gid,
                  valid, pen, pref, fixed_sel, chunk=chunk)


def launch(seed, cap: float, res_mode: str, acc, mask, deadlines, bsize, lat, step_app, swap,
           gid, valid, pen, pref, fixed_sel=None, *, chunk: int) -> torch.Tensor:
    """The kernel's launch for arguments ``spec_scan`` has checked, with
    the carry seed (t0, res0, sizes) already on the card: allocates the
    output, the (chunk, W, B, M) scratch tile (the block instance's), the
    (chunk - 1, W, K) pre-state slots and the (3, chunk) chain inputs,
    launches on the current stream and returns without synchronising."""
    dev = acc.device
    s, b, m = acc.shape
    n_w = lat.shape[1]
    tabs = [x.contiguous() for x in (acc, mask, deadlines, bsize, lat, step_app, swap, gid,
                                     valid, pen, pref)]
    fixed = fixed_sel.contiguous() if fixed_sel is not None else None
    out = torch.empty((4, s + 1), dtype=torch.float64, device=dev)
    warp = instance(n_w, b, m) == "warp"
    n_blocks = blocks(chunk, n_w, b, m, fixed is not None)
    tile = None if warp else torch.empty((chunk, n_w, b if fixed is None else 1, m),
                                         dtype=torch.float64, device=dev)
    seed = [x.contiguous() for x in seed]
    res_st = torch.empty((max(chunk - 1, 1),) + tuple(seed[1].shape), dtype=torch.int64,
                         device=dev)
    stage = torch.empty((3, chunk), dtype=torch.float64, device=dev)
    lib, fn = _entry()
    refuse_grad("spec_scan", f"it has no backward ({GRADIENTS_RULE})", *tabs)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*[x.data_ptr() for x in seed], cap, *[x.data_ptr() for x in tabs],
                 fixed.data_ptr() if fixed is not None else None,
                 tile.data_ptr() if tile is not None else None, out.data_ptr(),
                 res_st.data_ptr(), stage.data_ptr(),
                 s, b, m, n_w, seed[1].shape[1], seed[2].shape[1], int(res_mode == "slot1"),
                 chunk, int(warp), n_blocks, stream)
    counter.add()
    nvcc.check(lib, err, "spec_scan")
    return out
