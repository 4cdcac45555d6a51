"""Wrapper of the Eq. 2 utility kernel (K1), the port of
``repro.kernels.utility.ops.utility_scores``.

Tensors on the CPU take the plain version (``ref.py``); CUDA tensors
launch ``csrc/utility.cu`` on the current stream, or raise.  There is no
other route.  ``utility_plan`` computes the launch plan (block shape,
cluster size, chunk rows) from the shapes; the C entry validates it.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.core.utility import PENALTY_CODES
from repro_torch.kernels import GRADIENTS_RULE, LaunchCounter, nvcc, refuse_grad
from repro_torch.kernels.utility.ref import utility_scores_ref, utility_tile_ref

__all__ = ["utility_scores", "utility_plan", "UtilityPlan", "counter", "MAX_MODELS"]

counter = LaunchCounter("utility_scores")

MAX_MODELS = 256  # one thread per column sums the column
THREADS = 256  # a block is M x (THREADS // M) threads
MAX_CLUSTER = 8  # the portable cluster size: one summing block, up to 7 filling
SUM_BYTES = 224 * 1024  # the summing block's chunk slots in shared memory
MAX_FILL_BLOCKS = 4 * 132  # without sums: about four blocks per SM of an H100

_P = ctypes.c_void_p
_I = ctypes.c_int


@dataclasses.dataclass(frozen=True)
class UtilityPlan:
    """One launch over an (R, M) tile: blocks of M x ``block_rows``
    threads and chunks of ``chunk_rows`` rows.  With the sums, one cluster
    of ``cluster`` blocks: blocks 1.. fill the chunks in turn into
    ``slots`` slots each of block 0's shared memory (``smem_bytes``) and
    block 0 sums them in row order; without, ``blocks`` blocks of one
    chunk each."""

    block_rows: int
    cluster: int
    chunk_rows: int
    blocks: int
    slots: int
    smem_bytes: int

    def chunks(self, r: int) -> list[tuple[int, int, int]]:
        """(filling block, first row, end row) of each chunk, in row order;
        without the sums the filling block is the block's index."""
        n = -(-r // self.chunk_rows)
        fill = self.cluster - 1
        return [(1 + c % fill if self.cluster else c, c * self.chunk_rows,
                 min(r, (c + 1) * self.chunk_rows)) for c in range(n)]


def utility_plan(r: int, m: int, itemsize: int, with_means: bool) -> UtilityPlan:
    """The launch plan of an (R, M) tile of ``itemsize``-byte values.

    With the sums: as many filling blocks (up to 7) as give each at least
    one pass of its block's rows, one chunk each, in whole groups of 8 rows
    (the sum's groups).  A slot holds a chunk column by column, each
    column padded by 16 bytes.  Where the tile fits block 0's
    ``SUM_BYTES`` every chunk has a slot of its own; else each filling
    block has a ring of two slots, the chunks (and, for wide rows, the
    filling blocks) cut to fit.  Without: chunks of whole passes, at most
    ``MAX_FILL_BLOCKS`` blocks.
    """
    if r < 1 or not 1 <= m <= MAX_MODELS or itemsize not in (4, 8):
        raise ValueError(f"no utility plan for R={r} M={m} itemsize={itemsize}")
    rows = THREADS // m
    if not with_means:
        chunk = rows * -(-r // (rows * MAX_FILL_BLOCKS))
        return UtilityPlan(rows, 0, chunk, -(-r // chunk), 0, 0)
    fill = min(MAX_CLUSTER - 1, -(-r // rows))
    chunk = -(-r // (fill * 8)) * 8  # one chunk per filling block, in 8s
    pad = 16 // itemsize  # a slot's columns: apart in the banks

    def chunk_bytes(c):
        return m * (c + pad) * itemsize

    ring = fill * chunk_bytes(chunk) > SUM_BYTES
    if ring:  # two slots per filling block, as many rows as fit
        chunk = max(8, min(chunk, (SUM_BYTES // (2 * fill * m * itemsize) - pad) // 8 * 8))
        fill = min(fill, SUM_BYTES // (2 * chunk_bytes(chunk)))
    fill = min(fill, -(-r // chunk))  # no filling block without a chunk
    slots = 2 if ring else 1
    return UtilityPlan(rows, fill + 1, chunk, 1, slots, slots * fill * chunk_bytes(chunk))


def _entry(dtype: torch.dtype):
    lib = nvcc.library("utility")
    fn = lib.utility_scores_f64 if dtype == torch.float64 else lib.utility_scores_f32
    fn.argtypes = [_P, _P, _P, _I, _P, _P] + [_I] * 8 + [_P]
    fn.restype = _I
    return lib, fn


def _check_args(acc, deadlines, completions, penalty):
    if penalty not in PENALTY_CODES:
        raise ValueError(f"unknown penalty {penalty!r}")
    if acc.ndim != 2 or acc.shape[0] == 0 or acc.shape[1] == 0:
        raise ValueError(f"acc must be a non-empty (R, M) tensor, got {tuple(acc.shape)}")
    r, m = acc.shape
    if deadlines.shape != (r,):
        raise ValueError(f"deadlines must be ({r},), got {tuple(deadlines.shape)}")
    if completions.shape not in ((r, m), (m,)):
        raise ValueError(
            f"completions must be ({r}, {m}) or ({m},), got {tuple(completions.shape)}"
        )
    if acc.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"acc must be float32 or float64, got {acc.dtype}")
    for name, t in (("deadlines", deadlines), ("completions", completions)):
        if t.dtype != acc.dtype:
            raise TypeError(f"{name} is {t.dtype}, acc is {acc.dtype}")
        if t.device != acc.device:
            raise ValueError(f"{name} is on {t.device}, acc on {acc.device}")


def utility_scores(acc, deadlines, completions, penalty: str = "sigmoid",
                   with_means: bool = True):
    """(U (R, M), column means (M,) or None) for one (requests x models) tile.

    ``deadlines`` is (R,); ``completions`` is the full (R, M) tile or one
    (M,) row shared by every request.  The means are the column sums over
    the R rows, added in row order, divided by R: bit-identical in
    float64 to the reference's ``sequential_mean`` of the same tile.
    ``with_means=False`` skips the sums (per-entry scoring).
    """
    _check_args(acc, deadlines, completions, penalty)
    if acc.device.type == "cpu":
        if with_means:
            return utility_scores_ref(acc, deadlines, completions, penalty)
        return utility_tile_ref(acc, deadlines, completions, penalty), None
    if acc.device.type != "cuda":
        raise ValueError(f"utility_scores runs on CUDA or the CPU, not {acc.device}")
    for name, t in (("acc", acc), ("deadlines", deadlines), ("completions", completions)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    r, m = acc.shape
    if m > MAX_MODELS:
        raise ValueError(f"the utility kernel takes M <= {MAX_MODELS} columns, got {m}")
    u = torch.empty_like(acc)
    sums = torch.empty(m, dtype=acc.dtype, device=acc.device) if with_means else None
    plan = utility_plan(r, m, acc.element_size(), with_means)
    lib, fn = _entry(acc.dtype)
    refuse_grad("utility_scores", f"it has no backward ({GRADIENTS_RULE})", acc, deadlines,
                completions)
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        err = fn(acc.data_ptr(), deadlines.data_ptr(), completions.data_ptr(),
                 m if completions.ndim == 2 else 0, u.data_ptr(),
                 sums.data_ptr() if with_means else None, r, m,
                 PENALTY_CODES[penalty], plan.block_rows, plan.cluster, plan.chunk_rows,
                 plan.blocks, plan.slots, stream)
    counter.add()
    nvcc.check(lib, err, "utility_scores")
    return u, (sums / r if with_means else None)
