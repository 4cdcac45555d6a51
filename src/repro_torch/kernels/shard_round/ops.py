"""Wrappers of the shard-round kernel: the per-shard work of a sharded
window's rounds (``core.shard``), two entry points of one CUDA source.

Tensors on the CPU take the plain versions (``ref.py``); CUDA tensors
launch ``csrc/shard_round.cu`` on the current stream, or raise.  There is
no other route.  Each launch of either entry adds one to the counter.  The
wrappers allocate the outputs and the scoring tile with ``torch.empty``
and synchronise nothing.  The chain keeps the carry in one block's shared
memory, so a carry beyond it is refused on both routes (ROADMAP §3, P7).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import GRADIENTS_RULE, LaunchCounter, nvcc, refuse_grad
from repro_torch.kernels.selection_scan.ops import MAX_SMEM_BYTES
from repro_torch.kernels.shard_round.ref import RANK_INF, chain_ref, score_block_ref

__all__ = ["score_block", "chain", "counter", "chain_smem_bytes", "RANK_INF"]

counter = LaunchCounter("shard_round")

_P = ctypes.c_void_p
_I = ctypes.c_int


def chain_smem_bytes(n_w: int, n_slots: int) -> int:
    """Shared bytes of one chain launch (csrc: chain_smem_bytes): the
    carry's (W, K) slots and (W,) tails, 8 bytes each."""
    return 8 * (n_w * n_slots + n_w)


@functools.lru_cache(maxsize=None)
def _entries():
    lib = nvcc.library("shard_round")
    score = lib.shard_round_score_f64
    score.argtypes = [_P, _I, _P, _I] + [_P] * 16 + [_I] * 6 + [_P]
    score.restype = _I
    chain_fn = lib.shard_round_chain_f64
    chain_fn.argtypes = [_P, _P, _P, ctypes.c_double] + [_P] * 6 + [_I] * 5 + [_P]
    chain_fn.restype = _I
    return lib, score, chain_fn


def _check(what, tensors, device):
    for name, (x, shape, dtype) in tensors.items():
        if x is None:
            continue
        if tuple(x.shape) != tuple(shape) or x.dtype != dtype:
            raise ValueError(f"{what}: {name} must be {tuple(shape)} {dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.device != device:
            raise ValueError(f"{what}: {name} is on {x.device}, expected {device}")


def _row_stride(x, inner: int) -> int:
    """The row stride of a (R, ...) carry whose rows are contiguous blocks
    of ``inner`` elements (0 when every row is the same one)."""
    if x.shape[0] > 1 and x.stride(0) == 0:
        return 0
    if x[0].numel() and not x[0].is_contiguous():
        raise ValueError("a carry row must be contiguous")
    return x.stride(0) if x.shape[0] > 1 else inner


def score_block(t, res, slot1: bool, acc, mask, deadlines, bsize, lat, step_app, swap, gid,
                valid, pen, rank, wvalid=None, fixed=None):
    """Score one shard's block of R rows, each against its carry, and take
    each row's pick over the block's (worker, model) cells.

    ``t`` (R, W) queue tails and ``res`` (R, W, K) resident ids per row
    (views whose rows are one expanded carry, or a row per carry); the
    row tables ``acc`` (R, B, M), ``mask`` and ``deadlines`` (R, B),
    ``bsize`` (R,), ``lat`` (R, W, M) and ``step_app`` (R,) index the
    application tables ``swap`` (A, W, M), ``gid`` (A, M), ``valid`` (A,
    M) bool, ``pen`` (A,) penalty codes and ``rank`` (A, W * M) tie-break
    ranks; ``wvalid`` (W,) marks real workers; ``fixed`` (R,) gives
    carry-free choices (MaxAcc).  Returns ((5, R) float64: utility, the
    pick's raw swap, effective swap, latency, completion; (3, R) int64:
    the pick ``w * M + m``, its rank, its model id), float64 bits equal to
    the selection scan's step for the same carry."""
    n_rows, b, m = acc.shape
    n_w, n_slots = res.shape[1], res.shape[2]
    a = gid.shape[0]
    dev = acc.device
    f64, i64 = torch.float64, torch.int64
    _check("score_block", {
        "t": (t, (n_rows, n_w), f64), "res": (res, (n_rows, n_w, n_slots), i64),
        "acc": (acc, (n_rows, b, m), f64), "mask": (mask, (n_rows, b), f64),
        "deadlines": (deadlines, (n_rows, b), f64), "bsize": (bsize, (n_rows,), f64),
        "lat": (lat, (n_rows, n_w, m), f64), "step_app": (step_app, (n_rows,), i64),
        "swap": (swap, (a, n_w, m), f64), "gid": (gid, (a, m), i64),
        "valid": (valid, (a, m), torch.bool), "pen": (pen, (a,), i64),
        "rank": (rank, (a, n_w * m), i64), "wvalid": (wvalid, (n_w,), torch.bool),
        "fixed": (fixed, (n_rows,), i64),
    }, dev)
    if slot1 and n_slots != 1:
        raise ValueError(f"slot1 residency carries one id per worker, got {n_slots}")
    if dev.type == "cpu":
        return score_block_ref(t, res, slot1, acc, mask, deadlines, bsize, lat, step_app, swap,
                               gid, valid, pen, rank, wvalid, fixed)
    if dev.type != "cuda":
        raise ValueError(f"shard_round runs on CUDA or the CPU, not {dev}")
    outf = torch.empty((5, n_rows), dtype=f64, device=dev)
    outi = torch.empty((3, n_rows), dtype=i64, device=dev)
    if n_rows == 0:
        return outf, outi
    ts, rs = _row_stride(t, n_w), _row_stride(res, n_w * n_slots)
    tabs = [x.contiguous() for x in (acc, mask, deadlines, bsize, lat, step_app, swap, gid,
                                     valid, pen)]
    rank = rank.contiguous()
    wvalid = wvalid.contiguous() if wvalid is not None else None
    fixed = fixed.contiguous() if fixed is not None else None
    tile = (torch.empty((n_rows, n_w, b, m), dtype=f64, device=dev) if fixed is None
            else None)
    refuse_grad("shard_round", f"it has no backward ({GRADIENTS_RULE})", t, res, *tabs)
    lib, fn, _ = _entries()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(t.data_ptr(), ts, res.data_ptr(), rs, *[x.data_ptr() for x in tabs],
                 rank.data_ptr(),
                 wvalid.data_ptr() if wvalid is not None else None,
                 fixed.data_ptr() if fixed is not None else None,
                 tile.data_ptr() if tile is not None else None,
                 outf.data_ptr(), outi.data_ptr(), n_rows, b, m, n_w, n_slots, int(slot1),
                 stream)
    counter.add()
    nvcc.check(lib, err, "shard_round score_block")
    return outf, outi


def chain(t0, res0, sizes, cap: float, slot1: bool, wi, g, sw, lt):
    """Apply n decisions to a carry, one after the other, keeping every
    state: ``t0`` (W,) tails and ``res0`` (W, K) slots before the first;
    ``sizes`` (W, G) bytes per id and ``cap`` the byte budget (the LRU
    rule); per decision the worker ``wi`` and model id ``g`` (int64), the
    raw swap ``sw`` and the latency ``lt`` (float64), each (n,).  Returns
    ((n + 1, W) float64 tails, (n + 1, W, K) int64 slots), row k the state
    before decision k.  The completion is (t + (resident ? 0 : swap)) +
    lat, the residency the slot1 id or the LRU touch."""
    n = wi.shape[0]
    n_w, n_slots = res0.shape
    dev = t0.device
    _check("chain", {
        "t0": (t0, (n_w,), torch.float64), "res0": (res0, (n_w, n_slots), torch.int64),
        "sizes": (sizes, (n_w, sizes.shape[1]), torch.float64),
        "wi": (wi, (n,), torch.int64), "g": (g, (n,), torch.int64),
        "sw": (sw, (n,), torch.float64), "lt": (lt, (n,), torch.float64),
    }, dev)
    if slot1 and n_slots != 1:
        raise ValueError(f"slot1 residency carries one id per worker, got {n_slots}")
    need = chain_smem_bytes(n_w, n_slots)
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f"the chain's carry needs {need} bytes of shared memory for W={n_w} workers and "
            f"K={n_slots} model ids, over the {MAX_SMEM_BYTES} one block has (ROADMAP §3, P7)")
    if dev.type == "cpu":
        return chain_ref(t0, res0, sizes, cap, slot1, wi, g, sw, lt)
    if dev.type != "cuda":
        raise ValueError(f"shard_round runs on CUDA or the CPU, not {dev}")
    t_st = torch.empty((n + 1, n_w), dtype=torch.float64, device=dev)
    r_st = torch.empty((n + 1, n_w, n_slots), dtype=torch.int64, device=dev)
    ins = [x.contiguous() for x in (t0, res0, sizes, wi, g, sw, lt)]
    refuse_grad("shard_round", f"it has no backward ({GRADIENTS_RULE})", *ins)
    lib, _, fn = _entries()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*[x.data_ptr() for x in ins[:3]], float(cap),
                 *[x.data_ptr() for x in ins[3:]], t_st.data_ptr(), r_st.data_ptr(),
                 n, n_w, n_slots, sizes.shape[1], int(slot1), stream)
    counter.add()
    nvcc.check(lib, err, "shard_round chain")
    return t_st, r_st
