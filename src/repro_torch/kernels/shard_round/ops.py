"""Wrappers of the shard-round kernel: the per-shard work of a sharded
window's rounds (``core.shard``), three entry points of one CUDA source.

Tensors on the CPU take the plain versions (``ref.py``); CUDA tensors
launch ``csrc/shard_round.cu`` on the current stream, or raise.  There is
no other route.  Each launch of any entry adds one to the counter.  The
wrappers allocate the outputs and the scoring tile with ``torch.empty``
(or write into the caller's) and synchronise nothing.  The chain keeps
the carry in one block's shared memory, so a carry beyond it is refused
on both routes (ROADMAP §3, P7).  ``score_block`` runs a row a warp when
its cells fit one (``score_instance``), else a row a cluster of
``score_blocks`` blocks.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import GRADIENTS_RULE, LaunchCounter, nvcc, refuse_grad
from repro_torch.kernels.selection_scan.ops import MAX_SMEM_BYTES
from repro_torch.kernels.shard_round.ref import RANK_INF, accept_ref, chain_ref, score_block_ref

__all__ = ["score_block", "chain", "accept", "counter", "chain_smem_bytes", "score_instance",
           "score_blocks", "tile_in_smem", "RANK_INF"]

counter = LaunchCounter("shard_round")

_P = ctypes.c_void_p
_I = ctypes.c_int
WARP = 32  # lanes of a warp: a row's cells in the warp instance
ROW_CELLS_A_BLOCK = 1024  # a wide row's tile cells a cluster block takes, at most
MAX_CLUSTER = 8  # the portable cluster size
# The most bytes of a wide row's rows and tile in the leader block's shared
# memory (csrc: kWideSmemTile); a wider row keeps its tile in device memory.
WIDE_SMEM_TILE = 160 * 1024


def chain_smem_bytes(n_w: int, n_slots: int) -> int:
    """Shared bytes of one chain launch (csrc: chain_smem_bytes): the
    carry's (W, K) slots and (W,) tails, 8 bytes each."""
    return 8 * (n_w * n_slots + n_w)


def score_instance(n_w: int, members: int, m: int) -> str:
    """The ``score_block`` instance of a block of ``n_w`` workers,
    ``members`` (the tables' padded member count B) and ``m`` models:
    ``"warp"`` when a row's W * B * M cells fit one warp, a lane each, else
    ``"wide"``."""
    return "warp" if n_w * members * m <= WARP else "wide"


def tile_in_smem(n_w: int, members: int, m: int) -> bool:
    """Whether a wide row's (W, B, M) tile fits the leader block's shared
    memory beside its (W, M) rows (csrc: wide_tile_in_smem)."""
    rows = -(-17 * n_w * m // 8) * 8
    return rows + 8 * n_w * members * m <= WIDE_SMEM_TILE


def score_blocks(n_w: int, members: int, m: int, fixed: bool = False) -> int:
    """Blocks of the cluster a wide row spreads its Eq. 2 tile over, each
    a slice written into the leader's shared memory: one per
    ROW_CELLS_A_BLOCK cells, at most MAX_CLUSTER; one with fixed choices
    (nothing scored) or a tile too wide for shared memory."""
    if fixed or not tile_in_smem(n_w, members, m):
        return 1
    return max(1, min(MAX_CLUSTER, -(-n_w * members * m // ROW_CELLS_A_BLOCK)))


@functools.lru_cache(maxsize=None)
def _entries():
    lib = nvcc.library("shard_round")
    score = lib.shard_round_score_f64
    score.argtypes = [_P, _I, _P, _I] + [_P] * 17 + [_I] * 14 + [_P]
    score.restype = _I
    chain_fn = lib.shard_round_chain_f64
    chain_fn.argtypes = [_P, _P, _P, ctypes.c_double] + [_P] * 6 + [_I] * 5 + [_P, _I, _I, _P]
    chain_fn.restype = _I
    accept_fn = lib.shard_round_accept_f64
    accept_fn.argtypes = ([_P, _I, _I, _P, _P, _I, _P, _P, _I, _P, _P, _P, ctypes.c_double]
                          + [_P] * 4 + [_I] * 5 + [_P])
    accept_fn.restype = _I
    return lib, score, chain_fn, accept_fn


def _check_pos(what, pos, device):
    if not (isinstance(pos, torch.Tensor) and pos.shape == (1,) and pos.dtype == torch.int64
            and pos.device == device):
        raise ValueError(f"{what}: pos must be a (1,) int64 tensor on {device}")


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
                valid, pen, rank, wvalid=None, fixed=None, *, pos=None, lo: int = 0,
                hi: int | None = None, row0: int = 0, total: int | None = None, out=None):
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
    the selection scan's step for the same carry.

    With ``pos`` (a (1,) int64 tensor on the device: the window's next
    undecided position p), the block holds rows [row0, row0 + R) of a
    window of ``total`` rows, and the rows of [p + lo, p + hi) it holds are
    scored, each against carry row (its row - p - lo) of ``t`` and
    ``res`` ((hi - lo, W) and (hi - lo, W, K)), into that column of the
    (5, hi - lo) and (3, hi - lo) outputs — ``out``, or new ones — leaving
    the other columns as they are; nothing once p has reached ``total``.
    The host need not know p: a round runs without a read-back."""
    n_rows, b, m = acc.shape
    n_w, n_slots = res.shape[1], res.shape[2]
    a = gid.shape[0]
    dev = acc.device
    f64, i64 = torch.float64, torch.int64
    if pos is None:
        lo, hi, row0, total = 0, n_rows, 0, n_rows
    elif hi is None or total is None:
        raise ValueError("score_block: a position needs hi and total")
    span = hi - lo
    if span < 1:
        raise ValueError(f"score_block: hi - lo must be positive, got {span}")
    _check("score_block", {
        "t": (t, (span, n_w), f64), "res": (res, (span, n_w, n_slots), i64),
        "acc": (acc, (n_rows, b, m), f64), "mask": (mask, (n_rows, b), f64),
        "deadlines": (deadlines, (n_rows, b), f64), "bsize": (bsize, (n_rows,), f64),
        "lat": (lat, (n_rows, n_w, m), f64), "step_app": (step_app, (n_rows,), i64),
        "swap": (swap, (a, n_w, m), f64), "gid": (gid, (a, m), i64),
        "valid": (valid, (a, m), torch.bool), "pen": (pen, (a,), i64),
        "rank": (rank, (a, n_w * m), i64), "wvalid": (wvalid, (n_w,), torch.bool),
        "fixed": (fixed, (n_rows,), i64),
    }, dev)
    if out is not None:
        _check("score_block", {"out[0]": (out[0], (5, span), f64),
                               "out[1]": (out[1], (3, span), i64)}, dev)
        if not (out[0].is_contiguous() and out[1].is_contiguous()):
            raise ValueError("score_block: the outputs must be contiguous")
    if pos is not None:
        _check_pos("score_block", pos, dev)
    if slot1 and n_slots != 1:
        raise ValueError(f"slot1 residency carries one id per worker, got {n_slots}")
    if dev.type == "cpu":
        if pos is None:
            got = score_block_ref(t, res, slot1, acc, mask, deadlines, bsize, lat, step_app,
                                  swap, gid, valid, pen, rank, wvalid, fixed)
            if out is None:
                return got
            out[0].copy_(got[0])
            out[1].copy_(got[1])
            return out
        return score_block_ref(t, res, slot1, acc, mask, deadlines, bsize, lat, step_app, swap,
                               gid, valid, pen, rank, wvalid, fixed, pos=pos, lo=lo, hi=hi,
                               row0=row0, total=total, out=out)
    if dev.type != "cuda":
        raise ValueError(f"shard_round runs on CUDA or the CPU, not {dev}")
    if out is None:  # with a position, the columns not scored stay zero
        alloc = torch.empty if pos is None else torch.zeros
        out = (alloc((5, span), dtype=f64, device=dev), alloc((3, span), dtype=i64, device=dev))
    outf, outi = out
    slots = min(span, n_rows)
    if n_rows == 0:
        return outf, outi
    ts, rs = _row_stride(t, n_w), _row_stride(res, n_w * n_slots)
    tabs = [x.contiguous() for x in (acc, mask, deadlines, bsize, lat, step_app, swap, gid,
                                     valid, pen)]
    rank = rank.contiguous()
    wvalid = wvalid.contiguous() if wvalid is not None else None
    fixed = fixed.contiguous() if fixed is not None else None
    warp = score_instance(n_w, b, m) == "warp"
    blocks = 1 if warp else score_blocks(n_w, b, m, fixed is not None)
    tile = (torch.empty((slots, n_w, b, m), dtype=f64, device=dev)
            if fixed is None and not warp and not tile_in_smem(n_w, b, m) else None)
    refuse_grad("shard_round", f"it has no backward ({GRADIENTS_RULE})", t, res, *tabs)
    lib, fn, _, _ = _entries()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(t.data_ptr(), ts, res.data_ptr(), rs, *[x.data_ptr() for x in tabs],
                 rank.data_ptr(),
                 wvalid.data_ptr() if wvalid is not None else None,
                 fixed.data_ptr() if fixed is not None else None,
                 tile.data_ptr() if tile is not None else None,
                 outf.data_ptr(), outi.data_ptr(),
                 pos.data_ptr() if pos is not None else None, lo, hi, row0, total, span,
                 slots, n_rows, b, m, n_w, n_slots, int(slot1), int(warp), blocks, stream)
    counter.add()
    nvcc.check(lib, err, "shard_round score_block")
    return outf, outi


def chain(t0, res0, sizes, cap: float, slot1: bool, wi, g, sw, lt, *, models: int = 0,
          pos=None, total: int | None = None):
    """Apply n decisions to a carry, one after the other, keeping every
    state: ``t0`` (W,) tails and ``res0`` (W, K) slots before the first;
    ``sizes`` (W, G) bytes per id and ``cap`` the byte budget (the LRU
    rule); per decision the worker ``wi`` and model id ``g`` (int64), the
    raw swap ``sw`` and the latency ``lt`` (float64), each (n,).  Returns
    ((n + 1, W) float64 tails, (n + 1, W, K) int64 slots), row k the state
    before decision k.  The completion is (t + (resident ? 0 : swap)) +
    lat, the residency the slot1 id or the LRU touch.

    With ``models`` > 0, ``wi`` holds (worker, model) cells and the worker
    is ``wi // models``.  With ``pos`` (a (1,) int64 tensor: the round's
    first position p in a window of ``total``), only the decisions before
    the window's last position are applied (min(n, total - p - 1); the
    later rows are left as they are), and nothing once p has reached
    ``total``."""
    n = wi.shape[0]
    n_w, n_slots = res0.shape
    dev = t0.device
    _check("chain", {
        "t0": (t0, (n_w,), torch.float64), "res0": (res0, (n_w, n_slots), torch.int64),
        "sizes": (sizes, (n_w, sizes.shape[1]), torch.float64),
        "wi": (wi, (n,), torch.int64), "g": (g, (n,), torch.int64),
        "sw": (sw, (n,), torch.float64), "lt": (lt, (n,), torch.float64),
    }, dev)
    if pos is not None:
        _check_pos("chain", pos, dev)
        if total is None:
            raise ValueError("chain: a position needs total")
    if models < 0:
        raise ValueError(f"chain: models must be >= 0, got {models}")
    if slot1 and n_slots != 1:
        raise ValueError(f"slot1 residency carries one id per worker, got {n_slots}")
    need = chain_smem_bytes(n_w, n_slots)
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f"the chain's carry needs {need} bytes of shared memory for W={n_w} workers and "
            f"K={n_slots} model ids, over the {MAX_SMEM_BYTES} one block has (ROADMAP §3, P7)")
    if dev.type == "cpu":
        return chain_ref(t0, res0, sizes, cap, slot1, wi, g, sw, lt, models=models, pos=pos,
                         total=total)
    if dev.type != "cuda":
        raise ValueError(f"shard_round runs on CUDA or the CPU, not {dev}")
    t_st = torch.empty((n + 1, n_w), dtype=torch.float64, device=dev)
    r_st = torch.empty((n + 1, n_w, n_slots), dtype=torch.int64, device=dev)
    ins = [x.contiguous() for x in (t0, res0, sizes, wi, g, sw, lt)]
    refuse_grad("shard_round", f"it has no backward ({GRADIENTS_RULE})", *ins)
    lib, _, fn, _ = _entries()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*[x.data_ptr() for x in ins[:3]], float(cap),
                 *[x.data_ptr() for x in ins[3:]], t_st.data_ptr(), r_st.data_ptr(),
                 n, n_w, n_slots, sizes.shape[1], int(slot1),
                 pos.data_ptr() if pos is not None else None,
                 int(total) if total is not None else 0, int(models), stream)
    counter.add()
    nvcc.check(lib, err, "shard_round chain")
    return t_st, r_st


def accept(pos, total: int, span: int, spec, val, t_st, r_st, sizes, cap: float, slot1: bool,
           t, res, out, stats, models: int) -> None:
    """End a round in place, at the position ``pos`` holds (a (1,) int64
    tensor), without reading anything back.

    ``spec`` is the (5, span) float64 and (3, span) int64 outputs of the
    round's speculation (``score_block``'s form: the cell ``w * models +
    m`` in row 0 of the ints, the model id in row 2; raw swap, effective
    swap and latency in rows 1-3 of the floats), ``val`` those of its
    validation of positions 1..span-1 (None when ``span`` is 1); ``t_st``
    (span, W) and ``r_st`` (span, W, K) the round's pre-states (``t[None]``
    and ``res[None]`` when ``span`` is 1); ``sizes`` (W, G) and ``cap`` the
    LRU rule.  The first conflict (a validated cell that differs from the
    speculated one) ends the accepted run, inclusive; the accepted rows go
    to columns [p, p + a) of ``out`` (4, total): worker, model column,
    start, latency; the carry ``t`` (W,), ``res`` (W, K) becomes the last
    accepted position's pre-state with its decision applied; ``pos``
    advances by a and ``stats`` (2,) int64 adds the round and its
    conflict.  Nothing once p has reached ``total``."""
    n_w, n_slots = res.shape
    dev = t.device
    f64, i64 = torch.float64, torch.int64
    shapes = {
        "spec[0]": (spec[0], (5, span), f64), "spec[1]": (spec[1], (3, span), i64),
        "t_st": (t_st, (span, n_w), f64), "r_st": (r_st, (span, n_w, n_slots), i64),
        "sizes": (sizes, (n_w, sizes.shape[1]), f64), "t": (t, (n_w,), f64),
        "res": (res, (n_w, n_slots), i64), "out": (out, (4, total), f64),
        "stats": (stats, (2,), i64),
    }
    if span > 1:
        if val is None:
            raise ValueError("accept: a round of more than one position needs its validation")
        shapes["val[0]"] = (val[0], (5, span - 1), f64)
        shapes["val[1]"] = (val[1], (3, span - 1), i64)
    _check("accept", shapes, dev)
    _check_pos("accept", pos, dev)
    for name, (x, _, _) in shapes.items():
        if not x.is_contiguous():
            raise ValueError(f"accept: {name} must be contiguous")
    if slot1 and n_slots != 1:
        raise ValueError(f"slot1 residency carries one id per worker, got {n_slots}")
    if dev.type == "cpu":
        accept_ref(pos, total, span, spec, val, t_st, r_st, sizes, cap, slot1, t, res, out,
                   stats, models)
        return
    if dev.type != "cuda":
        raise ValueError(f"shard_round runs on CUDA or the CPU, not {dev}")
    lib, _, _, fn = _entries()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(pos.data_ptr(), total, span, spec[0].data_ptr(), spec[1].data_ptr(), span,
                 val[0].data_ptr() if span > 1 else None,
                 val[1].data_ptr() if span > 1 else None, max(span - 1, 1),
                 t_st.data_ptr(), r_st.data_ptr(), sizes.data_ptr(), float(cap),
                 t.data_ptr(), res.data_ptr(), out.data_ptr(), stats.data_ptr(),
                 models, n_w, n_slots, sizes.shape[1], int(slot1), stream)
    counter.add()
    nvcc.check(lib, err, "shard_round accept")
