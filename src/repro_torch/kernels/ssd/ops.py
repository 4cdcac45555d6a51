"""Wrapper of the Mamba-2 SSD chunk-scan kernel (K5), the port of
``repro.kernels.ssd.ops``.

``ssd(x, dt, a_log, bm, cm, chunk)`` is the model-facing call of the
reference: it forms ``dA = dt * -exp(a_log)`` and ``xdt = x * dt`` in
float32 and hands them to ``ssd_chunk_scan``, which has
``ssd_pallas``'s contract: xdt (B, S, H, P), dA (B, S, H), bm and cm
(B, S, N), ngroups = 1, ``S % chunk == 0``; y (B, S, H, P) and the
final state (B, H, P, N), float32.  Tensors on the CPU take the plain
version (``ref.ssd_chunk_ref``); CUDA tensors launch the five kernels of
``csrc/ssd.cu`` in order on the current stream (cumsum, scores, chunk
states, state passing, output: the Mamba-2 split), or the call raises.
There is no other route.  One call is one K5 launch on the counter,
whatever the number of CUDA kernels it starts.

``ssd_chunk_bwd`` is the backward (K5b): the gradients with respect to
xdt, dA, bm and cm from the output's gradient and what the forward saved
(``ssd_chunk_scan_saving``: the cumsum and the state entering each
chunk, which the backward reads rather than recomputes), through the nine
kernels of ``csrc/ssd_bwd.cu`` on the card (one launch on its own
counter) or ``ref.ssd_chunk_bwd_ref`` on the CPU.  ``ssd`` and
``ssd_from_a`` (the model's route) run the chunk scan through an autograd
function over both: the forward saves what the backward reads, and
builds no graph where nothing requires a gradient.  A direct CUDA call of
``ssd_chunk_scan`` whose input requires a gradient raises
(``kernels.refuse_grad``).
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import LaunchCounter, nvcc, refuse_grad
from repro_torch.kernels.ssd.ref import (
    ssd_chunk_bwd_ref,
    ssd_chunk_ref,
    ssd_chunk_ref_saving,
)

__all__ = ["ssd", "ssd_from_a", "ssd_chunk_scan", "ssd_chunk_scan_stages",
           "ssd_chunk_scan_saving", "ssd_chunk_bwd", "SsdStages", "counter", "bwd_counter",
           "MAX_CHUNK", "MAX_HEADDIM", "MAX_STATE"]

counter = LaunchCounter("ssd")
bwd_counter = LaunchCounter("ssd_bwd")

# The kernels' limits (csrc/ssd.cu: kMaxL, kMaxP, kMaxN).
MAX_CHUNK, MAX_HEADDIM, MAX_STATE = 128, 64, 128
# State rows p of one block of K5b's reverse pass (csrc/ssd_bwd.cu: kPassRows).
PASS_ROWS = 8

_P = ctypes.c_void_p
_I = ctypes.c_int


def _check_args(xdt, dA, bm, cm, chunk):
    if xdt.ndim != 4 or dA.ndim != 3 or bm.ndim != 3 or bm.shape != cm.shape:
        raise ValueError(f"xdt (B, S, H, P), dA (B, S, H), bm and cm (B, S, N): got "
                         f"{tuple(xdt.shape)}, {tuple(dA.shape)}, {tuple(bm.shape)}, "
                         f"{tuple(cm.shape)}")
    b, s, h, _ = xdt.shape
    if tuple(dA.shape) != (b, s, h) or tuple(bm.shape[:2]) != (b, s):
        raise ValueError(f"xdt {tuple(xdt.shape)}, dA {tuple(dA.shape)} and bm "
                         f"{tuple(bm.shape)} disagree (ngroups must be 1)")
    if chunk <= 0 or s % chunk:
        raise ValueError(f"sequence length {s} must be a multiple of the chunk {chunk}")
    for name, t in (("dA", dA), ("bm", bm), ("cm", cm)):
        if t.device != xdt.device:
            raise ValueError(f"{name} is on {t.device}, xdt on {xdt.device}")


SsdStages = collections.namedtuple(
    "SsdStages", ["cum", "scores", "entering", "final_state", "y"])
SsdStages.__doc__ = """What the five stages of K5 leave on the card, in the
layouts of ``ref``'s stages: cum (B, H, nc, l); scores (B, nc, l, l), valid
on and below the diagonal only; the state entering each chunk
(B, nc, H, P, N), a view of the kernels' (B, nc, H, N, P); the final state
(B, H, P, N); y (B, S, H, P)."""


def ssd_chunk_scan_stages(xdt, dA, bm, cm, chunk: int = 128) -> SsdStages:
    """Launch K5's five kernels on CUDA tensors and return every stage's
    output (the chunk states are overwritten in place by the entering
    states).  Counts one K5 launch."""
    _check_args(xdt, dA, bm, cm, chunk)
    if xdt.device.type != "cuda":
        raise ValueError(f"the SSD kernel stages run on CUDA, not {xdt.device}")
    b, s, h, p = xdt.shape
    n = bm.shape[-1]
    for name, t in (("xdt", xdt), ("dA", dA), ("bm", bm), ("cm", cm)):
        if t.dtype != torch.float32:
            raise TypeError(f"the SSD kernel takes float32, as ssd_pallas; {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if chunk > MAX_CHUNK or p > MAX_HEADDIM or n > MAX_STATE:
        raise ValueError(f"the SSD kernel takes chunk <= {MAX_CHUNK}, P <= {MAX_HEADDIM}, "
                         f"N <= {MAX_STATE}; got chunk={chunk}, P={p}, N={n}")
    nc = s // chunk

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=xdt.device)

    cum, wend = empty(b, h, nc, chunk), empty(b, h, nc, chunk)
    scores = empty(b, nc, chunk, chunk)
    states_t = empty(b, nc, h, n, p)  # (N, P): chunk states, then the entering states
    final_state = empty(b, h, p, n)
    y = torch.empty_like(xdt)
    lib = nvcc.library("ssd")
    launches = (
        ("ssd_chunk_scan_cumsum", [_P, _P, _P, _I, _I, _I, _I, _P],
         (dA, cum, wend, b, s, h, chunk)),
        ("ssd_chunk_scan_scores", [_P, _P, _P, _I, _I, _I, _I, _P],
         (bm, cm, scores, b, s, n, chunk)),
        ("ssd_chunk_scan_states", [_P, _P, _P, _P] + [_I] * 6 + [_P],
         (xdt, bm, wend, states_t, b, s, h, p, n, chunk)),
        ("ssd_chunk_scan_pass", [_P, _P, _P] + [_I] * 6 + [_P],
         (cum, states_t, final_state, b, s, h, p, n, chunk)),
        ("ssd_chunk_scan_output", [_P] * 6 + [_I] * 6 + [_P],
         (xdt, cm, scores, cum, states_t, y, b, s, h, p, n, chunk)),
    )
    with torch.cuda.device(xdt.device):
        stream = torch.cuda.current_stream(xdt.device).cuda_stream
        counter.add()
        for name, argtypes, args in launches:
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _I
            err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args), stream)
            nvcc.check(lib, err, name)
    return SsdStages(cum, scores, states_t.transpose(-1, -2), final_state, y)


def ssd_chunk_scan(xdt, dA, bm, cm, chunk: int = 128):
    """``ssd_pallas``: (y (B, S, H, P), final_state (B, H, P, N)), float32."""
    _check_args(xdt, dA, bm, cm, chunk)
    if xdt.device.type == "cpu":
        return ssd_chunk_ref(xdt, dA, bm, cm, chunk)
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd_chunk_scan runs on CUDA or the CPU, not {xdt.device}")
    refuse_grad("ssd_chunk_scan", "train through ssd_from_a (models.ssd.ssd_scan), whose "
                "autograd function's backward is K5b", xdt, dA, bm, cm)
    out = ssd_chunk_scan_stages(xdt, dA, bm, cm, chunk)
    return out.y, out.final_state


def ssd_chunk_scan_saving(xdt, dA, bm, cm, chunk: int = 128):
    """The forward of the autograd function: (y, final_state, cum (B, H, nc,
    l), entering (B, nc, H, P, N)), the last two what the backward reads.
    On the card one K5 launch (its stages' outputs), on the CPU the plain
    stages."""
    _check_args(xdt, dA, bm, cm, chunk)
    if xdt.device.type == "cpu":
        return ssd_chunk_ref_saving(xdt, dA, bm, cm, chunk)
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd_chunk_scan runs on CUDA or the CPU, not {xdt.device}")
    out = ssd_chunk_scan_stages(xdt, dA, bm, cm, chunk)
    return out.y, out.final_state, out.cum, out.entering


def ssd_chunk_bwd(xdt, bm, cm, dy, cum, entering, chunk: int = 128):
    """K5b: (dxdt (B, S, H, P), ddA (B, S, H), dbm, dcm (B, S, N)), float32,
    the gradients of ``ssd_chunk_scan``'s y given dy (B, S, H, P), from the
    forward's cum (B, H, nc, l) and entering states (B, nc, H, P, N) of
    ``ssd_chunk_scan_saving``.  One call is one K5b launch, whatever the
    number of CUDA kernels it starts."""
    b, s, h, p = xdt.shape
    _check_args(xdt, cum.new_empty((b, s, h)), bm, cm, chunk)
    n, nc = bm.shape[-1], s // chunk
    if tuple(dy.shape) != (b, s, h, p) or dy.device != xdt.device:
        raise ValueError(f"dy must be {(b, s, h, p)} on {xdt.device}, got {tuple(dy.shape)} "
                         f"on {dy.device}")
    if tuple(cum.shape) != (b, h, nc, chunk) or tuple(entering.shape) != (b, nc, h, p, n):
        raise ValueError(f"cum must be {(b, h, nc, chunk)} and entering {(b, nc, h, p, n)}, "
                         f"got {tuple(cum.shape)} and {tuple(entering.shape)}")
    if xdt.device.type == "cpu":
        return ssd_chunk_bwd_ref(xdt, bm, cm, dy, cum, entering, chunk)
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd_chunk_bwd runs on CUDA or the CPU, not {xdt.device}")
    if chunk > MAX_CHUNK or p > MAX_HEADDIM or n > MAX_STATE:
        raise ValueError(f"the SSD backward takes chunk <= {MAX_CHUNK}, P <= {MAX_HEADDIM}, "
                         f"N <= {MAX_STATE}; got chunk={chunk}, P={p}, N={n}")
    entering_t = entering.transpose(-1, -2)  # (B, nc, H, N, P), the forward's own storage
    args = [t.float().contiguous() for t in (xdt, bm, cm, dy, cum, entering_t)]

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=xdt.device)

    dxdt, dda = empty(b, s, h, p), empty(b, s, h)
    dbm, dcm = empty(b, s, n), empty(b, s, n)
    # Scratch: scores, the entering states' gradients (then the chunk
    # states'), the pass's dcum by block of state rows, r, qd and s per
    # position, the heads' d(scores), their sum, and the heads' own dC and dB.
    scratch = [empty(b, nc, chunk, chunk), empty(b, nc, h, n, p),
               empty(b, h, nc, -(-p // PASS_ROWS)),
               empty(b, h, nc, chunk), empty(b, h, nc, chunk), empty(b, h, nc, chunk),
               empty(b, nc, h, chunk, chunk), empty(b, nc, chunk, chunk),
               empty(b, s, h, n), empty(b, s, h, n)]
    lib = nvcc.library("ssd_bwd")
    fn = lib.ssd_chunk_bwd
    fn.argtypes = [_P] * 20 + [_I] * 6 + [_P]
    fn.restype = _I
    with torch.cuda.device(xdt.device):
        stream = torch.cuda.current_stream(xdt.device).cuda_stream
        bwd_counter.add()
        err = fn(*(t.data_ptr() for t in args + [dxdt, dda, dbm, dcm] + scratch),
                 b, s, h, p, n, chunk, stream)
    nvcc.check(lib, err, "ssd_chunk_bwd")
    return dxdt, dda, dbm, dcm


def ssd(x, dt, a_log, bm, cm, chunk: int = 128):
    """Model-facing API: x (B, S, H, P); dt (B, S, H) after softplus;
    a_log (H,); bm and cm (B, S, N) (ngroups = 1).  Returns (y,
    final_state), float32."""
    if a_log.ndim != 1 or x.ndim != 4 or a_log.shape[0] != x.shape[2]:
        raise ValueError(f"a_log must be (H,) for x {tuple(x.shape)}, got {tuple(a_log.shape)}")
    return ssd_from_a(x, dt, -torch.exp(a_log.float()), bm, cm, chunk)


class _SsdChunkScan(torch.autograd.Function):
    """K5 forward (saving cum and the entering states), K5b backward; the
    plain stages on the CPU.  The final state is not differentiated."""

    @staticmethod
    def forward(ctx, xdt, dA, bm, cm, chunk):
        y, final_state, cum, entering = ssd_chunk_scan_saving(xdt, dA, bm, cm, chunk)
        ctx.save_for_backward(xdt, bm, cm, cum, entering)
        ctx.chunk = chunk
        ctx.mark_non_differentiable(final_state)
        return y, final_state

    @staticmethod
    def backward(ctx, dy, _dfinal):
        xdt, bm, cm, cum, entering = ctx.saved_tensors
        dxdt, dda, dbm, dcm = ssd_chunk_bwd(xdt, bm, cm, dy.contiguous(), cum, entering,
                                            ctx.chunk)
        return dxdt, dda, dbm, dcm, None


def ssd_from_a(x, dt, a, bm, cm, chunk: int = 128):
    """``ssd`` given the per-head decay rate ``a = -exp(a_log)`` (H,), as
    the model's ``ssd_scan`` holds it: forms ``dA = dt * a`` and
    ``xdt = x * dt`` in float32 (plain torch, differentiable) and runs the
    chunk scan through its autograd function."""
    dt = dt.float()
    dA = dt * a.float()
    xdt = x.float() * dt[..., None]
    return _SsdChunkScan.apply(xdt, dA, bm.float().contiguous(), cm.float().contiguous(), chunk)
