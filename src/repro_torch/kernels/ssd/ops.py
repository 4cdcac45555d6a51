"""Wrapper of the Mamba-2 SSD chunk-scan kernel (K5), the port of
``repro.kernels.ssd.ops``.

``ssd(x, dt, a_log, bm, cm, chunk)`` is the model-facing call of the
reference: it forms ``dA = dt * -exp(a_log)`` and ``xdt = x * dt`` in
float32 and hands them to ``ssd_chunk_scan``, which has
``ssd_pallas``'s contract: xdt (B, S, H, P), dA (B, S, H), bm and cm
(B, S, N), ngroups = 1, ``S % chunk == 0``; y (B, S, H, P) and the
final state (B, H, P, N), float32.  Tensors on the CPU take the plain
version (``ref.ssd_chunk_ref``); CUDA tensors launch ``csrc/ssd.cu`` on
the current stream, or the call raises.  There is no other route.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LaunchCounter, nvcc
from repro_torch.kernels.ssd.ref import ssd_chunk_ref

__all__ = ["ssd", "ssd_from_a", "ssd_chunk_scan", "counter", "MAX_CHUNK", "MAX_HEADDIM", "MAX_STATE"]

counter = LaunchCounter("ssd")

# The kernel's limits (csrc/ssd.cu: kMaxL, kMaxP, kMaxN).
MAX_CHUNK, MAX_HEADDIM, MAX_STATE = 128, 64, 128

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


def ssd_chunk_scan(xdt, dA, bm, cm, chunk: int = 128):
    """``ssd_pallas``: (y (B, S, H, P), final_state (B, H, P, N)), float32."""
    _check_args(xdt, dA, bm, cm, chunk)
    if xdt.device.type == "cpu":
        return ssd_chunk_ref(xdt, dA, bm, cm, chunk)
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd_chunk_scan runs on CUDA or the CPU, not {xdt.device}")
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
    y = torch.empty_like(xdt)
    final_state = torch.empty((b, h, p, n), dtype=torch.float32, device=xdt.device)
    lib = nvcc.library("ssd")
    fn = lib.ssd_chunk_scan_fwd
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    with torch.cuda.device(xdt.device):
        stream = torch.cuda.current_stream(xdt.device).cuda_stream
        err = fn(xdt.data_ptr(), dA.data_ptr(), bm.data_ptr(), cm.data_ptr(), y.data_ptr(),
                 final_state.data_ptr(), b, s, h, p, n, chunk, stream)
    counter.add()
    nvcc.check(lib, err, "ssd_chunk_scan")
    return y, final_state


def ssd(x, dt, a_log, bm, cm, chunk: int = 128):
    """Model-facing API: x (B, S, H, P); dt (B, S, H) after softplus;
    a_log (H,); bm and cm (B, S, N) (ngroups = 1).  Returns (y,
    final_state), float32."""
    if a_log.ndim != 1 or x.ndim != 4 or a_log.shape[0] != x.shape[2]:
        raise ValueError(f"a_log must be (H,) for x {tuple(x.shape)}, got {tuple(a_log.shape)}")
    return ssd_from_a(x, dt, -torch.exp(a_log.float()), bm, cm, chunk)


def ssd_from_a(x, dt, a, bm, cm, chunk: int = 128):
    """``ssd`` given the per-head decay rate ``a = -exp(a_log)`` (H,), as
    the model's ``ssd_scan`` holds it: forms ``dA = dt * a`` and
    ``xdt = x * dt`` in float32 and runs the chunk scan."""
    dt = dt.float()
    dA = dt * a.float()
    xdt = x.float() * dt[..., None]
    return ssd_chunk_scan(xdt, dA, bm.float().contiguous(), cm.float().contiguous(), chunk)
