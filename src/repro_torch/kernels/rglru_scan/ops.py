"""Wrapper of the RG-LRU scan kernel: the gates, the gated linear
recurrence and the product with the GeLU branch of one Griffin recurrent
block, in one launch (two kernels, the chunk summaries and the chunked
scan, counted as one; the scan alone when S is at most a chunk).

Tensors on the CPU take the plain version (``ref.py``); CUDA tensors
launch ``csrc/rglru_scan.cu`` on the current stream, or raise.  There is
no other route.  The wrapper allocates the output and the kernels'
(2, B, ceil(S / chunk) - 1, L) float32 summary scratch with
``torch.empty``; the chunk length is the library's
(``rglru_scan_chunk``).  The grid depends on the shapes only and nothing
is read on the host, so a decode step (S = 1) that calls it can be
captured in a CUDA graph.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LaunchCounter, nvcc, refuse_grad
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

__all__ = ["rglru_scan", "chunk_len", "counter"]

counter = LaunchCounter("rglru_scan")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def _entry():
    lib = nvcc.library("rglru_scan")
    fn = lib.rglru_scan
    fn.argtypes = [_P] * 11 + [_I] * 4 + [_P]
    fn.restype = _I
    lib.rglru_scan_chunk.restype = _I
    return lib, fn, lib.rglru_scan_chunk()


def chunk_len() -> int:
    """The chunk length of the built kernel library (built on first use)."""
    return _entry()[2]


def rglru_scan(u, gpre, a_w, a_b, x_w, x_b, lam, h0=None):
    """One recurrent block's scan.  ``u`` (B, S, L) is the recurrence
    branch after its causal conv, ``gpre`` (B, S, L) the gate branch
    before its GeLU, both in the model's type; ``a_w``, ``a_b``, ``x_w``,
    ``x_b`` and ``lam`` (L,) the gate weights and biases and Lambda, in
    the model's type; ``h0`` (B, L) float32 the carried state or None
    (zeros).  Returns ``(h * gelu(gpre))`` (B, S, L) in the model's type
    and the last state ``h`` (B, L) in float32."""
    if u.dim() != 3 or gpre.shape != u.shape:
        raise ValueError(f"u and gpre must be one (B, S, L) shape, got {tuple(u.shape)} "
                         f"and {tuple(gpre.shape)}")
    b, s, width = u.shape
    if u.dtype not in _DTYPES:
        raise TypeError(f"rglru_scan takes float32 or bfloat16, got {u.dtype}")
    vecs = (a_w, a_b, x_w, x_b, lam)
    for x in (gpre,) + vecs:
        if x.dtype != u.dtype or x.device != u.device:
            raise ValueError(f"every input must be {u.dtype} on {u.device}, got "
                             f"{x.dtype} on {x.device}")
    if any(tuple(v.shape) != (width,) for v in vecs):
        raise ValueError(f"the gate vectors must be ({width},)")
    if h0 is not None and (tuple(h0.shape) != (b, width) or h0.dtype != torch.float32
                           or h0.device != u.device):
        raise ValueError(f"h0 must be ({b}, {width}) float32 on {u.device}")
    if u.device.type == "cpu":
        return rglru_scan_ref(u, gpre, a_w, a_b, x_w, x_b, lam, h0)
    if u.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on CUDA or the CPU, not {u.device}")
    u, gpre = u.contiguous(), gpre.contiguous()
    vecs = [v.contiguous() for v in vecs]
    h0 = h0.contiguous() if h0 is not None else None
    y = torch.empty_like(u)
    h_last = torch.empty((b, width), dtype=torch.float32, device=u.device)
    lib, fn, chunk = _entry()
    n_chunks = -(-s // chunk)
    scratch = None if n_chunks == 1 else torch.empty(
        (2, b, n_chunks - 1, width), dtype=torch.float32, device=u.device)
    refuse_grad("rglru_scan", "its backward is still to write (ROADMAP, queue 2, entry 8)",
                u, gpre, *vecs, h0)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = fn(u.data_ptr(), gpre.data_ptr(), *[v.data_ptr() for v in vecs],
                 h0.data_ptr() if h0 is not None else None, y.data_ptr(), h_last.data_ptr(),
                 scratch.data_ptr() if scratch is not None else None, b, s, width,
                 _DTYPES[u.dtype], stream)
    counter.add()
    nvcc.check(lib, err, "rglru_scan")
    return y, h_last
