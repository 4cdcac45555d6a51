"""Wrapper of the prefill flash-attention kernel (K3), the port of
``repro.kernels.flash_attention.ops``.

Model layout in and out: q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D).
Tensors on the CPU take the plain version (``ref.py``, in the kernel's
GQA layout); CUDA tensors launch ``csrc/flash_attention.cu`` on the
current stream, which reads the model layout directly, or raise.  There
is no other route.  The kernel's instance follows the dtype: bfloat16
runs on the tensor cores (``mma.sync``), float32 on the CUDA cores in
IEEE fp32; any other dtype raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LaunchCounter, nvcc
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = ["flash_attention", "counter", "HEAD_DIMS", "DTYPES"]

counter = LaunchCounter("flash_attention")

HEAD_DIMS = (16, 32, 64, 128, 256)  # the kernel's instances (K4 shares them)
# dtype -> the C entry point's instance: 0 the fp32 CUDA-core kernel, 1 the
# bf16 tensor-core kernel.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _check_args(q, k, v, causal, window):
    if not causal:
        raise NotImplementedError(
            "flash attention is causal-only here, as its oracle "
            "src/repro/kernels/flash_attention/ref.py:21 is; flash_attention_pallas also "
            "takes causal=False (ROADMAP, queue 2, entry 6)")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D): got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, hq, d = q.shape
    _, skv, hkv, dk = k.shape
    if k.shape[0] != b or dk != d or hkv == 0 or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree")
    if sq > skv:
        raise ValueError(f"queries sit at the last Sq of Skv positions: Sq={sq} > Skv={skv}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, scale=None):
    """Causal (optionally sliding-window) GQA attention, (B, Sq, Hq, D)."""
    _check_args(q, k, v, causal, window)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        g = hq // hkv
        qk = q.reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4)
        out = flash_attention_ref(qk, k.transpose(1, 2), v.transpose(1, 2),
                                  window=window, scale=scale)
        return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or the CPU, not {q.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"the flash-attention kernel takes float32 or bfloat16, got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the flash-attention kernel takes D in {HEAD_DIMS}, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # The bf16 instance copies rows in 16-byte pieces; a view that starts
    # off a 16-byte boundary is copied to a fresh (aligned) tensor first.
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    out = torch.empty_like(q)
    lib = nvcc.library("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]
    fn.restype = _I
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), DTYPES[q.dtype],
                 b, sq, skv, hq, hkv, d, window, scale, stream)
    counter.add()
    nvcc.check(lib, err, "flash_attention")
    return out
