"""Wrapper of the prefill flash-attention kernel (K3), the port of
``repro.kernels.flash_attention.ops``.

Model layout in and out: q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D).
Tensors on the CPU take the plain version (``ref.py``, in the kernel's
GQA layout); CUDA tensors launch ``csrc/flash_attention.cu`` on the
current stream, which reads the model layout directly, or raise.  There
is no other route.  The kernel's instance follows the dtype: bfloat16
runs on the tensor cores (``mma.sync``), float32 on the CUDA cores in
IEEE fp32; any other dtype raises.  With ``return_lse`` the forward also
writes the per-row logsumexp (B, Hq, Sq) float32 that its backward reads.

``flash_attention_bwd`` is the backward (K3b): dq, dk and dv from q, k,
v, the forward's output and logsumexp and the output's gradient, through
``csrc/flash_attention_bwd.cu`` on the card (counted on its own
``LaunchCounter``) or ``ref.flash_attention_bwd_ref`` on the CPU; as the
forward, bfloat16 runs its products on the tensor cores, float32 on the
CUDA cores.  The
model reaches both through the autograd function of ``models.attention``;
a direct CUDA call of the forward whose input requires a gradient raises
(``kernels.refuse_grad``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LaunchCounter, nvcc, refuse_grad
from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref, flash_attention_ref

__all__ = ["flash_attention", "flash_attention_bwd", "counter", "bwd_counter", "HEAD_DIMS",
           "BWD_HEAD_DIMS", "DTYPES"]

counter = LaunchCounter("flash_attention")
bwd_counter = LaunchCounter("flash_attention_bwd")

# K3b's instances; head dim 256 waits for its own design (ROADMAP, queue 2, entry 7).
BWD_HEAD_DIMS = (16, 32, 64, 128)

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


def _gqa(t, hkv):
    """(B, S, Hq, D) -> the kernel layout (B, Hkv, G, S, D), a view."""
    b, s, hq, d = t.shape
    return t.reshape(b, s, hkv, hq // hkv, d).permute(0, 2, 3, 1, 4)


def _model(t):
    """(B, Hkv, G, S, D) -> (B, S, Hq, D)."""
    b, hkv, g, s, d = t.shape
    return t.permute(0, 3, 1, 2, 4).reshape(b, s, hkv * g, d)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, scale=None,
                    return_lse: bool = False):
    """Causal (optionally sliding-window) GQA attention, (B, Sq, Hq, D);
    with ``return_lse`` also the logsumexp (B, Hq, Sq) float32."""
    _check_args(q, k, v, causal, window)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        out = flash_attention_ref(_gqa(q, hkv), k.transpose(1, 2), v.transpose(1, 2),
                                  window=window, scale=scale, return_lse=return_lse)
        if not return_lse:
            return _model(out)
        return _model(out[0]), out[1].reshape(b, hq, sq)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or the CPU, not {q.device}")
    refuse_grad("flash_attention", "train through models.attention.flash_attention_autograd, "
                "whose backward is K3b", q, k, v)
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
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if return_lse else None
    lib = nvcc.library("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]
    fn.restype = _I
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(), DTYPES[q.dtype],
                 b, sq, skv, hq, hkv, d, window, scale, stream)
    counter.add()
    nvcc.check(lib, err, "flash_attention")
    return (out, lse) if return_lse else out


def flash_attention_bwd(q, k, v, o, do, lse, *, window: int = 0, scale=None):
    """K3b: (dq, dk, dv) of causal GQA attention, each in its input's type
    and layout: q, o and do (B, Sq, Hq, D), k and v (B, Skv, Hkv, D), lse
    (B, Hq, Sq) float32 from ``flash_attention(..., return_lse=True)``."""
    _check_args(q, k, v, True, window)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.device != q.device:
            raise ValueError(f"{name} must be {tuple(q.shape)} on {q.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    if tuple(lse.shape) != (b, hq, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 {(b, hq, sq)}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    scale = d ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        dq, dk, dv = flash_attention_bwd_ref(
            _gqa(q, hkv), k.transpose(1, 2), v.transpose(1, 2), _gqa(o, hkv), _gqa(do, hkv),
            lse.reshape(b, hkv, hq // hkv, sq), window=window, scale=scale)
        return _model(dq), dk.transpose(1, 2), dv.transpose(1, 2)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on CUDA or the CPU, not {q.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"the flash-attention backward takes float32 or bfloat16, got {q.dtype}")
    if o.dtype != q.dtype or do.dtype != q.dtype:
        raise TypeError(f"o and do must be {q.dtype}, got {o.dtype} and {do.dtype}")
    if d not in BWD_HEAD_DIMS:
        raise NotImplementedError(
            f"the flash-attention backward takes D in {BWD_HEAD_DIMS}, got {d}: head dim 256 "
            "waits for its own design (ROADMAP, queue 2, entry 7)")
    # The bf16 instance copies rows in 16-byte pieces; an input that starts
    # off a 16-byte boundary is copied to a fresh (aligned) tensor first.
    q, k, v, o, do, lse = (t.contiguous() for t in (q, k, v, o, do, lse))
    q, k, v, o, do = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v, o, do))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    drow = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    lib = nvcc.library("flash_attention_bwd")
    fn = lib.flash_attention_bwd
    fn.argtypes = [_P] * 10 + [_I] * 8 + [ctypes.c_float, _P]
    fn.restype = _I
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(t.data_ptr() for t in (q, k, v, o, do, lse, drow, dq, dk, dv)),
                 DTYPES[q.dtype], b, sq, skv, hq, hkv, d, window, scale, stream)
    bwd_counter.add()
    nvcc.check(lib, err, "flash_attention_bwd")
    return dq, dk, dv
