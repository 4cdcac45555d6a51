"""Wrapper of the flash-decode kernel (K4), the port of
``repro.kernels.decode_attention.ops``.

Model layout in and out: q (B, 1, Hq, D), caches (B, S, Hkv, D),
``lengths`` (B,) int32 valid positions per row.  Tensors on the CPU take
the plain version (``ref.py``, in the kernel's layout); CUDA tensors
launch ``csrc/decode_attention.cu`` on the current stream, one launch
per call, or raise.  There is no other route.  The launch depends on the
shapes and the card's SM count alone, allocates only its output and
reads ``lengths`` on the device, so a CUDA graph can hold it.  Its
instance (``instance``) follows (dtype, D, G): in bf16 at D = 256 the
query heads a pass fit G and the registers they free hold more rows in
flight, and ``split_count`` puts several blocks on each SM.

Fake tensors take a branch only they reach (``kernels.is_fake``): the
output as a fake tensor and the shape-only operator
``repro_torch::decode_attention``, whose FLOP formula counts q.K and p.V
over the whole cache, 4 D per (query head, cache position): the valid
lengths are data the trace does not see.  DTensors run on each rank's
batch rows and KV-head shards (``kernels.on_shards``).
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import (
    GRADIENTS_RULE,
    LaunchCounter,
    is_fake,
    is_sharded,
    nvcc,
    on_shards,
    refuse_grad,
)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.ops import DTYPES, HEAD_DIMS

__all__ = ["decode_attention", "counter", "MAX_GROUP", "instance", "split_count"]

counter = LaunchCounter("decode_attention")

MAX_GROUP = 32  # query heads per KV head (the kernel takes them 8 at a time at most)

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _library():
    """(the kernel's library, its entry points typed once; its largest
    cluster)."""
    lib = nvcc.library("decode_attention")
    lib.decode_max_splits.argtypes = []
    lib.decode_max_splits.restype = _I
    lib.decode_attention_fwd.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                         ctypes.c_float, _I, _P]
    lib.decode_attention_fwd.restype = _I
    lib.decode_instance.argtypes = [_I, _I, _I]
    lib.decode_instance.restype = _I
    return lib, lib.decode_max_splits()


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=())
def _k4_op(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           lengths: torch.Tensor, window: int) -> torch.Tensor:
    raise RuntimeError("repro_torch::decode_attention is K4's shape-only operator: it runs "
                       "on fake tensors alone")


@_k4_op.register_fake
def _(q, k_cache, v_cache, lengths, window):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.decode_attention)
def _k4_flops(q_shape, k_shape, *args, **kwargs) -> int:
    b, _, hq, d = q_shape
    return 4 * b * hq * k_shape[1] * d


def instance(dtype, d: int, g: int) -> dict:
    """The kernel instance a call of (dtype, D, G) launches, as the C entry
    ``decode_instance`` picks it: ``heads`` query heads a pass, ``rows`` in
    flight per lane group, ``resident`` blocks an SM.  8 heads and 2 rows,
    2 blocks an SM; but bf16 at D = 256 is ``fitted``: a row is one warp's
    16-byte loads, the heads follow G (1, 2, 4, or 8 from G = 5), and the
    registers of the head slots that would sit idle hold rows: 8 for one
    or two heads, 4 for four, which keep 4 blocks on an SM."""
    fitted = dtype == torch.bfloat16 and d == 256
    heads = next(h for h in (1, 2, 4, 8) if g <= h or h == 8) if fitted else 8
    rows = 8 if heads <= 2 else 4 if heads == 4 else 2
    return {"fitted": fitted, "heads": heads, "rows": rows, "resident": 4 if heads <= 4 else 2}


def split_count(b: int, hkv: int, s: int, sms: int, inst: dict, max_splits: int = 8) -> int:
    """Blocks per (batch row, KV head), 1 to ``max_splits`` (one cluster),
    fixed by the shapes.  Below D = 256 and in f32: as many as leave every
    block an SM of its own, at most one per 32 cache positions.  A fitted
    instance: enough for ``resident`` blocks on each of the ``sms`` SMs,
    at most one per pass of its four lane groups over the cache (4 x
    ``rows`` positions)."""
    if not inst["fitted"]:
        return max(1, min(max_splits, sms // (b * hkv), -(-s // 32)))
    return max(1, min(max_splits, -(-inst["resident"] * sms // (b * hkv)),
                      -(-s // (4 * inst["rows"]))))


def _check_args(q, k_cache, v_cache, lengths, window):
    if q.ndim != 4 or q.shape[1] != 1 or k_cache.ndim != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"q (B, 1, Hq, D), caches (B, S, Hkv, D): got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, _, hq, d = q.shape
    _, _, hkv, dk = k_cache.shape
    if k_cache.shape[0] != b or dk != d or hkv == 0 or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} and caches {tuple(k_cache.shape)} disagree")
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be ({b},) int32, got {tuple(lengths.shape)} "
                         f"{lengths.dtype}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def decode_attention(q, k_cache, v_cache, lengths, *, window: int = 0, scale=None):
    """One query token per row against its cache, (B, 1, Hq, D).

    ``lengths[b]`` (at most S) positions of row b are valid; the new
    token's K/V must already be written at ``lengths[b] - 1``."""
    _check_args(q, k_cache, v_cache, lengths, window)
    if is_sharded(q):
        def local(q, k_cache, v_cache, lengths):
            return decode_attention(q, k_cache, v_cache, lengths, window=window, scale=scale)

        return on_shards(local, (q, k_cache, v_cache, lengths),
                         ((0, 2), (0, 2), (0, 2), (0, None)), ((0, 2),))
    if is_fake(q):
        counter.add_fake()
        return _k4_op(q, k_cache, v_cache, lengths, window)
    b, _, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    scale = d ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        out = decode_attention_ref(q.reshape(b, hkv, g, d), k_cache.transpose(1, 2),
                                   v_cache.transpose(1, 2), lengths, window=window,
                                   scale=scale)
        return out.reshape(b, 1, hq, d)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on CUDA or the CPU, not {q.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"the flash-decode kernel takes float32 or bfloat16, got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the flash-decode kernel takes D in {HEAD_DIMS}, got {d}")
    if g > MAX_GROUP:
        raise ValueError(f"the flash-decode kernel takes G <= {MAX_GROUP}, got {g}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the kernel's loads)")
    lib, max_splits = _library()
    splits = split_count(b, hkv, s, _sm_count(q.device.index), instance(q.dtype, d, g),
                         max_splits)
    out = torch.empty_like(q)
    refuse_grad("decode_attention", f"it has no backward ({GRADIENTS_RULE})", q, k_cache,
                v_cache)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attention_fwd(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                                       lengths.data_ptr(), out.data_ptr(), DTYPES[q.dtype], b,
                                       s, hkv, g, d, window, scale, splits, stream)
    counter.add()
    nvcc.check(lib, err, "decode_attention")
    return out
