"""Wrapper of the prefill flash-attention kernel (K3), the port of
``repro.kernels.flash_attention.ops``.

Model layout in and out: q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D).
Tensors on the CPU take the plain version (``ref.py``, in the kernel's
GQA layout); CUDA tensors launch ``csrc/flash_attention.cu`` on the
current stream, which reads the model layout directly, or raise.  There
is no other route.  The kernel's instance follows the dtype: bfloat16
runs on the tensor cores (``mma.sync``; at D = 256 warpgroup products,
``wgmma``, two warpgroups of 64 query rows a block), float32 on them too at fp32's
accuracy, each product as three TF32 products of an error-compensated
split (3xTF32; ``ref.py``'s ``rounding="tf32x3"`` emulates it), bound by
``mma.sync``'s TF32 rate (0.77 ms at tinyllama's prefill shape on an
H100, 3.7 times its bound; PERF.md §6); any other dtype raises.  With
``return_lse`` the forward also writes the per-row logsumexp (B, Hq, Sq)
float32 that its backward reads.
The forward takes ``causal=False`` as ``flash_attention_pallas`` does
(every key visible, the window alone masking); the backward is
causal-only, as the reference's model, the one route to its VJP, refuses
non-causal attention (``src/repro/models/attention.py:149-150``).

``flash_attention_bwd`` is the backward (K3b): dq, dk and dv from q, k,
v, the forward's output and logsumexp and the output's gradient, through
``csrc/flash_attention_bwd.cu`` on the card (counted on its own
``LaunchCounter``) or ``ref.flash_attention_bwd_ref`` on the CPU; as the
forward, both instances run their products on the tensor cores, bfloat16
on bf16 operands, float32 as 3xTF32 (2.76 ms at tinyllama's training
shape, 5.3 times its bound).  At D = 256 the bf16 instance runs its products as warpgroup
products (``wgmma``), and ``bwd_plan`` spreads a KV head's G query heads
over head groups when one block per (key tile, KV head, batch row) would
not fill the card.  The
model reaches both through the autograd function of ``models.attention``;
a direct CUDA call of the forward whose input requires a gradient raises
(``kernels.refuse_grad``).

On fake tensors both take a branch that only fake tensors reach
(``kernels.is_fake``): the outputs and the scratch of the launch as fake
tensors, and the shape-only operators ``repro_torch::flash_attention`` and
``repro_torch::flash_attention_bwd``, whose FLOP formulas count the full
Sq x Skv square (the reference's unrolled attention) unless
``models.attention.attention_options(skip_masked_blocks=True)`` is on,
when they count the key tiles the kernels run (``key_tiles``; every tile
the window reaches when not causal).  On
DTensors both run on each rank's batch rows and head shards
(``kernels.on_shards``).
"""
from __future__ import annotations

import ctypes
import threading

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import (
    LaunchCounter,
    is_fake,
    is_sharded,
    nvcc,
    on_shards,
    refuse_grad,
)
from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref, flash_attention_ref

__all__ = ["flash_attention", "flash_attention_bwd", "bwd_plan", "counter", "bwd_counter",
           "key_tiles", "HEAD_DIMS", "DTYPES", "WGMMA_SMEM", "SMEM_LIMIT"]

counter = LaunchCounter("flash_attention")
bwd_counter = LaunchCounter("flash_attention_bwd")

# The kernels' instances, K3's, K3b's and K4's (K3b's bf16 one at 256 on
# warpgroup products).
HEAD_DIMS = (16, 32, 64, 128, 256)
# dtype -> the C entry point's instance: 0 the fp32 kernel (3xTF32 on the
# tensor cores), 1 the bf16 one.  Both take 16-byte-aligned inputs.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int

# K3b's bf16 design at D = 256 (csrc/flash_attention_bwd.cu): 64-row tiles
# of 64 x 256 bf16 (32,768 B) on 1024-byte boundaries.  dkdv holds K, V, two
# stages of Q and dO, P^T (64 x 64 fp32) and two stages of 64 L and 64 D
# values; dq Q, dO, two stages of K and V, P (fp32) and dS (bf16).
WGMMA_ROWS = 64
_TILE = WGMMA_ROWS * 256 * 2
_PBYTES = WGMMA_ROWS * WGMMA_ROWS * 4
WGMMA_SMEM = {"dkdv": 1024 + 6 * _TILE + _PBYTES + 4 * WGMMA_ROWS * 4,
              "dq": 1024 + 6 * _TILE + _PBYTES + _PBYTES // 2}
SMEM_LIMIT = 232_448  # shared memory a block may have on the H100
H100_SMS = 132


def bwd_plan(b: int, skv: int, hq: int, hkv: int, d: int, dtype, sms: int = H100_SMS) -> dict:
    """K3b's launch plan: ``groups``, the head groups a KV head's G query
    heads are spread over (``heads``: each group's [first, end) of the G),
    and ``scratch``, the float32 elements of their partial dK and dV.  Only
    the bf16 instance at D = 256 splits: when its (key tile, KV head, batch
    row) blocks, one an SM, are fewer than the ``sms`` SMs, into enough
    groups for two waves; each group's blocks write fp32 partials that a
    small pass adds in group order."""
    g = hq // hkv
    groups = 1
    if dtype == torch.bfloat16 and d == 256:
        blocks = -(-skv // WGMMA_ROWS) * hkv * b
        if blocks < sms:
            groups = min(g, -(-2 * sms // blocks))
    heads = [(i * g // groups, (i + 1) * g // groups) for i in range(groups)]
    scratch = 2 * groups * b * skv * hkv * d if groups > 1 else 0
    return {"groups": groups, "heads": heads, "scratch": scratch}


# This thread's ``models.attention.attention_options``: with ``skip`` a
# traced step counts the key tiles the kernels run instead of the full square.
COUNTING = threading.local()
QUERY_ROWS = 64  # K3's and K3b's query rows per block, or per warpgroup (K3 bf16 at D = 256)


def _skip_masked() -> bool:
    opts = getattr(COUNTING, "opts", None)
    return bool(opts and opts["skip"])


def _key_tile(dtype, d: int) -> int:
    """K3's keys per tile in the count: 64, what its bf16 instances stage
    (at D = 256 each warpgroup of a 128-row block walks exactly the 64-key
    tiles a 64-row block would, ``QUERY_ROWS``); the fp32 instance stages
    32 at D = 128 and 256, and the count takes 64 there too, the padding of
    the square it counts."""
    return 64


def key_tiles(sq: int, skv: int, window: int, key_tile: int, rows: int = QUERY_ROWS,
              causal: bool = True) -> int:
    """The (query block, key tile) pairs one (batch row, head) runs: each
    block of ``rows`` queries (the last Sq of Skv positions) reads the
    ``key_tile``-key tiles from the first its window reaches (tile-aligned)
    to its last row's position (to the last key when not ``causal``), as
    K3's ``k_start``/``k_stop`` do."""
    offset, total = skv - sq, 0
    for q0 in range(0, sq, rows):
        first, last = offset + q0, offset + min(q0 + rows, sq) - 1
        stop = min(skv, last + 1) if causal else skv
        start = 0
        if window > 0 and first - window + 1 > 0:
            start = (first - window + 1) // key_tile * key_tile
        total += -(-(stop - start) // key_tile)
    return total


def _area(q_shape, k_shape, window: int, key_tile: int, rows: int = QUERY_ROWS,
          causal: bool = True) -> int:
    """Query-key pairs a kernel multiplies, per head dim element: the full
    square, or (``key_tile`` > 0) the tiles it runs, padded."""
    b, sq, hq, _ = q_shape
    skv = k_shape[1]
    if key_tile <= 0:
        return b * hq * sq * skv
    return b * hq * key_tiles(sq, skv, window, key_tile, rows, causal) * rows * key_tile


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _k3_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int, key_tile: int,
           lse_rows: int, causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    raise RuntimeError("repro_torch::flash_attention is K3's shape-only operator: it runs "
                       "on fake tensors alone")


@_k3_op.register_fake
def _(q, k, v, window, key_tile, lse_rows, causal):
    b, sq, hq, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, hq, sq) if lse_rows else (0,),
                                            dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _k3_flops(q_shape, k_shape, v_shape, window, key_tile, lse_rows, causal, *args,
              **kwargs) -> int:
    """Q.K^T and P.V: 4 D per query-key pair."""
    return 4 * q_shape[-1] * _area(q_shape, k_shape, window, key_tile, causal=causal)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def _k3b_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
            do: torch.Tensor, lse: torch.Tensor, window: int,
            key_tile: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    raise RuntimeError("repro_torch::flash_attention_bwd is K3b's shape-only operator: it "
                       "runs on fake tensors alone")


@_k3b_op.register_fake
def _(q, k, v, o, do, lse, window, key_tile):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _k3b_flops(q_shape, k_shape, v_shape, o_shape, do_shape, lse_shape, window, key_tile,
               *args, **kwargs) -> int:
    """S = Q.K^T again, dV += P^T.dO, dP = dO.V^T, dQ += dS.K, dK += dS^T.Q:
    10 D per query-key pair."""
    return 10 * q_shape[-1] * _area(q_shape, k_shape, window, key_tile)


def _fake_forward(q, k, v, causal, window, return_lse):
    """The fake-tensor branch of ``flash_attention``."""
    key_tile = _key_tile(q.dtype, q.shape[-1]) if _skip_masked() else 0
    out, lse = _k3_op(q, k, v, window, key_tile, int(return_lse), causal)
    counter.add_fake()
    return (out, lse) if return_lse else out


def _fake_backward(q, k, v, o, do, lse, window):
    """The fake-tensor branch of ``flash_attention_bwd``: its row sums and
    head-group partials as scratch."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    drow = q.new_empty((b, hq, sq), dtype=torch.float32)
    plan = bwd_plan(b, skv, hq, hkv, d, q.dtype)
    part = q.new_empty((plan["scratch"],), dtype=torch.float32) if plan["scratch"] else None
    grads = _k3b_op(q, k, v, o, do, lse, window, 64 if _skip_masked() else 0)
    del drow, part
    bwd_counter.add_fake()
    return grads


def _check_args(q, k, v, window):
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
    """Causal or not (optionally sliding-window) GQA attention, (B, Sq, Hq,
    D); with ``return_lse`` also the logsumexp (B, Hq, Sq) float32."""
    _check_args(q, k, v, window)
    if is_sharded(q):
        def local(q, k, v):
            return flash_attention(q, k, v, causal=causal, window=window, scale=scale,
                                   return_lse=return_lse)

        return on_shards(local, (q, k, v), ((0, 2),) * 3,
                         ((0, 2), (0, 1)) if return_lse else ((0, 2),))
    if is_fake(q):
        return _fake_forward(q, k, v, causal, window, return_lse)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        out = flash_attention_ref(_gqa(q, hkv), k.transpose(1, 2), v.transpose(1, 2),
                                  causal=causal, window=window, scale=scale,
                                  return_lse=return_lse)
        if not return_lse:
            return _model(out)
        return _model(out[0]), out[1].reshape(b, hq, sq)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or the CPU, not {q.device}")
    refuse_grad("flash_attention", "train through models.attention.flash_attention_autograd, "
                "whose backward is K3b" if causal else
                "K3b is causal-only: the reference's model refuses non-causal attention "
                "(src/repro/models/attention.py:149-150), the one route to its VJP", q, k, v)
    if q.dtype not in DTYPES:
        raise TypeError(f"the flash-attention kernel takes float32 or bfloat16, got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the flash-attention kernel takes D in {HEAD_DIMS}, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # Both instances copy rows in 16-byte pieces; a view that starts off a
    # 16-byte boundary is copied to a fresh (aligned) tensor first.
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if return_lse else None
    lib = nvcc.library("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]
    fn.restype = _I
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(), DTYPES[q.dtype],
                 b, sq, skv, hq, hkv, d, int(causal), window, scale, stream)
    counter.add()
    nvcc.check(lib, err, "flash_attention")
    return (out, lse) if return_lse else out


def flash_attention_bwd(q, k, v, o, do, lse, *, window: int = 0, scale=None):
    """K3b: (dq, dk, dv) of causal GQA attention, each in its input's type
    and layout: q, o and do (B, Sq, Hq, D), k and v (B, Skv, Hkv, D), lse
    (B, Hq, Sq) float32 from ``flash_attention(..., return_lse=True)``."""
    _check_args(q, k, v, window)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.device != q.device:
            raise ValueError(f"{name} must be {tuple(q.shape)} on {q.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    if tuple(lse.shape) != (b, hq, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 {(b, hq, sq)}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    if is_fake(q):
        return _fake_backward(q, k, v, o, do, lse, window)
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
    if d not in HEAD_DIMS:
        raise ValueError(f"the flash-attention backward takes D in {HEAD_DIMS}, got {d}")
    # Both instances copy rows in 16-byte pieces; an input that starts off a
    # 16-byte boundary is copied to a fresh (aligned) tensor first.
    q, k, v, o, do, lse = (t.contiguous() for t in (q, k, v, o, do, lse))
    q, k, v, o, do = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v, o, do))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    drow = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    plan = bwd_plan(b, skv, hq, hkv, d, q.dtype,
                    torch.cuda.get_device_properties(q.device).multi_processor_count)
    part = (torch.empty(plan["scratch"], dtype=torch.float32, device=q.device)
            if plan["scratch"] else None)
    lib = nvcc.library("flash_attention_bwd")
    fn = lib.flash_attention_bwd
    fn.argtypes = [_P] * 11 + [_I] * 9 + [ctypes.c_float, _P]
    fn.restype = _I
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(t.data_ptr() for t in (q, k, v, o, do, lse, drow, dq, dk, dv)),
                 None if part is None else part.data_ptr(), DTYPES[q.dtype], b, sq, skv, hq,
                 hkv, d, window, plan["groups"], scale, stream)
    bwd_counter.add()
    nvcc.check(lib, err, "flash_attention_bwd")
    return dq, dk, dv
