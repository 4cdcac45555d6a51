"""Attention: GQA/MQA, causal global and sliding-window, prefill and
decode, through the port's kernels.

The counterpart of ``repro.models.attention``'s forward path.  The
reference computes prefill attention with a chunked online softmax in
jnp (``flash_attention``) and decode attention with one einsum over the
cache (``decode_attention``); the port computes the same two functions
through K3 (``kernels.flash_attention``) and K4
(``kernels.decode_attention``), whose wrappers launch the CUDA kernels
for tensors on the card and run their plain versions on the CPU.  The
reference decodes at one scalar position; K4 takes per-row lengths, so
the decode step passes ``pos + 1`` for every row (``min(pos + 1, L)``
for a ring buffer of L slots), built on the device from the 0-dim
position tensor.  The int8 KV cache (``kv_quantize``, ``kv_dequantize``)
is the reference's ``blocks._kv_quant`` and ``_kv_dequant``: per-position
absmax codes with float32 scales, dequantised to the model's type before
K4.

Training differentiates prefill attention through
``flash_attention_autograd``, a ``torch.autograd.Function`` over K3 and
its backward K3b: the counterpart of the reference's custom VJP
``_flash_core`` (``src/repro/models/attention.py:235``), which saves q,
k, v, the output and the per-row logsumexp and rebuilds the
probabilities blockwise in the backward.  ``attn_forward`` takes it only
while autograd records and an input requires a gradient; serving calls
K3 alone, as before.

``attention_options(unroll=, skip_masked_blocks=)`` is the reference's
thread-local switch of the dry run's cost model.  The port's attention
always runs its kernels, so the options change only how a traced step
counts them: with ``skip_masked_blocks=False`` (the default) K3's and
K3b's FLOP formulas count the full Sq x Skv square, as the reference's
unrolled attention computes it; with ``True`` the key tiles K3 runs.
``unroll`` changes nothing (an eager trace counts every block anyway);
the dry run writes both options into its record.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import is_sharded, records_grad
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layers import rmsnorm, rope
from repro_torch.models.spec import P

__all__ = ["attn_spec", "attn_forward", "attn_decode", "kv_quantize", "kv_dequantize",
           "flash_attention_autograd", "attention_options"]

@contextlib.contextmanager
def attention_options(unroll: bool = False, skip_masked_blocks: bool = False):
    """The reference's options for this thread (restored on exit), kept
    where K3's and K3b's FLOP formulas read them (``flash_ops.COUNTING``)."""
    prev = getattr(flash_ops.COUNTING, "opts", None)
    flash_ops.COUNTING.opts = {"unroll": unroll, "skip": skip_masked_blocks}
    try:
        yield
    finally:
        flash_ops.COUNTING.opts = prev


def _attn_opts() -> dict:
    return getattr(flash_ops.COUNTING, "opts", None) or {"unroll": False, "skip": False}


class _FlashAttention(torch.autograd.Function):
    """K3 forward (with its logsumexp), K3b backward."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        out, lse = flash_ops.flash_attention(q, k, v, causal=True, window=window,
                                             return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_ops.flash_attention_bwd(q, k, v, out, dout.contiguous(), lse,
                                                   window=ctx.window)
        return dq, dk, dv, None


def flash_attention_autograd(q, k, v, window: int = 0):
    """Causal GQA attention (B, Sq, Hq, D) whose gradient runs through K3b."""
    return _FlashAttention.apply(q, k, v, window)


def attn_spec(d_model: int, num_heads: int, num_kv_heads: int, head_dim: int,
              qk_norm: bool) -> dict:
    spec = {
        "wq": P((d_model, num_heads, head_dim), ("embed", "heads", "head_dim")),
        "wk": P((d_model, num_kv_heads, head_dim), ("embed", "kv_heads", "head_dim")),
        "wv": P((d_model, num_kv_heads, head_dim), ("embed", "kv_heads", "head_dim")),
        "wo": P((num_heads, head_dim, d_model), ("heads", "head_dim", "embed")),
    }
    if qk_norm:
        spec["q_norm"] = {"scale": P((head_dim,), (None,), init="zeros")}
        spec["k_norm"] = {"scale": P((head_dim,), (None,), init="zeros")}
    return spec


def _heads(x, w):
    """x (B, T, d) @ w (d, H, Dh) -> (B, T, H, Dh), contiguous."""
    b, t, _ = x.shape
    d, h, dh = w.shape
    return (x @ w.reshape(d, h * dh)).view(b, t, h, dh)


def _project_qkv(params, x, cfg, positions, theta):
    q = _heads(x, params.wq)
    k = _heads(x, params.wk)
    v = _heads(x, params.wv)
    if hasattr(params, "q_norm"):
        q = rmsnorm(params.q_norm, q)
        k = rmsnorm(params.k_norm, k)
    q = rope(q, positions, theta)
    k = rope(k, positions, theta)
    return q, k, v


def _out(o, wo):
    """o (B, T, H, Dh) @ wo (H, Dh, d) -> (B, T, d)."""
    b, t = o.shape[:2]
    return o.reshape(b, t, -1) @ wo.reshape(-1, wo.shape[-1])


def attn_forward(params, x, cfg, *, window: int = 0, theta: float = 10_000.0,
                 positions=None):
    """Full-sequence causal attention through K3.  Returns (y, (k, v))
    for the cache build."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(params, x, cfg, positions, theta)
    if records_grad(q, k, v):
        o = flash_attention_autograd(q, k, v, window)
    else:
        o = flash_ops.flash_attention(q, k, v, causal=True, window=window)
    return _out(o, params.wo), (k, v)


def kv_quantize(x):
    """(B, S, H, D) -> (int8 codes, (B, S, H, 1) float32 scales): absmax per
    position and head, scale max(absmax, 1e-8) / 127, codes rounded half to
    even and clipped to +-127, as the reference's ``blocks._kv_quant``."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    return torch.round(xf / scale).clamp(-127, 127).to(torch.int8), scale


def kv_dequantize(codes, scale, dtype):
    """Codes times scales in float32, rounded to ``dtype``."""
    return (codes.float() * scale).to(dtype)


def _write_slot(buf, index, t):
    """``buf[:, index] = t`` in place.  A DTensor cache whose slots are
    sharded over a mesh axis (``launch.shardings.cache_pspecs``: seq over
    ``model``) is written on its local shards: the rank whose slots hold
    ``index`` writes, every other rank writes back what it holds (one
    branch-free path, no value read on the host)."""
    if not is_sharded(buf):
        buf.index_copy_(1, index, t)
        return
    from torch.distributed.tensor import DTensor, Replicate

    mesh, placements = buf.device_mesh, tuple(buf.placements)
    seq_axes = [i for i, p in enumerate(placements) if p.is_shard() and p.dim == 1]
    whole_seq = tuple(Replicate() if p.is_shard() and p.dim == 1 else p for p in placements)
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    src = t.redistribute(mesh, whole_seq).to_local()
    if isinstance(index, DTensor):
        index = index.to_local()
    local = buf.to_local()
    offset = 0
    for i in seq_axes:  # the first slot this rank holds
        offset = offset * mesh.size(i) + mesh.get_local_rank(i)
    at = index - offset * local.shape[1]
    held = (at >= 0) & (at < local.shape[1])
    at = at.clamp(0, local.shape[1] - 1)
    local.index_copy_(1, at, torch.where(held, src, local.index_select(1, at)))


def attn_decode(params, x, kv_cache, pos, cfg, *, window: int = 0,
                theta: float = 10_000.0, lengths=None, slot=None):
    """One decode step through K4.  x: (B, 1, D); ``pos`` the new token's
    0-based position, a 0-dim int32 tensor on x's device (the reference's
    scalar); ``kv_cache`` (k, v), each (B, L, Hkv, Dh), or with
    ``cfg.kv_quant`` (k codes, k scales, v codes, v scales): int8 (B, L,
    Hkv, Dh) codes and float32 (B, L, Hkv, 1) scales.  The new K/V go to
    slot ``slot`` (a 0-dim int32 tensor, ``pos % L`` for a ring buffer;
    ``pos`` unless given) and K4 reads ``lengths``, (B,) int32 valid
    slots (``pos + 1`` for every row unless given).

    The new K/V are written into the caches IN PLACE (the reference's
    ``dynamic_update_slice`` returns new arrays); the same tensors are
    returned.  Nothing here reads a device value on the host."""
    b = x.shape[0]
    q, k, v = _project_qkv(params, x, cfg, pos.expand(b, 1), theta)
    index = (pos if slot is None else slot).reshape(1).long()
    new = kv_quantize(k) + kv_quantize(v) if cfg.kv_quant else (k, v)
    for buf, t in zip(kv_cache, new):
        _write_slot(buf, index, t.to(buf.dtype))
    if cfg.kv_quant:
        k_codes, k_scale, v_codes, v_scale = kv_cache
        k_cache = kv_dequantize(k_codes, k_scale, q.dtype)
        v_cache = kv_dequantize(v_codes, v_scale, q.dtype)
    else:
        k_cache, v_cache = kv_cache
    if lengths is None:
        lengths = (pos + 1).expand(b).contiguous()
    o = decode_ops.decode_attention(q, k_cache, v_cache, lengths, window=window)
    return _out(o, params.wo), kv_cache
