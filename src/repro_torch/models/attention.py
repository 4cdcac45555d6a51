"""Attention: GQA/MQA, causal, prefill and decode, through the port's kernels.

The counterpart of ``repro.models.attention``'s forward path.  The
reference computes prefill attention with a chunked online softmax in
jnp (``flash_attention``) and decode attention with one einsum over the
cache (``decode_attention``); the port computes the same two functions
through K3 (``kernels.flash_attention``) and K4
(``kernels.decode_attention``), whose wrappers launch the CUDA kernels
for tensors on the card and run their plain versions on the CPU.  The
reference decodes at one scalar position; K4 takes per-row lengths, so
the decode step passes ``pos + 1`` for every row, built on the device
from the 0-dim position tensor.  Forward only: the flash backward (the
custom VJP of the reference) comes with training.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layers import rmsnorm, rope
from repro_torch.models.spec import P

__all__ = ["attn_spec", "attn_forward", "attn_decode"]


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
    o = flash_ops.flash_attention(q, k, v, causal=True, window=window)
    return _out(o, params.wo), (k, v)


def attn_decode(params, x, kv_cache, pos, cfg, *, window: int = 0,
                theta: float = 10_000.0, lengths=None):
    """One decode step through K4.  x: (B, 1, D); kv_cache: (k, v) each
    (B, Smax, Hkv, Dh); ``pos`` the new token's 0-based position, a 0-dim
    int32 tensor on x's device (the reference's scalar); ``lengths`` K4's
    (B,) int32 valid lengths, ``pos + 1`` for every row unless given.

    The new K/V are written into the caches IN PLACE at ``pos`` (the
    reference's ``dynamic_update_slice`` returns new arrays); the same
    tensors are returned.  Nothing here reads a device value on the
    host."""
    k_cache, v_cache = kv_cache
    b = x.shape[0]
    q, k, v = _project_qkv(params, x, cfg, pos.expand(b, 1), theta)
    slot = pos.reshape(1).long()
    k_cache.index_copy_(1, slot, k.to(k_cache.dtype))
    v_cache.index_copy_(1, slot, v.to(v_cache.dtype))
    if lengths is None:
        lengths = (pos + 1).expand(b).contiguous()
    o = decode_ops.decode_attention(q, k_cache, v_cache, lengths, window=window)
    return _out(o, params.wo), (k_cache, v_cache)
