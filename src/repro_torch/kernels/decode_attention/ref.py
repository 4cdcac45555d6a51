"""Plain PyTorch version of the flash-decode kernel (K4).

The same function as ``decode_attention_pallas`` in the kernel's layout:
q (B, Hkv, G, D), caches (B, Hkv, S, D), lengths (B,); row b attends to
the positions p < lengths[b] (and, with ``window > 0``,
p >= lengths[b] - window).  Float32 scores, ``_NEG`` for masked ones,
unnormalised probabilities rounded to the cache type before the P.V
product and divided by the clamped sum afterwards, as the kernel does
(the jnp oracle ``decode_attention_ref`` of the JAX package normalises
first; the two agree in float32).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ref import NEG

__all__ = ["decode_attention_ref"]


def decode_attention_ref(q, k_cache, v_cache, lengths, *, window: int = 0, scale=None):
    """q: (B, Hkv, G, D); caches: (B, Hkv, S, D); lengths: (B,) -> (B, Hkv, G, D)."""
    d = q.shape[-1]
    s = k_cache.shape[2]
    scale = d ** -0.5 if scale is None else scale
    logits = torch.einsum("bhgd,bhsd->bhgs", q.float(), k_cache.float()) * scale
    pos = torch.arange(s, device=q.device)[None, :]
    lengths = lengths.to(q.device)[:, None]
    mask = pos < lengths
    if window > 0:
        mask &= pos >= lengths - window
    mask = mask[:, None, None, :]
    logits = torch.where(mask, logits, NEG)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgs,bhsd->bhgd", p.to(v_cache.dtype).float(), v_cache.float())
    return (acc / l.clamp_min(1e-30)).to(q.dtype)
