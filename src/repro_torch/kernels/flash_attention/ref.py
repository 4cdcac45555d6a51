"""Plain PyTorch version of the prefill flash-attention kernel (K3).

The same function as ``flash_attention_pallas`` in the kernel's GQA
layout: q (B, Hkv, G, Sq, D), k and v (B, Hkv, Skv, D); query i sits at
position Skv - Sq + i and sees keys at positions <= its own (and, with
``window > 0``, > position - window).  Scores, max, sum and the P.V
accumulator are float32; masked scores take ``_NEG``, not -inf; the
probabilities are rounded to the input type before the P.V product, as
the kernel rounds them; a row with nothing valid keeps ``l`` clamped to
1e-30.  One pass over the whole key axis: the kernel's blocked online
softmax gives the same values up to float32 summation order.
"""
from __future__ import annotations

import torch

__all__ = ["flash_attention_ref", "NEG"]

NEG = -0.7 * float(torch.finfo(torch.float32).max)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0, scale=None):
    """q: (B, Hkv, G, Sq, D); k, v: (B, Hkv, Skv, D) -> (B, Hkv, G, Sq, D)."""
    if not causal:
        raise NotImplementedError(
            "flash attention is causal-only here, as its oracle "
            "src/repro/kernels/flash_attention/ref.py:21 is; flash_attention_pallas also "
            "takes causal=False (ROADMAP, queue 2, entry 6)")
    sq, d = q.shape[3], q.shape[4]
    skv = k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    s = torch.einsum("bhgqd,bhkd->bhgqk", q.float(), k.float()) * scale
    q_pos = torch.arange(sq, device=q.device) + (skv - sq)
    k_pos = torch.arange(skv, device=q.device)
    mask = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    s = torch.where(mask, s, NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v.float())
    return (acc / l.clamp_min(1e-30)).to(q.dtype)
