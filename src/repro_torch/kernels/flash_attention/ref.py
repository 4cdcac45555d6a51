"""Plain PyTorch versions of the prefill flash-attention kernel (K3) and of
its backward (K3b).

``flash_attention_ref`` is the same function as ``flash_attention_pallas``
in the kernel's GQA layout: q (B, Hkv, G, Sq, D), k and v (B, Hkv, Skv, D);
query i sits at position Skv - Sq + i and sees keys at positions <= its
own (and, with ``window > 0``, > position - window); with ``causal=False``
it sees every key, later ones too, and the window alone masks
(kernel.py:64-68).  Scores, max, sum and
the P.V accumulator are float32; masked scores take ``_NEG``, not -inf;
the probabilities are rounded to the input type before the P.V product,
as the kernel rounds them; a row with nothing valid keeps ``l`` clamped
to 1e-30.  One pass over the whole key axis: the kernel's blocked online
softmax gives the same values up to float32 summation order.  With
``return_lse`` it also returns the per-row logsumexp ``L = m + log l``
(B, Hkv, G, Sq), float32, which the reference's ``_flash_core_fwd``
(``src/repro/models/attention.py:248``) saves for its backward.  With
``rounding="tf32x3"`` it does the float32 kernel's arithmetic instead:
each product's operands split as the kernel splits them (``hi`` the
nearest TF32 value, ties away from zero, as ``cvt.rna.tf32.f32`` rounds,
``lo`` that of what ``hi`` left), the product lo.hi + hi.lo, then + hi.hi,
each term exact in float32 and summed in float32 (3xTF32: float32's
accuracy, on the tensor cores).

``flash_attention_bwd_ref`` is that backward, ``_flash_core_bwd``
(``src/repro/models/attention.py:265``) in its blockwise form: D =
rowsum(dO o O), then per query block and per key block p = exp(s - L),
rebuilt from the saved logsumexp and never stored whole, dV += p^T dO,
dP = dO V^T, dS = p (dP - D) scale, dQ += dS K, dK += dS^T Q, all in
float32 (float64 for float64 inputs), the G query heads of a KV head
summed into its dK and dV.  With ``rounding`` it does the bf16 kernel's
arithmetic instead (ROADMAP, queue 3, P10): ``"bf16"`` rounds p and dS to
bf16 where they become a product's operand (the D <= 128 design);
``"bf16x2"`` rounds dS so and takes p to dV's product as two bf16 terms,
its rounding and what that rounding left (the D = 256 design);
``"tf32x3"`` runs its five products as the float32 kernel runs them, as
the forward's ``rounding="tf32x3"`` does, on float32 inputs.
"""
from __future__ import annotations

import torch

__all__ = ["flash_attention_ref", "flash_attention_bwd_ref", "NEG", "split_tf32"]

NEG = -0.7 * float(torch.finfo(torch.float32).max)


def _tf32(t):
    """float32 -> the nearest TF32 value, ties away from zero (10 explicit
    mantissa bits: 2^12 added to the bits, the low 13 cleared)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(t):
    """(hi, lo) of a float32 tensor: hi its nearest TF32 value, lo that of
    t - hi; t = hi + lo to within 2^-21 |t|."""
    hi = _tf32(t)
    return hi, _tf32(t - hi)


def _product(eq, a, b, rounding=None):
    """einsum(eq, a, b), or with ``rounding="tf32x3"`` the float32 kernel's
    three TF32 products of the operands' splits."""
    if rounding != "tf32x3":
        return torch.einsum(eq, a, b)
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"rounding='tf32x3' splits float32 operands, not {a.dtype}, {b.dtype}")
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)) + torch.einsum(
        eq, a_hi, b_hi)


def _mask(q_pos, k_pos, window: int, causal: bool = True):
    mask = torch.ones((len(q_pos), len(k_pos)), dtype=torch.bool, device=q_pos.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return mask


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0, scale=None,
                        return_lse: bool = False, rounding=None):
    """q: (B, Hkv, G, Sq, D); k, v: (B, Hkv, Skv, D) -> (B, Hkv, G, Sq, D),
    and with ``return_lse`` the logsumexp (B, Hkv, G, Sq) float32.
    ``rounding``: None or ``"tf32x3"`` (the module's docstring)."""
    if rounding not in (None, "tf32x3"):
        raise ValueError(f"rounding {rounding!r}: None or 'tf32x3'")
    sq, d = q.shape[3], q.shape[4]
    skv = k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    s = _product("bhgqd,bhkd->bhgqk", q.float(), k.float(), rounding) * scale
    q_pos = torch.arange(sq, device=q.device) + (skv - sq)
    mask = _mask(q_pos, torch.arange(skv, device=q.device), window, causal)
    s = torch.where(mask, s, NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = _product("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v.float(), rounding)
    out = (acc / l.clamp_min(1e-30)).to(q.dtype)
    if not return_lse:
        return out
    return out, (m + torch.log(l.clamp_min(1e-30)))[..., 0]


def _bf16(t):
    return t.to(torch.bfloat16).to(t.dtype)


def flash_attention_bwd_ref(q, k, v, o, do, lse, *, window: int = 0, scale=None,
                            q_block: int = 64, kv_block: int = 64, rounding=None):
    """Gradients (dq, dk, dv) of ``flash_attention_ref`` in its layout: q, o
    and do (B, Hkv, G, Sq, D), k and v (B, Hkv, Skv, D), lse (B, Hkv, G, Sq)
    from the forward.  Each returned in its input's type.  ``rounding``:
    None, ``"bf16"``, ``"bf16x2"`` or ``"tf32x3"`` (the module's
    docstring)."""
    if rounding not in (None, "bf16", "bf16x2", "tf32x3"):
        raise ValueError(f"rounding {rounding!r}: None, 'bf16', 'bf16x2' or 'tf32x3'")
    sq, d = q.shape[3], q.shape[4]
    skv = k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    work = torch.float64 if q.dtype == torch.float64 else torch.float32
    qf, kf, vf, dof = (t.to(work) for t in (q, k, v, do))
    lse = lse.to(work)
    drow = (dof * o.to(work)).sum(dim=-1)  # D = rowsum(dO o O)
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    offset = skv - sq
    for q0 in range(0, sq, q_block):
        q1 = min(q0 + q_block, sq)
        qc, doc = qf[..., q0:q1, :], dof[..., q0:q1, :]
        lc, dc = lse[..., q0:q1, None], drow[..., q0:q1, None]
        q_pos = torch.arange(q0, q1, device=q.device) + offset
        for k0 in range(0, skv, kv_block):
            k1 = min(k0 + kv_block, skv)
            mask = _mask(q_pos, torch.arange(k0, k1, device=q.device), window)
            if not bool(mask.any()):
                continue  # a block wholly masked: above the diagonal or left of the window
            kc, vc = kf[..., k0:k1, :], vf[..., k0:k1, :]
            s = _product("bhgqd,bhkd->bhgqk", qc, kc, rounding) * scale
            p = torch.where(mask, torch.exp(s - lc), 0.0)
            if rounding == "bf16":
                pv = _bf16(p)
            elif rounding == "bf16x2":
                pv = _bf16(p) + _bf16(p - _bf16(p))
            else:
                pv = p
            dv[..., k0:k1, :] += _product("bhgqk,bhgqd->bhkd", pv, doc, rounding)
            dp = _product("bhgqd,bhkd->bhgqk", doc, vc, rounding)
            ds = p * (dp - dc) * scale
            if rounding in ("bf16", "bf16x2"):
                ds = _bf16(ds)
            dq[..., q0:q1, :] += _product("bhgqk,bhkd->bhgqd", ds, kc, rounding)
            dk[..., k0:k1, :] += _product("bhgqk,bhgqd->bhkd", ds, qc, rounding)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
