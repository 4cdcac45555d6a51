"""Plain PyTorch version of the RG-LRU scan kernel.

The Griffin recurrent block's gates and gated linear recurrence
(``src/repro/models/rglru.py:65`` ``_gates`` and the scan of
``rglru_forward`` :77 and ``rglru_decode_step`` :100), step by step in
float32: a sequential loop over the sequence where the reference takes
``jax.lax.associative_scan`` (the same recurrence, its products added in
another order).  Used for tensors on the CPU and, on the card, as the
kernel's comparison.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["rglru_scan_ref", "GATE_C"]

GATE_C = 8.0  # log a_t = -c * softplus(Lambda) * r_t (Griffin's c)


def rglru_scan_ref(u, gpre, a_w, a_b, x_w, x_b, lam, h0=None):
    """(y, h_last) of one recurrent block's scan; arguments as
    ``ops.rglru_scan``."""
    uf = u.float()
    gate = F.gelu(gpre.float(), approximate="tanh")
    r = torch.sigmoid(uf * a_w.float() + a_b.float())
    i = torch.sigmoid(uf * x_w.float() + x_b.float())
    a = torch.exp(-GATE_C * F.softplus(lam.float()) * r)
    # sqrt(1 - a^2) input normalisation (Griffin eq. 2), clamped.
    bx = torch.sqrt(torch.clamp(1.0 - a * a, 1e-12, 1.0)) * i * uf
    b, s, width = u.shape
    h = h0.float() if h0 is not None else uf.new_zeros((b, width))
    hs = torch.empty_like(uf)
    for t in range(s):
        h = a[:, t] * h + bx[:, t]
        hs[:, t] = h
    return (hs * gate).to(u.dtype), h
