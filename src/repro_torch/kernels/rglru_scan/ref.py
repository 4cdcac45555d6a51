"""Plain PyTorch version of the RG-LRU scan kernel.

The Griffin recurrent block's gates and gated linear recurrence
(``src/repro/models/rglru.py:65`` ``_gates`` and the scan of
``rglru_forward`` :77 and ``rglru_decode_step`` :100), step by step in
float32: a sequential loop over the sequence where the reference takes
``jax.lax.associative_scan`` (the same recurrence, its products added in
another order).  Used for tensors on the CPU and, on the card, as the
kernel's comparison.  ``rglru_scan_chunked_ref`` is the kernel's own
order of operations (chunk summaries, the carry pushed through them,
each chunk scanned again from its carry), for the tests only.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["rglru_scan_ref", "rglru_scan_chunked_ref", "GATE_C"]

GATE_C = 8.0  # log a_t = -c * softplus(Lambda) * r_t (Griffin's c)


def _gates(u, a_w, a_b, x_w, x_b, lam):
    """a and b·x (B, S, L) float32 of every step."""
    uf = u.float()
    r = torch.sigmoid(uf * a_w.float() + a_b.float())
    i = torch.sigmoid(uf * x_w.float() + x_b.float())
    a = torch.exp(-GATE_C * F.softplus(lam.float()) * r)
    # sqrt(1 - a^2) input normalisation (Griffin eq. 2), clamped.
    return a, torch.sqrt(torch.clamp(1.0 - a * a, 1e-12, 1.0)) * i * uf


def rglru_scan_ref(u, gpre, a_w, a_b, x_w, x_b, lam, h0=None):
    """(y, h_last) of one recurrent block's scan; arguments as
    ``ops.rglru_scan``."""
    uf = u.float()
    gate = F.gelu(gpre.float(), approximate="tanh")
    a, bx = _gates(u, a_w, a_b, x_w, x_b, lam)
    b, s, width = u.shape
    h = h0.float() if h0 is not None else uf.new_zeros((b, width))
    hs = torch.empty_like(uf)
    for t in range(s):
        h = a[:, t] * h + bx[:, t]
        hs[:, t] = h
    return (hs * gate).to(u.dtype), h


def rglru_scan_chunked_ref(u, gpre, a_w, a_b, x_w, x_b, lam, h0=None, chunk=64):
    """``rglru_scan_ref``'s (y, h_last) in the kernel's order: S cut into
    chunks of ``chunk`` steps; each chunk's summary (A = prod a, H = its h
    from a zero start); the carry into chunk k, h0 (or 0) through the
    summaries of chunks 0 .. k-1 as h = A * h + H; each chunk's recurrence
    again from its carry.  The chunks run side by side, the last one padded
    with steps a = 1, b·x = 0, which leave h and A as they are."""
    b, s, width = u.shape
    n = -(-s // chunk)
    a, bx = _gates(u, a_w, a_b, x_w, x_b, lam)
    pad = n * chunk - s
    a = F.pad(a, (0, 0, 0, pad), value=1.0).reshape(b, n, chunk, width)
    bx = F.pad(bx, (0, 0, 0, pad)).reshape(b, n, chunk, width)
    prod = a.new_ones((b, n, width))
    h_sum = a.new_zeros((b, n, width))
    for t in range(chunk):
        prod = prod * a[:, :, t]
        h_sum = a[:, :, t] * h_sum + bx[:, :, t]
    carry = torch.empty_like(h_sum)
    h = h0.float() if h0 is not None else a.new_zeros((b, width))
    for k in range(n):
        carry[:, k] = h
        h = prod[:, k] * h + h_sum[:, k]
    hs = torch.empty_like(a)
    h = carry
    for t in range(chunk):
        h = a[:, :, t] * h + bx[:, :, t]
        hs[:, :, t] = h
    hs = hs.reshape(b, n * chunk, width)[:, :s]
    gate = F.gelu(gpre.float(), approximate="tanh")
    return (hs * gate).to(u.dtype), hs[:, -1].contiguous()
