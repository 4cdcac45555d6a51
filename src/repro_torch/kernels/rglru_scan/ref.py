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

``rglru_scan_bwd_ref`` is the backward's plain version: h recomputed by
the same loop, then an explicit float32 reverse loop over the adjoint
recurrence and the chain rule through the gates, written out (the
gradient that ``jax.grad`` takes through the reference's ``_gates`` and
``associative_scan``, src/repro/models/rglru.py:65-97).
``rglru_scan_bwd_chunked_ref`` is the same gradient in the backward
kernel's order (span summaries, the adjoint pushed through them from the
right, each span walked back from its entering value, the sums added span
by span and chunk by chunk), for the tests only.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["rglru_scan_ref", "rglru_scan_saving_ref", "rglru_scan_chunked_ref",
           "rglru_scan_bwd_ref", "rglru_scan_bwd_chunked_ref", "GATE_C", "CLAMP_LO"]

GATE_C = 8.0  # log a_t = -c * softplus(Lambda) * r_t (Griffin's c)
CLAMP_LO = 1e-12  # 1 - a^2 is clamped to [CLAMP_LO, 1]


def _gates(u, a_w, a_b, x_w, x_b, lam):
    """a and b·x (B, S, L) float32 of every step."""
    uf = u.float()
    r = torch.sigmoid(uf * a_w.float() + a_b.float())
    i = torch.sigmoid(uf * x_w.float() + x_b.float())
    a = torch.exp(-GATE_C * F.softplus(lam.float()) * r)
    # sqrt(1 - a^2) input normalisation (Griffin eq. 2), clamped.
    return a, torch.sqrt(torch.clamp(1.0 - a * a, CLAMP_LO, 1.0)) * i * uf


def _states(a, bx, h0):
    """h (B, S, L) float32 of every step, from h0 (or zeros)."""
    h = h0.float() if h0 is not None else a.new_zeros((a.shape[0], a.shape[2]))
    hs = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + bx[:, t]
        hs[:, t] = h
    return hs


def rglru_scan_ref(u, gpre, a_w, a_b, x_w, x_b, lam, h0=None):
    """(y, h_last) of one recurrent block's scan; arguments as
    ``ops.rglru_scan``."""
    gate = F.gelu(gpre.float(), approximate="tanh")
    hs = _states(*_gates(u, a_w, a_b, x_w, x_b, lam), h0)
    return (hs * gate).to(u.dtype), hs[:, -1]


def rglru_scan_saving_ref(u, gpre, a_w, a_b, x_w, x_b, lam, h0=None, chunk=16):
    """``rglru_scan_ref``'s (y, h_last) and the carries (B, ceil(S /
    chunk), L) float32: the h entering every ``chunk`` steps (the kernel's
    carry span), h0 (or zeros) first."""
    gate = F.gelu(gpre.float(), approximate="tanh")
    hs = _states(*_gates(u, a_w, a_b, x_w, x_b, lam), h0)
    b, s, width = u.shape
    first = h0.float() if h0 is not None else hs.new_zeros((b, width))
    carries = torch.cat([first[:, None], hs[:, chunk - 1:s - 1:chunk]], dim=1)
    return (hs * gate).to(u.dtype), hs[:, -1], carries.contiguous()


def _bwd_parts(u, gpre, a_w, a_b, x_w, x_b, lam, dy, h0):
    """What both plain backwards take per step, float32 (B, S, L): h, the
    h before it, r, i, a, sqrt(v), whether 1 - a^2 lay inside the clamp,
    e = dy gelu(gpre), dgpre; and -8 softplus(Lambda) (L,)."""
    uf, gf, dyf = u.float(), gpre.float(), dy.float()
    aw, ab, xw, xb, lm = (v.float() for v in (a_w, a_b, x_w, x_b, lam))
    r = torch.sigmoid(uf * aw + ab)
    i = torch.sigmoid(uf * xw + xb)
    neg_c_sp = -GATE_C * F.softplus(lm)
    a = torch.exp(neg_c_sp * r)
    pre = 1.0 - a * a
    sq = torch.sqrt(torch.clamp(pre, CLAMP_LO, 1.0))
    hs = _states(a, sq * i * uf, h0)
    b, _, width = u.shape
    h_prev = torch.cat([(h0.float() if h0 is not None else hs.new_zeros((b, width)))[:, None],
                        hs[:, :-1]], dim=1)
    # GeLU (tanh form) and its derivative, with z = sqrt(2 / pi) (x + 0.044715 x^3).
    k = (2.0 / torch.pi) ** 0.5
    th = torch.tanh(k * (gf + 0.044715 * gf ** 3))
    gelu = 0.5 * gf * (1.0 + th)
    dgelu = 0.5 * (1.0 + th) + 0.5 * gf * (1.0 - th * th) * k * (1.0 + 3 * 0.044715 * gf * gf)
    inside = (pre >= CLAMP_LO) & (pre <= 1.0)
    return hs, h_prev, r, i, a, sq, inside, dyf * gelu, dyf * hs * dgelu, neg_c_sp


def _bwd_terms(g, uf, h_prev, r, i, a, sq, inside, neg_c_sp, aw, xw):
    """du and the vector gradients' terms (d_pre_r, d_pre_i, d_loga r) of
    steps whose adjoint is g."""
    d_i = g * sq * uf
    d_v = torch.where(inside, 0.5 * g * i * uf / sq, torch.zeros_like(g))
    d_loga = (g * h_prev - 2.0 * a * d_v) * a
    d_pre_r = d_loga * neg_c_sp * r * (1.0 - r)
    d_pre_i = d_i * i * (1.0 - i)
    return g * sq * i + d_pre_r * aw + d_pre_i * xw, d_pre_r, d_pre_i, d_loga * r


def rglru_scan_bwd_ref(u, gpre, a_w, a_b, x_w, x_b, lam, dy, h0=None, dh_last=None):
    """The gradients of ``rglru_scan_ref`` given the output's gradient
    ``dy`` (B, S, L) and the last state's ``dh_last`` (B, L) float32 or
    None (zeros): (du, dgpre) in u's type, (da_w, da_b, dx_w, dx_b, dlam)
    in the vectors' type, and dh0 (B, L) float32, or None when ``h0`` is.
    The clamp of 1 - a^2 passes its gradient inside [CLAMP_LO, 1], bounds
    included, as torch's ``clamp`` does."""
    hs, h_prev, r, i, a, sq, inside, e, dgpre, neg_c_sp = _bwd_parts(
        u, gpre, a_w, a_b, x_w, x_b, lam, dy, h0)
    b, s, width = u.shape
    # The adjoint recurrence, backwards: g_t = e_t + a_{t+1} g_{t+1}.
    g = torch.empty_like(e)
    w = dh_last.float() if dh_last is not None else e.new_zeros((b, width))
    for t in range(s - 1, -1, -1):
        g[:, t] = e[:, t] + w
        w = a[:, t] * g[:, t]
    uf = u.float()
    du, d_pre_r, d_pre_i, d_lam = _bwd_terms(g, uf, h_prev, r, i, a, sq, inside, neg_c_sp,
                                             a_w.float(), x_w.float())
    vec_grads = (
        (d_pre_r * uf).sum((0, 1)), d_pre_r.sum((0, 1)), (d_pre_i * uf).sum((0, 1)),
        d_pre_i.sum((0, 1)), d_lam.sum((0, 1)) * -GATE_C * torch.sigmoid(lam.float()),
    )
    return ((du.to(u.dtype), dgpre.to(u.dtype))
            + tuple(gv.to(t.dtype) for gv, t in zip(vec_grads, (a_w, a_b, x_w, x_b, lam)))
            + (w if h0 is not None else None,))


def rglru_scan_bwd_chunked_ref(u, gpre, a_w, a_b, x_w, x_b, lam, dy, h0=None, dh_last=None,
                               chunk=64, span=16):
    """``rglru_scan_bwd_ref``'s gradients in the backward kernel's order:
    S cut into spans of ``span`` steps (the forward's carry span) and
    chunks of ``chunk``.  Each span's summary A = prod a, E = sum_t
    (prod_{s <= t} a_s) e_t (accumulated forwards); the adjoint entering
    the last span is dh_last (or 0), and each span hands the one on its
    left A w + E, the first span's being dh0; each span walked back from
    its entering w (g_t = e_t + w, w = a_t g_t), its sums of the vector
    gradients' terms taken over its steps backwards, the spans' sums of a
    chunk added from the right, and the chunks' over (batch row, chunk) in
    that order."""
    hs, h_prev, r, i, a, sq, inside, e, dgpre, neg_c_sp = _bwd_parts(
        u, gpre, a_w, a_b, x_w, x_b, lam, dy, h0)
    b, s, width = u.shape
    bounds = [(t0, min(s, t0 + span)) for t0 in range(0, s, span)]
    summaries = []
    for t0, t1 in bounds:
        prod, esum = e.new_ones((b, width)), e.new_zeros((b, width))
        for t in range(t0, t1):
            prod = prod * a[:, t]
            esum = prod * e[:, t] + esum
        summaries.append((prod, esum))
    w = dh_last.float() if dh_last is not None else e.new_zeros((b, width))
    entering = [None] * len(bounds)
    for j in range(len(bounds) - 1, -1, -1):
        entering[j] = w
        w = summaries[j][0] * w + summaries[j][1]
    uf = u.float()
    g = torch.empty_like(e)
    for (t0, t1), w_in in zip(bounds, entering):
        w_j = w_in
        for t in range(t1 - 1, t0 - 1, -1):
            g[:, t] = e[:, t] + w_j
            w_j = a[:, t] * g[:, t]
    du, d_pre_r, d_pre_i, d_lam = _bwd_terms(g, uf, h_prev, r, i, a, sq, inside, neg_c_sp,
                                             a_w.float(), x_w.float())
    terms = (d_pre_r * uf, d_pre_r, d_pre_i * uf, d_pre_i, d_lam)
    per = chunk // span
    chunk_sums = []  # per chunk: the five (B, L) sums
    for k in range(-(-s // chunk)):
        spans = range(k * per, min(len(bounds), (k + 1) * per))
        total = None
        for j in reversed(spans):
            t0, t1 = bounds[j]
            acc = [e.new_zeros((b, width)) for _ in terms]
            for t in range(t1 - 1, t0 - 1, -1):
                acc = [x + term[:, t] for x, term in zip(acc, terms)]
            total = acc if total is None else [x + y for x, y in zip(total, acc)]
        chunk_sums.append(total)
    vec_grads = []
    for n in range(len(terms)):
        v = e.new_zeros(width)
        for bi in range(b):
            for total in chunk_sums:
                v = v + total[n][bi]
        vec_grads.append(v)
    vec_grads[-1] = vec_grads[-1] * -GATE_C * torch.sigmoid(lam.float())
    return ((du.to(u.dtype), dgpre.to(u.dtype))
            + tuple(gv.to(t.dtype) for gv, t in zip(vec_grads, (a_w, a_b, x_w, x_b, lam)))
            + (w if h0 is not None else None,))


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
