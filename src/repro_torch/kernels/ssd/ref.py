"""Plain PyTorch versions of the Mamba-2 SSD chunk-scan kernel (K5).

``ssd_chunk_ref`` is the same function as the reference model's
``ssd_scan`` (``src/repro/models/ssd.py:83``) after its padding, and as
``ssd_pallas`` where that takes one group: xdt (B, S, H, P), dA (B, S,
H), bm and cm (B, S, G, N) with G dividing H, head h reading group
h // (H / G) (or (B, S, N), one group), float32, ``S % chunk == 0``; it
returns y (B, S, H, P) and the final state (B, H, P, N), float32.  It is
written in the chunked algebra of ``ssd_scan``, in the same order of
operations, cut into the five stages the kernel launches
(``csrc/ssd.cu``), each a plain function here so that each kernel stage
is held against its own: ``chunk_cumsum`` (cum of dA per chunk and
head), ``chunk_scores`` (``C.B^T`` once per chunk and group, shared by
the group's heads), ``chunk_states`` (each chunk's own state),
``state_passing`` (the short scan over chunks: the state entering each
chunk, and the final state) and ``chunk_scan`` (``y_diag`` through the
scores and the causal decay ``L = exp(cum_i - cum_j)``, plus ``y_off``
from the entering state).  All of it is float32: the reference model
rounds scores, ``L`` and the carried states to a bf16 model's type
inside ``ssd_scan``; this function, like ``ssd_pallas``, does not
(ROADMAP, fault P3).

``ssd_sequential_ref`` is the step-by-step recurrence of
``src/repro/kernels/ssd/ref.py``, kept as a test oracle: one decay and
one rank-1 update per position.

``ssd_chunk_bwd_ref`` is the backward of ``ssd_chunk_ref`` (K5b's plain
version): the gradients of y with respect to xdt, dA, bm and cm, given
the output's gradient dy and what the forward leaves (the cumsum and the
state entering each chunk), as the reverse of the five stages, cut into
the stages of the kernel (``csrc/ssd_bwd.cu``):

  1. ``bwd_dstate``: the output stage's y_off backward gives the
     gradient of each chunk's entering state, dE = sum_i e^cum_i dy_i^T C_i;
  2. ``bwd_pass``: a reverse scan over the chunks through the state
     passing gives the gradient of each chunk's own state (dSc) and the
     chunk totals' share of dcum;
  3. ``bwd_dx``: dxdt through the scores (y_diag) and the chunk states,
     and each position's share of dcum through the decay to the chunk's end;
  4. ``bwd_dscores``: d(scores) per head, and dcum through the causal decay;
  5. ``bwd_dbc_heads``: per head, dC through y_off and dB through the chunk
     states, and dcum through y_off;
  6. ``bwd_dcum``: dcum summed, then the reverse cumsum that gives ddA;
  7. ``bwd_dbm_dcm``: each group's heads' d(scores) summed, through C.B^T
     into dB and dC, plus the group's heads' own dB and dC.

The final state is not differentiated (the model reads only y).
"""
from __future__ import annotations

import torch

__all__ = ["ssd_chunk_ref", "ssd_chunk_ref_saving", "ssd_sequential_ref", "chunk_cumsum",
           "chunk_scores", "chunk_states", "state_passing", "chunk_scan", "causal_decay",
           "ssd_chunk_bwd_ref", "bwd_dstate", "bwd_pass", "bwd_dx", "bwd_dscores",
           "bwd_dbc_heads", "bwd_dcum", "bwd_dbm_dcm"]


def _chunks(t, chunk):
    """(B, S, ...) -> (B, nc, l, ...), float32."""
    return t.float().reshape(t.shape[0], t.shape[1] // chunk, chunk, *t.shape[2:])


def _grouped(t):
    """B or C as (B, S, G, N): (B, S, N) is one group."""
    return t[:, :, None] if t.ndim == 3 else t


def _head_groups(h: int, g: int, device=None):
    """(H,) int64: the group each head reads, h // (H / G)."""
    return torch.arange(h, device=device) // (h // g)


def _per_head(t, h: int):
    """B or C (B, S, G, N) (or (B, S, N)) -> (B, S, H, N), each head's group."""
    t = _grouped(t)
    return t[:, :, _head_groups(h, t.shape[2], t.device)]


def causal_decay(cum):
    """cum: (..., l) -> (..., l, l); out[i, j] = exp(cum_i - cum_j) for
    i >= j, 0 above the diagonal: a difference of the cumsum, never a
    quotient of exponentials."""
    length = cum.shape[-1]
    d = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((length, length), dtype=torch.bool, device=cum.device))
    return torch.exp(d.masked_fill(~mask, float("-inf")))


def chunk_cumsum(dA, chunk: int):
    """Stage 1: dA (B, S, H) -> cum (B, H, nc, l), the cumsum of dA
    inside each chunk."""
    return torch.cumsum(_chunks(dA, chunk).permute(0, 3, 1, 2), dim=-1)


def chunk_scores(bm, cm, chunk: int):
    """Stage 2: (B, nc, G, l, l), the scores C.B^T of each chunk and group,
    one set for the group's heads."""
    return torch.einsum("bclgn,bcsgn->bcgls", _chunks(_grouped(cm), chunk),
                        _chunks(_grouped(bm), chunk))


def chunk_states(xdt, bm, cum, chunk: int):
    """Stage 3: (B, nc, H, P, N), each chunk's own contribution to the
    state, sum_j exp(cum_end - cum_j) xdt_j^T B_j (B of the head's group)."""
    decay_to_end = torch.exp(cum[..., -1:] - cum)
    return torch.einsum("bcshn,bhcs,bcshp->bchpn", _chunks(_per_head(bm, xdt.shape[2]), chunk),
                        decay_to_end, _chunks(xdt, chunk))


def state_passing(states, cum):
    """Stage 4: the short scan over the chunks, S_c = exp(cum_end,c) S_{c-1}
    + states_c.  Returns the state entering each chunk (B, nc, H, P, N)
    and the final state (B, H, P, N)."""
    chunk_decay = torch.exp(cum[..., -1])  # (b, h, nc)
    carry = torch.zeros_like(states[:, 0])
    entering = []
    for c in range(states.shape[1]):
        entering.append(carry)  # the state BEFORE chunk c
        carry = chunk_decay[:, :, c, None, None] * carry + states[:, c]
    return torch.stack(entering, dim=1), carry


def _scores_per_head(scores, h: int):
    """(B, nc, G, l, l) -> (B, nc, H, l, l), each head's group's scores."""
    return scores[:, :, _head_groups(h, scores.shape[2], scores.device)]


def chunk_scan(xdt, cm, scores, cum, entering, chunk: int):
    """Stage 5: y (B, S, H, P) = (scores o L) . xdt within each chunk
    plus exp(cum_i) C_i . S_enter^T from the state entering it (scores and
    C of the head's group)."""
    b, s, h, p = xdt.shape
    xc = _chunks(xdt, chunk)
    y_diag = torch.einsum("bchls,bhcls,bcshp->bclhp", _scores_per_head(scores, h),
                          causal_decay(cum), xc)
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", _chunks(_per_head(cm, h), chunk), entering,
                         torch.exp(cum))
    return (y_diag + y_off).reshape(b, s, h, p)


def ssd_chunk_ref_saving(xdt, dA, bm, cm, chunk: int = 128):
    """The five stages in order: (y (B, S, H, P), final_state (B, H, P, N),
    cum (B, H, nc, l), entering (B, nc, H, P, N)), float32; the last two are
    what the backward (``ssd_chunk_bwd_ref``) reads."""
    cum = chunk_cumsum(dA, chunk)
    scores = chunk_scores(bm, cm, chunk)
    entering, final_state = state_passing(chunk_states(xdt, bm, cum, chunk), cum)
    return chunk_scan(xdt, cm, scores, cum, entering, chunk), final_state, cum, entering


def ssd_chunk_ref(xdt, dA, bm, cm, chunk: int = 128):
    """(y (B, S, H, P), final_state (B, H, P, N)), float32."""
    return ssd_chunk_ref_saving(xdt, dA, bm, cm, chunk)[:2]


def ssd_sequential_ref(xdt, dA, bm, cm):
    """The recurrence one position at a time (the test oracle):
    ``state <- exp(dA_t) state + xdt_t (x) B_t``, ``y_t = state . C_t``."""
    b, s, h, p = xdt.shape
    n = bm.shape[-1]
    xdt, dA = xdt.float(), dA.float()
    bm, cm = (_per_head(t, h).float() for t in (bm, cm))
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=xdt.device)
    ys = []
    for t in range(s):
        upd = torch.einsum("bhn,bhp->bhpn", bm[:, t], xdt[:, t])
        state = torch.exp(dA[:, t])[:, :, None, None] * state + upd
        ys.append(torch.einsum("bhn,bhpn->bhp", cm[:, t], state))
    return torch.stack(ys, dim=1), state


# ------------------------------------------------------------ the backward


def bwd_dstate(dy, cm, cum, chunk: int):
    """Stage 1: (B, nc, H, P, N), the gradient of the state entering each
    chunk through y_off: sum_i exp(cum_i) dy_i[p] C_i[n]."""
    return torch.einsum("bhci,bcihp,bcihn->bchpn", torch.exp(cum), _chunks(dy, chunk),
                        _chunks(_per_head(cm, dy.shape[2]), chunk))


def bwd_pass(dE, entering, cum):
    """Stage 2: the reverse scan of ``state_passing``.  With g the gradient
    of the state leaving chunk c (0 after the last: the final state is not
    differentiated), dSc_c = g, chunk c's total decay a_c = exp(cum_end,c)
    takes a_c <g, E_c>, and g <- dE_c + a_c g.  Returns dSc (B, nc, H, P, N)
    and the chunk totals' dcum (B, H, nc)."""
    a = torch.exp(cum[..., -1])  # (b, h, nc)
    g = torch.zeros_like(dE[:, 0])
    dsc = torch.empty_like(dE)
    dcend = torch.empty_like(a)
    for c in reversed(range(dE.shape[1])):
        dsc[:, c] = g
        dcend[:, :, c] = a[:, :, c] * (g * entering[:, c]).sum(dim=(-1, -2))
        g = dE[:, c] + a[:, :, c, None, None] * g
    return dsc, dcend


def bwd_dx(xdt, dy, bm, scores, cum, dsc, chunk: int):
    """Stage 3: dxdt (B, S, H, P) = sum_{i >= j} (scores o L)_ij dy_i plus
    w_j sum_n B_j[n] dSc[p, n], w_j = exp(cum_end - cum_j); and r (B, H, nc,
    l) = w_j dw_j, the chunk states' share of dcum."""
    b, s, h, p = xdt.shape
    w_decay = _scores_per_head(scores, h).transpose(1, 2) * causal_decay(cum)  # (b, h, nc, i, j)
    t1 = torch.einsum("bhcij,bcihp->bcjhp", w_decay, _chunks(dy, chunk))
    u = torch.einsum("bcjhn,bchpn->bcjhp", _chunks(_per_head(bm, h), chunk), dsc)
    w = torch.exp(cum[..., -1:] - cum)  # (b, h, nc, l)
    dx = t1 + w.permute(0, 2, 3, 1)[..., None] * u
    r = w * torch.einsum("bcjhp,bcjhp->bhcj", _chunks(xdt, chunk), u)
    return dx.reshape(b, s, h, p), r


def bwd_dscores(xdt, dy, scores, cum, chunk: int):
    """Stage 4: per head, d(scores) (B, H, nc, l, l) = (dy_i . xdt_j) L_ij on
    and below the diagonal, and qd (B, H, nc, l), dcum through L: the row
    sums less the column sums of d(scores) o scores."""
    dw = torch.einsum("bcihp,bcjhp->bhcij", _chunks(dy, chunk), _chunks(xdt, chunk))
    dg = dw * causal_decay(cum)
    q = dg * _scores_per_head(scores, xdt.shape[2]).transpose(1, 2)
    return dg, q.sum(dim=-1) - q.sum(dim=-2)


def bwd_dbc_heads(xdt, dy, cm, cum, entering, dsc, chunk: int):
    """Stage 5: per head, dC (B, nc, l, H, N) = exp(cum_i) sum_p dy_i[p]
    E[p, n] through y_off, dB (B, nc, l, H, N) = w_j sum_p xdt_j[p] dSc[p, n]
    through the chunk states, and s (B, H, nc, l) = C_i . dC_i, dcum
    through y_off."""
    dco = torch.exp(cum).permute(0, 2, 3, 1)[..., None] * torch.einsum(
        "bcihp,bchpn->bcihn", _chunks(dy, chunk), entering)
    s = torch.einsum("bcihn,bcihn->bhci", _chunks(_per_head(cm, dy.shape[2]), chunk), dco)
    w = torch.exp(cum[..., -1:] - cum)
    dbo = w.permute(0, 2, 3, 1)[..., None] * torch.einsum(
        "bcihp,bchpn->bcihn", _chunks(xdt, chunk), dsc)
    return dco, dbo, s


def bwd_dcum(qd, s, r, dcend):
    """Stage 6: dcum = qd + s - r, the chunk's end also taking sum_j r_j and
    the pass's share; ddA (B, S, H) is its reverse cumsum in each chunk."""
    dcum = qd + s - r
    dcum[..., -1] += r.sum(dim=-1) + dcend
    dda = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), dim=-1), (-1,))
    b, h, nc, length = dda.shape
    return dda.permute(0, 2, 3, 1).reshape(b, nc * length, h)


def bwd_dbm_dcm(dg, dco, dbo, bm, cm, chunk: int):
    """Stage 7: each group's heads' d(scores) summed, through scores =
    C.B^T: dC += d(scores) . B, dB += d(scores)^T . C, plus the group's
    heads' own dC and dB.  Returns dbm, dcm in bm's and cm's shapes."""
    bg, cg = _grouped(bm), _grouped(cm)
    b, h, nc, length, _ = dg.shape
    g = bg.shape[2]
    dgt = dg.reshape(b, g, h // g, nc, length, length).sum(dim=2)  # (b, g, nc, i, j)
    bc, cc = _chunks(bg, chunk), _chunks(cg, chunk)
    own_c = dco.reshape(*dco.shape[:3], g, h // g, -1).sum(dim=4)
    own_b = dbo.reshape(*dbo.shape[:3], g, h // g, -1).sum(dim=4)
    dc = own_c + torch.einsum("bgcij,bcjgn->bcign", dgt, bc)
    db = own_b + torch.einsum("bgcij,bcign->bcjgn", dgt, cc)
    return db.reshape(bm.shape), dc.reshape(cm.shape)


def ssd_chunk_bwd_ref(xdt, bm, cm, dy, cum, entering, chunk: int = 128):
    """(dxdt (B, S, H, P), ddA (B, S, H), dbm, dcm in bm's shape), float32:
    the gradients of ``ssd_chunk_ref``'s y given dy, from the forward's cum
    (B, H, nc, l) and entering states (B, nc, H, P, N)."""
    xdt, bm, cm, dy = (t.float() for t in (xdt, bm, cm, dy))
    scores = chunk_scores(bm, cm, chunk)
    dsc, dcend = bwd_pass(bwd_dstate(dy, cm, cum, chunk), entering, cum)
    dx, r = bwd_dx(xdt, dy, bm, scores, cum, dsc, chunk)
    dg, qd = bwd_dscores(xdt, dy, scores, cum, chunk)
    dco, dbo, s = bwd_dbc_heads(xdt, dy, cm, cum, entering, dsc, chunk)
    dbm, dcm = bwd_dbm_dcm(dg, dco, dbo, bm, cm, chunk)
    return dx, bwd_dcum(qd, s, r, dcend), dbm, dcm
