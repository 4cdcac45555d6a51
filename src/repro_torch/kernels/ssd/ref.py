"""Plain PyTorch versions of the Mamba-2 SSD chunk-scan kernel (K5).

``ssd_chunk_ref`` is the same function as ``ssd_pallas``: xdt
(B, S, H, P), dA (B, S, H), bm and cm (B, S, N), float32, ngroups = 1,
``S % chunk == 0``; it returns y (B, S, H, P) and the final state
(B, H, P, N), float32.  It is written in the chunked algebra of the
reference model's ``ssd_scan`` (``src/repro/models/ssd.py:83``), in the
same order of operations with ngroups = 1, cut into the five stages
the kernel launches (``csrc/ssd.cu``), each a plain function here so
that each kernel stage is held against its own: ``chunk_cumsum`` (cum
of dA per chunk and head), ``chunk_scores`` (``C.B^T`` once per chunk,
shared by the heads), ``chunk_states`` (each chunk's own state),
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
"""
from __future__ import annotations

import torch

__all__ = ["ssd_chunk_ref", "ssd_sequential_ref", "chunk_cumsum", "chunk_scores",
           "chunk_states", "state_passing", "chunk_scan", "causal_decay"]


def _chunks(t, chunk):
    """(B, S, ...) -> (B, nc, l, ...), float32."""
    return t.float().reshape(t.shape[0], t.shape[1] // chunk, chunk, *t.shape[2:])


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
    """Stage 2: (B, nc, l, l), the scores C.B^T of each chunk, one set
    for every head (ngroups = 1)."""
    return torch.einsum("bcln,bcsn->bcls", _chunks(cm, chunk), _chunks(bm, chunk))


def chunk_states(xdt, bm, cum, chunk: int):
    """Stage 3: (B, nc, H, P, N), each chunk's own contribution to the
    state, sum_j exp(cum_end - cum_j) xdt_j^T B_j."""
    decay_to_end = torch.exp(cum[..., -1:] - cum)
    return torch.einsum("bcsn,bhcs,bcshp->bchpn", _chunks(bm, chunk), decay_to_end,
                        _chunks(xdt, chunk))


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


def chunk_scan(xdt, cm, scores, cum, entering, chunk: int):
    """Stage 5: y (B, S, H, P) = (scores o L) . xdt within each chunk
    plus exp(cum_i) C_i . S_enter^T from the state entering it."""
    b, s, h, p = xdt.shape
    xc = _chunks(xdt, chunk)
    y_diag = torch.einsum("bcls,bhcls,bcshp->bclhp", scores, causal_decay(cum), xc)
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", _chunks(cm, chunk), entering,
                         torch.exp(cum))
    return (y_diag + y_off).reshape(b, s, h, p)


def ssd_chunk_ref(xdt, dA, bm, cm, chunk: int = 128):
    """(y (B, S, H, P), final_state (B, H, P, N)), float32: the five
    stages in order."""
    cum = chunk_cumsum(dA, chunk)
    scores = chunk_scores(bm, cm, chunk)
    entering, final_state = state_passing(chunk_states(xdt, bm, cum, chunk), cum)
    return chunk_scan(xdt, cm, scores, cum, entering, chunk), final_state


def ssd_sequential_ref(xdt, dA, bm, cm):
    """The recurrence one position at a time (the test oracle):
    ``state <- exp(dA_t) state + xdt_t (x) B_t``, ``y_t = state . C_t``."""
    b, s, h, p = xdt.shape
    n = bm.shape[-1]
    xdt, dA, bm, cm = (t.float() for t in (xdt, dA, bm, cm))
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=xdt.device)
    ys = []
    for t in range(s):
        upd = torch.einsum("bn,bhp->bhpn", bm[:, t], xdt[:, t])
        state = torch.exp(dA[:, t])[:, :, None, None] * state + upd
        ys.append(torch.einsum("bn,bhpn->bhp", cm[:, t], state))
    return torch.stack(ys, dim=1), state
