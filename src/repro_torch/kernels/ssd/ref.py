"""Plain PyTorch versions of the Mamba-2 SSD chunk-scan kernel (K5).

``ssd_chunk_ref`` is the same function as ``ssd_pallas``: xdt
(B, S, H, P), dA (B, S, H), bm and cm (B, S, N), float32, ngroups = 1,
``S % chunk == 0``; it returns y (B, S, H, P) and the final state
(B, H, P, N), float32.  It is written in the chunked algebra of the
reference model's ``ssd_scan`` (``src/repro/models/ssd.py:83``), in the
same order of operations with ngroups = 1: the causal decay
``L = exp(segsum(dA))`` per chunk, the intra-chunk ``y_diag`` through
the scores ``C.B^T``, the chunk states, a short loop over chunks for the
carried state, and ``y_off`` from the state before each chunk.  All of
it is float32: the reference model rounds scores, ``L`` and the carried
states to a bf16 model's type inside ``ssd_scan``; this function, like
``ssd_pallas``, does not (ROADMAP, fault P3).

``ssd_sequential_ref`` is the step-by-step recurrence of
``src/repro/kernels/ssd/ref.py``, kept as a test oracle: one decay and
one rank-1 update per position.
"""
from __future__ import annotations

import torch

__all__ = ["ssd_chunk_ref", "ssd_sequential_ref", "segsum"]


def segsum(x):
    """x: (..., L) -> (..., L, L); out[i, j] = sum_{k=j+1..i} x_k for
    i >= j, -inf above the diagonal (so exp(.) is the causal decay)."""
    length = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((length, length), dtype=torch.bool, device=x.device))
    return d.masked_fill(~mask, float("-inf"))


def ssd_chunk_ref(xdt, dA, bm, cm, chunk: int = 128):
    """(y (B, S, H, P), final_state (B, H, P, N)), float32."""
    b, s, h, p = xdt.shape
    n = bm.shape[-1]
    nc = s // chunk
    xdt, dA, bm, cm = (t.float() for t in (xdt, dA, bm, cm))
    dAc = dA.reshape(b, nc, chunk, h).permute(0, 3, 1, 2)  # (b, h, nc, l)
    xc = xdt.reshape(b, nc, chunk, h, p)
    bc = bm.reshape(b, nc, chunk, n)
    cc = cm.reshape(b, nc, chunk, n)

    # intra-chunk (attention form)
    decay = torch.exp(segsum(dAc))  # (b, h, nc, l, l)
    scores = torch.einsum("bcln,bcsn->bcls", cc, bc)
    y_diag = torch.einsum("bcls,bhcls,bcshp->bclhp", scores, decay, xc)

    # chunk states
    cum = torch.cumsum(dAc, dim=-1)  # (b, h, nc, l)
    decay_to_end = torch.exp(cum[..., -1:] - cum)
    states = torch.einsum("bcsn,bhcs,bcshp->bchpn", bc, decay_to_end, xc)

    # inter-chunk recurrence over the chunk states
    chunk_decay = torch.exp(cum[..., -1])  # (b, h, nc)
    carry = torch.zeros((b, h, p, n), dtype=torch.float32, device=xdt.device)
    prev = []
    for c in range(nc):
        prev.append(carry)  # the state BEFORE chunk c
        carry = chunk_decay[:, :, c, None, None] * carry + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (b, nc, h, p, n)

    # inter-chunk output
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", cc, prev_states, torch.exp(cum))
    return (y_diag + y_off).reshape(b, s, h, p), carry


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
