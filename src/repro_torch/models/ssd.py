"""Mamba-2 SSD (state-space duality) mixer: chunked prefill and O(1) decode.

The counterpart of ``repro.models.ssd``.  Layout as the reference's:
x (B, S, H, P) heads by head dim; B and C (B, S, G, N) state projections
shared by the H / G heads of a group (head h reads group h // (H / G));
A one scalar per head.  The chunked scan of a prefill runs through K5
(``kernels.ssd``), which takes every group count the reference's
``ssd_scan`` takes (``ssd_pallas`` itself takes one).  The 4-tap causal
convolution and the one-token decode step are plain PyTorch, as the
reference computes them in jnp outside any Pallas kernel.  Decode
writes the conv window and the state into the layer's cache tensors in
place, where the reference returns new arrays.

In a bf16 model the reference rounds the scores, the decay matrix and
the carried chunk states to bf16 inside ``ssd_scan``; K5 and its plain
version keep them float32 (ROADMAP, fault P3).

Training differentiates ``ssd_scan`` through the ``torch.autograd.Function``
that ``kernels.ssd.ops.ssd_from_a`` applies over the chunk scan (xdt, dA,
bm, cm): K5 forward, saving the cumsum and the entering states, then K5b
backward on the card; the plain stages forward and backward on the CPU.
Serving takes the same route and builds no graph.  The reference has no hand-written
backward (``jax.grad`` differentiates its jnp scan); the chain to x, dt
and A stays plain torch, and the final state is not differentiated.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models.spec import P

__all__ = ["ssd_spec", "ssd_forward", "ssd_decode_step", "ssd_init_cache_shapes", "ssd_scan"]


def ssd_spec(cfg) -> dict:
    d, din = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssd_ngroups, cfg.ssd_state, cfg.ssd_heads
    d_xbc = din + 2 * g * n
    return {
        "in_proj": P((d, 2 * din + 2 * g * n + h), ("embed", "ssd_inner")),
        "conv_w": P((cfg.conv_width, d_xbc), ("conv", "ssd_inner"), init="small"),
        "conv_b": P((d_xbc,), ("ssd_inner",), init="zeros"),
        "A_log": P((h,), ("ssd_heads",), init="zeros"),  # A = -exp(A_log) => -1 at init
        "D": P((h,), ("ssd_heads",), init="ones"),
        "dt_bias": P((h,), ("ssd_heads",), init="zeros"),
        "norm_scale": P((din,), ("ssd_inner",), init="zeros"),
        "out_proj": P((din, d), ("ssd_inner", "embed")),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal 1-D conv.  x: (B, S, C); w: (W, C).

    ``state`` (B, W-1, C) provides left context (decode); zeros otherwise.
    Taps are summed in float32, in order: the first tap's product, then
    each next tap added with one fused multiply-add, then the bias.
    Returns (y, new_state)."""
    bsz, s, c = x.shape
    wlen = w.shape[0]
    if state is None:
        state = x.new_zeros((bsz, wlen - 1, c))
    xp = torch.cat([state.to(x.dtype), x], dim=1)  # (B, W-1+S, C)
    xf, wf = xp.float(), w.float()
    y = xf[:, 0:s] * wf[0]
    for i in range(1, wlen):  # W is tiny (4): unrolled taps
        y.addcmul_(xf[:, i:i + s], wf[i])
    y.add_(b)
    new_state = xp[:, s:, :] if s >= wlen - 1 else xp[:, -(wlen - 1):, :]
    return y.to(x.dtype), new_state


def _gated_rmsnorm(scale, x, z, eps: float = 1e-6):
    """Mamba-2 norm: RMSNorm(x * silu(z)) with (1 + scale).  silu is taken
    in float32 and rounded to x's type, as the reference's
    ``silu(z.astype(f32)).astype(x.dtype)``: PyTorch's silu computes a
    bfloat16 input in float32 and rounds once."""
    x = x * F.silu(z)
    xf = x.float()
    out = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return torch.addcmul(out, out, scale).to(x.dtype)  # out * (1 + scale), in float32


def _softplus(x):
    """jax.nn.softplus, logaddexp(x, 0), as one kernel: log1p(exp(x)), and
    x itself above 20, where the two agree in float32."""
    return F.softplus(x)


def _split_zxbcdt(cfg, zxbcdt):
    din, g, n = cfg.d_inner, cfg.ssd_ngroups, cfg.ssd_state
    z = zxbcdt[..., :din]
    xbc = zxbcdt[..., din:2 * din + 2 * g * n]
    dt = zxbcdt[..., 2 * din + 2 * g * n:]
    return z, xbc, dt


def ssd_scan(x, dt, a_per_head, B, C, chunk: int):
    """Core chunked SSD through K5.  x: (b, s, h, p); dt: (b, s, h) after
    softplus; a_per_head: (h,) negative; B, C: (b, s, g, n), g dividing h.
    Returns (y in x's type, final_state (b, h, p, n) float32).

    A length that is no multiple of the chunk is padded with dt = 0 steps
    (decay exp(0) = 1, zero input), as the reference pads: the state
    after the padding is the state after the last real step."""
    s = x.shape[1]
    bm, cm = B, C
    pad = -s % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, 0, 0, pad))
    y, final_state = ssd_ops.ssd_from_a(x, dt, a_per_head, bm, cm, chunk)
    return y[:, :s].to(x.dtype), final_state


def ssd_forward(params, x, cfg):
    """Full-sequence SSD mixer.  x: (B, S, D).

    Returns (y, (conv_state, ssm_state)): the cache that continues
    decoding after a prefill."""
    b, s, _ = x.shape
    h, p = cfg.ssd_heads, cfg.ssd_headdim
    g, n = cfg.ssd_ngroups, cfg.ssd_state
    din = cfg.d_inner

    zxbcdt = x @ params.in_proj
    z, xbc, dt = _split_zxbcdt(cfg, zxbcdt)
    xbc, conv_state = _causal_conv(xbc, params.conv_w, params.conv_b)
    conv_state = conv_state.clone()  # the cache owns it; decode writes it in place
    xbc = F.silu(xbc)  # float32 inside, rounded once to x's type, as the reference
    xin = xbc[..., :din].reshape(b, s, h, p)
    bmat = xbc[..., din:din + g * n].reshape(b, s, g, n)
    cmat = xbc[..., din + g * n:].reshape(b, s, g, n)
    dt = _softplus(dt.float() + params.dt_bias)
    a = -torch.exp(params.A_log.float())

    y, ssm_state = ssd_scan(xin, dt, a, bmat, cmat, cfg.ssd_chunk)
    y = y + params.D.to(x.dtype)[None, None, :, None] * xin
    y = _gated_rmsnorm(params.norm_scale, y.reshape(b, s, din), z)
    return y @ params.out_proj, (conv_state, ssm_state)


def ssd_decode_step(params, x, cache, cfg):
    """One-token SSD step.  x: (B, 1, D); cache = (conv_state, ssm_state),
    written in place and returned.

    The reference's step, in few kernels: casts ride inside the
    arithmetic (a float32 tensor times a bfloat16 one is computed in
    float32), and the state is decayed and updated in place,
    S <- decay * S + (dt x) (outer) B, then read as y = S . C by one
    batched product; each head reads its group's B and C, the state viewed
    as (B, G, H / G, P, N) (with one group, the shapes of a state without
    groups)."""
    conv_state, ssm_state = cache
    b = x.shape[0]
    h, p = cfg.ssd_heads, cfg.ssd_headdim
    g, n = cfg.ssd_ngroups, cfg.ssd_state
    din = cfg.d_inner

    zxbcdt = x @ params.in_proj  # (B, 1, ...)
    z, xbc, dt = _split_zxbcdt(cfg, zxbcdt)
    xbc, new_conv = _causal_conv(xbc, params.conv_w, params.conv_b, conv_state)
    conv_state.copy_(new_conv)
    xbc = F.silu(xbc)[:, 0]  # (B, d_xbc)
    xin = xbc[:, :din].reshape(b, h, p)
    bv = xbc[:, din:din + g * n].reshape(b, g, 1, 1, n)
    cv = xbc[:, din + g * n:].reshape(b * g, n, 1)
    dt1 = _softplus(dt[:, 0].float() + params.dt_bias)  # (B, h)
    decay = torch.exp(dt1 * -torch.exp(params.A_log.float()))  # (B, h)

    ssm_state.mul_(decay[:, :, None, None])
    ssm_state.view(b, g, h // g, p, n).addcmul_(
        (xin * dt1[:, :, None]).view(b, g, h // g, p, 1), bv)
    y = torch.bmm(ssm_state.view(b * g, h // g * p, n), cv.float()).view(b, h, p)
    y = torch.addcmul(y, params.D[:, None], xin)  # y + D * x in float32
    y = _gated_rmsnorm(params.norm_scale, y.reshape(b, 1, din).to(x.dtype), z)
    return y @ params.out_proj, (conv_state, ssm_state)


def ssd_init_cache_shapes(cfg, batch: int):
    """(conv_state, ssm_state) shapes for cache allocation."""
    d_xbc = cfg.d_inner + 2 * cfg.ssd_ngroups * cfg.ssd_state
    return (
        (batch, cfg.conv_width - 1, d_xbc),
        (batch, cfg.ssd_heads, cfg.ssd_headdim, cfg.ssd_state),
    )
