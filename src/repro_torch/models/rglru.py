"""Griffin recurrent block: conv1d + RG-LRU gated linear recurrence.

The counterpart of ``repro.models.rglru`` ([arXiv:2402.19427] §2.4):

  branch 1: linear(D -> lru) -> causal conv1d(4) -> RG-LRU
  branch 2: linear(D -> lru) -> GeLU
  output:   (branch1 * branch2) -> linear(lru -> D)

RG-LRU:
  r_t = sigmoid(a_gate(x_t));   i_t = sigmoid(x_gate(x_t))
  log a_t = -c * softplus(Lambda) * r_t          (c = 8)
  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Gates are per-channel diagonal (weight + bias per channel), as the
reference's.  The reference runs the recurrence as a
``jax.lax.associative_scan``; PyTorch has none, so the gates, the
recurrence and the product with the GeLU branch are one kernel,
``kernels.rglru_scan`` (a chunked two-pass scan in float32: chunk
summaries, then every chunk from its carry; its plain version on the
CPU), the same kernel at S = 1 for decode.  The two differ only in the
order their float32 products are added.  Training differentiates the
scan through ``rglru_scan_autograd``, an autograd function whose forward
also keeps the h entering each chunk and whose backward is the kernel
``rglru_scan_bwd`` (its plain reverse loop on the CPU): the gradient
that ``jax.grad`` takes through the reference's gates and scan.
``_scan`` takes it only while autograd records and an input requires a
gradient; serving calls the scan alone.  The projections and the 4-tap
causal conv stay plain PyTorch, as the reference computes them in jnp.
Decode writes the conv window and the state into the layer's cache
tensors in place, where the reference returns new arrays.
"""
from __future__ import annotations

from repro_torch.kernels import records_grad
from repro_torch.kernels.rglru_scan import ops as rglru_ops
from repro_torch.models.spec import P
# The reference's ``rglru._conv1d`` computes what its ``ssd._causal_conv``
# computes (float32 taps in order, then the bias, rounded to x's type).
from repro_torch.models.ssd import _causal_conv as _conv1d

__all__ = ["rglru_spec", "rglru_forward", "rglru_decode_step", "rglru_init_cache_shapes"]


def rglru_spec(cfg) -> dict:
    d, lru = cfg.d_model, cfg.lru_width
    return {
        "w_rec": P((d, lru), ("embed", "lru")),
        "w_gate_branch": P((d, lru), ("embed", "lru")),
        "conv_w": P((cfg.conv_width, lru), ("conv", "lru"), init="small"),
        "conv_b": P((lru,), ("lru",), init="zeros"),
        "a_gate_w": P((lru,), ("lru",), init="small"),
        "a_gate_b": P((lru,), ("lru",), init="zeros"),
        "x_gate_w": P((lru,), ("lru",), init="small"),
        "x_gate_b": P((lru,), ("lru",), init="zeros"),
        "Lambda": P((lru,), ("lru",), init="ones"),  # softplus(1) ~ 1.31
        "w_out": P((lru, d), ("lru", "embed")),
    }


def _scan(params, u, gpre, h0=None):
    """The reference's ``_gates``, its scan and ``(h * gate)`` in one call:
    (y in u's type, h_last float32); through the autograd function while
    autograd records and an input requires a gradient."""
    args = (u, gpre, params.a_gate_w, params.a_gate_b, params.x_gate_w, params.x_gate_b,
            params.Lambda, h0)
    if records_grad(*args):
        return rglru_ops.rglru_scan_autograd(*args)
    return rglru_ops.rglru_scan(*args)


def rglru_forward(params, x, cfg, conv_state=None, h0=None):
    """Full-sequence Griffin recurrent block.  x: (B, S, D); ``h0`` (B, lru)
    float32 continues a state (the reference folds it in as a virtual
    first step; the kernel starts its recurrence from it).

    Returns (y, (conv_state, h_last))."""
    u = x @ params.w_rec
    gpre = x @ params.w_gate_branch
    u, conv_state = _conv1d(u, params.conv_w, params.conv_b, conv_state)
    y, h_last = _scan(params, u, gpre, h0)
    return y @ params.w_out, (conv_state.clone(), h_last)


def rglru_decode_step(params, x, cache, cfg):
    """One token.  x: (B, 1, D); cache = (conv_state, h), written in place
    and returned."""
    conv_state, h = cache
    u = x @ params.w_rec
    gpre = x @ params.w_gate_branch
    u, new_conv = _conv1d(u, params.conv_w, params.conv_b, conv_state)
    conv_state.copy_(new_conv)
    y, h_new = _scan(params, u, gpre, h)
    h.copy_(h_new)
    return y @ params.w_out, (conv_state, h)


def rglru_init_cache_shapes(cfg, batch: int):
    """(conv_state, h) shapes for cache allocation."""
    return ((batch, cfg.conv_width - 1, cfg.lru_width), (batch, cfg.lru_width))
