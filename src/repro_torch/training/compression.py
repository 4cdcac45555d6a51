"""Gradient compression: int8 quantization with error feedback, the
counterpart of ``repro.training.compression``.

    e    <- residual carried from the previous step
    q    <- quant8(g + e)            (per-row absmax scales)
    e'   <- (g + e) - dequant(q)     (local quantization error, kept)
    g_out = dequant(q)

``compressed_psum_tree`` is the local round (``axis_name=None``, one
participant): the reference's unit of the error-feedback contraction.
Its all-reduce across a named axis belongs with the port's distribution,
ROADMAP item 13, and raises until then.
"""
from __future__ import annotations

import torch

from repro_torch.training.checkpoint import DISTRIBUTION_ITEM
from repro_torch.training.optimizer import tree_map, tree_map_n

__all__ = ["quantize8", "dequantize8", "compressed_psum_tree", "init_error_feedback"]


def quantize8(x):
    """Per-row (last-dim) absmax int8 quantization: (q int8, scale float32
    (..., 1)), rounding half to even as the reference does."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = absmax.clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize8(q, scale):
    return q.float() * scale


def init_error_feedback(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


def compressed_psum_tree(grads, error_feedback, axis_name: str | None = None):
    """Returns (grads after one quantize/dequantize round, new error
    feedback).  A named axis (the cross-device all-reduce) raises."""
    if axis_name is not None:
        raise NotImplementedError(
            f"compressed_psum_tree over axis {axis_name!r} is not ported to repro_torch yet: "
            f"see ROADMAP.md, 'Modules to port', {DISTRIBUTION_ITEM}")

    def one(g, e):
        gf = g.float() + e
        deq = dequantize8(*quantize8(gf))
        return deq, gf - deq

    return tree_map_n(one, 2, grads, error_feedback)
