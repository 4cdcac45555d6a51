"""Gradient compression: int8 quantization with error feedback, the
counterpart of ``repro.training.compression``.

    e    <- residual carried from the previous step
    q    <- quant8(g + e)            (per-row absmax scales)
    e'   <- (g + e) - dequant(q)     (local quantization error, kept)
    g_out = psum(dequant(q)) / n     (exchange int8 payload + fp32 scales)

``compressed_psum_tree`` with ``axis_name`` all-reduces each dequantized
payload over the process group of that dim of the ``DeviceMesh`` given as
``mesh=`` and divides by the group's size, as the reference's two
``psum``s under ``shard_map`` do; without, it is the local round (one
participant), the reference's unit of the error-feedback contraction.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.trees import tree_map, tree_map_n

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


def compressed_psum_tree(grads, error_feedback, axis_name: str | None = None, *, mesh=None):
    """Returns (mean grads, new error feedback).  With ``axis_name``, the
    int8 payloads times their scales are summed over the ranks of that
    mesh dim and divided by their number; without, a local round."""
    group, n = None, 1
    if axis_name is not None:
        if mesh is None:
            raise ValueError(f"axis {axis_name!r} needs the DeviceMesh it names (mesh=)")
        group = mesh.get_group(axis_name)
        n = dist.get_world_size(group)

    def one(g, e):
        gf = g.float() + e
        deq = dequantize8(*quantize8(gf))
        new_e = gf - deq
        if group is None:
            return deq, new_e
        total = deq.clone()
        dist.all_reduce(total, group=group)
        return total / n, new_e

    return tree_map_n(one, 2, grads, error_feedback)
