"""Decode caches: preallocated tensors, one dict per layer.

The counterpart of ``repro.models.kvcache``.  The reference's cache
mirrors its stacked parameter tree (one stacked array per pattern
position plus a tail); the port keeps a list with one dict per layer, in
layer order, and the position as the reference keeps it: a 0-dim int32
tensor on the caches' device, which a decode step reads and advances
there, so the step holds no host value and can be captured in a CUDA
graph.  An attention layer's dict is ``{"k", "v"}`` of (B, max_len,
Hkv, Dh) tensors (a sliding-window layer's: a ring buffer of
min(window, max_len) slots; with ``kv_quant``, int8 codes with
``"k_scale"`` and ``"v_scale"``), an SSD layer's
``{"conv": (B, W-1, d_xbc), "state": (B, H, P, N) float32}``, an RG-LRU
layer's ``{"conv": (B, W-1, lru), "h": (B, lru) float32}``
(``blocks.cache_spec``).  Decode writes each new token's K/V, and each
SSD or RG-LRU layer's conv window and state, into these tensors IN PLACE
(``models.attention.attn_decode``, ``models.ssd.ssd_decode_step``,
``models.rglru.rglru_decode_step``), where the reference builds new
arrays.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.blocks import cache_spec

__all__ = ["init_cache", "abstract_cache", "cache_bytes", "model_dtype", "position"]


def model_dtype(cfg) -> torch.dtype:
    """The activation, weight and cache type of a config."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def init_cache(cfg, batch: int, max_len: int, start_pos: int = 0, device=None) -> dict:
    """Zero caches for every layer on ``device`` (the card unless ``"cpu"``),
    ``{"layers": [{"k": ..., "v": ...} or {"conv": ..., "state": ...}, ...],
    "pos": 0-dim int32 tensor holding start_pos}``."""
    dev = resolve_device(device)
    layers = []
    for i in range(cfg.num_layers):
        tpl = cache_spec(cfg, cfg.layer_kind(i), batch, max_len)
        layers.append({name: torch.zeros(shape, dtype=dtype, device=dev)
                       for name, (shape, dtype) in tpl.items()})
    return {"layers": layers, "pos": position(start_pos, dev)}


def abstract_cache(cfg, batch: int, max_len: int) -> dict:
    """``init_cache``'s tree as ``meta`` tensors (shapes and dtypes)."""
    layers = []
    for i in range(cfg.num_layers):
        tpl = cache_spec(cfg, cfg.layer_kind(i), batch, max_len)
        layers.append({name: torch.empty(shape, dtype=dtype, device="meta")
                       for name, (shape, dtype) in tpl.items()})
    return {"layers": layers, "pos": torch.empty((), dtype=torch.int32, device="meta")}


def position(pos: int, device) -> torch.Tensor:
    """A cache position: a 0-dim int32 tensor on ``device``, filled there
    (no host-to-device copy)."""
    return torch.full((), int(pos), dtype=torch.int32, device=device)


def cache_bytes(cfg, batch: int, max_len: int) -> int:
    """Bytes of the caches, plus the reference's 4-byte int32 position."""
    total = 4
    for i in range(cfg.num_layers):
        for shape, dtype in cache_spec(cfg, cfg.layer_kind(i), batch, max_len).values():
            n = 1
            for s in shape:
                n *= s
            total += n * dtype.itemsize
    return total
