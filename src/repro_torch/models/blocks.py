"""Per-layer blocks of every mixer and FFN kind, and their caches.

The counterpart of ``repro.models.blocks``: a block is a pre-norm mixer
(causal attention, sliding-window attention, the Griffin RG-LRU
recurrent block or the Mamba-2 SSD mixer) plus residual, then, unless
the FFN kind is ``none``, a pre-norm FFN (a dense MLP or the routed MoE)
plus residual, with optional gemma3-style post-norms.  Three entry
points per block:

  * ``block_full``    — full sequence, no cache (scoring)
  * ``block_prefill`` — full sequence, returns the decode cache
  * ``block_decode``  — one token, writes the cache in place

Cache layouts (per layer), as the reference's:
  attn:   {"k", "v"}: (B, max_len, Hkv, Dh)       — absolute slots
  local:  {"k", "v"}: (B, min(window, max_len), Hkv, Dh) — ring buffer,
          slot = pos % length
  rglru:  {"conv": (B, W-1, lru), "h": (B, lru) float32}
  ssd:    {"conv": (B, W-1, d_xbc), "state": (B, H, P, N) float32}
With ``kv_quant`` an attention cache holds int8 codes and float32
(B, L, Hkv, 1) scales: {"k", "k_scale", "v", "v_scale"}.

SSD with more than one group raises ``NotImplementedError`` naming the
ROADMAP item that brings it.  ``block_full`` returns the MoE's Switch
auxiliary term (``moe.moe_forward``) beside x, as the reference's does,
for the training loss; prefill and decode drop it.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import rows_over_data
from repro_torch.kernels import is_sharded
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssd as ssd_mod
from repro_torch.models.layers import mlp, mlp_spec, rmsnorm, rmsnorm_spec

__all__ = ["block_spec", "cache_spec", "block_full", "block_prefill", "block_decode",
           "residual"]


def _split_kind(kind: str) -> tuple[str, str]:
    """(mixer, ffn) of a layer kind (``ModelConfig`` validated it)."""
    mixer, _, ffn = kind.partition(":")
    return mixer, ffn


def _kv_names(cfg) -> tuple[str, ...]:
    """The names of an attention cache's tensors, in ``attn_decode``'s order."""
    return ("k", "k_scale", "v", "v_scale") if cfg.kv_quant else ("k", "v")


def block_spec(cfg, kind: str) -> dict:
    mixer, ffn = _split_kind(kind)
    d = cfg.d_model
    spec: dict = {"pre_norm": rmsnorm_spec(d)}
    if mixer in ("attn", "local"):
        spec["attn"] = attn_mod.attn_spec(d, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                                          cfg.qk_norm)
    elif mixer == "rglru":
        spec["rec"] = rglru_mod.rglru_spec(cfg)
    else:
        spec["ssd"] = ssd_mod.ssd_spec(cfg)
    if cfg.post_norms:
        spec["post_norm"] = rmsnorm_spec(d)
    if ffn != "none":
        spec["mlp_norm"] = rmsnorm_spec(d)
        gated = cfg.activation in ("swiglu", "geglu")
        if ffn == "mlp":  # the dense layers of an MoE model take dense_d_ff
            spec["mlp"] = mlp_spec(d, cfg.dense_d_ff, gated)
        else:
            spec["moe"] = moe_mod.moe_spec(d, cfg.num_experts, cfg.moe_d_ff, gated,
                                           cfg.shared_expert)
        if cfg.post_norms:
            spec["mlp_post_norm"] = rmsnorm_spec(d)
    return spec


def cache_spec(cfg, kind: str, batch: int, max_len: int) -> dict:
    """{name: (shape, dtype)} of one layer's cache."""
    mixer, _ = _split_kind(kind)
    kv_dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    if mixer == "ssd":
        conv, state = ssd_mod.ssd_init_cache_shapes(cfg, batch)
        return {"conv": (conv, kv_dtype), "state": (state, torch.float32)}
    if mixer == "rglru":
        conv, h = rglru_mod.rglru_init_cache_shapes(cfg, batch)
        return {"conv": (conv, kv_dtype), "h": (h, torch.float32)}
    length = max_len if mixer == "attn" else min(cfg.window_size, max_len)
    shp = (batch, length, cfg.num_kv_heads, cfg.head_dim)
    if cfg.kv_quant:
        sshp = shp[:-1] + (1,)
        return {"k": (shp, torch.int8), "k_scale": (sshp, torch.float32),
                "v": (shp, torch.int8), "v_scale": (sshp, torch.float32)}
    return {"k": (shp, kv_dtype), "v": (shp, kv_dtype)}


def _theta(cfg, mixer: str) -> float:
    return cfg.rope_theta_local if mixer == "local" else cfg.rope_theta


def _window(cfg, mixer: str) -> int:
    return cfg.window_size if mixer == "local" else 0


def _apply_ffn(params, x, cfg, ffn: str):
    """(x + FFN(x), the MoE's aux term or 0.0)."""
    if ffn == "none":
        return x, 0.0
    h = rmsnorm(params.mlp_norm, x)
    aux = 0.0
    if ffn == "mlp":
        y = mlp(params.mlp, h, cfg.activation)
    else:
        y, aux = moe_mod.moe_forward(params.moe, h, cfg)
    if cfg.post_norms:
        y = rmsnorm(params.mlp_post_norm, y)
    return x + y, aux


def _post(params, y, cfg):
    return rmsnorm(params.post_norm, y) if cfg.post_norms else y


def residual(x):
    """x itself, or a DTensor residual stream (a sharded serving step)
    placed where the reference's ``shard_act(x, "act_btd")`` holds it,
    rows over the data axes and whole on ``model``
    (``distributed.sharding.rows_over_data``): a layer's output sum is
    all-reduced there, not left to DTensor's choice of a layout."""
    return rows_over_data(x) if is_sharded(x) else x


def block_full(params, x, cfg, kind: str):
    """Full-sequence pass (no cache).  Returns (x, aux): the MoE's
    auxiliary term, 0.0 for any other FFN."""
    mixer, ffn = _split_kind(kind)
    h = rmsnorm(params.pre_norm, x)
    if mixer == "ssd":
        y, _ = ssd_mod.ssd_forward(params.ssd, h, cfg)
    elif mixer == "rglru":
        y, _ = rglru_mod.rglru_forward(params.rec, h, cfg)
    else:
        y, _ = attn_mod.attn_forward(params.attn, h, cfg, window=_window(cfg, mixer),
                                     theta=_theta(cfg, mixer))
    return _apply_ffn(params, x + _post(params, y, cfg), cfg, ffn)


def _pad_seq(t, length: int):
    """(B, S, ...) followed by zeros to (B, length, ...), or t itself when S
    is the length.  A concatenation, which DTensors place as t is placed
    (their ``F.pad`` fails to redistribute in some PyTorch releases)."""
    s = t.shape[1]
    if s == length:
        return t
    return torch.cat([t, t.new_zeros((t.shape[0], length - s) + tuple(t.shape[2:]))], dim=1)


def _ring_from_prefill(t, length: int):
    """Full-sequence keys or values (B, S, ...) in a ring buffer of
    ``length`` slots: slot p % length holds position p, for the last
    ``length`` positions (the reference's ``_ring_from_prefill``)."""
    s = t.shape[1]
    if s < length:
        return _pad_seq(t, length)
    shift = (s - length) % length
    last = t[:, s - length:]
    # torch.roll's rotation as one concatenation (a DTensor may have no
    # strategy for roll; it has one for cat).
    return torch.cat([last[:, length - shift:], last[:, :length - shift]], dim=1)


def _prefill_cache(cfg, mixer: str, k, v, max_len: int) -> dict:
    """The decode cache of an attention layer from its prompt's K/V: the
    first S slots of zero (B, max_len, ...) tensors, or a ring buffer of
    min(window, max_len) slots; int8 codes and scales with ``kv_quant``."""
    kv_dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    if cfg.kv_quant:
        stored = dict(zip(_kv_names(cfg), attn_mod.kv_quantize(k) + attn_mod.kv_quantize(v)))
    else:
        stored = {"k": k.to(kv_dtype), "v": v.to(kv_dtype)}
    if mixer == "local":
        length = min(cfg.window_size, max_len)
        return {name: _ring_from_prefill(t, length) for name, t in stored.items()}
    return {name: _pad_seq(t, max_len) for name, t in stored.items()}


def block_prefill(params, x, cfg, kind: str, max_len: int):
    """Full-sequence pass that also builds the decode cache: for attention
    the prompt's K/V (``_prefill_cache``), for SSD and RG-LRU the conv
    window and the final state.  Returns (x, cache)."""
    mixer, ffn = _split_kind(kind)
    h = rmsnorm(params.pre_norm, x)
    if mixer == "ssd":
        y, (conv, state) = ssd_mod.ssd_forward(params.ssd, h, cfg)
        cache = {"conv": conv, "state": state}
    elif mixer == "rglru":
        y, (conv, h_last) = rglru_mod.rglru_forward(params.rec, h, cfg)
        cache = {"conv": conv, "h": h_last}
    else:
        y, (k, v) = attn_mod.attn_forward(params.attn, h, cfg, window=_window(cfg, mixer),
                                          theta=_theta(cfg, mixer))
        cache = _prefill_cache(cfg, mixer, k, v, max_len)
    return _apply_ffn(params, residual(x + _post(params, y, cfg)), cfg, ffn)[0], cache


def block_decode(params, x, cache, pos, cfg, kind: str, lengths=None, slot=None):
    """One-token step.  x: (B, 1, D); ``pos`` the new token's position, a
    0-dim int32 tensor; for attention ``slot`` the cache slot it is
    written to (``pos % L`` in a ring buffer of L slots, ``pos`` unless
    given) and ``lengths`` (B,) int32, K4's valid slots (``min(pos + 1,
    L)`` in a ring, ``pos + 1``), both built on the device once per step
    by the caller.  A ring holds exactly the window, so K4 takes no
    window of its own (the reference's ``window=0``).  Writes the layer's
    cache in place; returns (x, cache)."""
    mixer, ffn = _split_kind(kind)
    h = rmsnorm(params.pre_norm, x)
    if mixer == "ssd":
        y, (conv, state) = ssd_mod.ssd_decode_step(params.ssd, h,
                                                   (cache["conv"], cache["state"]), cfg)
        cache = {"conv": conv, "state": state}
    elif mixer == "rglru":
        y, (conv, h_state) = rglru_mod.rglru_decode_step(params.rec, h,
                                                         (cache["conv"], cache["h"]), cfg)
        cache = {"conv": conv, "h": h_state}
    else:
        names = _kv_names(cfg)
        y, _ = attn_mod.attn_decode(params.attn, h, tuple(cache[n] for n in names), pos, cfg,
                                    theta=_theta(cfg, mixer), lengths=lengths, slot=slot)
    return _apply_ffn(params, residual(x + _post(params, y, cfg)), cfg, ffn)[0], cache
