"""Per-layer blocks of the ``attn:mlp`` and ``ssd:none`` kinds, and their caches.

The counterpart of ``repro.models.blocks``: a block is a pre-norm mixer
(causal attention, or the Mamba-2 SSD mixer) plus residual, then, unless
the FFN kind is ``none``, a pre-norm FFN plus residual, with optional
gemma3-style post-norms.  Three entry points per block:

  * ``block_full``    — full sequence, no cache (scoring)
  * ``block_prefill`` — full sequence, returns the decode cache
  * ``block_decode``  — one token, writes the cache in place

Cache layouts (per layer), as the reference's:
  attn:   {"k", "v"}: (B, max_len, Hkv, Dh)       — absolute slots
  ssd:    {"conv": (B, W-1, d_xbc), "state": (B, H, P, N) float32}

The other layer kinds of the reference raise ``NotImplementedError``
naming the ROADMAP item that brings them ("Modules to port").  The MoE
auxiliary loss of the reference's block functions belongs to ``moe``, so
the port's blocks return no aux term.
"""
from __future__ import annotations

import torch

from repro_torch.core.scheduler import not_ported
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssd as ssd_mod
from repro_torch.models.layers import mlp, mlp_spec, rmsnorm, rmsnorm_spec

__all__ = ["block_spec", "cache_spec", "block_full", "block_prefill", "block_decode",
           "NOT_PORTED"]

# Layer kinds and options of the reference this port does not run yet,
# with the ROADMAP item ("Open items" -> "Modules to port") that brings each.
NOT_PORTED: dict[str, str] = {
    "local": "item 8 (sliding-window layers and their ring-buffer caches)",
    "rglru": "item 9 (recurrent and sparse mixers)",
    "moe": "item 9 (recurrent and sparse mixers)",
    "kv_quant": "item 8 (the int8 KV cache)",
}


def _check_kind(cfg, kind: str) -> tuple[str, str]:
    """(mixer, ffn) of a layer kind the port runs; raises for the others."""
    mixer, _, ffn = kind.partition(":")
    if mixer not in ("attn", "ssd"):
        not_ported(mixer, NOT_PORTED)
    if ffn not in ("mlp", "none"):
        not_ported(ffn, NOT_PORTED)
    if mixer == "attn" and cfg.kv_quant:
        not_ported("kv_quant", NOT_PORTED)
    if mixer == "ssd":
        ssd_mod.check_groups(cfg.ssd_ngroups)
    return mixer, ffn


def block_spec(cfg, kind: str) -> dict:
    mixer, ffn = _check_kind(cfg, kind)
    d = cfg.d_model
    spec: dict = {"pre_norm": rmsnorm_spec(d)}
    if mixer == "attn":
        spec["attn"] = attn_mod.attn_spec(d, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                                          cfg.qk_norm)
    else:
        spec["ssd"] = ssd_mod.ssd_spec(cfg)
    if cfg.post_norms:
        spec["post_norm"] = rmsnorm_spec(d)
    if ffn == "mlp":
        spec["mlp_norm"] = rmsnorm_spec(d)
        spec["mlp"] = mlp_spec(d, cfg.dense_d_ff, cfg.activation in ("swiglu", "geglu"))
        if cfg.post_norms:
            spec["mlp_post_norm"] = rmsnorm_spec(d)
    return spec


def cache_spec(cfg, kind: str, batch: int, max_len: int) -> dict:
    """{name: (shape, dtype)} of one layer's cache."""
    mixer, _ = _check_kind(cfg, kind)
    kv_dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    if mixer == "ssd":
        conv, state = ssd_mod.ssd_init_cache_shapes(cfg, batch)
        return {"conv": (conv, kv_dtype), "state": (state, torch.float32)}
    shp = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": (shp, kv_dtype), "v": (shp, kv_dtype)}


def _apply_ffn(params, x, cfg, ffn: str):
    if ffn == "none":
        return x
    h = rmsnorm(params.mlp_norm, x)
    y = mlp(params.mlp, h, cfg.activation)
    if cfg.post_norms:
        y = rmsnorm(params.mlp_post_norm, y)
    return x + y


def _post(params, y, cfg):
    return rmsnorm(params.post_norm, y) if cfg.post_norms else y


def block_full(params, x, cfg, kind: str):
    """Scoring pass (no cache).  Returns x."""
    mixer, ffn = _check_kind(cfg, kind)
    h = rmsnorm(params.pre_norm, x)
    if mixer == "attn":
        y, _ = attn_mod.attn_forward(params.attn, h, cfg, theta=cfg.rope_theta)
    else:
        y, _ = ssd_mod.ssd_forward(params.ssd, h, cfg)
    return _apply_ffn(params, x + _post(params, y, cfg), cfg, ffn)


def block_prefill(params, x, cfg, kind: str, max_len: int):
    """Full-sequence pass that also builds the decode cache: for attention
    the prompt's K/V in the first S slots of zero (B, max_len, Hkv, Dh)
    tensors, for SSD the conv window and the final state.
    Returns (x, cache)."""
    mixer, ffn = _check_kind(cfg, kind)
    h = rmsnorm(params.pre_norm, x)
    if mixer == "attn":
        y, (k, v) = attn_mod.attn_forward(params.attn, h, cfg, theta=cfg.rope_theta)
        cache = {}
        for name, t in (("k", k), ("v", v)):
            buf = torch.zeros((t.shape[0], max_len) + tuple(t.shape[2:]), dtype=t.dtype,
                              device=t.device)
            buf[:, :t.shape[1]] = t
            cache[name] = buf
    else:
        y, (conv, state) = ssd_mod.ssd_forward(params.ssd, h, cfg)
        cache = {"conv": conv, "state": state}
    return _apply_ffn(params, x + _post(params, y, cfg), cfg, ffn), cache


def block_decode(params, x, cache, pos, cfg, kind: str, lengths=None):
    """One-token step.  x: (B, 1, D); ``pos`` the new token's position, a
    0-dim int32 tensor; ``lengths`` (B,) int32, K4's valid lengths
    (``pos + 1``), built once per step by the caller.  Writes the layer's
    cache in place; returns (x, cache)."""
    mixer, ffn = _check_kind(cfg, kind)
    h = rmsnorm(params.pre_norm, x)
    if mixer == "attn":
        y, (k, v) = attn_mod.attn_decode(params.attn, h, (cache["k"], cache["v"]), pos, cfg,
                                         theta=cfg.rope_theta, lengths=lengths)
        cache = {"k": k, "v": v}
    else:
        y, (conv, state) = ssd_mod.ssd_decode_step(params.ssd, h,
                                                   (cache["conv"], cache["state"]), cfg)
        cache = {"conv": conv, "state": state}
    return _apply_ffn(params, x + _post(params, y, cfg), cfg, ffn), cache
