"""Common transformer layers: norms, RoPE, MLPs, embeddings.

Functions over parameter modules (any object whose attributes are the
reference's leaf names: ``params.scale``, ``params.w_gate``, ...), each
the counterpart of its namesake in ``repro.models.layers``.  The specs
are the reference's, so ``LM.init`` follows its shapes and laws.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import is_sharded
from repro_torch.models.spec import P

__all__ = [
    "rmsnorm_spec", "rmsnorm",
    "rope",
    "mlp_spec", "mlp",
    "embed_spec", "embed_tokens", "logits_from_embed",
    "softcap",
]

# ---------------------------------------------------------------- norms


def rmsnorm_spec(dim: int) -> dict:
    return {"scale": P((dim,), (None,), init="zeros")}  # gemma-style (1+scale)


def rmsnorm(params, x, eps: float = 1e-6):
    """RMSNorm with (1 + scale) parameterisation, computed in float32: the
    scale is applied as out + out * scale, one kernel that casts it inside
    (out of place, so that autograd can differentiate it)."""
    xf = x.float()
    out = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return torch.addcmul(out, out, params.scale).to(x.dtype)


# ---------------------------------------------------------------- rope


@functools.lru_cache(maxsize=16)
def _rope_freqs(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """The (head_dim/2,) frequencies, cached per device and shared by every
    thread: on the card the table is complete before it is returned, so a
    lane on another stream never reads it half written."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    freqs = 1.0 / (theta ** exponent)
    if device.type == "cuda" and not torch.cuda.is_current_stream_capturing():
        torch.cuda.current_stream(device).synchronize()
    return freqs


def _tracing() -> bool:
    """Whether a ``FakeTensorMode`` is active (a dry run's trace), whose
    tensors must not enter a cache that real calls read afterwards."""
    return torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None


def rope(x, positions, theta: float = 10_000.0):
    """Rotary embedding on split halves (not interleaved), angles in
    float32.  x: (..., S, H, Dh); positions: (..., S)."""
    freqs = (_rope_freqs.__wrapped__ if _tracing() else _rope_freqs)(
        x.shape[-1], float(theta), x.device)
    angles = positions[..., None].float() * freqs  # (..., S, Dh/2)
    angles = angles[..., None, :]  # broadcast over heads: (..., S, 1, Dh/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- mlp


def mlp_spec(d_model: int, d_ff: int, gated: bool) -> dict:
    if gated:
        return {
            "w_gate": P((d_model, d_ff), ("embed", "ffn")),
            "w_up": P((d_model, d_ff), ("embed", "ffn")),
            "w_down": P((d_ff, d_model), ("ffn", "embed")),
        }
    return {
        "w_up": P((d_model, d_ff), ("embed", "ffn")),
        "w_down": P((d_ff, d_model), ("ffn", "embed")),
    }


def _act(name: str, x):
    if name in ("swiglu", "silu"):
        return F.silu(x)
    if name in ("geglu", "gelu"):
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


def _summed(t):
    """t itself, or a DTensor product whose pending sums (``Partial``, a
    weight split on its input dim over ``model``: the ``ep_tp`` rules' dense
    layers) are all-reduced before a nonlinearity reads it."""
    if not is_sharded(t) or not any(p.is_partial() for p in t.placements):
        return t
    from torch.distributed.tensor import Replicate

    return t.redistribute(t.device_mesh, tuple(Replicate() if p.is_partial() else p
                                               for p in t.placements))


def mlp(params, x, activation: str = "swiglu"):
    """(Gated) MLP: SwiGLU, GeGLU (tanh GELU) or plain GELU.  x: (..., d_model)."""
    if hasattr(params, "w_gate"):
        h = _act(activation, _summed(x @ params.w_gate)) * _summed(x @ params.w_up)
    else:
        h = _act(activation, _summed(x @ params.w_up))
    return h @ params.w_down


# ---------------------------------------------------------------- embeddings


def embed_spec(vocab: int, d_model: int) -> dict:
    return {"embedding": P((vocab, d_model), ("vocab", "embed"), init="small")}


def embed_tokens(params, tokens, scale_by_dim: bool = False):
    """Row lookup of the (V, D) table; ``scale_by_dim`` multiplies by
    sqrt(D) (float32 square root, rounded to the table's type)."""
    table = params.embedding
    x = table[tokens]
    if scale_by_dim:  # a 0-dim host scalar: no copy to the card, so a graph can hold it
        x = x * torch.sqrt(torch.tensor(float(table.shape[-1]))).to(x.dtype)
    return x


def logits_from_embed(table, x, softcap_value: float = 0.0):
    """Readout against a (V, D) table (the embedding, or an untied
    ``lm_head``): (..., D) @ (V, D)^T -> (..., V)."""
    logits = x @ table.T
    if softcap_value and softcap_value > 0:
        logits = softcap(logits, softcap_value)
    return logits


def softcap(x, cap: float):
    return torch.tanh(x / cap) * cap
