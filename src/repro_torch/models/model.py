"""The model API the serving backends use: ``LM``.

The counterpart of ``repro.models.model.LM``: a thin, stateless wrapper
that owns only the config; the weights (a ``TransformerParams`` module)
and the caches flow through the arguments.  ``init`` places the weights
on the card unless ``device="cpu"`` is named, and raises on a host
without CUDA.  The weights come frozen; a trainer unfreezes them before
``loss``.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import kvcache, transformer
from repro_torch.models.spec import abstract_params, count_params, init_params, logical_axes

__all__ = ["LM"]


class LM:
    def __init__(self, cfg):
        self.cfg = cfg
        self.spec = transformer.model_spec(cfg)

    # ----------------------------------------------------------- params

    def init(self, seed: int = 0, device=None, *, shardings=None) -> transformer.TransformerParams:
        """Random weights by the reference's laws (``models.spec``), drawn
        on ``device`` from per-path ``torch.Generator``s; with ``shardings``
        (``launch.shardings``' tree of ``NamedSharding``), this rank's shards
        of them as DTensors, no leaf kept whole."""
        dev = resolve_device(device)
        tree = init_params(self.spec, seed, kvcache.model_dtype(self.cfg), dev, shardings)
        return transformer.TransformerParams(self.cfg, tree)

    def abstract_params(self):
        """The weights' tree in the reference's stacked layout, as tensors on
        the ``meta`` device (shapes and dtypes, no storage)."""
        return abstract_params(self.spec, kvcache.model_dtype(self.cfg))

    def param_axes(self):
        """The logical axes of every weight, in the same tree."""
        return logical_axes(self.spec)

    def num_params(self) -> int:
        return count_params(self.spec)

    # ----------------------------------------------------------- compute

    def forward(self, params, tokens):
        """Logits (B, S, V) of a (B, S) token batch."""
        return transformer.forward(params, tokens, self.cfg)

    def loss(self, params, batch):
        """(total loss, metrics) of a {"tokens": (B, S + 1)} batch
        (``transformer.loss_fn``); differentiable once the weights require
        gradients."""
        return transformer.loss_fn(params, batch, self.cfg)

    def prefill(self, params, tokens, max_len: int | None = None):
        """(last-position logits (B, V), cache with room for ``max_len``)."""
        max_len = max_len or tokens.shape[1]
        return transformer.prefill(params, tokens, self.cfg, max_len)

    def decode_step(self, params, cache, tokens):
        """(logits (B, V), cache) after one (B, 1) token step; the cache is
        written in place."""
        return transformer.decode_step(params, cache, tokens, self.cfg)

    def decode_into(self, params, cache, tok, logits):
        """One greedy step on static buffers (``transformer.decode_into``):
        the cache, the (B, 1) int32 token buffer and the (B, V) logits
        buffer are all written in place."""
        transformer.decode_into(params, cache, tok, logits, self.cfg)

    def init_cache(self, batch: int, max_len: int, start_pos: int = 0, device=None):
        return kvcache.init_cache(self.cfg, batch, max_len, start_pos, device=device)

    def abstract_cache(self, batch: int, max_len: int):
        """``init_cache``'s tree as ``meta`` tensors."""
        return kvcache.abstract_cache(self.cfg, batch, max_len)

    # ----------------------------------------------------------- sampling

    def generate(self, params, prompt, steps: int, temperature: float = 0.0, seed: int = 0):
        """Greedy (``temperature <= 0``) or temperature sampling from a
        ``torch.Generator`` seeded with ``seed``: prefill, then
        ``steps - 1`` decode steps.  Returns (B, steps) int32 tokens."""
        b, s = prompt.shape
        logits, cache = self.prefill(params, prompt, max_len=s + steps)
        gen = torch.Generator(device=logits.device).manual_seed(seed)

        def pick(logits):
            if temperature <= 0.0:
                return torch.argmax(logits, dim=-1).to(torch.int32)
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)

        tok = pick(logits)
        out = [tok]
        for _ in range(steps - 1):
            logits, cache = self.decode_step(params, cache, tok[:, None])
            tok = pick(logits)
            out.append(tok)
        return torch.stack(out, dim=1)
