"""Full-model assembly: embed -> layers -> final norm -> logits.

The counterpart of ``repro.models.transformer``.  The reference scans
its layers over parameters stacked on a leading "layers" axis (one
stack per pattern position, plus unrolled tail layers); the port holds
one module per layer in a ``ModuleList``, in layer order, and runs them
in a Python loop.  The reference compiles its decode step with
``jax.jit``; the port's counterpart is a CUDA graph of ``decode_into``
(``serving.backends.DecodeGraph``), which is why the decode step keeps
its position on the device and writes its caches, its next token and its
logits in place.  ``TransformerParams`` converts between the two: it is
built from a tree in the reference's stacked layout and gives one back
(``to_tree``, and ``grad_tree`` for the gradients), and takes one in
place (``load_tree_``), which is how the optimizer's update reaches it.

Its weights are frozen (``requires_grad=False``), so serving builds no
autograd graph; training unfreezes them (``requires_grad_(True)``).  The
training half is the reference's: ``hidden_states`` (each layer under
``torch.utils.checkpoint`` when ``cfg.remat``, the counterpart of the
reference's ``jax.checkpoint`` of its period body, and the MoE layers'
auxiliary terms summed), ``chunked_xent`` (the logits of one sequence
chunk at a time, each chunk checkpointed, so the (B, S, V) logits never
exist whole) and ``loss_fn``.

The layer loops are ``layers_full``, ``layers_prefill`` and
``layers_decode``, which the dry run's cost pieces call on their own
(``launch.costmodel``).  On DTensor weights (the sharded serving steps,
``launch.steps``) the prefill and decode loops hold the residual stream
on the data axes at each layer's entry (``blocks.residual``) and gather a
layer's weights over the data axes where the rules split them there
(``distributed.fsdp.serving_view``); on plain tensors both are no-ops.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.fsdp import local_params, local_view, serving_view
from repro_torch.kernels import is_sharded
from repro_torch.models import blocks
from repro_torch.models.kvcache import model_dtype, position
from repro_torch.models.layers import (
    embed_spec,
    embed_tokens,
    logits_from_embed,
    rmsnorm,
    rmsnorm_spec,
)
from repro_torch.models.spec import P, stack

__all__ = ["model_spec", "TransformerParams", "forward", "prefill", "decode_step", "decode_into",
           "hidden_states", "chunked_xent", "loss_fn", "layers_full", "layers_prefill",
           "layers_decode"]


def model_spec(cfg) -> dict:
    """The reference's parameter tree (``repro.models.transformer.model_spec``)."""
    spec: dict = {"embed": embed_spec(cfg.vocab_size, cfg.d_model)}
    spec["blocks"] = [
        stack(blocks.block_spec(cfg, kind), cfg.n_periods) for kind in cfg.pattern
    ]
    spec["tail"] = [
        blocks.block_spec(cfg, cfg.layer_kind(cfg.n_periods * cfg.period + i))
        for i in range(cfg.n_tail)
    ]
    spec["final_norm"] = rmsnorm_spec(cfg.d_model)
    if not cfg.tie_embeddings:
        spec["lm_head"] = P((cfg.vocab_size, cfg.d_model), ("vocab", "embed"), init="small")
    return spec


def _module(tree: dict) -> nn.Module:
    """A module whose attributes are the tree's keys: sub-dicts become
    submodules, tensors frozen parameters."""
    m = nn.Module()
    for key, val in tree.items():
        if isinstance(val, dict):
            m.add_module(key, _module(val))
        else:
            m.register_parameter(key, nn.Parameter(val, requires_grad=False))
    return m


def _tensors(m: nn.Module, leaf=lambda p: p.data) -> dict:
    out = {name: leaf(p) for name, p in m.named_parameters(recurse=False)}
    out.update({name: _tensors(child, leaf) for name, child in m.named_children()})
    return out


def _grad(p):
    return p.grad if p.grad is not None else torch.zeros_like(p)


def _copy_into(m: nn.Module, tree: dict) -> None:
    for name, p in m.named_parameters(recurse=False):
        p.data.copy_(tree[name])
    for name, child in m.named_children():
        _copy_into(child, tree[name])


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


class TransformerParams(nn.Module):
    """The weights of one LM: ``embed``, ``layers`` (one module per layer),
    ``final_norm`` and, untied, ``lm_head``."""

    def __init__(self, cfg, tree: dict):
        super().__init__()
        self.cfg = cfg
        self.embed = _module(tree["embed"])
        self.layers = nn.ModuleList()
        for i in range(cfg.num_layers):
            if i < cfg.n_periods * cfg.period:
                stacked = tree["blocks"][i % cfg.period]
                layer = _map(stacked, lambda t, p=i // cfg.period: t[p])
            else:
                layer = tree["tail"][i - cfg.n_periods * cfg.period]
            self.layers.append(_module(layer))
        self.final_norm = _module(tree["final_norm"])
        # With no whole period (a dry run's pieces) the stacks hold no layer;
        # kept as given, so that ``to_tree`` returns the spec's layout.
        self._empty_stacks = tree["blocks"] if cfg.n_periods == 0 else None
        if "lm_head" in tree:
            self.lm_head = nn.Parameter(tree["lm_head"], requires_grad=False)
        else:
            self.lm_head = None

    def to_tree(self) -> dict:
        """The reference's stacked layout (the inverse of the constructor)."""
        return self._tree(lambda p: p.data)

    def grad_tree(self) -> dict:
        """The gradients in the reference's stacked layout: zeros for a
        weight the loss did not reach."""
        return self._tree(_grad)

    def _tree(self, leaf) -> dict:
        cfg = self.cfg
        layers = [_tensors(m, leaf) for m in self.layers]
        full = cfg.n_periods * cfg.period
        tree = {
            "embed": _tensors(self.embed, leaf),
            "blocks": ([_map(b, leaf) for b in self._empty_stacks]
                       if self._empty_stacks is not None else
                       [_stack_trees(layers[j:full:cfg.period]) for j in range(cfg.period)]),
            "tail": layers[full:],
            "final_norm": _tensors(self.final_norm, leaf),
        }
        if self.lm_head is not None:
            tree["lm_head"] = leaf(self.lm_head)
        return tree

    @torch.no_grad()
    def load_tree_(self, tree: dict) -> "TransformerParams":
        """Copy a tree in the reference's stacked layout into the weights,
        in place (each leaf cast to its weight's type)."""
        cfg = self.cfg
        full = cfg.n_periods * cfg.period
        _copy_into(self.embed, tree["embed"])
        for i, layer in enumerate(self.layers):
            if i < full:
                _copy_into(layer, _map(tree["blocks"][i % cfg.period],
                                       lambda t, p=i // cfg.period: t[p]))
            else:
                _copy_into(layer, tree["tail"][i - full])
        _copy_into(self.final_norm, tree["final_norm"])
        if self.lm_head is not None:
            self.lm_head.data.copy_(tree["lm_head"])
        return self


def _stack_trees(trees: list) -> dict:
    """One tree whose leaves stack the given trees' leaves on a new axis 0."""
    return {
        k: _stack_trees([t[k] for t in trees]) if isinstance(v, dict)
        else torch.stack([t[k] for t in trees])
        for k, v in trees[0].items()
    }


def _kinds(cfg):
    return [cfg.layer_kind(i) for i in range(cfg.num_layers)]


def _logits(params, cfg, x):
    table = params.lm_head if params.lm_head is not None else params.embed.embedding
    return logits_from_embed(table, x, cfg.logit_softcap)


def _embed(params, cfg, tokens):
    x = embed_tokens(params.embed, tokens, scale_by_dim=cfg.embed_scale)
    return x.to(model_dtype(cfg))


def forward(params, tokens, cfg):
    """Causal LM forward.  tokens: (B, S) int -> logits (B, S, V)."""
    params = local_params(params)
    x, _ = _blocks(params, tokens, cfg)
    return _logits(params, cfg, rmsnorm(params.final_norm, x))


def hidden_states(params, tokens, cfg):
    """Embed + blocks + final norm, WITHOUT the logits projection.  Returns
    (x, aux), aux the sum of the MoE layers' auxiliary terms (float32).
    With ``cfg.remat``, while autograd records, each layer runs under
    ``torch.utils.checkpoint``: its activations are recomputed in the
    backward, as the reference's ``jax.checkpoint`` recomputes its period
    body."""
    params = local_params(params)
    x, aux = _blocks(params, tokens, cfg)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=x.device)
    return rmsnorm(params.final_norm, x), aux


def _blocks(params, tokens, cfg):
    """Embed + blocks: (x, the MoE terms' sum, 0.0 without MoE layers)."""
    return layers_full(params.layers, _embed(params, cfg, tokens), cfg)


def layers_full(layers, x, cfg):
    """The layers' full-sequence passes on the residual stream x (layer i
    of kind ``cfg.layer_kind(i)``), each under ``torch.utils.checkpoint``
    when ``cfg.remat`` and autograd records: (x, the MoE terms' sum)."""
    remat = cfg.remat and torch.is_grad_enabled()
    aux = 0.0
    for layer, kind in zip(layers, _kinds(cfg)):
        if remat:
            x, a = checkpoint(_block_full, layer, x, cfg, kind, use_reentrant=False)
        else:
            x, a = _block_full(layer, x, cfg, kind)
        aux = aux + a
    return x, aux


def _block_full(layer, x, cfg, kind):
    """``blocks.block_full`` on one layer; sharded weights (``Trainer(
    shardings=)``) are gathered whole here, inside the layer's checkpoint,
    so that its backward gathers them again (``distributed.fsdp``)."""
    return blocks.block_full(local_view(layer), x, cfg, kind)


def _xent_chunk(xc, table, tc, mc, softcap_value: float):
    logits = (xc @ table.T).float()
    if softcap_value and softcap_value > 0:
        logits = torch.tanh(logits / softcap_value) * softcap_value
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, tc[..., None].long())[..., 0]
    return ((logz - gold) * mc).sum()


def chunked_xent(x, table, targets, mask, softcap_value: float, chunk: int):
    """Cross-entropy summed over sequence chunks of ``chunk`` positions: the
    (B, S, V) logits are never materialised.  While autograd records, each
    chunk runs under ``torch.utils.checkpoint``, so only its (B, c, D)
    slice is kept for the backward, which recomputes its logits."""
    s = x.shape[1]
    chunk = min(chunk, s)
    grad = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for s0 in range(0, s, chunk):
        args = (x[:, s0:s0 + chunk], table, targets[:, s0:s0 + chunk], mask[:, s0:s0 + chunk],
                softcap_value)
        part = (checkpoint(_xent_chunk, *args, use_reentrant=False) if grad
                else _xent_chunk(*args))
        total = total + part
    return total


def loss_fn(params, batch, cfg):
    """Next-token cross-entropy via chunked logits (memory-bounded).

    batch: {"tokens": (B, S) int, optional "mask": (B, S)}.  Returns (loss,
    metrics) as the reference's: the loss plus 0.01 times the MoE
    auxiliary term, and {"loss", "aux_loss", "tokens"}.  Sharded weights
    are gathered as ``distributed.fsdp`` says."""
    params = local_params(params)
    tokens = batch["tokens"]
    x, aux = hidden_states(params, tokens[:, :-1], cfg)
    targets = tokens[:, 1:]
    mask = batch.get("mask")
    mask = (torch.ones(targets.shape, dtype=torch.float32, device=targets.device)
            if mask is None else mask[:, 1:].float())
    table = params.lm_head if params.lm_head is not None else params.embed.embedding
    nll = chunked_xent(x, table, targets, mask, cfg.logit_softcap, cfg.xent_chunk)
    denom = mask.sum().clamp_min(1.0)
    loss = nll / denom
    total = loss + 0.01 * aux
    return total, {"loss": loss, "aux_loss": aux, "tokens": denom}


def prefill(params, tokens, cfg, max_len: int):
    """Process a full prompt; returns (logits at the last position (B, V),
    cache) with ``cache = {"layers": [...], "pos": S}``, the position a
    0-dim int32 tensor on the tokens' device."""
    x, caches = layers_prefill(params.layers, _embed(params, cfg, tokens), cfg, max_len)
    x = rmsnorm(params.final_norm, x[:, -1:, :])[:, 0]
    pos = position(tokens.shape[1], tokens.device)
    return _logits(params, cfg, x), {"layers": caches, "pos": pos}


def layers_prefill(layers, x, cfg, max_len: int):
    """The layers' prefill passes on x: (x, their caches).  On a DTensor x
    (a sharded serving step) each layer runs through its ``serving_view``
    and x is held on the data axes at its entry (``blocks.residual``)."""
    sharded = is_sharded(x)
    caches = []
    for layer, kind in zip(layers, _kinds(cfg)):
        x, cache = blocks.block_prefill(serving_view(layer) if sharded else layer,
                                        blocks.residual(x), cfg, kind, max_len)
        caches.append(cache)
    return x, caches


def layers_decode(layers, x, caches, pos, cfg):
    """The layers' decode steps on x (B, 1, D) at ``pos``, each writing its
    cache in place: x.  A DTensor x runs as in ``layers_prefill``."""
    sharded = is_sharded(x)
    slots = _slots(cfg, caches, pos, x.shape[0])
    for layer, c, kind, (slot, lengths) in zip(layers, caches, _kinds(cfg), slots):
        x, _ = blocks.block_decode(serving_view(layer) if sharded else layer,
                                   blocks.residual(x), c, pos, cfg, kind,
                                   lengths=lengths, slot=slot)
    return x


def _slots(cfg, caches, pos, batch: int) -> list:
    """Per layer, (slot, lengths) of the step at ``pos``: for a global
    attention layer (``pos``, ``pos + 1``), for a ring buffer of L slots
    (``pos % L``, ``min(pos + 1, L)``), lengths expanded to (B,); None for
    SSD.  Each distinct pair is built once, on the device."""
    built: dict = {}
    out = []
    for c, kind in zip(caches, _kinds(cfg)):
        mixer = kind.partition(":")[0]
        key = c["k"].shape[1] if mixer == "local" else mixer
        if key not in built:
            if mixer == "attn":
                built[key] = (pos, (pos + 1).expand(batch).contiguous())
            elif mixer == "local":
                built[key] = (torch.remainder(pos, key),
                              torch.clamp(pos + 1, max=key).expand(batch).contiguous())
            else:
                built[key] = (None, None)
        out.append(built[key])
    return out


def decode_step(params, cache, tokens, cfg):
    """One decode step.  tokens: (B, 1) int; the cache from ``prefill`` or
    ``kvcache.init_cache``, written in place, its position advanced in
    place, and returned.  Returns (logits (B, V), cache).

    Reads no device value on the host: the new token's position, its
    slot in each ring buffer and K4's per-row lengths (``_slots``, built
    once per step) stay on the device."""
    pos = cache["pos"]
    x = layers_decode(params.layers, _embed(params, cfg, tokens), cache["layers"], pos, cfg)
    x = rmsnorm(params.final_norm, x)
    logits = _logits(params, cfg, x[:, -1, :])
    pos.add_(1)
    return logits, cache


def decode_into(params, cache, tok, logits, cfg):
    """One greedy decode step on static buffers, all written in place:
    reads the (B, 1) int32 token buffer ``tok``, advances ``cache``, writes
    the step's logits into ``logits`` (B, V) and the argmax token back into
    ``tok``.  The function a decode CUDA graph captures, and the one the
    host runs eagerly."""
    out, _ = decode_step(params, cache, tok, cfg)
    logits.copy_(out)
    tok.copy_(out.argmax(dim=-1, keepdim=True))
