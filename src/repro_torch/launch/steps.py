"""Step functions of the trainer and the server, the counterpart of
``repro.launch.steps``.

Each factory closes over the model and the optimizer config.  The
reference's are pure functions for ``jax.jit``; the port's train step
runs eagerly and updates the weights in place: the loss, its backward
(through K3b and K5b on the card), then ``adamw_step`` on the stacked
trees (``TransformerParams.grad_tree``/``to_tree``), whose result is
copied back into the weights (``load_tree_``).  ``input_specs`` gives
a cell's inputs as ``meta`` tensors, the reference's ``ShapeDtypeStruct``
stand-ins.  With sharded weights the trainer takes
``make_sharded_train_step`` instead (``distributed.fsdp``).

The serving steps have sharded counterparts too, the reference's dry-run
steps under its ``tp`` and ``ep_tp`` rules: ``make_sharded_prefill_step``
and ``make_sharded_decode_step`` run the model on DTensor weights placed
by those rules (``launch.shardings.serve_shardings``), the tokens' rows
over the data axes, and let DTensor propagate the placements through
every operation (plain tensors the model makes count as replicated,
``implicit_replication``); the kernels run on each rank's shards
(``kernels.on_shards``), and a decode step writes the sequence-sharded
cache on its local shards (``models.attention``).  The steps return the
logits and the cache placed as the reference's ``out_shardings`` place
them.
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed import fsdp
from repro_torch.distributed.sharding import mesh_sizes
from repro_torch.training.optimizer import OptimizerConfig, adamw_step

__all__ = ["make_train_step", "make_sharded_train_step", "sharded_loss_and_grads",
           "make_prefill_step", "make_decode_step", "make_sharded_prefill_step",
           "make_sharded_decode_step", "placed", "input_specs"]


def make_train_step(model, opt_cfg: OptimizerConfig):
    def train_step(params, opt_state, batch):
        """One step on ``params`` (a ``TransformerParams``, updated in place
        and returned); metrics as the reference's, 0-dim tensors."""
        params.requires_grad_(True)
        params.zero_grad(set_to_none=True)
        loss, metrics = model.loss(params, batch)
        loss.backward()
        grads = params.grad_tree()
        params.zero_grad(set_to_none=True)
        new_tree, new_opt, opt_metrics = adamw_step(grads, opt_state, params.to_tree(), opt_cfg)
        del grads
        params.load_tree_(new_tree)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, new_opt, {**metrics, **opt_metrics, "total_loss": loss.detach()}

    return train_step


def sharded_loss_and_grads(model, params, batch, policy):
    """This rank's rows of the global ``batch`` (``distributed.fsdp.
    batch_rows`` under ``policy``) through the loss and its backward, on
    DTensor weights: (this rank's loss, its share of the world's tokens,
    its row blocks, its metrics, the gradients as DTensors on the
    weights' placements)."""
    mesh = params.final_norm.scale.device_mesh
    tokens = batch["tokens"]
    first, rows, blocks = fsdp.batch_rows(tokens.shape[0], tokens.shape[1] - 1, model.cfg,
                                          mesh, policy)
    local = {k: v[first:first + rows] for k, v in batch.items()}
    params.requires_grad_(True)
    params.zero_grad(set_to_none=True)
    loss, metrics = model.loss(params, local)
    share = metrics["tokens"].detach().float()
    share = share / fsdp.all_reduce_sum(share)
    (loss * share).backward()
    grads = params.grad_tree()
    params.zero_grad(set_to_none=True)
    return loss.detach(), share, blocks, metrics, grads


def make_sharded_train_step(model, opt_cfg, shardings, policy):
    """The train step on DTensor weights and state (``shardings`` =
    (param shardings, opt-state shardings)), on the global batch, of
    which this rank computes its rows (``sharded_loss_and_grads``).
    Metrics as the unsharded step's, for the global batch."""
    p_sh, o_sh = shardings
    world = math.prod(mesh_sizes(fsdp.first_mesh(p_sh)).values())

    def train_step(params, opt_state, batch):
        loss, share, blocks, metrics, grads = sharded_loss_and_grads(model, params, batch,
                                                                     policy)
        new_tree, new_opt, opt_metrics = adamw_step(grads, opt_state, params.to_tree(), opt_cfg)
        del grads
        params.load_tree_(fsdp.place_tree(new_tree, p_sh))
        new_opt = {**new_opt,
                   **{k: fsdp.place_tree(new_opt[k], o_sh[k]) for k in ("master", "m", "v")}}
        out = {k: fsdp.all_reduce_sum(metrics[k].float() * share) for k in ("loss", "aux_loss")}
        out["tokens"] = fsdp.all_reduce_sum(metrics["tokens"].float()) * blocks / world
        out["total_loss"] = fsdp.all_reduce_sum(loss * share)
        gnorm = opt_metrics["grad_norm"]
        out.update(lr=opt_metrics["lr"],
                   grad_norm=gnorm.full_tensor() if isinstance(gnorm, fsdp.DTensor) else gnorm)
        return params, new_opt, out

    return train_step


def make_prefill_step(model, max_len: int):
    def prefill_step(params, tokens):
        return model.prefill(params, tokens, max_len=max_len)

    return prefill_step


def make_decode_step(model):
    def decode_step(params, cache, tokens):
        return model.decode_step(params, cache, tokens)

    return decode_step


def placed(x, sharding):
    """``x`` as a DTensor on ``sharding``: a plain tensor is taken as the
    whole value (every rank holds it) and cut without communication."""
    if not isinstance(x, fsdp.DTensor):
        return fsdp.shard_tensor(x, sharding)
    want = tuple(sharding.placements)
    return x if tuple(x.placements) == want else x.redistribute(sharding.mesh, want)


def _place_cache(cache, shardings):
    return {"layers": [{k: placed(v, shardings["layers"][i][k]) for k, v in layer.items()}
                       for i, layer in enumerate(cache["layers"])],
            "pos": placed(cache["pos"], shardings["pos"])}


def make_sharded_prefill_step(model, max_len: int, shardings):
    """``make_prefill_step`` on DTensor weights; ``shardings`` = (token,
    cache, logits shardings) from ``launch.shardings.serve_shardings``.
    The step takes the whole (B, S) token batch on every rank, or its
    DTensor, and returns (logits (B, V), cache) as DTensors."""
    tok_sh, cache_sh, logits_sh = shardings

    def prefill_step(params, tokens):
        from torch.distributed.tensor.experimental import implicit_replication

        with implicit_replication(), torch.no_grad():
            logits, cache = model.prefill(params, placed(tokens, tok_sh), max_len=max_len)
            return placed(logits, logits_sh), _place_cache(cache, cache_sh)

    return prefill_step


def make_sharded_decode_step(model, shardings):
    """``make_decode_step`` on DTensor weights and a cache placed by
    ``shardings`` (as ``make_sharded_prefill_step``'s); the cache is
    written in place and returned."""
    tok_sh, cache_sh, logits_sh = shardings

    def decode_step(params, cache, tokens):
        from torch.distributed.tensor.experimental import implicit_replication

        with implicit_replication(), torch.no_grad():
            logits, cache = model.decode_step(params, cache, placed(tokens, tok_sh))
            return placed(logits, logits_sh), cache

    return decode_step


def input_specs(cfg, shape_spec):
    """``meta`` tensor stand-ins for every model input of one cell.

    train:   {"tokens": (B, S+1)}  (the model trains on exactly S positions)
    prefill: {"tokens": (B, S)}
    decode:  {"tokens": (B, 1)} + cache built by the caller
    """
    b, s = shape_spec.global_batch, shape_spec.seq_len
    rows = {"train": s + 1, "prefill": s, "decode": 1}.get(shape_spec.step)
    if rows is None:
        raise ValueError(shape_spec.step)
    return {"tokens": torch.empty((b, rows), dtype=torch.int32, device="meta")}
