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
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed import fsdp
from repro_torch.distributed.sharding import mesh_sizes
from repro_torch.training.optimizer import OptimizerConfig, adamw_step

__all__ = ["make_train_step", "make_sharded_train_step", "sharded_loss_and_grads",
           "make_prefill_step", "make_decode_step", "input_specs"]


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
