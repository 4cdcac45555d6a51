"""Compositional roofline cost model (dry-run companion), the counterpart
of ``repro.launch.costmodel``.

The reference composes its FLOPs from separately compiled pieces because
XLA's ``cost_analysis`` counts a scan's body once:

  total = stub + n_periods * period + tail

  * stub   — embed -> final_norm -> logits (+ loss & backward for train):
             the non-layer work;
  * period — one full pattern period applied to the residual stream
             (for train: forward, the remat recompute and backward);
  * tail   — the remainder layers.

The port runs its layers in a Python loop and traces them eagerly, so a
trace of the whole step already counts every layer: the dry run takes
its totals from that trace, and composes only when asked for the
breakdown (``launch.dryrun --composed``), a period's cost being the unit
a reader compares.  The sum equals the whole trace's FLOPs
(``tests/test_torch_dryrun.py`` holds it).
Each piece runs the model's own code on fake tensors (``FakeTensorMode``)
over the caller's mesh, weights as fake DTensors placed by ``policy``
(``models.spec.abstract_params`` through ``launch.shardings``): the stub
is the whole step of a config with no layers; a period or the tail is
``models.transformer.layers_full`` (train: each layer under
``torch.utils.checkpoint``, the gradient taken through a sum of squares,
as the reference's piece loss), ``layers_prefill`` (caches placed as the
step places them) or ``layers_decode`` on the residual stream placed as
the step's.  Each piece is measured by one ``launch.hlo_analysis.
StepTrace``: FLOPs, bytes accessed and the collective census.  Peak
memory does not compose; ``launch.dryrun`` takes it from the whole step.

``step_setup`` builds a whole step and its fake inputs, the dry run's
and the stub's.  The optimizer is not in the composition (the reference's
stub is its loss and gradient); its work is elementwise, which the FLOP
count leaves out anyway.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.distributed import fsdp
from repro_torch.distributed.sharding import named_sharding_tree, rows_over_data
from repro_torch.launch import shardings as shd
from repro_torch.launch.hlo_analysis import StepTrace, collective_bytes
from repro_torch.launch.steps import (
    make_sharded_decode_step,
    make_sharded_prefill_step,
    make_sharded_train_step,
    placed,
    sharded_loss_and_grads,
)
from repro_torch.models import LM, blocks, transformer
from repro_torch.models.attention import attention_options
from repro_torch.models.kvcache import model_dtype
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.trainer import sharded_opt_state
from repro_torch.trees import tree_map

__all__ = ["composed_cost", "step_setup", "trace", "fake_mode", "fake_params"]


def fake_mode():
    """The tracing mode: fake tensors; real ones (the mesh's own) may mix in."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode(allow_non_fake_inputs=True)


def _fake_leaf(t, sharding):
    full = torch.empty(tuple(t.shape), dtype=t.dtype)
    return full if sharding is None else fsdp.shard_tensor(full, sharding)


def fake_params(model, p_sh):
    """The model's weights as fake DTensors on ``p_sh`` (a tree of
    ``NamedSharding``); call under ``fake_mode``."""
    tree = tree_map(_fake_leaf, model.abstract_params(), p_sh)
    return transformer.TransformerParams(model.cfg, tree)


def _fake_state(model, p_sh, o_sh, opt_cfg):
    """Weights and AdamW's state as ``Trainer(shardings=)`` builds them:
    the state of the local shards placed as the shards of the state.  The
    step counter stays a real host tensor (the step reads it as a number)."""
    params = fake_params(model, p_sh)
    opt = sharded_opt_state(model, params, o_sh, opt_cfg, "cpu")
    with torch._subclasses.fake_tensor.unset_fake_temporarily():
        opt["step"] = torch.zeros((), dtype=torch.int32)
    return params, opt


def _fake_cache(model, cache_sh, batch: int, max_len: int, pos: int):
    """Decode caches on ``cache_sh``, the position ``pos`` (a replicated
    0-dim tensor)."""
    cache = model.abstract_cache(batch, max_len)
    layers = [{k: _fake_leaf(v, cache_sh["layers"][i][k]) for k, v in layer.items()}
              for i, layer in enumerate(cache["layers"])]
    position = torch.full((), int(pos), dtype=torch.int32)
    return {"layers": layers, "pos": fsdp.shard_tensor(position, cache_sh["pos"])}


def step_setup(cfg, shape, mesh, policy, opt_cfg=None, *, loss_only: bool = False):
    """(step function, its fake arguments, the tree of what it holds when it
    starts) for one cell's whole step on ``mesh``; call under ``fake_mode``.

    train:   ``make_sharded_train_step`` on the weights and AdamW state
             (``loss_only``: ``sharded_loss_and_grads`` alone), the
             global (B, S + 1) batch on every rank, as the trainer's;
    prefill: ``make_sharded_prefill_step`` on the (B, S) tokens;
    decode:  ``make_sharded_decode_step`` on a cache of S positions whose
             last is written, one (B, 1) token."""
    model = LM(cfg)
    b, s = shape.global_batch, shape.seq_len
    if shape.step == "train":
        opt_cfg = opt_cfg or OptimizerConfig()
        p_sh = named_sharding_tree(shd.param_pspecs(model, policy, mesh), mesh)
        o_sh = named_sharding_tree(shd.opt_state_pspecs(model, policy, mesh, opt_cfg), mesh)
        params, opt = _fake_state(model, p_sh, o_sh, opt_cfg)
        batch = {"tokens": torch.empty((b, s + 1), dtype=torch.int32)}
        if loss_only:
            def loss_step(params, batch):
                return sharded_loss_and_grads(model, params, batch, policy)

            return loss_step, (params, batch), (params, batch)
        step = make_sharded_train_step(model, opt_cfg, (p_sh, o_sh), policy)
        return step, (params, opt, batch), (params, opt, batch)
    p_sh, serve_sh = shd.serve_shardings(model, mesh, b, s, step=shape.step)
    params = fake_params(model, p_sh)
    if shape.step == "prefill":
        tokens = torch.empty((b, s), dtype=torch.int32)
        return make_sharded_prefill_step(model, s, serve_sh), (params, tokens), (params, tokens)
    cache = _fake_cache(model, serve_sh[1], b, s, s - 1)
    tokens = torch.empty((b, 1), dtype=torch.int32)
    return (make_sharded_decode_step(model, serve_sh), (params, cache, tokens),
            (params, cache, tokens))


def trace(fn, args, inputs=None) -> dict:
    """Run ``fn(*args)`` under a ``StepTrace`` (``inputs``: what it holds
    when it starts): {"flops", "bytes", "collectives", "peak_bytes",
    "start_bytes", "ops"}."""
    with StepTrace(inputs) as t:
        fn(*args)
    return {"flops": float(t.flops), "bytes": float(t.bytes),
            "collectives": collective_bytes(t), "peak_bytes": t.peak,
            "start_bytes": t.start_bytes, "ops": t.ops}


def _piece(cfg, kinds, shape, mesh, policy) -> dict:
    """The cost of ``kinds``' layers on the residual stream of one cell."""
    cfg_p = dataclasses.replace(cfg, num_layers=len(kinds))
    assert [cfg_p.layer_kind(i) for i in range(len(kinds))] == list(kinds)
    model = LM(cfg_p)
    b, s, d = shape.global_batch, shape.seq_len, cfg.d_model
    dtype = model_dtype(cfg)
    if shape.step == "train":
        p_sh = named_sharding_tree(shd.param_pspecs(model, policy, mesh), mesh)
        params = fake_params(model, p_sh)
        _, rows, _ = fsdp.batch_rows(b, s, cfg, mesh, policy)
        x = torch.empty((rows, s, d), dtype=dtype).requires_grad_(True)

        def piece(params, x):
            params.requires_grad_(True)
            y, aux = transformer.layers_full(params.layers, x, cfg_p)
            (torch.sum(y.float() ** 2) * 1e-6 + aux).backward()

        return trace(piece, (params, x), (params, x))
    seq = s if shape.step == "prefill" else 1
    p_sh, (_, cache_sh, _) = shd.serve_shardings(model, mesh, b, s, step=shape.step)
    params = fake_params(model, p_sh)
    # The residual stream where each layer's entry holds it (``blocks.residual``),
    # in and out: the whole step reduces a layer's pending output sum where
    # the next layer or the final norm reads it, so a piece ends with it.
    x = rows_over_data(DTensor.from_local(torch.empty((b, seq, d), dtype=dtype), mesh,
                                          [Replicate()] * mesh.ndim, run_check=False))

    def run(fn):
        from torch.distributed.tensor.experimental import implicit_replication

        with implicit_replication(), torch.no_grad():
            return fn()

    if shape.step == "prefill":
        def piece(params, x):
            def go():
                y, caches = transformer.layers_prefill(params.layers, x, cfg_p, s)
                return blocks.residual(y), [
                    {k: placed(v, cache_sh["layers"][i][k]) for k, v in c.items()}
                    for i, c in enumerate(caches)]
            return run(go)

        return trace(piece, (params, x), (params, x))
    cache = _fake_cache(model, cache_sh, b, s, s - 1)

    def piece(params, x, cache):
        return run(lambda: blocks.residual(transformer.layers_decode(
            params.layers, x, cache["layers"], cache["pos"], cfg_p)))

    return trace(piece, (params, x, cache), (params, x, cache))


def composed_cost(cfg, shape, mesh, policy, opt_cfg=None, skip_masked_blocks: bool = False):
    """Returns {"stub": cost, "period": cost, "tail": cost, "totals": {...}},
    each cost a ``trace`` record; totals {"flops", "bytes",
    "collective_bytes"} = stub + n_periods * period + tail.  Needs a
    process group whose world is the mesh's (``launch.mesh.fake_world``).

    ``skip_masked_blocks`` counts the key tiles K3 and K3b run instead of
    the full square (``models.attention.attention_options``)."""
    results = {}
    with attention_options(unroll=True, skip_masked_blocks=skip_masked_blocks), fake_mode():
        cfg0 = dataclasses.replace(cfg, num_layers=0)
        fn, args, inputs = step_setup(cfg0, shape, mesh, policy, opt_cfg, loss_only=True)
        results["stub"] = trace(fn, args, inputs)
        results["period"] = (_piece(cfg, list(cfg.pattern), shape, mesh, policy)
                             if cfg.n_periods > 0 else None)
        tail_kinds = [cfg.layer_kind(cfg.n_periods * cfg.period + i) for i in range(cfg.n_tail)]
        results["tail"] = _piece(cfg, tail_kinds, shape, mesh, policy) if tail_kinds else None

    def total(get):
        t = get(results["stub"])
        if results["period"]:
            t += cfg.n_periods * get(results["period"])
        if results["tail"]:
            t += get(results["tail"])
        return t

    results["totals"] = {
        "flops": total(lambda r: r["flops"]),
        "bytes": total(lambda r: r["bytes"]),
        "collective_bytes": total(lambda r: r["collectives"]["total_bytes"]),
    }
    return results
