"""Spec construction for params, optimizer state, caches and inputs, the
counterpart of ``repro.launch.shardings``.

The trees are the port's: parameters and AdamW's state in the reference's
stacked layout (``TransformerParams.to_tree``, ``LM.abstract_params``),
int8 moments included, and decode caches in the port's per-layer list
(``kvcache.init_cache``: ``{"layers": [...], "pos"}``), whose leaves
carry no stacked dim.  The reference's ``as_named`` is
``distributed.sharding.named_sharding_tree`` here.
"""
from __future__ import annotations

from repro_torch.distributed.policies import dp_axes
from repro_torch.distributed.sharding import (
    PartitionSpec,
    ShardingPolicy,
    mesh_sizes,
    params_pspecs,
)
from repro_torch.trees import is_spec, tree_leaves, tree_map

__all__ = [
    "param_pspecs",
    "opt_state_pspecs",
    "cache_pspecs",
    "token_pspec",
    "logits_pspec",
    "serve_shardings",
]


def param_pspecs(model, policy: ShardingPolicy, mesh):
    axes = model.param_axes()
    shapes = model.abstract_params()
    return params_pspecs(axes, shapes, policy, mesh)


def opt_state_pspecs(model, policy: ShardingPolicy, mesh, opt_cfg):
    """Mirrors param specs for master/m/v; quantized moments {"q","scale"}
    share the param's spec (scale loses its last dim).  The master copy is
    absent (None) when params are already master-precision — mirror
    ``training.optimizer.init_opt_state``."""
    p = param_pspecs(model, policy, mesh)
    abstract = model.abstract_params()
    needs_master = any(x.dtype != opt_cfg.master_dtype for x in tree_leaves(abstract))

    def moment(ps: PartitionSpec):
        if not opt_cfg.quantize_moments:
            return ps
        parts = list(ps)
        scale = PartitionSpec(*(parts[:-1] + [None])) if parts else PartitionSpec()
        return {"q": ps, "scale": scale}

    return {
        "step": PartitionSpec(),
        "master": p if needs_master else None,
        "m": tree_map(moment, p, is_leaf=is_spec),
        "v": tree_map(moment, p, is_leaf=is_spec),
    }


def _div(n: int, mesh, axis) -> bool:
    if axis is None:
        return True
    names = axis if isinstance(axis, tuple) else (axis,)
    sizes = mesh_sizes(mesh)
    size = 1
    for a in names:
        size *= sizes[a]
    return n % size == 0


def _leaf_spec(name: str, shape, mesh, dp):
    """Cache-leaf PartitionSpec by field name (see kvcache layouts)."""
    dpx = dp if len(dp) > 1 else dp[0]
    if name in ("k", "v", "k_scale", "v_scale"):
        tpl = [dpx, "model", None, None]  # (B, S, Hkv, Dh) / (B, S, Hkv, 1)
    elif name == "conv":
        tpl = [dpx, None, None]
    elif name == "h":
        tpl = [dpx, "model"]
    elif name == "state":
        tpl = [dpx, None, None, None]
    elif name == "pos":
        return PartitionSpec()
    else:
        raise KeyError(name)
    if len(shape) == len(tpl) + 1:  # stacked (n_periods leading; the reference's layout)
        tpl = [None] + tpl
    out = []
    for dim, axis in zip(shape, tpl):
        out.append(axis if _div(dim, mesh, axis) else None)
    return PartitionSpec(*out)


def cache_pspecs(cache_abstract, mesh):
    dp = dp_axes(mesh)

    def walk(node):
        if isinstance(node, dict):
            return {
                k: (walk(v) if isinstance(v, (dict, list))
                    else _leaf_spec(k, getattr(v, "shape", ()), mesh, dp))
                for k, v in node.items()
            }
        if isinstance(node, list):
            return [walk(v) for v in node]
        raise TypeError(type(node))

    return walk(cache_abstract)


def token_pspec(batch: int, mesh, full_mesh: bool = False) -> PartitionSpec:
    """Token-batch sharding: widest divisible data split.  ``full_mesh``
    (train under fsdp modes) also folds the model axis into the batch."""
    dp = dp_axes(mesh)
    candidates = []
    if full_mesh:
        candidates.append(tuple(dp) + ("model",))
    candidates.append(dp if len(dp) > 1 else dp[0])
    candidates.append("data")
    for cand in candidates:
        names = cand if isinstance(cand, tuple) else (cand,)
        size = 1
        for a in names:
            size *= mesh_sizes(mesh)[a]
        if batch % size == 0:
            return PartitionSpec(cand, None)
    return PartitionSpec(None, None)


def logits_pspec(cfg, batch: int, mesh) -> PartitionSpec:
    """Serve-step readout (B, V): batch over data, vocab over model —
    keeping the table sharded end-to-end (an unspecified out_sharding
    makes XLA all-gather the full embedding table per step)."""
    sizes = mesh_sizes(mesh)
    b_axis = "data" if batch % sizes["data"] == 0 else None
    v_axis = "model" if cfg.vocab_size % sizes["model"] == 0 else None
    return PartitionSpec(b_axis, v_axis)



def serve_shardings(model, mesh, batch: int, max_len: int, step: str = "decode"):
    """The placements of a sharded serving step (``launch.steps.
    make_sharded_prefill_step``/``make_sharded_decode_step``) under the
    policy of ``step``: (params, (tokens, cache, logits)), each a tree of
    ``NamedSharding`` on ``mesh``."""
    from repro_torch.distributed.policies import make_policy
    from repro_torch.distributed.sharding import NamedSharding, named_sharding_tree

    policy = make_policy(model.cfg, step, mesh)
    params = named_sharding_tree(param_pspecs(model, policy, mesh), mesh)
    cache = named_sharding_tree(cache_pspecs(model.abstract_cache(batch, max_len), mesh), mesh)
    return params, (NamedSharding(mesh, token_pspec(batch, mesh)), cache,
                    NamedSharding(mesh, logits_pspec(model.cfg, batch, mesh)))
