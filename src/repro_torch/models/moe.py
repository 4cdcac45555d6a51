"""Routed MoE: GShard/Switch-style grouped capacity dispatch (top-k).

The counterpart of ``repro.models.moe``.  Tokens are split into groups
of ``moe_group``; per (group, expert) capacity C = ceil(group * top_k / E
* capacity_factor), rounded up to a multiple of 4.  Each of the top-k
rounds routes every token to its best remaining expert, at the next free
slot of that expert's buffer in its group (slots taken in token order,
``fill`` carried from round to round); a token past the capacity is
dropped, and the residual connection keeps its representation.  Padded
prompt rows are tokens like any other, so they take capacity exactly as
in the reference.

The reference dispatches and combines with one-hot einsums over (G, Tg,
E, C) tensors; the port moves the same rows by index: each kept token is
written to its (expert, group, slot) row of the (E, G, C, D) buffer and
read back from it, which is the value the one-hot sum gives (one term
times 1.0, the rest zeros).  The expert products are batched matrix
products (``torch.bmm``), as the reference leaves them to XLA outside
any Pallas kernel.  The shapes depend on the batch and sequence only and
nothing is read on the host, so a decode step (group = min(moe_group,
B)) can be captured in a CUDA graph.  The Switch load-balancing term E *
sum_e f_e * p_e is computed and returned; the serving path ignores it.

In a sharded serving step (``launch.steps.make_sharded_prefill_step``)
the stream is a DTensor, and DTensor has no sharding strategy for the
dispatch's ``index_put_`` or the combine's advanced index on every
PyTorch release (torch 2.11 has none).  So routing, dispatch, the expert
products and the combine run on each rank's local shards
(``_routed_on_shards``): whole token groups over the data axes and the
experts over ``model``, the placement of the reference's ``ep_tp`` rule
``moe_expert_in``.
"""
from __future__ import annotations

from math import prod
from types import SimpleNamespace

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.sharding import heads_divide, row_axes, rows_heads, rows_over_data
from repro_torch.models.layers import _act, mlp, mlp_spec
from repro_torch.models.spec import P

__all__ = ["moe_spec", "moe_forward"]


def moe_spec(d_model: int, num_experts: int, d_ff: int, gated: bool, shared: bool) -> dict:
    spec = {
        "router": P((d_model, num_experts), ("embed", "experts"), init="small"),
        "w_up": P((num_experts, d_model, d_ff), ("experts", "embed", "ffn")),
        "w_down": P((num_experts, d_ff, d_model), ("experts", "ffn", "embed")),
    }
    if gated:
        spec["w_gate"] = P((num_experts, d_model, d_ff), ("experts", "embed", "ffn"))
    if shared:
        spec["shared"] = mlp_spec(d_model, d_ff, gated)
    return spec


def _capacity(group: int, top_k: int, num_experts: int, factor: float) -> int:
    c = int(group * top_k * factor / num_experts) + 1
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


def _routes(probs, top_k: int, cap: int):
    """The reference's top-k capacity routing of (G, Tg, E) router
    probabilities: per round (expert (G, Tg), slot (G, Tg), kept (G, Tg)
    bool, gate (G, Tg) float32 — zero where dropped)."""
    ng, _, e = probs.shape
    experts = torch.arange(e, device=probs.device)
    remaining = probs
    fill = probs.new_zeros((ng, e))  # slots used per (group, expert)
    routes = []
    for _ in range(top_k):
        eidx = torch.argmax(remaining, dim=-1)
        gate = remaining.gather(-1, eidx[..., None])[..., 0]
        onehot = (eidx[..., None] == experts).to(probs.dtype)  # (G, Tg, E)
        # Position of each token within its expert's capacity buffer.
        pos = torch.cumsum(onehot, dim=1) - 1.0 + fill[:, None, :]
        pos_tok = (pos * onehot).sum(dim=-1)
        keep = pos_tok < cap
        routes.append((eidx, pos_tok.to(torch.int64), keep, gate * keep))
        fill = fill + (onehot * keep[..., None]).sum(dim=1)
        remaining = remaining * (1.0 - onehot)  # mask the chosen expert for the next k
    return routes


def _routed(params, xg, cfg, cap: int, lo: int = 0):
    """The routed experts of (G, Tg, D) token groups: (y (G, Tg, D), the
    router probabilities (G, Tg, E)).  ``params``' expert weights hold the
    experts lo, lo + 1, ... (all E unless a sharded step cut them); a token
    routed to an expert outside them adds nothing to y."""
    ng, group, d = xg.shape
    e = cfg.num_experts
    el = params.w_up.shape[0]
    logits = torch.einsum("gtd,de->gte", xg, params.router).float()
    probs = torch.softmax(logits, dim=-1)  # (G, Tg, E)
    routes = _routes(probs, cfg.moe_top_k, cap)

    # Dispatch: each kept token to its (expert, group, slot) row; dropped
    # tokens, and tokens of experts held elsewhere, go to a spare slot C
    # that is never read.
    rows = torch.arange(ng, device=xg.device)[:, None].expand(ng, group)
    # Per round: (expert index among those held, kept here).  All experts
    # held (no sharded step): the routes as they are, no extra kernels in a
    # decode step.
    locs = []
    for eidx, _, keep, _ in routes:
        if el == e:
            locs.append((eidx, keep))
        else:
            here = (eidx >= lo) & (eidx < lo + el)
            locs.append(((eidx - lo).clamp(0, el - 1), keep & here))
    expert_in = xg.new_zeros((el, ng, cap + 1, d))
    for (_, pos, _, _), (local, kept) in zip(routes, locs):
        expert_in[local, rows, torch.where(kept, pos, cap)] = xg
    expert_in = expert_in[:, :, :cap].reshape(el, ng * cap, d)
    up = torch.bmm(expert_in, params.w_up)
    if hasattr(params, "w_gate"):
        h = _act(cfg.activation, torch.bmm(expert_in, params.w_gate)) * up
    else:
        h = _act(cfg.activation, up)
    out_e = torch.bmm(h, params.w_down).reshape(el, ng, cap, d)

    # Combine: each round's rows back, times its gate (zero when dropped).
    y = torch.zeros_like(xg)
    for (_, pos, _, gate), (local, kept) in zip(routes, locs):
        routed = out_e[local, rows, pos.clamp(max=cap - 1)] * kept[..., None].to(xg.dtype)
        y = y + gate[..., None].to(routed.dtype) * routed
    return y, probs


def moe_forward(params, x, cfg):
    """x: (B, S, D) -> (y, aux)."""
    b, s, d = x.shape
    e = cfg.num_experts
    t_total = b * s
    group = min(cfg.moe_group, t_total)
    if t_total % group:
        raise ValueError(f"token count {t_total} not divisible by moe_group {group}")
    cap = _capacity(group, cfg.moe_top_k, e, cfg.capacity_factor)
    if isinstance(x, DTensor):
        y, aux = _routed_on_shards(params, x, cfg, group, cap)
    else:
        xg = x.reshape(t_total // group, group, d)
        y, probs = _routed(params, xg, cfg, cap)
        y = y.reshape(b, s, d)
        aux = e * torch.sum(_aux_terms(probs, e).prod(dim=0))
    if hasattr(params, "shared"):
        y = y + mlp(params.shared, x, cfg.activation)
    return y.to(x.dtype), aux


def _aux_terms(probs, e: int):
    """(2, E) float32: the share of tokens whose top expert is e (f_e), and
    the mean router probability of e (p_e), over the groups' tokens."""
    top = torch.argmax(probs, dim=-1)
    f_e = (top[..., None] == torch.arange(e, device=probs.device)).float().mean(dim=(0, 1))
    return torch.stack([f_e, probs.mean(dim=(0, 1))])


def _local(t, mesh, placements):
    """This rank's shard of ``t`` on ``placements`` (a plain tensor is the
    whole value, held by every rank)."""
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return (t if tuple(t.placements) == placements else t.redistribute(mesh, placements)).to_local()


def _routed_on_shards(params, x, cfg, group: int, cap: int):
    """The routed experts of a DTensor stream (a sharded serving step) on
    each rank's shards, so that no DTensor reaches the dispatch's and the
    combine's indexing: (y, a DTensor placed as ``rows_over_data`` places
    the stream; aux, the whole batch's).

    The groups are the whole batch's (``group`` and ``cap`` come from the
    global token count): a rank takes whole groups of token rows over the
    data axes when the batch rows and the groups both divide them
    (``row_axes``), else every row, and routes them all.  The experts go
    over ``model`` when their count divides it (the ``ep_tp`` rules'
    ``moe_expert_in``), each rank running its own and adding nothing for a
    token routed elsewhere; the ranks' partial outputs are then summed over
    ``model``.  The llama4 configs route top-1, so each token's routed
    output comes from one expert on one rank and the sum only adds zeros
    to it: exact.  With top-k > 1 a token's k terms may sit on different
    ranks and are summed in another order than the unsharded combine's:
    equal to rounding, not bit for bit."""
    mesh = x.device_mesh
    b, s, d = x.shape
    e = cfg.num_experts
    names = mesh.mesh_dim_names
    rows_on = row_axes(mesh, b, b * s // group)
    split = heads_divide(mesh, e)
    el = e // mesh.size(names.index("model")) if split else e
    lo = mesh.get_local_rank("model") * el if split else 0
    xl = _local(x, mesh, rows_heads(mesh, rows_on, 0, None))
    experts = rows_heads(mesh, [], None, 0 if split else None)
    local = SimpleNamespace(router=_local(params.router, mesh, rows_heads(mesh, [], None, None)),
                            **{k: _local(getattr(params, k), mesh, experts)
                               for k in ("w_up", "w_gate", "w_down") if hasattr(params, k)})
    y, probs = _routed(local, xl.reshape(-1, group, d), cfg, cap, lo)
    shards = prod(mesh.size(names.index(n)) for n in rows_on)
    place = tuple(Partial() if n == "model" and split else Shard(0) if n in rows_on
                  else Replicate() for n in names)
    y = DTensor.from_local(y.reshape(-1, s, d), mesh, place, run_check=False,
                           shape=torch.Size((b, s, d)), stride=(s * d, d, 1))
    # Each rank's means over its rows, over their count: summed over the
    # data axes, the whole batch's means.
    terms = DTensor.from_local(_aux_terms(probs, e) / shards, mesh,
                               tuple(Partial() if n in rows_on else Replicate() for n in names),
                               run_check=False).full_tensor()
    return rows_over_data(y), e * torch.sum(terms.prod(dim=0))
