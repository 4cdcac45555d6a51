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
"""
from __future__ import annotations

import torch

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


def moe_forward(params, x, cfg):
    """x: (B, S, D) -> (y, aux)."""
    b, s, d = x.shape
    e = cfg.num_experts
    tokens = x.reshape(-1, d)
    t_total = tokens.shape[0]
    group = min(cfg.moe_group, t_total)
    if t_total % group:
        raise ValueError(f"token count {t_total} not divisible by moe_group {group}")
    ng = t_total // group
    xg = tokens.reshape(ng, group, d)

    logits = torch.einsum("gtd,de->gte", xg, params.router).float()
    probs = torch.softmax(logits, dim=-1)  # (G, Tg, E)
    cap = _capacity(group, cfg.moe_top_k, e, cfg.capacity_factor)
    routes = _routes(probs, cfg.moe_top_k, cap)

    # Dispatch: each kept token to its (expert, group, slot) row; dropped
    # tokens go to a spare slot C that is never read.
    rows = torch.arange(ng, device=x.device)[:, None].expand(ng, group)
    expert_in = x.new_zeros((e, ng, cap + 1, d))
    for eidx, pos, keep, _ in routes:
        expert_in[eidx, rows, torch.where(keep, pos, cap)] = xg
    expert_in = expert_in[:, :, :cap].reshape(e, ng * cap, d)
    up = torch.bmm(expert_in, params.w_up)
    if hasattr(params, "w_gate"):
        h = _act(cfg.activation, torch.bmm(expert_in, params.w_gate)) * up
    else:
        h = _act(cfg.activation, up)
    out_e = torch.bmm(h, params.w_down).reshape(e, ng, cap, d)

    # Combine: each round's rows back, times its gate (zero when dropped).
    y = torch.zeros_like(xg)
    for eidx, pos, keep, gate in routes:
        routed = out_e[eidx, rows, pos.clamp(max=cap - 1)] * keep[..., None].to(x.dtype)
        y = y + gate[..., None].to(routed.dtype) * routed

    # Switch aux loss (per-token mean): E * sum_e f_e * p_e.
    top = torch.argmax(probs, dim=-1)
    f_e = (top[..., None] == torch.arange(e, device=x.device)).float().mean(dim=(0, 1))
    aux = e * torch.sum(f_e * probs.mean(dim=(0, 1)))

    if hasattr(params, "shared"):
        y = y + mlp(params.shared, xg, cfg.activation)
    return y.reshape(b, s, d).to(x.dtype), aux
