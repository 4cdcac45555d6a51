"""AdamW with optional int8-quantized moments, the counterpart of
``repro.training.optimizer``.

Plain tensor code over trees of tensors (dicts and lists, as the
reference's parameter trees): global-norm clipping, bias correction,
decoupled weight decay and the warmup-then-cosine schedule, with a
float32 master copy only when the weights are in a lower precision, and
int8 moments per row by absmax with the second moment kept in sqrt
space.  The state has the reference's keys (``step``, ``master``, ``m``,
``v``) and, for a model's weights, its stacked layout
(``TransformerParams.to_tree``), so checkpoints cross between the two
packages.

The step count and the learning rate live on the host: ``step`` is a
0-dim int32 CPU tensor, and the schedule and the bias corrections are
float32 scalars computed there, so a step reads nothing back from the
card.  The clipping factor stays a device tensor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.trees import tree_leaves, tree_map, tree_map_n

__all__ = ["OptimizerConfig", "init_opt_state", "adamw_step", "learning_rate", "tree_map",
           "tree_map_n", "tree_leaves"]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    grad_clip: float = 1.0
    quantize_moments: bool = False
    master_dtype: Any = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def learning_rate(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio: a 0-dim float32 CPU
    tensor, computed in float32 as the reference computes it."""
    step = torch.as_tensor(step).to(device="cpu", dtype=torch.float32)
    warm = torch.minimum(step / max(cfg.warmup_steps, 1), _f32(1.0))
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(_f32(math.pi) * t))
    decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.learning_rate * warm * decay


# ----------------------------------------------------------- int8 moments


def _quant(x):
    """Per-row (last-dim) absmax int8 quantization.  Returns (q, scale)."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = absmax.clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _dequant(q, scale):
    return q.float() * scale


def _moment_zeros(p, quantized: bool):
    if not quantized:
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {
        "q": torch.zeros(p.shape, dtype=torch.int8, device=p.device),
        "scale": torch.zeros(p.shape[:-1] + (1,), dtype=torch.float32, device=p.device),
    }


def _moment_read(m, quantized: bool, sqrt_space: bool = False):
    if not quantized:
        return m
    x = _dequant(m["q"], m["scale"])
    return x * x if sqrt_space else x


def _moment_write(x, quantized: bool, sqrt_space: bool = False):
    """``sqrt_space`` stores sqrt(x) (x >= 0): the second moment's dynamic
    range is huge and the update divides by sqrt(v), so quantizing in
    sqrt-space is what keeps int8 Adam on the fp32 trajectory."""
    if not quantized:
        return x
    q, scale = _quant(torch.sqrt(x.clamp_min(0.0)) if sqrt_space else x)
    return {"q": q, "scale": scale}


# ----------------------------------------------------------- state / step


def init_opt_state(params, cfg: OptimizerConfig) -> dict:
    """The state of a tree of weights.  The master copy exists only when a
    weight is in another type than ``master_dtype``: otherwise it would be
    the weights themselves."""
    q = cfg.quantize_moments
    needs_master = any(x.dtype != cfg.master_dtype for x in tree_leaves(params))
    return {
        "step": torch.zeros((), dtype=torch.int32),
        "master": (tree_map(lambda p: p.detach().to(cfg.master_dtype, copy=True), params)
                   if needs_master else None),
        "m": tree_map(lambda p: _moment_zeros(p, q), params),
        "v": tree_map(lambda p: _moment_zeros(p, q), params),
    }


def _global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def adamw_step(grads, opt_state, params, cfg: OptimizerConfig):
    """One AdamW update.  Returns (new_params, new_opt_state, metrics)."""
    q = cfg.quantize_moments
    step = torch.as_tensor(opt_state["step"]).cpu().to(torch.int32) + 1
    lr = float(learning_rate(cfg, step))

    gnorm = _global_norm(grads)
    clip = (torch.clamp(cfg.grad_clip / gnorm.clamp_min(1e-12), max=1.0)
            if cfg.grad_clip > 0 else 1.0)

    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = float(1.0 - _f32(b1) ** stepf)
    bc2 = float(1.0 - _f32(b2) ** stepf)

    def upd(g, m, v, master):
        g = g.float() * clip
        m_f = _moment_read(m, q)
        v_f = _moment_read(v, q, sqrt_space=True)
        m_new = b1 * m_f + (1.0 - b1) * g
        v_new = b2 * v_f + (1.0 - b2) * g * g
        update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        master_f = master.float()
        master_new = master_f - lr * (update + cfg.weight_decay * master_f)
        return (_moment_write(m_new, q), _moment_write(v_new, q, sqrt_space=True),
                master_new.to(cfg.master_dtype))

    has_master = opt_state["master"] is not None
    masters_in = opt_state["master"] if has_master else params
    new_m, new_v, masters = tree_map_n(upd, 3, grads, opt_state["m"], opt_state["v"],
                                       masters_in)
    new_state = {
        "step": step,
        "master": masters if has_master else None,
        "m": new_m,
        "v": new_v,
    }
    param_dtype = tree_leaves(params)[0].dtype
    new_params = tree_map(lambda ma: ma.to(param_dtype), masters)
    return new_params, new_state, {"lr": lr, "grad_norm": gnorm}
