"""Analytic per-device HBM-traffic model (the roofline memory term), the
counterpart of ``repro.launch.memmodel``.

The dry run's traced bytes (``launch.hlo_analysis.StepTrace``) count what
the step allocates, not what it reads and writes, and the reference's
XLA ``bytes accessed`` sums every op's operands before fusion; the
roofline memory term instead uses this minimal-traffic model, the
reference's, with the same arithmetic in the same order.

Components (per device, per step), mode-aware (see policies.default_mode):

  train "fsdp":    weights are all-gathered per layer, so each device
                   READS the full weight set 3x (fwd, remat recompute,
                   bwd) + optimizer r/w on its 1/ndev shard + fp32 grad
                   w+r + period-boundary activation checkpoints + chunked
                   xent logits (w+r, fwd + recompute).
  train "ep_fsdp": expert weights stay sharded (each device reads its
                   E/tp x F/dp shard 3x); non-expert weights as fsdp.
  serve "tp":      1x TP-local weight read + cache traffic + activations.
  serve "ep_tp":   1x (expert-local + dense TP-local) weight read + cache.

Tokens-per-device: batch over the widest divisible data split (whole
mesh under fsdp, data axis otherwise); sequences are not sharded by the
baseline policies.  ``mesh`` is a ``DeviceMesh``, a ``{axis: size}``
dict, or any object with the reference's ``shape`` mapping and
``axis_names``.
"""
from __future__ import annotations

import math

from repro_torch.distributed.policies import default_mode
from repro_torch.distributed.sharding import mesh_sizes
from repro_torch.models.kvcache import cache_bytes

__all__ = ["analytic_hbm_bytes", "roofline_fraction_for"]


def _sizes(mesh) -> dict[str, int]:
    return dict(mesh) if isinstance(mesh, dict) else mesh_sizes(mesh)


def _expert_params(cfg) -> int:
    if not cfg.num_experts:
        return 0
    mats = 3 if cfg.activation in ("swiglu", "geglu") else 2
    n_moe_layers = sum(1 for i in range(cfg.num_layers) if cfg.layer_kind(i).endswith("moe"))
    return n_moe_layers * cfg.num_experts * mats * cfg.d_model * cfg.moe_d_ff


def analytic_hbm_bytes(cfg, shape, mesh, opt_quantized: bool = False,
                       mode: str | None = None) -> dict:
    mode = mode or default_mode(cfg, shape.step)
    sizes = _sizes(mesh)
    ndev = int(math.prod(sizes.values()))
    tp = int(sizes["model"])
    dp = ndev // tp
    b, s = shape.global_batch, shape.seq_len
    s_eff = 1 if shape.step == "decode" else s
    if mode in ("fsdp", "ep_fsdp") and b % ndev == 0:
        tok = b * s_eff / ndev
        b_dev = b / ndev
    elif b % dp == 0:
        tok = b * s_eff / dp
        b_dev = b / dp
    else:
        tok = float(b * s_eff)
        b_dev = float(b)

    p_total = cfg.param_count()
    p_exp = _expert_params(cfg)
    p_dense = p_total - p_exp
    d = cfg.d_model
    vocab_local = cfg.vocab_size / tp if cfg.vocab_size % tp == 0 else cfg.vocab_size

    comp = {}
    if shape.step == "train":
        # fsdp: full gathered weights read per pass; expert tensors keep
        # their model-axis (EP) shard and only gather over data.
        comp["weights_read"] = 3.0 * (2.0 * p_dense + 2.0 * p_exp / tp)
        per_param_opt = (4 + 1 + 1) * 2 + 4 if opt_quantized else (4 + 4 + 4) * 2 + 4
        comp["optimizer_rw"] = per_param_opt * p_total / ndev
        comp["grad_rw"] = 2 * 4.0 * p_total / ndev
        comp["act_checkpoints"] = 2.0 * (cfg.num_layers / cfg.period) * tok * d * 2
        comp["xent_logits"] = 2.0 * 2 * tok * vocab_local * 4
    elif shape.step == "prefill":
        w_local = 2.0 * (p_dense / tp + p_exp / ndev) if mode == "ep_tp" else 2.0 * p_total / tp
        comp["weights_read"] = w_local
        comp["kv_write"] = cache_bytes(cfg, b, s) / ndev
        comp["activations"] = 2.0 * cfg.num_layers * tok * d * 2
        comp["logits"] = b_dev * vocab_local * 4
    else:  # decode
        p_active = cfg.active_param_count()
        p_active_exp = p_exp * cfg.moe_top_k / max(cfg.num_experts, 1)
        if mode == "ep_tp":
            # every expert shard streams whichever experts its tokens hit;
            # lower bound: active expert bytes spread over the mesh
            comp["weights_read"] = 2.0 * ((p_active - p_active_exp) / tp + p_exp / ndev)
        else:
            comp["weights_read"] = 2.0 * p_active / tp
        cb = cache_bytes(cfg, b, s)
        comp["cache_read"] = cb / ndev
        comp["cache_write"] = (2.0 * b * cfg.num_layers * max(cfg.num_kv_heads, 1)
                               * max(cfg.head_dim, 1) * 2 / ndev)
        comp["activations"] = 2.0 * cfg.num_layers * tok * d * 2
        comp["logits"] = b_dev * vocab_local * 4
    comp["total"] = float(sum(comp.values()))
    comp["mode"] = mode
    return comp


def roofline_fraction_for(step: str, t_compute: float, t_memory: float, t_collective: float,
                          useful_flops_frac: float = 1.0) -> dict:
    """Step-aware roofline score.

    train/prefill: useful work is compute — frac = (useful FLOP time)/t_max.
    decode:        useful work is weight+cache streaming — frac = t_memory/t_max.
    """
    t_max = max(t_compute, t_memory, t_collective, 1e-12)
    bound = max(
        ("compute", t_compute), ("memory", t_memory), ("collective", t_collective),
        key=lambda kv: kv[1],
    )[0]
    if step == "decode":
        frac = t_memory / t_max
    else:
        frac = (t_compute * min(useful_flops_frac, 1.0)) / t_max
    return {"bound": bound, "t_max_s": t_max, "roofline_fraction": frac}
