"""Per-(arch, step) sharding policies over the production mesh, the
counterpart of ``repro.distributed.policies`` (the same rule sets, as
data).

Mode selection (the baseline; §Perf hillclimbs override via ``mode=``):

  train, dense/ssm/hybrid  -> "fsdp"    pure ZeRO-3: batch over the whole
      mesh, every weight sharded on its embed dim over (data x model) [or
      vocab over model], weights all-gathered per layer as it runs,
      grads reduce-scattered.  At 4k tokens/device this is near the
      compute/comm balance point for every dense arch; Megatron-style TP
      at degree 16 is collective-bound for d_model <= 8k (napkin math in
      EXPERIMENTS.md §Perf) — measured, not assumed.
  train, moe               -> "ep_fsdp" experts over model (EP), expert
      ffn dim over data (so expert weights shard 256-way for optimizer
      state without per-layer weight gathers — the combine emits small
      token-sized all-reduces instead), everything else FSDP.
  serve (prefill/decode)   -> "tp"      weights TP over model, replicated
      over data; batch over data; KV cache (batch -> data, seq -> model)
      giving split-KV flash-decode.
  serve, moe               -> "ep_tp"   experts over model; expert embed
      dim over data (big-MoE weights don't fit replicated); dense
      interleave layers 2-D sharded (model x data).

Ordered candidate lists + the per-spec "axis already used" rule resolve
conflicts mechanically: e.g. with ``embed: ["model", "data"]`` attention
weights take model, while expert tensors (whose expert dim already took
model) fall through to data.
"""
from __future__ import annotations

from repro_torch.distributed.sharding import ShardingPolicy, mesh_sizes

__all__ = ["make_policy", "dp_axes", "default_mode"]


def dp_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh_sizes(mesh) else ("data",)


def default_mode(cfg, step: str) -> str:
    if step == "train":
        return "ep_fsdp" if cfg.num_experts else "fsdp"
    return "ep_tp" if cfg.num_experts else "tp"


def make_policy(cfg, step: str, mesh, mode: str | None = None) -> ShardingPolicy:
    mode = mode or default_mode(cfg, step)
    dp = dp_axes(mesh)
    dp_tuple = dp if len(dp) > 1 else dp[0]
    dpm = tuple(dp) + ("model",)  # the full mesh as one data-parallel axis

    # widest divisible split wins; on the multi-pod mesh a 256 batch can't
    # fold over all 512 chips, so ("data","model") keeps 4k tokens/device
    # and leaves the pod axis as a pure ZeRO/grad-reduce dimension
    # (iteration 8, EXPERIMENTS §Perf).
    batch_full = [dpm, ("data", "model"), dp_tuple, "data"]
    batch_dp = [dp_tuple, "data"]

    if mode == "ep_fsdp":
        # The fsdp rule set already resolves MoE tensors correctly via the
        # ordered candidates (experts take model; embed falls through to
        # data), and full-mesh batch keeps tokens/device at 4k.  Kept as a
        # named mode for reporting/hillclimb clarity.
        mode = "fsdp"
    if mode == "fsdp":
        param_rules = {
            "vocab": ["model"],
            "embed": [dpm, dp_tuple],
            "ffn": [], "heads": [], "kv_heads": [], "head_dim": [],
            "experts": ["model"],
            "lru": [dpm, dp_tuple],
            "ssd_inner": [], "ssd_heads": [], "ssd_state": [],
            "conv": [], "layers": [],
        }
        act_rules = {
            "act_btd": (batch_full, None, None),
            "act_ffn": (batch_full, None, None),
            "act_heads": (batch_full, None, None, None),
            "act_kv_heads": (batch_full, None, None, None),
            "act_lru": (batch_full, None, None),
            "ssd_x": (batch_full, None, None, None),
            "moe_tokens": (batch_full, None, None),
            "moe_expert_in": ("model", batch_dp, None, None),
            "moe_expert_ffn": ("model", batch_dp, None, None),
            "moe_tokens_row": ("data", None, None),
            "moe_dispatch": ("data", None, None, None),
            # xent runs batch-over-data x vocab-over-model: the only layout
            # where the chunked logits einsum needs no giant re-gathers.
            "xent_act": ("data", None, None),
            "logits": ("data", None, "model"),
        }
    elif mode == "tp":
        param_rules = {
            "vocab": ["model"],
            "embed": [],
            "ffn": ["model"],
            "heads": ["model"], "kv_heads": ["model"], "head_dim": [],
            "experts": ["model"],
            "lru": ["model"],
            "ssd_inner": [], "ssd_heads": ["model"], "ssd_state": [],
            "conv": [], "layers": [],
        }
        act_rules = {
            "act_btd": (batch_dp, None, None),
            "act_ffn": (batch_dp, None, "model"),
            # heads-TP when divisible; otherwise shard the QUERY sequence
            # over model (KV gathered per layer) instead of replicating the
            # whole attention 16x (iteration 5, EXPERIMENTS §Perf).
            "act_heads": [("data", None, "model", None), ("data", "model", None, None)]
            if step != "decode" else (batch_dp, None, ["model"], None),
            "act_kv_heads": (batch_dp, None, ["model"], None),
            "act_lru": (batch_dp, None, "model"),
            "ssd_x": (batch_dp, None, None, None),
            "moe_tokens": (batch_dp, None, None),
            "moe_expert_in": ("model", batch_dp, None, None),
            "moe_expert_ffn": ("model", batch_dp, None, None),
            "moe_tokens_row": ("data", None, None),
            "moe_dispatch": ("data", None, None, None),
            "logits": (batch_dp, "model") if step == "decode" else (batch_dp, None, "model"),
            "kv_cache": (batch_dp, "model", None, None),
        }
    elif mode == "ep_tp":
        param_rules = {
            "vocab": ["model"],
            "embed": ["model", "data"],  # attn -> model; expert D -> data
            "ffn": ["model", "data"],  # dense interleave 2-D; expert F falls to data? (D took data)
            "heads": ["model"], "kv_heads": ["model"], "head_dim": [],
            "experts": ["model"],
            "lru": [], "ssd_inner": [], "ssd_heads": [], "ssd_state": [],
            "conv": [], "layers": [],
        }
        act_rules = {
            "act_btd": (batch_dp, None, None),
            "act_ffn": (batch_dp, None, None),
            "act_heads": [("data", None, "model", None), ("data", "model", None, None)]
            if step != "decode" else (batch_dp, None, ["model"], None),
            "act_kv_heads": (batch_dp, None, ["model"], None),
            "act_lru": (batch_dp, None, None),
            "ssd_x": (batch_dp, None, None, None),
            "moe_tokens": (batch_dp, None, None),
            "moe_expert_in": ("model", batch_dp, None, None),
            "moe_expert_ffn": ("model", batch_dp, None, None),
            "moe_tokens_row": ("data", None, None),
            "moe_dispatch": ("data", None, None, None),
            "logits": (batch_dp, "model") if step == "decode" else (batch_dp, None, "model"),
            "kv_cache": (batch_dp, "model", None, None),
        }
    else:
        raise ValueError(f"unknown sharding mode {mode!r}")
    return ShardingPolicy(param_rules=param_rules, act_rules=act_rules)
