"""gemma3-4b [dense]: 5:1 local:global attention, 128k context.

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144
[hf:google/gemma-3-4b-pt].  QK-norm, head_dim=256, sliding window 1024,
local RoPE theta 10k / global 1M, post-norms, sqrt(d) embedding scale.
34 = 5 full periods of (5 local + 1 global) + 4 local remainder layers.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    vocab_size=262_144,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    activation="geglu",
    pattern=("local:mlp",) * 5 + ("attn:mlp",),
    window_size=1024,
    qk_norm=True,
    post_norms=True,
    rope_theta=1_000_000.0,
    rope_theta_local=10_000.0,
    embed_scale=True,
    tie_embeddings=True,
)
