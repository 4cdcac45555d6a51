"""recurrentgemma-9b [hybrid]: Griffin — RG-LRU + local attention, 2:1.

38L d_model=4096 16H (MQA kv=1, head_dim=256) d_ff=12288 vocab=256000
[arXiv:2402.19427].  Pattern period 3 = (rglru, rglru, local-attn),
window 2048; 38 = 12 periods + 2 rglru tail layers.  GeGLU, sqrt(d)
embedding scale, logit softcap 30 (RecurrentGemma conventions).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    vocab_size=256_000,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    activation="geglu",
    pattern=("rglru:mlp", "rglru:mlp", "local:mlp"),
    window_size=2048,
    lru_width=4096,
    embed_scale=True,
    logit_softcap=30.0,
    tie_embeddings=True,
)
