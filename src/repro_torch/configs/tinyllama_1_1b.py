"""tinyllama-1.1b [dense]: llama2-arch small model.

22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000 [arXiv:2401.02385].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    num_layers=22,
    d_model=2048,
    vocab_size=32_000,
    num_heads=32,
    num_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    activation="swiglu",
    pattern=("attn:mlp",),
    tie_embeddings=False,
)
