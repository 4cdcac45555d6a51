"""granite-8b [dense]: llama-arch code model.

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152 [arXiv:2405.04324].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    vocab_size=49_152,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    activation="swiglu",
    pattern=("attn:mlp",),
    tie_embeddings=True,
)
