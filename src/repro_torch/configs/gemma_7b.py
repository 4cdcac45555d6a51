"""gemma-7b [dense]: GeGLU, explicit head_dim=256, MHA (kv=16).

28L d_model=3072 16H d_ff=24576 vocab=256000 [arXiv:2403.08295].
Gemma scales embeddings by sqrt(d_model) and ties the readout.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    vocab_size=256_000,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    activation="geglu",
    pattern=("attn:mlp",),
    embed_scale=True,
    tie_embeddings=True,
)
