"""musicgen-medium [audio]: decoder-only LM over EnCodec tokens.

48L d_model=1536 24H (MHA, kv=24) d_ff=6144 vocab=2048 [arXiv:2306.05284].
The EnCodec frontend is a stub per the assignment: inputs are precomputed
codec token ids in the backbone vocab.  Non-gated GELU MLP; RoPE replaces
the original sinusoidal embedding (positional backbone of this framework,
as in the JAX package's copy of this config).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    vocab_size=2048,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    activation="gelu",
    pattern=("attn:mlp",),
    tie_embeddings=True,
)
