"""chameleon-34b [vlm]: early-fusion mixed-modal LM over VQ image tokens.

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536 (text + VQ codes)
[arXiv:2405.09818].  QK-norm (chameleon's training-stability fix).  The
VQ-VAE image tokenizer frontend is a stub per the assignment: inputs are
precomputed token ids.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    vocab_size=65_536,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    activation="swiglu",
    pattern=("attn:mlp",),
    qk_norm=True,
    tie_embeddings=False,
)
