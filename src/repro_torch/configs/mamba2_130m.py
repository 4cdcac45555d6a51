"""mamba2-130m [ssm]: SSD (state-space duality), attention-free.

24L d_model=768 d_inner=1536 (expand 2) headdim=64 -> 24 SSD heads,
d_state=128, ngroups=1, conv width 4, vocab=50280 [arXiv:2405.21060].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    vocab_size=50_280,
    pattern=("ssd:none",),
    ssd_state=128,
    ssd_headdim=64,
    ssd_expand=2,
    ssd_ngroups=1,
    ssd_chunk=128,
    conv_width=4,
    tie_embeddings=True,
)
