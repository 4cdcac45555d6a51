"""llama4-maverick-400b-a17b [moe]: 128 experts, top-1, dense:MoE 1:1.

48L d_model=5120 40H (GQA kv=8) expert d_ff=8192 vocab=202048.
MoE every other layer (dense interleave d_ff=16384) + shared expert —
the combination that yields ~400B total / ~17B active params
[hf:meta-llama/Llama-4-Maverick-17B-128E].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-128e",
    family="moe",
    num_layers=48,
    d_model=5120,
    vocab_size=202_048,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    dense_d_ff=16384,
    activation="swiglu",
    pattern=("attn:mlp", "attn:moe"),
    num_experts=128,
    moe_top_k=1,
    moe_d_ff=8192,
    shared_expert=True,
    tie_embeddings=False,
)
