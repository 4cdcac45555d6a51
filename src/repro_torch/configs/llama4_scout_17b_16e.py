"""llama4-scout-17b-a16e [moe]: 16 experts, top-1 routing + shared expert.

48L d_model=5120 40H (GQA kv=8) d_ff=8192(expert) vocab=202048
[hf:meta-llama/Llama-4-Scout-17B-16E].  MoE on every layer; shared expert
in parallel with the routed one (what makes the 17B-active / ~109B-total
arithmetic work — see DESIGN.md).  Early-fusion frontend stubbed.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    vocab_size=202_048,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    activation="swiglu",
    pattern=("attn:moe",),
    num_experts=16,
    moe_top_k=1,
    moe_d_ff=8192,
    shared_expert=True,
    tie_embeddings=False,
)
