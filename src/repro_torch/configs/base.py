"""ModelConfig of the port: a copy of the JAX package's ``configs/base.py``.

One dataclass covering every architecture family of the reference, so
that ``param_count`` (and through it ``serving.backends.weight_bytes``,
which sizes the ``SwapManager``) gives the reference's numbers.  Layer
patterns are repeating periods of "mixer:ffn" strings: mixer in {attn,
local, rglru, ssd}, ffn in {mlp, moe, none}, every one of which the
port's models run (``models/blocks.py``).
"""
from __future__ import annotations

import dataclasses

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    vocab_size: int
    # attention
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_theta_local: float = 10_000.0
    window_size: int = 0
    # mlp
    d_ff: int = 0
    activation: str = "swiglu"  # swiglu | geglu | gelu (non-gated)
    post_norms: bool = False  # gemma3-style post-attn/post-ffn norms
    # layer pattern (repeating period)
    pattern: tuple[str, ...] = ("attn:mlp",)
    # embeddings / logits
    embed_scale: bool = False
    logit_softcap: float = 0.0
    tie_embeddings: bool = True
    # MoE
    num_experts: int = 0
    moe_top_k: int = 1
    moe_d_ff: int = 0
    dense_d_ff: int = 0  # d_ff of the dense interleave layers (defaults to d_ff)
    shared_expert: bool = False
    capacity_factor: float = 1.25
    moe_group: int = 512  # GShard token-group size for dispatch
    # SSD (mamba-2)
    ssd_state: int = 0
    ssd_headdim: int = 64
    ssd_expand: int = 2
    ssd_ngroups: int = 1
    ssd_chunk: int = 128
    conv_width: int = 4
    # RG-LRU (griffin)
    lru_width: int = 0
    # compute knobs
    kv_quant: bool = False  # int8 KV cache (per-position absmax scales)
    xent_chunk: int = 512  # sequence-chunked cross-entropy (memory bound)
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    remat: bool = True
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads and not self.num_kv_heads:
            object.__setattr__(self, "num_kv_heads", self.num_heads)
        if self.num_experts and not self.moe_d_ff:
            object.__setattr__(self, "moe_d_ff", self.d_ff)
        if not self.dense_d_ff:
            object.__setattr__(self, "dense_d_ff", self.d_ff)
        for p in self.pattern:
            mixer, _, ffn = p.partition(":")
            if mixer not in ("attn", "local", "rglru", "ssd") or ffn not in ("mlp", "moe", "none"):
                raise ValueError(f"bad pattern entry {p!r}")
        if any("moe" in p for p in self.pattern) and not self.num_experts:
            raise ValueError("moe pattern requires num_experts")

    # ---------------------------------------------------------- structure

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def n_periods(self) -> int:
        return self.num_layers // self.period

    @property
    def n_tail(self) -> int:
        return self.num_layers - self.n_periods * self.period

    def layer_kind(self, i: int) -> str:
        return self.pattern[i % self.period]

    @property
    def d_inner(self) -> int:  # ssd
        return self.ssd_expand * self.d_model

    @property
    def ssd_heads(self) -> int:
        return self.d_inner // self.ssd_headdim

    @property
    def uses_full_attention(self) -> bool:
        """True when any layer is unbounded-context softmax attention."""
        return any(p.startswith("attn") for p in self.pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True when context cost per token is bounded (SSM/recurrent/local-only)."""
        return not self.uses_full_attention

    # ---------------------------------------------------------- accounting

    def _layer_params(self, kind: str) -> int:
        mixer, _, ffn = kind.partition(":")
        n = 0
        d = self.d_model
        if mixer in ("attn", "local"):
            n += d * self.head_dim * (self.num_heads * 2 + self.num_kv_heads * 2)
        elif mixer == "rglru":
            lru = self.lru_width
            n += 2 * d * lru + lru * d  # two in-branches + out
            n += self.conv_width * lru + 4 * lru  # conv + gates/Lambda
        elif mixer == "ssd":
            din, g, ns, h = self.d_inner, self.ssd_ngroups, self.ssd_state, self.ssd_heads
            d_xbc = din + 2 * g * ns
            n += d * (2 * din + 2 * g * ns + h)  # in_proj (z, xBC, dt)
            n += self.conv_width * d_xbc + 3 * h + din  # conv, A/D/dt_bias, norm
            n += din * d  # out_proj
        if ffn == "mlp":
            ff = self.dense_d_ff
            mats = 3 if self.activation in ("swiglu", "geglu") else 2
            n += mats * d * ff
        elif ffn == "moe":
            mats = 3 if self.activation in ("swiglu", "geglu") else 2
            n += d * self.num_experts  # router
            n += self.num_experts * mats * d * self.moe_d_ff
            if self.shared_expert:
                n += mats * d * self.moe_d_ff
        return n

    def param_count(self) -> int:
        n = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            n *= 2
        for i in range(self.num_layers):
            n += self._layer_params(self.layer_kind(i))
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts + shared)."""
        n = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        mats = 3 if self.activation in ("swiglu", "geglu") else 2
        for i in range(self.num_layers):
            kind = self.layer_kind(i)
            mixer, _, ffn = kind.partition(":")
            n += self._layer_params(f"{mixer}:none")
            if ffn == "mlp":
                n += mats * self.d_model * self.dense_d_ff
            elif ffn == "moe":
                n += self.d_model * self.num_experts
                n += self.moe_top_k * mats * self.d_model * self.moe_d_ff
                if self.shared_expert:
                    n += mats * self.d_model * self.moe_d_ff
        return n

    def model_flops_per_token(self) -> float:
        """6 * N_active (the standard dense/MoE training-FLOPs model)."""
        return 6.0 * self.active_param_count()

    # ---------------------------------------------------------- reduction

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        period = self.period
        layers = period * 2 + min(self.n_tail, 1)
        return dataclasses.replace(
            self,
            name=f"{self.name}-reduced",
            num_layers=max(2, layers),
            d_model=64,
            vocab_size=128,
            num_heads=4 if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=16 if self.num_heads else 0,
            d_ff=128 if self.d_ff else 0,
            dense_d_ff=128 if self.dense_d_ff else 0,
            moe_d_ff=128 if self.num_experts else 0,
            num_experts=min(self.num_experts, 4),
            moe_group=16,
            # Drop-free capacity: C >= group * top_k, so prefill/decode match
            # the full forward exactly (capacity dropping is group-boundary
            # dependent and intentionally lossy in the full configs).
            capacity_factor=float(max(self.num_experts, 1)),
            window_size=16 if self.window_size else 0,
            ssd_state=16 if self.ssd_state else 0,
            ssd_headdim=8,
            ssd_chunk=8,
            lru_width=64 if self.lru_width else 0,
            attn_q_chunk=16,
            attn_kv_chunk=16,
            dtype="float32",
            remat=False,
        )
