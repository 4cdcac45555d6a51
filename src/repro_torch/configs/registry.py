"""Architecture registry of the port: the configs its models can run.

The JAX package's registry (``configs/registry.py``) holds ten
architectures; the port's models run global and sliding-window
attention with dense MLPs (``attn:mlp``, ``local:mlp``) and the Mamba-2
``ssd:none`` kind, so it registers the seven configs made of those:
musicgen-medium, tinyllama-1.1b, gemma-7b, gemma3-4b, granite-8b,
mamba2-130m and chameleon-34b.  The other three (the llama4 MoE models
and recurrentgemma-9b) join as their mixers are ported (ROADMAP
"Modules to port", item 9).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.chameleon_34b import CONFIG as _chameleon
from repro_torch.configs.gemma3_4b import CONFIG as _gemma3
from repro_torch.configs.gemma_7b import CONFIG as _gemma7b
from repro_torch.configs.granite_8b import CONFIG as _granite
from repro_torch.configs.mamba2_130m import CONFIG as _mamba2
from repro_torch.configs.musicgen_medium import CONFIG as _musicgen
from repro_torch.configs.tinyllama_1_1b import CONFIG as _tinyllama

__all__ = ["ARCHS", "get_config"]

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in (_musicgen, _tinyllama, _gemma7b, _gemma3, _granite, _mamba2, _chameleon)
}


def get_config(name: str) -> ModelConfig:
    """The registered config called ``name``."""
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port runs {sorted(ARCHS)}")
    return ARCHS[name]
