"""Architecture registry of the port: ``--arch <id>`` -> ``ModelConfig``.

The JAX package's ten architectures (``configs/registry.py``), with its
``ALIASES``: the attention and SSD families, the Griffin hybrid
recurrentgemma-9b (``rglru`` mixers) and the llama4 MoE models (``moe``
FFNs).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.chameleon_34b import CONFIG as _chameleon
from repro_torch.configs.gemma3_4b import CONFIG as _gemma3
from repro_torch.configs.gemma_7b import CONFIG as _gemma7b
from repro_torch.configs.granite_8b import CONFIG as _granite
from repro_torch.configs.llama4_maverick_400b_128e import CONFIG as _maverick
from repro_torch.configs.llama4_scout_17b_16e import CONFIG as _scout
from repro_torch.configs.mamba2_130m import CONFIG as _mamba2
from repro_torch.configs.musicgen_medium import CONFIG as _musicgen
from repro_torch.configs.recurrentgemma_9b import CONFIG as _rgemma
from repro_torch.configs.tinyllama_1_1b import CONFIG as _tinyllama

__all__ = ["ARCHS", "ALIASES", "get_config"]

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in (
        _musicgen,
        _tinyllama,
        _gemma7b,
        _gemma3,
        _granite,
        _scout,
        _maverick,
        _rgemma,
        _mamba2,
        _chameleon,
    )
}

# Aliases matching the assignment table verbatim.
ALIASES = {
    "musicgen-medium": "musicgen-medium",
    "tinyllama-1.1b": "tinyllama-1.1b",
    "gemma-7b": "gemma-7b",
    "gemma3-4b": "gemma3-4b",
    "granite-8b": "granite-8b",
    "llama4-scout-17b-a16e": "llama4-scout-17b-16e",
    "llama4-maverick-400b-a17b": "llama4-maverick-400b-128e",
    "recurrentgemma-9b": "recurrentgemma-9b",
    "mamba2-130m": "mamba2-130m",
    "chameleon-34b": "chameleon-34b",
}


def get_config(name: str) -> ModelConfig:
    """The registered config called ``name`` or one of its ``ALIASES``."""
    key = ALIASES.get(name, name)
    if key not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[key]
