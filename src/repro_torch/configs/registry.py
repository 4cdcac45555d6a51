"""Architecture registry of the port: the configs its models can run.

The JAX package's registry (``configs/registry.py``) holds ten
architectures; the port's models run the dense ``attn:mlp`` kind and
the Mamba-2 ``ssd:none`` kind, so it registers tinyllama-1.1b and
mamba2-130m.  The others join as their mixers are ported (ROADMAP
"Modules to port", items 8 and 9).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.mamba2_130m import CONFIG as _mamba2
from repro_torch.configs.tinyllama_1_1b import CONFIG as _tinyllama

__all__ = ["ARCHS", "get_config"]

ARCHS: dict[str, ModelConfig] = {c.name: c for c in (_mamba2, _tinyllama)}


def get_config(name: str) -> ModelConfig:
    """The registered config called ``name``."""
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port runs {sorted(ARCHS)}")
    return ARCHS[name]
