"""Model configurations of the port (``configs.base.ModelConfig``)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ALIASES, ARCHS, get_config

__all__ = ["ALIASES", "ARCHS", "ModelConfig", "get_config"]
