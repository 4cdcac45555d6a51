"""Model configurations of the port (``configs.base.ModelConfig``)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCHS, get_config

__all__ = ["ARCHS", "ModelConfig", "get_config"]
