"""Model configurations of the port (``configs.base.ModelConfig``) and
the assigned input shapes (``configs.shapes``)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ALIASES, ARCHS, get_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec, cell_supported

__all__ = ["ALIASES", "ARCHS", "SHAPES", "ModelConfig", "ShapeSpec", "cell_supported",
           "get_config"]
