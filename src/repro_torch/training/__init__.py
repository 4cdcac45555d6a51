"""Training of the port: AdamW, checkpoints, gradient compression and the
fault-tolerant trainer, the counterpart of ``repro.training``."""
from repro_torch.training import checkpoint
from repro_torch.training.compression import (
    compressed_psum_tree,
    dequantize8,
    init_error_feedback,
    quantize8,
)
from repro_torch.training.optimizer import (
    OptimizerConfig,
    adamw_step,
    init_opt_state,
    learning_rate,
)
from repro_torch.training.trainer import Trainer, TrainerConfig

__all__ = [
    "OptimizerConfig", "adamw_step", "init_opt_state", "learning_rate",
    "checkpoint", "compressed_psum_tree", "init_error_feedback", "quantize8", "dequantize8",
    "Trainer", "TrainerConfig",
]
