"""Assigned input shapes and per-(arch x shape) cell definitions, the
counterpart of ``repro.configs.shapes``.

LM shapes are seq_len x global_batch.  ``decode_*``/``long_*`` are the
serve step (one new token against a seq_len KV cache); ``prefill_*`` the
prefill serve step; ``train_*`` the train step.  ``long_500k`` requires
sub-quadratic context handling and is skipped for pure full-attention
archs (recorded, not silently dropped).
"""
from __future__ import annotations

import dataclasses

__all__ = ["ShapeSpec", "SHAPES", "cell_supported"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    step: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# Archs allowed to run long_500k: bounded-context layers only (SSM /
# recurrent / local attention), or hybrids whose global layers decode O(S)
# against a sequence-sharded cache (gemma3's 5:1 local:global).
_LONG_OK = {"mamba2-130m", "recurrentgemma-9b", "gemma3-4b"}


def cell_supported(arch_name: str, shape_name: str) -> tuple[bool, str]:
    """(supported, reason-if-not) for one (arch x shape) cell."""
    if shape_name == "long_500k" and arch_name not in _LONG_OK:
        return False, "pure full-attention arch: 500k decode excluded per assignment (sub-quadratic attention required)"
    return True, ""
