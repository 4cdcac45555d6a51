"""Device rule and float policy of the PyTorch port.

Every entry point of ``repro_torch`` takes ``device=`` and resolves it
here.  ``None`` means the card: the port runs on CUDA, and a host
without CUDA is an error, not a silent fallback.  The CPU is used only
when the caller names it (``device="cpu"``), as the CPU tests do.

Scheduling tensors are float64 (``SCHED_DTYPE``) so that decisions match
the JAX package's numpy fast path bit for bit; the k-NN search is
float32 (``KNN_DTYPE``), as the Pallas kernel it replaces.
"""
from __future__ import annotations

import torch

__all__ = ["SCHED_DTYPE", "KNN_DTYPE", "resolve_device"]

SCHED_DTYPE = torch.float64
KNN_DTYPE = torch.float32


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` and ``"cuda"`` resolve to the current CUDA device and raise
    ``RuntimeError`` when CUDA is absent; ``"cpu"`` is honoured only
    because the caller asked for it.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA and found none; pass device='cpu' "
                "to run the plain PyTorch versions on the host"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
