"""PyTorch and CUDA port of the SneakPeek reproduction, for one NVIDIA H100.

The JAX package (``repro``) is the reference; this package imports
nothing of it and mirrors its module layout (``core``, ``data``,
``configs``, ``models``, ``serving``, ``kernels``, ``training``,
``launch``, ``distributed``).  Batched math runs as
torch tensors on an explicit device, the card unless a caller names the
CPU (``device.resolve_device``).  The k-NN search, the Eq. 2 utility
tiles, prefill attention, decode attention and the Mamba-2 SSD chunk
scan (the five Pallas kernels of the reference), the window pipeline's
sequential and speculative chunked selection scans and the RG-LRU scan
are hand-written CUDA kernels (``kernels/<name>/csrc``: ``knn``,
``utility``, ``flash_attention``, ``decode_attention``, ``ssd``,
``selection_scan``, ``spec_scan``, ``rglru_scan``).
"""
from repro_torch.device import KNN_DTYPE, SCHED_DTYPE, resolve_device

__all__ = ["KNN_DTYPE", "SCHED_DTYPE", "resolve_device"]
