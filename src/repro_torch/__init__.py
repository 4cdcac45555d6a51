"""PyTorch and CUDA port of the SneakPeek reproduction, for one NVIDIA H100.

The JAX package (``repro``) is the reference; this package imports
nothing of it and mirrors its module layout (``core``, ``data``,
``kernels``).  Batched math runs as torch tensors on an explicit device,
the card unless a caller names the CPU (``device.resolve_device``); the
k-NN search and the Eq. 2 utility tiles are hand-written CUDA kernels
(``kernels/knn/csrc/knn.cu``, ``kernels/utility/csrc/utility.cu``).
"""
from repro_torch.device import KNN_DTYPE, SCHED_DTYPE, resolve_device

__all__ = ["KNN_DTYPE", "SCHED_DTYPE", "resolve_device"]
