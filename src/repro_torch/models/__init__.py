"""Language models of the port: ``model.LM`` over the dense ``attn:mlp`` stack.

Each module mirrors its namesake in the JAX package (``repro.models``).
Attention runs through the port's kernels: prefill through K3
(``kernels.flash_attention``), decode through K4
(``kernels.decode_attention``); projections, MLPs and the readout are
``torch.matmul``, as the reference left them to XLA.
"""
from repro_torch.models.model import LM

__all__ = ["LM"]
