"""Language models of the port: ``model.LM`` over stacks of global
(``attn``) and sliding-window (``local``) attention layers, Griffin
RG-LRU recurrent layers (``rglru``) and Mamba-2 SSD layers (``ssd``),
with dense MLPs, routed MoE FFNs (``moe``) or none.

Each module mirrors its namesake in the JAX package (``repro.models``).
Attention runs through the port's kernels: prefill through K3
(``kernels.flash_attention``), decode through K4
(``kernels.decode_attention``), at head dims up to 256, from a
full cache, a ring buffer or the int8 cache; the Mamba-2 SSD mixer's chunked prefill
scan runs through K5 (``kernels.ssd``), its decode step in plain
PyTorch; the RG-LRU recurrence through ``kernels.rglru_scan`` (prefill
and decode); projections, MLPs, the MoE's expert products and the
readout are ``torch.matmul``/``torch.bmm``, as the reference left them to
XLA.
"""
from repro_torch.models.model import LM

__all__ = ["LM"]
