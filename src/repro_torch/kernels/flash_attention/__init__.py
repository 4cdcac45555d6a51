"""Prefill flash attention (K3): ``ops.flash_attention``."""
