"""Mamba-2 SSD chunk scan (K5): ``ops.ssd`` and ``ops.ssd_chunk_scan``."""
