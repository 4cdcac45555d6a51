"""Roofline terms of one step, the arithmetic half of
``repro.launch.hlo_analysis``.

``HW`` holds the peaks of the card the port runs on, one NVIDIA H100 SXM
(``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``:
``NVIDIA H100 80GB HBM3, 700.00 W``), from NVIDIA's data sheet: the
dense bf16 tensor-core rate, the HBM3 bandwidth and NVLink's 900 GB/s to
the host's other cards, 450 GB/s each way.  The reference's ``HW`` holds
a TPU v5e's.  A card set below 700 W runs slower under load than these
peaks say.

``collective_bytes``, the reference's census of the collectives in
compiled HLO text, belongs with the dry-run tooling that compiles the
steps; it is not here yet.
"""
from __future__ import annotations

__all__ = ["roofline_terms", "HW"]

# One H100 SXM at its 700 W limit (NVIDIA data sheet, dense rates).
HW = {
    "peak_flops_bf16": 989e12,  # FLOP/s, tensor cores
    "hbm_bw": 3.35e12,  # B/s
    "ici_bw": 450e9,  # B/s, NVLink, one direction
}


def roofline_terms(
    flops_per_device: float,
    hbm_bytes_per_device: float,
    collective_bytes_per_device: float,
) -> dict:
    """Three roofline times (seconds) from per-device quantities.

    compute = FLOPs / peak;  memory = bytes / HBM_bw;
    collective = bytes / link bw.  The dominant term is the bottleneck;
    'roofline_fraction' = compute / max(all) (how close the step is to
    being compute-bound at peak).
    """
    t_compute = flops_per_device / HW["peak_flops_bf16"]
    t_memory = hbm_bytes_per_device / HW["hbm_bw"]
    t_collective = collective_bytes_per_device / HW["ici_bw"]
    bound = max(
        ("compute", t_compute), ("memory", t_memory), ("collective", t_collective),
        key=lambda kv: kv[1],
    )[0]
    t_max = max(t_compute, t_memory, t_collective)
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "bound": bound,
        "roofline_fraction": (t_compute / t_max) if t_max > 0 else 0.0,
    }
