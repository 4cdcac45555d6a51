"""LM variant profiles from the roofline terms, the counterpart of
``repro.serving.profiles``.

The paper's scheduler consumes per-variant ``ModelProfile``s (latency,
swap cost, per-class recalls).  The latency model comes from the dry-run
roofline records when a results directory holds them (the port's own,
``python -m repro_torch.launch.dryrun``, write to ``DRYRUN_DIR``,
``results/dryrun_torch/``, never to the reference's ``results/dryrun/``,
whose TPU records would set an H100's profiles), else from the analytic
census below:

    l_decode(b)  = t_max(decode cell)   (per generated token)
    l_prefill(b) = t_max(prefill cell) * (prompt_tokens / cell tokens)
    l(m, b)      = prefill(prompt) + n_new * decode  ~ affine in batch

Swap cost = weight bytes over a 25 GB/s staging rate.  The formulas and
signatures are the reference's; the analytic terms use the port's
``launch.hlo_analysis.HW`` (one H100), and the device count defaults to
the one card the port serves on, where the reference's defaults to a
16-chip slice of its pod.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.accuracy import ModelProfile
from repro_torch.launch.hlo_analysis import HW, roofline_terms
from repro_torch.models.kvcache import cache_bytes

__all__ = [
    "lm_latency_model",
    "lm_profile",
    "load_dryrun_record",
    "costmodel_terms",
    "costmodel_latency_model",
    "costmodel_profile",
    "DRYRUN_DIR",
]

_DCN_BW = 25e9  # host->HBM staging bandwidth for cold weight loads (B/s)
N_DEVICES = 1  # the cards one variant is served from
DRYRUN_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def load_dryrun_record(results_dir, arch: str, shape: str, mesh: str = "pod") -> dict | None:
    """Load one dry-run roofline record, or None when absent/failed."""
    p = Path(results_dir) / f"{arch}__{shape}__{mesh}.json"
    if not p.exists():
        return None
    rec = json.loads(p.read_text())
    return rec if rec.get("status") == "ok" else None


def lm_latency_model(
    results_dir, arch: str, prompt_tokens: int = 512, new_tokens: int = 64,
    mesh: str = "pod", n_devices: int = N_DEVICES
) -> tuple[float, float]:
    """(fixed_s, per_item_s) affine batch-latency model for one variant.

    Derived from the decode/prefill cells' t_max: fixed cost ~ prefill of
    one prompt + the batch-independent decode floor; per-item ~ marginal
    decode bandwidth per sequence.  Falls back to an analytic model when
    the dry-run records are absent.
    """
    cfg = get_config(arch)
    dec = load_dryrun_record(results_dir, cfg.name, "decode_32k", mesh)
    pre = load_dryrun_record(results_dir, cfg.name, "prefill_32k", mesh)
    if dec and pre:
        t_dec_batch = dec["roofline"]["t_max_s"]  # 128-way batched decode step
        b_cell = dec["global_batch"]
        t_pre_cell = pre["roofline"]["t_max_s"]
        tok_cell = pre["global_batch"] * pre["seq_len"]
        t_prefill = t_pre_cell * prompt_tokens / tok_cell
        # decode cost is dominated by weight streaming (batch-independent)
        # plus per-sequence cache reads:
        fixed = new_tokens * t_dec_batch * 0.7 + t_prefill
        per_item = new_tokens * t_dec_batch * 0.3 / b_cell + t_prefill * 0.1
        return float(fixed), float(per_item)
    # analytic fallback: weights stream at HBM bandwidth per token; the
    # prompt's prefill flops run at peak.  Both divide by the device
    # count — the same sharding the decode term assumes.
    hbm, peak = HW["hbm_bw"], HW["peak_flops_bf16"]
    t_tok = 2.0 * cfg.active_param_count() / n_devices / hbm
    t_prefill = 2.0 * cfg.active_param_count() * prompt_tokens / n_devices / peak
    return float(new_tokens * t_tok + t_prefill), float(t_prefill * 0.05)


def costmodel_terms(
    arch, prompt_tokens: int = 512, new_tokens: int = 64, n_devices: int = N_DEVICES
) -> dict:
    """Analytic roofline census for one serving step, term by term, with
    the ``launch.hlo_analysis.HW`` constants:

    * ``prefill_fixed_s``  — weights read once from HBM (shared by the
      whole batch).
    * ``prefill_item_s``   — each prompt's ``2 * active_params * tokens``
      flops at peak.
    * ``decode_fixed_s``   — per generated token, the weight stream from
      HBM (batch-independent: one pass serves every sequence).
    * ``decode_item_s``    — per sequence: decode flops at peak plus the
      KV-cache read (``models.kvcache.cache_bytes`` at the full
      prompt+generation length) per step.

    The affine model is then ``fixed = prefill_fixed + decode_fixed`` and
    ``per_item = prefill_item + decode_item``.
    """
    cfg = get_config(arch) if isinstance(arch, str) else arch
    hbm, peak = HW["hbm_bw"], HW["peak_flops_bf16"]
    act = cfg.active_param_count()
    dtype_bytes = 2 if cfg.dtype == "bfloat16" else 4
    t_weight = dtype_bytes * act / n_devices / hbm
    t_cache = cache_bytes(cfg, 1, prompt_tokens + new_tokens) / n_devices / hbm
    return {
        "prefill_fixed_s": t_weight,
        "prefill_item_s": 2.0 * act * prompt_tokens / n_devices / peak,
        "decode_fixed_s": new_tokens * t_weight,
        "decode_item_s": new_tokens * (2.0 * act / n_devices / peak + t_cache),
    }


def costmodel_latency_model(
    arch, prompt_tokens: int = 512, new_tokens: int = 64, results_dir=None,
    mesh: str = "pod", n_devices: int = N_DEVICES, costs=None
) -> tuple[float, float]:
    """(fixed_s, per_item_s) from the best cost source available.

    Priority: dry-run roofline records (when ``results_dir`` holds them)
    > cost-model totals passed via ``costs=`` (keys ``flops``/``bytes``/
    ``collective_bytes``, optional ``batch``) > the analytic
    ``costmodel_terms`` census.
    """
    cfg = get_config(arch) if isinstance(arch, str) else arch
    if results_dir is not None:
        dec = load_dryrun_record(results_dir, cfg.name, "decode_32k", mesh)
        pre = load_dryrun_record(results_dir, cfg.name, "prefill_32k", mesh)
        if dec and pre:
            return lm_latency_model(
                results_dir, cfg.name, prompt_tokens, new_tokens, mesh, n_devices)
    terms = costmodel_terms(cfg, prompt_tokens, new_tokens, n_devices)
    if costs is not None:
        # totals for one decode step at ``batch`` sequences: roofline the
        # step, then split it 70/30 fixed/per-item like the dry-run path
        # (weight streaming dominates the fixed share).
        b = int(costs.get("batch", 1))
        rt = roofline_terms(
            costs["flops"] / n_devices,
            costs["bytes"] / n_devices,
            costs.get("collective_bytes", 0) / n_devices,
        )
        t_step = max(rt["t_compute_s"], rt["t_memory_s"], rt["t_collective_s"])
        fixed = new_tokens * t_step * 0.7 + terms["prefill_fixed_s"]
        per_item = new_tokens * t_step * 0.3 / b + terms["prefill_item_s"]
        return float(fixed), float(per_item)
    fixed = terms["prefill_fixed_s"] + terms["decode_fixed_s"]
    per_item = terms["prefill_item_s"] + terms["decode_item_s"]
    return float(fixed), float(per_item)


def costmodel_profile(
    arch,
    recalls,
    prompt_tokens: int = 512,
    new_tokens: int = 64,
    results_dir=None,
    name: str | None = None,
    mesh: str = "pod",
    n_devices: int = N_DEVICES,
    costs=None,
) -> ModelProfile:
    """``ModelProfile`` minted from the cost model (provenance
    ``"costmodel"``): no device execution."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    fixed, per_item = costmodel_latency_model(
        cfg, prompt_tokens, new_tokens, results_dir, mesh, n_devices, costs)
    weight_bytes = (2 if cfg.dtype == "bfloat16" else 4) * cfg.param_count()
    return ModelProfile(
        name=name or cfg.name,
        recalls=np.asarray(recalls, dtype=np.float64),
        latency_s=fixed + per_item,
        load_latency_s=weight_bytes / _DCN_BW / n_devices,
        memory_bytes=weight_bytes,
        latency_model=(fixed, per_item),
        provenance="costmodel",
    )


def lm_profile(
    results_dir,
    arch: str,
    recalls,
    prompt_tokens: int = 512,
    new_tokens: int = 64,
    name: str | None = None,
    mesh: str = "pod",
) -> ModelProfile:
    """ModelProfile for an LM variant with roofline-derived latency; its
    weights stage over ``N_DEVICES`` cards' links in parallel."""
    cfg = get_config(arch)
    fixed, per_item = lm_latency_model(results_dir, arch, prompt_tokens, new_tokens, mesh)
    weight_bytes = 2 * cfg.param_count()
    return ModelProfile(
        name=name or cfg.name,
        recalls=np.asarray(recalls, dtype=np.float64),
        latency_s=fixed + per_item,
        load_latency_s=weight_bytes / _DCN_BW / N_DEVICES,
        memory_bytes=weight_bytes,
        latency_model=(fixed, per_item),
        provenance="costmodel",  # roofline-derived, not measured on-device
    )
