"""Plain PyTorch version of the chunked selection-scan kernel.

The speculate / reconstruct / validate / accept rounds of the reference's
``_spec_select`` and ``_spec_select_mw`` (``src/repro/core/pipeline.py:244``,
``:691``) over the (W, B, M) step tables of ``selection_scan``: the
pipeline's ``_spec_select``, on float64 tensors.  Used for tensors on the
CPU and, on the card, as the kernel's comparison.
"""
from __future__ import annotations

import torch

__all__ = ["spec_scan_ref"]


def spec_scan_ref(chunk: int, t0, res0, sizes, cap: float, slot1: bool, acc, mask, deadlines,
                  bsize, lat, step_app, swap, gid, valid, pen, pref,
                  fixed_sel=None) -> torch.Tensor:
    """The (4, S + 1) float64 rows of S decisions taken ``chunk`` at a
    time — worker index, model column, start, latency — and, in column S,
    the rounds and conflicts; arguments as ``ops.spec_scan``."""
    from repro_torch.core.pipeline import _spec_select

    return _spec_select(chunk, slot1, t0, res0, sizes, cap, acc, mask, deadlines, bsize, lat,
                        step_app, swap, gid, valid, pen, pref, fixed_sel)
