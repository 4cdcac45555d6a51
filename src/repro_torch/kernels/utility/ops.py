"""Wrapper of the Eq. 2 utility kernel (K1), the port of
``repro.kernels.utility.ops.utility_scores``.

Tensors on the CPU take the plain version (``ref.py``); CUDA tensors
launch ``csrc/utility.cu`` on the current stream, or raise.  There is no
other route.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.utility import PENALTY_CODES
from repro_torch.kernels import LaunchCounter, nvcc
from repro_torch.kernels.utility.ref import utility_scores_ref, utility_tile_ref

__all__ = ["utility_scores", "counter", "MAX_MODELS"]

counter = LaunchCounter("utility_scores")

MAX_MODELS = 256  # one thread per column sums the column

_P = ctypes.c_void_p
_I = ctypes.c_int


def _entry(dtype: torch.dtype):
    lib = nvcc.library("utility")
    fn = lib.utility_scores_f64 if dtype == torch.float64 else lib.utility_scores_f32
    fn.argtypes = [_P, _P, _P, _I, _P, _P, _I, _I, _I, _P]
    fn.restype = _I
    return lib, fn


def _check_args(acc, deadlines, completions, penalty):
    if penalty not in PENALTY_CODES:
        raise ValueError(f"unknown penalty {penalty!r}")
    if acc.ndim != 2 or acc.shape[0] == 0 or acc.shape[1] == 0:
        raise ValueError(f"acc must be a non-empty (R, M) tensor, got {tuple(acc.shape)}")
    r, m = acc.shape
    if deadlines.shape != (r,):
        raise ValueError(f"deadlines must be ({r},), got {tuple(deadlines.shape)}")
    if completions.shape not in ((r, m), (m,)):
        raise ValueError(
            f"completions must be ({r}, {m}) or ({m},), got {tuple(completions.shape)}"
        )
    if acc.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"acc must be float32 or float64, got {acc.dtype}")
    for name, t in (("deadlines", deadlines), ("completions", completions)):
        if t.dtype != acc.dtype:
            raise TypeError(f"{name} is {t.dtype}, acc is {acc.dtype}")
        if t.device != acc.device:
            raise ValueError(f"{name} is on {t.device}, acc on {acc.device}")


def utility_scores(acc, deadlines, completions, penalty: str = "sigmoid",
                   with_means: bool = True):
    """(U (R, M), column means (M,) or None) for one (requests x models) tile.

    ``deadlines`` is (R,); ``completions`` is the full (R, M) tile or one
    (M,) row shared by every request.  The means are the column sums over
    the R rows, added in row order, divided by R: bit-identical in
    float64 to the reference's ``sequential_mean`` of the same tile.
    ``with_means=False`` skips the sums (per-entry scoring).
    """
    _check_args(acc, deadlines, completions, penalty)
    if acc.device.type == "cpu":
        if with_means:
            return utility_scores_ref(acc, deadlines, completions, penalty)
        return utility_tile_ref(acc, deadlines, completions, penalty), None
    if acc.device.type != "cuda":
        raise ValueError(f"utility_scores runs on CUDA or the CPU, not {acc.device}")
    for name, t in (("acc", acc), ("deadlines", deadlines), ("completions", completions)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    r, m = acc.shape
    if m > MAX_MODELS:
        raise ValueError(f"the utility kernel takes M <= {MAX_MODELS} columns, got {m}")
    u = torch.empty_like(acc)
    sums = torch.empty(m, dtype=acc.dtype, device=acc.device) if with_means else None
    lib, fn = _entry(acc.dtype)
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        err = fn(acc.data_ptr(), deadlines.data_ptr(), completions.data_ptr(),
                 m if completions.ndim == 2 else 0, u.data_ptr(),
                 sums.data_ptr() if with_means else None, r, m,
                 PENALTY_CODES[penalty], stream)
    counter.add()
    nvcc.check(lib, err, "utility_scores")
    return u, (sums / r if with_means else None)
