"""Request utility and deadline-penalty functions (paper Eq. 2, §VI-A).

    u_a(m, d, t) = Accuracy(m) * [1 - gamma_a(d, t + l(m))]        (Eq. 2)

gamma_a(d, e) >= 0 is a monotonically increasing penalty, positive when
the expected completion time e exceeds the deadline d:

  * step:    gamma = 1[d < e]
  * linear:  gamma = 1[d < e] * min(1, (e - d) / d)
  * sigmoid: a smooth ramp in the overshoot ratio, capped at 1
  * none:    gamma = 0

Two forms, as in the reference (``repro.core.utility``): scalar
penalties on Python floats for the sequential loops (brute force,
per-request selection), and ``gamma`` on tensors for the batched tiles.
The tensor form is the plain version of the Eq. 2 kernel
(``repro_torch.kernels.utility``).  Both compute ratio^-3 with multiply
and divide only, which are correctly rounded everywhere, so the scalar,
numpy, tensor and CUDA forms agree bit for bit.
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = [
    "step_penalty",
    "linear_penalty",
    "sigmoid_penalty",
    "no_penalty",
    "PENALTIES",
    "PENALTY_CODES",
    "gamma",
    "utility",
]

PenaltyFn = Callable[[float, float], float]


def step_penalty(deadline: float, completion: float) -> float:
    """gamma(d, e) = 1[d < e] — utility zero on any miss."""
    return 1.0 if deadline < completion else 0.0


def linear_penalty(deadline: float, completion: float) -> float:
    """Ramp penalty: overshoot fraction of the deadline, capped at 1."""
    if completion <= deadline:
        return 0.0
    if deadline <= 0:
        return 1.0
    return min(1.0, (completion - deadline) / deadline)


def sigmoid_penalty(deadline: float, completion: float) -> float:
    """Smooth sigmoid ramp in the overshoot ratio x = (e - d) / d:
    ``1 / (1 + (x / (1 - x))^-3)`` on x in (0, 1), saturating at 1."""
    if completion <= deadline:
        return 0.0
    if deadline <= 0:
        return 1.0
    x = (completion - deadline) / deadline
    if x >= 1.0:
        return 1.0
    if x <= 0.0:
        return 0.0
    ratio = x / (1.0 - x)
    return min(1.0, 1.0 / (1.0 + 1.0 / (ratio * ratio * ratio)))


def no_penalty(deadline: float, completion: float) -> float:
    """Constant-zero penalty: Eq. 3 degenerates to accuracy maximization."""
    return 0.0


PENALTIES: dict[str, PenaltyFn] = {
    "step": step_penalty,
    "linear": linear_penalty,
    "sigmoid": sigmoid_penalty,
    "none": no_penalty,
}

# Integer codes the CUDA kernel takes for the static penalty.
PENALTY_CODES: dict[str, int] = {"none": 0, "step": 1, "linear": 2, "sigmoid": 3}


def gamma(penalty: str, d: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Vectorized penalty gamma(d, e) on broadcastable tensors of one dtype.

    The same branch structure as the reference's numpy form: every branch
    is computed and the masked ones are selected away, with safe
    denominators so no masked lane produces a NaN.
    """
    zero = e.new_zeros(())
    one = e.new_ones(())
    if penalty == "none":
        return torch.zeros(torch.broadcast_shapes(d.shape, e.shape), dtype=e.dtype,
                           device=e.device)
    if penalty == "step":
        return torch.where(d < e, one, zero)
    safe_d = torch.where(d > 0, d, one)
    x = (e - d) / safe_d
    if penalty == "linear":
        return torch.where(e <= d, zero, torch.where(d <= 0, one, torch.minimum(one, x)))
    if penalty == "sigmoid":
        ratio = x / torch.where(x < 1.0, 1.0 - x, one)
        safe_ratio = torch.where(ratio > 0, ratio, one)
        inner = torch.minimum(
            one, 1.0 / (1.0 + 1.0 / (safe_ratio * safe_ratio * safe_ratio))
        )
        return torch.where(
            e <= d,
            zero,
            torch.where(
                d <= 0,
                one,
                torch.where(x >= 1.0, one, torch.where(x <= 0.0, zero, inner)),
            ),
        )
    raise ValueError(f"unknown penalty {penalty!r}")


def utility(
    accuracy: float,
    deadline: float,
    start_time: float,
    latency: float,
    penalty: PenaltyFn,
) -> float:
    """Eq. 2 for one (request, model) pair on Python floats."""
    g = penalty(deadline, start_time + latency)
    return float(accuracy) * (1.0 - min(1.0, max(0.0, g)))
