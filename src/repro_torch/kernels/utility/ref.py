"""Plain PyTorch version of the Eq. 2 utility kernel.

The same function as ``csrc/utility.cu`` in the same arithmetic: the
penalty is ``core.utility.gamma`` (multiply and divide only) and the
column sums add the rows one by one from row 0, as the kernel does and as
the reference's ``sequential_mean`` does.  Used for tensors on the CPU
and, on the card, as the kernel's comparison.
"""
from __future__ import annotations

import torch

from repro_torch.core.ordered import sequential_mean
from repro_torch.core.utility import gamma

__all__ = ["utility_tile_ref", "utility_scores_ref"]


def utility_tile_ref(acc, deadlines, completions, penalty: str) -> torch.Tensor:
    """U (R, M) = acc * (1 - clip(gamma(d, e), 0, 1)); ``deadlines`` (R,),
    ``completions`` (R, M) or (M,)."""
    g = gamma(penalty, deadlines[:, None], completions)
    return acc * (1.0 - torch.clamp(g, 0.0, 1.0))


def utility_scores_ref(acc, deadlines, completions, penalty: str = "sigmoid"):
    """(U (R, M), column means (M,)), the means summed in row order."""
    u = utility_tile_ref(acc, deadlines, completions, penalty)
    return u, sequential_mean(u, dim=0)
