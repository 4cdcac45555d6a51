"""Reductions over a few columns in numpy's own summation order.

numpy reduces a contiguous row of ``n`` values with its pairwise kernel:
a plain running sum from 0 below 8 values; from 8 up to 128 values,
eight interleaved running sums combined as a tree, then the tail added
one by one.  ``torch.sum`` and ``torch.var`` use other orders, on the
host and on the card, and a last-bit difference there can flip a
scheduling decision.  ``row_sum`` repeats numpy's order column by
column, so the port's Eq. 11 and Eq. 12 rows are bit-identical to the
reference's ``a.sum(axis=1)`` and ``A.var(axis=1)``.
"""
from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["row_sum", "row_mean", "row_var", "sequential_mean"]

_PAIRWISE_BLOCK = 128


def row_sum(cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum of equally shaped column tensors, in numpy's row-reduction order."""
    n = len(cols)
    if n == 0:
        raise ValueError("row_sum needs at least one column")
    if n > _PAIRWISE_BLOCK:
        raise ValueError(f"row_sum covers up to {_PAIRWISE_BLOCK} columns, got {n}")
    if n < 8:
        s = torch.zeros_like(cols[0])
        for c in cols:
            s = s + c
        return s
    r = list(cols[:8])
    i = 8
    while i + 8 <= n:
        r = [r[j] + cols[i + j] for j in range(8)]
        i += 8
    s = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
    for c in cols[i:]:
        s = s + c
    return s


def row_mean(mat: torch.Tensor) -> torch.Tensor:
    """``mat.mean(axis=1)`` of numpy for an (R, M) tensor."""
    return row_sum(mat.unbind(1)) / mat.shape[1]


def row_var(mat: torch.Tensor) -> torch.Tensor:
    """Population variance ``mat.var(axis=1)`` of numpy for an (R, M) tensor."""
    mean = row_mean(mat)
    dev = [c - mean for c in mat.unbind(1)]
    return row_sum([x * x for x in dev]) / mat.shape[1]


def sequential_mean(tile: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Mean along ``dim`` accumulated in the scalar order — ``total += u``
    member by member from 0, then one divide — as the reference's
    ``fastpath.sequential_mean``; the Eq. 2 kernel sums its columns the
    same way."""
    tile = tile.movedim(dim, 0)
    s = torch.zeros_like(tile[0])
    for row in tile:
        s = s + row
    return s / tile.shape[0]
