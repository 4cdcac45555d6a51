"""Parameter specs and their initialisation laws, as in the JAX package.

A copy of ``repro.models.spec``'s declarative form: every module declares
its parameters as a tree of ``P`` leaves (shape, logical axes, init law),
and ``init_params`` materialises the tree with the reference's laws
(``_init_leaf``): a seed per leaf path hashed from the base seed
(``_path_seed``), a truncated normal cut at +-2 sigma scaled by
1/sqrt(fan-in) (the first non-layer dimension), 1.0 for ``embed``, 0.02
for ``small``, zeros for the norm scales.  The draws come from a
``torch.Generator`` seeded per leaf, so the values differ from JAX's;
``convert.lm_params_from_arrays`` carries the reference's own values
across where both must compute on identical weights.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.distributed.fsdp import shard_tensor

__all__ = ["P", "init_params", "abstract_params", "logical_axes", "stack", "count_params"]


@dataclasses.dataclass(frozen=True)
class P:
    """Spec for one parameter tensor."""

    shape: tuple[int, ...]
    axes: tuple[Any, ...]  # logical axis name (str) or None per dim
    init: str = "normal"  # normal | zeros | ones | embed | small
    scale: float | None = None  # stddev override for "normal"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes} rank mismatch")


def _path_seed(path: str, base_seed: int) -> int:
    h = hashlib.blake2b(f"{base_seed}/{path}".encode(), digest_size=4).digest()
    return int.from_bytes(h, "little")


def _init_leaf(p: P, path: str, base_seed: int, dtype, device) -> torch.Tensor:
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=device)
    if p.init not in ("normal", "embed", "small"):
        raise ValueError(f"unknown init {p.init!r}")
    if p.scale is not None:
        std = p.scale
    elif p.init == "embed":
        std = 1.0
    elif p.init == "small":
        std = 0.02
    else:
        fan_in = p.shape[0] if len(p.shape) >= 2 else max(1, p.shape[-1])
        if p.axes and p.axes[0] == "layers" and len(p.shape) >= 3:
            fan_in = p.shape[1]
        std = 1.0 / np.sqrt(fan_in)
    gen = torch.Generator(device=device).manual_seed(_path_seed(path, base_seed))
    x = torch.empty(p.shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(x, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=gen)
    # Scaled in place: one float32 draw of the leaf at a time (an expert
    # stack of llama4-maverick is 21 GB in float32).
    return x.mul_(std).to(dtype)


def _walk(tree, fn: Callable[[P, str], Any], path: str = ""):
    if isinstance(tree, P):
        return fn(tree, path)
    if isinstance(tree, dict):
        return {k: _walk(v, fn, f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, fn, f"{path}/{i}") for i, v in enumerate(tree)]
    raise TypeError(f"unexpected spec node {type(tree)} at {path!r}")


def init_params(spec, seed: int, dtype: torch.dtype, device: torch.device, shardings=None):
    """Materialise a spec into a tree of tensors on ``device`` (seeded by path).

    With ``shardings`` (a tree of ``NamedSharding`` in the same layout),
    each leaf is drawn whole and only this rank's shard of it kept
    (``distributed.fsdp.shard_tensor``), one leaf at a time: the shards of
    the unsharded init's weights, at the memory of the shards and one leaf.
    """
    if shardings is None:
        return _walk(spec, lambda p, path: _init_leaf(p, path, seed, dtype, device))

    def leaf(p, path):
        sharding = shardings
        for part in path.split("/")[1:]:
            sharding = sharding[int(part) if isinstance(sharding, list) else part]
        return shard_tensor(_init_leaf(p, path, seed, dtype, device), sharding)

    return _walk(spec, leaf)


def abstract_params(spec, dtype: torch.dtype):
    """The spec's tree as ``meta`` tensors (shapes and dtypes, no storage)."""
    return _walk(spec, lambda p, path: torch.empty(p.shape, dtype=dtype, device="meta"))


def logical_axes(spec):
    """The spec's tree of logical axes tuples."""
    return _walk(spec, lambda p, path: tuple(p.axes))


def stack(spec, n: int):
    """Prepend a "layers" axis of size n to every leaf (the reference's
    scanned periods; the port unstacks it into one module per layer)."""
    return _walk(
        spec,
        lambda p, path: P(
            shape=(n,) + p.shape, axes=("layers",) + tuple(p.axes), init=p.init, scale=p.scale
        ),
    )


def count_params(spec) -> int:
    """Number of scalars in a spec."""
    total = 0

    def add(p: P, path: str):
        nonlocal total
        total += int(np.prod(p.shape, dtype=np.int64))

    _walk(spec, add)
    return total
