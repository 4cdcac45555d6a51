"""Mesh construction, the counterpart of ``repro.launch.mesh`` (defined as
functions: importing this module touches no process group).

A mesh is a ``torch.distributed`` ``DeviceMesh`` over the ranks of the
default process group, which the caller has initialised: one rank per
card on ``cuda`` (the default), gloo ranks on ``cpu``.  A mesh whose size
is not the world's raises.
"""
from __future__ import annotations

import math

from repro_torch.device import resolve_device

__all__ = ["make_production_mesh", "make_mesh"]


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The reference's production layout: (data, model) = (16, 16); two
    pods (pod, data, model) = (2, 16, 16).  Kept for the reference's
    surface only: it needs 256 or 512 ranks, so on a host of one to four
    cards it raises."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *, device=None):
    """A mesh of ``shape`` named ``axes`` over every rank of the world."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of {math.prod(shape)} devices {dict(zip(axes, shape))} "
                         f"needs as many ranks; the world has {world}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    return init_device_mesh(resolve_device(device).type, shape, mesh_dim_names=axes)
