"""Mesh construction, the counterpart of ``repro.launch.mesh`` (defined as
functions: importing this module touches no process group).

A mesh is a ``torch.distributed`` ``DeviceMesh`` over the ranks of the
default process group, which the caller has initialised: one rank per
card on ``cuda`` (the default), gloo ranks on ``cpu``.  A mesh whose size
is not the world's raises.

``fake_world(n)`` gives a process a world of ``n`` ranks that exchange
nothing (the ``fake`` process group, this process rank 0): the dry run
(``launch.dryrun``) traces a step on fake tensors over the reference's
production meshes there.  A mesh in a fake world lies on the ``cpu``
device type, whatever ``device`` names.
"""
from __future__ import annotations

import contextlib
import math

from repro_torch.device import resolve_device

__all__ = ["make_production_mesh", "make_mesh", "fake_world", "in_fake_world"]


@contextlib.contextmanager
def fake_world(n: int):
    """A world of ``n`` ranks of the ``fake`` process group for the block:
    collectives return tensors of their results' shapes and move nothing.
    Refuses when a process group is already up; destroys its own on exit."""
    import torch.distributed as dist

    from repro_torch.launch.hlo_analysis import require_internals

    require_internals()
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world needs a process without a process group; one is "
                           f"up ({dist.get_backend()}, {dist.get_world_size()} ranks)")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=int(n))
    try:
        yield
    finally:
        dist.destroy_process_group()


def in_fake_world() -> bool:
    """Whether the default process group is ``fake_world``'s."""
    import torch.distributed as dist

    return dist.is_initialized() and dist.get_backend() == "fake"


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The reference's production layout: (data, model) = (16, 16); two
    pods (pod, data, model) = (2, 16, 16).  It needs 256 or 512 ranks, so
    outside a ``fake_world`` of that size on a host of one to four cards
    it raises."""
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
    kind = "cpu" if in_fake_world() else resolve_device(device).type
    return init_device_mesh(kind, shape, mesh_dim_names=axes)
