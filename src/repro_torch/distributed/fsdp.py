"""ZeRO-3 over a ``DeviceMesh``: the route ``Trainer(shardings=)`` takes
(its step is ``launch.steps.make_sharded_train_step``).

The weights and AdamW's state are DTensors placed by the specs of the
policy (``launch.shardings``, ``NamedSharding.placements``).  Each rank
holds its shard of every leaf; the reference's stacked trees
(``TransformerParams.to_tree``) keep the layer dim whole, so a layer's
weights are a slice of each stacked DTensor, sharded on its other dims.

A step:

  * each rank takes its rows of the global batch: the rows its
    coordinate on the batch axes of the policy's ``act_btd`` rule names
    (``batch_rows``); ranks that share those coordinates compute the
    same rows;
  * each layer's weights are gathered whole as plain tensors just before
    the layer runs (``local_view``: ``redistribute`` to ``Replicate`` and
    ``to_local`` with ``Partial`` gradients), inside the layer's
    checkpoint when the config rematerialises, so the backward gathers
    them again; the embedding, the final norm and the head are gathered
    once a step.  No DTensor reaches a kernel wrapper: the attention,
    SSD and RG-LRU autograd functions see local tensors;
  * each rank's loss is weighted by its share of the tokens summed over
    all ranks, so the gradients summed over the ranks (the ``Partial``
    placements) are those of the global batch's mean loss; they come
    back reduce-scattered to the weights' placements;
  * ``adamw_step`` runs on the DTensors (the norm and the int8 moments'
    row maxima reduce across shards), and its results are placed back on
    the specs, as the reference's ``out_shardings`` place them.

The sums run in another order than one rank's, so a sharded step equals
the unsharded step to rounding, not bit for bit.

No card holds the whole state: ``LM.init(shardings=)`` draws one leaf at
a time on the card and keeps this rank's shard of it (``shard_tensor``),
``checkpoint.restore(shardings=)`` cuts each leaf on the host and copies
only the shard, and ``checkpoint.save`` sends the shards to rank 0's host
(``full_on_rank0``).  A card's peak of state is its shards plus one leaf.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.distributed.sharding import act_spec, mesh_sizes
from repro_torch.trees import tree_leaves, tree_map

__all__ = ["shard_tensor", "shard_tree", "zeros_tree", "from_local_tree", "place_tree",
           "full_on_rank0", "local_view", "local_params", "serving_view", "batch_rows",
           "all_reduce_sum", "first_mesh"]


def _box(shape, placements, mesh, coords) -> tuple:
    """The slices of a full tensor of ``shape`` that the rank at mesh
    coordinates ``coords`` holds: each tensor dim cut evenly by the mesh
    dims that shard it, in the mesh's order (``torch.chunk`` nested)."""
    box = [slice(None)] * len(shape)
    for d, size in enumerate(shape):
        start, n = 0, size
        for i, place in enumerate(placements):
            if place.is_shard() and place.dim == d:
                parts = mesh.size(i)
                if n % parts:
                    raise ValueError(f"dim {d} of {tuple(shape)} does not split {parts} ways")
                n //= parts
                start += coords[i] * n
        box[d] = slice(start, start + n)
    return tuple(box)


def _coords(mesh, rank: int) -> list[int]:
    return (mesh.mesh == rank).nonzero()[0].tolist()


def shard_tensor(t: torch.Tensor, sharding, device=None) -> DTensor:
    """This rank's shard of ``t`` (the same full tensor on every rank), as a
    DTensor placed by ``sharding``, with no communication.  Only the shard
    is copied, to ``device`` (``t``'s by default), so ``t`` may stay on the
    host and be freed."""
    mesh, placements = sharding.mesh, tuple(sharding.placements)
    local = t[_box(t.shape, placements, mesh, mesh.get_coordinate())]
    out = torch.empty(local.shape, dtype=local.dtype, device=t.device if device is None else device)
    out.copy_(local)
    return DTensor.from_local(out, mesh, placements, run_check=False)


def shard_tree(tree, shardings):
    """Every full leaf that ``shardings`` (a tree of the same structure,
    None for a leaf left whole) names, replaced by its shard."""
    return tree_map(lambda x, sh: x if sh is None else shard_tensor(x, sh), tree, shardings)


def zeros_tree(tree, shardings, device):
    """A DTensor of zeros for every leaf of ``tree`` (tensors whose shapes and
    types are the whole leaves', ``meta`` ones for instance), this rank's
    shard of it on ``shardings`` made on ``device`` alone."""
    def zeros(x, sh):
        box = _box(x.shape, tuple(sh.placements), sh.mesh, sh.mesh.get_coordinate())
        local = torch.zeros(tuple(b.stop - b.start for b in box), dtype=x.dtype, device=device)
        return DTensor.from_local(local, sh.mesh, tuple(sh.placements), run_check=False)

    return tree_map(zeros, tree, shardings)


def from_local_tree(tree, shardings):
    """Every local leaf that ``shardings`` names, as the DTensor it is the
    shard of: no communication (each rank passes its own shards)."""
    return tree_map(lambda x, sh: x if sh is None else DTensor.from_local(
        x, sh.mesh, tuple(sh.placements), run_check=False), tree, shardings)


def place_tree(tree, shardings):
    """Every DTensor leaf redistributed to the placements ``shardings`` names."""
    def place(x, sh):
        if sh is None:
            return x
        want = tuple(sh.placements)
        return x if tuple(x.placements) == want else x.redistribute(sh.mesh, want)

    return tree_map(place, tree, shardings)


def full_on_rank0(x: DTensor) -> torch.Tensor | None:
    """The whole of ``x`` as a host tensor on rank 0, None on the other
    ranks.  Each shard that no earlier rank holds (rank 0 and the ranks at
    coordinate 0 of every mesh dim that replicates ``x``) is sent to rank 0
    in turn and copied to its host, so no card holds more than its own
    shard and one received piece."""
    mesh, placements = x.device_mesh, tuple(x.placements)
    if any(p.is_partial() for p in placements):
        raise ValueError(f"a pending sum {placements} cannot be saved")
    local = x.to_local().contiguous()
    senders = [r for r in mesh.mesh.flatten().tolist()
               if all(c == 0 for c, p in zip(_coords(mesh, r), placements) if not p.is_shard())]
    rank = dist.get_rank()
    if rank != 0:
        if rank in senders:
            dist.send(local, dst=0)
        return None
    full = torch.empty(tuple(x.shape), dtype=x.dtype)
    piece = torch.empty_like(local)
    for r in senders:
        if r != rank:
            dist.recv(piece, src=r)
        full[_box(full.shape, placements, mesh, _coords(mesh, r))] = (
            local if r == rank else piece).cpu()
    return full


def _gather(p: torch.Tensor) -> torch.Tensor:
    """A DTensor weight whole, as a plain tensor whose gradient returns to
    the weight's placements as the sum over the ranks."""
    n = p.device_mesh.ndim
    return p.redistribute(p.device_mesh, [Replicate()] * n).to_local(
        grad_placements=[Partial()] * n)


class _View:
    """A module's weights under the module's names, each through a leaf
    function."""


def _view(m: torch.nn.Module, leaf=_gather) -> _View:
    v = _View()
    for name, p in m.named_parameters(recurse=False):
        setattr(v, name, leaf(p))
    for name, child in m.named_children():
        setattr(v, name, _view(child, leaf))
    return v


def local_view(m: torch.nn.Module):
    """``m`` itself, or, when its weights are DTensors, a view of them
    gathered whole."""
    first = next(m.parameters(), None)
    return _view(m) if isinstance(first, DTensor) else m


def _tp_only(p: torch.Tensor) -> torch.Tensor:
    """A DTensor weight gathered over every mesh axis but ``model``."""
    names = p.device_mesh.mesh_dim_names
    want = tuple(place if name == "model" else Replicate()
                 for name, place in zip(names, p.placements))
    return p if want == tuple(p.placements) else p.redistribute(p.device_mesh, want)


def serving_view(m: torch.nn.Module):
    """``m`` itself, or, when a weight is a DTensor sharded over a mesh axis
    other than ``model`` (the ``ep_tp`` rules' 2-D leaves: a dense layer's
    embed or ffn dim, an expert's embed dim, over ``data``), a view whose
    weights are gathered over those axes and keep their ``model`` shards:
    the layer then runs tensor-parallel as the ``tp`` rules' layers do.
    A layer of plain tensors (the first weight tells) is returned at once."""
    if not isinstance(next(m.parameters(), None), DTensor):
        return m

    def data_sharded(p):
        return any(place.is_shard() and name != "model"
                   for name, place in zip(p.device_mesh.mesh_dim_names, p.placements))

    return _view(m, _tp_only) if any(data_sharded(p) for p in m.parameters()) else m


def local_params(params):
    """``params`` itself, or, when sharded, a view whose embedding, final
    norm and head are gathered and whose layers stay sharded (each is
    gathered where it runs, ``transformer._block_full``)."""
    if not isinstance(params.final_norm.scale, DTensor):
        return params
    v = _View()
    v.cfg = params.cfg
    v.embed = _view(params.embed)
    v.final_norm = _view(params.final_norm)
    v.lm_head = None if params.lm_head is None else _gather(params.lm_head)
    v.layers = params.layers
    return v


def batch_rows(batch_size: int, seq: int, cfg, mesh, policy) -> tuple[int, int, int]:
    """(first row, rows, row blocks) of this rank's part of a global batch:
    the batch dim's entry of the policy's ``act_btd`` rule for a
    (batch, seq, d_model) activation, read at this rank's coordinate."""
    spec = act_spec((batch_size, seq, cfg.d_model), "act_btd", mesh, policy)
    axis = spec[0] if spec else None
    names = () if axis is None else (tuple(axis) if isinstance(axis, tuple) else (axis,))
    sizes = mesh_sizes(mesh)
    dims = list(sizes)
    block, blocks = 0, 1
    for name in names:
        block = block * sizes[name] + mesh.get_local_rank(dims.index(name))
        blocks *= sizes[name]
    rows = batch_size // blocks
    return block * rows, rows, blocks


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over every rank of the world (a new tensor)."""
    out = x.detach().clone()
    dist.all_reduce(out)
    return out


def first_mesh(shardings):
    """The mesh of the first sharding in a tree of them."""
    for sharding in tree_leaves(shardings):
        return sharding.mesh
    raise ValueError("the shardings name no mesh")
