"""Logical-axis sharding: rules mapping logical axes -> mesh axes, the
counterpart of ``repro.distributed.sharding``.

Models annotate parameters with logical axis names (their ``models.spec``
entries) and activations with logical activation names.  A
``ShardingPolicy`` maps those to mesh axes.  A spec (``PartitionSpec``)
is a tuple with one entry per tensor dim, trailing ``None``s dropped:
a mesh-axis name, a tuple of names (joint sharding, major axis first) or
``None``.  ``NamedSharding(mesh, spec).placements`` is its form on a
``torch.distributed`` ``DeviceMesh``: ``Shard(dim)`` on each mesh dim a
tensor dim names, ``Replicate()`` on the others.

The rules read only the mesh's axis names and sizes (``mesh_sizes``), so
they evaluate on a ``DeviceMesh`` or on any object with a ``shape``
mapping and ``axis_names``, without a process group.

Divisibility-aware: a rule only applies when the dimension size is
divisible by the mesh-axis size (falling through an ordered candidate
list otherwise) — this is what lets one policy cover head counts like 24
or 40 that don't divide a 16-way model axis.

The reference's ``use_sharding`` context and ``shard_act`` have no
general counterpart: under the fsdp rules the port's activations stay
local tensors (each rank's batch rows are its own, ``distributed.fsdp``),
so nothing places them, and the trainer takes its policy from its mesh.
The sharded serving steps (``launch.steps``) propagate DTensor
activations; there the residual stream is held where the reference's
``shard_act(x, "act_btd")`` holds it, rows over the data axes and whole
on ``model`` (``rows_over_data``, at each layer's entry), so that DTensor
does not move it elsewhere between layers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

from repro_torch.trees import is_spec, tree_map

__all__ = [
    "PartitionSpec",
    "NamedSharding",
    "ShardingPolicy",
    "act_spec",
    "spec_for_axes",
    "params_pspecs",
    "named_sharding_tree",
    "mesh_sizes",
    "rows_over_data",
    "row_axes",
    "heads_divide",
    "rows_heads",
]


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh-axis name, a tuple of names or None."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def mesh_sizes(mesh) -> dict[str, int]:
    """{axis name: size}, in the mesh's axis order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:  # a torch DeviceMesh
        return dict(zip(names, mesh.mesh.shape))
    return {name: int(mesh.shape[name]) for name in mesh.axis_names}


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DeviceMesh``."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard

        names = list(mesh_sizes(self.mesh))
        out = [Replicate()] * len(names)
        for dim, axis in enumerate(self.spec):
            axes = _axis_names(axis)
            idx = [names.index(a) for a in axes]
            if idx != sorted(idx):
                raise ValueError(f"joint axes {axes} must follow the mesh's order {names}")
            for i in idx:
                out[i] = Shard(dim)
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """Sharding rules.

    param_rules: logical param axis -> ordered candidates of mesh axes.
      Each candidate is a mesh-axis name or a tuple of names (joint
      sharding, e.g. FSDP x TP uses ("data", "model")).  First candidate
      whose size divides the dim (and whose axes are unused in the spec)
      wins; otherwise the dim is replicated.
    act_rules: logical activation name -> spec template (tuple of
      mesh-axis names / tuples / None, may be shorter than the rank — the
      remaining dims are replicated).
    """

    param_rules: Mapping[str, Sequence[Any]]
    act_rules: Mapping[str, tuple]

    def candidates(self, axis_name: str) -> Sequence[Any]:
        return self.param_rules.get(axis_name, ())


def _axis_size(mesh, axis) -> int:
    sizes = mesh_sizes(mesh)
    n = 1
    for a in _axis_names(axis):
        n *= sizes[a]
    return n


def _axis_names(axis) -> tuple:
    if axis is None:
        return ()
    if isinstance(axis, (tuple, list)):
        return tuple(axis)
    return (axis,)


def spec_for_axes(axes: tuple, shape: tuple[int, ...], policy: ShardingPolicy,
                  mesh) -> PartitionSpec:
    """The spec of one parameter from its logical axes + shape."""
    out, used = [], set()
    for dim, logical in zip(shape, axes):
        chosen = None
        if logical is not None:
            for cand in policy.candidates(logical):
                names = _axis_names(cand)
                if not names:
                    continue
                if any(n in used for n in names):
                    continue
                if dim % _axis_size(mesh, cand) != 0:
                    continue
                chosen = tuple(names) if len(names) > 1 else names[0]
                used.update(names)
                break
        out.append(chosen)
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def params_pspecs(axes_tree, shapes_tree, policy: ShardingPolicy, mesh):
    """Tree of specs for a params tree (leaves with a ``shape``)."""
    return tree_map(lambda axes, arr: spec_for_axes(axes, tuple(arr.shape), policy, mesh),
                    axes_tree, shapes_tree, is_leaf=is_spec)


def named_sharding_tree(pspec_tree, mesh):
    """Tree of ``NamedSharding`` (None kept) for a tree of specs."""
    return tree_map(lambda ps: None if ps is None else NamedSharding(mesh, ps), pspec_tree,
                    is_leaf=is_spec)


def act_spec(shape: tuple[int, ...], name: str, mesh, policy: ShardingPolicy):
    """The spec the policy's rule for activation ``name`` gives a tensor
    of ``shape``, or None when the rule does not apply (missing name, rank
    mismatch, or no template whose dims divide)."""
    rule = policy.act_rules.get(name)
    if rule is None:
        return None
    # Template-level alternatives: a rule may be a LIST OF TUPLES tried in
    # order; the first template whose non-None dims all divide (and don't
    # conflict) wins.
    if isinstance(rule, list) and rule and isinstance(rule[0], tuple):
        chosen_rule = None
        for tpl in rule:
            if len(tpl) > len(shape):
                continue
            used_t: set = set()
            ok = True
            for i, axis in enumerate(tpl):
                if axis is None:
                    continue
                names = tuple(axis) if isinstance(axis, tuple) else (axis,)
                if any(n in used_t for n in names) or shape[i] % _axis_size(mesh, axis) != 0:
                    ok = False
                    break
                used_t.update(names)
            if ok:
                chosen_rule = tpl
                break
        if chosen_rule is None:
            return None
        rule = chosen_rule
    if len(rule) > len(shape):
        return None
    spec = []
    used: set = set()
    for i, axis in enumerate(rule):
        # Each dim may carry an ordered candidate list: [cand1, cand2, ...].
        candidates = axis if isinstance(axis, list) else [axis]
        chosen = None
        for cand in candidates:
            if cand is None:
                continue
            names = tuple(cand) if isinstance(cand, tuple) else (cand,)
            if any(n in used for n in names):
                continue
            if shape[i] % _axis_size(mesh, cand) != 0:
                continue
            chosen = names if len(names) > 1 else names[0]
            used.update(names)
            break
        spec.append(chosen)
    return PartitionSpec(*spec)


def row_axes(mesh, *rows: int) -> list[str]:
    """The mesh axes that a sharded serving step splits batch rows over
    (the serving rules' ``act_btd``): every axis but ``model`` when each of
    ``rows`` divides by their size, else ``data`` when each divides by its
    size, else none.  Heads (or channels) go over ``model``."""
    names = list(mesh.mesh_dim_names)
    sizes = dict(zip(names, (int(n) for n in mesh.mesh.shape)))
    data = [n for n in names if n != "model"]
    n_data = 1
    for n in data:
        n_data *= sizes[n]
    if all(r % n_data == 0 for r in rows):
        return data
    if "data" in names and all(r % sizes["data"] == 0 for r in rows):
        return ["data"]
    return []


def heads_divide(mesh, *heads: int) -> bool:
    """Whether each of ``heads`` (head or channel counts) splits over the
    ``model`` axis; False on a mesh without one."""
    names = list(mesh.mesh_dim_names)
    if "model" not in names:
        return False
    n = int(mesh.size(names.index("model")))
    return all(h % n == 0 for h in heads)


def rows_heads(mesh, rows_on: list[str], row_dim: int | None, head_dim: int | None) -> tuple:
    """DTensor placements on ``mesh``: ``Shard(row_dim)`` on the axes
    ``rows_on``, ``Shard(head_dim)`` on ``model``, whole elsewhere (a None
    dim is whole everywhere)."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        if name == "model":
            out.append(Replicate() if head_dim is None else Shard(head_dim))
        else:
            out.append(Shard(row_dim) if row_dim is not None and name in rows_on else Replicate())
    return tuple(out)


def rows_over_data(x):
    """A DTensor (B, ...) placed as the serving rules' ``act_btd``: rows over
    ``row_axes``, whole on ``model``."""
    mesh = x.device_mesh
    want = rows_heads(mesh, row_axes(mesh, x.shape[0]), 0, None)
    return x if tuple(x.placements) == want else x.redistribute(mesh, want)
