"""Trees of dicts, lists and tuples: the walkers the optimizer, the
sharding rules and the ZeRO-3 route share (the reference uses
``jax.tree``)."""
from __future__ import annotations

__all__ = ["tree_map", "tree_map_n", "tree_leaves", "is_spec"]


def is_spec(x) -> bool:
    """A leaf of a tree of specs or logical axes: those are tuples."""
    return isinstance(x, tuple)


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree`` (dicts, lists and tuples of
    tensors), with the matching subtrees of ``rest`` (which may hold more
    structure below a leaf of ``tree``, as quantized moments do).  A node
    for which ``is_leaf`` holds is a leaf."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


class _Results(tuple):
    """The values ``tree_map_n``'s function returned for one leaf."""


def _pick(tree, i):
    if isinstance(tree, _Results):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    out = [_pick(v, i) for v in tree]
    return out if isinstance(tree, list) else tuple(out)


def tree_map_n(fn, n: int, tree, *rest) -> tuple:
    """``tree_map`` for a function that returns ``n`` values per leaf: ``n``
    trees of ``tree``'s structure."""
    out = tree_map(lambda *leaves: _Results(fn(*leaves)), tree, *rest)
    return tuple(_pick(out, i) for i in range(n))


def tree_leaves(tree) -> list:
    """The leaves in order, None (an absent subtree) skipped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]
