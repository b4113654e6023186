"""Nested dicts of tensors as trees, with ``jax.tree_util``'s leaf order.

A tree is a dict (keys visited sorted, recursively) whose leaves are
tensors or ``core.cplx.Complex`` pairs (a Complex is one leaf, as the JAX
package's ``is_leaf=_is_cplx`` makes it).  Flattening in the same order as
JAX makes packed offsets, and so every packed buffer, mean the same in both
packages.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

TreeDef = Any


def tree_flatten(tree) -> Tuple[List[Any], TreeDef]:
    """(leaves in sorted-key order, structure)."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves: List[Any] = []
        defs = []
        for k in keys:
            sub, d = tree_flatten(tree[k])
            leaves += sub
            defs.append(d)
        return leaves, (tuple(keys), tuple(defs))
    return [tree], None


def tree_unflatten(treedef: TreeDef, leaves) -> Any:
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        keys, defs = d
        return {k: build(sub) for k, sub in zip(keys, defs)}

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of ``rest`` (same structure)."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(t)[0] for t in rest]
    return tree_unflatten(treedef, [fn(*args) for args in zip(leaves,
                                                              *others)])


def tree_stack(trees, dim: int = 0):
    """Leafwise ``torch.stack`` of same-structure trees."""
    return tree_map(lambda *ls: torch.stack(ls, dim=dim), *trees)
