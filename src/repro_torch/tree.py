"""Nested dicts and lists of tensors as trees, with ``jax.tree_util``'s
leaf order.

A tree is a dict (keys visited sorted, recursively) or a list (items in
index order; an empty list holds no leaf, as in JAX) whose leaves are
tensors or ``core.cplx.Complex`` pairs (a Complex is one leaf, as the JAX
package's ``is_leaf=_is_cplx`` makes it).  Flattening in the same order as
JAX makes packed offsets, and so every packed buffer, mean the same in both
packages.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

import torch

TreeDef = Any


def tree_flatten(tree) -> Tuple[List[Any], TreeDef]:
    """(leaves in sorted-key and index order, structure)."""
    if isinstance(tree, (dict, list)):
        keys = sorted(tree) if isinstance(tree, dict) else None
        leaves: List[Any] = []
        defs = []
        for item in (tree[k] for k in keys) if keys is not None else tree:
            sub, d = tree_flatten(item)
            leaves += sub
            defs.append(d)
        return leaves, (keys if keys is None else tuple(keys), tuple(defs))
    return [tree], None


def tree_unflatten(treedef: TreeDef, leaves) -> Any:
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        keys, defs = d
        if keys is None:
            return [build(sub) for sub in defs]
        return {k: build(sub) for k, sub in zip(keys, defs)}

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_paths(tree, prefix: Tuple[str, ...] = ()
               ) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) of every leaf in flatten order: a dict key as itself, a
    list item as ``#i`` (the names ``jax.tree_util``'s key paths give)."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, list):
        return [pl for i, v in enumerate(tree)
                for pl in tree_paths(v, prefix + (f"#{i}",))]
    return [(prefix, tree)]


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


def to_device(obj, device):
    """A copy of ``obj`` with every tensor detached onto ``device``.  Dicts,
    lists, tuples (named ones too: a trainer state with its channel and
    optimizer state, a round's draws, a ``Complex``) and dataclass
    instances (a ``ChannelBlock``) are walked field by field, other values
    kept.  An object reached twice is copied once, so aliases survive the
    move (sgd's ``nu`` is its ``mu``)."""
    memo = {}

    def move(x):
        if id(x) in memo:
            return memo[id(x)]
        if isinstance(x, torch.Tensor):
            out = x.detach().to(device)
        elif isinstance(x, dict):
            out = {k: move(v) for k, v in x.items()}
        elif isinstance(x, list):
            out = [move(v) for v in x]
        elif isinstance(x, tuple):
            items = [move(v) for v in x]
            out = type(x)(*items) if hasattr(x, "_fields") else tuple(items)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            out = dataclasses.replace(x, **{
                f.name: move(getattr(x, f.name))
                for f in dataclasses.fields(x) if f.init})
        else:
            return x
        memo[id(x)] = out
        return out

    return move(obj)
