"""Packed-buffer pytree transport: flatten a parameter tree into ONE
contiguous ``(..., D)`` f32 buffer so the whole OTA uplink is a single
kernel chain per round instead of one per leaf.  Counterpart of the
single-device half of ``repro/core/packing.py``.

A :class:`PackSpec` holds per-leaf offsets and sizes in the packed vector,
plus the shapes and dtypes needed to unpack the received global model.
Leaves are visited in ``jax.tree_util``'s order (dict keys sorted,
recursively; ``repro_torch.tree``), so offsets, sizes and packed buffers
equal the JAX package's for the same tree.

Leaves may carry leading batch dims (the worker axis ``W``): a leaf of shape
``lead + spec.shapes[i]`` packs into ``lead + (sizes[i],)``; all leaves of
one ``pack`` call share ``lead``.  Complex trees (duals λ, fading h) pack
planewise via :func:`pack_cplx` / :func:`unpack_cplx`.  The shard-local
layout (``ShardPackSpec``) is not ported (ROADMAP queue A item 6).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.core.cplx import Complex
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

Tensor = torch.Tensor
PyTree = Any


class PackSpec(NamedTuple):
    """Static layout of a tree inside a flat packed buffer."""

    treedef: Any                          # tree structure (Complex = leaf)
    shapes: Tuple[Tuple[int, ...], ...]   # per-leaf element shape (no batch dims)
    dtypes: Tuple[Any, ...]               # per-leaf dtype (for bit-compatible unpack)
    offsets: Tuple[int, ...]              # start of each leaf in the packed axis
    sizes: Tuple[int, ...]                # elements per leaf
    d: int                                # total packed length Σ sizes

    @property
    def n_leaves(self) -> int:
        return len(self.shapes)


def build_packspec(tree: PyTree, batch_dims: int = 0) -> PackSpec:
    """Layout of ``tree``'s leaves (skipping ``batch_dims`` leading axes,
    e.g. 1 for worker-major ``(W, ...)`` trees) inside one packed vector."""
    leaves, treedef = tree_flatten(tree)
    shapes, dtypes, offsets, sizes = [], [], [], []
    off = 0
    for leaf in leaves:
        t = leaf.re if isinstance(leaf, Complex) else leaf
        eshape = tuple(t.shape[batch_dims:])
        size = math.prod(eshape)
        shapes.append(eshape)
        dtypes.append(t.dtype)
        offsets.append(off)
        sizes.append(size)
        off += size
    return PackSpec(treedef=treedef, shapes=tuple(shapes),
                    dtypes=tuple(dtypes), offsets=tuple(offsets),
                    sizes=tuple(sizes), d=off)


def _lead(spec: PackSpec, leaf: Tensor, i: int) -> Tuple[int, ...]:
    nb = leaf.dim() - len(spec.shapes[i])
    if nb < 0 or tuple(leaf.shape[nb:]) != spec.shapes[i]:
        raise ValueError(
            f"leaf {i} shape {tuple(leaf.shape)} does not end with spec "
            f"shape {spec.shapes[i]}")
    return tuple(leaf.shape[:nb])


def pack(spec: PackSpec, tree: PyTree) -> Tensor:
    """``tree`` -> ``lead + (spec.d,)`` f32 buffer (row-major per leaf).
    Each leaf is cast and copied once into the buffer, with no f32 copy of
    the leaf on the side."""
    leaves = tree_flatten(tree)[0]
    if len(leaves) != spec.n_leaves:
        raise ValueError(f"tree has {len(leaves)} leaves, spec expects "
                         f"{spec.n_leaves}")
    lead = _lead(spec, leaves[0], 0)
    buf = torch.empty(lead + (spec.d,), dtype=torch.float32,
                      device=leaves[0].device)
    for i, leaf in enumerate(leaves):
        li = _lead(spec, leaf, i)
        if li != lead:
            raise ValueError(f"leaf {i} leading dims {li} != leaf 0 leading "
                             f"dims {lead}")
        off, n = spec.offsets[i], spec.sizes[i]
        buf[..., off:off + n].copy_(leaf.reshape(lead + (n,)))
    return buf


def unpack(spec: PackSpec, buf: Tensor, cast: bool = True) -> PyTree:
    """``lead + (spec.d,)`` buffer -> tree of views into it; ``cast=True``
    restores the recorded leaf dtypes (a copy where the dtype differs),
    ``cast=False`` keeps the buffer dtype (the analog path's f32)."""
    if buf.shape[-1] != spec.d:
        raise ValueError(f"buffer last dim {buf.shape[-1]} != spec.d {spec.d}")
    lead = tuple(buf.shape[:-1])
    out = []
    for i in range(spec.n_leaves):
        off, n = spec.offsets[i], spec.sizes[i]
        piece = buf[..., off:off + n].reshape(lead + spec.shapes[i])
        out.append(piece.to(spec.dtypes[i]) if cast else piece)
    return tree_unflatten(spec.treedef, out)


def pack_cplx(spec: PackSpec, tree: PyTree) -> Complex:
    """Complex-leaf tree -> Complex of packed planes."""
    return Complex(pack(spec, tree_map(lambda c: c.re, tree)),
                   pack(spec, tree_map(lambda c: c.im, tree)))


def unpack_cplx(spec: PackSpec, buf: Complex) -> PyTree:
    """Complex packed planes -> tree of Complex leaves (f32 views: duals and
    fading always live in f32, never the parameter dtype)."""
    re = tree_flatten(unpack(spec, buf.re, cast=False))[0]
    im = tree_flatten(unpack(spec, buf.im, cast=False))[0]
    return tree_unflatten(spec.treedef,
                          [Complex(r, i) for r, i in zip(re, im)])
