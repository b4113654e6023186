"""Keyed seeds: the port's stand-in for ``jax.random.fold_in``/``split``.

A key is a plain 64-bit integer.  :func:`fold_in` derives a child key from a
key and an integer with splitmix64, so a stream's draws depend only on the
path of folds that names it, never on how many draws other streams made:
round ``r`` of a run draws from ``fold_in(seed, r + 1)``, as the JAX trainer
does, and its halves are :func:`split`'s folds.  A side branch (such as
``phy.geometry.SHADOW_SALT``) is a ``fold_in`` with a salt, so drawing on
it changes no draw of the base schedule.  :func:`generator` turns a key into
a seeded ``torch.Generator`` on a device.

The bits differ from JAX's threefry; tests that compare the two packages
make their random planes once and hand them to both.
"""
from __future__ import annotations

from typing import Tuple

import torch

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_in(key: int, data: int) -> int:
    """The child key of ``key`` named by ``data``."""
    return _splitmix64(_splitmix64(key & _MASK64) ^ (data & _MASK64))


def split(key: int, num: int = 2) -> Tuple[int, ...]:
    """``num`` independent child keys (the parts of ``jax.random.split``):
    folds 0 … num − 1."""
    return tuple(fold_in(key, i) for i in range(num))


class _MetaGenerator(torch.Generator):
    """A CPU generator that names ``meta`` as its device: torch makes no
    generator on ``meta``, but draws on ``meta`` take a CPU one, and the
    port's draws put their result on ``generator.device``."""

    device = property(lambda self: torch.device("meta"))


def generator(key: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``key`` (on
    ``meta``, a CPU generator that reports ``meta``: the dry run's shapes
    without data)."""
    if torch.device(device).type == "meta":
        g = _MetaGenerator()
    else:
        g = torch.Generator(device=device)
    g.manual_seed(key & _MASK64)
    return g
