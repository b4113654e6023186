"""Logical-axis sharding names: the port's counterpart of
``repro/models/sharding.py``.

Model code may annotate activations with logical axis names
(``shard(x, "batch", "seq", "embed")``); :func:`axis_rules` binds the
names to mesh axes.  In eager torch no compiler partitions a tensor by its
annotation, so :func:`shard` is the identity, as the JAX package's is
outside a mesh; under a binding it checks that the annotation names every
dim.  The rules are what ``launch/shardings`` specialises per arch, and
what ``models/partition.partition_for`` reads: a product partitions over
``model`` by hand (the port's counterpart of XLA partitioning an
annotated one) where the rules bind its ``heads``, ``kv_heads``, ``ff``
or ``vocab`` axis to ``model``.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

MeshAxis = Union[str, Sequence[str], None]

_ACTIVE: dict = {"mesh": None, "rules": None}

#: default logical->mesh bindings (the JAX package's, name for name)
DEFAULT_RULES: Dict[str, MeshAxis] = {
    "batch": "data",        # (joined with "pod" by the multi-pod launcher)
    "worker": "data",       # FL worker axis (replicated mode)
    "seq": None,
    "res_seq": None,        # layer-boundary residual seq dim
    "kv_seq": "model",      # decode caches: sequence sharded over model
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "vocab": "model",
    "expert": "model",
    "moe_group": "data",    # grouped-dispatch token groups
    "lru": "model",
    "inner": "model",       # mamba d_inner
    "state": None,
    "fsdp": "data",         # param dim for 2D-sharded (sketched-mode) archs
}


@contextlib.contextmanager
def axis_rules(mesh, rules: Optional[Dict[str, MeshAxis]] = None):
    """Bind logical axis names to ``mesh``'s axes for the enclosed code."""
    prev = dict(_ACTIVE)
    _ACTIVE["mesh"] = mesh
    _ACTIVE["rules"] = dict(DEFAULT_RULES if rules is None else rules)
    try:
        yield
    finally:
        _ACTIVE.update(prev)


def current_mesh():
    """The mesh :func:`axis_rules` bound, or None."""
    return _ACTIVE["mesh"]


def spec_for(*names: Optional[str]) -> Tuple[MeshAxis, ...]:
    """The mesh axes of each logical name (None where unbound): a spec, one
    entry per dim."""
    rules = _ACTIVE["rules"] or {}
    return tuple(rules.get(n) if n else None for n in names)


def shard(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """``x`` unchanged; under a binding, one logical name per dim is
    required, as in the JAX package."""
    if _ACTIVE["mesh"] is not None and len(names) != x.dim():
        raise ValueError(f"shard: {len(names)} names for a tensor of "
                         f"shape {tuple(x.shape)}")
    return x
