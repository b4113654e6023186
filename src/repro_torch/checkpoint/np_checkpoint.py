"""Checkpointing: a state's leaves in one ``.npz``, keyed by tree path.
Counterpart of ``repro/checkpoint/np_checkpoint.py``, with its file format.

A leaf's key is the ``|``-joined path of names that reaches it, as the JAX
package writes it: a dict key as itself, a list or tuple item as ``#i``, a
NamedTuple's or a dataclass's field by its name (``Complex`` as ``re`` and
``im``).  A field that is None holds no leaf.  So the port's states
(``AFadmmState``, ``ChannelBlock``, ``TreeFLState``, ``PhyState``,
``FaultState``, ``OptState`` …) give the same key for the same leaf as the
JAX package's, and a checkpoint written by either restores into the other's
state.  A port field whose name differs from the JAX field it stands for
is renamed through :data:`FIELD_KEYS`.

The port keeps some scalars on the host (a round counter, a channel block's
age): they are written as 0-d int32/bool/float32 arrays, as JAX holds them,
and restored as host values.  bf16 is stored as f32 and cast back on
restore.  The copy to the host is one ``.cpu()`` a leaf; a tensor reached
twice (sgd's fresh ``nu`` is its ``mu``) is copied once and written under
both keys, and each key restores its own leaf, as in JAX.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

PyTree = Any

_SEP = "|"

#: (class name, port field) -> the path part the JAX package writes for it,
#: where the two differ.  JAX flattens its ``ChannelBlock`` by position, so
#: its fields are keyed ``0`` … ``3``; every other state the port
#: checkpoints names its fields as the JAX package does.
FIELD_KEYS: Dict[Tuple[str, str], str] = {
    ("ChannelBlock", "h"): "0", ("ChannelBlock", "h_prev"): "1",
    ("ChannelBlock", "changed"): "2", ("ChannelBlock", "age"): "3"}


def _fields(x) -> Iterator[Tuple[str, Any]]:
    """(path part, child) of one tree node, in the JAX package's order."""
    if isinstance(x, dict):
        for k in sorted(x):
            yield str(k), x[k]
    elif isinstance(x, tuple) and hasattr(x, "_fields"):
        for f in x._fields:
            yield FIELD_KEYS.get((type(x).__name__, f), f), getattr(x, f)
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield f"#{i}", v
    else:
        for f in dataclasses.fields(x):
            yield (FIELD_KEYS.get((type(x).__name__, f.name), f.name),
                   getattr(x, f.name))


def _is_node(x) -> bool:
    return (isinstance(x, (dict, list, tuple))
            or (dataclasses.is_dataclass(x) and not isinstance(x, type)))


def _walk(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) of every leaf; None holds none."""
    if tree is None:
        return
    if _is_node(tree):
        for part, child in _fields(tree):
            yield from _walk(child, prefix + (part,))
        return
    yield prefix, tree


def _to_np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:   # npz can't hold bf16
            t = t.float()
        return t.numpy()
    if isinstance(v, bool):
        return np.asarray(v, np.bool_)
    if isinstance(v, int):
        return np.asarray(v, np.int32)
    if isinstance(v, float):
        return np.asarray(v, np.float32)
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return a


def save(path: str, tree: PyTree) -> None:
    """Write ``tree``'s leaves to ``path`` (one ``.npz``), through a
    temporary file renamed into place, so a run killed while writing never
    leaves a truncated snapshot under the round's name."""
    arrays: Dict[str, np.ndarray] = {}
    host: Dict[int, np.ndarray] = {}
    for p, v in _walk(tree):
        key = _SEP.join(p)
        if isinstance(v, torch.Tensor):
            if id(v) not in host:
                host[id(v)] = _to_np(v)
            arrays[key] = host[id(v)]
        else:
            arrays[key] = _to_np(v)
    path = path if path.endswith(".npz") else path + ".npz"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


_ROUND_RE = re.compile(r"^round_(\d+)\.npz$")


def round_path(directory: str, r: int) -> str:
    """Canonical per-round checkpoint filename (fixed width so lexical
    order == round order)."""
    return os.path.join(directory, f"round_{int(r):08d}.npz")


def latest_round(directory: str):
    """Highest round number with a ``round_*.npz`` checkpoint in
    ``directory``, or None if there is none (missing dir included)."""
    if not os.path.isdir(directory):
        return None
    rounds = [int(m.group(1)) for f in os.listdir(directory)
              if (m := _ROUND_RE.match(f))]
    return max(rounds) if rounds else None


def restore(path: str, like: PyTree) -> PyTree:
    """Restore into the structure of ``like``: every leaf shape-checked,
    cast to ``like``'s dtype and put on its device; a host scalar of
    ``like`` comes back as a host value of its type.  A missing leaf raises
    ``KeyError`` and a shape mismatch ``ValueError``, each naming the
    leaf's key."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as zf:
        data = {k: zf[k] for k in zf.files}

    def leaf(key: str, proto):
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = data[key]
        shape = tuple(proto.shape) if isinstance(proto, torch.Tensor) \
            else np.shape(proto)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"{key}: shape {arr.shape} != {shape}")
        if isinstance(proto, torch.Tensor):
            return torch.from_numpy(np.array(arr, order="C")).to(
                device=proto.device, dtype=proto.dtype)
        if isinstance(proto, (bool, int, float)):
            return type(proto)(arr.item())
        return arr.astype(np.asarray(proto).dtype)

    def build(x, prefix):
        if x is None:
            return None
        if not _is_node(x):
            return leaf(_SEP.join(prefix), x)
        if isinstance(x, dict):
            return {k: build(v, prefix + (str(k),)) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(build(v, prefix + (part,))
                             for part, v in _fields(x)))
        if isinstance(x, (list, tuple)):
            return type(x)(build(v, prefix + (f"#{i}",))
                           for i, v in enumerate(x))
        return dataclasses.replace(x, **{
            f.name: build(v, prefix + (part,))
            for f, (part, v) in zip(dataclasses.fields(x), _fields(x))})

    return build(like, ())
