"""Federated data sharding: IID split + per-round minibatch sampling.

Counterpart of the IID half of ``repro/data/federated.py``.  The minibatch
draw is split from the lookup so that a round's indices can be made once
(``core.admm.RoundDraws.batch_idx``) and replayed.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch import rng
from repro_torch.device import resolve_device

Tensor = torch.Tensor


def split_iid(key: int, n_samples: int, n_workers: int,
              device="cuda") -> Tensor:
    """Random equal partition. Returns (W, n_samples // W) index tensor."""
    dev = resolve_device(device)
    per = n_samples // n_workers
    perm = torch.randperm(n_samples, generator=rng.generator(key, dev),
                          device=dev)
    return perm[: per * n_workers].reshape(n_workers, per)


@dataclasses.dataclass(frozen=True)
class BatchFn:
    """Per-worker minibatches from each worker's own shard.

    ``draw(gen, n_steps)`` makes ``(n_steps, W, B)`` shard-local indices,
    each uniform over the shard (the paper's "mini-batch of size 100 at
    random"); ``batch_fn(idx)`` turns one step's ``(W, B)`` indices into a
    tuple of ``(W, B, ...)`` tensors."""

    data: Tuple[Tensor, ...]
    shards: Tensor       # (W, per) global sample ids
    batch_size: int

    def draw(self, gen: torch.Generator, n_steps: int) -> Tensor:
        W, per = self.shards.shape
        return torch.randint(0, per, (n_steps, W, self.batch_size),
                             generator=gen, device=self.shards.device)

    def __call__(self, idx: Tensor) -> Tuple[Tensor, ...]:
        flat = torch.gather(self.shards, 1, idx)     # (W, B) global ids
        return tuple(x[flat] for x in self.data)


def make_batch_fn(data: Tuple[Tensor, ...], shards: Tensor,
                  batch_size: int) -> BatchFn:
    return BatchFn(data=tuple(data), shards=shards, batch_size=batch_size)
