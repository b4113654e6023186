"""Federated data sharding: IID and Dirichlet non-IID splits + per-round
minibatch sampling.

Counterpart of ``repro/data/federated.py``.  The minibatch draw is split
from the lookup so that a round's indices can be made once
(``core.admm.RoundDraws.batch_idx``) and replayed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

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


def _gamma(gen: torch.Generator, alpha: float, shape) -> Tensor:
    """Gamma(alpha, 1) draws on ``gen``'s device: Marsaglia and Tsang's
    squeeze-free rejection for shape ≥ 1, boosted by U^(1/alpha) below 1
    (``torch.distributions`` takes no generator)."""
    dev = gen.device
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.empty(shape, device=dev).reshape(-1)
    todo = torch.arange(out.numel(), device=dev)
    while todo.numel():
        x = torch.randn(todo.numel(), generator=gen, device=dev)
        u = torch.rand(todo.numel(), generator=gen, device=dev)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp(min=1e-30)))
        out[todo[ok]] = (d * v)[ok]
        todo = todo[~ok]
    out = out.reshape(shape)
    if alpha < 1.0:
        out = out * torch.rand(shape, generator=gen, device=dev) ** (1.0
                                                                     / alpha)
    return out


def split_dirichlet(key: int, labels: Tensor, n_workers: int,
                    alpha: float = 0.5,
                    n_classes: Optional[int] = None) -> Tensor:
    """Label-skewed partition on ``labels``' device: worker w draws classes
    ~ Dir(alpha).

    Returns (W, per) indices (per = n // W; the trailing remainder is
    dropped).  Each sample is assigned a worker from its class's Dirichlet
    row, then the shards are rebalanced to equal sizes by sorting on
    (assigned worker, random tiebreak), so each worker's shard stays
    dominated by its preferred classes."""
    dev = labels.device
    n = labels.shape[0]
    C = int(n_classes if n_classes is not None else int(labels.max()) + 1)
    gd, ga, gt = (rng.generator(k, dev) for k in rng.split(key, 3))
    g = _gamma(gd, alpha, (C, n_workers))
    probs = g / g.sum(-1, keepdim=True)                  # class -> worker
    assign = torch.multinomial(probs[labels] + 1e-9, 1,
                               generator=ga).squeeze(-1)
    # lexsort on (assign, tiebreak): sort by the tiebreak, then stably by
    # the assigned worker
    by_tiebreak = torch.argsort(torch.rand(n, generator=gt, device=dev))
    order = by_tiebreak[torch.argsort(assign[by_tiebreak], stable=True)]
    per = n // n_workers
    return order[: per * n_workers].reshape(n_workers, per)


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
