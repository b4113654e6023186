"""Synthetic datasets, statistically matched to the paper's tasks.

The same distributions as ``repro/data/synthetic.py`` (20k × 6 housing-style
regression; 60k/10k 784-dim 10-class images; per-worker skewed token
streams for the LLM trainer), drawn from the port's own
generators: the bits differ from the JAX package's, the statistics do not.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch import rng
from repro_torch.device import resolve_device

Tensor = torch.Tensor


def linreg_dataset(key: int, n_samples: int = 20_000, d: int = 6,
                   noise_std: float = 0.05, feature_corr: float = 0.4,
                   device="cuda") -> Tuple[Tensor, Tensor, Tensor]:
    """Housing-style regression: correlated features, linear teacher.

    Returns (X (n,d), y (n,), theta_teacher (d,)), features normalised to
    zero mean / unit variance."""
    dev = resolve_device(device)
    gx, gt, gn, gc = (rng.generator(rng.fold_in(key, i), dev) for i in range(4))
    base = torch.randn((n_samples, d), generator=gx, device=dev)
    mix = feature_corr * torch.randn((d, d), generator=gc, device=dev) \
        / math.sqrt(d)
    X = base @ (torch.eye(d, device=dev) + mix)
    X = (X - X.mean(0)) / (X.std(0, correction=0) + 1e-8)
    theta = torch.randn((d,), generator=gt, device=dev)
    y = X @ theta + noise_std * torch.randn((n_samples,), generator=gn,
                                            device=dev)
    return X, y, theta


def image_dataset(key: int, n_train: int = 60_000, n_test: int = 10_000,
                  n_classes: int = 10, dim: int = 784,
                  cluster_std: float = 1.0, device="cuda"
                  ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """MNIST-shaped classification: anisotropic Gaussian class clusters on a
    rank-32 manifold, squashed to (0, 1) like pixels.

    Returns (x_train, y_train, x_test, y_test)."""
    dev = resolve_device(device)
    gp, gm, gtr, gte, gltr, glte = (rng.generator(rng.fold_in(key, i), dev)
                                    for i in range(6))
    rank = 32
    protos_low = torch.randn((n_classes, rank), generator=gp, device=dev) * 3.0
    mix = torch.randn((rank, dim), generator=gm, device=dev) / math.sqrt(rank)
    protos = protos_low @ mix                        # (C, dim)

    y_train = torch.randint(0, n_classes, (n_train,), generator=gltr,
                            device=dev)
    y_test = torch.randint(0, n_classes, (n_test,), generator=glte, device=dev)
    x_train = protos[y_train] + cluster_std * torch.randn(
        (n_train, dim), generator=gtr, device=dev)
    x_test = protos[y_test] + cluster_std * torch.randn(
        (n_test, dim), generator=gte, device=dev)
    return torch.sigmoid(x_train), y_train, torch.sigmoid(x_test), y_test


def token_dataset(key: int, n_sequences: int, seq_len: int, vocab_size: int,
                  n_workers: int = 1, skew: float = 2.0,
                  device="cuda") -> Tensor:
    """Synthetic token streams with per-worker unigram skew (non-IID FL).

    Each worker samples from a Zipf-tempered unigram distribution (logit
    −skew·log rank) under a worker-specific random permutation of the
    vocabulary, so local losses genuinely disagree.  Returns
    (n_workers, n_sequences, seq_len) int32."""
    dev = resolve_device(device)
    ranks = torch.arange(1, vocab_size + 1, dtype=torch.float32, device=dev)
    probs = torch.softmax(-skew * torch.log(ranks), dim=0)
    out = []
    for w in range(n_workers):
        gp, gs = (rng.generator(k, dev) for k in rng.split(rng.fold_in(key, w)))
        perm = torch.randperm(vocab_size, generator=gp, device=dev)
        p = probs[torch.argsort(perm)]
        ids = torch.multinomial(p, n_sequences * seq_len, replacement=True,
                                generator=gs)
        out.append(ids.reshape(n_sequences, seq_len))
    return torch.stack(out).to(torch.int32)
