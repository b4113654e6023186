"""The paper's DNN: a 784-128-64-10 ReLU MLP operated as a *flat parameter
vector* (the representation A-FADMM transmits on subcarriers).

The flat layout is the JAX package's (``repro/models/mlp.py``): per layer,
``W`` of shape (in, out) row-major, then ``b``; a layer computes
``h @ W + b``.  Here every function is batched over workers: parameters are
(W, d), inputs (W, B, in), and the products are ``torch.bmm``.
"""
from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple

import torch

from repro_torch import rng
from repro_torch.device import resolve_device

Tensor = torch.Tensor
Unflatten = Callable[[Tensor], List[Tuple[Tensor, Tensor]]]


def mlp_unflatten(sizes: Sequence[int]) -> Unflatten:
    """``unflatten(vec (W, d)) -> [(w (W, in, out), b (W, out)), ...]``,
    views into ``vec``."""
    shapes = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        shapes += [(a, b), (b,)]

    def unflatten(vec: Tensor):
        out, off = [], 0
        for shp in shapes:
            n = math.prod(shp)
            out.append(vec[:, off:off + n].reshape(vec.shape[0], *shp))
            off += n
        return [(out[2 * i], out[2 * i + 1]) for i in range(len(shapes) // 2)]

    return unflatten


def init_mlp_flat(key: int, sizes: Sequence[int],
                  device="cuda") -> Tuple[Tensor, Unflatten]:
    """Returns (flat_params (d,), unflatten).  Layer i's weights are
    N(0, 2/in) (He init) from ``fold_in(key, i)``; biases are zero."""
    dev = resolve_device(device)
    parts = []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        g = rng.generator(rng.fold_in(key, i), dev)
        w = torch.randn((a, b), generator=g, device=dev) * math.sqrt(2.0 / a)
        parts += [w.reshape(-1), torch.zeros(b, device=dev)]
    return torch.cat(parts), mlp_unflatten(sizes)


def mlp_apply(vec: Tensor, x: Tensor, unflatten: Unflatten) -> Tensor:
    """Logits (W, B, out) of each worker's MLP ``vec[w]`` on ``x[w]``."""
    layers = unflatten(vec)
    h = x
    for w, b in layers[:-1]:
        h = torch.relu(torch.bmm(h, w) + b[:, None, :])
    w, b = layers[-1]
    return torch.bmm(h, w) + b[:, None, :]


def make_loss_fns(unflatten: Unflatten):
    """Returns (loss, grad, accuracy), each ``(vec (W, d), x (W, B, in),
    y (W, B)) -> ...``: per-worker mean cross-entropy (W,), its gradient
    (W, d), and per-worker accuracy (W,).

    Worker n's loss depends only on row n of ``vec``, so the gradient of the
    sum of the workers' losses is, row by row, each worker's own gradient
    (the JAX package's ``vmap(grad)``)."""

    def loss(vec: Tensor, x: Tensor, y: Tensor) -> Tensor:
        logp = torch.log_softmax(mlp_apply(vec, x, unflatten), dim=-1)
        return -logp.gather(-1, y[..., None]).squeeze(-1).mean(-1)

    def grad(vec: Tensor, x: Tensor, y: Tensor) -> Tensor:
        with torch.enable_grad():
            v = vec.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(loss(v, x, y).sum(), v)
        return g

    def accuracy(vec: Tensor, x: Tensor, y: Tensor) -> Tensor:
        logits = mlp_apply(vec, x, unflatten)
        return (logits.argmax(-1) == y).float().mean(-1)

    return loss, grad, accuracy
