"""Minimal functional optimizers (SGD / Adam) for the local primal steps.
Counterpart of ``repro/optim/optimizers.py``: like JAX's, they take one
tensor or a tree (nested dicts) of tensors.  ``count`` is a host int."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.tree import tree_map

Tensor = torch.Tensor
PyTree = Any


class OptState(NamedTuple):
    mu: PyTree     # first moment (the momentum buffer for sgd)
    nu: PyTree     # second moment (unused by sgd: the same object as mu)
    count: int


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], OptState]
    update: Callable[[PyTree, OptState, PyTree], Tuple[PyTree, OptState]]


def sgd(learning_rate: float, momentum: float = 0.0) -> Optimizer:
    def init(params: PyTree) -> OptState:
        z = tree_map(torch.zeros_like, params)
        return OptState(mu=z, nu=z, count=0)

    def update(grads, state, params):
        mu = tree_map(lambda m, g: momentum * m + g, state.mu, grads)
        new_params = tree_map(lambda p, m: p - learning_rate * m, params, mu)
        return new_params, OptState(mu=mu, nu=state.nu, count=state.count + 1)

    return Optimizer(init=init, update=update)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    def init(params: PyTree) -> OptState:
        return OptState(mu=tree_map(torch.zeros_like, params),
                        nu=tree_map(torch.zeros_like, params), count=0)

    def update(grads, state, params):
        count = state.count + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
        mhat_s = 1.0 / (1 - b1 ** count)
        vhat_s = 1.0 / (1 - b2 ** count)
        new_params = tree_map(
            lambda p, m, v: p - learning_rate * (m * mhat_s) / (
                torch.sqrt(v * vhat_s) + eps), params, mu, nu)
        return new_params, OptState(mu=mu, nu=nu, count=count)

    return Optimizer(init=init, update=update)
