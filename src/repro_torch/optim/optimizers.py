"""Minimal functional optimizers (SGD / Adam) for the local primal steps,
on one parameter tensor.  Counterpart of ``repro/optim/optimizers.py``."""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Tuple

import torch

Tensor = torch.Tensor


class OptState(NamedTuple):
    mu: Tensor     # first moment (the momentum buffer for sgd)
    nu: Tensor     # second moment (unused by sgd)
    count: int


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tensor], OptState]
    update: Callable[[Tensor, OptState, Tensor], Tuple[Tensor, OptState]]


def sgd(learning_rate: float, momentum: float = 0.0) -> Optimizer:
    def init(params: Tensor) -> OptState:
        z = torch.zeros_like(params)
        return OptState(mu=z, nu=z, count=0)

    def update(grads, state, params):
        mu = momentum * state.mu + grads
        return (params - learning_rate * mu,
                OptState(mu=mu, nu=state.nu, count=state.count + 1))

    return Optimizer(init=init, update=update)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    def init(params: Tensor) -> OptState:
        return OptState(mu=torch.zeros_like(params),
                        nu=torch.zeros_like(params), count=0)

    def update(grads, state, params):
        count = state.count + 1
        mu = b1 * state.mu + (1 - b1) * grads
        nu = b2 * state.nu + (1 - b2) * grads * grads
        mhat_s = 1.0 / (1 - b1 ** count)
        vhat_s = 1.0 / (1 - b2 ** count)
        new_params = params - learning_rate * (mu * mhat_s) / (
            torch.sqrt(nu * vhat_s) + eps)
        return new_params, OptState(mu=mu, nu=nu, count=count)

    return Optimizer(init=init, update=update)
