"""Shared benchmark infrastructure: the paper's two tasks and their algorithm
runners.  Counterpart of ``benchmarks/common.py``: d = 6 linear regression
over 10 subcarriers and the MLP over 512 (FAST) or 4096 subcarriers.

The scale lives here so every figure uses one setting: :data:`FAST_SCALE`
(the default, the JAX benchmarks' own) shrinks workers, widths and rounds
about 5-10× against :data:`PAPER_SCALE` but keeps every ratio the paper's
claims depend on (bandwidth per worker, model/subcarrier ratio,
coherence).  Every task is built on an explicit ``device``, the card unless
the caller asks for the CPU.

Minibatches: the twin draws a fresh one for each local step (the paper's
"mini-batch of size 100 at random"), from the round key, through the
solver's and A-GD's ``draw_batches``.  JAX's MLP task advances a host
counter each time its ``grad_fn`` is traced, so under its compiled round
driver one minibatch serves every step of a block of rounds; a test that
holds the twin to JAX replays that schedule.
"""
from __future__ import annotations

import dataclasses
import math
import os
import statistics
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import rng
from repro_torch.core.admm import AdmmConfig
from repro_torch.core.aggregators import make
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.subcarrier import SubcarrierPlan
from repro_torch.core.transport import check_backend_choice
from repro_torch.data.federated import BatchFn, make_batch_fn, split_iid
from repro_torch.data.synthetic import image_dataset, linreg_dataset
from repro_torch.device import resolve_device
from repro_torch.models.mlp import (init_mlp_flat, make_loss_fns,
                                    mlp_unflatten)
from repro_torch.optim.local_solvers import (exact_quadratic_solver,
                                             prox_adam_solver)
from repro_torch.optim.optimizers import adam
from repro_torch.train.fl_trainer import train

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Scale:
    """Workers, widths and round budgets of one benchmark scale."""

    linreg_workers: int
    mlp_workers: int
    mlp_sizes: Tuple[int, ...]
    mlp_subcarriers: int
    mlp_rounds: int
    mlp_local_iters: int
    mlp_samples: Tuple[int, int]     # (train, test)


FAST_SCALE = Scale(linreg_workers=10, mlp_workers=10,
                   mlp_sizes=(64, 32, 16, 10), mlp_subcarriers=512,
                   mlp_rounds=25, mlp_local_iters=5,
                   mlp_samples=(4000, 800))
PAPER_SCALE = Scale(linreg_workers=100, mlp_workers=100,
                    mlp_sizes=(784, 128, 64, 10), mlp_subcarriers=4096,
                    mlp_rounds=200, mlp_local_iters=20,
                    mlp_samples=(60000, 10000))

FAST = True
SCALE = FAST_SCALE if FAST else PAPER_SCALE

LINREG_WORKERS = SCALE.linreg_workers
LINREG_ROUNDS = 300
MLP_WORKERS = SCALE.mlp_workers
MLP_SIZES = SCALE.mlp_sizes
MLP_IMG_DIM = MLP_SIZES[0]
MLP_SUBCARRIERS = SCALE.mlp_subcarriers
MLP_ROUNDS = SCALE.mlp_rounds


def _with_ota_backend(name: str, extra: Optional[dict]) -> dict:
    """Algorithm keywords, after ``REPRO_OTA_BACKEND`` is checked: JAX's
    figure code passes it to A-FADMM as ``backend=``; the port takes the
    kernel route always, so it accepts ``"pallas"`` and refuses ``"jnp"``
    (``core.transport.check_backend_choice``) and passes nothing on."""
    kw = dict(extra or {})
    if name == "afadmm":
        check_backend_choice(kw.pop("backend", None)
                             or os.environ.get("REPRO_OTA_BACKEND") or None)
    return kw


# ---------------------------------------------------------------------------
# Fig. 2 / Fig. 5: linear regression
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LinregTask:
    X: Tensor            # (W, m, d), scaled by 1/√m
    y: Tensor
    theta0: Tensor
    f_star: float
    eval_fn: Callable
    grad_fn: Callable
    d: int = 6


def linreg_task(X: Tensor, y: Tensor, theta0: Tensor) -> LinregTask:
    """The task on the samples X (n, d), y (n,) split evenly over the
    W = ``theta0.shape[0]`` workers (the remainder dropped), on their
    device; the loss is the optimality gap |f(Θ) − f*| of the mean squared
    error over every sample."""
    W, d = theta0.shape
    m = X.shape[0] // W
    Xw = X[: m * W].reshape(W, m, d) / math.sqrt(m)
    yw = y[: m * W].reshape(W, m) / math.sqrt(m)

    def f_total(th):
        r = y - X @ th
        return torch.mean(r * r)

    theta_star = torch.linalg.solve(X.T @ X, X.T @ y)
    f_star = float(f_total(theta_star))

    def grad_fn(theta):
        r = torch.einsum("wmd,wd->wm", Xw, theta) - yw
        return 2.0 * torch.einsum("wmd,wm->wd", Xw, r)

    def eval_fn(Theta):
        return {"loss": torch.abs(f_total(Theta) - f_star)}

    return LinregTask(X=Xw, y=yw, theta0=theta0, f_star=f_star,
                      eval_fn=eval_fn, grad_fn=grad_fn, d=d)


def make_linreg_task(key: int, n_workers: int = LINREG_WORKERS,
                     n_samples: int = 2000, device="cuda") -> LinregTask:
    dev = resolve_device(device)
    X, y, _ = linreg_dataset(key, n_samples, 6, device=dev)
    theta0 = torch.randn((n_workers, 6), device=dev,
                         generator=rng.generator(rng.fold_in(key, 9), dev))
    return linreg_task(X, y, theta0)


def linreg_algorithm(name: str, task: LinregTask, *, snr_db=40.0,
                     noisy=True, rho=0.5, n_sub=10, extra=None):
    W = task.theta0.shape[0]
    acfg = AdmmConfig(rho=rho, flip_on_change=True, power_control=True)
    ccfg = ChannelConfig(n_workers=W, n_subcarriers=n_sub, snr_db=snr_db,
                         noisy=noisy)
    plan = SubcarrierPlan.build(task.d, n_sub)
    alg = make(name, acfg, ccfg, plan, **_with_ota_backend(name, extra))
    solver = exact_quadratic_solver(task.X, task.y, rho)
    return alg, solver


# ---------------------------------------------------------------------------
# Fig. 3: the MLP classifier
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MinibatchGrad:
    """Each worker's ∂f on its own minibatch.  ``draw_batches(gen)`` makes
    one gradient's (W, B) shard-local indices (A-GD's round draws them
    with its channel); ``grad_fn(theta, batch_idx)`` computes it."""

    grad: Callable
    batch_fn: BatchFn

    def draw_batches(self, gen: torch.Generator) -> Tensor:
        return self.batch_fn.draw(gen, 1)[0]

    def __call__(self, theta: Tensor, batch_idx: Tensor) -> Tensor:
        return self.grad(theta, *self.batch_fn(batch_idx))


@dataclasses.dataclass
class MlpTask:
    theta0: Tensor
    solver: Callable
    grad_fn: MinibatchGrad
    eval_fn: Callable
    d: int


def mlp_task(data: Tuple[Tensor, Tensor, Tensor, Tensor], shards: Tensor,
             theta0: Tensor, sizes: Tuple[int, ...],
             rho: float = 0.5, local_iters: int = 5, lr: float = 0.01,
             batch: int = 100) -> MlpTask:
    """The task on given data (x_train, y_train, x_test, y_test), shards
    (W, per) and (W, d) initial local models, on their device:
    ``local_iters`` prox-Adam steps a round at ``lr`` on minibatches of
    ``batch``; the eval is the test loss and accuracy of Θ."""
    xtr, ytr, xte, yte = data
    loss, grad, acc = make_loss_fns(mlp_unflatten(sizes))
    batch_fn = make_batch_fn((xtr, ytr), shards, batch_size=batch)
    solver = prox_adam_solver(lambda th, b: grad(th, *b), adam(lr),
                              n_steps=local_iters, rho=rho, batch_fn=batch_fn)

    def eval_fn(Theta):
        return {"loss": loss(Theta[None], xte[None], yte[None])[0],
                "accuracy": acc(Theta[None], xte[None], yte[None])[0]}

    return MlpTask(theta0=theta0, solver=solver,
                   grad_fn=MinibatchGrad(grad, batch_fn), eval_fn=eval_fn,
                   d=theta0.shape[1])


def make_mlp_task(key: int, n_workers: Optional[int] = None, rho: float = 0.5,
                  local_iters: Optional[int] = None, lr: float = 0.01,
                  batch: int = 100, scale: Scale = SCALE,
                  device="cuda") -> MlpTask:
    """The image task at ``scale`` (workers and local steps default to the
    scale's): cluster_std 3.0 keeps it unsaturated at the FAST scale, so the
    algorithms' ranking (paper Fig. 3) stays visible."""
    dev = resolve_device(device)
    W = scale.mlp_workers if n_workers is None else n_workers
    n_train, n_test = scale.mlp_samples
    data = image_dataset(key, n_train, n_test, dim=scale.mlp_sizes[0],
                         cluster_std=3.0, device=dev)
    shards = split_iid(rng.fold_in(key, 1), n_train, W, device=dev)
    flat0, _ = init_mlp_flat(rng.fold_in(key, 2), scale.mlp_sizes, device=dev)
    d = flat0.numel()
    theta0 = flat0[None].expand(W, d) + 0.01 * torch.randn(
        (W, d), generator=rng.generator(key, dev), device=dev)
    return mlp_task(data, shards, theta0, scale.mlp_sizes, rho=rho,
                    local_iters=(scale.mlp_local_iters if local_iters is None
                                 else local_iters), lr=lr, batch=batch)


def mlp_algorithm(name: str, task: MlpTask, *, snr_db=40.0, noisy=True,
                  rho=0.5, n_sub=MLP_SUBCARRIERS, extra=None):
    W = task.theta0.shape[0]
    acfg = AdmmConfig(rho=rho, flip_on_change=False, power_control=True)
    ccfg = ChannelConfig(n_workers=W, n_subcarriers=n_sub, snr_db=snr_db,
                         noisy=noisy)
    plan = SubcarrierPlan.build(task.d, n_sub)
    return make(name, acfg, ccfg, plan, **_with_ota_backend(name, extra))


#: JAX's ``run_train`` picks one of two round drivers; the port has one
run_train = train


def timed(fn: Callable) -> Dict:
    t0 = time.time()
    derived = fn()
    return {"seconds": time.time() - t0, "derived": derived}


# ---------------------------------------------------------------------------
# device timing on the card
# ---------------------------------------------------------------------------

#: CUDA-event timings a call the medians of :func:`time_ms` take by default
TIMED_RUNS = 25
#: GPU cycles to spin before each timed call (~3 ms on an H100): the host
#: enqueues the start event, the call's launches and the end event while the
#: card is still busy, so the interval holds device time only and not the
#: wrapper's host-side launch gap
SPIN_CYCLES = 5_000_000


def time_ms(fn: Callable, runs: int = TIMED_RUNS, warmup: int = 3,
            spin: bool = True) -> float:
    """Median over ``runs`` CUDA-event timings of one call of ``fn`` on the
    current card.  With ``spin`` each call is queued behind a GPU spin, so
    only device time is measured; without it the interval also holds the
    host's time to issue the call (the wrapper's checks and launch) while
    the card waits."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
