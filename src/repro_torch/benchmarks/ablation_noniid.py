"""Beyond-paper ablation: non-IID (Dirichlet) federated data.  Torch twin of
``benchmarks/ablation_noniid.py``.

The paper's experiments use equal IID shards. Under label-skewed shards the
per-worker optima genuinely disagree; ADMM's dual variables absorb the
disagreement, so A-FADMM should retain accuracy where plain analog gradient
averaging degrades. Reported: test accuracy after a fixed round budget, IID
vs Dirichlet(0.3), for A-FADMM and A-GD.  :func:`ablation_decentralized`
runs the paper's §6 chain without a parameter server.
"""
from __future__ import annotations

import math

import torch

from repro_torch import rng
from repro_torch.benchmarks.common import (MLP_IMG_DIM, MLP_SIZES,
                                           MLP_SUBCARRIERS, mlp_task)
from repro_torch.benchmarks.common import run_train as train
from repro_torch.core.admm import AdmmConfig
from repro_torch.core.aggregators import make
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.decentralized import (AnalogGadmm,
                                            gadmm_quadratic_solver)
from repro_torch.core.subcarrier import SubcarrierPlan
from repro_torch.data.federated import split_dirichlet, split_iid
from repro_torch.data.synthetic import image_dataset, linreg_dataset
from repro_torch.device import resolve_device
from repro_torch.models.mlp import init_mlp_flat

KEY = 7


def _task(split: str, n_workers: int = 8, rho: float = 0.5, device="cuda"):
    dev = resolve_device(device)
    n_train, n_test = 4000, 800
    data = image_dataset(KEY, n_train, n_test, dim=MLP_IMG_DIM,
                         cluster_std=3.0, device=dev)
    if split == "iid":
        shards = split_iid(rng.fold_in(KEY, 1), n_train, n_workers,
                           device=dev)
    else:
        shards = split_dirichlet(rng.fold_in(KEY, 1), data[1], n_workers,
                                 alpha=0.3)
    flat0, _ = init_mlp_flat(rng.fold_in(KEY, 2), MLP_SIZES, device=dev)
    d = flat0.numel()
    theta0 = flat0[None].expand(n_workers, d) + 0.01 * torch.randn(
        (n_workers, d), generator=rng.generator(KEY, dev), device=dev)
    return mlp_task(data, shards, theta0, MLP_SIZES, rho=rho,
                    local_iters=5, lr=0.01, batch=64)


#: the decentralized ablation's key, as JAX's ``PRNGKey(11)``
DECENTRALIZED_KEY = 11


def decentralized_task(key: int, W: int, d: int, device):
    """The ablation's samples X (2000, d), y (2000,) and the chain's
    initial models (W, d), on ``device``."""
    X, y, _ = linreg_dataset(key, 2000, d, device=device)
    theta0 = torch.randn((W, d), generator=rng.generator(key, device),
                         device=device)
    return X, y, theta0


def ablation_decentralized(rounds: int = 300, device="cuda"):
    """Paper §6 "Decentralized Architecture": chain GADMM with analog
    neighbour links vs the PS-based algorithms: 2 channel uses a round
    (spatial reuse), and no worker ever talks to a central server."""
    dev = resolve_device(device)
    key = DECENTRALIZED_KEY
    W, d = 8, 6
    X, y, theta0 = decentralized_task(key, W, d, dev)
    m = 2000 // W
    Xw = X[: m * W].reshape(W, m, d) / math.sqrt(m)
    yw = y[: m * W].reshape(W, m) / math.sqrt(m)
    theta_star = torch.linalg.solve(X.T @ X, X.T @ y)

    def f(th):
        return float(torch.mean((y - X @ th) ** 2))

    ccfg = ChannelConfig(n_workers=W, n_subcarriers=d, noisy=True,
                         snr_db=40.0)
    alg = AnalogGadmm(ccfg=ccfg, plan=SubcarrierPlan.build(d, d), rho=1.0)
    solver = gadmm_quadratic_solver(Xw, yw, alg.rho)
    st, met = alg.scan_rounds(key, alg.init(key, theta0), solver, None,
                              rounds)
    return {
        "final_gap": abs(f(alg.global_model(st)) - f(theta_star)),
        "consensus_gap": float(met["consensus_gap"][-1]),
        "channel_uses_per_round": float(met["channel_uses"][-1]),
    }


def ablation_noniid(rounds: int = 20, device="cuda"):
    out = {}
    for split in ("iid", "dirichlet0.3"):
        task = _task(split, device=device)
        W = task.theta0.shape[0]
        row = {}
        for name, extra in [("afadmm", None),
                            ("analog_gd", dict(learning_rate=5e-2,
                                               epsilon=1e-6))]:
            acfg = AdmmConfig(rho=0.5, flip_on_change=False,
                              power_control=True)
            ccfg = ChannelConfig(n_workers=W, n_subcarriers=MLP_SUBCARRIERS,
                                 snr_db=40.0)
            alg = make(name, acfg, ccfg,
                       SubcarrierPlan.build(task.d, MLP_SUBCARRIERS),
                       **(extra or {}))
            hist = train(alg, task.theta0, task.solver, task.grad_fn, rounds,
                         rng.fold_in(KEY, 9), eval_fn=task.eval_fn,
                         eval_every=rounds - 1)
            row[name] = hist.accuracy[-1]
        out[split] = row
    return out
