"""Beyond-paper ablation: non-IID (Dirichlet) federated data.  Torch twin of
``benchmarks/ablation_noniid.py``.

The paper's experiments use equal IID shards. Under label-skewed shards the
per-worker optima genuinely disagree; ADMM's dual variables absorb the
disagreement, so A-FADMM should retain accuracy where plain analog gradient
averaging degrades. Reported: test accuracy after a fixed round budget, IID
vs Dirichlet(0.3), for A-FADMM and A-GD.
"""
from __future__ import annotations

import torch

from repro_torch import rng
from repro_torch.benchmarks.common import (MLP_IMG_DIM, MLP_SIZES,
                                           MLP_SUBCARRIERS, mlp_task)
from repro_torch.benchmarks.common import run_train as train
from repro_torch.core.admm import AdmmConfig
from repro_torch.core.aggregators import make
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.subcarrier import SubcarrierPlan
from repro_torch.data.federated import split_dirichlet, split_iid
from repro_torch.data.synthetic import image_dataset
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


def ablation_decentralized(rounds: int = 300, device="cuda"):
    """Paper §6's chain GADMM with analog neighbour links: not ported."""
    raise NotImplementedError(
        "ablation_decentralized needs core/decentralized.py (AnalogGadmm), "
        "which is not ported yet (ROADMAP queue A item 5)")


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
