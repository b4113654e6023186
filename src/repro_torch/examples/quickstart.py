"""Quickstart: A-FADMM on federated linear regression.  Torch twin of
``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Ten workers share one wireless channel; their model updates superpose over
the air (one channel use per round, whatever the worker count) and the
parameter server never sees any individual model.
"""
from __future__ import annotations

import argparse
import math

import torch

from repro_torch import rng
from repro_torch.core.admm import AdmmConfig
from repro_torch.core.aggregators import make
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.subcarrier import SubcarrierPlan
from repro_torch.data.synthetic import linreg_dataset
from repro_torch.device import resolve_device
from repro_torch.optim.local_solvers import exact_quadratic_solver

W, D, ROUNDS = 10, 6, 200


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card, default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    key = 0

    # federated data: 10 workers, equal IID shards
    X, y, _ = linreg_dataset(key, n_samples=2000, d=D, device=dev)
    m = 2000 // W
    Xw = X[: m * W].reshape(W, m, D) / math.sqrt(m)
    yw = y[: m * W].reshape(W, m) / math.sqrt(m)
    theta_star = torch.linalg.solve(X.T @ X, X.T @ y)

    def f(th) -> float:
        return float(torch.mean((y - X @ th) ** 2))

    # the wireless channel and the algorithm
    acfg = AdmmConfig(rho=0.5)                     # paper Sec. 5 default
    ccfg = ChannelConfig(n_workers=W, n_subcarriers=10, snr_db=40.0)
    alg = make("afadmm", acfg, ccfg, SubcarrierPlan.build(D, 10))
    solver = exact_quadratic_solver(Xw, yw, acfg.rho)

    def grad_fn(theta):
        r = torch.einsum("wmd,wd->wm", Xw, theta) - yw
        return 2.0 * torch.einsum("wmd,wm->wd", Xw, r)

    theta0 = torch.randn((W, D), generator=rng.generator(key, dev),
                         device=dev)
    st = alg.init(key, theta0)
    gap = uses = float("nan")
    for r in range(args.rounds):
        st, metrics = alg.round(rng.fold_in(key, r), st, solver, grad_fn)
        if r % 40 == 0 or r == args.rounds - 1:
            gap = abs(f(alg.global_model(st)) - f(theta_star))
            uses = float(metrics["channel_uses"])
            print(f"round {r:3d}  optimality gap {gap:.3e}  "
                  f"channel uses/round {uses:.0f}")
    print("NB: one channel use per round — independent of the number of "
          "workers.")
    return {"final_gap": gap, "channel_uses_per_round": uses}


if __name__ == "__main__":
    main()
