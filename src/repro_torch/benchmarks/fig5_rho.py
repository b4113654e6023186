"""Paper Fig. 5 — sensitivity to the disagreement penalty ρ.  Torch twin of
``benchmarks/fig5_rho.py``."""
from __future__ import annotations

from repro_torch import rng
from repro_torch.benchmarks.common import linreg_algorithm, make_linreg_task
from repro_torch.benchmarks.common import run_train as train

KEY = 2


def fig5_rho_sensitivity(rhos=(0.1, 0.5, 2.0), rounds: int = 150,
                         device="cuda"):
    """Linreg loss after a fixed round budget for several ρ — the paper
    observes larger ρ converges faster with diminishing returns."""
    task = make_linreg_task(KEY, device=device)
    out = {}
    for rho in rhos:
        alg, solver = linreg_algorithm("afadmm", task, rho=rho, noisy=False)
        hist = train(alg, task.theta0, solver, task.grad_fn,
                     rounds, rng.fold_in(KEY, 1),
                     eval_fn=task.eval_fn, eval_every=rounds - 1)
        out[f"rho_{rho:g}"] = {"loss_at_budget": hist.loss[-1]}
    return out
