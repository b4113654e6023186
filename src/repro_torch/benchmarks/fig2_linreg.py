"""Paper Fig. 2 — linear regression over the simulated wireless channel.
Torch twin of ``benchmarks/fig2_linreg.py``.

(a) communication efficiency: loss vs # uploads, A-FADMM vs D-FADMM vs
    D-FADMM-10x vs A-GD (truncated channel inversion);
(b) energy efficiency: final loss vs SNR under a channel-use budget;
(c) scalability: channel uses to reach a target loss vs # workers.
"""
from __future__ import annotations

from repro_torch import rng
from repro_torch.benchmarks.common import (LINREG_ROUNDS, linreg_algorithm,
                                           make_linreg_task)
from repro_torch.benchmarks.common import run_train as train

KEY = 0


def fig2a_comm_efficiency(rounds: int = LINREG_ROUNDS, device="cuda"):
    """loss-vs-uploads curves. Derived: uploads each algorithm needs to hit
    the paper's 1e-4 target (A-FADMM lowest; A-GD stalls)."""
    task = make_linreg_task(KEY, device=device)
    out = {}
    for name, n_sub, extra in [("afadmm", 10, None),
                               ("dfadmm", 10, None),
                               ("dfadmm-10x", 100, None),
                               ("analog_gd", 10,
                                dict(learning_rate=1e-2, epsilon=1e-6))]:
        alg, solver = linreg_algorithm(name.split("-")[0], task,
                                       n_sub=n_sub, extra=extra)
        hist = train(alg, task.theta0, solver, task.grad_fn, rounds,
                     rng.fold_in(KEY, 1), eval_fn=task.eval_fn)
        target = 1e-4
        idx = next((i for i, l in enumerate(hist.loss) if l < target), None)
        cum = hist.cumulative_uses()
        out[name] = {"final_loss": hist.loss[-1],
                     "rounds_to_1e-4": None if idx is None else idx + 1,
                     "channel_uses_to_1e-4":
                         None if idx is None else cum[idx]}
    return out


def fig2b_energy(budget_uses: float = 300.0,
                 snrs=(-10.0, 0.0, 10.0, 20.0, 40.0), device="cuda"):
    """Paper Fig 2(b): loss at a FIXED total channel-use budget vs SNR.

    A-FADMM spends 1 use/round regardless of SNR; D-FADMM's uses/round grow
    as the Shannon rate drops, so at low SNR it completes far fewer rounds —
    the paper's energy-efficiency crossover."""
    task = make_linreg_task(KEY, device=device)
    out = {}
    for snr in snrs:
        row = {}
        for name in ("afadmm", "dfadmm"):
            alg, solver = linreg_algorithm(name, task, snr_db=snr)
            hist = train(alg, task.theta0, solver, task.grad_fn,
                         LINREG_ROUNDS, rng.fold_in(KEY, 2),
                         eval_fn=task.eval_fn)
            cum = hist.cumulative_uses()
            idx = max((i for i, c in enumerate(cum) if c <= budget_uses),
                      default=0)
            row[name] = hist.loss[min(idx, len(hist.loss) - 1)]
            row[name + "_rounds_in_budget"] = idx + 1
        out[f"snr_{snr:g}dB"] = row
    return out


def fig2c_scalability(workers=(5, 10, 20), target: float = 1e-3,
                      device="cuda"):
    """channel uses until target loss vs number of workers."""
    out = {}
    for W in workers:
        task = make_linreg_task(rng.fold_in(KEY, W), n_workers=W,
                                device=device)
        row = {}
        for name in ("afadmm", "dfadmm"):
            alg, solver = linreg_algorithm(name, task, snr_db=40.0)
            hist = train(alg, task.theta0, solver, task.grad_fn,
                         LINREG_ROUNDS, rng.fold_in(KEY, 3),
                         eval_fn=task.eval_fn)
            cum = hist.cumulative_uses()
            idx = next((i for i, l in enumerate(hist.loss) if l < target),
                       None)
            row[name] = cum[idx] if idx is not None else float("inf")
        out[f"W={W}"] = row
    return out
