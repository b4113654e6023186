"""Paper Fig. 3 — image classification with the 784-128-64-10 MLP
(A-SFADMM / D-SFADMM / A-SGD stochastic variants).  Torch twin of
``benchmarks/fig3_classification.py``; each function also takes the
``scale`` (``common.FAST_SCALE``, the default, or ``PAPER_SCALE``).

(a) test accuracy vs # uploads; (b) accuracy vs SNR; (c) channel uses to a
target accuracy vs # workers.
"""
from __future__ import annotations

from typing import Optional

from repro_torch import rng
from repro_torch.benchmarks.common import (SCALE, Scale, make_mlp_task,
                                           mlp_algorithm)
from repro_torch.benchmarks.common import run_train as train

KEY = 1


def fig3a_comm_efficiency(rounds: Optional[int] = None, device="cuda",
                          scale: Scale = SCALE):
    rounds = scale.mlp_rounds if rounds is None else rounds
    task = make_mlp_task(KEY, scale=scale, device=device)
    out = {}
    for name, kw in [("afadmm", {}),
                     ("dfadmm", {}),
                     ("analog_gd", dict(extra=dict(learning_rate=5e-2,
                                                   epsilon=1e-6)))]:
        alg = mlp_algorithm(name, task, n_sub=scale.mlp_subcarriers, **kw)
        hist = train(alg, task.theta0, task.solver, task.grad_fn, rounds,
                     rng.fold_in(KEY, 1), eval_fn=task.eval_fn,
                     eval_every=max(rounds // 5, 1))
        out["A-S" + name.upper() if name == "afadmm" else name] = {
            "final_accuracy": hist.accuracy[-1],
            "uploads": sum(hist.channel_uses) / max(hist.channel_uses[0], 1),
        }
    return out


def fig3b_energy(snrs=(-10.0, 10.0, 40.0), rounds: Optional[int] = None,
                 device="cuda", scale: Scale = SCALE):
    rounds = scale.mlp_rounds if rounds is None else rounds
    task = make_mlp_task(KEY, scale=scale, device=device)
    out = {}
    for snr in snrs:
        row = {}
        for name in ("afadmm", "dfadmm"):
            alg = mlp_algorithm(name, task, snr_db=snr,
                                n_sub=scale.mlp_subcarriers)
            n_rounds = rounds if name == "afadmm" else max(rounds // 4, 3)
            hist = train(alg, task.theta0, task.solver, task.grad_fn,
                         n_rounds, rng.fold_in(KEY, 2),
                         eval_fn=task.eval_fn,
                         eval_every=max(n_rounds - 1, 1))
            row[name] = hist.accuracy[-1]
        out[f"snr_{snr:g}dB"] = row
    return out


def fig3c_scalability(workers=(5, 10), target_acc: float = 0.5,
                      rounds: Optional[int] = None, device="cuda",
                      scale: Scale = SCALE):
    rounds = scale.mlp_rounds if rounds is None else rounds
    out = {}
    for W in workers:
        task = make_mlp_task(rng.fold_in(KEY, W), n_workers=W, scale=scale,
                             device=device)
        row = {}
        for name in ("afadmm", "dfadmm"):
            alg = mlp_algorithm(name, task, n_sub=scale.mlp_subcarriers)
            hist = train(alg, task.theta0, task.solver, task.grad_fn,
                         rounds, rng.fold_in(KEY, 3),
                         eval_fn=task.eval_fn)
            cum = hist.cumulative_uses()
            idx = next((i for i, a in enumerate(hist.accuracy)
                        if a > target_acc), None)
            row[name] = cum[idx] if idx is not None else float("inf")
        out[f"W={W}"] = row
    return out
