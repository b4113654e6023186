"""Paper-scale federated trainer: flat-vector models over the simulated
wireless channel, driving the paper's Sec. 5 experiments (linreg + MLP).

Counterpart of ``repro/train/fl_trainer.py``.  The JAX package has two
drivers (a compiled ``lax.scan`` and a Python loop) that it pins as bitwise
equal; the port has the one round loop.  Round ``r`` uses the round key
``fold_in(key, r + 1)``, as both JAX drivers do.  Metrics, evals and a
round's channel uses (a tensor when they depend on the drawn channel, as
D-FADMM's do) stay on the device until the run ends, so the loop never
waits for the card.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from repro_torch import rng
from repro_torch.core.admm import RoundDraws

Tensor = torch.Tensor


@dataclasses.dataclass
class History:
    loss: List[float] = dataclasses.field(default_factory=list)
    accuracy: List[float] = dataclasses.field(default_factory=list)
    channel_uses: List[float] = dataclasses.field(default_factory=list)
    extra: Dict[str, List[float]] = dataclasses.field(default_factory=dict)

    def cumulative_uses(self) -> List[float]:
        out, tot = [], 0.0
        for u in self.channel_uses:
            tot += u
            out.append(tot)
        return out


def _eval_rounds(n_rounds: int, eval_every: int) -> List[bool]:
    return [(r % eval_every == 0 or r == n_rounds - 1)
            for r in range(n_rounds)]


def train(algorithm, theta0: Tensor, local_solve: Callable, grad_fn: Callable,
          n_rounds: int, key: int,
          eval_fn: Optional[Callable[[Tensor], Dict[str, Tensor]]] = None,
          eval_every: int = 1, init_state=None,
          draws: Optional[Callable[[int], RoundDraws]] = None) -> History:
    """Run ``n_rounds`` of federated optimisation.

    Args:
      algorithm: an object from ``core.aggregators``.
      theta0: (W, d) initial local models, on the run's device.
      local_solve/grad_fn: see ``core.aggregators``.
      eval_fn: global-model evaluator -> {"loss": ..., ("accuracy": ...)},
        called after every ``eval_every``-th round and the last.
      init_state: start from this algorithm state instead of
        ``algorithm.init(key, theta0)``.
      draws: ``r -> RoundDraws`` replaces round r's own random planes.
    """
    st = algorithm.init(key, theta0) if init_state is None else init_state
    do_eval = _eval_rounds(n_rounds, eval_every) if eval_fn is not None \
        else [False] * n_rounds
    hist = History()
    uses: List = []
    metrics_log: Dict[str, List[Tensor]] = {}
    evals: List[Dict[str, Tensor]] = []
    for r in range(n_rounds):
        st, metrics = algorithm.round(
            rng.fold_in(key, r + 1), st, local_solve, grad_fn,
            draws=None if draws is None else draws(r))
        uses.append(metrics.pop("channel_uses"))
        for k, v in metrics.items():
            metrics_log.setdefault(k, []).append(v)
        if do_eval[r]:
            evals.append(eval_fn(algorithm.global_model(st)))
    # one transfer per series, after the last round
    tensors = [u for u in uses if torch.is_tensor(u)]
    fetched = iter(torch.stack(tensors).tolist() if tensors else ())
    hist.channel_uses = [next(fetched) if torch.is_tensor(u) else float(u)
                         for u in uses]
    for k, vals in metrics_log.items():
        hist.extra[k] = torch.stack(vals).tolist()
    if evals:
        hist.loss = torch.stack([e["loss"] for e in evals]).tolist()
        if "accuracy" in evals[0]:
            hist.accuracy = torch.stack([e["accuracy"]
                                         for e in evals]).tolist()
    return hist
