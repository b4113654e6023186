"""Paper-scale federated trainer: flat-vector models over the simulated
wireless channel, driving the paper's Sec. 5 experiments (linreg + MLP).

Counterpart of ``repro/train/fl_trainer.py``.  Two drivers share one
``History`` contract:

* ``driver="scan"`` (default) — the block driver: blocks of rounds (a
  channel coherence block by default) through the algorithm's
  ``scan_rounds``, metrics and evals stacked on the device and copied to
  the host once a block.  Durable progress: with ``checkpoint_dir`` and
  ``checkpoint_every`` the state is snapshotted at the block boundaries
  (``repro_torch.checkpoint``), and ``resume=True`` restarts from the
  latest snapshot.
* ``driver="loop"`` — one round and one host synchronisation a round.

Round ``r`` uses the key ``fold_in(key, r + 1)`` of its global index
under both, so the two drivers give equal histories bit for bit, and a run
killed at any round and resumed equals the uninterrupted run, whatever
block boundaries either used.  Metrics (loss / accuracy / channel uses /
the ``obs/`` telemetry, a (W,) leaf as a list) are recorded per round.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from repro_torch import rng
from repro_torch.checkpoint import latest_round, restore, round_path, save
from repro_torch.core.admm import RoundDraws
from repro_torch.core.aggregators import stack_rows

Tensor = torch.Tensor

#: most rounds in one block of the scan driver (keeps the stacked metrics
#: small even for huge coherence blocks)
MAX_BLOCK_ROUNDS = 128


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


def _metric_entries(v) -> list:
    """Per-round history entries from a (T,) or (T, k) stacked metric (a
    tensor, copied to the host once): scalar metrics become floats, vector
    metrics (the per-worker ``obs/tx_energy``) lists of floats."""
    t = torch.as_tensor(v).detach()
    if t.dim() <= 1:
        return [float(x) for x in t.reshape(-1).tolist()]
    return [[float(x) for x in row]
            for row in t.reshape(t.shape[0], -1).tolist()]


def _record_metrics(hist: History, metrics: Dict[str, Tensor]) -> None:
    for k, v in metrics.items():
        vals = _metric_entries(v)
        if k == "channel_uses":
            hist.channel_uses.extend(vals)
        else:
            hist.extra.setdefault(k, []).extend(vals)


def train_scan(algorithm, theta0: Tensor, local_solve: Callable,
               grad_fn: Callable, n_rounds: int, key: int,
               eval_fn: Optional[Callable[[Tensor], Dict[str, Tensor]]] = None,
               eval_every: int = 1,
               block_rounds: Optional[int] = None,
               start_round: int = 0,
               init_state=None,
               checkpoint_dir: Optional[str] = None,
               checkpoint_every: int = 0,
               sink=None,
               draws: Optional[Callable[[int], RoundDraws]] = None
               ) -> History:
    """The block driver: rounds ``start_round`` … ``n_rounds − 1`` in
    blocks of ``block_rounds`` (default: the algorithm's channel coherence
    block, ``ccfg.coherence_iters``), each one ``scan_rounds`` call and one
    copy of its metrics and evals to the host.

    With ``checkpoint_dir`` and ``checkpoint_every > 0`` the state is
    snapshotted (``round_path(checkpoint_dir, stop)``) at each block
    boundary ``stop`` at least ``checkpoint_every`` rounds past the last
    snapshot, and at the run's end.  Resume by passing the restored state
    as ``init_state`` and its round as ``start_round``
    (:func:`resume_state`).  ``sink`` (a ``repro_torch.obs.sink
    .MetricsSink``) logs every round of every block.  ``draws(r)``
    replaces round r's random planes.
    """
    st = algorithm.init(key, theta0) if init_state is None else init_state
    if block_rounds is None:
        ccfg = getattr(algorithm, "ccfg", None)
        block_rounds = ccfg.coherence_iters if ccfg is not None else 16
    span = max(1, n_rounds - start_round)
    block_rounds = max(1, min(int(block_rounds), span, MAX_BLOCK_ROUNDS))
    do_eval = _eval_rounds(n_rounds, eval_every) if eval_fn is not None \
        else [False] * n_rounds
    hist = History()
    last_ckpt = start_round
    for start in range(start_round, n_rounds, block_rounds):
        stop = min(start + block_rounds, n_rounds)
        out = algorithm.scan_rounds(key, st, local_solve, grad_fn,
                                    range(start, stop), eval_fn=eval_fn,
                                    eval_mask=do_eval[start:stop],
                                    draws=draws)
        st, metrics = out[0], out[1]
        host = {k: v.cpu() for k, v in metrics.items()}  # the block's copy
        _record_metrics(hist, host)
        if sink is not None:
            sink.log_rounds(start, host)
        if eval_fn is not None and any(do_eval[start:stop]):
            evals = {k: v.tolist() for k, v in out[2].items()}
            for i, r in enumerate(range(start, stop)):
                if do_eval[r]:
                    hist.loss.append(float(evals["loss"][i]))
                    if "accuracy" in evals:
                        hist.accuracy.append(float(evals["accuracy"][i]))
        if (checkpoint_dir and checkpoint_every > 0
                and (stop - last_ckpt >= checkpoint_every
                     or stop == n_rounds)):
            save(round_path(checkpoint_dir, stop), st)
            last_ckpt = stop
    return hist


def resume_state(algorithm, theta0: Tensor, key: int, checkpoint_dir: str):
    """The latest ``round_*.npz`` snapshot in ``checkpoint_dir``, restored
    into the structure (shapes, dtypes, device) of ``algorithm.init(key,
    theta0)``.  Returns ``(state, round)`` — feed them to
    :func:`train_scan` as ``init_state``/``start_round`` — or ``(None, 0)``
    when the directory holds no snapshot (a fresh start)."""
    r = latest_round(checkpoint_dir)
    if r is None:
        return None, 0
    like = algorithm.init(key, theta0)
    return restore(round_path(checkpoint_dir, r), like), r


def train_loop(algorithm, theta0: Tensor, local_solve: Callable,
               grad_fn: Callable, n_rounds: int, key: int,
               eval_fn: Optional[Callable[[Tensor], Dict[str, Tensor]]] = None,
               eval_every: int = 1, sink=None, init_state=None,
               draws: Optional[Callable[[int], RoundDraws]] = None
               ) -> History:
    """One round and one host synchronisation a round (its metrics and
    eval read back before the next round starts)."""
    st = algorithm.init(key, theta0) if init_state is None else init_state
    do_eval = _eval_rounds(n_rounds, eval_every)
    hist = History()
    for r in range(n_rounds):
        st, metrics = algorithm.round(
            rng.fold_in(key, r + 1), st, local_solve, grad_fn,
            draws=None if draws is None else draws(r))
        hist.channel_uses.append(float(metrics["channel_uses"]))
        if eval_fn is not None and do_eval[r]:
            ev = eval_fn(algorithm.global_model(st))
            hist.loss.append(float(ev["loss"]))
            if "accuracy" in ev:
                hist.accuracy.append(float(ev["accuracy"]))
        if sink is not None:
            sink.log_round(r, metrics)
        for k, v in metrics.items():
            if k == "channel_uses":
                continue
            hist.extra.setdefault(k, []).extend(
                _metric_entries(stack_rows([v])))
    return hist


def train(algorithm, theta0: Tensor, local_solve: Callable, grad_fn: Callable,
          n_rounds: int, key: int,
          eval_fn: Optional[Callable[[Tensor], Dict[str, Tensor]]] = None,
          eval_every: int = 1, driver: str = "scan",
          block_rounds: Optional[int] = None,
          checkpoint_dir: Optional[str] = None,
          checkpoint_every: int = 0, resume: bool = False,
          sink=None, init_state=None,
          draws: Optional[Callable[[int], RoundDraws]] = None) -> History:
    """Run ``n_rounds`` of federated optimisation.

    Args:
      algorithm: an object from ``core.aggregators``.
      theta0: (W, d) initial local models, on the run's device.
      local_solve/grad_fn: see ``core.aggregators``.
      eval_fn: global-model evaluator -> {"loss": ..., ("accuracy": ...)},
        called after every ``eval_every``-th round and the last.
      driver: ``"scan"`` (blocks of rounds, one host copy a block) or
        ``"loop"`` (one host synchronisation a round).
      checkpoint_dir/checkpoint_every: the scan driver's snapshots at block
        boundaries; ``resume=True`` restarts from the latest snapshot in
        ``checkpoint_dir``, bit for bit the uninterrupted run.
      sink: a ``repro_torch.obs.sink.MetricsSink`` that logs every round.
      init_state: start from this algorithm state instead of
        ``algorithm.init(key, theta0)`` (a resumed snapshot wins over it).
      draws: ``r -> RoundDraws`` replaces round r's own random planes.
    """
    if driver == "scan":
        start_round = 0
        if resume and checkpoint_dir:
            restored, start_round = resume_state(algorithm, theta0, key,
                                                 checkpoint_dir)
            if restored is not None:
                init_state = restored
        return train_scan(algorithm, theta0, local_solve, grad_fn, n_rounds,
                          key, eval_fn, eval_every, block_rounds,
                          start_round=start_round, init_state=init_state,
                          checkpoint_dir=checkpoint_dir,
                          checkpoint_every=checkpoint_every, sink=sink,
                          draws=draws)
    if driver == "loop":
        return train_loop(algorithm, theta0, local_solve, grad_fn, n_rounds,
                          key, eval_fn, eval_every, sink=sink,
                          init_state=init_state, draws=draws)
    raise ValueError(f"unknown driver {driver!r}; want 'scan' or 'loop'")
