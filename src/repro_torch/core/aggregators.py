"""Federated aggregation algorithms: the trainer's plug point.

    alg = make("afadmm", acfg, ccfg, plan)          # scenario=... optional
    st  = alg.init(key, theta0)                     # theta0: (W, d)
    st, m = alg.round(key, st, local_solve, grad_fn)
    Theta = alg.global_model(st)

Counterpart of ``repro/core/aggregators.py``, with the paper's Sec. 5
benchmark set:

* ``afadmm``    — A-FADMM (the paper): analog OTA, no channel inversion;
* ``dfadmm``    — D-FADMM: digital orthogonal-subcarrier ADMM (Appendix A),
                  Shannon-rate channel-use accounting (Appendix H);
* ``analog_gd`` — A-GD: first-order analog FL with truncated channel
                  inversion (transmit only where |h| ≥ ε) [refs 9-11];
* ``fedavg``    — plain FedAvg over an ideal link.

Keys are integers (``repro_torch.rng``); the device is that of ``theta0``.
Every algorithm's ``round`` draws its random planes from the round key, as
the JAX round does, or takes them ready-made from its ``draw`` (a
``core.admm.RoundDraws``), so a test can replay the JAX package's planes.
With a ``repro_torch.phy`` scenario A-FADMM's channel is the scenario's:
its state rides in ``AFadmmState.phys`` and it supplies the round's
participation mask and the workers' CSI.  With a ``repro_torch.faults
.FaultPlan`` the fault state rides in ``AFadmmState.flt``, its draws come
from the round key's ``FAULT_SALT`` side branch (so an all-zero plan changes
no draw of the fault-free run), and a ``GuardConfig`` guards the uplink.
With a ``repro_torch.core.cohort.CohortConfig`` A-FADMM's state is a
population's and each round runs the sampled cohort's rows only; the
cohort's plane comes from the round key's ``COHORT_SALT`` side branch.

Every algorithm also has :meth:`ScanRounds.scan_rounds`, a block of
rounds at their global indices with the metrics stacked on the device (the
block driver ``train.fl_trainer.train_scan`` runs), and A-FADMM takes a
``telemetry`` knob (``repro_torch.obs``) that adds its ``obs/`` keys.

A-GD masks its truncated workers with ``where``, not by multiplying as the
JAX round does, so a non-finite gradient behind a truncated channel never
reaches Θ.  D-FADMM's channel uses are a 0-dim tensor on the run's device
(they depend on the drawn channel); the others' are host floats.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch import obs as _obs
from repro_torch import rng
from repro_torch.core import admm, cohort as _cohort, cplx, subcarrier
from repro_torch.core.admm import (AdmmConfig, AFadmmState, GradFn,
                                   LocalSolve, RoundDraws)
from repro_torch.core.channel import (ChannelBlock, ChannelConfig,
                                      init_channel, matched_filter_noise,
                                      rayleigh, redraws, shannon_rate,
                                      step_channel)
from repro_torch.core.cplx import Complex
from repro_torch.core.subcarrier import SubcarrierPlan
from repro_torch.core.transport import matched_filter_noise_re
from repro_torch.faults import guards as _guards
from repro_torch.faults import plan as _fplan

Tensor = torch.Tensor

#: fold of the round key that seeds the local solver's minibatch draw
BATCH_SALT = 2


def _batches(fn, key: int, dev) -> Optional[Tensor]:
    """``fn.draw_batches`` on the round key's ``BATCH_SALT`` fold, or None
    for a function that takes no minibatches."""
    draw_batches = getattr(fn, "draw_batches", None)
    if draw_batches is None:
        return None
    return draw_batches(rng.generator(rng.fold_in(key, BATCH_SALT), dev))


def stack_rows(values: list) -> Tensor:
    """One metric's rows as a (T, ...) tensor: tensors stacked on their
    device, host numbers as a float64 CPU tensor (exact for the floats)."""
    if all(torch.is_tensor(v) for v in values):
        return torch.stack(values)
    return torch.tensor([float(v) for v in values], dtype=torch.float64)


class ScanRounds:
    """``scan_rounds``, shared by every algorithm: a block of rounds in one
    call, the torch counterpart of the JAX package's ``lax.scan`` over
    rounds.  Round ``r`` (its global index) uses the key ``fold_in(key,
    r + 1)``, as a driver that calls ``round`` once a round does, so a
    block's history is bit for bit that driver's."""

    def scan_rounds(self, key: int, st, local_solve, grad_fn,
                    rounds: int | Sequence[int],
                    eval_fn: Optional[Callable] = None,
                    eval_mask: Optional[Sequence[bool]] = None,
                    draws: Optional[Callable[[int], RoundDraws]] = None):
        """Run ``rounds`` (an int n for rounds 0 … n−1, or the global
        round indices) one after another without reading a value back.

        Returns ``(state, metrics)`` with each metric's rows stacked to
        (T, ...) on the device (host numbers as a float64 CPU tensor); with
        ``eval_fn``, ``(state, metrics, evals)``: ``eval_fn`` of the
        post-round global model where ``eval_mask`` is true (every round
        without a mask), zeros of its shape elsewhere (an empty dict when
        no round of the block evaluates).  ``draws(r)`` replaces round
        r's own random planes."""
        rounds = list(range(rounds)) if isinstance(rounds, int) \
            else [int(r) for r in rounds]
        if eval_mask is None:
            eval_mask = [True] * len(rounds)
        rows: Dict[str, list] = {}
        evals: list = []
        for r, do_ev in zip(rounds, eval_mask):
            st, m = self.round(rng.fold_in(key, r + 1), st, local_solve,
                               grad_fn,
                               draws=None if draws is None else draws(r))
            for k, v in m.items():
                rows.setdefault(k, []).append(v)
            if eval_fn is not None:
                evals.append(eval_fn(self.global_model(st)) if do_ev
                             else None)
        metrics = {k: stack_rows(v) for k, v in rows.items()}
        if eval_fn is None:
            return st, metrics
        like = next((e for e in evals if e is not None), None)
        if like is None:
            return st, metrics, {}
        zero = {k: torch.zeros_like(v) for k, v in like.items()}
        return st, metrics, {
            k: torch.stack([(zero if e is None else e)[k] for e in evals])
            for k in like}


@dataclasses.dataclass(frozen=True)
class AFadmm(ScanRounds):
    acfg: AdmmConfig
    ccfg: ChannelConfig
    plan: SubcarrierPlan
    #: optional ``repro_torch.phy.Scenario``; None keeps the legacy i.i.d.
    #: block-fading channel
    scenario: Optional[Any] = None
    #: optional ``repro_torch.faults.FaultPlan`` (crash / straggler /
    #: corruption / burst injection) and ``GuardConfig`` (round health
    #: guard); None keeps the fault-free round
    faults: Optional[_fplan.FaultPlan] = None
    guard: Optional[_guards.GuardConfig] = None
    #: optional ``repro_torch.core.cohort.CohortConfig``: ``theta0``, the
    #: duals and the phy and fault state are population-wide, and each
    #: round only the sampled cohort's rows run it; the others keep their θ
    #: and λ.  None, or ``cohort == population``, is the unsampled round
    cohort: Optional[_cohort.CohortConfig] = None
    #: optional ``repro_torch.obs.TelemetryConfig`` (or True): the round's
    #: ``obs/`` keys (``admm.afadmm_round``), and a sampled round's
    #: ``obs/cohort_*``.  None keeps the round bit for bit
    telemetry: Optional[Any] = None

    name = "afadmm"

    def init(self, key: int, theta0: Tensor) -> AFadmmState:
        kc, _ = rng.split(key)
        W, d = theta0.shape
        flt = None
        if self.faults is not None:
            flt = _fplan.init(self.faults, W, d, theta0.device)
        if self.scenario is None:
            blk = init_channel(rng.generator(kc, theta0.device), self.ccfg,
                               n_coeffs=theta0.shape[-1])
            return admm.init_state(theta0, blk, flt=flt)
        phys = self.scenario.init(kc, W, d, theta0.device)
        return admm.init_state(theta0, self._as_block(phys, phys.h, False),
                               phys=phys, flt=flt)

    @staticmethod
    def _as_block(phys, h_prev, changed: bool) -> ChannelBlock:
        """ChannelBlock view of a PhyState (the flip rule reads .changed)."""
        return ChannelBlock(
            h=phys.h, h_prev=h_prev,
            changed=torch.full((), changed, dtype=torch.bool,
                               device=phys.h.re.device).expand(
                                   phys.h.re.shape),
            age=phys.age)

    def draw(self, key: int, st: AFadmmState,
             local_solve: LocalSolve) -> RoundDraws:
        """The round's random planes from round key ``key``: the channel
        redraw (or the scenario's draws) from the first half of the key, the
        uplink noise from the second and the analog-downlink noise from that
        half's fold 1 (as ``repro.core.admm``), the minibatches from fold
        ``BATCH_SALT``, the fault uniforms from the ``FAULT_SALT`` fold of
        the whole key, and the guard's burst and retry planes from folds of
        the noise half (``faults.guards.draw``), and the cohort's plane from
        the ``COHORT_SALT`` fold of the whole key.  Under sampling the
        analog-downlink noise is the cohort's, the rest the population's."""
        kc, kn = rng.split(key)
        dev = st.theta.device
        W, d = st.theta.shape
        sampling = _cohort.cohort_active(self.cohort)
        h_fresh = phy = None
        if self.scenario is not None:
            phy = self.scenario.draw(kc, st.phys)
        elif redraws(st.blk, self.ccfg):
            h_fresh = rayleigh(rng.generator(kc, dev), (W, d))
        noise_re = matched_filter_noise_re(rng.generator(kn, dev), (d,),
                                           self.ccfg)
        downlink = None
        if self.ccfg.analog_downlink:
            rows = self.cohort.cohort if sampling else W
            downlink = matched_filter_noise(
                rng.generator(rng.fold_in(kn, 1), dev), (rows, d),
                self.ccfg).re
        batch_idx = _batches(local_solve, key, dev)
        faults = guard = None
        if self.faults is not None:
            faults = _fplan.draw_uniforms(
                self.faults, rng.fold_in(key, _fplan.FAULT_SALT), W, dev)
        bursts = self.faults is not None and self.faults.has_bursts
        if self.guard is not None or bursts:
            guard = _guards.draw(self.guard or _guards.GuardConfig(), kn, d,
                                 self.ccfg, dev, bursts)
        return RoundDraws(h_fresh=h_fresh, noise_re=noise_re,
                          downlink_noise_re=downlink, batch_idx=batch_idx,
                          phy=phy, faults=faults, guard=guard,
                          cohort=_cohort.draw_cohort(key, self.cohort, dev)
                          if sampling else None)

    def round(self, key: int, st: AFadmmState, local_solve: LocalSolve,
              grad_fn: GradFn, draws: Optional[RoundDraws] = None
              ) -> Tuple[AFadmmState, dict]:
        if draws is None:
            draws = self.draw(key, st, local_solve)
        mask = h_tx = None
        if self.scenario is None:
            blk_next = step_channel(st.blk, self.ccfg, draws.h_fresh)
        else:
            phys = self.scenario.step(st.phys, draws.phy)
            blk_next = self._as_block(phys, st.blk.h,
                                      self.scenario.changed(phys))
            st = st._replace(phys=phys)
            if self.scenario.truncating:
                mask = phys.mask
            if self.scenario.imperfect_csi:
                h_tx = phys.h_hat
        faults = None
        fmetrics = {}
        if self.faults is not None:
            if draws.faults is None:
                raise ValueError("a round under a fault plan needs "
                                 "draws.faults")
            rf, st_mid, fmetrics = _fplan.draw(self.faults, st.flt,
                                               draws.faults)
            st = st._replace(flt=st_mid)
            mask = rf.alive if mask is None else mask & rf.alive
            faults = (self.faults, rf, st.flt.stale)
        if _cohort.cohort_active(self.cohort):
            st, metrics = self._cohort_round(st, blk_next, local_solve,
                                             grad_fn, draws, mask, h_tx,
                                             faults)
        else:
            st, metrics = admm.afadmm_round(
                st, blk_next, local_solve, grad_fn, self.acfg, self.ccfg,
                draws, mask=mask, h_tx=h_tx, guard=self.guard, faults=faults,
                telemetry=self.telemetry)
        aux = metrics.pop("_fault_aux", {})
        if self.faults is not None:
            st = st._replace(flt=_fplan.commit(st.flt, aux.get("stale"),
                                               aux.get("evicted")))
        metrics = _obs.merge_disjoint(metrics, fmetrics, who="AFadmm.round")
        metrics["channel_uses"] = float(
            subcarrier.analog_channel_uses(self.plan))
        return st, metrics

    def _cohort_round(self, st: AFadmmState, blk_next: ChannelBlock,
                      local_solve: LocalSolve, grad_fn: GradFn,
                      draws: RoundDraws, mask, h_tx, faults
                      ) -> Tuple[AFadmmState, dict]:
        """Sampled round: gather the cohort's rows out of the population
        state (θ, λ, the channel block, the mask, h_tx, the fault rows), run
        ``admm.afadmm_round`` at cohort width, scatter θ, λ and the fault
        aux back.  The solver must take any worker count."""
        if draws.cohort is None and self.cohort.policy != "top-gain":
            raise ValueError("a sampled round needs draws.cohort")
        n_pop = st.theta.shape[0]
        # uniform never reads the weight: no (N, d) |h|² pass
        wgt = (_cohort.channel_weight(blk_next.h)
               if self.cohort.policy != "uniform" else None)
        idx = _cohort.sample_cohort(self.cohort, draws.cohort, wgt)
        take = _cohort.take_rows
        blk_sub = ChannelBlock(h=take(blk_next.h, idx),
                               h_prev=take(blk_next.h_prev, idx),
                               changed=take(blk_next.changed, idx),
                               age=blk_next.age)
        faults_sub = None
        if faults is not None:
            fplan, rf, stale = faults
            rf = rf._replace(alive=take(rf.alive, idx),
                             straggler=take(rf.straggler, idx),
                             corrupt=take(rf.corrupt, idx),
                             snapshot_due=take(rf.snapshot_due, idx))
            faults_sub = (fplan, rf, take(stale, idx))
        sub = AFadmmState(theta=st.theta[idx], lam=take(st.lam, idx),
                          Theta=st.Theta, blk=blk_sub, step=st.step)
        st2, metrics = admm.afadmm_round(
            sub, blk_sub, local_solve, grad_fn, self.acfg, self.ccfg, draws,
            mask=take(mask, idx), h_tx=take(h_tx, idx), guard=self.guard,
            faults=faults_sub, telemetry=self.telemetry)
        aux = metrics.pop("_fault_aux", None)
        if aux is not None:
            if aux.get("stale") is not None:
                aux["stale"] = _cohort.put_rows(st.flt.stale, idx,
                                                aux["stale"])
            if aux.get("evicted") is not None:
                aux["evicted"] = _cohort.put_rows(
                    torch.zeros(n_pop, dtype=torch.bool,
                                device=st.theta.device), idx, aux["evicted"])
            metrics["_fault_aux"] = aux
        if _obs.is_on(self.telemetry):
            metrics = _obs.merge_disjoint(
                metrics, _cohort.cohort_metrics(self.cohort),
                who="AFadmm._cohort_round")
        return AFadmmState(theta=_cohort.put_rows(st.theta, idx, st2.theta),
                           lam=_cohort.put_rows(st.lam, idx, st2.lam),
                           Theta=st2.Theta, blk=blk_next, step=st2.step,
                           phys=st.phys, flt=st.flt), metrics

    def global_model(self, st: AFadmmState) -> Tensor:
        return st.Theta


def _ones(theta: Tensor) -> Complex:
    """h ≡ 1: the digital links' stand-in channel for the local solver."""
    return Complex(torch.ones_like(theta), torch.zeros_like(theta))


# ---------------------------------------------------------------------------
# D-FADMM (digital baseline, Appendix A)
# ---------------------------------------------------------------------------

class DFadmmState(NamedTuple):
    theta: Tensor       # (W, d)
    lam: Tensor         # (W, d) real duals
    Theta: Tensor       # (d,)
    blk: ChannelBlock   # (W, S): for the Shannon channel-use count only
    step: int


@dataclasses.dataclass(frozen=True)
class DFadmm(ScanRounds):
    acfg: AdmmConfig
    ccfg: ChannelConfig
    plan: SubcarrierPlan
    bits_per_element: int = 32

    name = "dfadmm"

    def init(self, key: int, theta0: Tensor) -> DFadmmState:
        blk = init_channel(rng.generator(key, theta0.device), self.ccfg)
        return DFadmmState(theta=theta0, lam=torch.zeros_like(theta0),
                           Theta=theta0.mean(0), blk=blk, step=0)

    def draw(self, key: int, st: DFadmmState,
             local_solve: LocalSolve) -> RoundDraws:
        """The fresh (W, S) block from the whole round key on a redraw
        round (as JAX's ``step_channel(key, ...)``), the minibatches from
        fold ``BATCH_SALT``; the digital link adds no noise."""
        dev = st.theta.device
        h_fresh = None
        if redraws(st.blk, self.ccfg):
            h_fresh = rayleigh(rng.generator(key, dev), st.blk.h.re.shape)
        return RoundDraws(h_fresh=h_fresh, noise_re=None,
                          batch_idx=_batches(local_solve, key, dev))

    def round(self, key: int, st: DFadmmState, local_solve: LocalSolve,
              grad_fn: GradFn, draws: Optional[RoundDraws] = None
              ) -> Tuple[DFadmmState, dict]:
        del grad_fn
        if draws is None:
            draws = self.draw(key, st, local_solve)
        rho = self.acfg.rho
        lam_c = Complex(st.lam, torch.zeros_like(st.lam))
        theta_new = local_solve(st.theta, lam_c, _ones(st.theta), st.Theta,
                                draws.batch_idx)                  # Eq. (20)
        Theta_new = (theta_new + st.lam / rho).sum(0) \
            / self.ccfg.n_workers                                 # Eq. (21)
        lam_new = st.lam + rho * (theta_new - Theta_new[None, :])  # Eq. (22)

        blk_next = step_channel(st.blk, self.ccfg, draws.h_fresh)
        # Appendix H straggler accounting: orthogonal S/N subcarriers a worker
        s_w = max(self.ccfg.n_subcarriers // self.ccfg.n_workers, 1)
        rates = shannon_rate(blk_next.h, self.ccfg)[:, :s_w]
        uses = subcarrier.digital_channel_uses(
            rates, float(self.bits_per_element * self.plan.d), s_w)
        metrics = {
            "primal_residual": torch.sqrt(torch.mean(
                (theta_new - Theta_new[None, :]) ** 2)),
            "dual_residual": rho * torch.sqrt(torch.mean(
                (Theta_new - st.Theta) ** 2)),
            "channel_uses": uses,
        }
        return DFadmmState(theta=theta_new, lam=lam_new, Theta=Theta_new,
                           blk=blk_next, step=st.step + 1), metrics

    def global_model(self, st: DFadmmState) -> Tensor:
        return st.Theta


# ---------------------------------------------------------------------------
# A-GD (truncated channel inversion, refs [9-11])
# ---------------------------------------------------------------------------

class AnalogGDState(NamedTuple):
    Theta: Tensor   # (d,): first-order methods keep one global model
    blk: ChannelBlock
    step: int


@dataclasses.dataclass(frozen=True)
class AnalogGD(ScanRounds):
    ccfg: ChannelConfig
    plan: SubcarrierPlan
    learning_rate: float = 1e-4
    #: truncation threshold ε: transmit only where |h| ≥ ε (Appendix H: 1e-6)
    epsilon: float = 1e-6

    name = "analog_gd"

    def init(self, key: int, theta0: Tensor) -> AnalogGDState:
        blk = init_channel(rng.generator(key, theta0.device), self.ccfg,
                           n_coeffs=theta0.shape[-1])
        return AnalogGDState(Theta=theta0.mean(0), blk=blk, step=0)

    def draw(self, key: int, st: AnalogGDState,
             grad_fn: GradFn) -> RoundDraws:
        """The fresh block from the round key's first half on a redraw
        round, the uplink noise from its second, and, for a ``grad_fn``
        with ``draw_batches``, its minibatch from fold ``BATCH_SALT``."""
        kc, kn = rng.split(key)
        dev = st.Theta.device
        d = st.Theta.shape[0]
        h_fresh = None
        if redraws(st.blk, self.ccfg):
            h_fresh = rayleigh(rng.generator(kc, dev), st.blk.h.re.shape)
        noise_re = matched_filter_noise_re(rng.generator(kn, dev), (d,),
                                           self.ccfg)
        return RoundDraws(h_fresh=h_fresh, noise_re=noise_re,
                          batch_idx=_batches(grad_fn, key, dev))

    def round(self, key: int, st: AnalogGDState, local_solve: LocalSolve,
              grad_fn: GradFn, draws: Optional[RoundDraws] = None
              ) -> Tuple[AnalogGDState, dict]:
        del local_solve
        if draws is None:
            draws = self.draw(key, st, grad_fn)
        blk = step_channel(st.blk, self.ccfg, draws.h_fresh)
        W, d = self.ccfg.n_workers, st.Theta.shape[0]
        theta_rep = st.Theta[None, :].expand(W, d)
        # local gradients at the global model
        g = grad_fn(theta_rep) if draws.batch_idx is None \
            else grad_fn(theta_rep, draws.batch_idx)
        keep = torch.sqrt(cplx.abs2(blk.h)) >= self.epsilon
        # channel inversion: tx g/h, the channel applies h, the PS sees the
        # kept workers' sum + z
        num = torch.where(keep, g, torch.zeros((), dtype=g.dtype,
                                               device=g.device)).sum(0)
        den = torch.clamp(keep.sum(0).to(g.dtype), min=1.0)
        g_hat = num / den + draws.noise_re / torch.clamp(den, min=1.0)
        Theta_new = st.Theta - self.learning_rate * g_hat
        metrics = {
            "participation": keep.to(g.dtype).mean(),
            "channel_uses": float(self.plan.n_slots),
            "grad_norm": torch.sqrt(torch.sum(g_hat ** 2)),
        }
        return AnalogGDState(Theta=Theta_new, blk=blk,
                             step=st.step + 1), metrics

    def global_model(self, st: AnalogGDState) -> Tensor:
        return st.Theta


# ---------------------------------------------------------------------------
# FedAvg (ideal-link reference)
# ---------------------------------------------------------------------------

class FedAvgState(NamedTuple):
    theta: Tensor
    Theta: Tensor
    step: int


@dataclasses.dataclass(frozen=True)
class FedAvg(ScanRounds):
    ccfg: ChannelConfig
    plan: SubcarrierPlan

    name = "fedavg"

    def init(self, key: int, theta0: Tensor) -> FedAvgState:
        return FedAvgState(theta=theta0, Theta=theta0.mean(0), step=0)

    def draw(self, key: int, st: FedAvgState,
             local_solve: LocalSolve) -> RoundDraws:
        """Only the local solver's minibatches (fold ``BATCH_SALT``): the
        ideal link draws nothing."""
        return RoundDraws(h_fresh=None, noise_re=None,
                          batch_idx=_batches(local_solve, key,
                                             st.theta.device))

    def round(self, key: int, st: FedAvgState, local_solve: LocalSolve,
              grad_fn: GradFn, draws: Optional[RoundDraws] = None
              ) -> Tuple[FedAvgState, dict]:
        del grad_fn
        if draws is None:
            draws = self.draw(key, st, local_solve)
        zero = cplx.czero(st.theta.shape, dtype=st.theta.dtype,
                          device=st.theta.device)
        theta_new = local_solve(st.theta, zero, _ones(st.theta), st.Theta,
                                draws.batch_idx)
        Theta_new = theta_new.sum(0) / self.ccfg.n_workers
        return FedAvgState(theta=Theta_new[None, :].expand(st.theta.shape),
                           Theta=Theta_new, step=st.step + 1), \
            {"channel_uses": float(self.plan.n_slots)}

    def global_model(self, st: FedAvgState) -> Tensor:
        return st.Theta


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

ALGORITHMS = {
    "afadmm": AFadmm,
    "dfadmm": DFadmm,
    "analog_gd": AnalogGD,
    "fedavg": FedAvg,
}


def make(name: str, acfg: AdmmConfig, ccfg: ChannelConfig,
         plan: SubcarrierPlan, **kw):
    """Factory over :data:`ALGORITHMS`, taking each class's own keywords:
    A-FADMM's ``scenario`` (a ``repro_torch.phy.Scenario``), ``faults`` (a
    ``repro_torch.faults.FaultPlan``), ``guard`` (a ``GuardConfig``) and
    ``cohort`` (a ``repro_torch.core.cohort.CohortConfig``) and
    ``telemetry`` (a ``repro_torch.obs.TelemetryConfig`` or True);
    D-FADMM's ``bits_per_element``; A-GD's ``learning_rate`` and
    ``epsilon``.  ``acfg`` is ignored by the first-order algorithms."""
    if name not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {name!r}; the port has "
                         f"{sorted(ALGORITHMS)}")
    cls = ALGORITHMS[name]
    if cls in (AnalogGD, FedAvg):
        return cls(ccfg=ccfg, plan=plan, **kw)
    return cls(acfg=acfg, ccfg=ccfg, plan=plan, **kw)
