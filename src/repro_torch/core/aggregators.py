"""Federated aggregation algorithms: the trainer's plug point.

    alg = make("afadmm", acfg, ccfg, plan)          # scenario=... optional
    st  = alg.init(key, theta0)                     # theta0: (W, d)
    st, m = alg.round(key, st, local_solve, grad_fn)
    Theta = alg.global_model(st)

Counterpart of ``repro/core/aggregators.py`` for A-FADMM, the paper's
algorithm.  Keys are integers (``repro_torch.rng``); the device is that of
``theta0``.  ``round`` draws its random planes from the round key, as the
JAX round does from its two halves, or takes them ready-made.  With a
``repro_torch.phy`` scenario the channel is the scenario's: its state rides
in ``AFadmmState.phys`` and it supplies the round's participation mask and
the workers' CSI.  With a ``repro_torch.faults.FaultPlan`` the fault state
rides in ``AFadmmState.flt``, its draws come from the round key's
``FAULT_SALT`` side branch (so an all-zero plan changes no draw of the
fault-free run), and a ``GuardConfig`` guards the uplink.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch import rng
from repro_torch.core import admm, subcarrier
from repro_torch.core.admm import (AdmmConfig, AFadmmState, GradFn,
                                   LocalSolve, RoundDraws)
from repro_torch.core.channel import (ChannelBlock, ChannelConfig,
                                      init_channel, matched_filter_noise,
                                      rayleigh, redraws, step_channel)
from repro_torch.core.subcarrier import SubcarrierPlan
from repro_torch.core.transport import matched_filter_noise_re
from repro_torch.faults import guards as _guards
from repro_torch.faults import plan as _fplan

Tensor = torch.Tensor

#: fold of the round key that seeds the local solver's minibatch draw
BATCH_SALT = 2


@dataclasses.dataclass(frozen=True)
class AFadmm:
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
        the noise half (``faults.guards.draw``)."""
        kc, kn = rng.split(key)
        dev = st.theta.device
        W, d = st.theta.shape
        h_fresh = phy = None
        if self.scenario is not None:
            phy = self.scenario.draw(kc, st.phys)
        elif redraws(st.blk, self.ccfg):
            h_fresh = rayleigh(rng.generator(kc, dev), (W, d))
        noise_re = matched_filter_noise_re(rng.generator(kn, dev), (d,),
                                           self.ccfg)
        downlink = None
        if self.ccfg.analog_downlink:
            downlink = matched_filter_noise(
                rng.generator(rng.fold_in(kn, 1), dev), (W, d), self.ccfg).re
        draw_batches = getattr(local_solve, "draw_batches", None)
        batch_idx = None if draw_batches is None else draw_batches(
            rng.generator(rng.fold_in(key, BATCH_SALT), dev))
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
                          phy=phy, faults=faults, guard=guard)

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
        st, metrics = admm.afadmm_round(st, blk_next, local_solve, grad_fn,
                                        self.acfg, self.ccfg, draws,
                                        mask=mask, h_tx=h_tx,
                                        guard=self.guard, faults=faults)
        aux = metrics.pop("_fault_aux", {})
        if self.faults is not None:
            st = st._replace(flt=_fplan.commit(st.flt, aux.get("stale"),
                                               aux.get("evicted")))
        metrics.update(fmetrics)
        metrics["channel_uses"] = float(
            subcarrier.analog_channel_uses(self.plan))
        return st, metrics

    def global_model(self, st: AFadmmState) -> Tensor:
        return st.Theta


ALGORITHMS = {"afadmm": AFadmm}


def make(name: str, acfg: AdmmConfig, ccfg: ChannelConfig,
         plan: SubcarrierPlan, scenario=None, faults=None, guard=None):
    """Factory over :data:`ALGORITHMS`; ``scenario`` is an optional
    ``repro_torch.phy.Scenario``, ``faults`` a ``repro_torch.faults
    .FaultPlan`` and ``guard`` a ``GuardConfig``."""
    if name not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {name!r}; the port has "
                         f"{sorted(ALGORITHMS)}")
    return ALGORITHMS[name](acfg=acfg, ccfg=ccfg, plan=plan,
                            scenario=scenario, faults=faults, guard=guard)
