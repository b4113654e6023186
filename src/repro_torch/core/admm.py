"""A-FADMM: analog federated ADMM — the paper's core algorithm (Sec. 2), on
``(W, d)`` worker-major tensors.  Counterpart of ``repro/core/admm.py``: the
round with the participation mask and imperfect CSI of the
``repro_torch.phy`` scenarios, and the fault-injected, guarded round of
``repro_torch.faults``.

Update rules (paper equation numbers):

* modulate   (Alg. 1 l.14):   s_{n,i} = h*_{n,i} θ_{n,i} + λ*_{n,i}/ρ
* uplink     (Eq. 23):        y_i = Σ_n h_{n,i} s_{n,i} + z_i,  z ~ CN(0, N0/T)
* global     (Eq. 9/24):      Θ_i = Re{y_i} / Σ_n |h_{n,i}|²
* primal     (Eq. 6/10):      0 ∈ ∂f + Re{λ* h} + ρ|h|²(θ − Θ)   [solved by caller]
* dual       (Eq. 8/11):      λ' = λ + ρ h (θ − Θ)  (− ρ Re{z} under analog downlink)
* flip rule  (Sec. 2, "Time-varying Channel"): when h^{k+1} ≠ h^k freeze θ and
  re-solve the stationarity condition for λ: λ = t·h/|h|².

Every random plane a round reads arrives in a :class:`RoundDraws`, so the
same round can run on the port's own generators or on planes replayed from
the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import cplx
from repro_torch.core.channel import ChannelBlock, ChannelConfig
from repro_torch.core.cplx import Complex
from repro_torch.core.transport import dual_update, flip_lambda, ota_uplink
from repro_torch.faults import guards as _fguards
from repro_torch.faults import plan as _fplan

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdmmConfig:
    """Hyperparameters of the ADMM layer (paper Sec. 5 defaults)."""

    rho: float = 0.5
    #: apply the time-varying-channel flip rule (Sec. 2)
    flip_on_change: bool = True
    #: enforce the per-worker transmit power budget via the min-α protocol
    power_control: bool = True


class AFadmmState(NamedTuple):
    """Per-round algorithm state. Shapes: theta/lam (W, d); Theta (d,).

    ``phys`` is the ``repro_torch.phy.PhyState`` under a wireless scenario,
    None on the legacy block-fading path; ``flt`` the
    ``repro_torch.faults.FaultState`` under a fault plan, else None."""

    theta: Tensor
    lam: Complex
    Theta: Tensor
    blk: ChannelBlock
    step: int
    phys: Optional[Any] = None
    flt: Optional[Any] = None


class RoundDraws(NamedTuple):
    """Every random plane one round reads (of A-FADMM here, and of the
    baselines in ``core.aggregators``).

    h_fresh: the new Rayleigh block (W, d), only on rounds that redraw the
      channel (``channel.redraws``), else None.  D-FADMM's is (W, S).
    noise_re: (d,) real plane of the uplink matched-filter noise (zeros on
      a noise-free link); None for D-FADMM and FedAvg, whose links add none.
    downlink_noise_re: (W, d) real plane of the analog-downlink noise, only
      under ``ChannelConfig.analog_downlink``, else None.
    batch_idx: (n_steps, W, B) shard-local minibatch indices for a
      stochastic local solver (A-GD: (W, B) for its one gradient), else
      None.
    phy: the scenario's ``repro_torch.phy.PhyDraws`` under a wireless
      scenario (then ``h_fresh`` is None), else None.
    faults: the fault plan's uniforms (``repro_torch.faults.plan
      .FaultDraws``) under a fault plan, else None.
    guard: the guard's burst and retry noise planes
      (``repro_torch.faults.guards.GuardDraws``) when the round is guarded
      or has bursts, else None.
    cohort: the cohort plane (``repro_torch.core.cohort.draw_cohort``)
      when A-FADMM samples a cohort from its population, else None.
    """

    h_fresh: Optional[Complex]
    noise_re: Optional[Tensor]
    downlink_noise_re: Optional[Tensor] = None
    batch_idx: Optional[Tensor] = None
    phy: Optional[Any] = None
    faults: Optional[Any] = None
    guard: Optional[Any] = None
    cohort: Optional[Tensor] = None


def init_state(theta0: Tensor, blk: ChannelBlock,
               phys=None, flt=None) -> AFadmmState:
    """theta0: (W, d) initial local models (paper: random init)."""
    W, d = theta0.shape
    return AFadmmState(
        theta=theta0,
        lam=cplx.czero((W, d), dtype=theta0.dtype, device=theta0.device),
        Theta=theta0.mean(0),
        blk=blk,
        step=0,
        phys=phys,
        flt=flt)


def residuals(state: AFadmmState, Theta_prev: Tensor) -> Tuple[Tensor, Tensor]:
    """(primal, dual) residual norms of Theorem 1: r = θ−Θ, S = ρ|h|²(Θ'−Θ)."""
    r = state.theta - state.Theta[None, :]
    S = cplx.abs2(state.blk.h) * (state.Theta - Theta_prev)[None, :]
    return torch.sqrt(torch.sum(r * r)), torch.sqrt(torch.sum(S * S))


# ---------------------------------------------------------------------------
# One full A-FADMM round
# ---------------------------------------------------------------------------

#: ``(theta, lam, h, Theta, batch_idx) -> theta'``.  A solver that takes
#: minibatches also has ``draw_batches(gen) -> batch_idx`` (see
#: ``optim.local_solvers``); ``batch_idx`` is None for the others.
LocalSolve = Callable[[Tensor, Complex, Complex, Tensor, Optional[Tensor]],
                      Tensor]
GradFn = Callable[[Tensor], Tensor]


def afadmm_round(state: AFadmmState, blk_next: ChannelBlock,
                 local_solve: LocalSolve, grad_fn: GradFn, acfg: AdmmConfig,
                 ccfg: ChannelConfig, draws: RoundDraws,
                 mask: Optional[Tensor] = None,
                 h_tx: Optional[Complex] = None,
                 guard=None, faults=None) -> Tuple[AFadmmState, dict]:
    """One synchronous round of Algorithm 1 (with Appendix-B noise handling).

    Args:
      blk_next: the channel block for iteration k+1 (the caller steps the
        channel so the trainer can account coherence across rounds).
      local_solve: ``(theta, lam, h, Theta, batch_idx) -> theta'`` — solves
        or approximates the primal problem (Eq. 6/10) ignoring the flip
        mask, which is applied here.
      grad_fn: ``theta -> ∂f(θ)`` per worker, used by the flip rule.
        Shapes (W, d) -> (W, d).
      draws: the round's random planes (:class:`RoundDraws`).
      mask: (W,) participation mask (deep-fade truncation and/or fault
        liveness).  A masked worker skips the round: zero superposition
        contribution, left out of min-α, dual frozen at its pre-round
        value.  An all-masked round keeps Θ.
      h_tx: the workers' CSI ``h_hat`` (imperfect CSI): they solve, flip,
        precode and dual-update with it while the air applies ``h``.
      guard: a ``repro_torch.faults.GuardConfig`` — the uplink becomes the
        guarded fused round (Θ finiteness + SNR floor, then evict /
        retransmit / skip).  A healthy guarded round is the unguarded
        round's.
      faults: ``(FaultPlan, RoundFaults, stale)`` — substitutes the
        uplinked planes per the round's fault draw (stragglers, corruption,
        bursts); θ and the duals stay the workers' own.  A refreshed stale
        buffer and the evicted rows ride in ``metrics["_fault_aux"]``.

    Metrics are 0-d tensors on the device: reading them is the caller's
    choice of when to synchronise.
    """
    h = blk_next.h
    rho = acfg.rho
    h_wkr = h if h_tx is None else h_tx   # what the workers believe

    # --- primal / flip (Sec. 2 "Time-varying Channel") --------------------
    theta_solved = local_solve(state.theta, state.lam, h_wkr, state.Theta,
                               draws.batch_idx)
    if acfg.flip_on_change:
        changed = blk_next.changed
        theta_new = torch.where(changed, state.theta, theta_solved)
        lam_flip = flip_lambda(grad_fn(state.theta), state.theta, state.Theta,
                               h_wkr, rho)
        lam_pre = cplx.cwhere(changed, lam_flip, state.lam)
    else:
        theta_new = theta_solved
        lam_pre = state.lam

    # --- fault injection: what the air sees (worker state stays truthful) --
    aux = {}
    burst_std = None
    theta_tx = theta_new
    if faults is not None:
        fplan, rf, stale = faults
        theta_tx, stale_next = _fplan.apply_uplink(fplan, rf, theta_new,
                                                   stale)
        burst_std = rf.burst_std
        if stale_next is not None:
            aux["stale"] = stale_next

    # --- uplink: modulate, power-scale, superpose, matched-filter ---------
    healthy = evicted = None
    guard_metrics = {}
    if guard is not None or burst_std is not None:
        if draws.guard is None:
            raise ValueError("a guarded or bursty round needs draws.guard")
        with torch.profiler.record_function("guarded_ota_round"):
            gr = _fguards.guarded_ota_round(
                theta_tx, lam_pre, h, draws.noise_re, rho, ccfg,
                guard if guard is not None else _fguards.GuardConfig(),
                power_control=acfg.power_control, mask=mask, h_tx=h_tx,
                burst_std=burst_std, draws=draws.guard)
        Theta_new, inv_alpha = gr.Theta, gr.inv_alpha
        if guard is not None:   # burst-only: no policy, accept the round
            healthy, evicted = gr.healthy, gr.evicted
            guard_metrics = gr.metrics
            aux["evicted"] = evicted
    else:
        Theta_new, inv_alpha = ota_uplink(theta_tx, lam_pre, h,
                                          draws.noise_re, rho, ccfg,
                                          power_control=acfg.power_control,
                                          mask=mask, h_tx=h_tx)
    keep = None
    if mask is not None or evicted is not None:
        # nobody transmitted (all masked or evicted): keep Θ rather than
        # demodulate noise over a zero pilot
        active = mask
        if evicted is not None:
            active = ~evicted if active is None else active & ~evicted
        keep = active.any()
    if healthy is not None:
        keep = healthy if keep is None else keep & healthy
    if keep is not None:
        Theta_new = torch.where(keep, Theta_new, state.Theta)

    # --- downlink + dual ---------------------------------------------------
    # duals update from the workers' true θ (theta_new, not the faulted
    # theta_tx): a straggler's or corrupter's bookkeeping stays healthy
    downlink = None
    if ccfg.analog_downlink:
        if draws.downlink_noise_re is None:
            raise ValueError("analog_downlink needs draws.downlink_noise_re")
        downlink = draws.downlink_noise_re
    lam_new = dual_update(lam_pre, h_wkr, theta_new, Theta_new, rho,
                          downlink)
    freeze = mask
    if evicted is not None:
        freeze = ~evicted if freeze is None else freeze & ~evicted
    if freeze is not None:
        # workers that sat the round out keep their PRE-round duals —
        # state.lam, not lam_pre, which under flip_on_change already holds
        # this round's flip
        lam_new = cplx.cwhere(freeze[:, None], lam_new, state.lam)
    if healthy is not None:
        lam_new = cplx.cwhere(healthy, lam_new, state.lam)
    if evicted is not None:
        zero = torch.zeros((), dtype=lam_new.re.dtype,
                           device=lam_new.re.device)
        lam_new = Complex(torch.where(evicted[:, None], zero, lam_new.re),
                          torch.where(evicted[:, None], zero, lam_new.im))

    new_state = AFadmmState(theta=theta_new, lam=lam_new, Theta=Theta_new,
                            blk=blk_next, step=state.step + 1,
                            phys=state.phys, flt=state.flt)
    metrics = {
        "primal_residual": torch.sqrt(torch.mean(
            (theta_new - Theta_new[None, :]) ** 2)),
        "dual_residual": torch.sqrt(torch.mean(
            (cplx.abs2(h) * (Theta_new - state.Theta)[None, :]) ** 2)) * rho,
        "inv_alpha": inv_alpha,
        **guard_metrics,
    }
    if mask is not None:
        metrics["participation"] = mask.to(torch.float32).mean()
    if aux:
        metrics["_fault_aux"] = aux
    return new_state, metrics
