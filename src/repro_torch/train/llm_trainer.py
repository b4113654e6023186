"""Federated LLM training: A-FADMM as the aggregation layer, in the
``replicated`` mode.  Counterpart of ``repro/train/llm_trainer.py``.

Every FL worker owns a full (θ_n, λ_n) copy; per-worker tensors carry a
leading worker dim W.  The local prox steps run all workers at once: their
losses (one per worker, ``Model.loss`` on W-led parameters) are summed and
back-propagated, which gives each worker its own gradient.  One analog OTA
round (``core.tree_ota.ota_tree_round_packed_state``: the fused uplink B6 +
B3, then the dual update B4) produces the new global model.  Per the
paper's Appendix H the stochastic variant skips the flip rule.  λ and h
live persistently packed as ``(W, D)`` Complex buffers on one device, or as
trees of per-leaf buffers under ``packed_uplink=False`` (the leafwise
round, one receive chain per leaf).

Under a ``phy`` scenario the channel is the scenario's (W, D) ``PhyState``:
its mask truncates workers and its CSI is what the workers act on.  A
``faults.FaultPlan`` injects uplink faults (its state rides in
``TreeFLState.flt``) and a ``faults.GuardConfig`` guards the receive.  With
``population``/``cohort`` the state is a population's and each round only
the sampled cohort trains and transmits; the others keep their θ, optimizer
state and λ.

A round's random planes are a :class:`TreeRoundDraws`, drawn from the round
key when not given (:func:`draw_round`), so a test can replay the JAX
package's.  ``telemetry`` adds the round's ``obs/`` keys
(``repro_torch.obs``) and ``ota_block_cols`` picks the fused kernel's plan
(``kernels/ota_round.block_cols_choices``).  Not ported yet, and refused by
name: the ``sketched`` mode, meshes and a transport backend override.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch import obs as _obs
from repro_torch import rng
from repro_torch.core import cohort as _cohort
from repro_torch.core import cplx, transport
from repro_torch.core.admm import AdmmConfig
from repro_torch.core.channel import ChannelConfig, rayleigh
from repro_torch.core.cplx import Complex
from repro_torch.core.packing import build_packspec, unpack_cplx
from repro_torch.core.tree_ota import (TreeFLState, _zmap, draw_channel_tree,
                                       init_channel_packed, init_channel_tree,
                                       ota_tree_round,
                                       ota_tree_round_packed_state, redraws,
                                       step_channel_packed, step_channel_tree,
                                       tree_penalty_grad, tree_update_norm)
from repro_torch.device import resolve_device
from repro_torch.faults import guards as _guards
from repro_torch.faults import plan as _fplan
from repro_torch.kernels import ota_round as _round_k
from repro_torch.models.registry import Model, packed_param_count
from repro_torch.optim.optimizers import OptState, adam, sgd
from repro_torch.phy.scenario import h_tx as _phys_h_tx
from repro_torch.phy.scenario import make_scenario
from repro_torch.tree import tree_leaves, tree_map, tree_stack

Tensor = torch.Tensor
PyTree = Any


@dataclasses.dataclass(frozen=True)
class FLConfig:
    """The JAX package's ``FLConfig``, field for field (see its docs for
    each); the port runs ``mode="replicated"``."""

    mode: str = "replicated"        # replicated | sketched
    n_workers: int = 4
    local_steps: int = 1
    local_lr: float = 1e-3
    local_optimizer: str = "sgd"    # sgd | adam
    sketch_ratio: int = 256
    sketch_lr: float = 1.0
    transport_backend: Optional[str] = None
    #: None/True: λ and h packed (W, D); False: per-leaf trees and the
    #: leafwise round
    packed_uplink: Optional[bool] = None
    #: a ``repro_torch.phy`` preset (None: the block-fading channel)
    scenario: Optional[str] = None
    doppler_hz: Optional[float] = None
    csi_err: Optional[float] = None
    h_min: Optional[float] = None
    slots_per_round: Optional[int] = None
    #: one-pass fused receive: None/True the fused round, False the
    #: composed per-primitive chain
    ota_fused: Optional[bool] = None
    #: worker-cohort streaming of the fused round: 0 all W at once; None
    #: defers to REPRO_OTA_WORKER_CHUNK
    ota_worker_chunk: Optional[int] = None
    #: the fused kernel's column tile, which picks its plan (32, 64, 96,
    #: 128: the row plan; 256, 1024: the column plan, W ≤ 16); None defers
    #: to REPRO_OTA_BLOCK_COLS, else the kernel's own plan
    ota_block_cols: Optional[int] = None
    #: ``repro_torch.faults.FaultPlan`` / ``GuardConfig`` (packed layout)
    faults: Optional[Any] = None
    guard: Optional[Any] = None
    #: ``repro_torch.obs.TelemetryConfig`` (or True): the round's ``obs/``
    #: keys (packed layout); None keeps the trainer bit for bit
    telemetry: Optional[Any] = None
    #: workers that exist; each round samples ``cohort`` of them
    #: (``core.cohort``, packed layout).  Batch leaves are cohort-wide: row
    #: i feeds the round's i-th sampled worker
    population: Optional[int] = None
    cohort: Optional[int] = None
    cohort_policy: str = "uniform"


class TreeRoundDraws(NamedTuple):
    """Every random plane one round reads.

    h_fresh: on a round that redraws the block-fading channel
      (``tree_ota.redraws``) the new Rayleigh block: (W, D) packed, or a
      list of per-leaf blocks in flatten order (leafwise state); else None.
      None under a scenario, whose planes are ``phy``.
    noise_re: (D,) real plane of the uplink matched-filter noise (zeros on
      a noise-free link); a list of per-leaf planes for the leafwise round.
    phy: the scenario's ``phy.PhyDraws``, under a scenario.
    faults: the fault plan's ``faults.plan.FaultDraws`` (population-wide).
    guard: the guard's retry and burst planes (``faults.guards.GuardDraws``)
      when the round is guarded or the plan has bursts.
    cohort: the cohort plane (``core.cohort.draw_cohort``) when the round
      samples a cohort.
    """

    h_fresh: Optional[Any]
    noise_re: Any
    phy: Optional[Any] = None
    faults: Optional[Any] = None
    guard: Optional[Any] = None
    cohort: Optional[Tensor] = None


def _device_of(state: TreeFLState) -> torch.device:
    return tree_leaves(state.theta)[0].device


def draw_round(key: int, state: TreeFLState, ccfg: ChannelConfig, *,
               scenario=None, faults: Optional[_fplan.FaultPlan] = None,
               guard: Optional[_guards.GuardConfig] = None,
               cohort: Optional[_cohort.CohortConfig] = None
               ) -> TreeRoundDraws:
    """The round's planes from its key, split as JAX splits it: ``kc`` the
    channel (the redraw block, drawn only on a redraw round, or the
    scenario's draws), ``kn`` the noise (per leaf: ``split(kn, n_leaves)``
    for the leafwise state) and the guard's planes (folds of ``kn``); the
    fault uniforms from the key's ``FAULT_SALT`` fold and the cohort plane
    from its ``COHORT_SALT`` fold."""
    kc, kn = rng.split(key)
    dev = _device_of(state)
    leafwise = not isinstance(state.lam, Complex)
    h_fresh = phy = None
    if scenario is not None:
        phy = scenario.draw(kc, state.chan)
    elif redraws(state.chan, ccfg):
        h_fresh = (draw_channel_tree(kc, state.chan.h) if leafwise else
                   rayleigh(rng.generator(kc, dev), tuple(state.lam.re.shape)))
    if leafwise:
        leaves = tree_leaves(state.theta)
        noise = [transport.matched_filter_noise_re(
            rng.generator(k, dev), tuple(leaf.shape[1:]), ccfg)
            for k, leaf in zip(rng.split(kn, len(leaves)), leaves)]
        d = sum(leaf[0].numel() for leaf in leaves)
    else:
        d = state.lam.re.shape[1]
        noise = transport.matched_filter_noise_re(rng.generator(kn, dev),
                                                  (d,), ccfg)
    fd = gd = cd = None
    if faults is not None:
        fd = _fplan.draw_uniforms(faults, rng.fold_in(key, _fplan.FAULT_SALT),
                                  state.flt.alive.shape[0], dev)
    bursts = faults is not None and faults.has_bursts
    if guard is not None or bursts:
        gd = _guards.draw(guard or _guards.GuardConfig(), kn, d, ccfg, dev,
                          bursts)
    if _cohort.cohort_active(cohort):
        cd = _cohort.draw_cohort(key, cohort, dev)
    return TreeRoundDraws(h_fresh, noise, phy=phy, faults=fd, guard=gd,
                          cohort=cd)


def _local_opt(flcfg: FLConfig):
    if flcfg.local_optimizer == "adam":
        return adam(flcfg.local_lr)
    return sgd(flcfg.local_lr)


def _refuse_unported(flcfg: FLConfig, mesh, model: Model) -> None:
    """NotImplementedError for every FLConfig feature the port lacks, named
    with its ROADMAP item, so none is silently ignored; ValueError for a
    column tile no plan of the fused kernel takes at the round's (W, D)."""
    if mesh is not None:
        raise NotImplementedError("FLConfig mesh is not ported yet (ROADMAP "
                                  "queue A item 6 (multi-device))")
    transport.check_backend_choice(flcfg.transport_backend)
    if flcfg.ota_block_cols is not None:
        width = flcfg.cohort if flcfg.population is not None else \
            flcfg.n_workers
        _round_k.check_block_cols(width or 0, packed_param_count(model.cfg),
                                  flcfg.ota_block_cols)


def _opt_map(fn, opt: OptState, *rest: OptState) -> OptState:
    """``fn`` over the per-worker leaves of a local optimizer's state (and
    of like states ``rest``); sgd's ``nu`` stays its ``mu`` where it is."""
    mu = tree_map(fn, opt.mu, *(r.mu for r in rest))
    nu = mu if opt.nu is opt.mu else tree_map(fn, opt.nu,
                                              *(r.nu for r in rest))
    return OptState(mu=mu, nu=nu, count=opt.count)


# ---------------------------------------------------------------------------
# replicated mode
# ---------------------------------------------------------------------------

def make_replicated(model: Model, flcfg: FLConfig, acfg: AdmmConfig,
                    ccfg: ChannelConfig, mesh=None, device="cuda"):
    """``(init_fn, train_step)`` of the replicated mode on one device: one
    globally packed (W, D) buffer each for λ and h, or per-leaf trees under
    ``packed_uplink=False``."""
    _refuse_unported(flcfg, mesh, model)
    cohort_cfg = None
    if flcfg.population is not None:
        if flcfg.cohort is None:
            raise ValueError(
                "FLConfig.population sets the worker-population size but "
                "says nothing about the per-round uplink width — set "
                "FLConfig.cohort too (cohort == population disables "
                "sampling bitwise)")
        cohort_cfg = _cohort.CohortConfig(
            population=flcfg.population, cohort=flcfg.cohort,
            policy=flcfg.cohort_policy)
    W = flcfg.population if flcfg.population is not None \
        else flcfg.n_workers
    opt = _local_opt(flcfg)
    tel = _obs.resolve(flcfg.telemetry)
    dev = resolve_device(device)
    scn = None
    if flcfg.scenario is not None:
        if flcfg.packed_uplink is False:
            raise ValueError(
                "FLConfig.scenario runs over the packed (W, D) index space "
                "and requires the packed state layout (packed_uplink != "
                "False)")
        scn = make_scenario(flcfg.scenario, ccfg,
                            doppler_hz=flcfg.doppler_hz,
                            csi_err=flcfg.csi_err, h_min=flcfg.h_min,
                            slots_per_round=flcfg.slots_per_round)
    fplan, gcfg = flcfg.faults, flcfg.guard
    if (fplan is not None or gcfg is not None) \
            and flcfg.packed_uplink is False:
        raise ValueError(
            "FLConfig.faults/guard apply to the packed uplink and require "
            "the packed state layout (packed_uplink != False)")
    if tel is not None and flcfg.packed_uplink is False:
        raise ValueError(
            "FLConfig.telemetry is collected inside the packed receive and "
            "requires the packed state layout (packed_uplink != False)")
    packed_layout = scn is not None or flcfg.packed_uplink is not False
    sampling = _cohort.cohort_active(cohort_cfg)
    if sampling and not packed_layout:
        raise ValueError(
            "FLConfig.population/cohort sampling gathers rows of the packed "
            "(N, D) dual/fading buffers and requires the packed state "
            "layout (packed_uplink != False)")

    def init_fn(key: int) -> TreeFLState:
        """Per-worker random init (worker w from ``fold_in(kp, w)``), Θ the
        workers' mean in the param dtype, λ = 0, one Rayleigh block (or the
        scenario's initial state), the fault plan's fresh state."""
        kp, kc = rng.split(key)
        theta = tree_stack([model.init(rng.fold_in(kp, w), device=dev)
                            for w in range(W)])           # leaves (W, ...)
        Theta = tree_map(lambda l: l.float().mean(0).to(l.dtype), theta)
        flt = None
        if packed_layout:
            d = build_packspec(theta, batch_dims=1).d
            lam = cplx.czero((W, d), device=dev)
            chan = (scn.init(kc, W, d, dev) if scn is not None else
                    init_channel_packed(rng.generator(kc, dev), W, d))
            if fplan is not None:
                # straggler snapshots live in the packed layout, as λ
                flt = _fplan.init(fplan, W, d, dev)
        else:
            lam = tree_map(lambda l: cplx.czero(tuple(l.shape), device=dev),
                           theta)
            chan = init_channel_tree(kc, theta)
        return TreeFLState(theta=theta, lam=lam, Theta=Theta, chan=chan,
                           opt=opt.init(theta), step=0, flt=flt)

    def local_step(theta: PyTree, opt_state, batch, lam_tree, h_tree,
                   Theta: PyTree, rows: Optional[Tensor] = None):
        """One prox step of every worker: (θ', opt', mean loss).  ``rows``:
        the cohort's rows of the population-wide λ and h trees."""
        leaves = tree_map(lambda l: l.detach().requires_grad_(), theta)
        losses, _ = model.loss(leaves, batch)            # (W,)
        losses.sum().backward()
        with torch.no_grad():
            grads = tree_map(lambda l: l.grad, leaves)
            pen = tree_penalty_grad(theta, lam_tree, h_tree, Theta, acfg.rho,
                                    rows=rows)
            g = tree_map(lambda a, b: a + b.to(a.dtype), grads, pen)
            del grads, pen, leaves
            theta, opt_state = opt.update(g, opt_state, theta)
        return theta, opt_state, losses.detach().mean()

    def train_step(state: TreeFLState, batch: dict, key: Optional[int] = None,
                   draws: Optional[TreeRoundDraws] = None
                   ) -> Tuple[TreeFLState, dict]:
        """One round.  batch leaves: (W, B_local, ...), worker-major (the
        cohort's W under sampling); the round's planes are ``draws``, else
        drawn from ``key``."""
        if draws is None:
            if key is None:
                raise ValueError("train_step needs a round key or the "
                                 "round's draws")
            draws = draw_round(key, state, ccfg, scenario=scn, faults=fplan,
                               guard=gcfg, cohort=cohort_cfg)
        packed = isinstance(state.lam, Complex)   # the state decides
        mask = h_tx_p = Theta_prev = idx = spec = None
        if scn is not None:
            chan = scn.step(state.chan, draws.phy)  # PhyState, (W, D)
            h_pack = _phys_h_tx(chan)
            if scn.truncating:
                mask, Theta_prev = chan.mask, state.Theta
            if scn.imperfect_csi:
                h_tx_p = chan.h_hat
        elif packed:
            chan, _ = step_channel_packed(state.chan, ccfg, draws.h_fresh)
            h_pack = chan.h
        else:
            chan, _ = step_channel_tree(state.chan, ccfg, draws.h_fresh)
            lam_tree, h_tree = state.lam, chan.h
        # the channel's draws and the old channel are spent: let them go
        # before the model runs (a caller that keeps neither frees them)
        draws = draws._replace(h_fresh=None, phy=None)
        state = state._replace(chan=None)
        theta_run, opt_run = state.theta, state.opt
        if packed:
            spec = build_packspec(state.theta, batch_dims=1)
            lam_pack = state.lam
            if sampling:
                # uniform never reads the weight: no (N, D) |h|² pass
                wgt = (_cohort.channel_weight(chan.h)
                       if cohort_cfg.policy != "uniform" else None)
                idx = _cohort.sample_cohort(cohort_cfg, draws.cohort, wgt)
                theta_run = tree_map(lambda l: l[idx], state.theta)
                opt_run = _opt_map(lambda l: l[idx], state.opt)
            # slice-views of the packed buffers for the leafwise penalty —
            # constant across the local steps; the workers act on their CSI.
            # Under sampling they stay population-wide: the penalty gathers
            # a leaf's cohort rows while it forms that leaf's term
            lam_tree = unpack_cplx(spec, lam_pack)
            h_tree = unpack_cplx(spec, h_pack)
            del lam_pack, h_pack
        faults_arg = None
        fmetrics = {}
        flt_mid = state.flt
        if fplan is not None:
            if draws.faults is None:
                raise ValueError("a round under a fault plan needs "
                                 "draws.faults")
            rf, flt_mid, fmetrics = _fplan.draw(fplan, state.flt,
                                                draws.faults)
            mask = rf.alive if mask is None else mask & rf.alive
            faults_arg = (fplan, rf, state.flt.stale)
        if fplan is not None or gcfg is not None:
            Theta_prev = state.Theta   # skip fallback / all-crashed keep
        theta, opt_state = theta_run, opt_run
        nu_kept = None
        if idx is None:
            # the old θ and optimizer state are spent once the steps start
            del theta_run, opt_run
            state = state._replace(theta=None, opt=None)
        loss = None
        for _ in range(flcfg.local_steps):
            theta, opt_state, loss = local_step(theta, opt_state, batch,
                                                lam_tree, h_tree, state.Theta,
                                                rows=idx)
        del lam_tree, h_tree
        if idx is not None:
            # the gathered rows go before the round; sgd passes its second
            # moment through untouched, which the scatter then keeps
            nu_kept = opt_state.nu is opt_run.nu
            del theta_run, opt_run
        with torch.no_grad():
            if packed:
                # under sampling θ is cohort-wide; λ, h, the mask and the
                # fault rows stay population-wide and the round gathers and
                # scatters their rows
                Theta_f32, lam_new, m = ota_tree_round_packed_state(
                    theta, state.lam, chan.h, draws.noise_re, acfg, ccfg,
                    spec, mask=mask, h_tx_p=h_tx_p, Theta_prev=Theta_prev,
                    fused=flcfg.ota_fused,
                    worker_chunk=flcfg.ota_worker_chunk,
                    block_cols=flcfg.ota_block_cols, guard=gcfg,
                    guard_draws=draws.guard, faults=faults_arg,
                    telemetry=tel, cohort_idx=idx)
            else:
                Theta_f32, lam_new, m = ota_tree_round(
                    theta, state.lam, chan.h, draws.noise_re, acfg, ccfg,
                    packed=False)
            del draws, faults_arg
            flt_new = state.flt
            if fplan is not None:
                aux = m.pop("_fault_aux", {})
                flt_new = _fplan.commit(flt_mid, aux.get("stale"),
                                        aux.get("evicted"))
            if idx is not None:
                # the others keep their pre-round θ and optimizer rows
                theta = tree_map(lambda full, rows: _cohort.put_rows(
                    full, idx, rows), state.theta, theta)
                opt_state = _scatter_opt(state.opt, opt_state, idx, nu_kept)
            Theta_new = _zmap(lambda T, t: T.to(t.dtype), Theta_f32,
                              state.Theta)
            del Theta_f32
            if tel is not None and "obs/theta_update_norm" not in m:
                # a round without Theta_prev cannot emit the norm itself
                m["obs/theta_update_norm"] = tree_update_norm(Theta_new,
                                                              state.Theta)
            metrics = _obs.merge_disjoint(
                {"loss": loss, "theta_drift": _tree_rms_gap(theta,
                                                            Theta_new)},
                m, fmetrics, who="make_replicated.train_step")
        new_state = TreeFLState(theta=theta, lam=lam_new, Theta=Theta_new,
                                chan=chan, opt=opt_state, step=state.step + 1,
                                flt=flt_new)
        return new_state, metrics

    return init_fn, train_step


def _scatter_opt(full: OptState, new: OptState, idx: Tensor,
                 nu_kept: bool) -> OptState:
    """The population's optimizer state with the cohort's updated rows
    scattered in.  A moment the update passed through untouched
    (``nu_kept``: sgd's ``nu``) is the population's own, so it is kept
    rather than scattered back."""
    mu = tree_map(lambda f, r: _cohort.put_rows(f, idx, r), full.mu, new.mu)
    if new.nu is new.mu:
        nu = mu
    elif nu_kept:
        nu = full.nu
    else:
        nu = tree_map(lambda f, r: _cohort.put_rows(f, idx, r), full.nu,
                      new.nu)
    return OptState(mu=mu, nu=nu, count=new.count)


def _tree_rms_gap(theta_w: PyTree, Theta: PyTree) -> Tensor:
    """RMS over every element of θ_w − Θ (Θ broadcast over workers), a
    worker row at a time: at an LLM's widths a (W, leaf) f32 difference
    would be several GB."""
    num = None
    den = 0
    for t, T in zip(tree_leaves(theta_w), tree_leaves(Theta)):
        Tf = T.float()
        for row in t:
            d = row.float() - Tf
            s = torch.sum(d * d)
            num = s if num is None else num + s
        den += t.numel()
    return torch.sqrt(num / float(den))


def make_fl_train(model: Model, flcfg: FLConfig, acfg: AdmmConfig,
                  ccfg: ChannelConfig, mesh=None, device="cuda"):
    """``(init_fn, train_step)`` for ``flcfg.mode`` on ``device`` (the card
    unless the caller asks for the CPU)."""
    if flcfg.scenario is None:
        orphans = {k: getattr(flcfg, k)
                   for k in ("doppler_hz", "csi_err", "h_min",
                             "slots_per_round")
                   if getattr(flcfg, k) is not None}
        if orphans:
            raise ValueError(
                f"FLConfig{tuple(orphans)} are scenario overrides and do "
                "nothing without FLConfig.scenario — set e.g. "
                "scenario='markov-doppler' (refusing to silently ignore "
                "them)")
    if flcfg.population is None and flcfg.cohort is not None:
        raise ValueError(
            "FLConfig.cohort samples from FLConfig.population and does "
            "nothing without it — set population=N too (refusing to "
            "silently ignore it)")
    if flcfg.mode == "replicated":
        return make_replicated(model, flcfg, acfg, ccfg, mesh=mesh,
                               device=device)
    if flcfg.mode == "sketched":
        raise NotImplementedError("FLConfig mode 'sketched' is not ported yet "
                                  "(ROADMAP queue A item 5: core/sketch.py)")
    raise ValueError(f"unknown FL mode {flcfg.mode!r}")
