"""Federated LLM training: A-FADMM as the aggregation layer.  Counterpart
of ``repro/train/llm_trainer.py`` on one device, in both of its modes.

``replicated``: every FL worker owns a full (θ_n, λ_n) copy; per-worker
tensors carry a leading worker dim W.  The local prox steps run all workers
at once: their losses (one per worker, ``Model.loss`` on W-led parameters)
are summed and back-propagated, which gives each worker its own gradient.
One analog OTA round (``core.tree_ota.ota_tree_round_packed_state``: the
fused uplink B6 + B3, then the dual update B4) produces the new global
model.  Per the paper's Appendix H the stochastic variant skips the flip
rule.  λ and h live persistently packed as ``(W, D)`` Complex buffers on
one device, or as trees of per-leaf buffers under ``packed_uplink=False``
(the leafwise round, one receive chain per leaf).

``sketched`` (A-FADMM-CS, the paper's §6 large-model extension,
:func:`make_sketched`): one shared model Θ; the workers run one after
another from it, each worker's delta is count-sketched by the global
hashed codec (``core.sketch``) and the stacked (W, d_s) sketches ride the
same packed round, so λ and h are (W, d_s) and a model as deep as
granite-8b's 36 layers trains on one card.

Under a ``phy`` scenario the channel is the scenario's (W, D) (or
(W, d_s)) ``PhyState``: its mask truncates workers and its CSI is what the
workers act on.  A ``faults.FaultPlan`` injects uplink faults (its state
rides in the state's ``flt``) and a ``faults.GuardConfig`` guards the
receive.  With ``population``/``cohort`` (replicated mode) the state is a
population's and each round only the sampled cohort trains and transmits;
the others keep their θ, optimizer state and λ.

A batch's leaves lead with the worker dim: ``tokens`` (W, B, S), and the
vlm's ``patches`` or the audio enc-dec's ``frames``.  A round's metrics
carry the moe family's loss terms (``aux``, and ``mtp`` for deepseek-v3)
beside the loss, each a mean over the workers (the reference's trainer
reports the loss alone).

A round's random planes are a :class:`TreeRoundDraws`, drawn from the round
key when not given (:func:`draw_round`), so a test can replay the JAX
package's.  ``telemetry`` adds the round's ``obs/`` keys
(``repro_torch.obs``) and ``ota_block_cols`` picks the fused kernel's plan
(``kernels/ota_round.block_cols_choices``).  Refused by name: a mesh
(ROADMAP queue A item 6) and a transport backend override.
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
from repro_torch.core.sketch import chunks, decode_packed, encode_chunked
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
from repro_torch.models.transformer import unstack
from repro_torch.optim.optimizers import OptState, adam, sgd
from repro_torch.phy.scenario import h_tx as _phys_h_tx
from repro_torch.phy.scenario import make_scenario
from repro_torch.tree import (tree_flatten, tree_leaves, tree_map,
                              tree_stack, tree_unflatten)

Tensor = torch.Tensor
PyTree = Any


@dataclasses.dataclass(frozen=True)
class FLConfig:
    """The JAX package's ``FLConfig``, field for field (see its docs for
    each)."""

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


def _device_of(state) -> torch.device:
    """The device of a trainer state: its packed λ's, or its θ's (the
    leafwise state)."""
    if isinstance(state.lam, Complex):
        return state.lam.re.device
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


def _refuse_mesh_and_backend(flcfg: FLConfig, mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("FLConfig mesh is not ported yet (ROADMAP "
                                  "queue A item 6 (multi-device))")
    transport.check_backend_choice(flcfg.transport_backend)


def _refuse_unported(flcfg: FLConfig, mesh, model: Model) -> None:
    """NotImplementedError for every FLConfig feature the port lacks, named
    with its ROADMAP item, so none is silently ignored; ValueError for a
    column tile no plan of the fused kernel takes at the round's (W, D)."""
    _refuse_mesh_and_backend(flcfg, mesh)
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
        """One prox step of every worker: (θ', opt', mean loss, the means
        of the loss's extra terms).  ``rows``: the cohort's rows of the
        population-wide λ and h trees."""
        leaves = tree_map(lambda l: l.detach().requires_grad_(), theta)
        losses, lm = model.loss(leaves, batch)           # (W,)
        losses.sum().backward()
        with torch.no_grad():
            grads = tree_map(lambda l: l.grad, leaves)
            pen = tree_penalty_grad(theta, lam_tree, h_tree, Theta, acfg.rho,
                                    rows=rows)
            g = tree_map(lambda a, b: a + b.to(a.dtype), grads, pen)
            del grads, pen, leaves
            theta, opt_state = opt.update(g, opt_state, theta)
        return theta, opt_state, losses.detach().mean(), _loss_terms(lm)

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
        loss = terms = None
        for _ in range(flcfg.local_steps):
            theta, opt_state, loss, terms = local_step(
                theta, opt_state, batch, lam_tree, h_tree, state.Theta,
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
                                                            Theta_new),
                 **terms}, m, fmetrics, who="make_replicated.train_step")
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


#: the terms of a family's loss a round reports beside it: the moe
#: family's load-balance ``aux`` and its ``mtp`` cross-entropy
LOSS_TERMS = ("aux", "mtp")


def _loss_terms(lm: dict) -> dict:
    """The :data:`LOSS_TERMS` of ``model.loss``'s metrics, each its mean
    over the workers, detached."""
    return {k: lm[k].detach().float().mean() for k in LOSS_TERMS if k in lm}


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


# ---------------------------------------------------------------------------
# sketched mode (A-FADMM-CS)
# ---------------------------------------------------------------------------

class SketchFLState(NamedTuple):
    Theta: PyTree       # the one shared global model
    lam: Complex        # packed sketch-space duals, (W, d_s) f32
    chan: Any           # TreeChannel or PhyState over (W, d_s)
    step: int
    flt: Any = None     # FaultState (sketch-space layout) or None


#: hash seed of the global packed count-sketch codec
SKETCH_SEED = 17


def _sketch_dim(packed_size: int, ratio: int) -> int:
    if ratio < 1:
        raise ValueError(
            f"FLConfig.sketch_ratio must be a positive compression ratio "
            f"(d_s = ceil(d / ratio)), got {ratio}")
    return max(8, -(-packed_size // ratio))


def make_sketched(model: Model, flcfg: FLConfig, acfg: AdmmConfig,
                  ccfg: ChannelConfig, mesh=None, device="cuda"):
    """``(init_fn, train_step)`` of A-FADMM-CS on one device.

    One shared model Θ; the workers run one after another, each from Θ
    for ``local_steps`` sgd steps on its own batch.  A worker's delta
    (θ − Θ, in the parameter dtype, then f32) is count-sketched by the
    global hashed codec over the packed index space
    (``core.sketch.encode_chunked``: leaf by leaf, a chunk at a time, no
    (D,) buffer), and its θ and gradient go before the next worker starts.
    The stacked (W, d_s) sketches then run the replicated mode's round,
    ``ota_tree_round_packed_state``, as one packed leaf: the fused receive,
    the scenario's mask and CSI, faults and the guard.  The consensus
    sketch is decoded leaf by leaf and applied as
    ``Θ + sketch_lr · decoded`` in the parameter dtype.  On one device the
    reference's shard-local codec is this packed codec; a ``mesh`` is
    refused (ROADMAP queue A item 6)."""
    _refuse_mesh_and_backend(flcfg, mesh)
    if flcfg.population is not None:
        raise ValueError(
            "FLConfig.population/cohort sampling is a replicated-mode "
            "feature (per-worker θ rows to gather); sketched mode "
            "time-multiplexes workers over one shared model and has no "
            "population state to subsample")
    W = flcfg.n_workers
    ratio = flcfg.sketch_ratio
    tel = _obs.resolve(flcfg.telemetry)
    dev = resolve_device(device)
    scn = None
    if flcfg.scenario is not None:
        scn = make_scenario(flcfg.scenario, ccfg,
                            doppler_hz=flcfg.doppler_hz,
                            csi_err=flcfg.csi_err, h_min=flcfg.h_min,
                            slots_per_round=flcfg.slots_per_round)
    fplan, gcfg = flcfg.faults, flcfg.guard

    def init_fn(key: int) -> SketchFLState:
        """Θ from the model's init, λ = 0 and the channel (or the
        scenario's state) over (W, d_s), the fault plan's fresh state."""
        kp, kc = rng.split(key)
        Theta = model.init(kp, device=dev)
        d_s = _sketch_dim(build_packspec(Theta).d, ratio)
        if flcfg.ota_block_cols is not None:
            _round_k.check_block_cols(W, d_s, flcfg.ota_block_cols)
        lam = cplx.czero((W, d_s), device=dev)
        chan = (scn.init(kc, W, d_s, dev) if scn is not None else
                init_channel_packed(rng.generator(kc, dev), W, d_s))
        flt = _fplan.init(fplan, W, d_s, dev) if fplan is not None else None
        return SketchFLState(Theta=Theta, lam=lam, chan=chan, step=0,
                             flt=flt)

    def worker_sketch(Theta: PyTree, batch_w: dict, out: Tensor
                      ) -> Tuple[Tensor, dict]:
        """``local_steps`` sgd steps of one worker from Θ, its delta's
        sketch added into ``out`` (d_s,); returns the loss of the last
        step (at the θ it started from) and that step's loss terms."""
        with torch.no_grad():
            theta = tree_map(torch.clone, Theta)
        # one autograd leaf a layer (views of θ), so each layer's gradient
        # is a tensor of its own
        run = tree_map(lambda l: l.detach().requires_grad_(),
                       unstack(theta) if isinstance(theta, dict) else theta)
        leaves = tree_leaves(run)
        loss = terms = None
        for _ in range(flcfg.local_steps):
            loss, lm = model.loss(run, batch_w)
            terms = _loss_terms(lm)
            del lm
            loss.backward()
            with torch.no_grad():
                for p in leaves:
                    # θ − lr·g in the param dtype: p's storage is θ's
                    p.sub_(p.grad.to(p.dtype).mul_(flcfg.local_lr))
                    p.grad = None
            loss = loss.detach()
        del run, leaves
        with torch.no_grad():
            for t, T in zip(tree_leaves(theta), tree_leaves(Theta)):
                t.sub_(T)              # the delta, rounded in the dtype
            encode_chunked(tree_leaves(theta), out.shape[-1], SKETCH_SEED,
                           out=out)
        return loss, terms

    def apply_delta(Theta: PyTree, s: Tensor) -> Tuple[PyTree, Tensor]:
        """Θ + sketch_lr · decode(s), a leaf and a chunk at a time in the
        param dtype; and ‖decode(s)‖² (f32)."""
        lr = flcfg.sketch_lr
        sq = torch.zeros((), dtype=torch.float32, device=s.device)
        new, off = [], 0
        leaves, treedef = tree_flatten(Theta)
        for p in leaves:
            out = torch.empty_like(p)
            src, dst = p.reshape(-1), out.view(-1)
            for a, b in chunks(src.shape[0]):
                dg = decode_packed(s, b - a, SKETCH_SEED, off + a)
                if tel is not None:
                    sq += torch.dot(dg, dg)
                torch.add(src[a:b], dg.to(p.dtype).mul_(lr), out=dst[a:b])
            new.append(out)
            off += src.shape[0]
        return tree_unflatten(treedef, new), sq

    def train_step(state: SketchFLState, batch: dict,
                   key: Optional[int] = None,
                   draws: Optional[TreeRoundDraws] = None
                   ) -> Tuple[SketchFLState, dict]:
        """One round.  batch leaves: (W, B_w, ...), a worker's rows each;
        the round's planes (at (W, d_s)) are ``draws``, else drawn from
        ``key`` as the replicated mode draws them."""
        if draws is None:
            if key is None:
                raise ValueError("train_step needs a round key or the "
                                 "round's draws")
            draws = draw_round(key, state, ccfg, scenario=scn, faults=fplan,
                               guard=gcfg)
        W_, d_s = state.lam.re.shape
        mask = h_tx_p = Theta_prev = None
        if scn is not None:
            chan = scn.step(state.chan, draws.phy)   # PhyState, (W, d_s)
            if scn.truncating:
                mask = chan.mask
            if scn.imperfect_csi:
                h_tx_p = chan.h_hat
        else:
            chan, _ = step_channel_packed(state.chan, ccfg, draws.h_fresh)
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
        if mask is not None or gcfg is not None or fplan is not None:
            # a skipped or all-masked round must leave Θ alone: the
            # fallback consensus is the zero sketch, which decodes to 0
            Theta_prev = torch.zeros((d_s,), dtype=torch.float32,
                                     device=state.lam.re.device)

        s_w = torch.zeros((W_, d_s), dtype=torch.float32,
                          device=state.lam.re.device)
        losses, terms = [], []
        for w in range(W_):
            batch_w = tree_map(lambda l: l[w], batch)
            loss_w, terms_w = worker_sketch(state.Theta, batch_w, s_w[w])
            losses.append(loss_w)
            terms.append(terms_w)

        with torch.no_grad():
            # the consensus round in sketch space: s_w is the packed buffer
            spec = build_packspec(s_w, batch_dims=1)
            Theta_s, lam_new, m = ota_tree_round_packed_state(
                s_w, state.lam, chan.h, draws.noise_re, acfg, ccfg, spec,
                mask=mask, h_tx_p=h_tx_p, Theta_prev=Theta_prev,
                fused=flcfg.ota_fused, worker_chunk=flcfg.ota_worker_chunk,
                block_cols=flcfg.ota_block_cols, guard=gcfg,
                guard_draws=draws.guard, faults=faults_arg, telemetry=tel)
            del s_w, draws, faults_arg
            Theta_new, sq = apply_delta(state.Theta, Theta_s)
            flt_new = state.flt
            if fplan is not None:
                aux = m.pop("_fault_aux", {})
                flt_new = _fplan.commit(flt_mid, aux.get("stale"),
                                        aux.get("evicted"))
            metrics = _obs.merge_disjoint(
                {"loss": torch.stack(losses).mean(),
                 **{k: torch.stack([t[k] for t in terms]).mean()
                    for k in terms[0]}}, m, fmetrics,
                who="make_sketched.train_step")
            if tel is not None:
                # the model-space update norm (sketch_lr · ‖decoded
                # delta‖), in place of the sketch-space norm of the round
                metrics["obs/theta_update_norm"] = \
                    flcfg.sketch_lr * torch.sqrt(sq)
        new_state = SketchFLState(Theta=Theta_new, lam=lam_new, chan=chan,
                                  step=state.step + 1, flt=flt_new)
        return new_state, metrics

    return init_fn, train_step


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
        return make_sketched(model, flcfg, acfg, ccfg, mesh=mesh,
                             device=device)
    raise ValueError(f"unknown FL mode {flcfg.mode!r}")
