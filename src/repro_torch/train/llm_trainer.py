"""Federated LLM training: A-FADMM as the aggregation layer.  Counterpart
of ``repro/train/llm_trainer.py``, in both of its modes, on one device or
as the ranks of a mesh.

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
package's.  A packed fading block's row w comes from ``fold_in(kc, w)``
(``channel.rayleigh_rows``; a scenario's fading too,
``Scenario.row_keyed``), so a pure-data mesh's ranks draw one device's
rows.  ``telemetry`` adds the round's ``obs/`` keys
(``repro_torch.obs``) and ``ota_block_cols`` picks the fused kernel's plan
(``kernels/ota_round.block_cols_choices``).

``mesh`` (a ``launch.mesh.Mesh``) runs the trainer as one rank of a
(data, fsdp, model) process grid.  In the replicated mode
(:func:`_mesh_replicated`) the rank holds the rows of its workers (its
coordinate on the data axes) and, when the grid shards the model (model >
1 or fsdp > 1), its (fsdp, model) shard of θ, Θ, the optimizer state and
of the global shard-packed (W, d_pad) λ and h
(``core.packing.ShardPackSpec`` over ``launch.shardings.shard_dims_2d``).
The local steps run the gathered forward (``models.gather``), in which
every family computes each rank's own heads, ff columns, experts, inner or
RG-LRU channels and vocab rows on its model block (``models.partition``;
every model rank of a data row takes the same batch rows, the enc-dec's
``frames`` with its tokens), the penalty
reads λ and h through ``tree_ota.unpack_cplx_shard_local`` and the round is
``tree_ota.ota_tree_round_shard_local``.  A pure-data mesh keeps the global
packed layout, its worker rows split over the data axes, and samples a
cohort; ``packed_uplink=False`` runs the leafwise round on each rank's
blocks.  In the sketched mode Θ is the rank's shard of the codec's grid,
each rank encodes its resident slice and the partial sketches sum over
the grid (:func:`make_sketched`).  A transport backend override is refused
by name.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch import obs as _obs
from repro_torch import optflags, rng
from repro_torch.core import cohort as _cohort
from repro_torch.core import cplx, transport
from repro_torch.core.admm import AdmmConfig
from repro_torch.core.channel import ChannelConfig, rayleigh, rayleigh_rows
from repro_torch.core.cplx import Complex
from repro_torch.core.packing import (build_packspec, build_shard_packspec,
                                      pack_shard_local, shard_tree,
                                      shard_valid_mask, unpack_cplx,
                                      unpack_shard_local)
from repro_torch.core.sketch import (chunks, decode_packed,
                                     decode_shard_local, encode_chunked,
                                     encode_shard_local)
from repro_torch.core.tree_ota import (TreeChannel, TreeFLState, _zmap,
                                       draw_channel_tree,
                                       init_channel_packed, init_channel_tree,
                                       ota_tree_round, ota_tree_round_leafwise,
                                       ota_tree_round_packed_state,
                                       ota_tree_round_shard_local, redraws,
                                       shard_coords, shard_replication,
                                       shard_update_norm,
                                       step_channel_packed, step_channel_tree,
                                       tree_penalty_grad, tree_update_norm,
                                       unpack_cplx_shard_local)
from repro_torch.device import resolve_device
from repro_torch.faults import guards as _guards
from repro_torch.faults import plan as _fplan
from repro_torch.kernels import ota_round as _round_k
from repro_torch.models import gather as _gather
from repro_torch.models.partition import partition_for
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


def block_key(key: int, shard: int, data_rank: int) -> int:
    """The key of a shard-grid rank's block of a (W, d_pad) plane: the rank
    draws its (W_local, d_local) block alone, from the plane's key folded
    with its shard and then its data rank."""
    return rng.fold_in(rng.fold_in(key, shard), data_rank)


def draw_round(key: int, state: TreeFLState, ccfg: ChannelConfig, *,
               scenario=None, faults: Optional[_fplan.FaultPlan] = None,
               guard: Optional[_guards.GuardConfig] = None,
               cohort: Optional[_cohort.CohortConfig] = None,
               mesh_rank: Optional[Tuple[int, int, bool]] = None
               ) -> TreeRoundDraws:
    """The round's planes from its key, split as JAX splits it: ``kc`` the
    channel (the redraw block, drawn only on a redraw round, or the
    scenario's draws), ``kn`` the noise (per leaf: ``split(kn, n_leaves)``
    for the leafwise state) and the guard's planes (folds of ``kn``); the
    fault uniforms from the key's ``FAULT_SALT`` fold and the cohort plane
    from its ``COHORT_SALT`` fold.  A packed redraw block is
    ``channel.rayleigh_rows``': worker w's row from ``fold_in(kc, w)``.

    ``mesh_rank = (shard j, data rank, shard_local)`` draws one mesh rank's
    planes.  On a pure-data mesh its redraw rows are the rows of its
    workers (the one-device plane's, bit for bit) and its noise is the
    packed round's, from ``kn``.  On the shard grid its redraw block comes
    from :func:`block_key` (a scenario's from its shard's keys,
    ``Scenario.draw(shard=)``, every worker's row) and its noise (d_local,)
    from ``fold_in(kn, j)`` (JAX's per-shard noise); the guard's planes
    come from that noise key.  The fault uniforms and the cohort plane stay
    global."""
    kc, kn = rng.split(key)
    dev = _device_of(state)
    leafwise = not isinstance(state.lam, Complex)
    h_fresh = phy = None
    shard = None
    row0 = 0
    if mesh_rank is not None:
        j, jd, shard_local = mesh_rank
        if shard_local:
            shard = j
            kn = rng.fold_in(kn, j)
            if scenario is None:
                kc = block_key(kc, j, jd)
        elif not leafwise:
            row0 = jd * state.lam.re.shape[0]
    if scenario is not None:
        phy = (scenario.draw(kc, state.chan) if shard is None
               else scenario.draw(kc, state.chan, shard=shard))
    elif redraws(state.chan, ccfg):
        if leafwise:
            h_fresh = draw_channel_tree(kc, state.chan.h)
        elif shard is not None:
            h_fresh = rayleigh(rng.generator(kc, dev),
                               tuple(state.lam.re.shape))
        else:
            W_l, d = state.lam.re.shape
            h_fresh = rayleigh_rows(kc, range(row0, row0 + W_l), d, dev)
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


def _refuse_unported(flcfg: FLConfig, model: Model) -> None:
    """ValueError for a transport backend other than the port's and for a
    column tile no plan of the fused kernel takes at the round's (W, D)."""
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
    """``(init_fn, train_step)`` of the replicated mode: on one device one
    globally packed (W, D) buffer each for λ and h, or per-leaf trees under
    ``packed_uplink=False``; under ``mesh`` one rank's part of the state
    and of the round (:func:`_mesh_replicated`)."""
    _refuse_unported(flcfg, model)
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
                            slots_per_round=flcfg.slots_per_round,
                            row_keyed=True)
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
    if mesh is not None:
        return _mesh_replicated(model, flcfg, acfg, ccfg, mesh, dev, W, opt,
                                tel, cohort_cfg, scn, packed_layout)

    def init_fn(key: int) -> TreeFLState:
        """Per-worker random init (worker w from ``fold_in(kp, w)``), Θ the
        workers' mean in the param dtype, λ = 0, one Rayleigh block (worker
        w's row from ``fold_in(kc, w)``; or the scenario's initial state),
        the fault plan's fresh state."""
        kp, kc = rng.split(key)
        theta = tree_stack([model.init(rng.fold_in(kp, w), device=dev)
                            for w in range(W)])           # leaves (W, ...)
        Theta = tree_map(lambda l: l.float().mean(0).to(l.dtype), theta)
        flt = None
        if packed_layout:
            d = build_packspec(theta, batch_dims=1).d
            lam = cplx.czero((W, d), device=dev)
            chan = (scn.init(kc, W, d, dev) if scn is not None else
                    init_channel_packed(kc, range(W), d, dev))
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
        # under a mesh's gather plan the forward sees the full parameters
        losses, lm = model.loss(_gather.gather_params(leaves), batch)  # (W,)
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


def _mesh_replicated(model: Model, flcfg: FLConfig, acfg: AdmmConfig,
                     ccfg: ChannelConfig, mesh, dev: torch.device, W: int,
                     opt, tel, cohort_cfg, scn, packed_layout: bool):
    """The replicated mode as one rank of ``mesh`` (SPMD: every rank runs
    the same calls, with the mesh's collectives where the JAX package's
    ``shard_map`` bodies and XLA's partitioning put theirs).

    The rank holds workers ``[jd·W_l, (jd+1)·W_l)`` (``jd`` its data
    coordinate) and, on a model-parallel grid, its (fsdp, model) shard:
    θ, Θ and the optimizer state as resident blocks, λ and h as its
    ``(W_l, d_local)`` block of the global shard-packed ``(W, d_pad)``
    planes.  A pure-data mesh keeps the global packed layout (a 1 x 1
    grid's ``ShardPackSpec`` is ``PackSpec``'s), and its h rows are the
    one-device plane's (``channel.rayleigh_rows``), so it computes one
    device's rounds.  ``init_fn`` builds the layout from the full init it
    slices, so it runs before ``train_step``.  The batch a rank's
    ``train_step`` takes is its workers' rows (W_l, B, ...).  A round's
    metrics are global values, the same on every rank.

    Under a scenario the rank's ``PhyState`` holds every worker's row and
    its shard's columns (``Scenario.init(shard=)``: the per-worker state,
    the geometry and a frequency-flat fade, is every rank's; the
    per-element planes are the shard's), so the mask is global and the
    round reads the rank's rows.  A truncating per-element scenario on the
    shard grid takes each row's RMS over the grid (one psum of a (W,) sum
    of squares; padding never counts).

    Cohort sampling (a pure-data mesh; the shard grid refuses it, as the
    JAX package does): the population's rows split over the data ranks, and
    the round's cohort (the same indices on every rank) splits as a batch
    does, ``cohort / n_data`` sampled workers a rank.  A rank's cohort rows
    of θ, the optimizer state, λ, h and the straggler snapshot come from
    their owners by one all-gather over the data axes a tensor, and go back
    to them the same way after the round.

    ``packed_uplink=False`` keeps θ's leaf layout for λ and h too: the
    rank's (fsdp, model) block of each leaf, its workers' rows, and the
    leafwise round (``tree_ota.ota_tree_round_leafwise(mesh=)``).  Leaf
    i's block of h and of the noise draw from ``fold_in(kc, i)`` folded
    with the block's grid index (then the data rank, for h), so the ranks
    that hold one block draw it alike."""
    from repro_torch.launch.shardings import shard_dims_2d

    fplan, gcfg = flcfg.faults, flcfg.guard
    model_n = mesh.shape.get("model", 1)
    fsdp_n = mesh.shape.get("fsdp", 1)
    shard_local = model_n > 1 or fsdp_n > 1
    mc = shard_coords(mesh)
    sampling = _cohort.cohort_active(cohort_cfg)
    if sampling and shard_local:
        raise ValueError(
            "FLConfig.population/cohort sampling is not supported on "
            "the shard-local packed layout yet — run cohort sampling "
            "on a single-device or pure-data mesh")
    Wc = cohort_cfg.cohort if cohort_cfg is not None else W
    for n, what in ((W, "workers"), (Wc, "cohort workers")):
        if n % mc.n_data:
            raise ValueError(f"{n} {what} do not split over the "
                             f"{mc.n_data} ranks of the data axes "
                             f"{mc.daxes}")
    shard = mc.j if shard_local else None
    W_l, Wc_l = W // mc.n_data, Wc // mc.n_data
    rows = slice(mc.jd * W_l, (mc.jd + 1) * W_l)     # the rank's workers
    slots = slice(mc.jd * Wc_l, (mc.jd + 1) * Wc_l)  # its cohort slots
    every = mesh.axis_names
    grid_rms = (scn is not None and shard_local and scn.truncating
                and not scn.cfg.freq_flat)
    layout: dict = {}

    def spec_of(theta: PyTree):
        if not shard_local:
            n = len(tree_leaves(theta))
            return build_shard_packspec(theta, (None,) * n, 1, batch_dims=1)
        mdims, fdims = shard_dims_2d(theta, model.cfg, mesh,
                                     multi_pod="pod" in mesh.axis_names)
        return build_shard_packspec(theta, mdims, model_n, batch_dims=1,
                                    fsdp_dims=fdims, n_fsdp=fsdp_n)

    def rms_mask(known: Complex) -> Tensor:
        """Deep-fade truncation on the grid: each worker's RMS |h| over its
        whole row, from the (W, d_local) pieces of the ranks."""
        sq = torch.where(layout["valid"], cplx.abs2(known), 0.0).sum(-1)
        sq = mesh.psum(sq, mc.saxes)
        return (torch.sqrt(sq / float(layout["sspec"].spec.d))
                >= scn.cfg.h_min)

    mask_fn = rms_mask if grid_rms else None

    def leaf_key(key: int, i: int) -> int:
        """Leaf i's key folded with the grid index of the rank's block."""
        sspec = layout["sspec"]
        jb = ((mc.jf if sspec.fsdp_dims[i] is not None else 0) * model_n
              + (mc.jm if sspec.shard_dims[i] is not None else 0))
        return rng.fold_in(rng.fold_in(key, i), jb)

    def leaf_blocks(kc: int, leaves) -> list:
        return [rayleigh(rng.generator(rng.fold_in(leaf_key(kc, i), mc.jd),
                                       dev), tuple(leaf.shape))
                for i, leaf in enumerate(leaves)]

    def leaf_draws(key: int, state: TreeFLState) -> TreeRoundDraws:
        kc, kn = rng.split(key)
        leaves = tree_leaves(state.theta)
        h_fresh = (leaf_blocks(kc, leaves) if redraws(state.chan, ccfg)
                   else None)
        noise = [transport.matched_filter_noise_re(
            rng.generator(leaf_key(kn, i), dev), tuple(leaf.shape[1:]), ccfg)
            for i, leaf in enumerate(leaves)]
        return TreeRoundDraws(h_fresh, noise)

    def init_fn(key: int) -> TreeFLState:
        """Each rank inits its workers as one device inits them (worker w
        from ``fold_in(kp, w)``) and keeps its shard of them, bit for bit
        the one-device init's slice; Θ is the mean over all W workers, as
        one device sums it; λ = 0; h the rank's rows of the one-device
        plane on a pure-data mesh, else its block (:func:`block_key`; per
        leaf under ``packed_uplink=False``)."""
        kp, kc = rng.split(key)
        full = tree_stack([model.init(rng.fold_in(kp, w), device=dev)
                           for w in range(W)[rows]])
        sspec = spec_of(full)
        layout["sspec"] = sspec
        layout["plan"] = (_gather.make_plan(
            full, sspec.shard_dims, sspec.fsdp_dims, mesh,
            part=partition_for(model.cfg, mesh,
                               multi_pod="pod" in mesh.axis_names))
            if shard_local else None)
        layout["valid"] = (shard_valid_mask(sspec, mc.j, dev) if grid_rms
                           else None)
        # Θ is the mean over every worker's rows, gathered, in one
        # device's order of summation
        Theta = tree_map(lambda l: mesh.all_gather(l, mc.daxes, 0).float()
                         .mean(0).to(l.dtype), full)
        theta = tree_map(torch.clone, shard_tree(sspec, full, mc.j))
        Theta = tree_map(torch.clone, shard_tree(sspec, Theta, mc.j))
        del full
        d_local = sspec.d_local
        flt = None
        if not packed_layout:
            lam = tree_map(lambda l: cplx.czero(tuple(l.shape), device=dev),
                           theta)
            leaves, treedef = tree_flatten(theta)
            chan = TreeChannel(h=tree_unflatten(treedef,
                                                leaf_blocks(kc, leaves)),
                               age=0)
            return TreeFLState(theta=theta, lam=lam, Theta=Theta, chan=chan,
                               opt=opt.init(theta), step=0, flt=None)
        lam = cplx.czero((W_l, d_local), device=dev)
        if scn is not None:
            chan = scn.init(kc, W, d_local, dev, shard=shard,
                            mask_fn=mask_fn)
        elif shard_local:
            chan = TreeChannel(h=rayleigh(rng.generator(
                block_key(kc, mc.j, mc.jd), dev), (W_l, d_local)), age=0)
        else:
            chan = init_channel_packed(kc, range(W)[rows], d_local, dev)
        if fplan is not None:
            # alive is every rank's global (W,); the straggler snapshot is
            # the rank's block, as λ
            flt = _fplan.FaultState(
                alive=torch.ones(W, dtype=torch.bool, device=dev),
                stale=(torch.zeros((W_l, d_local), device=dev)
                       if fplan.has_stragglers else None),
                round=0, n_evicted=torch.zeros((), dtype=torch.int32,
                                               device=dev))
        return TreeFLState(theta=theta, lam=lam, Theta=Theta, chan=chan,
                           opt=opt.init(theta), step=0, flt=flt)

    def take(x: Optional[Tensor], idx: Tensor) -> Optional[Tensor]:
        """The rows of this rank's cohort slots from the population rows
        the data ranks hold: every rank lays the rows it owns into a (Wc,
        ...) plane, and one all-gather over the data axes brings each slot
        its owner's row."""
        if x is None:
            return None
        if isinstance(x, Complex):
            return Complex(take(x.re, idx), take(x.im, idx))
        own = idx // W_l == mc.jd
        buf = torch.zeros((Wc,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        buf[own] = x[idx[own] - mc.jd * W_l]
        pieces = mesh.all_gather(buf, mc.daxes, 0)     # (n_data·Wc, ...)
        mine = idx[slots]
        return pieces[(mine // W_l) * Wc
                      + torch.arange(slots.start, slots.stop,
                                     device=idx.device)]

    def put(full, idx: Tensor, new):
        """This rank's population rows with the cohort's updated rows
        (``new``: its slots') scattered in: one all-gather of the slots'
        rows over the data axes."""
        if full is None:
            return None
        if isinstance(full, Complex):
            return Complex(put(full.re, idx, new.re), put(full.im, idx,
                                                          new.im))
        every_slot = mesh.all_gather(new.contiguous(), mc.daxes, 0)
        own = idx // W_l == mc.jd
        out = full.clone()
        out[idx[own] - mc.jd * W_l] = every_slot[own].to(full.dtype)
        return out

    def local_step(theta, opt_state, batch, lam_tree, h_tree, Theta):
        leaves = tree_map(lambda l: l.detach().requires_grad_(), theta)
        with _gather.gathering(layout["plan"]):
            losses, lm = model.loss(_gather.gather_params(leaves), batch)
            losses.sum().backward()
        with torch.no_grad():
            grads = tree_map(lambda l: l.grad, leaves)
            pen = tree_penalty_grad(theta, lam_tree, h_tree, Theta, acfg.rho)
            g = tree_map(lambda a, b: a + b.to(a.dtype), grads, pen)
            del grads, pen, leaves
            theta, opt_state = opt.update(g, opt_state, theta)
        return theta, opt_state, losses.detach(), lm

    def over_workers(v: Tensor) -> Tensor:
        """The mean over the round's Wc workers of a (Wc_l,) value."""
        if mc.n_data == 1:
            return v.float().mean()
        return mesh.psum(v.float().sum(), mc.daxes) / Wc

    def rms_gap(theta_w: PyTree, Theta: PyTree, sspec) -> Tensor:
        num = None
        for i, (t, T) in enumerate(zip(tree_leaves(theta_w),
                                       tree_leaves(Theta))):
            Tf = T.float()
            s = sum(torch.sum((row.float() - Tf) ** 2) for row in t)
            s = s / float(shard_replication(sspec, i))
            num = s if num is None else num + s
        return torch.sqrt(mesh.psum(num, every) / float(W * sspec.spec.d))

    def train_step(state: TreeFLState, batch: dict, key: Optional[int] = None,
                   draws: Optional[TreeRoundDraws] = None
                   ) -> Tuple[TreeFLState, dict]:
        """One round of this rank.  batch leaves: (Wc_l, B, ...), the rows
        of the rank's workers (its cohort slots under sampling); the
        round's planes are ``draws`` (this rank's blocks), else drawn from
        ``key``."""
        sspec = layout.get("sspec")
        if sspec is None:
            raise ValueError("train_step under a mesh: call init_fn first "
                             "(the shard-local layout is built from the "
                             "init it slices)")
        packed = isinstance(state.lam, Complex)
        if draws is None:
            if key is None:
                raise ValueError("train_step needs a round key or the "
                                 "round's draws")
            draws = (draw_round(key, state, ccfg, scenario=scn,
                                faults=fplan, guard=gcfg, cohort=cohort_cfg,
                                mesh_rank=(mc.j, mc.jd, shard_local))
                     if packed else leaf_draws(key, state))
        mask = Theta_prev = faults_arg = h_tx_p = idx = None
        h_all = None
        if not packed:
            chan, _ = step_channel_tree(state.chan, ccfg, draws.h_fresh)
        elif scn is not None:
            # every worker's rows
            chan = scn.step(state.chan, draws.phy, mask_fn=mask_fn)
            h_all = (chan.h, _phys_h_tx(chan))
            if scn.truncating:
                mask, Theta_prev = chan.mask, state.Theta
        else:
            chan, _ = step_channel_packed(state.chan, ccfg, draws.h_fresh)
        draws = draws._replace(h_fresh=None, phy=None)
        state = state._replace(chan=None)
        theta_run, opt_run, lam_run = state.theta, state.opt, state.lam
        if sampling:
            # the cohort: global indices, the same on every rank
            wgt = None
            if cohort_cfg.policy != "uniform":
                wgt = _cohort.channel_weight(chan.h)
                if scn is None:
                    wgt = mesh.all_gather(wgt, mc.daxes, 0)
            idx = _cohort.sample_cohort(cohort_cfg, draws.cohort, wgt)
            theta_run = tree_map(lambda l: take(l, idx), state.theta)
            opt_run = _opt_map(lambda l: take(l, idx), state.opt)
            lam_run = take(state.lam, idx)
        if h_all is not None:
            sel = rows if idx is None else idx[slots]
            h_air, h_pack = (Complex(z.re[sel], z.im[sel]) for z in h_all)
            if scn.imperfect_csi:
                h_tx_p = h_pack
            del h_all
        elif packed:
            h_air = h_pack = chan.h if idx is None else take(chan.h, idx)
        if packed:
            lam_tree = unpack_cplx_shard_local(sspec, lam_run, mesh)
            h_tree = unpack_cplx_shard_local(sspec, h_pack, mesh)
            del h_pack
        else:
            lam_tree, h_tree = state.lam, chan.h
        fmetrics = {}
        flt_mid = state.flt
        if fplan is not None:
            if draws.faults is None:
                raise ValueError("a round under a fault plan needs "
                                 "draws.faults")
            rf, flt_mid, fmetrics = _fplan.draw(fplan, state.flt,
                                                draws.faults)
            mask = rf.alive if mask is None else mask & rf.alive
            stale = state.flt.stale
            if idx is not None:
                rt = _cohort.take_rows
                rf = rf._replace(alive=rt(rf.alive, idx),
                                 straggler=rt(rf.straggler, idx),
                                 corrupt=rt(rf.corrupt, idx),
                                 snapshot_due=rt(rf.snapshot_due, idx))
                stale = take(stale, idx)
            faults_arg = (fplan, rf, stale)
        if fplan is not None or gcfg is not None:
            Theta_prev = state.Theta
        if idx is not None and mask is not None:
            mask = mask[idx]         # the round's (Wc,) mask
        theta, opt_state = theta_run, opt_run
        if idx is None:
            del theta_run, opt_run
            state = state._replace(theta=None, opt=None)
        losses = lm = None
        for _ in range(flcfg.local_steps):
            theta, opt_state, losses, lm = local_step(
                theta, opt_state, batch, lam_tree, h_tree, state.Theta)
        del lam_tree, h_tree
        nu_kept = None
        if idx is not None:
            nu_kept = opt_state.nu is opt_run.nu
            del theta_run, opt_run
        with torch.no_grad():
            if packed:
                Theta_f32, lam_new, m = ota_tree_round_shard_local(
                    theta, lam_run, h_air, draws.noise_re, acfg, ccfg, sspec,
                    mesh, mask=mask, h_tx_p=h_tx_p, Theta_prev=Theta_prev,
                    fused=flcfg.ota_fused, block_cols=flcfg.ota_block_cols,
                    guard=gcfg, guard_draws=draws.guard, faults=faults_arg,
                    telemetry=tel)
                del h_air, h_tx_p
            else:
                Theta_f32, lam_new, m = ota_tree_round_leafwise(
                    theta, state.lam, chan.h, draws.noise_re, acfg, ccfg,
                    mesh=mesh, sspec=sspec)
            del draws, faults_arg, lam_run
            flt_new = state.flt
            if fplan is not None:
                aux = m.pop("_fault_aux", {})
                stale_new, evicted = aux.get("stale"), aux.get("evicted")
                if idx is not None:
                    if stale_new is not None:
                        stale_new = put(state.flt.stale, idx, stale_new)
                    if evicted is not None:
                        evicted = _cohort.put_rows(torch.zeros(
                            W, dtype=torch.bool, device=dev), idx, evicted)
                flt_new = _fplan.commit(flt_mid, stale_new, evicted)
            if idx is not None:
                # the others keep their pre-round θ, optimizer and λ rows
                theta = tree_map(lambda full, r: put(full, idx, r),
                                 state.theta, theta)
                opt_state = _scatter_opt(state.opt, opt_state, idx, nu_kept,
                                         put)
                lam_new = put(state.lam, idx, lam_new)
                if tel is not None:
                    m = _obs.merge_disjoint(
                        m, _cohort.cohort_metrics(cohort_cfg),
                        who="make_replicated.train_step.cohort")
            Theta_new = _zmap(lambda T, t: T.to(t.dtype), Theta_f32,
                              state.Theta)
            del Theta_f32
            if tel is not None and "obs/theta_update_norm" not in m:
                m["obs/theta_update_norm"] = shard_update_norm(
                    sspec, Theta_new, state.Theta, mesh, mc.saxes)
            terms = {k: over_workers(lm[k].detach()) for k in LOSS_TERMS
                     if k in lm}
            metrics = _obs.merge_disjoint(
                {"loss": over_workers(losses),
                 "theta_drift": rms_gap(theta, Theta_new, sspec), **terms},
                m, fmetrics, who="make_replicated.train_step")
        new_state = TreeFLState(theta=theta, lam=lam_new, Theta=Theta_new,
                                chan=chan, opt=opt_state, step=state.step + 1,
                                flt=flt_new)
        return new_state, metrics

    init_fn.layout = layout
    return init_fn, train_step


def _scatter_opt(full: OptState, new: OptState, idx: Tensor,
                 nu_kept: bool, put=_cohort.put_rows) -> OptState:
    """The population's optimizer state with the cohort's updated rows
    scattered in (by ``put``: a mesh's scatter, or ``cohort.put_rows``).
    A moment the update passed through untouched (``nu_kept``: sgd's
    ``nu``) is the population's own, so it is kept rather than scattered
    back."""
    mu = tree_map(lambda f, r: put(f, idx, r), full.mu, new.mu)
    if new.nu is new.mu:
        nu = mu
    elif nu_kept:
        nu = full.nu
    else:
        nu = tree_map(lambda f, r: put(f, idx, r), full.nu, new.nu)
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
    """``(init_fn, train_step)`` of A-FADMM-CS.

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
    ``Θ + sketch_lr · decoded`` in the parameter dtype.

    Under ``mesh`` (SPMD, as the JAX package's ``shard_map`` codec) Θ is
    held as each rank's shard of the codec's (fsdp, model) grid: the
    ``fsdp`` axis, or the data axes on a mesh without one
    (``launch.shardings.fsdp_axes(worker_dim=False)``), by
    ``shard_dims_2d(worker_dim=False)``.  The local steps run the gathered
    forward (``models.gather``, no worker dim); a worker's batch rows
    split over the data axes as XLA partitions the reference's batch, and
    its gradient sums over them (in the gathers' backward where the grid
    rides the data axes: an all-reduce, or a reduce-scatter under
    ``REPRO_OPT=rs_grads``; an all-reduce of the shard's gradient
    elsewhere).  Each rank encodes its resident slice
    (``core.packing.pack_shard_local``, ``core.sketch.encode_shard_local``
    on its canonical indices, a chunk at a time) and one psum over the
    grid's axes adds the (W, d_s) partial sketches into the global codec's.
    The (W, d_s) λ, h and scenario state are whole on every rank, drawn
    from the same key, so the round runs alike on every rank; each rank
    then decodes its own coordinates (and the B, C and replicated segments
    it unpacks), with no collective.  ``init_fn.layout`` holds the codec's
    spec (``"sspec"``), its fsdp axes (``"faxes"``) and the rank's flat
    shard (``"j"``); a rank's ``train_step`` takes its rows of every
    worker's batch, (W, B_l, ...)."""
    transport.check_backend_choice(flcfg.transport_backend)
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
                            slots_per_round=flcfg.slots_per_round,
                            row_keyed=True)
    fplan, gcfg = flcfg.faults, flcfg.guard
    grid = None if mesh is None else _SketchGrid(model, mesh)
    layout: dict = {}

    def init_fn(key: int) -> SketchFLState:
        """Θ from the model's init (the rank's shard of it under a mesh),
        λ = 0 and the channel (or the scenario's state) over (W, d_s), the
        fault plan's fresh state."""
        kp, kc = rng.split(key)
        Theta = model.init(kp, device=dev)
        d_s = _sketch_dim(build_packspec(Theta).d, ratio)
        if grid is not None:
            Theta = grid.init(Theta, layout)
        if flcfg.ota_block_cols is not None:
            _round_k.check_block_cols(W, d_s, flcfg.ota_block_cols)
        lam = cplx.czero((W, d_s), device=dev)
        chan = (scn.init(kc, W, d_s, dev) if scn is not None else
                init_channel_packed(kc, range(W), d_s, dev))
        flt = _fplan.init(fplan, W, d_s, dev) if fplan is not None else None
        return SketchFLState(Theta=Theta, lam=lam, chan=chan, step=0,
                             flt=flt)

    def worker_sketch(Theta: PyTree, batch_w: dict, out: Tensor
                      ) -> Tuple[Tensor, dict]:
        """``local_steps`` sgd steps of one worker from Θ, its delta's
        sketch added into ``out`` (d_s,) (the rank's partial sketch under
        a mesh); returns the loss of the last step (at the θ it started
        from) and that step's loss terms."""
        with torch.no_grad():
            theta = tree_map(torch.clone, Theta)
        if grid is not None:
            loss, terms = grid.local_steps(theta, batch_w, flcfg.local_steps,
                                           flcfg.local_lr)
        else:
            # one autograd leaf a layer (views of θ), so each layer's
            # gradient is a tensor of its own
            run = tree_map(lambda l: l.detach().requires_grad_(),
                           unstack(theta) if isinstance(theta, dict)
                           else theta)
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
            if grid is not None:
                grid.encode(theta, out)
            else:
                encode_chunked(tree_leaves(theta), out.shape[-1],
                               SKETCH_SEED, out=out)
        return loss, terms

    def apply_delta(Theta: PyTree, s: Tensor) -> Tuple[PyTree, Tensor]:
        """Θ + sketch_lr · decode(s) in the param dtype, and ‖decode(s)‖²
        (f32) when telemetry reads it."""
        if grid is not None:
            return grid.apply_delta(Theta, s, flcfg.sketch_lr,
                                    tel is not None)
        return _apply_packed(Theta, s, flcfg.sketch_lr, tel is not None)

    def train_step(state: SketchFLState, batch: dict,
                   key: Optional[int] = None,
                   draws: Optional[TreeRoundDraws] = None
                   ) -> Tuple[SketchFLState, dict]:
        """One round.  batch leaves: (W, B_w, ...), a worker's rows each
        (under a mesh, the rank's rows of each); the round's planes (at
        (W, d_s)) are ``draws``, else drawn from ``key`` as the replicated
        mode draws them."""
        if grid is not None and "sspec" not in layout:
            raise ValueError("train_step under a mesh: call init_fn first "
                             "(the codec's layout is built from the init "
                             "it slices)")
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
            if grid is not None:
                # the partial sketches into the global codec's
                s_w = grid.join(s_w)
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

    init_fn.layout = layout
    return init_fn, train_step


class _SketchGrid:
    """The sketched mode's codec on a mesh: one rank's part of the local
    steps, the encode and the decode (:func:`make_sketched`)."""

    def __init__(self, model: Model, mesh):
        from repro_torch.launch.mesh import axis_size, data_axes
        from repro_torch.launch.shardings import fsdp_axes

        self.model, self.mesh = model, mesh
        names = mesh.axis_names
        self.multi_pod = "pod" in names
        self.model_n = mesh.shape.get("model", 1)
        faxes = fsdp_axes(mesh, worker_dim=False,
                          multi_pod=self.multi_pod) or ()
        self.faxes = tuple(a for a in faxes if a in names)
        self.fsdp_n = axis_size(mesh, self.faxes) if self.faxes else 1
        self.jm = mesh.axis_index("model") if "model" in names else 0
        self.jf = mesh.axis_index(self.faxes) if self.faxes else 0
        self.j = self.jf * self.model_n + self.jm
        self.on = self.model_n > 1 or self.fsdp_n > 1
        #: the codec grid's axes, fsdp-major
        self.gaxes = tuple(a for a in self.faxes + ("model",)
                           if a in names and mesh.shape[a] > 1)
        #: the axes a worker's batch rows split over
        self.baxes = tuple(a for a in data_axes(self.multi_pod)
                           if a in names and mesh.shape[a] > 1)
        self.n_batch = axis_size(mesh, self.baxes) if self.baxes else 1
        self.state: dict = {}

    # -- layout -------------------------------------------------------------

    def init(self, Theta: PyTree, layout: dict) -> PyTree:
        """The rank's shard of the full ``Theta`` (a copy), with the
        codec's layout built from it into ``layout``."""
        from repro_torch.core.packing import (b_segment_perm, c_segment_perm,
                                              rep_segment_perm,
                                              shard_perm_local)
        from repro_torch.launch.shardings import shard_dims_2d

        dev = tree_leaves(Theta)[0].device
        if self.on:
            mdims, fdims = shard_dims_2d(Theta, self.model.cfg, self.mesh,
                                         multi_pod=self.multi_pod,
                                         worker_dim=False)
            sspec = build_shard_packspec(Theta, mdims, self.model_n,
                                         fsdp_dims=fdims,
                                         n_fsdp=self.fsdp_n)
        else:
            n = len(tree_leaves(Theta))
            sspec = build_shard_packspec(Theta, (None,) * n, 1)
        plan = None
        reduce = (tuple(a for a in self.baxes if a in self.faxes)
                  if self.on else ())
        if self.on:
            plan = _gather.make_plan(Theta, sspec.shard_dims,
                                     sspec.fsdp_dims, self.mesh, lead=0,
                                     fsdp_axis=self.faxes or "fsdp",
                                     reduce=reduce,
                                     part=partition_for(
                                         self.model.cfg, self.mesh,
                                         multi_pod=self.multi_pod))
        st = self.state
        st.update(sspec=sspec, plan=plan)
        if self.on:
            # the canonical indices are built on the host and moved: built
            # on the card, they moved a mesh rank's first sketched-round
            # loss in its last bits (ROADMAP queue C item 1); on ``meta``
            # (the dry run) they are shapes alone
            host = dev if dev.type == "meta" else torch.device("cpu")
            st["perm"] = shard_perm_local(sspec, self.j, host).to(dev)
            st["valid"] = shard_valid_mask(sspec, self.j, dev)
            segs = {}
            if sspec.b_leaves and sspec.n_fsdp > 1:
                segs["b_seg"] = (b_segment_perm(sspec, self.jm, host),
                                 sspec.b_size)
            if sspec.c_leaves and sspec.n_model > 1:
                segs["c_seg"] = (c_segment_perm(sspec, self.jf, host),
                                 sspec.c_size)
            if sspec.rep_leaves:
                segs["rep_seg"] = (rep_segment_perm(sspec, host),
                                   sspec.rep_size)
            st["segs"] = {k: (p.to(dev), torch.arange(p.shape[0],
                                                      device=dev) < n)
                          for k, (p, n) in segs.items()}
        # the batch axes each leaf's gradient still sums over after its
        # gathers' backward (which sums over the fsdp axes it rides)
        st["rest"] = [tuple(a for a in self.baxes
                            if not (a in reduce and fd is not None))
                      for fd in sspec.fsdp_dims]
        layout.update(sspec=sspec, faxes=self.faxes, j=self.j)
        return tree_map(torch.clone, shard_tree(sspec, Theta, self.j))

    # -- a worker -----------------------------------------------------------

    def local_steps(self, theta: PyTree, batch_w: dict, steps: int,
                    lr: float) -> Tuple[Tensor, dict]:
        """``steps`` sgd steps of one worker on this rank's shard ``theta``
        (in place) and its rows of the batch; the last step's loss and
        terms, as means over the worker's whole batch."""
        mesh = self.mesh
        plan = self.state["plan"]
        if plan is not None:
            plan = plan._replace(scatter=optflags.enabled("rs_grads"))
        run = tree_map(lambda l: l.detach().requires_grad_(), theta)
        leaves = tree_leaves(run)
        rest = self.state["rest"]
        loss = terms = None
        for _ in range(steps):
            with _gather.gathering(plan):
                loss, lm = self.model.loss(_gather.gather_params(run),
                                           batch_w)
                # the worker's mean over its batch: each rank's rows weigh
                # 1 / n_batch of it
                (loss / self.n_batch if self.n_batch > 1
                 else loss).backward()
            terms = _loss_terms(lm)
            del lm
            with torch.no_grad():
                for p, axes in zip(leaves, rest):
                    g = p.grad if not axes else mesh.psum(p.grad, axes)
                    p.sub_(g.to(p.dtype).mul_(lr))
                    p.grad = None
            loss = loss.detach()
        if self.n_batch > 1:
            loss = mesh.psum(loss.float(), self.baxes) / self.n_batch
            terms = {k: mesh.psum(v, self.baxes) / self.n_batch
                     for k, v in terms.items()}
        return loss, terms

    def encode(self, delta: PyTree, out: Tensor) -> None:
        """This rank's partial sketch of ``delta`` (its shard) into
        ``out``: its resident slice encoded a chunk at a time against the
        global codec (the whole packed delta off the grid)."""
        sspec = self.state["sspec"]
        if not self.on:
            encode_chunked(tree_leaves(delta), out.shape[-1], SKETCH_SEED,
                           out=out)
            return
        buf = pack_shard_local(sspec, delta, self.j)
        perm, valid = self.state["perm"], self.state["valid"]
        for a, b in chunks(sspec.d_local):
            encode_shard_local(buf[a:b], perm[a:b], valid[a:b],
                               out.shape[-1], SKETCH_SEED, out=out)

    def join(self, s_w: Tensor) -> Tensor:
        """The ranks' partial (W, d_s) sketches summed over the grid."""
        if not self.on:
            return s_w
        return self.mesh.psum(s_w, self.gaxes, inplace=True)

    # -- the consensus ------------------------------------------------------

    def apply_delta(self, Theta: PyTree, s: Tensor, lr: float,
                    want_sq: bool) -> Tuple[PyTree, Tensor]:
        """Θ + lr · decode(s) on this rank's shard, in the param dtype, and
        ‖decode(s)‖² over the whole model (one psum over the grid, a block
        several ranks hold counted once)."""
        sspec = self.state["sspec"]
        if not self.on:
            return _apply_packed(Theta, s, lr, want_sq)
        perm, valid = self.state["perm"], self.state["valid"]
        buf = torch.empty((sspec.d_local,), dtype=torch.float32,
                          device=s.device)
        for a, b in chunks(sspec.d_local):
            buf[a:b] = decode_shard_local(s, perm[a:b], valid[a:b],
                                          SKETCH_SEED)
        segs = {k: decode_shard_local(s, p, v, SKETCH_SEED)
                for k, (p, v) in self.state["segs"].items()}
        dgs = tree_leaves(unpack_shard_local(
            sspec, buf, segs.get("rep_seg"), b_seg=segs.get("b_seg"),
            c_seg=segs.get("c_seg")))
        leaves, treedef = tree_flatten(Theta)
        sq = torch.zeros((), dtype=torch.float32, device=s.device)
        new = []
        for i, (p, dg) in enumerate(zip(leaves, dgs)):
            if want_sq and ((sspec.shard_dims[i] is not None or self.jm == 0)
                            and (sspec.fsdp_dims[i] is not None
                                 or self.jf == 0)):
                f = dg.reshape(-1)
                sq += torch.dot(f, f)
            new.append(torch.add(p, dg.to(p.dtype, copy=True).mul_(lr)))
        if want_sq:
            sq = self.mesh.psum(sq, self.gaxes)
        return tree_unflatten(treedef, new), sq


def _apply_packed(Theta: PyTree, s: Tensor, lr: float,
                  want_sq: bool) -> Tuple[PyTree, Tensor]:
    """Θ + lr · decode(s) over the whole packed index space, a leaf and a
    chunk at a time in the param dtype; and ‖decode(s)‖² (f32)."""
    sq = torch.zeros((), dtype=torch.float32, device=s.device)
    new, off = [], 0
    leaves, treedef = tree_flatten(Theta)
    for p in leaves:
        out = torch.empty_like(p)
        src, dst = p.reshape(-1), out.view(-1)
        for a, b in chunks(src.shape[0]):
            dg = decode_packed(s, b - a, SKETCH_SEED, off + a)
            if want_sq:
                sq += torch.dot(dg, dg)
            torch.add(src[a:b], dg.to(p.dtype).mul_(lr), out=dst[a:b])
        new.append(out)
        off += src.shape[0]
    return tree_unflatten(treedef, new), sq


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
