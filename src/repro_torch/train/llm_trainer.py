"""Federated LLM training: A-FADMM as the aggregation layer, in the
``replicated`` mode.  Counterpart of ``repro/train/llm_trainer.py``.

Every FL worker owns a full (θ_n, λ_n) copy; per-worker tensors carry a
leading worker dim W.  The local prox steps run all workers at once: their
losses (one per worker, ``Model.loss`` on W-led parameters) are summed and
back-propagated, which gives each worker its own gradient.  One analog OTA
round (``core.tree_ota.ota_tree_round_packed_state``: the fused uplink B6 +
B3, then the dual update B4) produces the new global model.  Per the
paper's Appendix H the stochastic variant skips the flip rule.  λ and h
live persistently packed as ``(W, D)`` Complex buffers on one device.

A round's random planes (the redraw block and the matched-filter noise) are
a :class:`TreeRoundDraws`, drawn from the round key when not given, so a
test can replay the JAX package's.  Not ported yet, and refused by name:
the ``sketched`` mode, scenarios, faults and guards, telemetry, cohort
sampling, the leafwise (``packed_uplink=False``) state, meshes, a transport
backend override and the fused kernel's column tile.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch import rng
from repro_torch.core import cplx, transport
from repro_torch.core.admm import AdmmConfig
from repro_torch.core.channel import ChannelConfig, rayleigh
from repro_torch.core.cplx import Complex
from repro_torch.core.packing import build_packspec, unpack_cplx
from repro_torch.core.tree_ota import (TreeFLState, _zmap,
                                       init_channel_packed,
                                       ota_tree_round_packed_state, redraws,
                                       step_channel_packed, tree_penalty_grad)
from repro_torch.device import resolve_device
from repro_torch.models.registry import Model
from repro_torch.optim.optimizers import adam, sgd
from repro_torch.tree import tree_leaves, tree_map, tree_stack

Tensor = torch.Tensor
PyTree = Any


@dataclasses.dataclass(frozen=True)
class FLConfig:
    """The JAX package's ``FLConfig``, field for field (see its docs for
    each); the port runs ``mode="replicated"`` with the packed state."""

    mode: str = "replicated"        # replicated | sketched
    n_workers: int = 4
    local_steps: int = 1
    local_lr: float = 1e-3
    local_optimizer: str = "sgd"    # sgd | adam
    sketch_ratio: int = 256
    sketch_lr: float = 1.0
    transport_backend: Optional[str] = None
    packed_uplink: Optional[bool] = None
    scenario: Optional[str] = None
    doppler_hz: Optional[float] = None
    csi_err: Optional[float] = None
    h_min: Optional[float] = None
    slots_per_round: Optional[int] = None
    #: one-pass fused receive: None/True the fused round, False the
    #: composed per-primitive chain
    ota_fused: Optional[bool] = None
    #: worker-cohort streaming of the fused round: 0/None all W at once
    ota_worker_chunk: Optional[int] = None
    ota_block_cols: Optional[int] = None
    faults: Optional[Any] = None
    guard: Optional[Any] = None
    telemetry: Optional[Any] = None
    population: Optional[int] = None
    cohort: Optional[int] = None
    cohort_policy: str = "uniform"


class TreeRoundDraws(NamedTuple):
    """Every random plane one round reads.

    h_fresh: the new (W, D) Rayleigh block, only on rounds that redraw the
      channel (``tree_ota.redraws``), else None.
    noise_re: (D,) real plane of the uplink matched-filter noise (zeros on
      a noise-free link).
    """

    h_fresh: Optional[Complex]
    noise_re: Tensor


def draw_round(key: int, state: TreeFLState, ccfg: ChannelConfig
               ) -> TreeRoundDraws:
    """The round's planes from its key, split as JAX splits it: ``kc`` the
    redraw block (drawn only on a redraw round), ``kn`` the noise."""
    kc, kn = rng.split(key)
    W, d = state.lam.re.shape
    dev = state.lam.re.device
    h_fresh = (rayleigh(rng.generator(kc, dev), (W, d))
               if redraws(state.chan, ccfg) else None)
    return TreeRoundDraws(h_fresh, transport.matched_filter_noise_re(
        rng.generator(kn, dev), (d,), ccfg))


def _local_opt(flcfg: FLConfig):
    if flcfg.local_optimizer == "adam":
        return adam(flcfg.local_lr)
    return sgd(flcfg.local_lr)


def _refuse_unported(flcfg: FLConfig, mesh) -> None:
    """NotImplementedError for every FLConfig feature the port lacks, named
    with its ROADMAP item, so none is silently ignored."""
    checks = (
        ("scenario", flcfg.scenario is not None, "4 (scenarios on the LLM "
         "trainer)"),
        ("faults", flcfg.faults is not None, "4 (faults/guard on the LLM "
         "trainer)"),
        ("guard", flcfg.guard is not None, "4 (faults/guard on the LLM "
         "trainer)"),
        ("telemetry", flcfg.telemetry not in (None, False), "4 (obs/)"),
        ("population/cohort", flcfg.population is not None,
         "4 (core/cohort.py)"),
        ("packed_uplink=False", flcfg.packed_uplink is False,
         "3 (the leafwise ota_tree_round oracle)"),
        ("mesh", mesh is not None, "6 (multi-device)"),
        ("ota_block_cols", flcfg.ota_block_cols is not None,
         "4 (the fused kernel picks its own tiling)"),
    )
    for name, bad, item in checks:
        if bad:
            raise NotImplementedError(
                f"FLConfig {name} is not ported yet (ROADMAP queue A item "
                f"{item})")
    transport.check_backend_choice(flcfg.transport_backend)


# ---------------------------------------------------------------------------
# replicated mode
# ---------------------------------------------------------------------------

def make_replicated(model: Model, flcfg: FLConfig, acfg: AdmmConfig,
                    ccfg: ChannelConfig, mesh=None, device="cuda"):
    """``(init_fn, train_step)`` of the replicated mode on one device, with
    one globally packed (W, D) buffer each for λ and h."""
    _refuse_unported(flcfg, mesh)
    W = flcfg.n_workers
    opt = _local_opt(flcfg)
    dev = resolve_device(device)

    def init_fn(key: int) -> TreeFLState:
        """Per-worker random init (worker w from ``fold_in(kp, w)``), Θ the
        workers' mean in the param dtype, λ = 0, one Rayleigh block."""
        kp, kc = rng.split(key)
        theta = tree_stack([model.init(rng.fold_in(kp, w), device=dev)
                            for w in range(W)])           # leaves (W, ...)
        Theta = tree_map(lambda l: l.float().mean(0).to(l.dtype), theta)
        d = build_packspec(theta, batch_dims=1).d
        return TreeFLState(theta=theta, lam=cplx.czero((W, d), device=dev),
                           Theta=Theta,
                           chan=init_channel_packed(rng.generator(kc, dev),
                                                    W, d),
                           opt=opt.init(theta), step=0)

    def local_step(theta: PyTree, opt_state, batch, lam_tree, h_tree,
                   Theta: PyTree):
        """One prox step of every worker: (θ', opt', mean loss)."""
        leaves = tree_map(lambda l: l.detach().requires_grad_(), theta)
        losses, _ = model.loss(leaves, batch)            # (W,)
        losses.sum().backward()
        with torch.no_grad():
            grads = tree_map(lambda l: l.grad, leaves)
            pen = tree_penalty_grad(theta, lam_tree, h_tree, Theta, acfg.rho)
            g = tree_map(lambda a, b: a + b.to(a.dtype), grads, pen)
            del grads, pen, leaves
            theta, opt_state = opt.update(g, opt_state, theta)
        return theta, opt_state, losses.detach().mean()

    def train_step(state: TreeFLState, batch: dict, key: Optional[int] = None,
                   draws: Optional[TreeRoundDraws] = None
                   ) -> Tuple[TreeFLState, dict]:
        """One round.  batch leaves: (W, B_local, ...), worker-major; the
        round's planes are ``draws``, else drawn from ``key``."""
        if draws is None:
            if key is None:
                raise ValueError("train_step needs a round key or the "
                                 "round's draws")
            draws = draw_round(key, state, ccfg)
        spec = build_packspec(state.theta, batch_dims=1)
        chan, _ = step_channel_packed(state.chan, ccfg, draws.h_fresh)
        # slice-views of the packed buffers for the leafwise penalty —
        # constant across the local steps
        lam_tree = unpack_cplx(spec, state.lam)
        h_tree = unpack_cplx(spec, chan.h)
        theta, opt_state = state.theta, state.opt
        loss = None
        for _ in range(flcfg.local_steps):
            theta, opt_state, loss = local_step(theta, opt_state, batch,
                                                lam_tree, h_tree, state.Theta)
        del lam_tree, h_tree
        with torch.no_grad():
            Theta_f32, lam_new, m = ota_tree_round_packed_state(
                theta, state.lam, chan.h, draws.noise_re, acfg, ccfg, spec,
                fused=flcfg.ota_fused, worker_chunk=flcfg.ota_worker_chunk)
            Theta_new = _zmap(lambda T, t: T.to(t.dtype), Theta_f32,
                              state.Theta)
            del Theta_f32
            metrics = {"loss": loss, "theta_drift": _tree_rms_gap(theta,
                                                                  Theta_new),
                       **m}
        new_state = TreeFLState(theta=theta, lam=lam_new, Theta=Theta_new,
                                chan=chan, opt=opt_state, step=state.step + 1)
        return new_state, metrics

    return init_fn, train_step


def _tree_rms_gap(theta_w: PyTree, Theta: PyTree) -> Tensor:
    """RMS over every element of θ_w − Θ (Θ broadcast over workers)."""
    num = None
    den = 0
    for t, T in zip(tree_leaves(theta_w), tree_leaves(Theta)):
        d = t.float() - T[None].float()
        s = torch.sum(d * d)
        num = s if num is None else num + s
        den += d.numel()
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
