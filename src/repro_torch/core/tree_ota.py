"""Pytree-level A-FADMM: the LLM trainer's OTA round over a parameter tree.
Counterpart of the single-device half of ``repro/core/tree_ota.py``.

The OTA math is elementwise, so the round *packs* θ's leaves into one
contiguous ``(W, D)`` f32 buffer (``core.packing``) and runs the flat
transport on it: one fused uplink (B6 then B3), one matched-filter noise
plane and one dual update (B4) per round, however many leaves the model
has.  The trainer keeps the duals λ and the fading h persistently packed as
``(W, D)`` Complex buffers; only θ is a tree (the local steps run the
model).  The per-leaf round survives as :func:`ota_tree_round_leafwise`:
one receive chain (B1, then B2, or B8 under a mask, then B4) and one noise
plane per leaf, the oracle the packed round is held against and the
``packed_uplink=False`` trainer's round.

The packed round also takes a scenario's participation mask and the
workers' CSI, a fault plan's uplink faults, the round health guard and a
cohort of a population (``core.cohort``).  Its random planes are
arguments: the matched-filter noise ``noise_re`` ((D,), or one plane per
leaf for the leafwise round), the guard's :class:`~repro_torch.faults
.guards.GuardDraws` and, on a redraw round, the fresh Rayleigh block, so a
test can replay the JAX package's draws.  Not ported yet: telemetry (ROADMAP
queue A item 4) and the shard-local round (item 6).
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch import rng
from repro_torch.core import cohort as _cohort
from repro_torch.core import transport
from repro_torch.core.admm import AdmmConfig
from repro_torch.core.channel import ChannelConfig, rayleigh
from repro_torch.core.cplx import Complex
from repro_torch.core.packing import (PackSpec, build_packspec, pack,
                                      pack_cplx, unpack, unpack_cplx)
from repro_torch.faults import guards as _guards
from repro_torch.faults import plan as _fplan
from repro_torch.tree import (tree_flatten, tree_leaves, tree_map,
                              tree_unflatten)

Tensor = torch.Tensor
PyTree = Any


class TreeChannel(NamedTuple):
    h: Any          # ONE packed Complex (W, D) buffer, f32, or a tree of
                    # Complex leaves (W, ...) (the leafwise state)
    age: int        # rounds since the block was drawn (a host int)


class TreeFLState(NamedTuple):
    theta: PyTree   # param tree, leaves (W, ...)
    lam: Any        # ONE packed Complex (W, D), f32, or a tree of Complex
    Theta: PyTree   # global model, leaves (...)
    chan: Any       # TreeChannel, or a scenario's (W, D) phy.PhyState
    opt: Any        # per-worker local optimizer state (leaves (W, ...))
    step: int
    #: ``repro_torch.faults.FaultState`` (liveness, the straggler snapshot
    #: in the packed layout) under a fault plan, else None
    flt: Any = None


def _zmap(fn: Callable, *trees: PyTree) -> PyTree:
    """tree map that treats :class:`Complex` as a leaf in every argument:
    the trees share theta's structure, so their flattened leaves zip
    positionally."""
    flats = [tree_flatten(t)[0] for t in trees]
    treedef = tree_flatten(trees[0])[1]
    return tree_unflatten(treedef, [fn(*args) for args in zip(*flats)])


def tree_penalty_grad(theta: PyTree, lam: PyTree, h: PyTree, Theta: PyTree,
                      rho: float, rows: Optional[Tensor] = None) -> PyTree:
    """Leafwise Re{λ*h} + ρ|h|²(θ − Θ), broadcasting Θ over the worker dim.
    With ``rows`` (a cohort's indices) λ and h are population-wide and each
    leaf's rows are gathered only while its term is formed."""
    if rows is None:
        return _zmap(lambda t, l, hh, T: transport.penalty_grad(
            t, l, hh, T, rho), theta, lam, h, Theta)
    take = _cohort.take_rows
    return _zmap(lambda t, l, hh, T: transport.penalty_grad(
        t, take(l, rows), take(hh, rows), T, rho), theta, lam, h, Theta)


def _rows(x: Tensor) -> Tensor:
    """A (W, ...) leaf as (W, n)."""
    return x.reshape(x.shape[0], -1)


# ---------------------------------------------------------------------------
# leafwise fading state
# ---------------------------------------------------------------------------

def draw_channel_tree(key: int, tree: PyTree) -> List[Complex]:
    """One Rayleigh block per leaf of ``tree`` (leaves (W, ...), Complex or
    real), in flatten order: leaf ``i`` from ``split(key, n_leaves)[i]``, as
    the JAX package keys its per-leaf draws, on the leaves' device."""
    leaves = tree_leaves(tree)
    keys = rng.split(key, len(leaves))
    out = []
    for k, leaf in zip(keys, leaves):
        t = leaf.re if isinstance(leaf, Complex) else leaf
        out.append(rayleigh(rng.generator(k, t.device), tuple(t.shape)))
    return out


def init_channel_tree(key: int, theta_w: PyTree) -> TreeChannel:
    """A Rayleigh block per leaf of the worker-led θ tree
    (:func:`draw_channel_tree`)."""
    treedef = tree_flatten(theta_w)[1]
    return TreeChannel(h=tree_unflatten(treedef,
                                        draw_channel_tree(key, theta_w)),
                       age=0)


def step_channel_tree(chan: TreeChannel, ccfg: ChannelConfig,
                      fresh: Optional[Sequence[Complex]]
                      ) -> Tuple[TreeChannel, bool]:
    """Coherence-boundary redraw of every leaf's block: every
    ``coherence_iters`` rounds the leaves become ``fresh`` (one block per
    leaf in flatten order, needed only then).  Returns (channel, redraw)."""
    redraw = redraws(chan, ccfg)
    if not redraw:
        return TreeChannel(h=chan.h, age=chan.age + 1), False
    if fresh is None:
        raise ValueError("step_channel_tree: this round redraws the channel "
                         "but no fresh blocks were given")
    treedef = tree_flatten(chan.h)[1]
    return TreeChannel(h=tree_unflatten(treedef, list(fresh)), age=0), True


def _modulate_tree(theta: PyTree, lam: PyTree, h: PyTree,
                   rho: float) -> PyTree:
    """s = h*·θ + λ*/ρ leaf by leaf (B1 per leaf), as (W, n) planes."""
    return _zmap(lambda t, l, hh: transport.modulate(
        _rows(t), Complex(_rows(l.re), _rows(l.im)),
        Complex(_rows(hh.re), _rows(hh.im)), rho), theta, lam, h)


def _tree_energy_per_worker(signals: PyTree) -> Tensor:
    """Σ over all leaves and elements of |s|² per worker -> (W,)."""
    return sum(transport.worker_energy(s) for s in tree_leaves(signals))


def _tree_size(tree: PyTree) -> int:
    """Elements a worker holds across the tree's leaves (the worker dim
    skipped)."""
    total = 0
    for leaf in tree_leaves(tree):
        t = leaf.re if isinstance(leaf, Complex) else leaf
        total += t[0].numel()
    return total


# ---------------------------------------------------------------------------
# persistently-packed fading state
# ---------------------------------------------------------------------------

def init_channel_packed(gen: torch.Generator, n_workers: int,
                        d: int) -> TreeChannel:
    """One Rayleigh fading block drawn over the packed ``(W, D)`` index
    space, on ``gen``'s device."""
    return TreeChannel(h=rayleigh(gen, (n_workers, d)), age=0)


def redraws(chan: TreeChannel, ccfg: ChannelConfig) -> bool:
    """Whether the next channel step draws a new block."""
    return chan.age + 1 >= ccfg.coherence_iters


def step_channel_packed(chan: TreeChannel, ccfg: ChannelConfig,
                        fresh: Optional[Complex]) -> Tuple[TreeChannel, bool]:
    """Coherence-boundary redraw of a packed fading buffer: every
    ``coherence_iters`` rounds h becomes ``fresh`` (a (W, D) Rayleigh block,
    needed only then).  Returns (channel, redraw)."""
    redraw = redraws(chan, ccfg)
    if redraw and fresh is None:
        raise ValueError("step_channel_packed: this round redraws the "
                         "channel but no fresh block was given")
    if redraw:
        return TreeChannel(h=fresh, age=0), True
    return TreeChannel(h=chan.h, age=chan.age + 1), False


# ---------------------------------------------------------------------------
# the packed round
# ---------------------------------------------------------------------------

def _keep_rows_(keep: Tensor, new: Complex, old: Complex) -> None:
    """``new`` ← where(keep[:, None], new, old), in place: at an LLM's
    (W, D) each out-of-place select would hold one more pair of planes."""
    k = keep[:, None]
    torch.where(k, new.re, old.re, out=new.re)
    torch.where(k, new.im, old.im, out=new.im)


def ota_tree_round_packed_state(theta: PyTree, lam_p: Complex, h_p: Complex,
                                noise_re: Tensor, acfg: AdmmConfig,
                                ccfg: ChannelConfig, spec: PackSpec, *,
                                mask: Optional[Tensor] = None,
                                h_tx_p: Optional[Complex] = None,
                                Theta_prev: Optional[PyTree] = None,
                                fused: Optional[bool] = None,
                                worker_chunk: Optional[int] = None,
                                guard: Optional[_guards.GuardConfig] = None,
                                guard_draws: Optional[_guards.GuardDraws]
                                = None,
                                faults=None, telemetry=None,
                                cohort_idx: Optional[Tensor] = None,
                                ) -> Tuple[PyTree, Complex, dict]:
    """One OTA round where the duals/fading are already packed ``(W, D)``.

    Only θ is packed here.  ``fused`` None/True runs the uplink as
    ``transport.ota_round_fused`` (B6 then B3, with power control per
    ``acfg``; ``worker_chunk`` streams the workers in cohorts), False as the
    composed ``transport.ota_uplink``; then the dual update (B4).  Returns
    ``(Theta_tree_f32, lam_new_packed, metrics)``: the global model stays
    f32 (the analog path).

    * ``mask`` ((W,) participation) drops workers from the superposition and
      the min-α and freezes their duals; ``h_tx_p`` is the workers' packed
      CSI; ``Theta_prev`` (a tree) is kept when nobody transmits.
    * ``faults = (plan, RoundFaults, stale)`` substitutes the uplinked
      planes (stragglers, corruption, bursts); θ and the duals stay the
      workers' own.  ``guard`` (a ``GuardConfig``, needing ``Theta_prev``)
      replaces the fused receive with ``faults.guards.guarded_ota_round``:
      a healthy guarded round is the unguarded fused round bit for bit, and
      it ignores ``worker_chunk`` as the JAX guard does.  A guarded or
      bursty round reads its retry and burst planes from ``guard_draws``.
      The refreshed stale buffer and the evicted rows ride in
      ``metrics["_fault_aux"]``.
    * ``cohort_idx`` ((W,) indices into an N-worker population): θ is
      cohort-wide, λ, h, the mask, h_tx and the fault rows population-wide;
      their rows are gathered here, the round runs at cohort width, and λ
      and the fault aux scatter back with the other duals frozen.
    """
    if telemetry not in (None, False):
        raise NotImplementedError(
            "ota_tree_round_packed_state: telemetry is not ported yet "
            "(ROADMAP queue A item 4)")
    theta_p = pack(spec, theta)                    # the one layout op per round
    idx = cohort_idx
    lam_pop = stale_pop = None
    n_population = lam_p.re.shape[0]
    take = _cohort.take_rows
    if idx is not None:
        lam_pop = lam_p
        lam_p, h_p = take(lam_p, idx), take(h_p, idx)
        h_tx_p, mask = take(h_tx_p, idx), take(mask, idx)
        if faults is not None:
            fplan, rf, stale = faults
            stale_pop = stale
            rf = rf._replace(alive=take(rf.alive, idx),
                             straggler=take(rf.straggler, idx),
                             corrupt=take(rf.corrupt, idx),
                             snapshot_due=take(rf.snapshot_due, idx))
            faults = (fplan, rf, take(stale, idx))
    aux = {}
    burst_std = None
    theta_tx_p = theta_p
    if faults is not None:
        fplan, rf, stale = faults
        theta_tx_p, stale_next = _fplan.apply_uplink(fplan, rf, theta_p,
                                                     stale)
        burst_std = rf.burst_std
        if stale_next is not None:
            aux["stale"] = stale_next
    faults = None
    rho = acfg.rho
    healthy = evicted = None
    guard_metrics = {}
    if guard is not None or burst_std is not None:
        if fused is False:
            raise ValueError("round guards and bursts need the fused path "
                             "(fused None or True)")
        if guard is not None and Theta_prev is None:
            raise ValueError("guard needs Theta_prev for the skip fallback")
        if guard_draws is None:
            raise ValueError("a guarded or bursty round needs guard_draws")
        with torch.profiler.record_function("guarded_ota_round"):
            gr = _guards.guarded_ota_round(
                theta_tx_p, lam_p, h_p, noise_re, rho, ccfg,
                guard if guard is not None else _guards.GuardConfig(),
                power_control=acfg.power_control, mask=mask, h_tx=h_tx_p,
                burst_std=burst_std, draws=guard_draws)
        Theta_p, inv_alpha = gr.Theta, gr.inv_alpha
        if guard is not None:   # burst-only: no policy, accept the round
            healthy, evicted = gr.healthy, gr.evicted
            guard_metrics = gr.metrics
            aux["evicted"] = evicted
        del gr
    elif fused is not False:
        Theta_p, inv_alpha, _ = transport.ota_round_fused(
            theta_tx_p, lam_p, h_p, noise_re, rho, ccfg,
            power_control=acfg.power_control, mask=mask, h_tx=h_tx_p,
            worker_chunk=int(worker_chunk or 0))
    else:
        Theta_p, inv_alpha = transport.ota_uplink(
            theta_tx_p, lam_p, h_p, noise_re, rho, ccfg,
            power_control=acfg.power_control, mask=mask, h_tx=h_tx_p)
    del theta_tx_p
    # the duals update from the workers' true planes: a straggler's or a
    # corrupter's bookkeeping stays healthy
    h_wkr = h_p if h_tx_p is None else h_tx_p
    lam_new_p = transport.dual_update(lam_p, h_wkr, theta_p, Theta_p, rho)
    del h_wkr, h_p, h_tx_p, theta_p
    metrics = {"inv_alpha": inv_alpha, **guard_metrics}
    take_new = mask
    if evicted is not None:
        take_new = ~evicted if take_new is None else take_new & ~evicted
    if healthy is not None:
        take_new = (healthy.expand(lam_new_p.re.shape[0]) if take_new is None
                    else take_new & healthy)
    if take_new is not None:
        _keep_rows_(take_new, lam_new_p, lam_p)
    if evicted is not None:
        lam_new_p.re.masked_fill_(evicted[:, None], 0.0)
        lam_new_p.im.masked_fill_(evicted[:, None], 0.0)
    del lam_p
    if mask is not None:
        metrics["participation"] = mask.to(torch.float32).mean()
    Theta_new = unpack(spec, Theta_p, cast=False)  # analog path stays f32
    keep = None
    if mask is not None or evicted is not None:
        active = mask
        if evicted is not None:
            active = ~evicted if active is None else active & ~evicted
        keep = active.any()
    if healthy is not None:
        keep = healthy if keep is None else keep & healthy
    if keep is not None and Theta_prev is not None:
        Theta_new = tree_map(lambda new, old: torch.where(
            keep, new, old.to(new.dtype)), Theta_new, Theta_prev)
    if idx is not None:
        # non-sampled duals keep their rows; the fault aux lands on the
        # sampled rows only
        lam_new_p = _cohort.put_rows(lam_pop, idx, lam_new_p)
        if "stale" in aux and stale_pop is not None:
            aux["stale"] = _cohort.put_rows(stale_pop, idx, aux["stale"])
        if "evicted" in aux:
            aux["evicted"] = _cohort.put_rows(
                torch.zeros(n_population, dtype=torch.bool,
                            device=evicted.device), idx, aux["evicted"])
    if aux:
        metrics["_fault_aux"] = aux
    return Theta_new, lam_new_p, metrics


# ---------------------------------------------------------------------------
# the tree-in/tree-out rounds
# ---------------------------------------------------------------------------

def _leaf_noise(spec: PackSpec, noise_re) -> List[Tensor]:
    """Per-leaf noise planes (leaf element shapes, flatten order): a list
    as given, or the pieces of one packed (D,) plane."""
    if not isinstance(noise_re, torch.Tensor):
        return list(noise_re)
    return [noise_re[o:o + n].reshape(s) for o, n, s in
            zip(spec.offsets, spec.sizes, spec.shapes)]


def ota_tree_round(theta: PyTree, lam: PyTree, h: PyTree, noise_re,
                   acfg: AdmmConfig, ccfg: ChannelConfig, *,
                   packed: Optional[bool] = None,
                   mask: Optional[Tensor] = None,
                   h_tx: Optional[PyTree] = None,
                   Theta_prev: Optional[PyTree] = None,
                   fused: Optional[bool] = None,
                   worker_chunk: Optional[int] = None,
                   telemetry=None) -> Tuple[PyTree, PyTree, dict]:
    """Uplink + global + dual for one round over trees of (W, ...) leaves:
    θ real, λ and h Complex.  ``packed`` None/True packs the trees and runs
    :func:`ota_tree_round_packed_state` (one uplink, one noise plane); False
    runs :func:`ota_tree_round_leafwise`.  ``noise_re`` is one packed (D,)
    plane or a list of per-leaf planes (flatten order); either serves
    either path, the pieces of the packed plane being the leaves'.
    Returns ``(Theta_new, lam_new, metrics)`` as trees."""
    spec = build_packspec(theta, batch_dims=1)
    if packed is False:
        return ota_tree_round_leafwise(theta, lam, h, _leaf_noise(
            spec, noise_re), acfg, ccfg, mask=mask, h_tx=h_tx,
            Theta_prev=Theta_prev)
    if not isinstance(noise_re, torch.Tensor):
        noise_re = torch.cat([z.reshape(-1) for z in noise_re])
    Theta_new, lam_new_p, metrics = ota_tree_round_packed_state(
        theta, pack_cplx(spec, lam), pack_cplx(spec, h), noise_re, acfg,
        ccfg, spec, mask=mask,
        h_tx_p=None if h_tx is None else pack_cplx(spec, h_tx),
        Theta_prev=Theta_prev, fused=fused, worker_chunk=worker_chunk,
        telemetry=telemetry)
    return Theta_new, unpack_cplx(spec, lam_new_p), metrics


def ota_tree_round_leafwise(theta: PyTree, lam: PyTree, h: PyTree,
                            noise_re: Sequence[Tensor], acfg: AdmmConfig,
                            ccfg: ChannelConfig, *,
                            mask: Optional[Tensor] = None,
                            h_tx: Optional[PyTree] = None,
                            Theta_prev: Optional[PyTree] = None,
                            ) -> Tuple[PyTree, PyTree, dict]:
    """The per-leaf round: B1 per leaf, the min-α over every leaf's energy,
    then per leaf one receive (B2, or B8 under ``mask``) on that leaf's own
    noise plane (``noise_re[i]`` of the leaf's element shape; JAX draws it
    from ``split(key, n_leaves)[i]``) and one dual update (B4).  ``mask``,
    ``h_tx`` and ``Theta_prev`` as in :func:`ota_tree_round_packed_state`.
    On a noise-free link it computes the packed round's Θ and λ; with power
    control α⁻¹ sums the energies in another order."""
    rho = acfg.rho
    h_wkr = h if h_tx is None else h_tx
    signals = _modulate_tree(theta, lam, h_wkr, rho)
    s_leaves, treedef = tree_flatten(signals)
    if acfg.power_control:
        budget = ccfg.transmit_power * _tree_size(signals)
        inv_alpha = transport.inv_alpha_from_energy(
            _tree_energy_per_worker(signals), budget, mask=mask)
    else:
        inv_alpha = torch.ones((), dtype=torch.float32,
                               device=s_leaves[0].re.device)
    del signals
    h_leaves = tree_leaves(h)
    noise = list(noise_re)
    if len(noise) != len(s_leaves):
        raise ValueError(f"ota_tree_round_leafwise: {len(noise)} noise "
                         f"planes for {len(s_leaves)} leaves")
    thetas = []
    for i in range(len(s_leaves)):
        hh = h_leaves[i]
        out = transport.receive(s_leaves[i], Complex(_rows(hh.re),
                                                     _rows(hh.im)),
                                noise[i].reshape(-1), inv_alpha, mask)
        s_leaves[i] = None
        thetas.append(out.reshape(hh.re.shape[1:]))
    Theta_new = tree_unflatten(treedef, thetas)

    def dual(l: Complex, hh: Complex, t: Tensor, T: Tensor) -> Complex:
        out = transport.dual_update(
            Complex(_rows(l.re), _rows(l.im)),
            Complex(_rows(hh.re), _rows(hh.im)), _rows(t), T.reshape(-1),
            rho)
        new = Complex(out.re.reshape(l.re.shape), out.im.reshape(l.im.shape))
        if mask is not None:
            _keep_rows_(mask, Complex(out.re, out.im),
                        Complex(_rows(l.re), _rows(l.im)))
        return new

    lam_new = _zmap(dual, lam, h_wkr, theta, Theta_new)
    metrics = {"inv_alpha": inv_alpha}
    if mask is not None:
        metrics["participation"] = mask.to(torch.float32).mean()
        if Theta_prev is not None:
            keep = mask.any()
            Theta_new = tree_map(lambda new, old: torch.where(
                keep, new, old.to(new.dtype)), Theta_new, Theta_prev)
    return Theta_new, lam_new, metrics
