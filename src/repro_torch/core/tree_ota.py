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
test can replay the JAX package's draws.  With ``telemetry`` the packed
round adds the ``obs/`` keys of ``repro_torch.obs`` to its metrics.

Under a model-parallel mesh (``launch.mesh``) the round is
:func:`ota_tree_round_shard_local`: SPMD code every rank runs on the leaf
shards it holds, in the shard-local packed layout
(``core.packing.ShardPackSpec``), with the mesh's collectives where the
JAX package's ``shard_map`` body has them.
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch import obs as _obs
from repro_torch import rng
from repro_torch.core import cohort as _cohort
from repro_torch.core import transport
from repro_torch.core.admm import AdmmConfig
from repro_torch.core.channel import ChannelConfig, rayleigh, rayleigh_rows
from repro_torch.core.cplx import Complex
from repro_torch.core.packing import (PackSpec, ShardPackSpec,
                                      build_packspec, pack, pack_cplx,
                                      pack_shard_local, scatter_b_chunk,
                                      scatter_c_chunk, scatter_rep_chunk,
                                      shard_b_chunk, shard_c_chunk,
                                      shard_rep_chunk, shard_valid_mask,
                                      unpack, unpack_cplx,
                                      unpack_shard_local)
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

def init_channel_packed(key: int, rows: Sequence[int], d: int,
                        device) -> TreeChannel:
    """The first fading block over the packed ``(W, D)`` index space: the
    ``rows`` of ``channel.rayleigh_rows``."""
    return TreeChannel(h=rayleigh_rows(key, rows, d, device), age=0)


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
                                block_cols: Optional[int] = None,
                                guard: Optional[_guards.GuardConfig] = None,
                                guard_draws: Optional[_guards.GuardDraws]
                                = None,
                                faults=None, telemetry=None,
                                cohort_idx: Optional[Tensor] = None,
                                ) -> Tuple[PyTree, Complex, dict]:
    """One OTA round where the duals/fading are already packed ``(W, D)``.

    Only θ is packed here.  ``fused`` None/True runs the uplink as
    ``transport.ota_round_fused`` (B6 then B3, with power control per
    ``acfg``; ``worker_chunk`` streams the workers in cohorts and
    ``block_cols`` picks B6's plan, each None for its environment knob), False
    as the composed ``transport.ota_uplink``; then the dual update (B4).  Returns
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
    * ``telemetry`` (True or a ``repro_torch.obs.TelemetryConfig``) adds the
      ``obs/`` keys: the fused or guarded receive's (the composed path has
      none), ``obs/theta_update_norm`` where ``Theta_prev`` is given, and a
      cohort's ``obs/cohort_*``.  The round's Θ and λ are unchanged.
    """
    tel = _obs.resolve(telemetry)
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
                burst_std=burst_std, draws=guard_draws,
                block_cols=block_cols, telemetry=tel)
        Theta_p, inv_alpha = gr.Theta, gr.inv_alpha
        if guard is not None:   # burst-only: no policy, accept the round
            healthy, evicted = gr.healthy, gr.evicted
            guard_metrics = gr.metrics
            aux["evicted"] = evicted
        else:
            # no guard verdicts, but the accepted slot's telemetry applies
            guard_metrics = {k: v for k, v in gr.metrics.items()
                             if k.startswith("obs/")}
        del gr
    elif fused is not False:
        out = transport.ota_round_fused(
            theta_tx_p, lam_p, h_p, noise_re, rho, ccfg,
            power_control=acfg.power_control, mask=mask, h_tx=h_tx_p,
            worker_chunk=worker_chunk, block_cols=block_cols, telemetry=tel)
        Theta_p, inv_alpha = out[0], out[1]
        if tel is not None:
            guard_metrics = out[3]
        del out
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
    metrics = _obs.merge_disjoint({"inv_alpha": inv_alpha}, guard_metrics,
                                  who="ota_tree_round_packed_state")
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
    if tel is not None and Theta_prev is not None:
        # the l2 norm of the committed consensus update (after keep/skip)
        metrics["obs/theta_update_norm"] = tree_update_norm(Theta_new,
                                                            Theta_prev)
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
        if tel is not None:
            metrics = _obs.merge_disjoint(
                metrics, _cohort.cohort_metrics(_cohort.CohortConfig(
                    n_population, int(idx.shape[0]))),
                who="ota_tree_round_packed_state.cohort")
    if aux:
        metrics["_fault_aux"] = aux
    return Theta_new, lam_new_p, metrics


def tree_update_norm(new: PyTree, old: PyTree) -> Tensor:
    """‖new − old‖₂ over every leaf of two like trees, in f32, a leaf at a
    time: one f32 leaf-sized temporary (the difference, formed in place in
    a copy of ``new``; a bf16 ``old`` widens exactly inside the
    subtraction)."""
    sq = None
    for n, o in zip(tree_leaves(new), tree_leaves(old)):
        d = n.to(torch.float32, copy=True).sub_(o).reshape(-1)
        s = torch.dot(d, d)
        del d
        sq = s if sq is None else sq + s
    return torch.sqrt(sq)


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
                            mesh=None, sspec: Optional[ShardPackSpec] = None,
                            ) -> Tuple[PyTree, PyTree, dict]:
    """The per-leaf round: B1 per leaf, the min-α over every leaf's energy,
    then per leaf one receive (B2, or B8 under ``mask``) on that leaf's own
    noise plane (``noise_re[i]`` of the leaf's element shape; JAX draws it
    from ``split(key, n_leaves)[i]``) and one dual update (B4).  ``mask``,
    ``h_tx`` and ``Theta_prev`` as in :func:`ota_tree_round_packed_state`.
    On a noise-free link it computes the packed round's Θ and λ; with power
    control α⁻¹ sums the energies in another order.

    Under ``mesh`` (with the layout ``sspec`` names: each leaf's model and
    fsdp dims) a rank holds its workers' rows of its (fsdp, model) block of
    every leaf, and ``noise_re[i]`` is that block's noise.  The energies
    sum over the grid (a block several ranks hold counts once), the min-α
    takes the min over the data axes and each leaf's superposition sums
    over them, as in :func:`ota_tree_round_shard_local`; ``mask`` stays the
    global (W,) vector."""
    rho = acfg.rho
    c = None if mesh is None else shard_coords(mesh, sspec)
    mask_l = mask
    if c is not None and mask is not None:
        W_l = tree_leaves(theta)[0].shape[0]
        mask_l = mask[c.jd * W_l:(c.jd + 1) * W_l]
    h_wkr = h if h_tx is None else h_tx
    signals = _modulate_tree(theta, lam, h_wkr, rho)
    s_leaves, treedef = tree_flatten(signals)
    dev = s_leaves[0].re.device
    if acfg.power_control:
        mrf = None
        if c is None:
            budget = ccfg.transmit_power * _tree_size(signals)
            energy = _tree_energy_per_worker(signals)
        else:
            budget = ccfg.transmit_power * sspec.spec.d
            energy = torch.zeros(s_leaves[0].re.shape[0],
                                 dtype=torch.float32, device=dev)
            for i, sl in enumerate(s_leaves):
                if _counts_block(sspec, i, c):
                    energy = energy + transport.worker_energy(sl)
            energy = mesh.psum(energy, c.saxes)
            if c.n_data > 1:
                mrf = lambda a: mesh.pmin(a, c.daxes)  # noqa: E731
        inv_alpha = transport.inv_alpha_from_energy(energy, budget,
                                                    mask=mask_l,
                                                    min_reduce_fn=mrf)
    else:
        inv_alpha = torch.ones((), dtype=torch.float32, device=dev)
    del signals
    reduce_fn = None
    if c is not None and c.n_data > 1:
        reduce_fn = lambda x: mesh.psum(x.sum(0), c.daxes)  # noqa: E731
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
                                noise[i].reshape(-1), inv_alpha, mask_l,
                                reduce_fn=reduce_fn)
        s_leaves[i] = None
        thetas.append(out.reshape(hh.re.shape[1:]))
    Theta_new = tree_unflatten(treedef, thetas)

    def dual(l: Complex, hh: Complex, t: Tensor, T: Tensor) -> Complex:
        out = transport.dual_update(
            Complex(_rows(l.re), _rows(l.im)),
            Complex(_rows(hh.re), _rows(hh.im)), _rows(t), T.reshape(-1),
            rho)
        new = Complex(out.re.reshape(l.re.shape), out.im.reshape(l.im.shape))
        if mask_l is not None:
            _keep_rows_(mask_l, Complex(out.re, out.im),
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


# ---------------------------------------------------------------------------
# the shard-local round (model-parallel meshes), SPMD over the ranks
# ---------------------------------------------------------------------------
#
# Each rank holds its workers' rows (its coordinate on the data axes) and
# its (fsdp, model) shard of every leaf; λ and h live in the global
# shard-packed (W, d_pad) layout, of which the rank holds the (W_local,
# d_local) block of its rows and its shard's columns.  No signal plane ever
# crosses the shard grid: the worker superposition is an all-reduce over
# the data axes, the power consensus an all-reduce of the per-worker
# energies over the grid and a min over the data axes, and only the small
# B/C/replicated segments are summed across the grid to be unpacked.

def _mesh_data_axes(mesh, model_axis: str,
                    fsdp_axis: str = "fsdp") -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names
                 if a not in (model_axis, fsdp_axis))


def _shard_grid_axes(mesh, model_axis: str,
                     fsdp_axis: str = "fsdp") -> Tuple[str, ...]:
    """Mesh axes of the (fsdp, model) shard grid, fsdp-major: the axes the
    packed ``d_pad`` dimension shards over (flat shard
    ``j = jf * n_model + jm``)."""
    return tuple(a for a in (fsdp_axis, model_axis) if a in mesh.axis_names)


class ShardCoords(NamedTuple):
    """A rank's place on the mesh for a shard-local layout."""

    daxes: Tuple[str, ...]      # the data axes (the worker dim's)
    saxes: Tuple[str, ...]      # the shard grid's axes, fsdp-major
    jd: int                     # flat index on the data axes
    n_data: int
    jm: int                     # model shard
    jf: int                     # fsdp shard
    j: int                      # flat shard, jf * n_model + jm


def shard_coords(mesh, sspec: Optional[ShardPackSpec] = None,
                 model_axis: str = "model",
                 fsdp_axis: str = "fsdp") -> ShardCoords:
    """This rank's :class:`ShardCoords`; with ``sspec``, a check that the
    spec's grid is the mesh's."""
    daxes = _mesh_data_axes(mesh, model_axis, fsdp_axis)
    saxes = _shard_grid_axes(mesh, model_axis, fsdp_axis)
    n_model = mesh.shape.get(model_axis, 1)
    n_fsdp = mesh.shape.get(fsdp_axis, 1)
    if sspec is not None and (sspec.n_model, sspec.n_fsdp) != (n_model,
                                                                 n_fsdp):
        raise ValueError(f"spec has a ({sspec.n_fsdp}, {sspec.n_model}) "
                         f"(fsdp, model) grid but mesh "
                         f"{dict(mesh.shape)} has ({n_fsdp}, {n_model})")
    jm = mesh.axis_index(model_axis) if model_axis in mesh.shape else 0
    jf = mesh.axis_index(fsdp_axis) if fsdp_axis in mesh.shape else 0
    return ShardCoords(daxes=daxes, saxes=saxes,
                       jd=mesh.axis_index(daxes) if daxes else 0,
                       n_data=mesh.axis_size(daxes) if daxes else 1,
                       jm=jm, jf=jf, j=jf * n_model + jm)


def _segs_psum(sspec: ShardPackSpec, plane: Tensor, jm: int, jf: int, mesh,
               model_axis: str = "model", fsdp_axis: str = "fsdp"):
    """Rebuild the full B/C/D segments from the per-shard chunks: one small
    all-reduce each over exactly the axes the segment is split across (B
    over fsdp, C over model, D over both).  A segment that is not split is
    the shard's own chunk, a view.  Returns ``(b_seg, c_seg, rep_seg)``
    (None where the class is empty)."""
    b_seg = c_seg = rep_seg = None
    if sspec.b_leaves:
        b_seg = shard_b_chunk(sspec, plane)
        if sspec.n_fsdp > 1:
            b_seg = mesh.psum(scatter_b_chunk(sspec, b_seg, jf), fsdp_axis)
    if sspec.c_leaves:
        c_seg = shard_c_chunk(sspec, plane)
        if sspec.n_model > 1:
            c_seg = mesh.psum(scatter_c_chunk(sspec, c_seg, jm), model_axis)
    if sspec.rep_leaves:
        rep_seg = shard_rep_chunk(sspec, plane)
        axes = tuple(a for a, n in ((fsdp_axis, sspec.n_fsdp),
                                    (model_axis, sspec.n_model)) if n > 1)
        if axes:
            j = jf * sspec.n_model + jm
            rep_seg = mesh.psum(scatter_rep_chunk(sspec, rep_seg, j), axes)
    return b_seg, c_seg, rep_seg


def unpack_cplx_shard_local(sspec: ShardPackSpec, buf: Complex, mesh,
                            model_axis: str = "model",
                            fsdp_axis: str = "fsdp") -> PyTree:
    """This rank's block of the global shard-packed ``(W, d_pad)`` Complex
    planes -> its tree of Complex ``(W_local, ...)`` leaf shards.  Sharded
    leaves are views of the block; only the B/C/replicated segments cross
    the grid (one all-reduce each).  The trainer reads λ and h for the
    penalty gradient through it."""
    c = shard_coords(mesh, sspec, model_axis, fsdp_axis)

    def one(plane):
        b_seg, c_seg, rep_seg = _segs_psum(sspec, plane, c.jm, c.jf, mesh,
                                           model_axis, fsdp_axis)
        return tree_leaves(unpack_shard_local(sspec, plane, rep_seg,
                                              b_seg=b_seg, c_seg=c_seg))

    return tree_unflatten(sspec.spec.treedef, [
        Complex(r, i) for r, i in zip(one(buf.re), one(buf.im))])


def _counts_block(sspec: ShardPackSpec, i: int, c: ShardCoords) -> bool:
    """Whether this rank's block of leaf ``i`` is the one the grid counts:
    a leaf the grid does not split on an axis counts on that axis's
    coordinate 0 only."""
    return ((sspec.shard_dims[i] is not None or c.jm == 0)
            and (sspec.fsdp_dims[i] is not None or c.jf == 0))


def shard_replication(sspec: ShardPackSpec, i: int) -> int:
    """How many shards of the grid hold leaf ``i``'s same block."""
    n = sspec.n_shards
    if sspec.shard_dims[i] is not None:
        n //= sspec.n_model
    if sspec.fsdp_dims[i] is not None:
        n //= sspec.n_fsdp
    return n


def _global_rows(mesh, x: Tensor, daxes) -> Tensor:
    """A (W_local,) vector of each data rank -> the global (W,) one."""
    if not daxes:
        return x
    return mesh.all_gather(x, daxes, 0)


def ota_tree_round_shard_local(theta: PyTree, lam_p: Complex, h_p: Complex,
                               noise_re: Tensor, acfg: AdmmConfig,
                               ccfg: ChannelConfig, sspec: ShardPackSpec,
                               mesh, *, mask: Optional[Tensor] = None,
                               h_tx_p: Optional[Complex] = None,
                               Theta_prev: Optional[PyTree] = None,
                               model_axis: str = "model",
                               fsdp_axis: str = "fsdp",
                               fused: Optional[bool] = None,
                               block_cols: Optional[int] = None,
                               guard: Optional[_guards.GuardConfig] = None,
                               guard_draws: Optional[_guards.GuardDraws]
                               = None,
                               faults=None, telemetry=None,
                               ) -> Tuple[PyTree, Complex, dict]:
    """One OTA round with SHARD-LOCAL packing under a mesh, run by every
    rank (the JAX package's ``shard_map`` body, with this rank's ``(jm,
    jf)``).

    Per rank: θ the tree of its ``(W_local, ...)`` leaf shards; ``lam_p``,
    ``h_p`` (and ``h_tx_p``) its ``(W_local, d_local)`` block of the global
    shard-packed planes; ``noise_re`` its shard's (d_local,) matched-filter
    noise (JAX draws it from ``fold_in(key, j)``); ``Theta_prev`` its shard
    of Θ.  ``mask`` and the fault rows are global (W,) vectors, as every
    rank holds them; ``guard_draws`` holds the shard's burst and retry
    planes (``faults.guards.draw`` on the shard's noise key).  Each rank:

    1. packs its resident θ shards (no collective);
    2. runs one pass over its worker planes (``fused`` None/True: B6), or
       the composed chain (False: B1, then the receive);
    3. joins the min-α consensus: energies summed over the grid, the min
       over the data axes;
    4. superposes over the data axes (an all-reduce; with one rank on the
       data axes the worker sum is local), demodulates its ``d_local``
       slice of Θ (B3) and updates its λ block (B4).

    Each shard runs exactly one receive a round.  The guard evicts
    proactively (non-finite rows, OR-ed over the grid, leave the mask
    before the receive) and unrolls its retransmissions as ``where``
    selects, with the JAX package's noise keys and power backoff.  Noise-
    free, Θ and λ are the leafwise round's, bit for bit on a one-rank data
    axis.  Returns ``(Theta_tree_f32, lam_new_block, metrics)``: Θ the
    rank's shard, metrics global values, the stale buffer (this rank's
    block) and the evicted rows (global) in ``metrics["_fault_aux"]``.
    """
    rho = acfg.rho
    c = shard_coords(mesh, sspec, model_axis, fsdp_axis)
    daxes, saxes = c.daxes, c.saxes
    local_w = c.n_data == 1
    use_fused = fused is not False
    tel = _obs.resolve(telemetry)
    has_guard = guard is not None
    has_faults = faults is not None
    want_energy_out = (tel is not None and use_fused and tel.per_worker
                       and acfg.power_control)
    if (has_guard or has_faults) and not use_fused:
        raise ValueError("round guards/faults require the fused shard-local "
                         "path (fused=True)")
    if has_guard and Theta_prev is None:
        raise ValueError("guard needs Theta_prev for the skip fallback")
    W_l = lam_p.re.shape[0]
    rows = slice(c.jd * W_l, (c.jd + 1) * W_l)
    dev = lam_p.re.device

    def local(v):
        return None if v is None else v[rows]

    mask_l = local(mask)
    theta_p = pack_shard_local(sspec, theta, c.j)       # (W_l, d_local)
    budget = ccfg.transmit_power * sspec.spec.d         # real elements
    theta_tx = theta_p
    stale_next = None
    burst_std = None
    if has_faults:
        fplan, rf, stale = faults
        rf_l = _fplan.RoundFaults(
            alive=None, straggler=local(rf.straggler),
            corrupt=local(rf.corrupt), snapshot_due=rf.snapshot_due,
            burst_std=rf.burst_std)
        theta_tx, stale_next = _fplan.apply_uplink(fplan, rf_l, theta_p,
                                                   stale)
        burst_std = rf.burst_std
    if burst_std is not None and (guard_draws is None
                                  or guard_draws.burst is None):
        raise ValueError("a bursty round needs guard_draws.burst")
    evicted_l = None
    if has_guard and guard.evicts:
        planes = [theta_tx, lam_p.re, lam_p.im, h_p.re, h_p.im]
        if h_tx_p is not None:
            planes += [h_tx_p.re, h_tx_p.im]
        # a worker's row spans every shard: OR the local verdicts
        bad = mesh.por(_guards._rows_nonfinite(*planes), saxes)
        base = (torch.ones(W_l, dtype=torch.bool, device=dev)
                if mask_l is None else mask_l)
        evicted_l = bad & base
        mask_l = base & ~evicted_l
    mrf = None if local_w else (lambda a: mesh.pmin(a, daxes))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    healthy = retries = None
    sig_g = npw_g = zero
    h_wkr = h_p if h_tx_p is None else h_tx_p
    if use_fused:
        y_l, p2_l, energy_l, _ = transport.ota_round_stats(
            theta_tx, lam_p, h_p, rho, mask=mask_l, h_tx=h_tx_p,
            block_cols=block_cols)
        energy = mesh.psum(energy_l, saxes) if acfg.power_control else None
        if not local_w:
            # the superposition: B6's own planes, summed in place
            y_l = mesh.psum(y_l, daxes, inplace=True)
            p2_l = mesh.psum(p2_l, daxes, inplace=True)

        def gsum(v):
            return mesh.psum(v, saxes)

        def power(energy_budget) -> Tensor:
            if not acfg.power_control:
                return torch.ones((), dtype=torch.float32, device=dev)
            return transport.inv_alpha_from_energy(
                energy, energy_budget, mask=mask_l, min_reduce_fn=mrf)

        if has_guard:
            from repro_torch.core import power as _power

            thr = (None if guard.snr_floor_db is None
                   else 10.0 ** (guard.snr_floor_db / 10.0))

            def epi(noise, attempt, with_burst):
                ia = power(_power.retry_power_budget(budget, attempt,
                                                     guard.power_backoff))
                n = noise
                if with_burst:
                    n = n + burst_std * guard_draws.burst
                n_eff = n * ia
                Th = transport.demodulate(y_l, p2_l, n_eff, 1.0)
                ok = gsum((~torch.isfinite(Th)).to(torch.float32).sum()) \
                    == 0.0
                sig = npw = zero
                if thr is not None or tel is not None:
                    sig = gsum(torch.sum(y_l * y_l))
                    npw = gsum(torch.sum(n_eff * n_eff))
                if thr is not None:
                    ok = ok & (sig >= thr * npw)
                return Th, ia, ok, sig, npw

            Theta_p, inv_alpha, ok, sig_g, npw_g = epi(
                noise_re, 0, burst_std is not None)
            retries = torch.zeros((), dtype=torch.int32, device=dev)
            # unrolled retries: every rank runs each attempt's collectives,
            # and the first healthy attempt (or the last) is kept
            for a in range(1, guard.retries + 1):
                Th_a, ia_a, ok_a, sig_a, npw_a = epi(
                    guard_draws.retry_noise[a - 1], a, False)
                take = ~ok
                Theta_p = torch.where(take, Th_a, Theta_p)
                inv_alpha = torch.where(take, ia_a, inv_alpha)
                sig_g = torch.where(take, sig_a, sig_g)
                npw_g = torch.where(take, npw_a, npw_g)
                retries = retries + take.to(torch.int32)
                ok = torch.where(take, ok_a, ok)
            healthy = ok
        else:
            inv_alpha = power(budget)
            noise = noise_re
            if burst_std is not None:
                noise = noise + burst_std * guard_draws.burst
            Theta_p = transport.demodulate(y_l, p2_l, noise, inv_alpha)
            if tel is not None:
                # y_l is whole over the data axes here, so the power sums
                # reduce over the grid only: the guard's exact gsum
                n_eff = noise * inv_alpha
                sig_g = gsum(torch.sum(y_l * y_l))
                npw_g = gsum(torch.sum(n_eff * n_eff))
        e_tx = None
        if want_energy_out:
            alpha = transport.applied_alpha(inv_alpha)
            e_tx = energy * (alpha * alpha)
            if mask_l is not None:
                e_tx = torch.where(mask_l, e_tx, torch.zeros_like(e_tx))
        del y_l, p2_l
    else:
        signals = transport.modulate(theta_p, lam_p, h_wkr, rho)
        if acfg.power_control:
            # per-worker TOTAL energy: every element is owned by one shard
            energy = mesh.psum(transport.worker_energy(signals), saxes)
            inv_alpha = transport.inv_alpha_from_energy(
                energy, budget, mask=mask_l, min_reduce_fn=mrf)
        else:
            inv_alpha = torch.ones((), dtype=torch.float32, device=dev)
        Theta_p = transport.receive(
            signals, h_p, noise_re, inv_alpha, mask_l,
            reduce_fn=None if local_w
            else (lambda x: mesh.psum(x.sum(0), daxes)))
        del signals
    # duals update from the worker's TRUE planes (theta_p, not the faulted
    # theta_tx); the mask already excludes evicted offenders
    lam_new = transport.dual_update(lam_p, h_wkr, theta_p, Theta_p, rho)
    del theta_p, theta_tx
    if mask_l is not None:
        _keep_rows_(mask_l, lam_new, lam_p)
    if healthy is not None:
        lam_new = Complex(torch.where(healthy, lam_new.re, lam_p.re),
                          torch.where(healthy, lam_new.im, lam_p.im))
    if evicted_l is not None:
        lam_new.re.masked_fill_(evicted_l[:, None], 0.0)
        lam_new.im.masked_fill_(evicted_l[:, None], 0.0)
    if sspec.has_padding:
        # padding never re-enters the air: Θ is garbage there, so the dual
        # update would otherwise seed non-zero λ at padded slots
        pad = ~shard_valid_mask(sspec, c.j, dev)
        lam_new.re.masked_fill_(pad[None, :], 0.0)
        lam_new.im.masked_fill_(pad[None, :], 0.0)
    b_seg, c_seg, rep_seg = _segs_psum(sspec, Theta_p, c.jm, c.jf, mesh,
                                       model_axis, fsdp_axis)
    Theta_new = unpack_shard_local(sspec, Theta_p, rep_seg, b_seg=b_seg,
                                   c_seg=c_seg)
    aux = {}
    guard_metrics = {}
    evicted = None
    if stale_next is not None:
        aux["stale"] = stale_next
    if has_guard:
        guard_metrics["guard/healthy"] = healthy.to(torch.float32)
        guard_metrics["guard/retries"] = retries.to(torch.float32)
        if evicted_l is not None:
            evicted = _global_rows(mesh, evicted_l.to(torch.float32),
                                   daxes) > 0.5
            aux["evicted"] = evicted
            guard_metrics["guard/evicted"] = evicted.to(torch.float32).sum()
    W = W_l * c.n_data
    active = mask
    if evicted is not None:
        active = ~evicted if active is None else active & ~evicted
    obs_metrics = {}
    if tel is not None:
        obs_metrics["obs/min_alpha"] = transport.applied_alpha(inv_alpha)
        obs_metrics["obs/active_workers"] = transport.active_workers(
            active, W, dev)
        if use_fused:
            obs_metrics["obs/rx_snr_db"] = transport.snr_db_from_power(
                sig_g, npw_g)
            if want_energy_out:
                obs_metrics["obs/tx_energy"] = _global_rows(mesh, e_tx,
                                                            daxes)
    metrics = _obs.merge_disjoint({"inv_alpha": inv_alpha}, guard_metrics,
                                  obs_metrics,
                                  who="ota_tree_round_shard_local")
    if mask is not None:
        metrics["participation"] = mask.to(torch.float32).mean()
    keep = None if active is None else active.any()
    if healthy is not None:
        keep = healthy if keep is None else keep & healthy
    if keep is not None and Theta_prev is not None:
        Theta_new = tree_map(lambda new, old: torch.where(
            keep, new, old.to(new.dtype)), Theta_new, Theta_prev)
    if tel is not None and Theta_prev is not None:
        metrics["obs/theta_update_norm"] = shard_update_norm(
            sspec, Theta_new, Theta_prev, mesh, saxes)
    if aux:
        metrics["_fault_aux"] = aux
    return Theta_new, lam_new, metrics


def shard_update_norm(sspec: ShardPackSpec, new: PyTree, old: PyTree, mesh,
                      saxes) -> Tensor:
    """‖new − old‖₂ over the GLOBAL trees whose shards the grid's ranks
    hold: each leaf's local sum of squares counted once across the shards
    that hold the same block, then summed over the grid."""
    sq = None
    for i, (n, o) in enumerate(zip(tree_leaves(new), tree_leaves(old))):
        d = n.to(torch.float32, copy=True).sub_(o).reshape(-1)
        s = torch.dot(d, d) / float(shard_replication(sspec, i))
        sq = s if sq is None else sq + s
    return torch.sqrt(mesh.psum(sq, saxes))
