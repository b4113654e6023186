"""Pytree-level A-FADMM: the LLM trainer's OTA round over a parameter tree.
Counterpart of the single-device packed half of ``repro/core/tree_ota.py``.

The OTA math is elementwise, so the round *packs* θ's leaves into one
contiguous ``(W, D)`` f32 buffer (``core.packing``) and runs the flat
transport on it: one fused uplink (B6 then B3), one matched-filter noise
plane and one dual update (B4) per round, however many leaves the model
has.  The duals λ and the fading h live persistently packed as ``(W, D)``
Complex buffers; only θ is a tree (the local steps run the model).

The round's random planes are arguments: the matched-filter noise
``noise_re`` (d,) and, on a redraw round, the fresh Rayleigh block, so a
test can replay the JAX package's draws.  Not ported yet: the leafwise
rounds (``ota_tree_round``, ``ota_tree_round_leafwise``; ROADMAP queue A
item 3), the scenario mask and imperfect CSI, fault guards, telemetry and
cohort sampling on this round (item 4), and the shard-local round (item 6).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import transport
from repro_torch.core.admm import AdmmConfig
from repro_torch.core.channel import ChannelConfig, rayleigh
from repro_torch.core.cplx import Complex
from repro_torch.core.packing import PackSpec, pack, unpack
from repro_torch.tree import tree_flatten, tree_unflatten

Tensor = torch.Tensor
PyTree = Any


class TreeChannel(NamedTuple):
    h: Complex      # ONE packed Complex (W, D) buffer, f32
    age: int        # rounds since the block was drawn (a host int)


class TreeFLState(NamedTuple):
    theta: PyTree   # param tree, leaves (W, ...)
    lam: Complex    # ONE packed Complex (W, D), f32
    Theta: PyTree   # global model, leaves (...)
    chan: TreeChannel
    opt: Any        # per-worker local optimizer state (leaves (W, ...))
    step: int


def _zmap(fn: Callable, *trees: PyTree) -> PyTree:
    """tree map that treats :class:`Complex` as a leaf in every argument:
    the trees share theta's structure, so their flattened leaves zip
    positionally."""
    flats = [tree_flatten(t)[0] for t in trees]
    treedef = tree_flatten(trees[0])[1]
    return tree_unflatten(treedef, [fn(*args) for args in zip(*flats)])


def tree_penalty_grad(theta: PyTree, lam: PyTree, h: PyTree, Theta: PyTree,
                      rho: float) -> PyTree:
    """Leafwise Re{λ*h} + ρ|h|²(θ − Θ), broadcasting Θ over the worker dim."""
    return _zmap(lambda t, l, hh, T: transport.penalty_grad(t, l, hh, T, rho),
                 theta, lam, h, Theta)


# ---------------------------------------------------------------------------
# persistently-packed fading state
# ---------------------------------------------------------------------------

def init_channel_packed(gen: torch.Generator, n_workers: int,
                        d: int) -> TreeChannel:
    """One Rayleigh fading block drawn over the packed ``(W, D)`` index
    space, on ``gen``'s device."""
    return TreeChannel(h=rayleigh(gen, (n_workers, d)), age=0)


def redraws(chan: TreeChannel, ccfg: ChannelConfig) -> bool:
    """Whether the next :func:`step_channel_packed` draws a new block."""
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


def _not_ported(name: str, item: str):
    raise NotImplementedError(
        f"ota_tree_round_packed_state: {name} is not ported yet (ROADMAP "
        f"queue A item {item})")


def ota_tree_round_packed_state(theta: PyTree, lam_p: Complex, h_p: Complex,
                                noise_re: Tensor, acfg: AdmmConfig,
                                ccfg: ChannelConfig, spec: PackSpec, *,
                                mask: Optional[Tensor] = None,
                                h_tx_p: Optional[Complex] = None,
                                fused: Optional[bool] = None,
                                worker_chunk: Optional[int] = None,
                                guard=None, faults=None, telemetry=None,
                                cohort_idx: Optional[Tensor] = None,
                                ) -> Tuple[PyTree, Complex, dict]:
    """One OTA round where the duals/fading are already packed ``(W, D)``.

    Only θ is packed here.  ``fused`` None/True runs the uplink as
    ``transport.ota_round_fused`` (B6 then B3, with power control per
    ``acfg``; ``worker_chunk`` streams the workers in cohorts), False as the
    composed ``transport.ota_uplink``; then the dual update (B4).  Returns
    ``(Theta_tree_f32, lam_new_packed, {"inv_alpha": ...})``: the global
    model stays f32 (the analog path)."""
    for name, arg, item in (("mask", mask, "4"), ("h_tx_p", h_tx_p, "4"),
                            ("guard", guard, "3"), ("faults", faults, "4"),
                            ("telemetry", telemetry, "4"),
                            ("cohort_idx", cohort_idx, "4")):
        if arg is not None:
            _not_ported(name, item)
    theta_p = pack(spec, theta)                    # the one layout op per round
    if fused is not False:
        Theta_p, inv_alpha, _ = transport.ota_round_fused(
            theta_p, lam_p, h_p, noise_re, acfg.rho, ccfg,
            power_control=acfg.power_control,
            worker_chunk=int(worker_chunk or 0))
    else:
        Theta_p, inv_alpha = transport.ota_uplink(
            theta_p, lam_p, h_p, noise_re, acfg.rho, ccfg,
            power_control=acfg.power_control)
    lam_new_p = transport.dual_update(lam_p, h_p, theta_p, Theta_p, acfg.rho)
    Theta_new = unpack(spec, Theta_p, cast=False)  # analog path stays f32
    return Theta_new, lam_new_p, {"inv_alpha": inv_alpha}

