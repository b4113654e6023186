"""Shared by the port's baseline and figure tests: a port algorithm's JAX
twin, the JAX algorithm's initial state carried into the port, and the
random planes JAX's ``round(key, ...)`` draws, made in JAX and handed to the
port's ``round(..., draws=)``."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import AdmmConfig as JAdmmConfig
from repro.core import ChannelConfig as JChannelConfig
from repro.core import SubcarrierPlan as JSubcarrierPlan
from repro.core import make as jmake
from repro.core.channel import matched_filter_noise, rayleigh

from repro_torch import convert
from repro_torch.core.admm import RoundDraws
from repro_torch.core.aggregators import (AnalogGDState, DFadmmState,
                                          FedAvgState)
from repro_torch.core.channel import ChannelBlock
from repro_torch.core.cplx import Complex


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def jax_twin(alg):
    """The JAX package's algorithm of the port's ``alg``: same name,
    configs and keywords."""
    ccfg = JChannelConfig(**dataclasses.asdict(alg.ccfg))
    plan = JSubcarrierPlan.build(alg.plan.d, alg.plan.n_subcarriers)
    keywords = {"dfadmm": ("bits_per_element",),
                "analog_gd": ("learning_rate", "epsilon")}
    kw = {k: getattr(alg, k) for k in keywords.get(alg.name, ())}
    acfg = JAdmmConfig(**dataclasses.asdict(alg.acfg)) \
        if hasattr(alg, "acfg") else None
    return jmake(alg.name, acfg, ccfg, plan, **kw)


def _block(blk) -> ChannelBlock:
    return ChannelBlock(h=Complex(t(blk.h.re), t(blk.h.im)),
                        h_prev=Complex(t(blk.h_prev.re), t(blk.h_prev.im)),
                        changed=t(blk.changed), age=int(blk.age))


def port_state(name: str, st):
    """The port's state of algorithm ``name`` from the JAX state ``st``."""
    if name == "afadmm":
        a = np.asarray
        return convert.afadmm_state_from_numpy(
            {"theta": a(st.theta), "lam_re": a(st.lam.re),
             "lam_im": a(st.lam.im), "Theta": a(st.Theta),
             "h_re": a(st.blk.h.re), "h_im": a(st.blk.h.im),
             "h_prev_re": a(st.blk.h_prev.re),
             "h_prev_im": a(st.blk.h_prev.im),
             "changed": a(st.blk.changed), "age": a(st.blk.age),
             "step": a(st.step)}, device="cpu")
    if name == "dfadmm":
        return DFadmmState(theta=t(st.theta), lam=t(st.lam),
                           Theta=t(st.Theta), blk=_block(st.blk),
                           step=int(st.step))
    if name == "analog_gd":
        return AnalogGDState(Theta=t(st.Theta), blk=_block(st.blk),
                             step=int(st.step))
    return FedAvgState(theta=t(st.theta), Theta=t(st.Theta),
                       step=int(st.step))


def draws(alg_j, key, age: int, W: int, d: int,
          batch_idx=None) -> RoundDraws:
    """The planes ``alg_j.round(key, st, ...)`` draws when ``st``'s channel
    block has age ``age``: A-FADMM and A-GD split the key (fresh block from
    the first half, uplink noise from the second), D-FADMM draws its (W, S)
    block from the whole key, FedAvg draws nothing."""
    ccfg = alg_j.ccfg
    redraw = age + 1 >= ccfg.coherence_iters
    h_fresh = noise_re = None
    if alg_j.name in ("afadmm", "analog_gd"):
        kc, kn = jax.random.split(key)
        if redraw:
            h = rayleigh(kc, (W, d))
            h_fresh = Complex(t(h.re), t(h.im))
        noise_re = t(matched_filter_noise(kn, (d,), ccfg).re)
    elif alg_j.name == "dfadmm" and redraw:
        h = rayleigh(key, (W, ccfg.n_subcarriers))
        h_fresh = Complex(t(h.re), t(h.im))
    return RoundDraws(h_fresh=h_fresh, noise_re=noise_re,
                      batch_idx=batch_idx)


def replay(alg, theta0: torch.Tensor, key, batch_idx=None):
    """``(init_state, draws)`` for the port's ``train``: ``alg``'s JAX
    twin's initial state from ``key`` and ``theta0``, and, for round r, the
    planes of round key ``fold_in(key, r + 1)`` (``batch_idx(r)`` its
    minibatch indices, if given)."""
    alg_j = jax_twin(alg)
    st_j = alg_j.init(key, jnp.asarray(theta0.numpy()))
    W, d = theta0.shape
    coh = alg.ccfg.coherence_iters

    def round_draws(r: int) -> RoundDraws:
        return draws(alg_j, jax.random.fold_in(key, r + 1), r % coh, W, d,
                     None if batch_idx is None else batch_idx(r))

    return port_state(alg.name, st_j), round_draws
