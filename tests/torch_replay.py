"""Shared by the port's tests that replay JAX's runs: a port algorithm's JAX
twin, the JAX algorithm's initial state carried into the port, and the
random planes JAX's ``round(key, ...)`` draws, made in JAX and handed to the
port's ``round(..., draws=)``; for A-FADMM under a scenario, faults, a guard
and a cohort too, and for the LLM trainer's ``train_step`` (its state and
its round's planes: the scenario's, the per-leaf noise, the fault uniforms,
the guard's planes and the cohort plane), in the replicated and the
sketched mode."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
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


@pytest.fixture(scope="module")
def one_thread():
    """One intra-op torch thread for a module of toy-sized tests: the suite
    runs several pytest workers on the host's cores, and a torch op that
    spreads a tiny tensor over all of them waits on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# ---------------------------------------------------------------------------
# cohorts, scenarios, faults and guards; the LLM trainer's rounds
# ---------------------------------------------------------------------------

def gadmm_draws(keys, shape, ccfg):
    """The link planes JAX's ``AnalogGadmm.round(key, ...)`` draws for each
    of ``keys`` (round keys), as one ``r -> GadmmDraws`` of round r: each
    half-round's ``_noisy_link`` splits its half of the key into h and z."""
    from repro.core.channel import awgn

    from repro_torch.core.decentralized import GadmmDraws

    if not ccfg.noisy:
        return lambda r: GadmmDraws(None, None, None, None)

    @jax.jit
    @jax.vmap
    def planes(key):
        out = []
        for k in jax.random.split(key):
            kh, kz = jax.random.split(k)
            h = rayleigh(kh, shape)
            z = awgn(kz, shape, ccfg.noise_var_matched)
            out += [h.re, h.im, z.re, z.im]
        return out

    p = [np.array(x) for x in planes(jnp.stack(list(keys)))]
    return lambda r: GadmmDraws(*(Complex(torch.from_numpy(p[i][r]),
                                          torch.from_numpy(p[i + 1][r]))
                                  for i in range(0, 8, 2)))


def cohort_draw(key, cfg):
    """The plane JAX's ``sample_cohort(key, cfg, ...)`` draws from the
    ``COHORT_SALT`` branch of round key ``key``: the permutation for
    ``uniform``, the Gumbel plane for ``prop-h2``, None for ``top-gain``."""
    from repro.core.cohort import COHORT_SALT

    k = jax.random.fold_in(key, COHORT_SALT)
    if cfg.policy == "uniform":
        return t(jax.random.permutation(k, cfg.population))
    if cfg.policy == "prop-h2":
        return t(jax.random.gumbel(k, (cfg.population,), jnp.float32))
    return None


def _faulted_extras(key, kn, d, n_workers, faults, guard, ccfg_j):
    """(FaultDraws, GuardDraws) of a round under JAX's fault plan and guard
    (each None where absent)."""
    from test_torch_faults import guard_draws, jax_uniforms

    from repro_torch.faults import GuardConfig
    from repro_torch.faults.plan import FAULT_SALT

    fd = gd = None
    if faults is not None:
        fd = jax_uniforms(faults, jax.random.fold_in(key, FAULT_SALT),
                          n_workers)
    bursts = faults is not None and faults.burst_prob > 0
    if guard is not None or bursts:
        g = GuardConfig(**dataclasses.asdict(guard)) if guard is not None \
            else GuardConfig()
        gd = guard_draws(g, kn, d, ccfg_j, bursts)
    return fd, gd


def afadmm_round_draws(key, st_j, alg_j) -> RoundDraws:
    """Every plane JAX's ``AFadmm.round(key, st_j, ...)`` draws under its
    scenario, fault plan, guard and cohort (population-wide state)."""
    from test_torch_scenario import replay_phy

    ccfg = alg_j.ccfg
    kc, kn = jax.random.split(key)
    N, d = st_j.theta.shape
    h_fresh = phy = None
    if alg_j.scenario is not None:
        phy = replay_phy(alg_j.scenario, kc, st_j.phys)
    elif int(st_j.blk.age) + 1 >= ccfg.coherence_iters:
        h = rayleigh(kc, (N, d))
        h_fresh = Complex(t(h.re), t(h.im))
    fd, gd = _faulted_extras(key, kn, d, N, alg_j.faults, alg_j.guard, ccfg)
    coh = alg_j.cohort
    sampled = coh is not None and coh.cohort < coh.population
    return RoundDraws(
        h_fresh=h_fresh, noise_re=t(matched_filter_noise(kn, (d,), ccfg).re),
        phy=phy, faults=fd, guard=gd,
        cohort=cohort_draw(key, coh) if sampled else None)


def afadmm_full_state(st_j):
    """The port's ``AFadmmState`` from a JAX one with its phy and fault
    state."""
    from test_torch_faults import fault_to_numpy
    from test_torch_scenario import afadmm_to_numpy

    leaves = afadmm_to_numpy(st_j)
    if st_j.flt is not None:
        leaves["flt"] = fault_to_numpy(st_j.flt)
    return convert.afadmm_state_from_numpy(leaves, device="cpu")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def llm_state(st_j):
    """The port's ``TreeFLState`` from the JAX LLM trainer's: packed or
    leafwise λ and h, a scenario's ``PhyState``, a ``FaultState``, sgd's
    optimizer state."""
    from test_torch_faults import fault_to_numpy
    from test_torch_scenario import phy_to_numpy

    from repro.core.cplx import Complex as JComplex

    is_c = lambda x: isinstance(x, JComplex)  # noqa: E731
    if isinstance(st_j.lam, JComplex):
        lam_re, lam_im = np.asarray(st_j.lam.re), np.asarray(st_j.lam.im)
    else:
        lam_re = jax.tree.map(lambda c: np.asarray(c.re), st_j.lam,
                              is_leaf=is_c)
        lam_im = jax.tree.map(lambda c: np.asarray(c.im), st_j.lam,
                              is_leaf=is_c)
    chan = st_j.chan
    phys = h_re = h_im = None
    age = 0
    if hasattr(chan, "h_small"):
        phys = phy_to_numpy(chan)
    elif isinstance(chan.h, JComplex):
        h_re, h_im, age = np.asarray(chan.h.re), np.asarray(chan.h.im), \
            int(chan.age)
    else:
        h_re = jax.tree.map(lambda c: np.asarray(c.re), chan.h, is_leaf=is_c)
        h_im = jax.tree.map(lambda c: np.asarray(c.im), chan.h, is_leaf=is_c)
        age = int(chan.age)
    return convert.tree_fl_state_from_numpy(
        _np_tree(st_j.theta), _np_tree(st_j.Theta), lam_re, lam_im, h_re,
        h_im, age, int(st_j.step),
        opt={"mu": _np_tree(st_j.opt.mu), "nu": None,
             "count": int(st_j.opt.count)},
        phys=phys,
        flt=None if st_j.flt is None else fault_to_numpy(st_j.flt),
        device="cpu")


def sketch_state(st_j):
    """The port's ``SketchFLState`` from the JAX sketched trainer's: Θ, the
    (W, d_s) λ and channel (a scenario's ``PhyState``), a ``FaultState``."""
    from test_torch_faults import fault_to_numpy
    from test_torch_scenario import phy_to_numpy

    from repro_torch.core.tree_ota import TreeChannel
    from repro_torch.train.llm_trainer import SketchFLState

    def c(x):
        return Complex(t(x.re), t(x.im))

    chan = st_j.chan
    if hasattr(chan, "h_small"):
        chan = convert.phy_state_from_numpy(phy_to_numpy(chan), device="cpu")
    else:
        chan = TreeChannel(h=c(chan.h), age=int(chan.age))
    flt = None if st_j.flt is None else convert.fault_state_from_numpy(
        fault_to_numpy(st_j.flt), device="cpu")
    return SketchFLState(
        Theta=convert.model_params_from_numpy(_np_tree(st_j.Theta),
                                              device="cpu"),
        lam=c(st_j.lam), chan=chan, step=int(st_j.step), flt=flt)


def llm_round_draws(key, st_j, ccfg_j, *, scenario=None, faults=None,
                    guard=None, cohort=None):
    """Every plane JAX's LLM ``train_step(st_j, batch, key)`` draws: the
    channel from ``kc`` (the scenario's draws, or the redraw block, packed
    or one per leaf from ``split(kc, n_leaves)``), the uplink noise from
    ``kn`` (per leaf from ``split(kn, n_leaves)`` for the leafwise state),
    the fault uniforms, the guard's planes and the cohort plane."""
    from test_torch_scenario import replay_phy

    from repro.core.cplx import Complex as JComplex
    from repro.core.transport import matched_filter_noise_re
    from repro_torch.train.llm_trainer import TreeRoundDraws

    kc, kn = jax.random.split(key)
    packed = isinstance(st_j.lam, JComplex)
    if packed:              # replicated (W, D) or sketched (W, d_s) planes
        N, d = st_j.lam.re.shape
    else:
        leaves = jax.tree_util.tree_leaves(st_j.theta)
        N = leaves[0].shape[0]
        d = sum(int(np.prod(leaf.shape[1:])) for leaf in leaves)
    h_fresh = phy = None
    if scenario is not None:
        phy = replay_phy(scenario, kc, st_j.chan)
    elif int(st_j.chan.age) + 1 >= ccfg_j.coherence_iters:
        if packed:
            h = rayleigh(kc, (N, d))
            h_fresh = Complex(t(h.re), t(h.im))
        else:
            h_fresh = []
            for k, leaf in zip(jax.random.split(kc, len(leaves)), leaves):
                h = rayleigh(k, leaf.shape)
                h_fresh.append(Complex(t(h.re), t(h.im)))
    if packed:
        noise = t(matched_filter_noise_re(kn, (d,), ccfg_j))
    else:
        noise = [t(matched_filter_noise(k, leaf.shape[1:], ccfg_j).re)
                 for k, leaf in zip(jax.random.split(kn, len(leaves)),
                                    leaves)]
    fd, gd = _faulted_extras(key, kn, d, N, faults, guard, ccfg_j)
    sampled = cohort is not None and cohort.cohort < cohort.population
    return TreeRoundDraws(h_fresh, noise, phy=phy, faults=fd, guard=gd,
                          cohort=cohort_draw(key, cohort) if sampled
                          else None)
