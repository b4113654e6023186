"""One A-FADMM round of the port against the JAX package's, starting from a
JAX state carried across by ``repro_torch.convert`` and replaying the JAX
round's random planes: linear regression with the exact solver and the flip
rule (on a plain round and on a channel-redraw round), and a small MLP with
prox-Adam and injected minibatch indices."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import admm as jadmm  # noqa: E402
from repro.core import make as jmake  # noqa: E402
from repro.core.channel import matched_filter_noise  # noqa: E402
from repro.data.federated import split_iid as jsplit  # noqa: E402
from repro.data.synthetic import image_dataset as jimages  # noqa: E402
from repro.models.mlp import init_mlp_flat as jinit_mlp  # noqa: E402
from repro.models.mlp import make_loss_fns as jloss_fns  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro.optim.local_solvers import prox_adam_solver as jprox  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import admm  # noqa: E402
from repro_torch.core.admm import AdmmConfig, RoundDraws  # noqa: E402
from repro_torch.core.aggregators import make  # noqa: E402
from repro_torch.core.channel import ChannelConfig  # noqa: E402
from repro_torch.core.cplx import Complex  # noqa: E402
from repro_torch.core.subcarrier import SubcarrierPlan  # noqa: E402
from repro_torch.data.federated import make_batch_fn  # noqa: E402
from repro_torch.models.mlp import make_loss_fns  # noqa: E402
from repro_torch.optim.local_solvers import (exact_quadratic_solver,  # noqa: E402
                                             prox_adam_solver)
from repro_torch.optim.optimizers import adam  # noqa: E402

from helpers import default_cfgs, make_linreg, make_solver  # noqa: E402

#: solve / autograd / sum orders differ from XLA's in the last ulps
TOL = dict(rtol=1e-4, atol=1e-5)


def state_to_numpy(st) -> dict:
    """The JAX ``AFadmmState`` leaves under ``convert.STATE_KEYS``."""
    a = np.asarray
    return {"theta": a(st.theta), "lam_re": a(st.lam.re),
            "lam_im": a(st.lam.im), "Theta": a(st.Theta),
            "h_re": a(st.blk.h.re), "h_im": a(st.blk.h.im),
            "h_prev_re": a(st.blk.h_prev.re), "h_prev_im": a(st.blk.h_prev.im),
            "changed": a(st.blk.changed), "age": a(st.blk.age),
            "step": a(st.step)}


def replay_draws(key, st, ccfg, batch_idx=None) -> RoundDraws:
    """The planes JAX's ``AFadmm.round(key, st, ...)`` draws, as torch."""
    kc, kn = jax.random.split(key)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    h_fresh = None
    if int(st.blk.age) + 1 >= ccfg.coherence_iters:
        from repro.core.channel import rayleigh
        fresh = rayleigh(kc, st.blk.h.re.shape)
        h_fresh = Complex(t(fresh.re), t(fresh.im))
    noise = matched_filter_noise(kn, st.Theta.shape, ccfg)
    return RoundDraws(h_fresh=h_fresh, noise_re=t(noise.re),
                      batch_idx=batch_idx)


def assert_states_close(st_p, st_j, metrics_p, metrics_j):
    np.testing.assert_allclose(st_p.theta.numpy(), np.asarray(st_j.theta),
                               **TOL)
    np.testing.assert_allclose(st_p.lam.re.numpy(), np.asarray(st_j.lam.re),
                               **TOL)
    np.testing.assert_allclose(st_p.lam.im.numpy(), np.asarray(st_j.lam.im),
                               **TOL)
    np.testing.assert_allclose(st_p.Theta.numpy(), np.asarray(st_j.Theta),
                               **TOL)
    # the replayed draw runs outside the jitted round: last-ulp differences
    np.testing.assert_allclose(st_p.blk.h.re.numpy(),
                               np.asarray(st_j.blk.h.re), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(st_p.blk.changed.numpy(),
                                  np.asarray(st_j.blk.changed))
    assert st_p.blk.age == int(st_j.blk.age) and st_p.step == int(st_j.step)
    for k in ("primal_residual", "dual_residual", "inv_alpha",
              "channel_uses"):
        np.testing.assert_allclose(float(metrics_p[k]), float(metrics_j[k]),
                                   **TOL)


def _linreg_port(prob, rho):
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    X, y = t(prob["X"]), t(prob["y"])

    def grad_fn(theta):
        r = torch.einsum("wmd,wd->wm", X, theta) - y
        return 2.0 * torch.einsum("wmd,wm->wd", X, r)

    return exact_quadratic_solver(X, y, rho), grad_fn


@pytest.mark.parametrize("pre_rounds", [0, 2])
@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_linreg_round_matches_jax(pre_rounds, backend):
    """coherence 3: round 0 keeps the channel, round 2 redraws it (the flip
    rule then freezes θ and re-solves λ)."""
    prob = make_linreg(jax.random.PRNGKey(0))
    acfg_j, ccfg_j, plan_j = default_cfgs(prob["W"], prob["d"], coherence=3,
                                          noisy=True, power_control=True)
    alg_j = jmake("afadmm", acfg_j, ccfg_j, plan_j, backend=backend)
    solver_j = make_solver(prob, acfg_j.rho)
    key = jax.random.PRNGKey(1)
    st_j = alg_j.init(key, prob["theta0"])
    step = jax.jit(lambda st, k: alg_j.round(k, st, solver_j,
                                             prob["grad_fn"]))
    for r in range(pre_rounds):
        st_j, _ = step(st_j, jax.random.fold_in(key, r + 1))
    kr = jax.random.fold_in(key, pre_rounds + 1)
    draws = replay_draws(kr, st_j, ccfg_j)
    assert (draws.h_fresh is not None) == (pre_rounds == 2)
    st_p = convert.afadmm_state_from_numpy(state_to_numpy(st_j), device="cpu")
    st_j2, m_j = step(st_j, kr)

    alg = make("afadmm", AdmmConfig(rho=0.5, flip_on_change=True),
               ChannelConfig(n_workers=prob["W"], n_subcarriers=prob["d"],
                             coherence_iters=3, noisy=True),
               SubcarrierPlan.build(prob["d"], prob["d"]))
    solver, grad_fn = _linreg_port(prob, 0.5)
    st_p2, m_p = alg.round(0, st_p, solver, grad_fn, draws=draws)
    assert_states_close(st_p2, st_j2, m_p, m_j)
    if pre_rounds == 2:      # the flip round kept every worker's θ
        np.testing.assert_array_equal(st_p2.theta.numpy(),
                                      np.asarray(st_j.theta))


def _mlp_problem(W=4, n_steps=3, B=5, sizes=(16, 8, 4)):
    key = jax.random.PRNGKey(7)
    xtr, ytr, _, _ = jimages(key, 80, 20, n_classes=sizes[-1], dim=sizes[0],
                             cluster_std=3.0)
    shards = jsplit(jax.random.fold_in(key, 1), 80, W)
    flat0, unflatten = jinit_mlp(jax.random.fold_in(key, 2), sizes)
    theta0 = flat0[None] + 0.01 * jax.random.normal(key, (W, flat0.shape[0]))
    per = shards.shape[1]
    idx = np.random.default_rng(3).integers(0, per, (n_steps, W, B))
    return dict(key=key, xtr=xtr, ytr=ytr, shards=shards, flat0=flat0,
                unflatten=unflatten, theta0=theta0, idx=idx, sizes=sizes,
                n_steps=n_steps, W=W)


def _mlp_jax_solver(p, idx, rho):
    _, grad, _ = jloss_fns(p["unflatten"])
    flat = jnp.take_along_axis(p["shards"][None], jnp.asarray(idx), axis=2)
    bx, by = p["xtr"][flat], p["ytr"][flat]       # (n_steps, W, B, ...)
    return jprox(lambda th, b: jax.vmap(grad)(th, *b), jadam(0.01),
                 p["n_steps"], rho, batch_fn=lambda s: (bx[s], by[s]))


def _mlp_port_solver(p, rho):
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    _, unflatten = convert.mlp_flat_from_numpy(np.asarray(p["flat0"]),
                                               p["sizes"], device="cpu")
    _, grad, _ = make_loss_fns(unflatten)
    batch_fn = make_batch_fn((t(p["xtr"]), t(p["ytr"]).long()),
                             t(p["shards"]).long(), batch_size=5)
    return prox_adam_solver(lambda th, b: grad(th, *b), adam(0.01),
                            p["n_steps"], rho, batch_fn=batch_fn)


def test_mlp_round_matches_jax():
    p = _mlp_problem()
    d = int(p["flat0"].shape[0])
    acfg_j, ccfg_j, plan_j = default_cfgs(p["W"], d, noisy=True, n_sub=32,
                                          power_control=True, flip=False)
    alg_j = jmake("afadmm", acfg_j, ccfg_j, plan_j, backend="pallas")
    key = jax.random.PRNGKey(5)
    st_j = alg_j.init(key, p["theta0"])
    kr = jax.random.fold_in(key, 1)
    draws = replay_draws(kr, st_j, ccfg_j,
                         batch_idx=torch.from_numpy(p["idx"]))
    st_p = convert.afadmm_state_from_numpy(state_to_numpy(st_j), device="cpu")
    st_j2, m_j = alg_j.round(kr, st_j, _mlp_jax_solver(p, p["idx"], 0.5),
                             None)

    alg = make("afadmm", AdmmConfig(rho=0.5, flip_on_change=False),
               ChannelConfig(n_workers=p["W"], n_subcarriers=32),
               SubcarrierPlan.build(d, 32))
    st_p2, m_p = alg.round(0, st_p, _mlp_port_solver(p, 0.5), None,
                           draws=draws)
    assert_states_close(st_p2, st_j2, m_p, m_j)
    assert m_p["channel_uses"] == float(plan_j.n_slots)


def test_init_state_and_residuals_match_jax():
    prob = make_linreg(jax.random.PRNGKey(2))
    acfg_j, ccfg_j, plan_j = default_cfgs(prob["W"], prob["d"])
    alg_j = jmake("afadmm", acfg_j, ccfg_j, plan_j)
    st_j = alg_j.init(jax.random.PRNGKey(3), prob["theta0"])
    blk = convert.afadmm_state_from_numpy(state_to_numpy(st_j),
                                          device="cpu").blk
    st_p = admm.init_state(torch.from_numpy(np.array(prob["theta0"])), blk)
    np.testing.assert_allclose(st_p.Theta.numpy(), np.asarray(st_j.Theta),
                               rtol=1e-6)
    assert float(st_p.lam.re.abs().max()) == 0.0 and st_p.step == 0
    prev = np.random.default_rng(0).standard_normal(prob["d"]).astype(
        np.float32)
    got = admm.residuals(st_p, torch.from_numpy(prev))
    want = jadmm.residuals(st_j, jnp.asarray(prev))
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)


def test_converted_state_is_the_jax_state():
    prob = make_linreg(jax.random.PRNGKey(4))
    acfg_j, ccfg_j, plan_j = default_cfgs(prob["W"], prob["d"])
    st_j = jmake("afadmm", acfg_j, ccfg_j, plan_j).init(jax.random.PRNGKey(5),
                                                        prob["theta0"])
    leaves = state_to_numpy(st_j)
    st_p = convert.afadmm_state_from_numpy(leaves, device="cpu")
    np.testing.assert_array_equal(st_p.theta.numpy(), leaves["theta"])
    np.testing.assert_array_equal(st_p.blk.h_prev.im.numpy(),
                                  leaves["h_prev_im"])
    assert st_p.blk.changed.dtype == torch.bool
    with pytest.raises(KeyError, match="missing"):
        convert.afadmm_state_from_numpy({"theta": leaves["theta"]},
                                        device="cpu")


def test_analog_downlink_needs_its_noise_plane():
    prob = make_linreg(jax.random.PRNGKey(6), W=3)
    solver, grad_fn = _linreg_port(prob, 0.5)
    ccfg = ChannelConfig(n_workers=3, n_subcarriers=6, analog_downlink=True)
    alg = make("afadmm", AdmmConfig(), ccfg, SubcarrierPlan.build(6, 6))
    st = alg.init(0, torch.from_numpy(np.array(prob["theta0"])))
    draws = alg.draw(1, st, solver)
    assert draws.downlink_noise_re.shape == (3, 6)
    st2, _ = alg.round(1, st, solver, grad_fn, draws=draws)
    no_plane = draws._replace(downlink_noise_re=None)
    with pytest.raises(ValueError, match="downlink_noise_re"):
        alg.round(1, st, solver, grad_fn, draws=no_plane)
    # the downlink noise enters only the duals: λ differs, Θ does not
    st3, _ = alg.round(1, st, solver, grad_fn, draws=draws._replace(
        downlink_noise_re=torch.zeros(3, 6)))
    assert torch.equal(st2.Theta, st3.Theta)
    assert not torch.equal(st2.lam.re, st3.lam.re)
