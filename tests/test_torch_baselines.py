"""The paper's baselines in the port (D-FADMM, A-GD, FedAvg) against the JAX
package's, with the JAX run's random planes replayed: the digital link's
Shannon-rate accounting, one round of each from a JAX state, 50 linreg
rounds through ``train``, ``make`` and its keywords; the port-only
properties (A-GD's ``where`` mask, FedAvg's synchronised workers); and
``split_dirichlet``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import channel as jchannel  # noqa: E402
from repro.core import subcarrier as jsubcarrier  # noqa: E402

from repro_torch.core.admm import AdmmConfig, RoundDraws  # noqa: E402
from repro_torch.core.aggregators import (ALGORITHMS, AFadmm,  # noqa: E402
                                          AnalogGD, DFadmm, FedAvg, make)
from repro_torch.core.channel import (ChannelConfig,  # noqa: E402
                                      shannon_rate)
from repro_torch.core.cplx import Complex  # noqa: E402
from repro_torch.core.subcarrier import (SubcarrierPlan,  # noqa: E402
                                         digital_channel_uses)
from repro_torch.data.federated import split_dirichlet, split_iid  # noqa: E402
from repro_torch.optim.local_solvers import exact_quadratic_solver  # noqa: E402
from repro_torch.train.fl_trainer import train  # noqa: E402

from helpers import make_linreg, make_solver  # noqa: E402
from torch_replay import draws, jax_twin, port_state, replay, t  # noqa: E402

#: one round: the tolerance tests/test_aggregators.py holds JAX's rounds to
ROUND_TOL = dict(rtol=1e-5, atol=1e-6)
#: 50 rounds: solve and sum orders differ from XLA's, and the errors add up
RUN_TOL = dict(rtol=1e-4, atol=1e-5)
BASELINES = ("dfadmm", "analog_gd", "fedavg")
EXTRA = {"dfadmm": {}, "fedavg": {},
         "analog_gd": dict(learning_rate=1e-2, epsilon=1e-6)}


def _port_problem(prob):
    X, y = t(prob["X"]), t(prob["y"])

    def grad_fn(theta):
        r = torch.einsum("wmd,wd->wm", X, theta) - y
        return 2.0 * torch.einsum("wmd,wm->wd", X, r)

    return exact_quadratic_solver(X, y, 0.5), grad_fn


def _port_alg(name, W, d, coherence=10, n_sub=None, snr_db=40.0):
    ccfg = ChannelConfig(n_workers=W, n_subcarriers=n_sub or d,
                         coherence_iters=coherence, snr_db=snr_db)
    return make(name, AdmmConfig(rho=0.5), ccfg,
                SubcarrierPlan.build(d, ccfg.n_subcarriers), **EXTRA[name])


@pytest.mark.parametrize("snr_db", [-10.0, 40.0])
def test_shannon_rate_and_digital_uses_match_jax(snr_db):
    key = jax.random.PRNGKey(3)
    W, S = 6, 40
    h = jchannel.rayleigh(key, (W, S))
    jcfg = jchannel.ChannelConfig(n_workers=W, n_subcarriers=S,
                                  snr_db=snr_db)
    cfg = ChannelConfig(n_workers=W, n_subcarriers=S, snr_db=snr_db)
    rates_j = jchannel.shannon_rate(h, jcfg)
    rates = shannon_rate(Complex(t(h.re), t(h.im)), cfg)
    np.testing.assert_allclose(rates.numpy(), rates_j, rtol=1e-6, atol=1e-6)
    s_w = S // W
    for bits in (192.0, 32.0 * 2778):
        uses_j = jsubcarrier.digital_channel_uses(rates_j[:, :s_w], bits,
                                                  s_w)
        uses = digital_channel_uses(rates[:, :s_w], bits, s_w)
        assert uses.dim() == 0 and float(uses) == float(uses_j)


@pytest.mark.parametrize("pre_rounds", [0, 2])
@pytest.mark.parametrize("name", BASELINES)
def test_one_round_matches_jax(name, pre_rounds):
    """coherence 3: round 0 keeps the channel, round 2 redraws it."""
    prob = make_linreg(jax.random.PRNGKey(0))
    W, d = prob["W"], prob["d"]
    alg = _port_alg(name, W, d, coherence=3, n_sub=4 * W)
    alg_j = jax_twin(alg)
    solver_j = make_solver(prob, 0.5)
    step = jax.jit(lambda st, k: alg_j.round(k, st, solver_j,
                                             prob["grad_fn"]))
    key = jax.random.PRNGKey(1)
    st_j = alg_j.init(key, prob["theta0"])
    for r in range(pre_rounds):
        st_j, _ = step(st_j, jax.random.fold_in(key, r + 1))
    kr = jax.random.fold_in(key, pre_rounds + 1)
    dr = draws(alg_j, kr, pre_rounds, W, d)
    assert (dr.h_fresh is not None) == (pre_rounds == 2 and name != "fedavg")
    st = port_state(name, st_j)
    st_j2, m_j = step(st_j, kr)
    solver, grad_fn = _port_problem(prob)
    st2, m = alg.round(0, st, solver, grad_fn, draws=dr)

    np.testing.assert_allclose(st2.Theta.numpy(), np.asarray(st_j2.Theta),
                               **ROUND_TOL)
    for field in ("theta", "lam"):
        if hasattr(st2, field):
            np.testing.assert_allclose(getattr(st2, field).numpy(),
                                       np.asarray(getattr(st_j2, field)),
                                       **ROUND_TOL)
    if hasattr(st2, "blk"):
        # the replayed draw runs outside the jitted round: last-ulp
        # differences
        np.testing.assert_allclose(st2.blk.h.re.numpy(),
                                   np.asarray(st_j2.blk.h.re), rtol=1e-6,
                                   atol=1e-6)
        assert st2.blk.age == int(st_j2.blk.age)
    assert st2.step == int(st_j2.step) == pre_rounds + 1
    assert set(m) == set(m_j)
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), **ROUND_TOL)


@pytest.mark.parametrize("name", BASELINES)
def test_50_linreg_rounds_match_jax(name):
    """``train`` from JAX's initial state with every round's planes
    replayed: Θ after each round and the channel uses.  At −10 dB the
    digital straggler needs several slots, a count that moves with each
    coherence block."""
    prob = make_linreg(jax.random.PRNGKey(4), W=10)
    W, d = prob["W"], prob["d"]
    alg = _port_alg(name, W, d, n_sub=10 * W, snr_db=-10.0)
    alg_j = jax_twin(alg)
    solver_j = make_solver(prob, 0.5)
    step = jax.jit(lambda st, k: alg_j.round(k, st, solver_j,
                                             prob["grad_fn"]))
    key = jax.random.PRNGKey(5)
    st_j = alg_j.init(key, prob["theta0"])
    thetas_j, uses_j = [], []
    for r in range(50):
        st_j, m_j = step(st_j, jax.random.fold_in(key, r + 1))
        thetas_j.append(np.asarray(st_j.Theta))
        uses_j.append(float(m_j["channel_uses"]))

    theta0 = t(prob["theta0"])
    init_state, round_draws = replay(alg, theta0, key)
    solver, grad_fn = _port_problem(prob)
    thetas = []

    def record(Theta):
        thetas.append(Theta.clone())
        return {"loss": torch.sum(Theta ** 2)}

    hist = train(alg, theta0, solver, grad_fn, 50, 0, eval_fn=record,
                 init_state=init_state, draws=round_draws)
    assert len(thetas) == 50
    for r, (a, b) in enumerate(zip(thetas, thetas_j)):
        np.testing.assert_allclose(a.numpy(), b, err_msg=f"round {r}",
                                   **RUN_TOL)
    assert hist.channel_uses == uses_j
    if name == "dfadmm":          # 5 blocks of the digital straggler count
        assert len(set(uses_j)) > 1 and all(u % 100 == 0 for u in uses_j)
    else:
        assert set(uses_j) == {1.0}


def test_make_knows_every_algorithm_and_its_keywords():
    acfg = AdmmConfig(rho=0.5)
    ccfg = ChannelConfig(n_workers=4, n_subcarriers=8)
    plan = SubcarrierPlan.build(6, 8)
    assert set(ALGORITHMS) == {"afadmm", "dfadmm", "analog_gd", "fedavg"}
    assert isinstance(make("afadmm", acfg, ccfg, plan, scenario=None),
                      AFadmm)
    dig = make("dfadmm", acfg, ccfg, plan, bits_per_element=16)
    assert isinstance(dig, DFadmm) and dig.bits_per_element == 16
    agd = make("analog_gd", acfg, ccfg, plan, learning_rate=5e-2,
               epsilon=1e-3)
    assert isinstance(agd, AnalogGD)
    assert (agd.learning_rate, agd.epsilon) == (5e-2, 1e-3)
    assert isinstance(make("fedavg", None, ccfg, plan), FedAvg)
    with pytest.raises(ValueError, match="unknown algorithm"):
        make("gadmm", acfg, ccfg, plan)
    with pytest.raises(TypeError):
        make("fedavg", acfg, ccfg, plan, learning_rate=1.0)


def test_analog_gd_where_mask_keeps_a_nan_worker_out():
    """Worker 0's gradient is NaN and its channel is below ε everywhere:
    ``where`` drops it (JAX's ``mask * g`` would give NaN · 0 = NaN)."""
    W, d = 4, 6
    alg = make("analog_gd", None, ChannelConfig(n_workers=W, n_subcarriers=d),
               SubcarrierPlan.build(d, d), learning_rate=0.1, epsilon=1e-3)
    st = alg.init(0, torch.randn(W, d))
    h = Complex(st.blk.h.re.clone(), st.blk.h.im.clone())
    h.re[0], h.im[0] = 1e-4, 0.0
    st = st._replace(blk=dataclasses.replace(st.blk, h=h))

    def grad_fn(theta):
        g = theta - 1.0
        g[0] = float("nan")
        return g

    st2, m = alg.round(0, st, None, grad_fn,
                       draws=RoundDraws(h_fresh=None,
                                        noise_re=torch.zeros(d)))
    assert torch.isfinite(st2.Theta).all()
    np.testing.assert_allclose(float(m["participation"]), (W - 1) / W)
    # the three kept workers' mean gradient, all at Θ
    np.testing.assert_allclose(st2.Theta.numpy(),
                               (st.Theta - 0.1 * (st.Theta - 1.0)).numpy(),
                               rtol=1e-6)


def test_fedavg_round_leaves_every_worker_at_the_mean():
    prob = make_linreg(jax.random.PRNGKey(2), W=5)
    alg = _port_alg("fedavg", 5, prob["d"])
    solver, grad_fn = _port_problem(prob)
    st = alg.init(0, t(prob["theta0"]))
    st2, m = alg.round(0, st, solver, grad_fn)
    assert m == {"channel_uses": 1.0}
    assert torch.equal(st2.theta, st2.Theta[None].expand_as(st2.theta))
    zero = Complex(torch.zeros(5, prob["d"]), torch.zeros(5, prob["d"]))
    one = Complex(torch.ones(5, prob["d"]), torch.zeros(5, prob["d"]))
    np.testing.assert_allclose(
        st2.Theta.numpy(), solver(st.theta, zero, one, st.Theta).mean(0),
        rtol=1e-6, atol=1e-7)


def test_dfadmm_channel_uses_stay_on_the_device_until_the_run_ends():
    """D-FADMM's uses are a tensor a round; ``train`` turns them into host
    floats once, after the last round."""
    prob = make_linreg(jax.random.PRNGKey(6), W=4)
    alg = _port_alg("dfadmm", 4, prob["d"], coherence=2, n_sub=40)
    solver, grad_fn = _port_problem(prob)
    st = alg.init(1, t(prob["theta0"]))
    _, m = alg.round(7, st, solver, grad_fn)
    assert torch.is_tensor(m["channel_uses"])
    hist = train(alg, t(prob["theta0"]), solver, grad_fn, 6, 1)
    assert all(type(u) is float and u > 0 for u in hist.channel_uses)
    assert hist.cumulative_uses()[-1] == pytest.approx(sum(hist.channel_uses))


def _max_class_share(labels, shards, n_classes):
    return float(torch.stack([
        torch.bincount(labels[s], minlength=n_classes).max() / s.numel()
        for s in shards]).mean())


def test_split_dirichlet_shapes_indices_and_skew():
    n, W, C = 4003, 8, 10
    labels = torch.randint(0, C, (n,), generator=torch.Generator()
                           .manual_seed(0))
    shards = split_dirichlet(3, labels, W, alpha=0.3)
    assert shards.shape == (W, n // W) and shards.dtype == torch.int64
    flat = shards.reshape(-1)
    assert flat.unique().numel() == flat.numel()
    assert int(flat.min()) >= 0 and int(flat.max()) < n
    assert torch.equal(split_dirichlet(3, labels, W, alpha=0.3), shards)
    skew = _max_class_share(labels, shards, C)
    iid = _max_class_share(labels, split_iid(3, n, W, device="cpu"), C)
    assert skew > 1.5 * iid, (skew, iid)
    # a larger alpha is less skewed
    assert _max_class_share(labels, split_dirichlet(3, labels, W,
                                                    alpha=100.0), C) < skew
