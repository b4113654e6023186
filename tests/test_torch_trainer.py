"""The slice as a whole: the port's ``train`` against the JAX package's, with
the JAX run's random planes replayed — 50 rounds of the linear-regression
quickstart (exact solver, flip rule on), and 3 rounds of a small MLP with
prox-Adam and injected minibatches."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import AdmmConfig as JAdmmConfig  # noqa: E402
from repro.core import ChannelConfig as JChannelConfig  # noqa: E402
from repro.core import SubcarrierPlan as JSubcarrierPlan  # noqa: E402
from repro.core import make as jmake  # noqa: E402
from repro.data.synthetic import linreg_dataset as jlinreg  # noqa: E402
from repro.optim import exact_quadratic_solver as jexact  # noqa: E402
from repro.train import train as jtrain  # noqa: E402

from repro_torch import convert, rng  # noqa: E402
from repro_torch.core.admm import AdmmConfig  # noqa: E402
from repro_torch.core.aggregators import make  # noqa: E402
from repro_torch.core.channel import ChannelConfig  # noqa: E402
from repro_torch.core.subcarrier import SubcarrierPlan  # noqa: E402
from repro_torch.optim.local_solvers import exact_quadratic_solver  # noqa: E402
from repro_torch.train.fl_trainer import History, train  # noqa: E402

from test_torch_admm import (_mlp_jax_solver, _mlp_port_solver,  # noqa: E402
                             _mlp_problem, replay_draws, state_to_numpy)

#: solve and sum orders differ from XLA's and the errors add up over rounds
TOL = dict(rtol=1e-4, atol=1e-5)
W, D, ROUNDS = 10, 6, 50


def _quickstart_jax(key):
    X, y, _ = jlinreg(key, n_samples=2000, d=D)
    m = 2000 // W
    Xw = X[: m * W].reshape(W, m, D) / jnp.sqrt(m)
    yw = y[: m * W].reshape(W, m) / jnp.sqrt(m)
    theta_star = jnp.linalg.solve(X.T @ X, X.T @ y)
    f = lambda th: jnp.mean((y - X @ th) ** 2)  # noqa: E731
    f_star = f(theta_star)

    def grad_fn(theta):
        r = jnp.einsum("wmd,wd->wm", Xw, theta) - yw
        return 2.0 * jnp.einsum("wmd,wm->wd", Xw, r)

    acfg = JAdmmConfig(rho=0.5)
    ccfg = JChannelConfig(n_workers=W, n_subcarriers=10, snr_db=40.0)
    alg = jmake("afadmm", acfg, ccfg, JSubcarrierPlan.build(D, 10))
    return dict(X=X, y=y, Xw=Xw, yw=yw, grad_fn=grad_fn, alg=alg, ccfg=ccfg,
                solver=jexact(Xw, yw, acfg.rho),
                eval_fn=lambda T: {"loss": jnp.abs(f(T) - f_star)},
                theta0=jax.random.normal(key, (W, D)))


def _quickstart_port(q):
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    X, y, Xw, yw = (t(q[k]) for k in ("X", "y", "Xw", "yw"))
    f = lambda th: torch.mean((y - X @ th) ** 2)  # noqa: E731
    f_star = f(torch.linalg.solve(X.T @ X, X.T @ y))

    def grad_fn(theta):
        r = torch.einsum("wmd,wd->wm", Xw, theta) - yw
        return 2.0 * torch.einsum("wmd,wm->wd", Xw, r)

    alg = make("afadmm", AdmmConfig(rho=0.5),
               ChannelConfig(n_workers=W, n_subcarriers=10, snr_db=40.0),
               SubcarrierPlan.build(D, 10))
    return alg, exact_quadratic_solver(Xw, yw, 0.5), grad_fn, \
        (lambda T: {"loss": (f(T) - f_star).abs()})


def test_linreg_quickstart_50_rounds_matches_jax():
    key = jax.random.PRNGKey(0)
    q = _quickstart_jax(key)
    alg_j = q["alg"]
    step = jax.jit(lambda st, k: alg_j.round(k, st, q["solver"], q["grad_fn"]))
    st_j = alg_j.init(key, q["theta0"])
    st0 = state_to_numpy(st_j)
    thetas_j, draws = [], []
    for r in range(ROUNDS):
        kr = jax.random.fold_in(key, r + 1)
        draws.append(replay_draws(kr, st_j, q["ccfg"]))
        st_j, _ = step(st_j, kr)
        thetas_j.append(np.asarray(st_j.Theta))
    assert sum(d.h_fresh is not None for d in draws) == ROUNDS // 10
    hist_j = jtrain(alg_j, q["theta0"], q["solver"], q["grad_fn"], ROUNDS,
                    key, eval_fn=q["eval_fn"], driver="loop")

    alg, solver, grad_fn, eval_fn = _quickstart_port(q)
    thetas_p = []

    def eval_and_record(Theta):
        thetas_p.append(Theta.clone())
        return eval_fn(Theta)

    hist = train(alg, torch.from_numpy(np.array(q["theta0"])), solver,
                 grad_fn, ROUNDS, 0, eval_fn=eval_and_record,
                 init_state=convert.afadmm_state_from_numpy(st0,
                                                            device="cpu"),
                 draws=lambda r: draws[r])
    assert len(thetas_p) == ROUNDS
    for r, (a, b) in enumerate(zip(thetas_p, thetas_j)):
        np.testing.assert_allclose(a.numpy(), b, err_msg=f"round {r}", **TOL)
    assert hist.channel_uses == hist_j.channel_uses == [1.0] * ROUNDS
    # the optimality gap cancels to ~1e-6: compare it absolutely
    np.testing.assert_allclose(hist.loss, hist_j.loss, rtol=0, atol=1e-5)
    assert hist.loss[-1] < 1e-3 * hist.loss[0]


def test_mlp_three_rounds_match_jax():
    p = _mlp_problem()
    d = int(p["flat0"].shape[0])
    ccfg_j = JChannelConfig(n_workers=p["W"], n_subcarriers=32)
    acfg_j = JAdmmConfig(rho=0.5, flip_on_change=False)
    alg_j = jmake("afadmm", acfg_j, ccfg_j, JSubcarrierPlan.build(d, 32))
    key = jax.random.PRNGKey(9)
    st_j = alg_j.init(key, p["theta0"])
    st0 = state_to_numpy(st_j)
    idx = np.random.default_rng(11).integers(
        0, p["shards"].shape[1], (3,) + p["idx"].shape)
    thetas_j, draws = [], []
    for r in range(3):
        kr = jax.random.fold_in(key, r + 1)
        draws.append(replay_draws(kr, st_j, ccfg_j,
                                  batch_idx=torch.from_numpy(idx[r])))
        st_j, _ = alg_j.round(kr, st_j, _mlp_jax_solver(p, idx[r], 0.5), None)
        thetas_j.append(np.asarray(st_j.Theta))

    alg = make("afadmm", AdmmConfig(rho=0.5, flip_on_change=False),
               ChannelConfig(n_workers=p["W"], n_subcarriers=32),
               SubcarrierPlan.build(d, 32))
    thetas_p = []
    hist = train(alg, torch.from_numpy(np.array(p["theta0"])),
                 _mlp_port_solver(p, 0.5), None, 3, 0,
                 eval_fn=lambda T: thetas_p.append(T.clone()) or
                 {"loss": T.sum()},
                 init_state=convert.afadmm_state_from_numpy(st0,
                                                            device="cpu"),
                 draws=lambda r: draws[r])
    for a, b in zip(thetas_p, thetas_j):
        np.testing.assert_allclose(a.numpy(), b, **TOL)
    assert hist.channel_uses == [float(-(-d // 32))] * 3


def test_train_draws_its_own_planes_reproducibly():
    """Without replayed draws, round r draws from fold_in(key, r + 1): two
    runs with one key agree bitwise, another key gives another run."""
    q = _quickstart_jax(jax.random.PRNGKey(1))
    alg, solver, grad_fn, eval_fn = _quickstart_port(q)
    theta0 = torch.from_numpy(np.array(q["theta0"]))
    runs = [train(alg, theta0, solver, grad_fn, 12, key, eval_fn=eval_fn,
                  eval_every=5) for key in (3, 3, 4)]
    assert runs[0] == runs[1]
    assert runs[0].loss != runs[2].loss
    assert len(runs[0].loss) == 4              # rounds 0, 5, 10 and the last
    assert set(runs[0].extra) == {"primal_residual", "dual_residual",
                                  "inv_alpha"}
    assert runs[0].cumulative_uses() == [float(r + 1) for r in range(12)]


def test_round_key_schedule_is_the_jax_one():
    """Round r's key is fold_in(key, r + 1); the halves are split's folds."""
    assert rng.split(5) == (rng.fold_in(5, 0), rng.fold_in(5, 1))
    keys = {rng.fold_in(7, r + 1) for r in range(1000)}
    assert len(keys) == 1000 and rng.fold_in(7, 1) == rng.fold_in(7, 1)
    g1, g2 = rng.generator(11, "cpu"), rng.generator(11, "cpu")
    assert torch.equal(torch.randn(5, generator=g1),
                       torch.randn(5, generator=g2))


def test_history_defaults():
    h = History(channel_uses=[27.0, 27.0])
    assert h.cumulative_uses() == [27.0, 54.0] and h.loss == []
