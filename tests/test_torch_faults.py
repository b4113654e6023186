"""The port's fault injection and round health guards against the JAX
package's.

``FaultPlan``/``GuardConfig`` validation; ``draw`` on JAX's uniforms (masks
and flags exact); ``apply_uplink`` in the three corrupt modes and with
stragglers; ``commit``; ``guarded_ota_round`` for each policy on a healthy
slot, a NaN row, an Inf row and a burst, on JAX's noise, burst and retry
planes; 12 replayed rounds of the faulted linreg ``AFadmm``.  Port against
port: a healthy guarded round is the unguarded fused round, ``FaultPlan()``
is ``faults=None`` and a zero burst is no burst, bit for bit.  Last, the
chaos run at W = 8 under the reference's 10 % bar."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import faults as jfaults  # noqa: E402
from repro.core import make as jmake  # noqa: E402
from repro.core import power as jpower  # noqa: E402
from repro.core import transport as jt  # noqa: E402
from repro.core.channel import ChannelConfig as JChannelConfig  # noqa: E402
from repro.core.cplx import Complex as JComplex  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch import faults  # noqa: E402
from repro_torch.core import power, transport  # noqa: E402
from repro_torch.core.admm import AdmmConfig  # noqa: E402
from repro_torch.core.aggregators import make  # noqa: E402
from repro_torch.core.channel import ChannelConfig  # noqa: E402
from repro_torch.core.cplx import Complex  # noqa: E402
from repro_torch.core.subcarrier import SubcarrierPlan  # noqa: E402
from repro_torch.faults import FaultPlan, GuardConfig  # noqa: E402
from repro_torch.faults.guards import (BURST_SALT, RETRY_SALT,  # noqa: E402
                                       GuardDraws, guarded_ota_round)
from repro_torch.faults.plan import FAULT_SALT, FaultDraws  # noqa: E402

from helpers import default_cfgs, make_linreg, make_solver  # noqa: E402
from test_torch_admm import _linreg_port, replay_draws  # noqa: E402
from test_torch_admm import state_to_numpy  # noqa: E402

KEY = jax.random.PRNGKey(0)
RHO = 0.7
#: the guard's Θ: the fused round's sums in another order than XLA's
TOL = dict(rtol=1e-5, atol=1e-6)
#: replayed rounds: solve and sum orders add up over rounds (slice 2's)
REPLAY_TOL = dict(rtol=1e-4, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# FaultPlan / GuardConfig / draw / apply_uplink / commit
# ---------------------------------------------------------------------------

def test_fault_plan_validation():
    with pytest.raises(ValueError, match="corrupt_mode"):
        FaultPlan(corrupt_mode="zalgo")
    with pytest.raises(ValueError, match="straggler_delay"):
        FaultPlan(straggler_prob=0.1, straggler_delay=0)
    assert FaultPlan(nan_workers=1).has_corruption
    assert not FaultPlan().has_bursts and not FaultPlan().has_stragglers


def test_guard_config_validation():
    with pytest.raises(ValueError, match="policy"):
        GuardConfig(policy="pray")
    with pytest.raises(ValueError, match="max_retries"):
        GuardConfig(max_retries=-1)
    assert GuardConfig(policy="evict").evicts
    assert GuardConfig(policy="evict").retries == 0
    assert GuardConfig(policy="retransmit", max_retries=3).retries == 3
    assert GuardConfig(policy="evict-retransmit").retries == 2
    assert not GuardConfig(policy="skip").evicts


def jax_uniforms(plan, key, W) -> FaultDraws:
    """The uniforms JAX's ``faults.draw(plan, key, st)`` reads, as torch."""
    kc, ks, kx, kb = jax.random.split(jax.random.fold_in(key, FAULT_SALT), 4)
    u = lambda k, s: _t(jax.random.uniform(k, s))  # noqa: E731
    return FaultDraws(
        crash=u(kc, (W,)) if plan.crash_prob > 0 else None,
        straggler=u(ks, (W,)) if plan.straggler_prob > 0 else None,
        corrupt=u(kx, (W,)) if (plan.corrupt_prob > 0
                                or plan.nan_workers > 0) else None,
        burst=u(kb, ()) if plan.burst_prob > 0 else None)


_PLANS = [
    dict(crash_prob=0.5, max_crash_frac=1.0),
    dict(crash_prob=0.3, crash_start=5, max_crash_frac=0.25),
    dict(crash_at=((2, 1), (4, 3), (4, 9))),
    dict(straggler_prob=0.4, straggler_delay=3, corrupt_prob=0.2,
         nan_workers=1, burst_prob=0.5, burst_std=3.0),
]


@pytest.mark.parametrize("kw", _PLANS, ids=[str(i) for i in range(4)])
def test_draw_on_jax_uniforms_matches_jax(kw):
    """40 rounds: liveness, flags, burst and metrics exactly JAX's."""
    W = 8
    jplan, plan = jfaults.FaultPlan(**kw), FaultPlan(**kw)
    st_j, st = jfaults.init(jplan, W, 4), faults.init(plan, W, 4, "cpu")
    for r in range(40):
        k = jax.random.fold_in(KEY, r)
        rf_j, st_j, m_j = jfaults.draw(jplan, k, st_j)
        rf, st, m = faults.draw(plan, st, jax_uniforms(plan, k, W))
        np.testing.assert_array_equal(rf.alive.numpy(), np.asarray(rf_j.alive))
        for f in ("straggler", "corrupt"):
            a, b = getattr(rf, f), getattr(rf_j, f)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        if rf.snapshot_due is not None:
            assert rf.snapshot_due == bool(rf_j.snapshot_due)
        if rf.burst_std is not None:
            assert float(rf.burst_std) == float(rf_j.burst_std)
        assert st.round == int(st_j.round)
        assert {k: float(v) for k, v in m.items()} == \
            {k: float(v) for k, v in m_j.items()}
        assert bool(st.alive.any())


@pytest.mark.parametrize("mode", ["nan", "inf", "spike"])
def test_apply_uplink_matches_jax(mode):
    W, d = 5, 6
    kw = dict(nan_workers=1, corrupt_prob=0.3, corrupt_mode=mode,
              spike_gain=100.0, straggler_prob=0.5, straggler_delay=2)
    jplan, plan = jfaults.FaultPlan(**kw), FaultPlan(**kw)
    st_j, st = jfaults.init(jplan, W, d), faults.init(plan, W, d, "cpu")
    g = np.random.default_rng(1)
    for r in range(5):
        theta = g.standard_normal((W, d)).astype(np.float32)
        k = jax.random.fold_in(KEY, r + 3)
        rf_j, mid_j, _ = jfaults.draw(jplan, k, st_j)
        rf, mid, _ = faults.draw(plan, st, jax_uniforms(plan, k, W))
        tx_j, stale_j = jfaults.apply_uplink(jplan, rf_j, jnp.asarray(theta),
                                             st_j.stale)
        tx, stale = faults.apply_uplink(plan, rf, _t(theta), st.stale)
        np.testing.assert_array_equal(tx.numpy(), np.asarray(tx_j))
        np.testing.assert_array_equal(stale.numpy(), np.asarray(stale_j))
        st_j = jfaults.commit(mid_j, stale_j, None)
        st = faults.commit(mid, stale, None)
    assert not torch.equal(tx[0], _t(theta)[0])     # worker 0 corrupts always


def test_straggler_without_buffer_raises():
    plan = FaultPlan(straggler_prob=1.0)
    rf, _, _ = faults.draw(plan, faults.init(plan, 3, 5, "cpu"),
                           FaultDraws(straggler=torch.zeros(3)))
    with pytest.raises(ValueError, match="stale"):
        faults.apply_uplink(plan, rf, torch.ones(3, 5), None)
    with pytest.raises(ValueError, match="straggler"):
        faults.draw(plan, faults.init(plan, 3, 5, "cpu"), FaultDraws())


def test_commit_eviction_accounting():
    st = faults.init(FaultPlan(), 4, 2, "cpu")
    ev = torch.tensor([True, False, False, True])
    st2 = faults.commit(st, None, ev)
    assert int(st2.n_evicted) == 2 and st2.n_evicted.dtype == torch.int32
    assert st2.alive.tolist() == [False, True, True, False]
    st3 = faults.commit(st2, None, ev)       # never counted twice
    assert int(st3.n_evicted) == 2 and torch.equal(st3.alive, st2.alive)


@pytest.mark.parametrize("attempt", [0, 1, 2, 3])
def test_retry_power_budget_matches_jax(attempt):
    got = power.retry_power_budget(0.15 * 97, attempt, 2.0)
    want = jpower.retry_power_budget(0.15 * 97, attempt, 2.0)
    assert np.float32(got) == np.float32(want)
    assert power.retry_power_budget(0.15 * 97, 0, 2.0) == 0.15 * 97


# ---------------------------------------------------------------------------
# the guarded round, each policy, on JAX's planes
# ---------------------------------------------------------------------------

def _flat_problem(W, d, seed):
    g = np.random.default_rng(seed)
    f = lambda: g.standard_normal((W, d)).astype(np.float32)  # noqa: E731
    s = np.float32(np.sqrt(0.5))
    return f(), (s * f(), s * f()), (s * f(), s * f())


def guard_draws(gcfg, kn, d, ccfg_j, burst: bool) -> GuardDraws:
    """The guard planes JAX's ``guarded_ota_round(key=kn)`` draws."""
    b = None
    if burst:
        b = _t(jax.random.normal(jax.random.fold_in(kn, BURST_SALT), (d,),
                                 jnp.float32))
    retry = tuple(_t(jt.matched_filter_noise_re(
        jax.random.fold_in(kn, RETRY_SALT + a), (d,), ccfg_j))
        for a in range(1, gcfg.retries + 1))
    return GuardDraws(burst=b, retry_noise=retry)


_CASES = {
    "healthy": dict(floor=-60.0, row=None, burst=None),
    "nan-row": dict(floor=None, row=("nan", 1), burst=None),
    "inf-row": dict(floor=None, row=("inf", 0), burst=None),
    "burst": dict(floor=0.0, row=None, burst=5.0),
}


@pytest.mark.parametrize("policy", ["skip", "retransmit", "evict",
                                    "evict-retransmit"])
@pytest.mark.parametrize("case", list(_CASES))
def test_guarded_round_matches_jax(policy, case):
    W, d = 4, 97
    c = _CASES[case]
    theta, lam, h = _flat_problem(W, d, 4)
    if c["row"] is not None:
        theta[c["row"][1]] = float(c["row"][0])
    gcfg_kw = dict(policy=policy, snr_floor_db=c["floor"], max_retries=2)
    ccfg_j = JChannelConfig(n_workers=W, noisy=True, snr_db=20.0)
    ccfg = ChannelConfig(n_workers=W, noisy=True, snr_db=20.0)
    burst = None if c["burst"] is None else jnp.float32(c["burst"])
    g_j = jax.jit(lambda t: jfaults.guarded_ota_round(
        t, JComplex(*map(jnp.asarray, lam)), JComplex(*map(jnp.asarray, h)),
        KEY, RHO, ccfg_j, jfaults.GuardConfig(**gcfg_kw), backend="jnp",
        burst_std=burst))(jnp.asarray(theta))
    gcfg = GuardConfig(**gcfg_kw)
    g = guarded_ota_round(
        _t(theta), Complex(*map(_t, lam)), Complex(*map(_t, h)),
        _t(jt.matched_filter_noise_re(KEY, (d,), ccfg_j)), RHO, ccfg, gcfg,
        burst_std=None if burst is None else torch.tensor(c["burst"]),
        draws=guard_draws(gcfg, KEY, d, ccfg_j, burst is not None))
    assert bool(g.healthy) == bool(g_j.healthy)
    np.testing.assert_array_equal(g.evicted.numpy(), np.asarray(g_j.evicted))
    for k in ("guard/retries", "guard/ok_first", "guard/healthy",
              "guard/evicted"):
        assert float(g.metrics[k]) == float(g_j.metrics[k]), k
    np.testing.assert_allclose(float(g.metrics["guard/snr_db"]),
                               float(g_j.metrics["guard/snr_db"]), rtol=1e-4)
    np.testing.assert_allclose(g.Theta.numpy(), np.asarray(g_j.Theta),
                               equal_nan=True, **TOL)
    np.testing.assert_allclose(float(g.inv_alpha), float(g_j.inv_alpha),
                               rtol=1e-5)
    if case == "burst" and "retransmit" in policy:
        assert float(g.metrics["guard/retries"]) >= 1 and bool(g.healthy)
    if case == "nan-row" and policy == "retransmit":
        assert float(g.metrics["guard/retries"]) == 2 and not bool(g.healthy)
    if case == "nan-row" and "evict" in policy:
        assert g.evicted.tolist() == [False, True, False, False]


@pytest.mark.parametrize("masked,csi", [(False, False), (True, True)])
def test_healthy_guarded_round_is_the_unguarded_fused_round(masked, csi):
    """Port against port, bit for bit: the guard only adds its checks."""
    W, d = 5, 113
    theta, lam, h = _flat_problem(W, d, 5)
    _, h_hat, _ = _flat_problem(W, d, 6)
    ccfg = ChannelConfig(n_workers=W, noisy=True, snr_db=20.0)
    noise = torch.randn(d, generator=torch.Generator().manual_seed(1)) * 7e-4
    kw = dict(mask=torch.tensor([True, True, False, True, True])
              if masked else None,
              h_tx=Complex(*map(_t, h_hat)) if csi else None)
    args = (_t(theta), Complex(*map(_t, lam)), Complex(*map(_t, h)), noise,
            RHO, ccfg)
    T0, ia0, _ = transport.ota_round_fused(*args, **kw)
    gcfg = GuardConfig(policy="evict-retransmit", snr_floor_db=-60.0)
    g = guarded_ota_round(*args, gcfg, draws=GuardDraws(
        retry_noise=(noise * 2, noise * 3)), **kw)
    assert bool(g.healthy) and float(g.metrics["guard/retries"]) == 0.0
    assert torch.equal(g.Theta, T0) and torch.equal(g.inv_alpha, ia0)


def test_zero_burst_is_no_burst_bitwise():
    W, d = 4, 97
    theta, lam, h = _flat_problem(W, d, 7)
    ccfg = ChannelConfig(n_workers=W, noisy=True, snr_db=20.0)
    noise = torch.randn(d, generator=torch.Generator().manual_seed(2)) * 7e-4
    args = (_t(theta), Complex(*map(_t, lam)), Complex(*map(_t, h)), noise,
            RHO, ccfg, GuardConfig(policy="skip"))
    g0 = guarded_ota_round(*args)
    g1 = guarded_ota_round(*args, burst_std=torch.tensor(0.0),
                           draws=GuardDraws(burst=torch.randn(d)))
    assert torch.equal(g0.Theta, g1.Theta)
    assert torch.equal(g0.inv_alpha, g1.inv_alpha)


def test_guard_refuses_missing_planes():
    W, d = 3, 10
    theta, lam, h = _flat_problem(W, d, 8)
    args = (_t(theta), Complex(*map(_t, lam)), Complex(*map(_t, h)),
            torch.zeros(d), RHO, ChannelConfig(n_workers=W))
    with pytest.raises(ValueError, match="retry noise"):
        guarded_ota_round(*args, GuardConfig(policy="retransmit"))
    with pytest.raises(ValueError, match="burst"):
        guarded_ota_round(*args, GuardConfig(), burst_std=torch.tensor(1.0))


# ---------------------------------------------------------------------------
# AFadmm under faults and a guard: 12 replayed rounds
# ---------------------------------------------------------------------------

_FAULTED = dict(crash_at=((5, 4),), straggler_prob=0.3, straggler_delay=2,
                nan_workers=1, burst_prob=0.3, burst_std=5.0)
_GUARD = dict(policy="evict-retransmit", snr_floor_db=-60.0, max_retries=2)


def fault_to_numpy(flt) -> dict:
    return {"alive": np.asarray(flt.alive),
            "stale": None if flt.stale is None else np.asarray(flt.stale),
            "round": np.asarray(flt.round),
            "n_evicted": np.asarray(flt.n_evicted)}


def replay_faulted(key, st_j, alg_j):
    """Every plane JAX's faulted, guarded ``AFadmm.round(key, st_j)`` draws."""
    ccfg_j = alg_j.ccfg
    _, kn = jax.random.split(key)
    d = st_j.Theta.shape[0]
    base = replay_draws(key, st_j, ccfg_j)
    gcfg = GuardConfig(**_GUARD)
    return base._replace(
        faults=jax_uniforms(alg_j.faults, jax.random.fold_in(key, FAULT_SALT),
                            st_j.theta.shape[0]),
        guard=guard_draws(gcfg, kn, d, ccfg_j, alg_j.faults.burst_prob > 0))


def _faulted_algs(W, d):
    acfg_j, ccfg_j, plan_j = default_cfgs(W, d, noisy=True, snr_db=30.0,
                                          power_control=True, flip=False)
    alg_j = jmake("afadmm", acfg_j, ccfg_j, plan_j,
                  faults=jfaults.FaultPlan(**_FAULTED),
                  guard=jfaults.GuardConfig(**_GUARD))
    ccfg = ChannelConfig(n_workers=W, n_subcarriers=d, snr_db=30.0,
                         noisy=True)
    alg = make("afadmm", AdmmConfig(rho=0.5, flip_on_change=False), ccfg,
               SubcarrierPlan.build(d, d), faults=FaultPlan(**_FAULTED),
               guard=GuardConfig(**_GUARD))
    return alg_j, alg


def test_faulted_afadmm_12_rounds_match_jax():
    prob = make_linreg(KEY, W=6)
    alg_j, alg = _faulted_algs(6, prob["d"])
    solver_j = make_solver(prob, 0.5)
    solver, grad_fn = _linreg_port(prob, 0.5)
    step = jax.jit(lambda st, k: alg_j.round(k, st, solver_j,
                                             prob["grad_fn"]))
    st_j = alg_j.init(KEY, prob["theta0"])
    leaves = dict(state_to_numpy(st_j), flt=fault_to_numpy(st_j.flt))
    st = convert.afadmm_state_from_numpy(leaves, device="cpu")
    retries = 0.0
    for r in range(12):
        k = jax.random.fold_in(KEY, r + 1)
        draws = replay_faulted(k, st_j, alg_j)
        st_j, m_j = step(st_j, k)
        st, m = alg.round(0, st, solver, grad_fn, draws=draws)
        msg = f"round {r}"
        for a, b in ((st.theta, st_j.theta), (st.Theta, st_j.Theta),
                     (st.lam.re, st_j.lam.re), (st.lam.im, st_j.lam.im),
                     (st.flt.stale, st_j.flt.stale)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=msg,
                                       **REPLAY_TOL)
        np.testing.assert_array_equal(st.flt.alive.numpy(),
                                      np.asarray(st_j.flt.alive), err_msg=msg)
        assert int(st.flt.n_evicted) == int(st_j.flt.n_evicted), msg
        assert st.flt.round == int(st_j.flt.round)
        for key in ("guard/evicted", "guard/healthy", "guard/ok_first",
                    "guard/retries", "fault/alive", "fault/burst"):
            assert float(m[key]) == float(m_j[key]), (msg, key)
        for key in ("inv_alpha", "primal_residual", "dual_residual"):
            np.testing.assert_allclose(float(m[key]), float(m_j[key]),
                                       err_msg=msg, **REPLAY_TOL)
        retries += float(m["guard/retries"])
    assert not bool(st.flt.alive[0]) and not bool(st.flt.alive[4])
    assert int(st.flt.n_evicted) >= 1
    assert torch.equal(st.lam.re[0], torch.zeros(prob["d"]))


def test_all_zero_fault_plan_is_no_faults_bitwise():
    """The fault key is a fold_in side branch: FaultPlan() draws nothing the
    fault-free round draws, so 6 rounds agree bit for bit."""
    prob = make_linreg(KEY, W=4)
    solver, grad_fn = _linreg_port(prob, 0.5)
    ccfg = ChannelConfig(n_workers=4, n_subcarriers=prob["d"], snr_db=30.0)
    plan = SubcarrierPlan.build(prob["d"], prob["d"])
    acfg = AdmmConfig(rho=0.5, flip_on_change=False)
    base = make("afadmm", acfg, ccfg, plan)
    nul = make("afadmm", acfg, ccfg, plan, faults=FaultPlan())
    theta0 = _t(prob["theta0"])
    st_a, st_b = base.init(3, theta0), nul.init(3, theta0)
    for r in range(6):
        st_a, _ = base.round(r + 10, st_a, solver, grad_fn)
        st_b, m = nul.round(r + 10, st_b, solver, grad_fn)
    assert torch.equal(st_a.Theta, st_b.Theta)
    assert torch.equal(st_a.lam.re, st_b.lam.re)
    assert float(m["fault/alive"]) == 4.0 and st_b.flt.round == 6


def test_fault_state_from_numpy_checks_its_leaves():
    st = jfaults.init(jfaults.FaultPlan(straggler_prob=0.1), 3, 4)
    got = convert.fault_state_from_numpy(fault_to_numpy(st), device="cpu")
    assert got.stale.shape == (3, 4) and got.round == 0
    assert got.alive.dtype == torch.bool
    with pytest.raises(KeyError, match="missing"):
        convert.fault_state_from_numpy({"alive": np.ones(3, bool)},
                                       device="cpu")
    with pytest.raises(KeyError, match="unknown"):
        convert.fault_state_from_numpy(dict(fault_to_numpy(st), x=1),
                                       device="cpu")


# ---------------------------------------------------------------------------
# chaos acceptance at W = 8, in the port
# ---------------------------------------------------------------------------

def test_chaos_within_10pct_of_fault_free():
    """25 % of the workers crash, a persistent NaN worker is evicted, bursts
    force retransmissions — and the final loss stays within 10 % of the
    fault-free run's (the reference's bar), on the port's own draws."""
    from repro_torch.data.synthetic import image_dataset
    from repro_torch.models.mlp import init_mlp_flat, make_loss_fns
    from repro_torch.optim.local_solvers import prox_adam_solver
    from repro_torch.optim.optimizers import adam
    from repro_torch.phy import make_scenario
    from repro_torch.train.fl_trainer import train

    W, dim, sizes = 8, 32, (32, 16, 10)
    key = 77
    xtr, ytr, xte, yte = image_dataset(key, 1024, 256, dim=dim,
                                       cluster_std=3.0, device="cpu")
    flat0, unflatten = init_mlp_flat(key + 2, sizes, device="cpu")
    d = flat0.numel()
    loss, grad, _ = make_loss_fns(unflatten)
    xw, yw = xtr.reshape(W, -1, dim), ytr.reshape(W, -1)
    solver = prox_adam_solver(lambda th: grad(th, xw, yw), adam(0.01), 5,
                              0.5)
    theta0 = flat0[None] + 0.01 * torch.randn(
        (W, d), generator=torch.Generator().manual_seed(key))
    ccfg = ChannelConfig(n_workers=W, n_subcarriers=256, snr_db=40.0)

    def run(fp, gc):
        alg = make("afadmm", AdmmConfig(rho=0.5, flip_on_change=False), ccfg,
                   SubcarrierPlan.build(d, 256),
                   scenario=make_scenario("markov-doppler", ccfg),
                   faults=fp, guard=gc)
        return train(alg, theta0, solver, None, 20, key,
                     eval_fn=lambda T: {"loss": loss(T[None], xte[None],
                                                     yte[None])[0]},
                     eval_every=50)

    h0 = run(None, None)
    h1 = run(FaultPlan(crash_at=((6, 6), (12, 7)), nan_workers=1,
                       burst_prob=0.4, burst_std=5.0),
             GuardConfig(policy="evict-retransmit", snr_floor_db=0.0,
                         max_retries=2))
    f0, f1 = h0.loss[-1], h1.loss[-1]
    assert np.isfinite(f1)
    assert f1 <= 1.10 * f0 + 1e-8, (f0, f1)
    assert f1 < h1.loss[0]
    assert sum(h1.extra["guard/retries"]) > 0, "no retransmission fired"
    assert sum(h1.extra["guard/evicted"]) >= 1, "NaN worker not evicted"
    assert h1.extra["fault/alive"][-1] == 5.0   # 8 − 2 crashed − 1 evicted
