"""The port's wireless-scenario round against the JAX package's.

``Scenario.step`` for every preset leaf by leaf (masks equal), the masked
uplink, one ``afadmm_round`` with a mask and imperfect CSI started from the
JAX state, the degenerate all-masked round, frozen duals under the flip
rule, and 30 replayed trainer rounds under ``deep-fade-truncation`` and
``markov-doppler`` with imperfect CSI.  JAX's draws are replayed through
``PhyDraws``/``RoundDraws``.  Port-against-port pins: ``block-fading`` is
the legacy channel bit for bit, ``static-iid`` never redraws, and
``changed`` is false under AR(1) mixing."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cplx as jcplx  # noqa: E402
from repro.core import make as jmake  # noqa: E402
from repro.core import transport as jt  # noqa: E402
from repro.core.channel import ChannelConfig as JChannelConfig  # noqa: E402
from repro.core.channel import awgn as jawgn  # noqa: E402
from repro.core.channel import matched_filter_noise  # noqa: E402
from repro.core.channel import rayleigh as jrayleigh  # noqa: E402
from repro.phy import geometry as jgeo  # noqa: E402
from repro.phy import make_scenario as jmake_scenario  # noqa: E402
from repro.train import train as jtrain  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import transport  # noqa: E402
from repro_torch.core.admm import AdmmConfig, RoundDraws  # noqa: E402
from repro_torch.core.aggregators import make  # noqa: E402
from repro_torch.core.channel import ChannelConfig  # noqa: E402
from repro_torch.core.cplx import Complex  # noqa: E402
from repro_torch.core.subcarrier import SubcarrierPlan  # noqa: E402
from repro_torch.phy import PhyDraws, h_tx, make_scenario  # noqa: E402
from repro_torch.train.fl_trainer import train  # noqa: E402

from helpers import default_cfgs, make_linreg, make_solver  # noqa: E402
from test_torch_admm import _linreg_port, state_to_numpy  # noqa: E402
from test_torch_trainer import _quickstart_jax, _quickstart_port  # noqa: E402

KEY = jax.random.PRNGKey(0)
#: solve and sum orders differ from XLA's and the errors add up over rounds
TOL = dict(rtol=1e-4, atol=1e-5)
#: one scenario step: the same f32 expressions (exp/log against pow in the
#: frequency-flat population kernel's path gain)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _c(z):
    return None if z is None else Complex(_t(z.re), _t(z.im))


def phy_to_numpy(ps) -> dict:
    """The JAX ``PhyState`` leaves under ``convert.PHY_KEYS``."""
    d = {"h_re": ps.h.re, "h_im": ps.h.im, "age": ps.age, "gain": ps.gain,
         "shadow": ps.shadow, "pos": ps.pos, "dest": ps.dest,
         "mask": ps.mask}
    for k in ("h_small", "h_hat"):
        z = getattr(ps, k)
        if z is not None:
            d[f"{k}_re"], d[f"{k}_im"] = z.re, z.im
    return {k: None if v is None else np.asarray(v) for k, v in d.items()}


def afadmm_to_numpy(st) -> dict:
    out = state_to_numpy(st)
    if st.phys is not None:
        out["phys"] = phy_to_numpy(st.phys)
    return out


def replay_phy(scn, key, ps) -> PhyDraws:
    """The planes JAX's ``scn.step(key, ps)`` draws, as torch."""
    cfg = scn.cfg
    if cfg.coherence_iters >= 1 << 30 and scn._plain_fading \
            and not scn.mobile:
        return PhyDraws()
    kf, kg, kc = scn._keys(key)
    h_small = ps.h if ps.h_small is None else ps.h_small
    w = dest_fresh = shadow_fresh = e = None
    if int(ps.age) + 1 >= cfg.coherence_iters:
        w = _c(jrayleigh(kf, h_small.re.shape))
    if scn.mobile:
        n = ps.pos.shape[0]
        dest_fresh = _t(jgeo.uniform_disk(kg, n, cfg.geometry.cell_radius_m))
        if cfg.geometry.shadowing_sigma_db > 0.0:
            shadow_fresh = _t(jgeo.shadowing(
                jax.random.fold_in(kg, jgeo.SHADOW_SALT), n, cfg.geometry))
    if scn.imperfect_csi:
        W, d = ps.h.re.shape
        e = _c(jawgn(kc, (W, 1) if cfg.freq_flat else (W, d),
                     cfg.csi_err ** 2))
    return PhyDraws(w=w, dest_fresh=dest_fresh, shadow_fresh=shadow_fresh,
                    csi_err=e)


def replay_round(key, st, alg_j) -> RoundDraws:
    """The planes JAX's ``AFadmm.round(key, st, ...)`` draws under its
    scenario, as torch."""
    kc, kn = jax.random.split(key)
    noise = matched_filter_noise(kn, st.Theta.shape, alg_j.ccfg)
    return RoundDraws(h_fresh=None, noise_re=_t(noise.re),
                      phy=replay_phy(alg_j.scenario, kc, st.phys))


def _assert_phy_close(p, j, tol=STEP_TOL):
    for name in ("h", "h_small", "h_hat"):
        a, b = getattr(p, name), getattr(j, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_allclose(a.re.numpy(), np.asarray(b.re),
                                       err_msg=name, **tol)
            np.testing.assert_allclose(a.im.numpy(), np.asarray(b.im),
                                       err_msg=name, **tol)
    for name in ("gain", "shadow", "pos", "dest"):
        a, b = getattr(p, name), getattr(j, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       err_msg=name, **tol)
    assert (p.mask is None) == (j.mask is None)
    if p.mask is not None:
        np.testing.assert_array_equal(p.mask.numpy(), np.asarray(j.mask))
    assert p.age == int(j.age)


# ---------------------------------------------------------------------------
# Scenario.step, leaf by leaf
# ---------------------------------------------------------------------------

_STEP_CASES = [
    ("static-iid", {}), ("block-fading", {}), ("markov-doppler", {}),
    ("urban-mobility", {}), ("deep-fade-truncation", {}),
    ("markov-doppler", dict(csi_err=0.3, h_min=0.8)),
    ("urban-mobility", dict(freq_flat=True, h_min=0.4, csi_err=0.1,
                            slots_per_round=2000)),
    ("deep-fade-truncation", dict(csi_err=0.2)),
]


@pytest.mark.parametrize("name,kw", _STEP_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(_STEP_CASES)])
def test_scenario_step_matches_jax(name, kw):
    """Five steps from JAX's ``Scenario.init`` state: every leaf close,
    masks equal.  block-fading at coherence 3 holds, then redraws."""
    W, d = 6, 37
    ccfg_j = JChannelConfig(n_workers=W, coherence_iters=3)
    ccfg_p = ChannelConfig(n_workers=W, coherence_iters=3)
    scn_j = jmake_scenario(name, ccfg_j, **kw)
    scn_p = make_scenario(name, ccfg_p, **kw)
    st_j = scn_j.init(KEY, W, d)
    st_p = convert.phy_state_from_numpy(phy_to_numpy(st_j), device="cpu")
    _assert_phy_close(st_p, st_j)
    for r in range(5):
        k = jax.random.fold_in(KEY, r + 1)
        draws = replay_phy(scn_j, k, st_j)
        st_j = scn_j.step(k, st_j)
        st_p = scn_p.step(st_p, draws)
        _assert_phy_close(st_p, st_j)
        assert scn_p.changed(st_p) == bool(scn_j.changed(st_j))


def test_port_scenario_init_and_draw_shapes():
    """The port's own ``init``/``draw`` give the state and draws that the
    JAX layout has, on the asked device."""
    W, d = 5, 12
    for name, kw in _STEP_CASES:
        scn = make_scenario(name, ChannelConfig(n_workers=W), **kw)
        st = scn.init(7, W, d, "cpu")
        assert h_tx(st) is (st.h if st.h_hat is None else st.h_hat)
        ref = jmake_scenario(name, JChannelConfig(n_workers=W), **kw).init(
            KEY, W, d)
        for f in ("h_small", "h_hat", "gain", "pos", "mask"):
            assert (getattr(st, f) is None) == (getattr(ref, f) is None), f
        assert st.h.re.shape == (W, d) and st.age == 0
        dr = scn.draw(8, st)
        assert (dr.csi_err is None) == (not scn.imperfect_csi)
        assert (dr.dest_fresh is None) == (not scn.mobile)
        st2 = scn.step(st, dr)
        assert st2.h.re.shape == (W, d)
        assert bool(torch.isfinite(st2.h.re).all())


# ---------------------------------------------------------------------------
# the masked transport
# ---------------------------------------------------------------------------

def _problem(W, d, seed):
    g = np.random.default_rng(seed)
    f = lambda *s: g.standard_normal(s).astype(np.float32)  # noqa: E731
    s = np.sqrt(0.5, dtype=np.float32)
    return f(W, d), (0.3 * f(W, d), 0.3 * f(W, d)), (s * f(W, d), s * f(W, d))


def test_masked_uplink_equals_active_subset_and_jax():
    """Masked workers contribute exactly zero: the masked W-worker uplink is
    the unmasked uplink of the active subset (same noise), and JAX's."""
    W, d = 6, 1037
    theta, lam, h = _problem(W, d, 1)
    mask = np.array([True, False, True, True, False, True])
    ccfg_j = JChannelConfig(n_workers=W, noisy=True, snr_db=20.0)
    kn = jax.random.fold_in(KEY, 9)
    noise = _t(matched_filter_noise(kn, (d,), ccfg_j).re)
    P = lambda x: _t(x)  # noqa: E731
    T_m, ia_m = transport.ota_uplink(
        P(theta), Complex(P(lam[0]), P(lam[1])), Complex(P(h[0]), P(h[1])),
        noise, 0.5, ChannelConfig(n_workers=W, noisy=True, snr_db=20.0),
        mask=P(mask))
    idx = np.flatnonzero(mask)
    T_s, ia_s = transport.ota_uplink(
        P(theta[idx]), Complex(P(lam[0][idx]), P(lam[1][idx])),
        Complex(P(h[0][idx]), P(h[1][idx])), noise, 0.5,
        ChannelConfig(n_workers=len(idx), noisy=True, snr_db=20.0))
    np.testing.assert_allclose(T_m.numpy(), T_s.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert float(ia_m) == pytest.approx(float(ia_s), rel=1e-6)
    T_j, ia_j = jt.ota_uplink(jnp.asarray(theta), jcplx.Complex(*lam),
                              jcplx.Complex(*h), kn, 0.5, ccfg_j,
                              mask=jnp.asarray(mask), backend="jnp")
    np.testing.assert_allclose(T_m.numpy(), np.asarray(T_j), rtol=1e-5,
                               atol=1e-6)
    assert float(ia_m) == pytest.approx(float(ia_j), rel=1e-5)


def test_masked_uplink_with_csi_matches_jax_and_ignores_garbage():
    """h_tx modulates, h superposes; a dropped worker's NaN/Inf stays out."""
    W, d = 5, 301
    theta, lam, h = _problem(W, d, 2)
    _, _, h_hat = _problem(W, d, 3)
    theta[1] = np.nan
    h[0][1] = np.inf
    mask = np.array([True, False, True, True, True])
    ccfg_j = JChannelConfig(n_workers=W, noisy=True, snr_db=20.0)
    T_j, ia_j = jt.ota_uplink(jnp.asarray(theta), jcplx.Complex(*lam),
                              jcplx.Complex(*h), KEY, 0.5, ccfg_j,
                              mask=jnp.asarray(mask),
                              h_tx=jcplx.Complex(*h_hat), backend="jnp")
    noise = _t(matched_filter_noise(KEY, (d,), ccfg_j).re)
    T_p, ia_p = transport.ota_uplink(
        _t(theta), Complex(_t(lam[0]), _t(lam[1])),
        Complex(_t(h[0]), _t(h[1])), noise, 0.5,
        ChannelConfig(n_workers=W, noisy=True, snr_db=20.0), mask=_t(mask),
        h_tx=Complex(_t(h_hat[0]), _t(h_hat[1])))
    assert bool(torch.isfinite(T_p).all()) and bool(torch.isfinite(ia_p))
    np.testing.assert_allclose(T_p.numpy(), np.asarray(T_j), rtol=1e-5,
                               atol=1e-6)
    assert float(ia_p) == pytest.approx(float(ia_j), rel=1e-5)


def test_min_alpha_over_active_workers_only():
    e = torch.tensor([100.0, 2.0, 1.0, 3.0])
    ia_all = transport.inv_alpha_from_energy(e, 1.0)
    ia_masked = transport.inv_alpha_from_energy(
        e, 1.0, mask=torch.tensor([False, True, True, True]))
    assert float(ia_masked) == float(transport.inv_alpha_from_energy(
        e[1:], 1.0)) < float(ia_all)
    assert float(ia_masked) == pytest.approx(float(jt.inv_alpha_from_energy(
        jnp.asarray(e.numpy()), 1.0,
        mask=jnp.asarray([False, True, True, True]))), rel=1e-7)
    assert float(transport.inv_alpha_from_energy(
        e, 1.0, mask=torch.zeros(4, dtype=torch.bool))) == 0.0


# ---------------------------------------------------------------------------
# one round, from JAX's state
# ---------------------------------------------------------------------------

def _linreg_algs(name, flip=False, **kw):
    prob = make_linreg(KEY)
    acfg_j, ccfg_j, plan_j = default_cfgs(prob["W"], prob["d"], noisy=True,
                                          snr_db=30.0, flip=flip,
                                          power_control=True)
    alg_j = jmake("afadmm", acfg_j, ccfg_j, plan_j,
                  scenario=jmake_scenario(name, ccfg_j, **kw))
    ccfg = ChannelConfig(n_workers=prob["W"], n_subcarriers=prob["d"],
                         snr_db=30.0, noisy=True)
    alg = make("afadmm", AdmmConfig(rho=0.5, flip_on_change=flip), ccfg,
               SubcarrierPlan.build(prob["d"], prob["d"]),
               scenario=make_scenario(name, ccfg, **kw))
    return prob, alg_j, alg


@pytest.mark.parametrize("name,kw", [
    ("deep-fade-truncation", dict(csi_err=0.2)),
    ("markov-doppler", dict(csi_err=0.3, h_min=0.7)),
    ("urban-mobility", dict(freq_flat=True, h_min=0.3))])
def test_first_round_from_jax_init_matches_jax(name, kw):
    """The port starts from JAX's ``AFadmm.init`` state (``Scenario.init``
    included) and its first round equals JAX's: mask, h_tx and all."""
    prob, alg_j, alg = _linreg_algs(name, **kw)
    solver_j = make_solver(prob, 0.5)
    st_j = alg_j.init(jax.random.PRNGKey(1), prob["theta0"])
    st_p = convert.afadmm_state_from_numpy(afadmm_to_numpy(st_j),
                                           device="cpu")
    kr = jax.random.fold_in(KEY, 1)
    draws = replay_round(kr, st_j, alg_j)
    st_j2, m_j = jax.jit(lambda s, k: alg_j.round(k, s, solver_j,
                                                  prob["grad_fn"]))(st_j, kr)
    solver, grad_fn = _linreg_port(prob, 0.5)
    st_p2, m_p = alg.round(0, st_p, solver, grad_fn, draws=draws)
    _assert_phy_close(st_p2.phys, st_j2.phys)
    for a, b in ((st_p2.theta, st_j2.theta), (st_p2.Theta, st_j2.Theta),
                 (st_p2.lam.re, st_j2.lam.re), (st_p2.lam.im, st_j2.lam.im)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    for k in ("primal_residual", "dual_residual", "inv_alpha",
              "participation"):
        np.testing.assert_allclose(float(m_p[k]), float(m_j[k]), **TOL)
    assert 0.0 < float(m_p["participation"]) <= 1.0


def test_all_masked_round_is_a_noop():
    """Every worker in a deep fade: Θ and λ keep their bits, 1/α is 0."""
    prob, alg_j, alg = _linreg_algs("deep-fade-truncation", h_min=100.0)
    solver, grad_fn = _linreg_port(prob, 0.5)
    st = alg.init(1, _t(prob["theta0"]))
    st1, _ = alg.round(2, st._replace(
        lam=Complex(torch.randn(8, 6), torch.randn(8, 6))), solver, grad_fn)
    st2, m = alg.round(3, st1, solver, grad_fn)
    assert float(m["participation"]) == 0.0 and float(m["inv_alpha"]) == 0.0
    assert torch.equal(st2.Theta, st1.Theta)
    assert torch.equal(st2.lam.re, st1.lam.re)
    assert torch.equal(st2.lam.im, st1.lam.im)
    st_j = alg_j.init(jax.random.PRNGKey(1), prob["theta0"])
    _, m_j = alg_j.round(KEY, st_j, make_solver(prob, 0.5), prob["grad_fn"])
    assert float(m_j["participation"]) == 0.0
    assert float(m_j["inv_alpha"]) == 0.0


def test_masked_duals_freeze_at_pre_round_value_under_the_flip_rule():
    """ρ = 0 redraws every 2nd round, so the flip rule fires; a truncated
    worker's dual keeps state.lam, not the flipped value — as in JAX."""
    prob, alg_j, alg = _linreg_algs("deep-fade-truncation", flip=True,
                                    rho=0.0, coherence_iters=2)
    solver_j = make_solver(prob, 0.5)
    solver, grad_fn = _linreg_port(prob, 0.5)
    round_j = jax.jit(lambda s, k: alg_j.round(k, s, solver_j,
                                               prob["grad_fn"]))
    st_j = alg_j.init(jax.random.PRNGKey(1), prob["theta0"])
    st_p = convert.afadmm_state_from_numpy(afadmm_to_numpy(st_j),
                                           device="cpu")
    flipped_and_masked = 0
    for r in range(8):
        kr = jax.random.fold_in(KEY, r + 1)
        draws = replay_round(kr, st_j, alg_j)
        st_j2, _ = round_j(st_j, kr)
        st_p2, _ = alg.round(0, st_p, solver, grad_fn, draws=draws)
        mask = st_p2.phys.mask
        np.testing.assert_array_equal(mask.numpy(),
                                      np.asarray(st_j2.phys.mask))
        drop = ~mask
        assert torch.equal(st_p2.lam.re[drop], st_p.lam.re[drop])
        assert torch.equal(st_p2.lam.im[drop], st_p.lam.im[drop])
        np.testing.assert_allclose(st_p2.lam.re.numpy(),
                                   np.asarray(st_j2.lam.re), **TOL)
        np.testing.assert_allclose(st_p2.Theta.numpy(),
                                   np.asarray(st_j2.Theta), **TOL)
        if alg.scenario.changed(st_p2.phys) and bool(drop.any()):
            flipped_and_masked += 1
            # the flip froze every θ this round
            assert torch.equal(st_p2.theta, st_p.theta)
        st_j, st_p = st_j2, st_p2
    assert flipped_and_masked > 0


# ---------------------------------------------------------------------------
# the trainer, 30 replayed rounds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [("deep-fade-truncation", {}),
                                     ("markov-doppler", dict(csi_err=0.3))])
def test_trainer_30_rounds_match_jax(name, kw):
    """The linreg quickstart (W = 10, d = 6, flip rule on) under a scenario:
    the port's ``train`` on JAX's replayed draws follows JAX's
    ``train(driver="loop")`` every round, with equal masks."""
    rounds = 30
    key = jax.random.PRNGKey(0)
    q = _quickstart_jax(key)
    alg_j = jmake("afadmm", q["alg"].acfg, q["ccfg"], q["alg"].plan,
                  scenario=jmake_scenario(name, q["ccfg"], **kw))
    step = jax.jit(lambda st, k: alg_j.round(k, st, q["solver"],
                                             q["grad_fn"]))
    st_j = alg_j.init(key, q["theta0"])
    st0 = afadmm_to_numpy(st_j)
    thetas_j, masks_j, draws = [], [], []
    for r in range(rounds):
        kr = jax.random.fold_in(key, r + 1)
        draws.append(replay_round(kr, st_j, alg_j))
        st_j, _ = step(st_j, kr)
        thetas_j.append(np.asarray(st_j.Theta))
        masks_j.append(None if st_j.phys.mask is None
                       else np.asarray(st_j.phys.mask))
    hist_j = jtrain(alg_j, q["theta0"], q["solver"], q["grad_fn"], rounds,
                    key, eval_fn=q["eval_fn"], driver="loop")

    base, solver, grad_fn, eval_fn = _quickstart_port(q)
    alg = make("afadmm", base.acfg, base.ccfg, base.plan,
               scenario=make_scenario(name, base.ccfg, **kw))
    thetas_p = []

    def eval_and_record(Theta):
        thetas_p.append(Theta.clone())
        return eval_fn(Theta)

    theta0 = _t(q["theta0"])
    hist = train(alg, theta0, solver, grad_fn, rounds, 0,
                 eval_fn=eval_and_record,
                 init_state=convert.afadmm_state_from_numpy(st0,
                                                            device="cpu"),
                 draws=lambda r: draws[r])
    for r, (a, b) in enumerate(zip(thetas_p, thetas_j)):
        np.testing.assert_allclose(a.numpy(), b, err_msg=f"round {r}", **TOL)
    np.testing.assert_allclose(hist.loss, hist_j.loss, rtol=0, atol=1e-5)
    # masks round by round: the same rounds driven one at a time
    st = convert.afadmm_state_from_numpy(st0, device="cpu")
    for r in range(rounds):
        st, m = alg.round(0, st, solver, grad_fn, draws=draws[r])
        if masks_j[r] is None:
            assert st.phys.mask is None and "participation" not in m
        else:
            np.testing.assert_array_equal(st.phys.mask.numpy(), masks_j[r],
                                          err_msg=f"round {r}")
    if name == "deep-fade-truncation":
        part = hist.extra["participation"]
        # the masks are equal; the mean sums in another order
        np.testing.assert_allclose(part, hist_j.extra["participation"],
                                   rtol=1e-6)
        assert 0.0 < float(np.mean(part)) < 1.0
    assert hist.loss[-1] < hist.loss[0]


# ---------------------------------------------------------------------------
# port against port
# ---------------------------------------------------------------------------

def test_block_fading_scenario_is_the_legacy_channel_bit_for_bit():
    """scenario="block-fading" draws and steps the channel exactly as the
    legacy path does: 25 rounds (coherence 3, flip rule on) agree bitwise."""
    prob = make_linreg(KEY)
    solver, grad_fn = _linreg_port(prob, 0.5)
    ccfg = ChannelConfig(n_workers=prob["W"], n_subcarriers=prob["d"],
                         coherence_iters=3, noisy=True)
    plan = SubcarrierPlan.build(prob["d"], prob["d"])
    runs = []
    for scn in (None, make_scenario("block-fading", ccfg)):
        alg = make("afadmm", AdmmConfig(rho=0.5), ccfg, plan, scenario=scn)
        thetas = []
        hist = train(alg, _t(prob["theta0"]), solver, grad_fn, 25, 4,
                     eval_fn=lambda T: thetas.append(T.clone()) or
                     {"loss": T.sum()})
        runs.append((hist, thetas))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


def test_static_iid_never_redraws_and_draws_nothing():
    scn = make_scenario("static-iid")
    st = scn.init(3, 2, 16, "cpu")
    h0 = st.h
    for r in range(5):
        dr = scn.draw(r, st)
        assert dr == PhyDraws()
        st = scn.step(st, dr)
        assert st.h is h0 and not scn.changed(st)
    assert st.age == 5


def test_changed_only_for_a_rho_zero_redraw():
    ccfg = ChannelConfig(n_workers=4)
    for name in ("markov-doppler", "urban-mobility",
                 "deep-fade-truncation"):
        scn = make_scenario(name, ccfg)
        assert scn.cfg.rho > 0.0
        st = scn.init(1, 4, 8, "cpu")
        for r in range(3):
            st = scn.step(st, scn.draw(r, st))
            assert st.age == 0 and scn.changed(st) is False
    scn = make_scenario("block-fading", ccfg)
    st = scn.init(1, 4, 8, "cpu")
    flags = []
    for r in range(ccfg.coherence_iters + 1):
        st = scn.step(st, scn.draw(r, st))
        flags.append(scn.changed(st))
    assert flags == [False] * (ccfg.coherence_iters - 1) + [True, False]


def test_phy_state_from_numpy_checks_its_leaves():
    scn = jmake_scenario("urban-mobility", csi_err=0.1, h_min=0.3)
    leaves = phy_to_numpy(scn.init(KEY, 4, 8))
    st = convert.phy_state_from_numpy(leaves, device="cpu")
    np.testing.assert_array_equal(st.pos.numpy(), leaves["pos"])
    assert st.mask.dtype == torch.bool and st.age == 0
    assert st.h_small is not None and st.h_hat is not None
    with pytest.raises(KeyError, match="missing"):
        convert.phy_state_from_numpy({"h_re": leaves["h_re"]}, device="cpu")
    with pytest.raises(KeyError, match="unknown"):
        convert.phy_state_from_numpy(dict(leaves, extra=1), device="cpu")
    with pytest.raises(KeyError, match="_im"):
        convert.phy_state_from_numpy(
            {k: v for k, v in leaves.items() if k != "h_small_im"},
            device="cpu")
