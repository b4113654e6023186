"""The port's wireless-scenario kernels and modules against the JAX package's.

Kernel plain versions: B8 ``ota_receive_masked`` against the Pallas kernel
(interpret mode) and the jnp masked receive; B9 ``fading_step`` against the
Pallas kernel and ``gauss_markov_step``; B10 ``population_step`` against the
Pallas kernel and the composed jnp chain.  Modules: Jakes ρ, geometry given
the fresh draws, CSI, and every preset's resolved ``PhyConfig``.  Every
random plane is drawn by JAX and handed to the port."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import transport as jtransport  # noqa: E402
from repro.core.channel import ChannelConfig as JChannelConfig  # noqa: E402
from repro.core.channel import awgn as jawgn  # noqa: E402
from repro.core.channel import matched_filter_noise  # noqa: E402
from repro.core.channel import rayleigh as jrayleigh  # noqa: E402
from repro.core.cplx import Complex as JComplex  # noqa: E402
from repro.kernels import phy_channel as jphy_k  # noqa: E402
from repro.kernels import phy_population as jpop_k  # noqa: E402
from repro.phy import csi as jcsi  # noqa: E402
from repro.phy import fading as jfading  # noqa: E402
from repro.phy import geometry as jgeo  # noqa: E402
from repro.phy import scenario as jscenario  # noqa: E402

from repro_torch import rng  # noqa: E402
from repro_torch.core.channel import ChannelConfig  # noqa: E402
from repro_torch.core.cplx import Complex  # noqa: E402
from repro_torch.kernels import build, phy_channel, phy_population, ref  # noqa: E402
from repro_torch.phy import csi, fading, geometry, population, scenario  # noqa: E402

SHAPES = [(3, 1000), (5, 1025), (8, 4097)]
KEY = jax.random.PRNGKey(0)
#: the receive sums over W in another order than XLA does
RECV_TOL = dict(rtol=1e-5, atol=1e-6)
#: elementwise: the same f32 expression, last-ulp differences only
ELEM_TOL = dict(rtol=1e-6, atol=1e-6)
#: the population step: exp/log against pow, and sqrt of a sum of squares
POP_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _planes(W, d, seed, n):
    g = np.random.default_rng(seed)
    return [g.standard_normal((W, d)).astype(np.float32) for _ in range(n)]


def _close(port, want, tol):
    np.testing.assert_allclose(port.numpy(), np.asarray(want), **tol)


# ---------------------------------------------------------------------------
# B8: the participation-masked receive
# ---------------------------------------------------------------------------

def _mask(W, seed):
    m = np.random.default_rng(seed).random(W) > 0.3
    m[0], m[-1] = True, False
    return m


@pytest.mark.parametrize("W,d", SHAPES)
def test_masked_receive_matches_jax(W, d):
    sre, sim, hre, him = _planes(W, d, W * d, 4)
    mask = _mask(W, d)
    ccfg = JChannelConfig(n_workers=W, noisy=True)
    key = jax.random.PRNGKey(W + d)
    noise = np.asarray(matched_filter_noise(key, (d,), ccfg).re)
    ia = np.float32(0.37)
    got = ref.ota_receive_masked(*map(_t, (sre, sim, hre, him, mask, noise)),
                                 torch.tensor(ia))
    pal = jphy_k.ota_receive_masked(sre, sim, hre, him, mask, noise, ia,
                                    interpret=True)
    _close(got, pal, RECV_TOL)
    jnp_out = jtransport.receive(JComplex(sre, sim), JComplex(hre, him), key,
                                 ccfg, jnp.float32(ia),
                                 mask=jnp.asarray(mask), backend="jnp")
    _close(got, jnp_out, RECV_TOL)
    # the CPU wrapper is the plain version
    assert torch.equal(got, phy_channel.ota_receive_masked(
        *map(_t, (sre, sim, hre, him, mask, noise)), torch.tensor(ia)))


def test_masked_receive_ignores_nan_and_inf_in_dropped_rows():
    W, d = 5, 1025
    sre, sim, hre, him = _planes(W, d, 3, 4)
    mask = np.array([True, False, True, False, True])
    clean = ref.ota_receive_masked(*map(_t, (sre, sim, hre, him, mask)),
                                   torch.zeros(d), torch.tensor(0.5))
    sre[1], him[1], hre[3], sim[3] = np.nan, np.inf, -np.inf, np.nan
    got = ref.ota_receive_masked(*map(_t, (sre, sim, hre, him, mask)),
                                 torch.zeros(d), torch.tensor(0.5))
    assert bool(torch.isfinite(got).all()) and torch.equal(got, clean)
    pal = jphy_k.ota_receive_masked(sre, sim, hre, him, mask,
                                    np.zeros(d, np.float32), 0.5,
                                    interpret=True)
    _close(got, pal, RECV_TOL)


def test_masked_receive_all_masked_is_zero():
    """Nobody transmits and α⁻¹ = 0: the output is exactly 0 (the round
    driver then keeps Θ)."""
    W, d = 4, 1000
    sre, sim, hre, him = _planes(W, d, 4, 4)
    none = np.zeros(W, bool)
    noise = np.random.default_rng(5).standard_normal(d).astype(np.float32)
    got = ref.ota_receive_masked(*map(_t, (sre, sim, hre, him, none, noise)),
                                 torch.tensor(0.0))
    assert torch.equal(got, torch.zeros(d))
    pal = jphy_k.ota_receive_masked(sre, sim, hre, him, none, noise, 0.0,
                                    interpret=True)
    np.testing.assert_array_equal(np.asarray(pal), np.zeros(d, np.float32))


# ---------------------------------------------------------------------------
# B9: the AR(1) fading step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("W,d", SHAPES)
@pytest.mark.parametrize("rho", [0.0, 0.9])
@pytest.mark.parametrize("redraw", [True, False])
def test_fading_step_matches_jax(W, d, rho, redraw):
    h = jrayleigh(jax.random.fold_in(KEY, d), (W, d))
    k = jax.random.fold_in(KEY, W)
    w = jrayleigh(k, (W, d))                 # the draw gauss_markov_step makes
    scale = jfading.innovation_scale(rho)
    hp, wp = Complex(_t(h.re), _t(h.im)), Complex(_t(w.re), _t(w.im))
    got = ref.fading_step(hp.re, hp.im, wp.re, wp.im, rho, scale, redraw)
    pre, pim = jphy_k.fading_step(*(np.asarray(x).reshape(-1) for x in
                                    (h.re, h.im, w.re, w.im)),
                                  rho, scale, jnp.asarray(redraw),
                                  interpret=True)
    _close(got[0].reshape(-1), pre, ELEM_TOL)
    _close(got[1].reshape(-1), pim, ELEM_TOL)
    want = jfading.gauss_markov_step(k, h, rho, jnp.asarray(redraw),
                                     backend="jnp")
    _close(got[0], want.re, ELEM_TOL)
    _close(got[1], want.im, ELEM_TOL)
    # the module: the plain version, and at ρ = 0 exactly w (or h)
    mod = fading.gauss_markov_step(hp, wp, rho, redraw)
    _close(mod.re, want.re, ELEM_TOL)
    if rho == 0.0:
        np.testing.assert_array_equal(mod.re.numpy(), np.asarray(want.re))
        np.testing.assert_array_equal(mod.im.numpy(), np.asarray(want.im))
    if not redraw:
        assert torch.equal(got[0], hp.re) and torch.equal(mod.im, hp.im)


@pytest.mark.parametrize("age,coh", [(0, 3), (2, 3), (0, 1)])
def test_correlated_step_matches_jax(age, coh):
    W, d = 4, 37
    h = jrayleigh(KEY, (W, d))
    k = jax.random.fold_in(KEY, 11)
    want, age_j, redraw_j = jfading.correlated_step(
        k, h, jnp.asarray(age, jnp.int32), 0.8, coh, backend="jnp")
    redraw = fading.redraws(age, coh)
    assert redraw == bool(redraw_j)
    w = jrayleigh(k, (W, d)) if redraw else None
    got, age_p, redraw_p = fading.correlated_step(
        Complex(_t(h.re), _t(h.im)),
        None if w is None else Complex(_t(w.re), _t(w.im)), age, 0.8, coh)
    assert (age_p, redraw_p) == (int(age_j), redraw)
    _close(got.re, want.re, ELEM_TOL)
    _close(got.im, want.im, ELEM_TOL)
    if redraw:
        with pytest.raises(ValueError, match="innovations"):
            fading.correlated_step(got, None, age, 0.8, coh)


def test_bessel_j0_and_doppler_rho_match_jax():
    for x in np.linspace(0.0, 12.0, 97):
        assert fading.bessel_j0(x) == jfading.bessel_j0(x)
    for f_d in (0.0, 10.0, 50.0, 100.0, 400.0, 500.0):
        for T in (1e-3, 2e-3, 5e-3):
            assert fading.doppler_rho(f_d, T) == jfading.doppler_rho(f_d, T)
    assert fading.doppler_rho(500.0, 1e-3) == 0.0
    assert fading.innovation_scale(0.6) == jfading.innovation_scale(0.6)
    assert abs(fading.bessel_j0(1.0) - 0.76519769) < 1e-6


# ---------------------------------------------------------------------------
# B10: the population step, and the geometry it fuses
# ---------------------------------------------------------------------------

GCFG = dict(cell_radius_m=500.0, speed_mps=15.0, slot_seconds=1.0,
            shadowing_sigma_db=6.0)


def _population_inputs(n, d=1, seed=0):
    g = jgeo.GeometryConfig(**GCFG)
    kh, kp, ks, kf, kg = jax.random.split(jax.random.PRNGKey(seed), 5)
    h = jrayleigh(kh, (n, d))
    pos, dest = jgeo.init_positions(kp, n, g)
    dest = dest.at[: n // 4].set(pos[: n // 4] + 1.0)     # force arrivals
    shadow = jgeo.shadowing(ks, n, g)
    # the draws the composed chain makes from kf and kg
    w = jrayleigh(kf, (n, d))
    fresh = jgeo.uniform_disk(kg, n, g.cell_radius_m)
    sh_fresh = jgeo.shadowing(jax.random.fold_in(kg, jgeo.SHADOW_SALT), n, g)
    return g, kf, kg, h, pos, dest, shadow, w, fresh, sh_fresh


def _composed_chain(kf, kg, h, age, pos, dest, shadow, g, rho, coh):
    h2, a2, _ = jfading.correlated_step(kf, h, age, rho, coh, backend="jnp")
    p2, d2, s2 = jgeo.waypoint_shadow_step(kg, pos, dest, shadow, g)
    return h2, a2, p2, d2, s2, jgeo.worker_gains(p2, s2, g)


@pytest.mark.parametrize("n", [257, 1000])
@pytest.mark.parametrize("age0", [0, 2])
def test_population_step_matches_jax(n, age0):
    """coherence 3: age 0 holds the fading, age 2 redraws it."""
    rho, coh = 0.9, 3
    g, kf, kg, h, pos, dest, shadow, w, fresh, sh_fresh = \
        _population_inputs(n, seed=n)
    want = _composed_chain(kf, kg, h, jnp.asarray(age0, jnp.int32), pos,
                           dest, shadow, g, rho, coh)
    redraw = fading.redraws(age0, coh)
    a = lambda x: np.asarray(x)  # noqa: E731
    flat = (a(h.re)[:, 0], a(h.im)[:, 0], a(w.re)[:, 0], a(w.im)[:, 0],
            a(pos)[:, 0], a(pos)[:, 1], a(dest)[:, 0], a(dest)[:, 1],
            a(fresh)[:, 0], a(fresh)[:, 1], a(shadow), a(sh_fresh))
    scalars = (rho, jfading.innovation_scale(rho), redraw,
               g.speed_mps * g.slot_seconds, g.ref_distance_m,
               g.norm_distance_m, g.pathloss_exp, True)
    got = ref.population_step(*map(_t, flat), *scalars)
    pal = jpop_k.population_step(*flat, *scalars[:2], jnp.asarray(redraw),
                                 *scalars[3:7], 1.0, interpret=True)
    for x, y in zip(got, pal):
        _close(x, y, POP_TOL)
    chain = (want[0].re[:, 0], want[0].im[:, 0], want[2][:, 0],
             want[2][:, 1], want[3][:, 0], want[3][:, 1], want[4], want[5])
    for x, y in zip(got, chain):
        _close(x, y, POP_TOL)

    # the module's fused path (frequency-flat) and its returned layout
    gp = geometry.GeometryConfig(**GCFG)
    out = population.population_step(
        Complex(_t(h.re), _t(h.im)),
        Complex(_t(w.re), _t(w.im)) if redraw else None, age0, _t(pos),
        _t(dest), _t(shadow), _t(fresh), _t(sh_fresh), gp, rho=rho,
        coherence_iters=coh)
    assert out[1] == int(want[1])
    assert out[2].shape == (n, 2) and out[2].T.is_contiguous()
    for x, y in zip((out[0].re, out[0].im, out[2], out[3], out[4], out[5]),
                    (want[0].re, want[0].im, want[2], want[3], want[4],
                     want[5])):
        _close(x, y, POP_TOL)


def test_population_step_wideband_is_the_composed_chain():
    """(N, d > 1) fading: the port runs B9 plus plain geometry, which is the
    JAX chain's arithmetic (pow path gain)."""
    n, d = 32, 8
    g, kf, kg, h, pos, dest, shadow, w, fresh, sh_fresh = \
        _population_inputs(n, d=d, seed=3)
    want = _composed_chain(kf, kg, h, jnp.zeros((), jnp.int32), pos, dest,
                           shadow, g, 0.9, 1)
    out = population.population_step(
        Complex(_t(h.re), _t(h.im)), Complex(_t(w.re), _t(w.im)), 0,
        _t(pos), _t(dest), _t(shadow), _t(fresh), _t(sh_fresh),
        geometry.GeometryConfig(**GCFG), rho=0.9, coherence_iters=1)
    assert out[1] == 0 and out[0].re.shape == (n, d)
    _close(out[0].re, want[0].re, ELEM_TOL)
    for x, y in zip(out[2:], want[2:]):
        _close(x, y, ELEM_TOL)


def test_geometry_given_fresh_draws_matches_jax():
    gj = jgeo.GeometryConfig(cell_radius_m=100.0, speed_mps=5.0,
                             slot_seconds=1.0, shadowing_sigma_db=8.0)
    gp = geometry.GeometryConfig(cell_radius_m=100.0, speed_mps=5.0,
                                 slot_seconds=1.0, shadowing_sigma_db=8.0)
    n = 64
    pos, dest = jgeo.init_positions(KEY, n, gj)
    dest = dest.at[: n // 2].set(pos[: n // 2])
    shadow = jgeo.shadowing(jax.random.fold_in(KEY, 1), n, gj)
    k = jax.random.fold_in(KEY, 2)
    fresh = jgeo.uniform_disk(k, n, gj.cell_radius_m)
    sh_fresh = jgeo.shadowing(jax.random.fold_in(k, jgeo.SHADOW_SALT), n, gj)
    p2, d2, s2 = jgeo.waypoint_shadow_step(k, pos, dest, shadow, gj)
    q2, e2, t2 = geometry.waypoint_shadow_step(
        _t(pos), _t(dest), _t(shadow), _t(fresh), _t(sh_fresh), gp)
    _close(q2, p2, ELEM_TOL)
    np.testing.assert_array_equal(e2.numpy(), np.asarray(d2))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(s2))
    q3, e3 = geometry.waypoint_step(_t(pos), _t(dest), _t(fresh), gp)
    assert torch.equal(q3, q2) and torch.equal(e3, e2)
    _close(geometry.worker_gains(q2, t2, gp),
           jgeo.worker_gains(p2, s2, gj), ELEM_TOL)
    d = np.asarray([0.01, 1.0, 50.0, 250.0, 500.0], np.float32)
    _close(geometry.path_gain(_t(d), gp), jgeo.path_gain(jnp.asarray(d), gj),
           ELEM_TOL)
    # shadowing off: nothing to redraw, shadow passes through
    g0 = dataclasses.replace(gp, shadowing_sigma_db=0.0)
    _, _, same = geometry.waypoint_shadow_step(_t(pos), _t(dest), _t(shadow),
                                               _t(fresh), None, g0)
    assert torch.equal(same, _t(shadow))
    assert torch.equal(geometry.shadowing(torch.Generator(), 3, g0),
                       torch.ones(3))
    assert geometry.SHADOW_SALT == jgeo.SHADOW_SALT


def test_port_draws_have_the_right_statistics():
    """The port's own draws: uniform over the disk, log-normal shadowing,
    and positions laid out so the x and y rows are contiguous."""
    g = torch.Generator().manual_seed(0)
    pts = geometry.uniform_disk(g, 20_000, 100.0)
    assert pts.shape == (20_000, 2) and pts.T.is_contiguous()
    r = torch.sqrt((pts * pts).sum(-1))
    assert float(r.max()) <= 100.0 + 1e-3
    assert abs(float(r.mean()) - 200.0 / 3.0) < 3.0
    sh = geometry.shadowing(g, 20_000, geometry.GeometryConfig(
        shadowing_sigma_db=6.0))
    db = 10.0 * torch.log10(sh)
    assert abs(float(db.std()) - 6.0) < 0.2 and abs(float(db.mean())) < 0.2


# ---------------------------------------------------------------------------
# CSI, keys, presets
# ---------------------------------------------------------------------------

def test_csi_estimate_matches_jax():
    h = jrayleigh(KEY, (4, 33))
    k = jax.random.fold_in(KEY, 5)
    want = jcsi.estimate(k, h, 0.3)
    e = jawgn(k, (4, 33), 0.3 ** 2)
    hp = Complex(_t(h.re), _t(h.im))
    got = csi.estimate(hp, Complex(_t(e.re), _t(e.im)), 0.3)
    _close(got.re, want.re, ELEM_TOL)
    _close(got.im, want.im, ELEM_TOL)
    assert csi.estimate(hp, None, 0.0) is hp


def test_split_and_side_branch_are_folds():
    assert rng.split(9, 3) == (rng.fold_in(9, 0), rng.fold_in(9, 1),
                               rng.fold_in(9, 2))
    assert rng.split(9) == rng.split(9, 3)[:2]
    assert len(set(rng.split(9, 3)) | {rng.fold_in(9, geometry.SHADOW_SALT)}
               ) == 4


def test_participation_mask_matches_jax():
    h = jrayleigh(KEY, (32, 1))
    for h_min in (0.3, 0.5, 1.0):
        got = scenario.participation_mask(Complex(_t(h.re), _t(h.im)), h_min)
        want = jscenario.participation_mask(h, h_min)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rms = scenario.participation_mask(
        Complex(torch.tensor([[3.0, 0.0], [0.1, 0.1]]), torch.zeros(2, 2)),
        1.0)
    assert rms.tolist() == [True, False]


_OVERRIDES = [{}, dict(csi_err=0.1), dict(h_min=0.3, freq_flat=True),
              dict(doppler_hz=80.0, coherence_iters=4),
              dict(rho=0.7, slots_per_round=5),
              dict(geometry=jgeo.GeometryConfig(speed_mps=5.0))]


@pytest.mark.parametrize("name", list(jscenario.PRESETS))
@pytest.mark.parametrize("ov", range(len(_OVERRIDES)))
def test_make_scenario_resolves_like_jax(name, ov):
    ccfg_j = JChannelConfig(n_workers=4, slot_seconds=2e-3)
    ccfg_p = ChannelConfig(n_workers=4, slot_seconds=2e-3)
    kw = dict(_OVERRIDES[ov])
    j = jscenario.make_scenario(name, ccfg_j, **kw)
    if "geometry" in kw:
        kw["geometry"] = geometry.GeometryConfig(
            **dataclasses.asdict(kw["geometry"]))
    p = scenario.make_scenario(name, ccfg_p, **kw)
    jd = dataclasses.asdict(j.cfg)
    jd.pop("backend")
    assert dataclasses.asdict(p.cfg) == jd
    assert (p.truncating, p.imperfect_csi, p.has_geometry, p.mobile) == (
        j.truncating, j.imperfect_csi, j.has_geometry, j.mobile)


def test_make_scenario_refuses_what_jax_refuses():
    assert scenario.list_scenarios() == jscenario.list_scenarios()
    with pytest.raises(ValueError, match="unknown scenario"):
        scenario.make_scenario("rayleigh-disco")
    with pytest.raises(ValueError, match="slots_per_round"):
        scenario.make_scenario("markov-doppler", slots_per_round=0)


def test_cpu_phy_wrappers_take_plain_version_and_count_nothing():
    sre, sim, hre, him = map(_t, _planes(3, 50, 9, 4))
    mask = torch.tensor([True, False, True])
    build.reset_launches()
    assert torch.equal(
        phy_channel.ota_receive_masked(sre, sim, hre, him, mask,
                                       torch.zeros(50), torch.tensor(1.0)),
        ref.ota_receive_masked(sre, sim, hre, him, mask, torch.zeros(50),
                               torch.tensor(1.0)))
    for a, b in zip(phy_channel.fading_step(sre, sim, hre, him, 0.5, 0.8,
                                            True),
                    ref.fading_step(sre, sim, hre, him, 0.5, 0.8, True)):
        assert torch.equal(a, b)
    flat = [x.reshape(-1) for x in (sre, sim, hre, him)] * 3
    for a, b in zip(
            phy_population.population_step(*flat, 0.9, 0.4, True, 0.1, 1.0,
                                           2.0, 3.0, True),
            ref.population_step(*flat, 0.9, 0.4, True, 0.1, 1.0, 2.0, 3.0,
                                True)):
        assert torch.equal(a, b)
    assert sum(build.launches.values()) == 0
    assert math.isfinite(float(ref.population_step(
        *flat, 0.9, 0.4, False, 0.1, 1.0, 2.0, 3.0, False)[7].sum()))
