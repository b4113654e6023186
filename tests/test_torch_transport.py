"""The port's transport layer against the JAX package's: the full uplink with
power control on/off and replayed noise, the dual update and flip rule, the
penalty gradient and power-control guards, on the same numpy inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import power as jpower  # noqa: E402
from repro.core import transport as jt  # noqa: E402
from repro.core.channel import ChannelConfig as JChannelConfig  # noqa: E402
from repro.core.channel import matched_filter_noise  # noqa: E402
from repro.core.cplx import Complex as JComplex  # noqa: E402
from repro.core import cplx as jcplx  # noqa: E402

from repro_torch.core import cplx, power, transport  # noqa: E402
from repro_torch.core.channel import ChannelConfig  # noqa: E402
from repro_torch.core.cplx import Complex  # noqa: E402

RHO = 0.5
#: Θ: the worker sum runs in another order; inv_alpha: the energy sum too
TOL = dict(rtol=1e-5, atol=1e-6)


def _problem(W, d, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    theta = f(W, d)
    lam = (0.3 * f(W, d), 0.3 * f(W, d))
    h = (np.sqrt(0.5, dtype=np.float32) * f(W, d),
         np.sqrt(0.5, dtype=np.float32) * f(W, d))
    return theta, lam, h


def _port(theta, lam, h):
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return t(theta), Complex(t(lam[0]), t(lam[1])), Complex(t(h[0]), t(h[1]))


def _jax(theta, lam, h):
    return jnp.asarray(theta), JComplex(*map(jnp.asarray, lam)), \
        JComplex(*map(jnp.asarray, h))


@pytest.mark.parametrize("W,d", [(4, 6), (7, 1061), (10, 4099)])
@pytest.mark.parametrize("noisy", [False, True])
@pytest.mark.parametrize("power_control", [False, True])
@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_uplink_matches_jax(W, d, noisy, power_control, backend):
    prob = _problem(W, d, seed=W * d)
    ccfg_j = JChannelConfig(n_workers=W, noisy=noisy, snr_db=20.0)
    ccfg = ChannelConfig(n_workers=W, noisy=noisy, snr_db=20.0)
    key = jax.random.PRNGKey(d)
    T_j, ia_j = jt.ota_uplink(*_jax(*prob), key, RHO, ccfg_j,
                              power_control=power_control, backend=backend)
    noise = torch.from_numpy(np.array(
        matched_filter_noise(key, (d,), ccfg_j).re))
    T_p, ia_p = transport.ota_uplink(*_port(*prob), noise, RHO, ccfg,
                                     power_control=power_control)
    np.testing.assert_allclose(T_p.numpy(), np.asarray(T_j), **TOL)
    np.testing.assert_allclose(float(ia_p), float(ia_j), **TOL)
    assert T_p.shape == (d,) and T_p.dtype == torch.float32


@pytest.mark.parametrize("with_noise", [False, True])
def test_dual_update_matches_jax(with_noise):
    theta, lam, h = _problem(5, 300, 3)
    rng = np.random.default_rng(4)
    Theta = rng.standard_normal(300).astype(np.float32)
    z = rng.standard_normal((5, 300)).astype(np.float32) if with_noise else None
    jth, jlam, jh = _jax(theta, lam, h)
    want = jt.dual_update(jlam, jh, jth, jnp.asarray(Theta), RHO,
                          0.0 if z is None else jnp.asarray(z), backend="jnp")
    pth, plam, ph = _port(theta, lam, h)
    got = transport.dual_update(plam, ph, pth, torch.from_numpy(Theta), RHO,
                                None if z is None else torch.from_numpy(z))
    np.testing.assert_allclose(got.re.numpy(), np.asarray(want.re), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got.im.numpy(), np.asarray(want.im), rtol=1e-6,
                               atol=1e-6)


def test_modulate_and_penalty_grad_match_jax():
    theta, lam, h = _problem(3, 500, 5)
    Theta = np.random.default_rng(6).standard_normal(500).astype(np.float32)
    jth, jlam, jh = _jax(theta, lam, h)
    pth, plam, ph = _port(theta, lam, h)
    s_j = jt.modulate(jth, jlam, jh, RHO, backend="pallas")
    s_p = transport.modulate(pth, plam, ph, RHO)
    np.testing.assert_allclose(s_p.re.numpy(), np.asarray(s_j.re), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(s_p.im.numpy(), np.asarray(s_j.im), rtol=1e-6,
                               atol=1e-6)
    g_j = jt.penalty_grad(jth, jlam, jh, jnp.asarray(Theta), RHO)
    g_p = transport.penalty_grad(pth, plam, ph, torch.from_numpy(Theta), RHO)
    np.testing.assert_allclose(g_p.numpy(), np.asarray(g_j), rtol=1e-6,
                               atol=1e-6)
    assert g_p.dtype == pth.dtype


def test_demodulate_matches_jax():
    rng = np.random.default_rng(8)
    y, z = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    p2 = np.abs(rng.standard_normal(64)).astype(np.float32)
    p2[:3] = 0.0                                  # the 1e-12 clamp
    want = jt.demodulate(jnp.asarray(y), jnp.asarray(p2), jnp.asarray(z),
                         0.25, backend="jnp")
    got = transport.demodulate(*(torch.from_numpy(a) for a in (y, p2, z)),
                               0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_flip_rule_restores_stationarity():
    """Sec. 2: after a channel change, λ = t·h/|h|² satisfies
    Re{λ* h} + ∂f + ρ|h|²(θ−Θ) = 0 — and equals the JAX flip rule."""
    W, d = 4, 16
    rng = np.random.default_rng(4)
    theta, grad, h_re, h_im = (rng.standard_normal((W, d)).astype(np.float32)
                               for _ in range(4))
    Theta = rng.standard_normal(d).astype(np.float32)
    t = torch.from_numpy
    h = Complex(t(h_re), t(h_im))
    lam = transport.flip_lambda(t(grad), t(theta), t(Theta), h, RHO)
    resid = t(grad) + transport.penalty_grad(t(theta), lam, h, t(Theta), RHO)
    assert float(resid.abs().max()) < 1e-4
    want = jt.flip_lambda(jnp.asarray(grad), jnp.asarray(theta),
                          jnp.asarray(Theta), JComplex(h_re, h_im), RHO,
                          backend="jnp")
    np.testing.assert_allclose(lam.re.numpy(), np.asarray(want.re),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(lam.im.numpy(), np.asarray(want.im),
                               rtol=1e-6, atol=1e-6)


def test_zero_energy_worker_never_binds_min_alpha():
    energy = np.array([0.0, 4.0, 1.0, 0.0], np.float32)
    a_p = power.alpha_from_energy(torch.from_numpy(energy), 2.0)
    a_j = jpower.alpha_from_energy(jnp.asarray(energy), 2.0)
    np.testing.assert_array_equal(a_p.numpy(), np.asarray(a_j))
    assert torch.isinf(a_p[0]) and torch.isinf(a_p[3])
    ia_p = transport.inv_alpha_from_energy(torch.from_numpy(energy), 2.0)
    ia_j = jt.inv_alpha_from_energy(jnp.asarray(energy), 2.0)
    assert float(ia_p) == pytest.approx(float(ia_j), rel=1e-7)
    assert float(ia_p) == pytest.approx(1.0 / np.sqrt(2.0 / 4.0), rel=1e-6)


def test_all_zero_energy_gives_zero_inv_alpha_and_a_finite_round():
    """Nobody transmits: α = +inf, 1/α = 0 exactly, and the uplink adds no
    noise — Θ is finite (the zero signal over the clamped pilot)."""
    W, d = 3, 40
    zeros = np.zeros((W, d), np.float32)
    _, _, h = _problem(W, d, 9)
    ia = transport.inv_alpha_from_energy(torch.zeros(W), 1.0)
    assert float(ia) == 0.0
    assert float(jt.inv_alpha_from_energy(jnp.zeros(W), 1.0)) == 0.0
    noise = torch.full((d,), 1e3)
    ccfg = ChannelConfig(n_workers=W)
    Theta, ia = transport.ota_uplink(*_port(zeros, (zeros, zeros), h), noise,
                                     RHO, ccfg)
    assert float(ia) == 0.0
    assert torch.equal(Theta, torch.zeros(d))


def test_worker_energy_and_power_scale_match_jax():
    theta, lam, h = _problem(6, 777, 10)
    ccfg_j = JChannelConfig(n_workers=6)
    s_j = jt.modulate(*_jax(theta, lam, h), RHO, backend="jnp")
    s_p = transport.modulate(*_port(theta, lam, h), RHO)
    np.testing.assert_allclose(transport.worker_energy(s_p).numpy(),
                               np.asarray(jt.worker_energy(s_j)), rtol=1e-5)
    np.testing.assert_allclose(
        float(transport.power_scale(s_p, ChannelConfig(n_workers=6))),
        float(jt.power_scale(s_j, ccfg_j)), rtol=1e-5)


def test_resolve_backend_follows_the_tensors():
    assert transport.resolve_backend(torch.zeros(1).device) == "torch"
    assert transport.resolve_backend(torch.device("cuda")) == "cuda"
    # the dry run's shapes-only tensors take the plain versions
    assert transport.resolve_backend(torch.zeros(1, device="meta").device) \
        == "torch"
    with pytest.raises(ValueError):
        transport.resolve_backend(torch.device("xpu"))


def test_channel_config_matches_jax():
    for kw in ({}, {"snr_db": 20.0, "noise_psd": 2e-9, "slot_seconds": 5e-4}):
        p, j = ChannelConfig(n_workers=3, **kw), JChannelConfig(n_workers=3,
                                                                **kw)
        assert p.transmit_power == j.transmit_power
        assert p.noise_var_matched == j.noise_var_matched


def test_complex_helpers_match_jax():
    a_re, a_im, b_re, b_im = (np.random.default_rng(i).standard_normal(
        (3, 5)).astype(np.float32) for i in range(4))
    mask = np.random.default_rng(9).random((3, 5)) > 0.5
    t = torch.from_numpy
    a, b = Complex(t(a_re), t(a_im)), Complex(t(b_re), t(b_im))
    ja, jb = JComplex(a_re, a_im), JComplex(b_re, b_im)
    for got, want in [(cplx.cmul(a, b), jcplx.cmul(ja, jb)),
                      (cplx.cmul_conj(a, b), jcplx.cmul_conj(ja, jb)),
                      (cplx.cwhere(t(mask), a, b),
                       jcplx.cwhere(jnp.asarray(mask), ja, jb))]:
        np.testing.assert_allclose(got.re.numpy(), np.asarray(want.re),
                                   rtol=1e-6)
        np.testing.assert_allclose(got.im.numpy(), np.asarray(want.im),
                                   rtol=1e-6)
    np.testing.assert_allclose(cplx.abs2(a).numpy(),
                               np.asarray(jcplx.abs2(ja)), rtol=1e-6)
    z = cplx.czero((2, 3), device="cpu")
    assert z.re.shape == (2, 3)
    assert not bool(z.re.any()) and not bool(z.im.any())
