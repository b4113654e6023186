"""The port's privacy harness (``core/privacy.py``, ``transport.superpose``)
against the JAX package's, on JAX's planes: the air's both complex planes,
the eavesdropper's view, the ambiguity witness with JAX's δ injected, the
observation gap at the reference's (W, d) = (6, 12), Thm 2's counting and
the model-inversion guess."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import cplx as jcplx  # noqa: E402
from repro.core import privacy as jprivacy  # noqa: E402
from repro.core import transport as jtransport  # noqa: E402
from repro.core.channel import rayleigh  # noqa: E402

from repro_torch.core import privacy, transport  # noqa: E402
from repro_torch.core.cplx import Complex  # noqa: E402

from torch_replay import t  # noqa: E402

#: f32 products and a 6-term sum over the worker dim: the same expressions
#: in the same order, so a few ulps at most
VIEW_TOL = dict(rtol=1e-6, atol=1e-6)
#: the reference's bar on two witnesses' observations (tests/test_privacy.py)
GAP_BAR = 1e-4


def _setup(key, W=6, d=12, rho=0.5):
    """``tests/test_privacy.py``'s planes: θ, λ (scaled 0.1), a Rayleigh h."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    theta = jax.random.normal(k1, (W, d))
    lam = jcplx.Complex(jax.random.normal(k2, (W, d)) * 0.1,
                        jax.random.normal(k3, (W, d)) * 0.1)
    return theta, lam, rayleigh(k4, (W, d)), rho


def _c(z) -> Complex:
    return Complex(t(z.re), t(z.im))


def _close(got, want, tol=VIEW_TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def _same_view(got, want, tol=VIEW_TOL):
    for g, w in ((got.y.re, want.y.re), (got.y.im, want.y.im),
                 (got.sumh2, want.sumh2), (got.Theta_prev, want.Theta_prev),
                 (got.Theta_new, want.Theta_new)):
        _close(g, w, tol)


@pytest.fixture(scope="module")
def planes():
    theta, lam, h, rho = _setup(jax.random.PRNGKey(0))
    return dict(theta=theta, lam=lam, h=h, rho=rho,
                Theta=theta.mean(0))


def test_superpose_equals_jax_both_planes(planes):
    s = jtransport.modulate(planes["theta"], planes["lam"], planes["h"],
                            planes["rho"])
    want_y, want_p = jtransport.superpose(s, planes["h"])
    got_y, got_p = transport.superpose(_c(s), _c(planes["h"]))
    _close(got_y.re, want_y.re)
    _close(got_y.im, want_y.im)
    _close(got_p, want_p)
    assert got_y.re.dtype == got_p.dtype == torch.float32
    # bf16 signals are superposed in f32; reduce_fn replaces the sum
    half = Complex(t(s.re).bfloat16(), t(s.im).bfloat16())
    y16, _ = transport.superpose(half, _c(planes["h"]))
    assert y16.re.dtype == torch.float32
    y_max, p_max = transport.superpose(_c(s), _c(planes["h"]),
                                       reduce_fn=lambda x: x.amax(0))
    assert y_max.re.shape == p_max.shape == (12,)


def test_eavesdropper_view_equals_jax(planes):
    Th = planes["Theta"]
    want = jprivacy.eavesdropper_view(planes["theta"], planes["lam"],
                                      planes["h"], planes["rho"], Th, Th)
    got = privacy.eavesdropper_view(t(planes["theta"]), _c(planes["lam"]),
                                    _c(planes["h"]), planes["rho"], t(Th),
                                    t(Th))
    _same_view(got, want)


@pytest.mark.parametrize("converged", [False, True],
                         ids=["trajectory", "converged"])
def test_ambiguity_with_jax_delta(converged):
    """Definition 1 (Thm 2), and Thm 3 at convergence (θ_n = Θ): the
    witness built from JAX's δ is JAX's witness, its models differ by more
    than 0.1, and the PS's two observations agree within the reference's
    bar."""
    theta, lam, h, rho = _setup(jax.random.PRNGKey(2 if converged else 0))
    Theta = theta.mean(0)
    if converged:
        theta = jax.numpy.broadcast_to(Theta[None], theta.shape)
    dkey = jax.random.PRNGKey(3 if converged else 7)
    jt2, jl2, jh2 = jprivacy.construct_ambiguity(dkey, theta, lam, h, rho)
    delta = t(jax.random.normal(dkey, theta.shape, theta.dtype))
    t2, l2, h2 = privacy.construct_ambiguity(0, t(theta), _c(lam), _c(h),
                                             rho, delta=delta)
    _close(t2, jt2, dict(rtol=0, atol=0))
    _close(l2.re, jl2.re, dict(rtol=0, atol=0))
    _close(l2.im, jl2.im, dict(rtol=0, atol=0))
    assert torch.equal(h2.re, t(jh2.re)) and torch.equal(h2.im, t(jh2.im))

    v1 = privacy.eavesdropper_view(t(theta), _c(lam), _c(h), rho, t(Theta),
                                   t(Theta))
    v2 = privacy.eavesdropper_view(t2, l2, h2, rho, t(Theta), t(Theta))
    assert float((t2 - t(theta)).abs().max()) > 0.1
    gap = float(privacy.observation_gap(v1, v2))
    assert gap < GAP_BAR
    jv1 = jprivacy.eavesdropper_view(theta, lam, h, rho, Theta, Theta)
    jv2 = jprivacy.eavesdropper_view(jt2, jl2, jh2, rho, Theta, Theta)
    _same_view(v2, jv2)
    np.testing.assert_allclose(gap, float(jprivacy.observation_gap(jv1, jv2)),
                               rtol=0, atol=1e-6)


def test_ambiguity_draws_delta_from_the_key(planes):
    theta = t(planes["theta"])
    a = privacy.construct_ambiguity(5, theta, _c(planes["lam"]),
                                    _c(planes["h"]), planes["rho"])
    b = privacy.construct_ambiguity(5, theta, _c(planes["lam"]),
                                    _c(planes["h"]), planes["rho"])
    c = privacy.construct_ambiguity(6, theta, _c(planes["lam"]),
                                    _c(planes["h"]), planes["rho"])
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])


def test_underdetermination_and_inversion_guess(planes):
    assert privacy.underdetermination(10) == jprivacy.underdetermination(10)
    assert privacy.underdetermination(10)["slack"] == 3
    Th = t(planes["Theta"])
    view = privacy.eavesdropper_view(t(planes["theta"]), _c(planes["lam"]),
                                     _c(planes["h"]), planes["rho"], Th, Th)
    guess = privacy.model_inversion_attack(view, 6, planes["rho"], 0)
    assert guess is view.Theta_new
    rmse = float(torch.sqrt(torch.mean((guess - t(planes["theta"][0])) ** 2)))
    assert rmse > 0.0   # the digital uplink's is exactly 0
