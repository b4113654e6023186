"""The port's kernel plain versions (B1 modulate, B2 receive, B4 dual update,
B5 flip rule) against the JAX package's Pallas kernels (interpret mode) and
its jnp references, on the same numpy inputs at unaligned shapes; and the
wrappers' CPU contract: plain version, no launch counted."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import transport as jtransport  # noqa: E402
from repro.core.channel import ChannelConfig as JChannelConfig  # noqa: E402
from repro.core.cplx import Complex as JComplex  # noqa: E402
from repro.kernels import admm_update as jadmm  # noqa: E402
from repro.kernels import ota as jota  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

from repro_torch.kernels import admm_update, build, ota, ref  # noqa: E402

SHAPES = [(3, 1000), (5, 1025), (8, 4097)]
RHO = 0.5
#: elementwise kernels: same f32 expression, last-ulp differences only
ELEM_TOL = dict(rtol=1e-6, atol=1e-6)
#: receive sums over W in another order than XLA does
RECV_TOL = dict(rtol=1e-5, atol=1e-6)


def _planes(W, d, seed, n):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((W, d)).astype(np.float32) for _ in range(n)]


def _vec(d, seed, scale=1.0):
    rng = np.random.default_rng(seed + 1000)
    return (scale * rng.standard_normal(d)).astype(np.float32)


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _close(port, want, tol):
    np.testing.assert_allclose(port.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("W,d", SHAPES)
def test_modulate_matches_jax(W, d):
    th, lre, lim, hre, him = _planes(W, d, W * d, 5)
    sre, sim = ref.ota_modulate(*_t(th, lre, lim, hre, him), RHO)
    flat = [x.reshape(-1) for x in (th, lre, lim, hre, him)]
    pre, pim = jota.ota_modulate(*flat, RHO, interpret=True)
    _close(sre.reshape(-1), pre, ELEM_TOL)
    _close(sim.reshape(-1), pim, ELEM_TOL)
    jre, jim = jref.ota_modulate(th, lre, lim, hre, him, RHO)
    _close(sre, jre, ELEM_TOL)
    _close(sim, jim, ELEM_TOL)


@pytest.mark.parametrize("W,d", SHAPES)
def test_receive_matches_jax(W, d):
    sre, sim, hre, him = _planes(W, d, W * d + 1, 4)
    ccfg = JChannelConfig(n_workers=W, noisy=True)
    key = jax.random.PRNGKey(W + d)
    ia = np.float32(0.37)
    # the jnp receive draws its noise from the key; replay that draw
    from repro.core.channel import matched_filter_noise
    noise = np.asarray(matched_filter_noise(key, (d,), ccfg).re)
    got = ref.ota_receive(*_t(sre, sim, hre, him, noise), torch.tensor(ia))
    pal = jota.ota_receive(sre, sim, hre, him, noise, ia, interpret=True)
    _close(got, pal, RECV_TOL)
    jnp_out = jtransport.receive(JComplex(sre, sim), JComplex(hre, him), key,
                                 ccfg, jnp.float32(ia), backend="jnp")
    _close(got, jnp_out, RECV_TOL)


@pytest.mark.parametrize("W,d", SHAPES)
@pytest.mark.parametrize("with_noise", [False, True])
def test_dual_update_matches_jax(W, d, with_noise):
    lre, lim, hre, him, th, z = _planes(W, d, W * d + 2, 6)
    Th = _vec(d, W * d)
    z = z if with_noise else None
    got = ref.admm_dual_update(*_t(lre, lim, hre, him, th, Th), RHO,
                               None if z is None else torch.from_numpy(z))
    zp = np.zeros((W, d), np.float32) if z is None else z
    flat = [x.reshape(-1) for x in
            (lre, lim, hre, him, th, np.broadcast_to(Th, (W, d)), zp)]
    pre, pim = jadmm.admm_dual_update(*flat[:6], RHO, flat[6], interpret=True)
    _close(got[0].reshape(-1), pre, ELEM_TOL)
    _close(got[1].reshape(-1), pim, ELEM_TOL)
    jre, jim = jref.admm_dual_update(lre, lim, hre, him, th, Th, RHO, zp)
    _close(got[0], jre, ELEM_TOL)
    _close(got[1], jim, ELEM_TOL)


@pytest.mark.parametrize("W,d", SHAPES)
def test_flip_lambda_matches_jax(W, d):
    g, th, hre, him = _planes(W, d, W * d + 3, 4)
    hre[0, :7] = 0.0          # exercise the 1e-12 clamp: |h|² == 0
    him[0, :7] = 0.0
    Th = _vec(d, W * d + 3)
    got = ref.admm_flip_lambda(*_t(g, th, Th, hre, him), RHO)
    flat = [x.reshape(-1) for x in
            (g, th, np.broadcast_to(Th, (W, d)), hre, him)]
    pre, pim = jadmm.admm_flip_lambda(*flat, RHO, interpret=True)
    _close(got[0].reshape(-1), pre, ELEM_TOL)
    _close(got[1].reshape(-1), pim, ELEM_TOL)
    jre, jim = jref.admm_flip_lambda(g, th, Th, hre, him, RHO)
    _close(got[0], jre, ELEM_TOL)
    _close(got[1], jim, ELEM_TOL)
    assert torch.all(got[0][0, :7] == 0) and torch.all(got[1][0, :7] == 0)


def test_receive_zero_inv_alpha_adds_no_noise():
    """All workers energy-free ⇒ 1/α = 0: finite noise contributes 0."""
    sre, sim, hre, him = _t(*_planes(4, 33, 7, 4))
    noise = torch.from_numpy(_vec(33, 7, 1e3))
    got = ref.ota_receive(sre, sim, hre, him, noise, torch.tensor(0.0))
    clean = ref.ota_receive(sre, sim, hre, him, torch.zeros(33),
                            torch.tensor(0.0))
    assert torch.equal(got, clean)


def test_cpu_wrappers_take_plain_version_and_count_nothing():
    W, d = 3, 1000
    th, lre, lim, hre, him, g = _t(*_planes(W, d, 11, 6))
    Th, noise = _t(_vec(d, 11), _vec(d, 12))
    ia = torch.tensor(0.5)
    build.reset_launches()
    for got, want in [
        (ota.ota_modulate(th, lre, lim, hre, him, RHO),
         ref.ota_modulate(th, lre, lim, hre, him, RHO)),
        ((ota.ota_receive(th, lre, hre, him, noise, ia),),
         (ref.ota_receive(th, lre, hre, him, noise, ia),)),
        (admm_update.admm_dual_update(lre, lim, hre, him, th, Th, RHO),
         ref.admm_dual_update(lre, lim, hre, him, th, Th, RHO)),
        (admm_update.admm_flip_lambda(g, th, Th, hre, him, RHO),
         ref.admm_flip_lambda(g, th, Th, hre, him, RHO)),
    ]:
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert sum(build.launches.values()) == 0
