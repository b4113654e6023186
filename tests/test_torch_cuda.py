"""The CUDA kernels on the card, against their plain versions (needs an
NVIDIA GPU and nvcc; skipped elsewhere).  Imports no JAX, so it also runs on
a machine without it:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (admm_update, build, ota,  # noqa: E402
                                 phy_channel, phy_population, ref)

pytestmark = pytest.mark.cuda
SHAPES = [(3, 1000), (5, 1025), (8, 4097), (100, 109_386)]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _planes(dev, W, d, n, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return [torch.randn((W, d), generator=g, device=dev) * math.sqrt(0.5)
            for _ in range(n)]


def _launched(name, fn):
    before = build.launches[name]
    out = fn()
    torch.cuda.synchronize()
    assert build.launches[name] == before + 1
    return out


@pytest.mark.parametrize("W,d", SHAPES)
def test_modulate_kernel(dev, W, d):
    args = _planes(dev, W, d, 5, 1)
    got = _launched("ota_modulate", lambda: ota.ota_modulate(*args, 0.5))
    for a, b in zip(got, ref.ota_modulate(*args, 0.5)):
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.parametrize("W,d", SHAPES)
@pytest.mark.parametrize("ia", [0.37, 0.0])
def test_receive_kernel(dev, W, d, ia):
    args = _planes(dev, W, d, 4, 2)
    noise = torch.randn(d, device=dev)
    ia_t = torch.tensor(ia, device=dev)
    got = _launched("ota_receive",
                    lambda: ota.ota_receive(*args, noise, ia_t))
    torch.testing.assert_close(got, ref.ota_receive(*args, noise, ia_t),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("W,d", SHAPES)
@pytest.mark.parametrize("with_noise", [False, True])
def test_dual_update_kernel(dev, W, d, with_noise):
    lre, lim, hre, him, th, z = _planes(dev, W, d, 6, 3)
    Th = torch.randn(d, device=dev)
    z = z if with_noise else None
    got = _launched("admm_dual_update", lambda: admm_update.admm_dual_update(
        lre, lim, hre, him, th, Th, 0.5, z))
    want = ref.admm_dual_update(lre, lim, hre, him, th, Th, 0.5, z)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.parametrize("W,d", SHAPES)
def test_flip_lambda_kernel(dev, W, d):
    g, th, hre, him = _planes(dev, W, d, 4, 4)
    hre[0, :5] = 0.0
    him[0, :5] = 0.0
    Th = torch.randn(d, device=dev)
    got = _launched("admm_flip_lambda", lambda: admm_update.admm_flip_lambda(
        g, th, Th, hre, him, 0.5))
    for a, b in zip(got, ref.admm_flip_lambda(g, th, Th, hre, him, 0.5)):
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.parametrize("W,d", SHAPES)
@pytest.mark.parametrize("ia", [0.37, 0.0])
def test_receive_masked_kernel(dev, W, d, ia):
    """A dropped row holding NaN and Inf never reaches Θ."""
    s_re, s_im, h_re, h_im = _planes(dev, W, d, 4, 6)
    mask = torch.arange(W, device=dev) % 3 != 1
    s_re[1] = float("nan")
    h_im[1] = float("inf")
    noise = torch.randn(d, device=dev)
    ia_t = torch.tensor(ia, device=dev)
    got = _launched("ota_receive_masked", lambda: phy_channel.ota_receive_masked(
        s_re, s_im, h_re, h_im, mask, noise, ia_t))
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, ref.ota_receive_masked(
        s_re, s_im, h_re, h_im, mask, noise, ia_t), rtol=1e-5, atol=1e-6)


def test_receive_masked_kernel_all_masked_and_many_rows(dev):
    """Every row masked gives exactly 0 at α⁻¹ = 0; more rows than one
    shared-memory tile of the mask still matches the plain version."""
    s_re, s_im, h_re, h_im = _planes(dev, 9000, 33, 4, 7)
    noise = torch.randn(33, device=dev)
    none = torch.zeros(9000, dtype=torch.bool, device=dev)
    got = phy_channel.ota_receive_masked(s_re, s_im, h_re, h_im, none, noise,
                                         torch.zeros((), device=dev))
    assert torch.equal(got, torch.zeros(33, device=dev))
    mask = torch.rand(9000, device=dev) > 0.3
    ia = torch.tensor(0.5, device=dev)
    torch.testing.assert_close(
        phy_channel.ota_receive_masked(s_re, s_im, h_re, h_im, mask, noise,
                                       ia),
        ref.ota_receive_masked(s_re, s_im, h_re, h_im, mask, noise, ia),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("W,d", SHAPES)
@pytest.mark.parametrize("rho,redraw", [(0.9, True), (0.9, False),
                                        (0.0, True)])
def test_fading_step_kernel(dev, W, d, rho, redraw):
    h_re, h_im, w_re, w_im = _planes(dev, W, d, 4, 8)
    scale = math.sqrt(1.0 - rho * rho)
    got = _launched("fading_step", lambda: phy_channel.fading_step(
        h_re, h_im, w_re, w_im, rho, scale, redraw))
    want = ref.fading_step(h_re, h_im, w_re, w_im, rho, scale, redraw)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    if not redraw:
        assert torch.equal(got[0], h_re) and torch.equal(got[1], h_im)


@pytest.mark.parametrize("n", [1000, 4097, 1_000_000])
@pytest.mark.parametrize("redraw,shadow_redraw", [(True, True),
                                                  (False, False)])
def test_population_step_kernel(dev, n, redraw, shadow_redraw):
    g = torch.Generator(device=dev)
    g.manual_seed(n)
    planes = [torch.randn(n, generator=g, device=dev) for _ in range(12)]
    planes[4:10] = [p * 300.0 for p in planes[4:10]]       # positions, m
    planes[6][: n // 4] = planes[4][: n // 4] + 1e-3        # arrivals
    planes[7][: n // 4] = planes[5][: n // 4]
    planes[10:] = [10.0 ** (0.6 * p) for p in planes[10:]]  # shadowing
    scalars = (0.95, math.sqrt(1 - 0.95 ** 2), redraw, 0.015, 1.0, 250.0,
               3.2, shadow_redraw)
    got = _launched("population_step", lambda: phy_population.population_step(
        *planes, *scalars))
    want = ref.population_step(*planes, *scalars)
    assert len(got) == 8
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_wrappers_refuse_bad_operands(dev):
    a, b = _planes(dev, 2, 8, 2, 5)
    with pytest.raises(ValueError, match="not contiguous"):
        ota.ota_modulate(a.t(), a.t(), a.t(), a.t(), a.t(), 0.5)
    with pytest.raises(ValueError, match="float32"):
        ota.ota_modulate(a.double(), a, a, b, b, 0.5)
    with pytest.raises(ValueError, match="shape"):
        ota.ota_modulate(a, a[:, :4].contiguous(), a, b, b, 0.5)
    with pytest.raises(ValueError, match="one-element tensor"):
        ota.ota_receive(a, a, b, b, torch.zeros(8, device=dev), 0.5)
    with pytest.raises(ValueError, match="Theta"):
        admm_update.admm_dual_update(a, a, b, b, a, torch.zeros(7, device=dev),
                                     0.5)
    z8, ia = torch.zeros(8, device=dev), torch.zeros((), device=dev)
    with pytest.raises(ValueError, match="mask"):
        phy_channel.ota_receive_masked(a, a, b, b, torch.ones(2, device=dev),
                                       z8, ia)
    with pytest.raises(ValueError, match="shape"):
        phy_channel.fading_step(a, a, b, b[:, :4].contiguous(), 0.5, 0.8,
                                True)
    with pytest.raises(ValueError, match="want"):
        phy_population.population_step(*([a] * 12), 0.9, 0.4, True, 0.1, 1.0,
                                       250.0, 3.0, True)
