"""The CUDA kernels on the card, against their plain versions (needs an
NVIDIA GPU and nvcc; skipped elsewhere).  Imports no JAX, so it also runs on
a machine without it:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (admm_update, build, ota,  # noqa: E402
                                 ota_round, phy_channel, phy_population, ref)

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


#: B6/B7 sum W terms of size ~1 in another order than the plain version's
#: tree sum: y and p2 carry ~W·1e-7 of absolute rounding, Θ = y/p2 ~1e-7
ROUND_TOL = dict(rtol=1e-5, atol=1e-4)
ROUND_SHAPES = SHAPES + [(65_536, 32), (1000, 8)]
ROUND_MODES = ["plain", "mask", "csi", "chan", "chan-held", "mask+csi+chan"]


def _round_inputs(dev, W, d, mode, seed=9):
    theta, lre, lim, hre, him, tre, tim, wre, wim = _planes(dev, W, d, 9, seed)
    theta = theta * 0.1
    mask = htx = chan = None
    if "mask" in mode:
        mask = torch.arange(W, device=dev) % 5 != 2
        theta[2] = float("nan")              # a dropped row's NaN stays out
        hre[2] = float("inf")
    if "csi" in mode:
        htx = (tre, tim)
    if "chan" in mode:
        chan = (wre, wim, 0.9755, math.sqrt(1 - 0.9755 ** 2),
                "held" not in mode)
    return (theta, lre, lim, hre, him), dict(mask=mask, htx=htx, chan=chan)


def _close_round(got, want, mask):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        if i == 2 and mask is not None:       # energies: the NaN row's too
            assert torch.isnan(a[2]) and torch.isnan(b[2])
            keep = torch.arange(a.numel(), device=a.device) != 2
            a, b = a[keep], b[keep]
        tol = ROUND_TOL if i < 3 else dict(rtol=1e-6, atol=1e-6)
        if i == 2:
            tol = dict(rtol=1e-5, atol=0.0)
        torch.testing.assert_close(a, b, **tol)


@pytest.mark.parametrize("W,d", ROUND_SHAPES)
@pytest.mark.parametrize("mode", ROUND_MODES)
def test_round_stats_kernel(dev, W, d, mode):
    planes, kw = _round_inputs(dev, W, d, mode)
    got = _launched("ota_round_stats",
                    lambda: ota_round.ota_round_stats(*planes, 0.5, **kw))
    want = ref.ota_round_stats(*planes, 0.5, **kw)
    _close_round(got, want, kw["mask"])
    assert bool(torch.isfinite(got[0]).all())
    again = ota_round.ota_round_stats(*planes, 0.5, **kw)
    for a, b in zip(got, again):             # no atomics: the same bits
        assert torch.equal(a.nan_to_num(), b.nan_to_num())


@pytest.mark.parametrize("W,d", ROUND_SHAPES)
@pytest.mark.parametrize("mode", ["plain", "mask+csi+chan"])
def test_round_theta_kernel(dev, W, d, mode):
    planes, kw = _round_inputs(dev, W, d, mode, seed=10)
    noise = torch.randn(d, device=dev) * 1e-3
    ia = torch.tensor(0.37, device=dev)
    got = _launched("ota_round_theta", lambda: ota_round.ota_round_theta(
        *planes, noise, ia, 0.5, **kw))
    want = ref.ota_round_theta(*planes, noise, ia, 0.5, **kw)
    assert len(got) == len(want)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("d", [1, 1000, 109_386])
def test_demodulate_kernels(dev, d):
    y, z, p2 = (torch.randn(d, device=dev) for _ in range(3))
    p2 = p2.abs()
    p2[: min(d, 3)] = 0.0
    ia = torch.tensor(0.37, device=dev)
    got = _launched("ota_demodulate_dyn",
                    lambda: ota.ota_demodulate_dyn(y, z, p2, ia))
    assert torch.equal(got, ref.ota_demodulate_dyn(y, z, p2, ia))
    got = _launched("ota_demodulate",
                    lambda: ota.ota_demodulate(y, z, p2, 0.37))
    assert torch.equal(got, ref.ota_demodulate(y, z, p2, 0.37))


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
    with pytest.raises(ValueError, match="mask"):
        ota_round.ota_round_stats(a, a, a, b, b, 0.5,
                                  mask=torch.ones(2, device=dev))
    with pytest.raises(ValueError, match="one-element tensor"):
        ota_round.ota_round_theta(a, a, a, b, b, z8, 1.0, 0.5)
    with pytest.raises(ValueError, match="shape"):
        ota.ota_demodulate(z8, z8[:4].contiguous(), z8, 1.0)
