"""The CUDA kernels on the card, against their plain versions (needs an
NVIDIA GPU and nvcc; skipped elsewhere).  Imports no JAX, so it also runs on
a machine without it:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (admm_update, build,  # noqa: E402
                                 flash_attention, linear_scan, ota, ota_round,
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


#: B2's shapes: the unsplit plan's, then the split plan's (the scaleup
#: phase's 65,536 workers over 32 columns; a ragged 7-column tile)
RECEIVE_SHAPES = SHAPES + [(65_536, 32), (4096, 7)]


@pytest.mark.parametrize("W,d", RECEIVE_SHAPES)
@pytest.mark.parametrize("ia", [0.37, 0.0])
def test_receive_kernel(dev, W, d, ia):
    args = _planes(dev, W, d, 4, 2)
    noise = torch.randn(d, device=dev)
    ia_t = torch.tensor(ia, device=dev)
    got = _launched("ota_receive",
                    lambda: ota.ota_receive(*args, noise, ia_t))
    torch.testing.assert_close(got, ref.ota_receive(*args, noise, ia_t),
                               rtol=1e-5, atol=1e-6)
    again = ota.ota_receive(*args, noise, ia_t)
    assert torch.equal(got, again)           # no atomics: the same bits


@pytest.mark.parametrize("W,d", [(100, 109_386), (65_536, 32), (300, 33)])
def test_receive_plans(dev, W, d):
    """Both of B2's plans at one shape, each against the plain version; the
    planned launch is bit for bit the launch of the plan it picked."""
    args = _planes(dev, W, d, 4, 12)
    noise = torch.randn(d, device=dev) * 1e-3
    ia = torch.tensor(0.37, device=dev)
    want = ref.ota_receive(*args, noise, ia)
    planned = ota.receive_tiling(W, d, ota_round.sm_count(dev))
    unsplit = ota_round.Tiling("unsplit", 1, W, -(-d // 256), 1)
    split = ota_round.row_tiling(W, d)._replace(plan="split")
    for plan in (unsplit, split):
        got = _launched("ota_receive", lambda: ota.ota_receive(
            *args, noise, ia, plan=plan))
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        if plan.plan == planned.plan:
            assert torch.equal(got, ota.ota_receive(*args, noise, ia))


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
#: the row plan's shapes (W ≥ 8) and the column plan's: (3, 1000) and
#: (5, 1025) from SHAPES, d % 4 != 0 (scalar loads, ragged) and d % 4 == 0
#: (16-byte loads) up to 10⁶ columns
ROUND_SHAPES = SHAPES + [(65_536, 32), (1000, 8), (2, 4097), (3, 1_000_003),
                         (2, 1 << 20)]
ROUND_MODES = ["plain", "mask", "csi", "chan", "chan-held", "mask+csi+chan"]


def _round_inputs(dev, W, d, mode, seed=9):
    theta, lre, lim, hre, him, tre, tim, wre, wim = _planes(dev, W, d, 9, seed)
    theta = theta * 0.1
    mask = htx = chan = None
    if "mask" in mode:
        bad = _bad_row(W)
        rows = torch.arange(W, device=dev)
        mask = (rows % 5 != 2) & (rows != bad)
        theta[bad] = float("nan")            # a dropped row's NaN stays out
        hre[bad] = float("inf")
    if "csi" in mode:
        htx = (tre, tim)
    if "chan" in mode:
        chan = (wre, wim, 0.9755, math.sqrt(1 - 0.9755 ** 2),
                "held" not in mode)
    return (theta, lre, lim, hre, him), dict(mask=mask, htx=htx, chan=chan)


def _bad_row(W):
    """The masked row that holds NaN and Inf: row 2, or the last of fewer."""
    return 2 if W > 2 else W - 1


def _close_round(got, want, mask):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        if i == 2 and mask is not None:       # energies: the NaN row's too
            bad = _bad_row(a.numel())
            assert torch.isnan(a[bad]) and torch.isnan(b[bad])
            keep = torch.arange(a.numel(), device=a.device) != bad
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


def _misaligned(x):
    """A contiguous copy of ``x`` whose storage starts one float past a
    16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.parametrize("W,d", [(2, 4096), (3, 1000)])
@pytest.mark.parametrize("mode", ["plain", "mask+csi+chan"])
def test_round_kernels_misaligned_planes(dev, W, d, mode):
    """d % 4 == 0 but a plane 4 bytes off a 16-byte boundary: the column
    plan takes its scalar loads, and refuses 16-byte loads there."""
    planes, kw = _round_inputs(dev, W, d, mode, seed=13)
    planes = (_misaligned(planes[0]),) + planes[1:]
    assert planes[0].data_ptr() % 16 != 0
    t = ota_round.tiling(W, d, ota_round.sm_count(dev),
                         ota_round.aligned16(*planes))
    assert t.plan == "column" and t.k == 1
    got = _launched("ota_round_stats",
                    lambda: ota_round.ota_round_stats(*planes, 0.5, **kw))
    _close_round(got, ref.ota_round_stats(*planes, 0.5, **kw), kw["mask"])
    again = ota_round.ota_round_stats(*planes, 0.5, **kw)
    for a, b in zip(got, again):             # no atomics: the same bits
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
    noise = _misaligned(torch.randn(d, device=dev) * 1e-3)
    ia = torch.tensor(0.37, device=dev)
    got = _launched("ota_round_theta", lambda: ota_round.ota_round_theta(
        *planes, noise, ia, 0.5, **kw))
    want = ref.ota_round_theta(*planes, noise, ia, 0.5, **kw)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    assert all(torch.equal(a, b) for a, b in zip(got, ota_round.
               ota_round_theta(*planes, noise, ia, 0.5, **kw)))
    with pytest.raises(RuntimeError, match="launch failed"):
        ota_round.ota_round_stats(*planes, 0.5, **kw,
                                  plan=t._replace(k=4))


@pytest.mark.parametrize("W,d", [(4, 10_000), (7, 4097), (16, 1000)])
@pytest.mark.parametrize("mode", ["plain", "mask+csi+chan"])
def test_round_plans_agree(dev, W, d, mode):
    """Row and column plan on the same planes, each against the plain
    version, up to the column plan's most rows."""
    planes, kw = _round_inputs(dev, W, d, mode, seed=14)
    want = ref.ota_round_stats(*planes, 0.5, **kw)
    for plan in (ota_round.row_tiling(W, d),
                 ota_round.column_tiling(W, d, ota_round.sm_count(dev))):
        got = _launched("ota_round_stats", lambda: ota_round.ota_round_stats(
            *planes, 0.5, **kw, plan=plan))
        _close_round(got, want, kw["mask"])
        again = ota_round.ota_round_stats(*planes, 0.5, **kw, plan=plan)
        for a, b in zip(got, again):
            assert torch.equal(a.nan_to_num(), b.nan_to_num())


@pytest.mark.parametrize("mode", ["plain", "mask+csi+chan"])
def test_column_plan_rounds_as_the_plain_version(dev, mode):
    """At W = 2 the column plan's y, p2, Θ and stepped channel are the
    plain version's bits: each product and sum is rounded as there, and
    the two rows are summed in order."""
    W, d = 2, 1 << 20
    planes, kw = _round_inputs(dev, W, d, mode, seed=15)
    got = ota_round.ota_round_stats(*planes, 0.5, **kw)
    want = ref.ota_round_stats(*planes, 0.5, **kw)
    for i in (0, 1, *range(3, len(want))):
        assert torch.equal(got[i], want[i]), i
    noise = torch.randn(d, device=dev) * 1e-3
    ia = torch.tensor(0.37, device=dev)
    got = ota_round.ota_round_theta(*planes, noise, ia, 0.5, **kw)
    want = ref.ota_round_theta(*planes, noise, ia, 0.5, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_round_plans_refuse_what_no_kernel_takes(dev):
    planes, _ = _round_inputs(dev, 17, 64, "plain")
    with pytest.raises(ValueError, match="no kernel takes"):
        ota_round.ota_round_stats(*planes, 0.5, plan=ota_round.Tiling(
            "column", 1, 17, 1, 1))
    with pytest.raises(ValueError, match="no kernel takes"):
        ota.ota_receive(*planes[1:], torch.zeros(64, device=dev),
                        torch.ones((), device=dev),
                        plan=ota_round.row_tiling(17, 64))


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


# ---------------------------------------------------------------------------
# B11 flash attention
# ---------------------------------------------------------------------------

#: (B, H, S, T): square, ragged S = T, T < S, T > S
FLASH_SHAPES = [(2, 3, 128, 128), (1, 2, 100, 100), (2, 2, 96, 40),
                (1, 3, 40, 130)]
#: f32: the kernels sum in another order than the plain version; bf16: the
#: outputs are rounded to bf16 (about 4e-3 relative), held to 1e-2
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


def _flash_inputs(dev, B, H, S, T, hd, dtype, seed=11):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    return r(B, H, S, hd), r(B, H, T, hd), r(B, H, T, hd), r(B, H, S, hd)


def _flash_close(got, want, dtype):
    tol = FLASH_TOL[dtype]
    for a, b in zip(got, want):
        scale = float(b.float().abs().max())
        torch.testing.assert_close(a.float(), b.float(), rtol=tol,
                                   atol=tol * max(scale, 1.0))


@pytest.mark.parametrize("hd", flash_attention.HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,S,T", FLASH_SHAPES)
def test_flash_kernels(dev, hd, causal, dtype, B, H, S, T):
    q, k, v, do = _flash_inputs(dev, B, H, S, T, hd, dtype)
    o, lse = _launched("flash_attention_fwd",
                       lambda: flash_attention.flash_attention_fwd(
                           q, k, v, causal))
    o_ref, lse_ref = ref.flash_attention_fwd(q, k, v, causal)
    _flash_close([o], [o_ref], dtype)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-5)
    delta = flash_attention.attention_delta(o, do)
    dq = _launched("flash_attention_dq", lambda: flash_attention.
                   flash_attention_dq(q, k, v, do, lse, delta, causal))
    dk, dv = _launched("flash_attention_dkv", lambda: flash_attention.
                       flash_attention_dkv(q, k, v, do, lse, delta, causal))
    want = ref.flash_attention_bwd(q, k, v, do, causal, lse=lse, delta=delta)
    for a, b in zip((dq, dk, dv), want):
        assert a.dtype == dtype and a.shape == b.shape
    _flash_close((dq, dk, dv), want, dtype)


def test_flash_kernels_bitwise_repeatable_and_counted(dev):
    q, k, v, do = _flash_inputs(dev, 2, 4, 300, 300, 64, torch.bfloat16)
    build.reset_launches()
    o1, l1 = flash_attention.flash_attention_fwd(q, k, v)
    o2, l2 = flash_attention.flash_attention_fwd(q, k, v)
    delta = flash_attention.attention_delta(o1, do)
    g1 = flash_attention.flash_attention_bwd(q, k, v, o1, l1, do)
    g2 = flash_attention.flash_attention_bwd(q, k, v, o1, l1, do)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2) and torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    assert dict(build.launches) == {"flash_attention_fwd": 2,
                                    "flash_attention_dq": 2,
                                    "flash_attention_dkv": 2}
    assert delta.dtype == torch.float32


@pytest.mark.parametrize("B,H,S,T,causal", [(1, 2, 1000, 1000, True),
                                             (1, 2, 384, 200, False),
                                             (1, 2, 200, 384, False)])
def test_flash_bf16_tensor_cores_multi_tile(dev, B, H, S, T, causal):
    """bf16 at hd = 128 over several query and key tiles of the
    tensor-core kernels (128-row forward and dq blocks, 64- and 128-key
    tiles, 64-row dk/dv tiles), ragged in S and T."""
    q, k, v, do = _flash_inputs(dev, B, H, S, T, 128, torch.bfloat16)
    o, lse = _launched("flash_attention_fwd",
                       lambda: flash_attention.flash_attention_fwd(
                           q, k, v, causal))
    o_ref, lse_ref = ref.flash_attention_fwd(q, k, v, causal)
    _flash_close([o], [o_ref], torch.bfloat16)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-5)
    delta = flash_attention.attention_delta(o, do)
    dq = _launched("flash_attention_dq", lambda: flash_attention.
                   flash_attention_dq(q, k, v, do, lse, delta, causal))
    dk, dv = _launched("flash_attention_dkv", lambda: flash_attention.
                       flash_attention_dkv(q, k, v, do, lse, delta, causal))
    want = ref.flash_attention_bwd(q, k, v, do, causal, lse=lse, delta=delta)
    _flash_close((dq, dk, dv), want, torch.bfloat16)


def test_flash_bf16_bitwise_repeatable_over_tiles(dev):
    """Two launches of each tensor-core kernel agree bit for bit where the
    blocks stream many tiles (S = T = 1,000: 8 query blocks of 128 rows,
    up to 16 key tiles of 64)."""
    q, k, v, do = _flash_inputs(dev, 2, 4, 1000, 1000, 128, torch.bfloat16)
    o1, l1 = flash_attention.flash_attention_fwd(q, k, v)
    o2, l2 = flash_attention.flash_attention_fwd(q, k, v)
    g1 = flash_attention.flash_attention_bwd(q, k, v, o1, l1, do)
    g2 = flash_attention.flash_attention_bwd(q, k, v, o1, l1, do)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2) and torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_flash_autograd_matches_plain_backward(dev):
    q, k, v, do = _flash_inputs(dev, 2, 2, 200, 200, 32, torch.float32)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention.flash_attention(*leaves)
    out.backward(do)
    want = ref.flash_attention_bwd(q, k, v, do)
    _flash_close([t.grad for t in leaves], want, torch.float32)
    _flash_close([out], [ref.flash_attention_fwd(q, k, v)[0]], torch.float32)


def test_flash_wrappers_refuse_bad_operands(dev):
    q, k, v, do = _flash_inputs(dev, 1, 2, 64, 64, 32, torch.float32)
    with pytest.raises(ValueError, match="want cuda"):
        flash_attention.flash_attention_fwd(q, k.cpu(), v)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention.flash_attention_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="dtype"):
        flash_attention.flash_attention_fwd(q, k.bfloat16(), v)
    q48 = torch.zeros(1, 2, 64, 48, device=dev)
    with pytest.raises(ValueError, match="head dim 48"):
        flash_attention.flash_attention_fwd(q48, q48, q48)
    with pytest.raises(ValueError, match="not contiguous"):
        flash_attention.flash_attention_fwd(q.transpose(2, 3), k, v)
    lse = torch.zeros(1, 2, 64, device=dev)
    with pytest.raises(ValueError, match="shape"):
        flash_attention.flash_attention_dq(q, k, v, do,
                                           torch.zeros(1, 2, 10, device=dev),
                                           lse, True)
    with pytest.raises(ValueError, match="float32"):
        flash_attention.flash_attention_dkv(q, k, v, do, lse.double(), lse)


# ---------------------------------------------------------------------------
# B11 on the LLM path: GQA attention and one trainer round
# ---------------------------------------------------------------------------

def test_gqa_attention_grads_match_the_plain_path(dev):
    """4 heads over 2 KV heads (hd 16), S = 64, f32: forward and grads
    w.r.t. params and x on the card (B11) against the CPU (B11's plain
    version); summation order only."""
    from repro_torch.models import layers as L
    from repro_torch.models.config import ModelConfig
    from repro_torch.tree import to_device, tree_leaves

    cfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=64,
                      param_dtype="float32")
    params = L.attention_init(3, cfg, device="cpu")
    g = torch.Generator().manual_seed(4)
    x = torch.randn((2, 64, 64), generator=g)
    cot = torch.randn((2, 64, 64), generator=g)
    results = []
    for d in (torch.device("cpu"), dev):
        p = to_device(params, d)
        for leaf in tree_leaves(p):
            leaf.requires_grad_()
        xx = x.detach().to(d).requires_grad_()
        build.reset_launches()
        out, _ = L.attention_fwd(p, xx, cfg, torch.arange(64, device=d), None)
        (out * cot.to(d)).sum().backward()
        results.append((out.detach().cpu(), xx.grad.cpu(),
                        [leaf.grad.cpu() for leaf in tree_leaves(p)],
                        dict(build.launches)))
    (o0, x0, g0, l0), (o1, x1, g1, l1) = results
    assert not l0
    assert l1 == {"flash_attention_fwd": 1, "flash_attention_dq": 1,
                  "flash_attention_dkv": 1}
    torch.testing.assert_close(o1, o0, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(x1, x0, rtol=1e-4, atol=1e-4)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_reduced_granite_train_step_matches_the_cpu(dev):
    """One replicated-mode round of reduced granite-8b in f32 (W = 4, B = 2,
    S = 16, 2 local steps) on the card against the CPU's plain path from
    the same state and draws.  Σ|h|² divides Θ (Eq. 24), amplifying
    summation-order differences where it is small: rtol/atol 1e-4."""
    import dataclasses

    from repro_torch.core.admm import AdmmConfig
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.models import registry as reg
    from repro_torch.train.llm_trainer import (FLConfig, draw_round,
                                               make_fl_train)
    from repro_torch.tree import to_device, tree_leaves

    cfg = dataclasses.replace(reg.get_config("granite-8b").reduced(),
                              param_dtype="float32")
    model = reg.build_model(cfg)
    W = 4
    flcfg = FLConfig(n_workers=W, local_steps=2, local_lr=1e-2)
    acfg = AdmmConfig(rho=0.5, flip_on_change=False)
    ccfg = ChannelConfig(n_workers=W, snr_db=40.0)
    init_cpu, step_cpu = make_fl_train(model, flcfg, acfg, ccfg,
                                       device="cpu")
    _, step_gpu = make_fl_train(model, flcfg, acfg, ccfg)
    st = init_cpu(0)
    draws = draw_round(7, st, ccfg)
    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (W, 2, 16), generator=g,
                           dtype=torch.int32)
    want, m_cpu = step_cpu(st, {"tokens": tokens}, draws=draws)
    build.reset_launches()
    got, m_gpu = step_gpu(to_device(st, dev), {"tokens": tokens.to(dev)},
                          draws=to_device(draws, dev))
    torch.cuda.synchronize()
    assert dict(build.launches) == {
        "flash_attention_fwd": 8, "flash_attention_dq": 4,
        "flash_attention_dkv": 4, "ota_round_stats": 1,
        "ota_demodulate_dyn": 1, "admm_dual_update": 1}
    tol = dict(rtol=1e-4, atol=1e-4)
    for k in ("loss", "theta_drift", "inv_alpha"):
        torch.testing.assert_close(m_gpu[k].cpu(), m_cpu[k], **tol)
    for a, b in zip(tree_leaves(got.theta) + tree_leaves(got.Theta),
                    tree_leaves(want.theta) + tree_leaves(want.Theta)):
        torch.testing.assert_close(a.cpu(), b, **tol)
    torch.testing.assert_close(got.lam.re.cpu(), want.lam.re, **tol)
    torch.testing.assert_close(got.lam.im.cpu(), want.lam.im, **tol)


# ---------------------------------------------------------------------------
# B12 gated linear scan and B13 accumulate
# ---------------------------------------------------------------------------

#: (B, S, D) from one step and one channel to the hybrid's full width;
#: ragged S and D, and the SSM's many-channel shape cut short
SCAN_SHAPES = [(1, 1, 1), (1, 2, 3), (2, 37, 19), (3, 1000, 100),
               (1, 257, 129), (2, 9, 4097), (2, 64, 131_072),
               (2, 4096, 2560)]


def _scan_inputs(dev, shape, seed=21):
    """Gates in (0, 1), as exp(dt·A) gives them; N(0, 1) inputs and
    cotangents."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    a = torch.sigmoid(2.0 * torch.randn(shape, generator=g, device=dev))
    b = torch.randn(shape, generator=g, device=dev)
    dh = torch.randn(shape, generator=g, device=dev)
    return a, b, dh


@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=str)
def test_linear_scan_kernels_equal_the_plain_versions(dev, shape):
    """Both kernels round each step as the plain loops do (product, then
    sum): bit for bit."""
    a, b, dh = _scan_inputs(dev, shape)
    h = _launched("linear_scan_fwd", lambda: linear_scan.linear_scan_fwd(a, b))
    assert torch.equal(h, ref.linear_scan(a, b))
    da, db = _launched("linear_scan_bwd",
                       lambda: linear_scan.linear_scan_bwd(a, h, dh))
    want_da, want_db = ref.linear_scan_bwd(a, h, dh)
    assert torch.equal(da, want_da) and torch.equal(db, want_db)


def test_linear_scan_autograd_matches_the_plain_backward(dev):
    a, b, dh = _scan_inputs(dev, (2, 300, 130), seed=22)
    at, bt = a.clone().requires_grad_(), b.clone().requires_grad_()
    build.reset_launches()
    h = linear_scan.gated_linear_scan(at.reshape(2, 300, 10, 13),
                                      bt.reshape(2, 300, 10, 13))
    (h.reshape(2, 300, 130) * dh).sum().backward()
    assert dict(build.launches) == {"linear_scan_fwd": 1,
                                    "linear_scan_bwd": 1}
    want_da, want_db = ref.linear_scan_bwd(a, ref.linear_scan(a, b), dh)
    assert torch.equal(at.grad, want_da) and torch.equal(bt.grad, want_db)


def test_linear_scan_kernels_bitwise_repeatable(dev):
    a, b, dh = _scan_inputs(dev, (2, 513, 2560), seed=23)
    h1 = linear_scan.linear_scan_fwd(a, b)
    h2 = linear_scan.linear_scan_fwd(a, b)
    g1 = linear_scan.linear_scan_bwd(a, h1, dh)
    g2 = linear_scan.linear_scan_bwd(a, h1, dh)
    assert torch.equal(h1, h2)
    assert all(torch.equal(x, y) for x, y in zip(g1, g2))


def test_linear_scan_wrappers_refuse_bad_operands(dev):
    a, b, dh = _scan_inputs(dev, (2, 8, 6))
    with pytest.raises(ValueError, match="want cuda"):
        linear_scan.linear_scan_fwd(a, b.cpu())
    with pytest.raises(ValueError, match="float32"):
        linear_scan.linear_scan_fwd(a.double(), b)
    with pytest.raises(ValueError, match="not contiguous"):
        linear_scan.linear_scan_fwd(a.transpose(1, 2), b.transpose(1, 2))
    with pytest.raises(ValueError, match="differ in shape"):
        linear_scan.linear_scan_fwd(a, b[:, :4].contiguous())
    with pytest.raises(ValueError, match="\\(B, S, D\\)"):
        linear_scan.linear_scan_fwd(a[0], b[0])
    with pytest.raises(ValueError, match="differ in shape"):
        linear_scan.linear_scan_bwd(a, b, dh[:1].contiguous())


#: the staged plan's ragged edges at both stage lengths T: one step, T − 1,
#: T, T + 1, and many stages with a remainder; D of one 4-channel group, of
#: a partial tile, and the hybrid's full width
STAGE_EDGES = sorted({s for T, _ in (linear_scan.LONG_STAGES,
                                     linear_scan.SHORT_STAGES)
                      for s in (T - 1, T, T + 1)} | {1, 1000})
#: each plan by name (the planner's parameters) and both stage lengths
PLAN_CASES = [*linear_scan.PLANS] + [
    linear_scan.ScanTiling("staged", linear_scan.STAGED_CHANNELS, *st)
    for st in (linear_scan.LONG_STAGES, linear_scan.SHORT_STAGES)]


@pytest.mark.parametrize("plan", PLAN_CASES, ids=str)
@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("D", [4, 100, 2560])
@pytest.mark.parametrize("S", STAGE_EDGES)
def test_linear_scan_plans_equal_the_plain_versions(dev, S, D, rows, plan):
    """Either plan, forced, and the staged plan at either stage length,
    rounds each step as the plain loops do: bit for bit, forward and
    backward, one counted launch each."""
    a, b, dh = _scan_inputs(dev, (rows, S, D), seed=S + D + rows)
    h = _launched("linear_scan_fwd",
                  lambda: linear_scan.linear_scan_fwd(a, b, plan))
    assert torch.equal(h, ref.linear_scan(a, b))
    da, db = _launched("linear_scan_bwd",
                       lambda: linear_scan.linear_scan_bwd(a, h, dh, plan))
    want_da, want_db = ref.linear_scan_bwd(a, h, dh)
    assert torch.equal(da, want_da) and torch.equal(db, want_db)


@pytest.mark.parametrize("tiling", [(32, 128, 3), (32, 32, 3), (8, 16, 2),
                                    (16, 64, 4), (32, 256, 2), (8, 8, 3)],
                         ids=str)
def test_staged_parameters_give_the_thread_plans_bits(dev, tiling):
    """Any channels, steps and stages the kernel takes give the same bits,
    at the hybrid's width with a ragged S."""
    a, b, dh = _scan_inputs(dev, (2, 1001, 2560), seed=24)
    t = linear_scan.ScanTiling("staged", *tiling)
    h = linear_scan.linear_scan_fwd(a, b, "thread")
    assert torch.equal(linear_scan.linear_scan_fwd(a, b, t), h)
    want = linear_scan.linear_scan_bwd(a, h, dh, "thread")
    got = linear_scan.linear_scan_bwd(a, h, dh, t)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_staged_plan_bitwise_repeatable(dev):
    a, b, dh = _scan_inputs(dev, (2, 4096, 2560), seed=25)
    assert linear_scan.scan_tiling(2, 4096, 2560).plan == "staged"
    h1 = linear_scan.linear_scan_fwd(a, b, "staged")
    h2 = linear_scan.linear_scan_fwd(a, b, "staged")
    g1 = linear_scan.linear_scan_bwd(a, h1, dh, "staged")
    g2 = linear_scan.linear_scan_bwd(a, h1, dh, "staged")
    assert torch.equal(h1, h2)
    assert all(torch.equal(x, y) for x, y in zip(g1, g2))
    assert torch.equal(h1, linear_scan.linear_scan_fwd(a, b, "thread"))


@pytest.mark.parametrize("plan", linear_scan.PLANS)
def test_linear_scan_autograd_counts_one_launch_a_direction(dev, plan):
    a, b, dh = _scan_inputs(dev, (2, 300, 128), seed=26)
    at, bt = a.clone().requires_grad_(), b.clone().requires_grad_()
    build.reset_launches()
    with linear_scan.forced_plan(plan):
        h = linear_scan.gated_linear_scan(at.reshape(2, 300, 8, 16),
                                          bt.reshape(2, 300, 8, 16))
        (h.reshape(2, 300, 128) * dh).sum().backward()
    assert dict(build.launches) == {"linear_scan_fwd": 1,
                                    "linear_scan_bwd": 1}
    want_da, want_db = ref.linear_scan_bwd(a, ref.linear_scan(a, b), dh)
    assert torch.equal(at.grad, want_da) and torch.equal(bt.grad, want_db)


@pytest.mark.parametrize("plan", linear_scan.PLANS)
def test_chunked_ssm_scan_equals_the_unchunked_one_on_b12(dev, plan):
    """``models/ssm``'s chunked scan (``REPRO_OPT=chunked_scan``) at
    (2, 1,024, 4,096) — 2 sequences, d_inner 256 × state 16 — in chunks of
    512: one B12 launch a chunk and direction; the output and gradients
    those of the whole-sequence scan (each step rounds as B12's own step,
    the carry folded into b₀; the C contraction and the dA sums run per
    chunk)."""
    from repro_torch.models import ssm
    g = torch.Generator(device=dev)
    g.manual_seed(27)
    Bn, S, di, n = 2, 1024, 256, 16
    r = lambda *shape: torch.randn(shape, generator=g, device=dev)  # noqa
    ins = [torch.nn.functional.softplus(r(Bn, S, di) - 1.0), r(Bn, S, n),
           r(Bn, S, n), -torch.exp(0.5 * r(di, n)), r(Bn, S, di)]
    cot = r(Bn, S, di)
    outs = []
    for fn, per_direction in ((ssm._scan_full, 1),
                              (lambda *a: ssm._scan_chunked_fused(*a, 512),
                               2)):
        leaves = [a.clone().requires_grad_() for a in ins]
        build.reset_launches()
        with linear_scan.forced_plan(plan):
            y = fn(*leaves)
            (y * cot).sum().backward()
        assert dict(build.launches) == {"linear_scan_fwd": per_direction,
                                        "linear_scan_bwd": per_direction}
        outs.append((y.detach(), [a.grad for a in leaves]))
    (y0, g0), (y1, g1) = outs
    torch.testing.assert_close(y1, y0, rtol=1e-6, atol=1e-6)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_staged_plan_refuses_what_tma_cannot_take(dev):
    a, b, dh = _scan_inputs(dev, (2, 8, 6))
    with pytest.raises(ValueError, match="not a multiple of 4"):
        linear_scan.linear_scan_fwd(a, b, "staged")
    assert linear_scan.scan_tiling(2, 8, 6).plan == "thread"
    buf = torch.zeros(2 * 8 * 8 + 1, device=dev)
    off = buf[1:].view(2, 8, 8)
    with pytest.raises(ValueError, match="16-byte boundary"):
        linear_scan.linear_scan_bwd(off, off, off, "staged")
    a8, b8, _ = _scan_inputs(dev, (2, 8, 8))
    for bad in ((12, 64, 2), (8, 264, 2), (8, 60, 2), (8, 64, 1),
                (32, 256, 8)):
        with pytest.raises(RuntimeError, match="launch failed"):
            linear_scan.linear_scan_fwd(
                a8, b8, linear_scan.ScanTiling("staged", *bad))


@pytest.mark.parametrize("d", [1, 1000, 109_386])
def test_accumulate_kernel(dev, d):
    y, p2, sre, sim, hre, him = (torch.randn(d, device=dev)
                                 for _ in range(6))
    got = _launched("ota_accumulate",
                    lambda: ota.ota_accumulate(y, p2, sre, sim, hre, him))
    want = ref.ota_accumulate(y, p2, sre, sim, hre, him)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="shape"):
        ota.ota_accumulate(y, torch.zeros(d + 1, device=dev), sre, sim, hre,
                           him)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b"])
def test_reduced_ssm_and_hybrid_train_step_match_the_cpu(dev, arch):
    """One replicated-mode round of the reduced model in f32 (W = 4, B = 2,
    S = 80, past the hybrid's 64-token window; 2 local steps) on the card
    against the CPU's plain path from the same state and draws, as
    ``test_reduced_granite_train_step_matches_the_cpu`` does.  Each local
    step runs B12 forward twice per recurrent layer (the checkpoint's
    recompute) and backward once: 8 and 4 a round for both models."""
    import dataclasses

    from repro_torch.core.admm import AdmmConfig
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.models import registry as reg
    from repro_torch.train.llm_trainer import (FLConfig, draw_round,
                                               make_fl_train)
    from repro_torch.tree import to_device, tree_leaves

    cfg = dataclasses.replace(reg.get_config(arch).reduced(),
                              param_dtype="float32")
    model = reg.build_model(cfg)
    W = 4
    flcfg = FLConfig(n_workers=W, local_steps=2, local_lr=1e-2)
    acfg = AdmmConfig(rho=0.5, flip_on_change=False)
    ccfg = ChannelConfig(n_workers=W, snr_db=40.0)
    init_cpu, step_cpu = make_fl_train(model, flcfg, acfg, ccfg,
                                       device="cpu")
    _, step_gpu = make_fl_train(model, flcfg, acfg, ccfg)
    st = init_cpu(0)
    draws = draw_round(7, st, ccfg)
    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (W, 2, 80), generator=g,
                           dtype=torch.int32)
    want, m_cpu = step_cpu(st, {"tokens": tokens}, draws=draws)
    build.reset_launches()
    got, m_gpu = step_gpu(to_device(st, dev), {"tokens": tokens.to(dev)},
                          draws=to_device(draws, dev))
    torch.cuda.synchronize()
    assert dict(build.launches) == {
        "linear_scan_fwd": 8, "linear_scan_bwd": 4, "ota_round_stats": 1,
        "ota_demodulate_dyn": 1, "admm_dual_update": 1}
    tol = dict(rtol=1e-4, atol=1e-4)
    for k in ("loss", "theta_drift", "inv_alpha"):
        torch.testing.assert_close(m_gpu[k].cpu(), m_cpu[k], **tol)
    for a, b in zip(tree_leaves(got.theta) + tree_leaves(got.Theta),
                    tree_leaves(want.theta) + tree_leaves(want.Theta)):
        torch.testing.assert_close(a.cpu(), b, **tol)
    torch.testing.assert_close(got.lam.re.cpu(), want.lam.re, **tol)
    torch.testing.assert_close(got.lam.im.cpu(), want.lam.im, **tol)


# ---------------------------------------------------------------------------
# the guarded packed round, cohort sampling and the robust LLM rounds
# ---------------------------------------------------------------------------

def test_guarded_packed_round_with_mask_and_csi_matches_the_cpu(dev):
    """The guarded packed round at W = 2 (B6's column plan) with a mask, the
    workers' CSI, a burst and the evict-retransmit guard, on the card
    against the CPU on the same planes: B6 once plus the evict pass, B3′ on
    each of its four epilogues, one B4."""
    from repro_torch.core.admm import AdmmConfig
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.cplx import Complex
    from repro_torch.core.packing import build_packspec
    from repro_torch.core.tree_ota import ota_tree_round_packed_state
    from repro_torch.faults import FaultPlan, GuardConfig
    from repro_torch.faults.guards import GuardDraws
    from repro_torch.faults.plan import RoundFaults
    from repro_torch.tree import to_device

    W, d = 2, 5003
    g = torch.Generator().manual_seed(8)
    theta = {"a": torch.randn((W, 3, 1000), generator=g) * 0.05,
             "b": torch.randn((W, 2003), generator=g) * 0.05}
    spec = build_packspec(theta, batch_dims=1)
    assert spec.d == d
    pl = [torch.randn((W, d), generator=g) * math.sqrt(0.5)
          for _ in range(6)]
    lam, h, htx = Complex(*pl[:2]), Complex(*pl[2:4]), Complex(*pl[4:])
    noise = torch.randn(d, generator=g) * 1e-2
    draws = GuardDraws(burst=torch.randn(d, generator=g),
                       retry_noise=(noise * 2, noise * 3))
    plan = FaultPlan(burst_prob=1.0, burst_std=3.0)
    rf = RoundFaults(alive=torch.tensor([True, True]), straggler=None,
                     corrupt=None, snapshot_due=None,
                     burst_std=torch.tensor(3.0))
    args = dict(mask=torch.tensor([True, True]), h_tx_p=htx,
                Theta_prev={k: v[0] * 0 for k, v in theta.items()},
                guard=GuardConfig(policy="evict-retransmit",
                                  snr_floor_db=0.0),
                guard_draws=draws, faults=(plan, rf, None))
    acfg = AdmmConfig(rho=0.5)
    ccfg = ChannelConfig(n_workers=W, snr_db=20.0)
    T_c, l_c, m_c = ota_tree_round_packed_state(theta, lam, h, noise, acfg,
                                                ccfg, spec, **args)
    build.reset_launches()
    T_g, l_g, m_g = ota_tree_round_packed_state(
        to_device(theta, dev), to_device(lam, dev), to_device(h, dev),
        noise.to(dev), acfg, ccfg, spec, **to_device(args, dev))
    torch.cuda.synchronize()
    assert dict(build.launches) == {"ota_round_stats": 2,
                                    "ota_demodulate": 4,
                                    "admm_dual_update": 1}
    for k in ("guard/retries", "guard/healthy", "guard/ok_first"):
        assert float(m_g[k]) == float(m_c[k]), k
    assert float(m_c["guard/retries"]) >= 1.0
    for k in T_c:
        torch.testing.assert_close(T_g[k].cpu(), T_c[k], rtol=1e-5,
                                   atol=1e-5)
    torch.testing.assert_close(l_g.re.cpu(), l_c.re, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(m_g["inv_alpha"].cpu(), m_c["inv_alpha"],
                               rtol=1e-5, atol=0.0)


def test_sampled_flat_round_matches_the_cpu(dev):
    """A 64-worker cohort of a 4,096-worker population over the
    frequency-flat urban-mobility scenario (the scaleup benchmark's round
    at a small population), on the card against the CPU from the same
    state and draws: B10 over the population, B1/B2/B4 at cohort width."""
    from repro_torch.benchmarks import scaleup
    from repro_torch.tree import to_device

    alg = scaleup.make_alg(4096, 64)
    solve = scaleup.proximal_solver(scaleup.RHO)
    g = torch.Generator().manual_seed(4)
    st = alg.init(3, torch.randn((4096, scaleup.D), generator=g))
    draws = alg.draw(11, st, solve)
    want, m_c = alg.round(11, st, solve, scaleup.zero_grad, draws=draws)
    build.reset_launches()
    got, m_g = alg.round(11, to_device(st, dev), solve, scaleup.zero_grad,
                         draws=to_device(draws, dev))
    torch.cuda.synchronize()
    assert dict(build.launches) == {"population_step": 1, "ota_modulate": 1,
                                    "ota_receive": 1, "admm_dual_update": 1}
    tol = dict(rtol=1e-5, atol=1e-5)
    for a, b in ((got.theta, want.theta), (got.lam.re, want.lam.re),
                 (got.Theta, want.Theta), (got.phys.h.re, want.phys.h.re)):
        torch.testing.assert_close(a.cpu(), b, **tol)
    idx = draws.cohort[:64]
    off = torch.ones(4096, dtype=torch.bool)
    off[idx] = False
    assert torch.equal(got.theta.cpu()[off], st.theta[off])
    assert torch.equal(got.lam.re.cpu()[off], st.lam.re[off])


_ROBUST = {
    "chaos": dict(scenario="markov-doppler", csi_err=0.1,
                  faults=dict(straggler_prob=0.5, straggler_delay=2,
                              burst_prob=1.0, burst_std=3.0),
                  guard=dict(policy="evict-retransmit", snr_floor_db=0.0)),
    "cohort": dict(population=6, cohort=4, cohort_policy="top-gain"),
    "leafwise": dict(packed_uplink=False),
}


@pytest.mark.parametrize("case", list(_ROBUST))
def test_reduced_granite_robust_train_step_matches_the_cpu(dev, case):
    """One round of reduced granite-8b in f32 (W = 4, B = 2, S = 16) under
    a scenario, faults and the guard; sampling a cohort; on the leafwise
    state: on the card against the CPU from the same state and draws, with
    each path's launches."""
    import dataclasses

    from repro_torch.core.admm import AdmmConfig
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.cohort import CohortConfig
    from repro_torch.core.packing import build_packspec
    from repro_torch.faults import FaultPlan, GuardConfig
    from repro_torch.models import registry as reg
    from repro_torch.phy import make_scenario
    from repro_torch.train.llm_trainer import (FLConfig, draw_round,
                                               make_fl_train)
    from repro_torch.tree import to_device, tree_leaves

    fl = dict(_ROBUST[case])
    if "faults" in fl:
        fl["faults"] = FaultPlan(**fl["faults"])
        fl["guard"] = GuardConfig(**fl["guard"])
    cfg = dataclasses.replace(reg.get_config("granite-8b").reduced(),
                              param_dtype="float32")
    model = reg.build_model(cfg)
    W = 4
    flcfg = FLConfig(n_workers=W, local_steps=2, local_lr=1e-2, **fl)
    acfg = AdmmConfig(rho=0.5, flip_on_change=False)
    ccfg = ChannelConfig(n_workers=W, snr_db=40.0, coherence_iters=1)
    init_cpu, step_cpu = make_fl_train(model, flcfg, acfg, ccfg,
                                       device="cpu")
    _, step_gpu = make_fl_train(model, flcfg, acfg, ccfg)
    st = init_cpu(0)
    scn = (make_scenario(fl["scenario"], ccfg, csi_err=fl["csi_err"])
           if "scenario" in fl else None)
    coh = CohortConfig(6, 4, "top-gain") if "population" in fl else None
    draws = draw_round(7, st, ccfg, scenario=scn, faults=fl.get("faults"),
                       guard=fl.get("guard"), cohort=coh)
    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (W, 2, 16), generator=g,
                           dtype=torch.int32)
    want, m_cpu = step_cpu(st, {"tokens": tokens}, draws=draws)
    build.reset_launches()
    got, m_gpu = step_gpu(to_device(st, dev), {"tokens": tokens.to(dev)},
                          draws=to_device(draws, dev))
    torch.cuda.synchronize()
    flash = {"flash_attention_fwd": 8, "flash_attention_dq": 4,
             "flash_attention_dkv": 4}
    n = build_packspec(st.theta, batch_dims=1).n_leaves
    want_launches = {
        "chaos": {"fading_step": 1, "ota_round_stats": 2,
                  "ota_demodulate": 4, "admm_dual_update": 1},
        "cohort": {"ota_round_stats": 1, "ota_demodulate_dyn": 1,
                   "admm_dual_update": 1},
        "leafwise": {"ota_modulate": n, "ota_receive": n,
                     "admm_dual_update": n},
    }[case]
    assert dict(build.launches) == dict(flash, **want_launches)
    tol = dict(rtol=1e-4, atol=1e-4)
    for k in ("loss", "theta_drift", "inv_alpha"):
        torch.testing.assert_close(m_gpu[k].cpu(), m_cpu[k], **tol)
    for a, b in zip(tree_leaves(got.theta) + tree_leaves(got.Theta),
                    tree_leaves(want.theta) + tree_leaves(want.Theta)):
        torch.testing.assert_close(a.cpu(), b, **tol)
    for a, b in zip(tree_leaves(got.lam), tree_leaves(want.lam)):
        torch.testing.assert_close(a.re.cpu(), b.re, **tol)
        torch.testing.assert_close(a.im.cpu(), b.im, **tol)
