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
