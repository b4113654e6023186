"""The port's one-pass OTA round against the JAX package's.

``transport.ota_round_fused`` / ``ota_round_stats`` against
``repro.core.transport.ota_round_fused(backend="jnp")`` for noise × power
control × {plain, mask, csi, mask+csi, deep-fade}, the worker-streamed
round (chunks 1, 2, 3, 5, 7 at W = 7, the all-masked chunk and round), and
the fused AR(1) channel step; the plain kernels B6/B7 and B3/B3′ against the
Pallas kernels in interpret mode.  Noise, mask, CSI and innovation planes
are drawn in JAX and injected.  Port against port, on the CPU: the fused
round is the composed ``ota_uplink`` bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import transport as jt  # noqa: E402
from repro.core.channel import ChannelConfig as JChannelConfig  # noqa: E402
from repro.core.cplx import Complex as JComplex  # noqa: E402
from repro.kernels import ota as jota  # noqa: E402
from repro.kernels import ota_round as jround  # noqa: E402
from repro.phy.scenario import participation_mask as jmask  # noqa: E402

from repro_torch import rng  # noqa: E402
from repro_torch.core import transport  # noqa: E402
from repro_torch.core.channel import ChannelConfig  # noqa: E402
from repro_torch.core.channel import \
    matched_filter_noise as port_noise  # noqa: E402
from repro_torch.core.cplx import Complex  # noqa: E402
from repro_torch.kernels import build, ota, ota_round, ref  # noqa: E402
from repro_torch.phy import gauss_markov_step  # noqa: E402

KEY = jax.random.PRNGKey(0)
RHO = 0.7
#: as tests/test_fused_round.py: the sums run in another order than XLA's
#: and the kernels multiply by 1/ρ where the JAX oracle divides
TOL = dict(rtol=1e-5, atol=1e-6)
SCENARIOS = ["plain", "mask", "csi", "mask+csi", "deep-fade"]


def _t(x):
    return torch.from_numpy(np.array(x))


def _pc(z):
    return Complex(_t(z[0]), _t(z[1]))


def _jc(z):
    return JComplex(jnp.asarray(z[0]), jnp.asarray(z[1]))


def _problem(W, d, seed):
    g = np.random.default_rng(seed)
    f = lambda: g.standard_normal((W, d)).astype(np.float32)  # noqa: E731
    s = np.float32(np.sqrt(0.5))
    theta = f()
    lam = (0.3 * f(), 0.3 * f())
    h = (s * f(), s * f())
    h_hat = (h[0] + np.float32(0.1) * f(), h[1] - np.float32(0.05))
    return theta, lam, h, h_hat


def _noise(ccfg_j, d, key=KEY):
    return np.asarray(jt.matched_filter_noise_re(key, (d,), ccfg_j))


def _scenario(name, h):
    """(mask, use h_tx) of a scenario; deep-fade truncates at an h_min
    between the workers' extreme RMS fades, so the mask always splits."""
    W = h[0].shape[0]
    mask = None
    if "mask" in name:
        mask = np.ones(W, bool)
        mask[1] = False
    if name == "deep-fade":
        rms = np.sqrt(np.mean(h[0] ** 2 + h[1] ** 2, axis=1))
        mask = np.asarray(jmask(_jc(h), float((rms.min() + rms.max()) / 2)))
        assert mask.any() and not mask.all()
    return mask, "csi" in name


def _both(theta, lam, h, h_hat, mask, csi, noisy, power_control, W, d,
          **jkw):
    """(port fused, JAX fused, port composed) on the same planes."""
    ccfg_j = JChannelConfig(n_workers=W, noisy=noisy, snr_db=20.0)
    ccfg = ChannelConfig(n_workers=W, noisy=noisy, snr_db=20.0)
    noise = _t(_noise(ccfg_j, d))
    pk = dict(power_control=power_control,
              mask=None if mask is None else _t(mask),
              h_tx=_pc(h_hat) if csi else None)
    port = transport.ota_round_fused(_t(theta), _pc(lam), _pc(h), noise, RHO,
                                     ccfg, **pk, **jkw)
    jax_out = jt.ota_round_fused(
        jnp.asarray(theta), _jc(lam), _jc(h), KEY, RHO, ccfg_j,
        power_control=power_control,
        mask=None if mask is None else jnp.asarray(mask),
        h_tx=_jc(h_hat) if csi else None, backend="jnp",
        worker_chunk=jkw.get("worker_chunk", 0))
    composed = transport.ota_uplink(_t(theta), _pc(lam), _pc(h), noise, RHO,
                                    ccfg, **pk)
    return port, jax_out, composed


# ---------------------------------------------------------------------------
# the fused round against JAX, and against the port's composed uplink
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("noisy", [False, True])
@pytest.mark.parametrize("power_control", [False, True])
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_fused_round_matches_jax(noisy, power_control, scenario):
    W, d = 4, 97
    theta, lam, h, h_hat = _problem(W, d, 1)
    mask, csi = _scenario(scenario, h)
    (T, ia, h_air), (Tj, iaj, _), _ = _both(theta, lam, h, h_hat, mask, csi,
                                            noisy, power_control, W, d)
    np.testing.assert_allclose(T.numpy(), np.asarray(Tj), **TOL)
    np.testing.assert_allclose(float(ia), float(iaj), rtol=1e-5)
    assert np.array_equal(h_air.re.numpy(), h[0])


@pytest.mark.parametrize("power_control", [False, True])
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_fused_round_is_the_composed_uplink_bitwise(power_control, scenario):
    """Port against port on the CPU: the plain B6/B7 use the plain B1, B2
    and B8 expressions, so Θ and α⁻¹ agree bit for bit (noisy link)."""
    W, d = 5, 131
    theta, lam, h, h_hat = _problem(W, d, 2)
    mask, csi = _scenario(scenario, h)
    (T, ia, _), _, (Tc, iac) = _both(theta, lam, h, h_hat, mask, csi, True,
                                     power_control, W, d)
    assert torch.equal(T, Tc)
    assert torch.equal(ia, iac)


def test_ota_round_stats_matches_jax():
    """y, Σ|h|² and the energies of every row, masked rows included."""
    W, d = 5, 200
    theta, lam, h, h_hat = _problem(W, d, 3)
    theta[2] = np.nan                      # a masked row's energy is NaN
    mask = np.array([True, True, False, True, True])
    y, p2, e, h_air = transport.ota_round_stats(
        _t(theta), _pc(lam), _pc(h), RHO, mask=_t(mask), h_tx=_pc(h_hat))
    yj, p2j, ej, _ = jt.ota_round_stats(
        jnp.asarray(theta), _jc(lam), _jc(h), RHO, mask=jnp.asarray(mask),
        h_tx=_jc(h_hat), backend="jnp")
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(p2.numpy(), np.asarray(p2j), **TOL)
    np.testing.assert_allclose(e.numpy(), np.asarray(ej), rtol=1e-5)
    assert np.isnan(e[2].item()) and np.isfinite(y.numpy()).all()
    assert h_air.re is not None and np.array_equal(h_air.re.numpy(), h[0])


# ---------------------------------------------------------------------------
# streamed worker cohorts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [1, 2, 3, 5, 7])
@pytest.mark.parametrize("masked", [False, True])
def test_streamed_matches_jax_and_monolithic(chunk, masked):
    """W = 7: chunks 2, 3 and 5 pad the last cohort with zero rows."""
    W, d = 7, 230
    theta, lam, h, h_hat = _problem(W, d, 5)
    mask = (np.array([True, False, True, True, False, True, True])
            if masked else None)
    (T, ia, _), (Tj, iaj, _), _ = _both(theta, lam, h, h_hat, mask, False,
                                        True, True, W, d, worker_chunk=chunk)
    np.testing.assert_allclose(T.numpy(), np.asarray(Tj), **TOL)
    np.testing.assert_allclose(float(ia), float(iaj), rtol=1e-5)
    (Tm, iam, _), _, _ = _both(theta, lam, h, h_hat, mask, False, True, True,
                               W, d)
    np.testing.assert_allclose(T.numpy(), Tm.numpy(), **TOL)
    np.testing.assert_allclose(float(ia), float(iam), rtol=1e-6)


@pytest.mark.parametrize("dead_chunk", [0, 1])
def test_streamed_all_masked_chunk(dead_chunk):
    """A chunk whose workers are all masked adds exact zeros: no 0/0."""
    W, d, chunk = 8, 64, 4
    theta, lam, h, h_hat = _problem(W, d, 11)
    mask = np.ones(W, bool)
    mask[dead_chunk * chunk:(dead_chunk + 1) * chunk] = False
    (T, ia, _), (Tj, iaj, _), _ = _both(theta, lam, h, h_hat, mask, False,
                                        True, True, W, d, worker_chunk=chunk)
    assert bool(torch.isfinite(T).all()) and bool(torch.isfinite(ia))
    np.testing.assert_allclose(T.numpy(), np.asarray(Tj), **TOL)
    np.testing.assert_allclose(float(ia), float(iaj), rtol=1e-5)


@pytest.mark.parametrize("chunk", [0, 4])
def test_fully_masked_round_stays_finite(chunk):
    W, d = 8, 64
    theta, lam, h, h_hat = _problem(W, d, 12)
    none = np.zeros(W, bool)
    (T, ia, _), (Tj, iaj, _), _ = _both(theta, lam, h, h_hat, none, False,
                                        True, True, W, d, worker_chunk=chunk)
    assert bool(torch.isfinite(T).all()) and float(ia) == 0.0
    np.testing.assert_array_equal(T.numpy(), np.asarray(Tj))
    assert float(iaj) == 0.0


# ---------------------------------------------------------------------------
# the fused AR(1) channel step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("power_control", [False, True])
@pytest.mark.parametrize("rho_f,redraw", [(0.0, True), (0.0, False),
                                          (0.9, True), (0.9, False)])
def test_chan_step_matches_jax_and_fading_then_round(power_control, rho_f,
                                                     redraw):
    """The fused step is JAX's, and (port against port) the fading step
    then the round: h_air bit for bit, Θ bit for bit on the CPU."""
    W, d = 3, 300
    theta, lam, h, _ = _problem(W, d, 4)
    ccfg_j = JChannelConfig(n_workers=W, noisy=True, snr_db=20.0)
    ccfg = ChannelConfig(n_workers=W, noisy=True, snr_db=20.0)
    from repro.core.channel import rayleigh as jrayleigh
    wj = jrayleigh(jax.random.fold_in(KEY, 99), (W, d))
    w = Complex(_t(wj.re), _t(wj.im))
    noise = _t(_noise(ccfg_j, d))
    T, ia, h_air = transport.ota_round_fused(
        _t(theta), _pc(lam), _pc(h), noise, RHO, ccfg,
        power_control=power_control, chan_step=(w, rho_f, redraw))
    Tj, iaj, hj = jt.ota_round_fused(
        jnp.asarray(theta), _jc(lam), _jc(h), KEY, RHO, ccfg_j,
        power_control=power_control,
        chan_step=(wj, rho_f, jnp.asarray(redraw)), backend="jnp",
        worker_chunk=0)
    np.testing.assert_allclose(T.numpy(), np.asarray(Tj), **TOL)
    np.testing.assert_allclose(float(ia), float(iaj), rtol=1e-5)
    np.testing.assert_allclose(h_air.re.numpy(), np.asarray(hj.re),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(h_air.im.numpy(), np.asarray(hj.im),
                               rtol=1e-6, atol=1e-6)
    h2 = gauss_markov_step(_pc(h), w, rho_f, redraw)
    assert torch.equal(h_air.re, h2.re) and torch.equal(h_air.im, h2.im)
    Tc, iac = transport.ota_uplink(_t(theta), _pc(lam), h2, noise, RHO, ccfg,
                                   power_control=power_control)
    assert torch.equal(T, Tc) and torch.equal(ia, iac)
    if rho_f == 0.0:
        want = w if redraw else _pc(h)
        assert torch.equal(h_air.re, want.re)


def test_streamed_chan_step_roundtrips_h():
    W, d = 5, 120
    theta, lam, h, _ = _problem(W, d, 6)
    ccfg = ChannelConfig(n_workers=W, noisy=False)
    g = rng.generator(7, "cpu")
    w = Complex(torch.randn(W, d, generator=g), torch.randn(W, d, generator=g))
    noise = torch.zeros(d)
    T, _, h_air = transport.ota_round_fused(
        _t(theta), _pc(lam), _pc(h), noise, RHO, ccfg, worker_chunk=2,
        chan_step=(w, 0.8, True))
    T0, _, h0 = transport.ota_round_fused(
        _t(theta), _pc(lam), _pc(h), noise, RHO, ccfg,
        chan_step=(w, 0.8, True))
    assert torch.equal(h_air.re, h0.re) and torch.equal(h_air.im, h0.im)
    np.testing.assert_allclose(T.numpy(), T0.numpy(), **TOL)


# ---------------------------------------------------------------------------
# the plain kernels against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

_D_PAD = 1024 + 37          # a multi-block column grid with padding


def _kernel_inputs(variant, W=4, d=_D_PAD, seed=21):
    theta, lam, h, h_hat = _problem(W, d, seed)
    g = np.random.default_rng(seed + 1)
    mask = np.array([True, False, True, True]) if "mask" in variant else None
    htx = h_hat if "csi" in variant else None
    chan = None
    if "chan" in variant:
        w = [g.standard_normal((W, d)).astype(np.float32) for _ in range(2)]
        rho_f = 0.9
        chan = (w[0], w[1], rho_f, float(np.sqrt(1 - rho_f ** 2)),
                "held" not in variant)
    return theta, lam, h, mask, htx, chan


def _port_kw(mask, htx, chan):
    return dict(mask=None if mask is None else _t(mask),
                htx=None if htx is None else (_t(htx[0]), _t(htx[1])),
                chan=None if chan is None else (_t(chan[0]), _t(chan[1]),
                                                *chan[2:]))


def _jax_kw(mask, htx, chan):
    return dict(mask=None if mask is None else jnp.asarray(mask),
                htx=None if htx is None else tuple(map(jnp.asarray, htx)),
                chan=None if chan is None else (
                    jnp.asarray(chan[0]), jnp.asarray(chan[1]), chan[2],
                    chan[3], jnp.asarray(chan[4])),
                block_cols=256, interpret=True)


_VARIANTS = ["plain", "mask", "csi", "chan", "chan-held", "mask+csi+chan"]


@pytest.mark.parametrize("variant", _VARIANTS)
def test_plain_b6_matches_pallas(variant):
    theta, lam, h, mask, htx, chan = _kernel_inputs(variant)
    got = ref.ota_round_stats(_t(theta), _t(lam[0]), _t(lam[1]), _t(h[0]),
                              _t(h[1]), RHO, **_port_kw(mask, htx, chan))
    want = jround.ota_round_stats(theta, lam[0], lam[1], h[0], h[1], RHO,
                                  **_jax_kw(mask, htx, chan))
    assert len(got) == len(want) == (3 if chan is None else 5)
    for name, a, b in zip(("y", "p2", "energy", "h_re", "h_im"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("variant", ["plain", "mask+csi", "mask+csi+chan"])
def test_plain_b7_matches_pallas(variant):
    theta, lam, h, mask, htx, chan = _kernel_inputs(variant, seed=22)
    noise = np.random.default_rng(5).standard_normal(_D_PAD).astype(
        np.float32) * np.float32(1e-3)
    got = ref.ota_round_theta(_t(theta), _t(lam[0]), _t(lam[1]), _t(h[0]),
                              _t(h[1]), _t(noise), torch.tensor(0.37), RHO,
                              **_port_kw(mask, htx, chan))
    want = jround.ota_round_theta(theta, lam[0], lam[1], h[0], h[1], noise,
                                  0.37, RHO, **_jax_kw(mask, htx, chan))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("dyn", [False, True])
def test_plain_b3_matches_pallas(dyn):
    g = np.random.default_rng(9)
    y, z = (g.standard_normal(_D_PAD).astype(np.float32) for _ in range(2))
    p2 = np.abs(g.standard_normal(_D_PAD)).astype(np.float32)
    p2[:5] = 0.0                               # the 1e-12 clamp
    ia = np.float32(0.37)
    if dyn:
        got = ref.ota_demodulate_dyn(_t(y), _t(z), _t(p2), torch.tensor(ia))
        want = jota.ota_demodulate_dyn(y, z, p2, ia, interpret=True)
    else:
        got = ref.ota_demodulate(_t(y), _t(z), _t(p2), float(ia))
        want = jota.ota_demodulate(y, z, p2, float(ia), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_demodulate_takes_b3_for_a_tensor_and_b3prime_for_a_float():
    g = np.random.default_rng(10)
    y, z, p2 = (_t(g.standard_normal(50).astype(np.float32))
                for _ in range(3))
    a = transport.demodulate(y, p2.abs(), z, torch.tensor(0.25))
    b = transport.demodulate(y, p2.abs(), z, 0.25)
    assert torch.equal(a, b)
    want = jt.demodulate(jnp.asarray(y.numpy()), jnp.asarray(p2.abs().numpy()),
                         jnp.asarray(z.numpy()), 0.25, backend="jnp")
    np.testing.assert_allclose(a.numpy(), np.asarray(want), rtol=1e-6)


def test_cpu_round_wrappers_take_plain_version_and_count_nothing():
    theta, lam, h, mask, htx, chan = _kernel_inputs("mask+csi+chan", W=4,
                                                    d=70)
    args = (_t(theta), _t(lam[0]), _t(lam[1]), _t(h[0]), _t(h[1]))
    kw = _port_kw(mask, htx, chan)
    build.reset_launches()
    for a, b in zip(ota_round.ota_round_stats(*args, RHO, **kw),
                    ref.ota_round_stats(*args, RHO, **kw)):
        assert torch.equal(a, b)
    noise, ia = torch.zeros(70), torch.tensor(0.5)
    for a, b in zip(ota_round.ota_round_theta(*args, noise, ia, RHO, **kw),
                    ref.ota_round_theta(*args, noise, ia, RHO, **kw)):
        assert torch.equal(a, b)
    y = args[0][0]
    assert torch.equal(ota.ota_demodulate(y, y, y.abs(), 0.5),
                       ref.ota_demodulate(y, y, y.abs(), 0.5))
    assert sum(build.launches.values()) == 0


def test_cpu_wrappers_take_the_plain_version_whatever_the_plan():
    """A plan picks a kernel's grid on the card; CPU tensors take the plain
    version and launch nothing."""
    theta, lam, h, mask, htx, chan = _kernel_inputs("mask+csi+chan", W=4,
                                                    d=64)
    args = (_t(theta), _t(lam[0]), _t(lam[1]), _t(h[0]), _t(h[1]))
    kw = _port_kw(mask, htx, chan)
    build.reset_launches()
    for plan in (ota_round.row_tiling(4, 64), ota_round.tiling(4, 64)):
        for a, b in zip(ota_round.ota_round_stats(*args, RHO, **kw,
                                                  plan=plan),
                        ref.ota_round_stats(*args, RHO, **kw)):
            assert torch.equal(a.nan_to_num(), b.nan_to_num())
    noise, ia = torch.zeros(64), torch.tensor(0.5)
    for plan in (ota.receive_tiling(4, 64),
                 ota_round.row_tiling(4, 64)._replace(plan="split")):
        assert torch.equal(ota.ota_receive(*args[1:], noise, ia, plan=plan),
                           ref.ota_receive(*args[1:], noise, ia))
    assert sum(build.launches.values()) == 0


@pytest.mark.parametrize("W,d,want", [
    (100, 109_386, ("row", 4, 100, 855, 1)),
    (65_536, 32, ("row", 1, 125, 1, 525)),
    # below the column threshold (W ≤ 16): one thread walks all W rows; k is
    # its load width (4 where d % 4 == 0, else 1), n_tiles its blocks
    (4, 1061, ("column", 1, 4, 5, 1)),
    (7, 1, ("column", 1, 7, 1, 1)),
    (1000, 8, ("row", 1, 8, 1, 125)),
    # the LLM rounds: three blocks an SM of 132, 16-byte loads; then the
    # column plan's most workers and the row plan from one more
    (2, 637_554_688, ("column", 4, 2, 396, 1)),
    (2, 476_967_488, ("column", 4, 2, 396, 1)),
    (2, 568_192, ("column", 4, 2, 396, 1)),
    (16, 109_386, ("column", 1, 16, 396, 1)),
    (17, 109_386, ("row", 4, 17, 855, 1)),
])
def test_kernel_tiling(W, d, want):
    """Many workers: column tiles as wide as the rows allow, then the worker
    axis split toward four blocks an SM, a warp's row at least per slice.
    Few workers: the column plan, a fixed number of blocks an SM striding
    over the columns."""
    t = ota_round.tiling(W, d)
    assert tuple(t) == want
    if t.plan == "row":
        assert t.n_tiles * 32 * t.k >= d
        assert t.n_slices * t.rows_per_slice >= W
    else:
        assert t.n_tiles * ota_round.COLUMN_THREADS * t.k >= d or \
            t.n_tiles == ota_round.COLUMN_BLOCKS_PER_SM * ota_round.SMS
    ota_round.check_tiling("ota_round_stats", t, W, d)


@pytest.mark.parametrize("W,d,aligned,n_sm,want", [
    (2, 637_554_688, False, 132, ("column", 1, 2, 396, 1)),
    (2, 4097, True, 132, ("column", 1, 2, 17, 1)),
    (3, 1000, True, 132, ("column", 4, 3, 1, 1)),
    (2, 568_192, True, 78, ("column", 4, 2, 234, 1)),
    (7, 1 << 20, True, 132, ("column", 4, 7, 396, 1)),
    (8, 4097, True, 132, ("column", 1, 8, 17, 1)),
])
def test_column_plan_grid(W, d, aligned, n_sm, want):
    """The column plan takes scalar loads for a misaligned plane or a d that
    is no multiple of 4, and its grid follows the card's SM count."""
    assert tuple(ota_round.tiling(W, d, n_sm, aligned)) == want


@pytest.mark.parametrize("W,d,want", [
    (65_536, 32, ("split", 1, 125, 1, 525)),
    (4096, 7, ("split", 1, 8, 1, 512)),
    (100, 109_386, ("unsplit", 1, 100, 428, 1)),
    (10, 6, ("unsplit", 1, 10, 1, 1)),
    (32, 32, ("split", 1, 8, 1, 4)),
    (31, 32, ("unsplit", 1, 31, 1, 1)),
    (2, 637_554_688, ("unsplit", 1, 2, 1 << 20, 1)),
])
def test_receive_tiling(W, d, want):
    """B2 splits the worker axis (B6's row plan) only where the columns
    cannot fill the card and the workers are many; the paper MLP's width
    keeps one thread a column."""
    t = ota.receive_tiling(W, d)
    assert tuple(t) == want
    ota_round.check_tiling("ota_receive", t, W, d)


@pytest.mark.parametrize("name,plan,W,d", [
    ("ota_round_stats", ("column", 4, 2, 1, 1), 2, 1001),
    ("ota_round_stats", ("column", 1, 17, 1, 1), 17, 64),
    ("ota_round_stats", ("row", 4, 100, 854, 1), 100, 109_386),
    ("ota_round_stats", ("split", 1, 125, 1, 525), 65_536, 32),
    ("ota_receive", ("row", 1, 125, 1, 525), 65_536, 32),
    ("ota_receive", ("split", 1, 100, 1, 3), 200, 32),
])
def test_check_tiling_refuses_grids_no_kernel_takes(name, plan, W, d):
    with pytest.raises(ValueError, match="no kernel takes"):
        ota_round.check_tiling(name, ota_round.Tiling(*plan), W, d)


def test_noise_re_and_snr_match_jax():
    ccfg = ChannelConfig(n_workers=2, noisy=True)
    full = port_noise(rng.generator(3, "cpu"), (257,), ccfg)
    re = transport.matched_filter_noise_re(rng.generator(3, "cpu"), (257,),
                                           ccfg)
    assert torch.equal(full.re, re)
    off = transport.matched_filter_noise_re(
        rng.generator(3, "cpu"), (5,), ChannelConfig(n_workers=2, noisy=False))
    assert torch.equal(off, torch.zeros(5))
    sig = np.array([4.0, 0.0, np.nan, 1.0, np.inf], np.float32)
    npow = np.array([1.0, 0.0, 1.0, 0.0, 1.0], np.float32)
    got = transport.snr_db_from_power(_t(sig), _t(npow))
    want = jt.snr_db_from_power(jnp.asarray(sig), jnp.asarray(npow))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert float(got[1]) == 0.0
