"""The port's tree rounds (``core/tree_ota.py``) against the JAX package's:
``ota_tree_round`` packed and ``ota_tree_round_leafwise`` with JAX's
per-leaf noise schedule (leaf i from ``split(key, n_leaves)[i]``), with and
without a mask, CSI and power control; ``init_channel_tree`` and
``step_channel_tree``; the packed round's mask, CSI, ``Theta_prev``, guard
and cohort arguments.  Port against port: packed and leafwise agree bit for
bit without power control and to 1e-6 with it (the energy sums group
differently), a healthy guarded packed round is the unguarded one, and a
cohort round is the round on the gathered rows."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cplx as jcplx  # noqa: E402
from repro.core import tree_ota as jtree  # noqa: E402
from repro.core.admm import AdmmConfig as JAdmmConfig  # noqa: E402
from repro.core.channel import ChannelConfig as JChannelConfig  # noqa: E402
from repro.core.channel import matched_filter_noise  # noqa: E402
from repro.core.channel import rayleigh as jrayleigh  # noqa: E402
from repro.core.transport import matched_filter_noise_re  # noqa: E402

from repro_torch.core import tree_ota  # noqa: E402
from repro_torch.core.admm import AdmmConfig  # noqa: E402
from repro_torch.core.channel import ChannelConfig  # noqa: E402
from repro_torch.core.cplx import Complex  # noqa: E402
from repro_torch.core.packing import build_packspec, pack_cplx  # noqa: E402
from repro_torch.faults import GuardConfig  # noqa: E402
from repro_torch.faults.guards import GuardDraws  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

from torch_replay import t  # noqa: E402

KEY = jax.random.PRNGKey(3)
W = 3
#: one round: the sums in another order than XLA's
TOL = dict(rtol=1e-5, atol=1e-6)


def _problem(seed=0):
    """θ (W, ...) of three leaves (dict order a, b, c), λ and h Complex
    trees, and the workers' CSI, as JAX trees and numpy."""
    k = jax.random.fold_in(KEY, seed)
    shapes = {"a": (W, 4, 5), "b": (W, 7), "c": (W, 2, 3)}
    theta = {n: jax.random.normal(jax.random.fold_in(k, i), s)
             for i, (n, s) in enumerate(shapes.items())}
    lam = {n: jcplx.Complex(
        0.3 * jax.random.normal(jax.random.fold_in(k, 10 + i), s),
        0.3 * jax.random.normal(jax.random.fold_in(k, 20 + i), s))
        for i, (n, s) in enumerate(shapes.items())}
    h = {n: jrayleigh(jax.random.fold_in(k, 30 + i), s)
         for i, (n, s) in enumerate(shapes.items())}
    h_tx = {n: jcplx.Complex(
        h[n].re + 0.1 * jax.random.normal(jax.random.fold_in(k, 40 + i), s),
        h[n].im + 0.1 * jax.random.normal(jax.random.fold_in(k, 50 + i), s))
        for i, (n, s) in enumerate(shapes.items())}
    return theta, lam, h, h_tx


def _port(tree):
    return {n: Complex(t(v.re), t(v.im)) if isinstance(v, jcplx.Complex)
            else t(v) for n, v in tree.items()}


def _cfgs(power_control, noisy=True):
    kw = dict(n_workers=W, noisy=noisy, snr_db=20.0)
    a = dict(rho=0.5, power_control=power_control)
    return JAdmmConfig(**a), JChannelConfig(**kw), AdmmConfig(**a), \
        ChannelConfig(**kw)


def _close_trees(got, want, tol=TOL):
    for name in sorted(want):
        g, w = got[name], want[name]
        if isinstance(w, jcplx.Complex):
            np.testing.assert_allclose(g.re.numpy(), np.asarray(w.re),
                                       err_msg=name, **tol)
            np.testing.assert_allclose(g.im.numpy(), np.asarray(w.im),
                                       err_msg=name, **tol)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       err_msg=name, **tol)


_MODES = {
    "plain": dict(power_control=False, mask=None, csi=False),
    "power": dict(power_control=True, mask=None, csi=False),
    "mask+csi": dict(power_control=True, mask=(True, False, True), csi=True),
    "all-masked": dict(power_control=True, mask=(False, False, False),
                       csi=False),
}


def _mode_args(mode, theta, h_tx):
    m = _MODES[mode]
    mask_j = None if m["mask"] is None else jnp.asarray(m["mask"])
    prev_j = None if m["mask"] is None else jax.tree.map(
        lambda l: jnp.full(l.shape[1:], 7.0), theta)
    jkw = dict(mask=mask_j, h_tx=h_tx if m["csi"] else None,
               Theta_prev=prev_j)
    kw = dict(mask=None if mask_j is None else t(mask_j),
              h_tx=_port(h_tx) if m["csi"] else None,
              Theta_prev=None if prev_j is None else _port(prev_j))
    return m["power_control"], jkw, kw


@pytest.mark.parametrize("mode", list(_MODES))
def test_packed_tree_round_matches_jax(mode):
    theta, lam, h, h_tx = _problem()
    pc, jkw, kw = _mode_args(mode, theta, h_tx)
    jacfg, jccfg, acfg, ccfg = _cfgs(pc)
    key = jax.random.fold_in(KEY, 99)
    T_j, lam_j, m_j = jtree.ota_tree_round(theta, lam, h, key, jacfg, jccfg,
                                           backend="jnp", **jkw)
    D = sum(int(np.prod(v.shape[1:])) for v in theta.values())
    noise = t(matched_filter_noise_re(key, (D,), jccfg))
    T, lam_p, m = tree_ota.ota_tree_round(_port(theta), _port(lam), _port(h),
                                          noise, acfg, ccfg, **kw)
    _close_trees(T, T_j)
    _close_trees(lam_p, lam_j)
    np.testing.assert_allclose(float(m["inv_alpha"]), float(m_j["inv_alpha"]),
                               rtol=1e-5)
    if "participation" in m_j:
        assert float(m["participation"]) == float(m_j["participation"])
    if mode == "all-masked":
        assert all(bool((v == 7.0).all()) for v in T.values())


def _leaf_noise(key, theta, ccfg_j):
    keys = jax.random.split(key, len(theta))
    return [t(matched_filter_noise(k, theta[n].shape[1:], ccfg_j).re)
            for k, n in zip(keys, sorted(theta))]


@pytest.mark.parametrize("mode", list(_MODES))
def test_leafwise_round_matches_jax_on_its_per_leaf_noise(mode):
    """Leaf i's noise from ``split(key, n_leaves)[i]`` (JAX's pinned
    schedule, ``tests/test_transport.py``), injected."""
    theta, lam, h, h_tx = _problem(1)
    pc, jkw, kw = _mode_args(mode, theta, h_tx)
    jacfg, jccfg, acfg, ccfg = _cfgs(pc)
    key = jax.random.fold_in(KEY, 1234)
    T_j, lam_j, m_j = jtree.ota_tree_round_leafwise(
        theta, lam, h, key, jacfg, jccfg, backend="jnp", **jkw)
    build.reset_launches()
    T, lam_p, m = tree_ota.ota_tree_round_leafwise(
        _port(theta), _port(lam), _port(h), _leaf_noise(key, theta, jccfg),
        acfg, ccfg, **kw)
    assert not build.launches
    _close_trees(T, T_j)
    _close_trees(lam_p, lam_j)
    np.testing.assert_allclose(float(m["inv_alpha"]), float(m_j["inv_alpha"]),
                               rtol=1e-5)
    if kw["mask"] is not None:
        # the masked workers' duals keep their bits
        off = ~kw["mask"]
        for n, l in _port(lam).items():
            assert torch.equal(lam_p[n].re[off], l.re[off])
            assert torch.equal(lam_p[n].im[off], l.im[off])


def test_ota_tree_round_packed_false_is_the_leafwise_round():
    theta, lam, h, _ = _problem(2)
    _, jccfg, acfg, ccfg = _cfgs(True)
    noise = _leaf_noise(KEY, theta, jccfg)
    a = tree_ota.ota_tree_round(_port(theta), _port(lam), _port(h), noise,
                                acfg, ccfg, packed=False)
    b = tree_ota.ota_tree_round_leafwise(_port(theta), _port(lam), _port(h),
                                         noise, acfg, ccfg)
    assert all(torch.equal(a[0][n], b[0][n]) for n in a[0])
    assert all(torch.equal(a[1][n].re, b[1][n].re)
               and torch.equal(a[1][n].im, b[1][n].im) for n in a[1])
    with pytest.raises(ValueError, match="noise planes"):
        tree_ota.ota_tree_round_leafwise(_port(theta), _port(lam), _port(h),
                                         noise[:2], acfg, ccfg)


@pytest.mark.parametrize("power_control", [False, True])
def test_packed_and_leafwise_agree(power_control):
    """Port against port on one noise plane (the packed (D,) plane's pieces
    are the leaves'): bit for bit without power control; with it α⁻¹ sums
    the energy per leaf first, so Θ, λ and α⁻¹ agree to 1e-6."""
    theta, lam, h, _ = _problem(4)
    _, jccfg, acfg, ccfg = _cfgs(power_control)
    D = sum(int(np.prod(v.shape[1:])) for v in theta.values())
    noise = t(matched_filter_noise_re(KEY, (D,), jccfg))
    args = (_port(theta), _port(lam), _port(h), noise, acfg, ccfg)
    Tp, lp, mp = tree_ota.ota_tree_round(*args)
    Tl, ll, ml = tree_ota.ota_tree_round(*args, packed=False)
    pairs = [(Tp[n], Tl[n]) for n in Tp] + \
        [(lp[n].re, ll[n].re) for n in lp] + [(lp[n].im, ll[n].im) for n in lp]
    if power_control:
        for a, b in pairs:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(mp["inv_alpha"], ml["inv_alpha"],
                                   rtol=1e-6, atol=0.0)
    else:
        assert all(torch.equal(a, b) for a, b in pairs)
        assert float(mp["inv_alpha"]) == float(ml["inv_alpha"]) == 1.0


def test_init_and_step_channel_tree():
    """Per-leaf blocks keyed by ``split(key, n_leaves)``; a redraw round
    takes the fresh blocks (here JAX's own, so the step is JAX's), the
    others age the channel; a redraw without blocks is refused."""
    theta, _, _, _ = _problem(5)
    pt = _port(theta)
    chan = tree_ota.init_channel_tree(11, pt)
    assert chan.age == 0
    for name, leaf in pt.items():
        assert chan.h[name].re.shape == leaf.shape
    assert not torch.equal(chan.h["a"].re[:, 0, :2], chan.h["b"].re[:, :2])
    again = tree_ota.draw_channel_tree(11, pt)
    assert torch.equal(again[0].re, chan.h["a"].re)
    jccfg = JChannelConfig(n_workers=W, coherence_iters=2)
    ccfg = ChannelConfig(n_workers=W, coherence_iters=2)
    jchan = jtree.init_channel_tree(KEY, theta)
    from repro_torch.core.tree_ota import TreeChannel
    pchan = TreeChannel(h=_port(jchan.h), age=0)
    for r in range(4):
        k = jax.random.fold_in(KEY, r)
        redraw = pchan.age + 1 >= ccfg.coherence_iters
        fresh = None
        if redraw:
            fresh = [Complex(t(z.re), t(z.im)) for z in (
                jrayleigh(kk, theta[n].shape) for kk, n in zip(
                    jax.random.split(k, len(theta)), sorted(theta)))]
        jchan, jredraw = jtree.step_channel_tree(k, jchan, jccfg)
        pchan, pre = tree_ota.step_channel_tree(pchan, ccfg, fresh)
        assert pre == bool(jredraw) and pchan.age == int(jchan.age)
        _close_trees(pchan.h, jchan.h, dict(rtol=0, atol=0))
    with pytest.raises(ValueError, match="fresh"):
        tree_ota.step_channel_tree(TreeChannel(h=pchan.h, age=1), ccfg, None)


# ---------------------------------------------------------------------------
# the packed round's guard and cohort arguments, port against port
# ---------------------------------------------------------------------------

def _packed_inputs(seed=6):
    theta, lam, h, h_tx = _problem(seed)
    pt = _port(theta)
    spec = build_packspec(pt, batch_dims=1)
    return (pt, pack_cplx(spec, _port(lam)), pack_cplx(spec, _port(h)),
            pack_cplx(spec, _port(h_tx)), spec)


def test_healthy_guarded_packed_round_is_the_unguarded_one():
    theta, lam_p, h_p, htx_p, spec = _packed_inputs()
    _, _, acfg, ccfg = _cfgs(True)
    noise = torch.randn(spec.d, generator=torch.Generator().manual_seed(1))
    mask = torch.tensor([True, False, True])
    prev = tree_map(lambda l: l[0] * 0 + 5.0, theta)
    kw = dict(mask=mask, h_tx_p=htx_p, Theta_prev=prev)
    T0, l0, m0 = tree_ota.ota_tree_round_packed_state(
        theta, lam_p, h_p, noise, acfg, ccfg, spec, **kw)
    gcfg = GuardConfig(policy="evict-retransmit", snr_floor_db=-60.0)
    T1, l1, m1 = tree_ota.ota_tree_round_packed_state(
        theta, lam_p, h_p, noise, acfg, ccfg, spec, guard=gcfg,
        guard_draws=GuardDraws(retry_noise=(2 * noise, 3 * noise)),
        worker_chunk=2, **kw)
    assert float(m1["guard/healthy"]) == 1.0
    assert float(m1["guard/retries"]) == 0.0
    assert torch.equal(m0["inv_alpha"], m1["inv_alpha"])
    assert all(torch.equal(T0[n], T1[n]) for n in T0)
    assert torch.equal(l0.re, l1.re) and torch.equal(l0.im, l1.im)
    assert not bool(m1["_fault_aux"]["evicted"].any())
    # the masked worker's dual keeps its bits
    assert torch.equal(l1.re[1], lam_p.re[1])
    with pytest.raises(ValueError, match="Theta_prev"):
        tree_ota.ota_tree_round_packed_state(
            theta, lam_p, h_p, noise, acfg, ccfg, spec, guard=gcfg,
            guard_draws=GuardDraws(retry_noise=(noise, noise)))
    with pytest.raises(ValueError, match="guard_draws"):
        tree_ota.ota_tree_round_packed_state(
            theta, lam_p, h_p, noise, acfg, ccfg, spec, guard=gcfg,
            Theta_prev=prev)
    # telemetry is a pure addition to the guarded round: the same Θ and λ
    # bits, the accepted attempt's obs/ keys beside the guard's
    T2, l2, m2 = tree_ota.ota_tree_round_packed_state(
        theta, lam_p, h_p, noise, acfg, ccfg, spec, guard=gcfg,
        guard_draws=GuardDraws(retry_noise=(2 * noise, 3 * noise)),
        telemetry=True, **kw)
    assert all(torch.equal(T1[n], T2[n]) for n in T1)
    assert torch.equal(l1.re, l2.re) and torch.equal(l1.im, l2.im)
    assert torch.equal(m2["obs/rx_snr_db"], m2["guard/snr_db"])
    assert float(m2["obs/active_workers"]) == 2.0
    assert float(m2["obs/tx_energy"][1]) == 0.0
    assert "obs/theta_update_norm" in m2


def test_guard_evicts_a_nan_worker_and_zeroes_its_dual():
    theta, lam_p, h_p, _, spec = _packed_inputs(7)
    theta = dict(theta, b=theta["b"].clone())
    theta["b"][2] = float("nan")
    _, _, acfg, ccfg = _cfgs(True)
    noise = torch.zeros(spec.d)
    prev = tree_map(lambda l: l[0] * 0, theta)
    T, lam_new, m = tree_ota.ota_tree_round_packed_state(
        theta, lam_p, h_p, noise, acfg, ccfg, spec, Theta_prev=prev,
        guard=GuardConfig(policy="evict"), guard_draws=GuardDraws())
    assert m["_fault_aux"]["evicted"].tolist() == [False, False, True]
    assert float(m["guard/healthy"]) == 1.0
    assert all(bool(torch.isfinite(v).all()) for v in T.values())
    assert not bool(lam_new.re[2].any()) and not bool(lam_new.im[2].any())


def test_cohort_round_is_the_round_on_the_gathered_rows():
    """With ``cohort_idx`` the round gathers λ, h, the mask and the CSI,
    runs at cohort width and scatters λ back: the gathered rows' round bit
    for bit, and the other rows' duals keep their bits."""
    N = 5
    theta, lam, h, h_tx = _problem(8)
    g = torch.Generator().manual_seed(3)
    spec = build_packspec(_port(theta), batch_dims=1)
    lam_pop = Complex(torch.randn((N, spec.d), generator=g),
                      torch.randn((N, spec.d), generator=g))
    h_pop = Complex(torch.randn((N, spec.d), generator=g),
                    torch.randn((N, spec.d), generator=g))
    tx_pop = Complex(h_pop.re + 0.1, h_pop.im - 0.1)
    mask = torch.tensor([True, True, False, True, True])
    idx = torch.tensor([4, 2, 0])
    _, _, acfg, ccfg = _cfgs(True)
    noise = torch.randn(spec.d, generator=g)
    pt = _port(theta)
    T, lam_new, m = tree_ota.ota_tree_round_packed_state(
        pt, lam_pop, h_pop, noise, acfg, ccfg, spec, mask=mask,
        h_tx_p=tx_pop, cohort_idx=idx)
    rows = lambda z: Complex(z.re[idx], z.im[idx])  # noqa: E731
    T2, lam_c, m2 = tree_ota.ota_tree_round_packed_state(
        pt, rows(lam_pop), rows(h_pop), noise, acfg, ccfg, spec,
        mask=mask[idx], h_tx_p=rows(tx_pop))
    assert all(torch.equal(T[n], T2[n]) for n in T)
    assert torch.equal(lam_new.re[idx], lam_c.re)
    off = torch.tensor([1, 3])
    assert torch.equal(lam_new.re[off], lam_pop.re[off])
    assert torch.equal(lam_new.im[off], lam_pop.im[off])
    assert float(m["participation"]) == float(m2["participation"])
    assert float(m["participation"]) == pytest.approx(2 / 3)
    assert torch.equal(m["inv_alpha"], m2["inv_alpha"])


# ---------------------------------------------------------------------------
# the tree path and the flat path are one protocol (port against port)
# ---------------------------------------------------------------------------

def _flat_inputs(Wf, d, seed):
    rs = np.random.default_rng(seed)
    f = lambda: torch.from_numpy(  # noqa: E731
        rs.standard_normal((Wf, d)).astype(np.float32))
    theta, lam = f(), Complex(0.2 * f(), 0.2 * f())
    s = float(np.sqrt(0.5))
    return theta, lam, Complex(s * f(), s * f())


def _noise_free(Wf):
    return (AdmmConfig(rho=0.5, power_control=False),
            ChannelConfig(n_workers=Wf, noisy=False))


def test_tree_round_matches_flat_round():
    """A one-leaf tree round (packed, the fused B6 + B3 chain) against the
    flat primitives (modulate, the stacked receive, the dual update) on a
    noise-free link: the same Θ and λ bits."""
    from repro_torch.core import transport
    Wf, d, rho = 5, 48, 0.5
    theta, lam, h = _flat_inputs(Wf, d, 0)
    acfg, ccfg = _noise_free(Wf)
    zero = torch.zeros(d)
    s = transport.modulate(theta, lam, h, rho)
    Theta_flat = transport.receive(s, h, zero, torch.ones(()))
    lam_flat = transport.dual_update(lam, h, theta, Theta_flat, rho)
    T, l, _ = tree_ota.ota_tree_round({"w": theta}, {"w": lam}, {"w": h},
                                      zero, acfg, ccfg)
    assert torch.equal(T["w"], Theta_flat)
    assert torch.equal(l["w"].re, lam_flat.re)
    assert torch.equal(l["w"].im, lam_flat.im)


def test_tree_round_multi_leaf_equals_concatenated_flat():
    """Splitting the parameter vector across leaves changes no bit of Θ
    (the protocol is elementwise)."""
    Wf, d = 4, 60
    theta, lam, h = _flat_inputs(Wf, d, 1)
    lam = Complex(lam.re, torch.zeros_like(lam.im))
    acfg, ccfg = _noise_free(Wf)
    one, _, _ = tree_ota.ota_tree_round({"w": theta}, {"w": lam}, {"w": h},
                                        torch.zeros(d), acfg, ccfg)

    def split(x):
        return {"a": x[:, :25], "b": x[:, 25:]}

    def split_c(c):
        return {"a": Complex(c.re[:, :25], c.im[:, :25]),
                "b": Complex(c.re[:, 25:], c.im[:, 25:])}

    two, _, _ = tree_ota.ota_tree_round(split(theta), split_c(lam),
                                        split_c(h), torch.zeros(d), acfg,
                                        ccfg)
    assert torch.equal(torch.cat([two["a"], two["b"]], dim=-1), one["w"])


def test_power_control_consistent_across_paths():
    """min-α sums every leaf's energy: the tree's per-worker energy over
    two leaves is the flat energy of the whole vector (to the reference's
    rtol 1e-5: the sums group by leaf), and its budget counts every
    element."""
    from repro_torch.core import transport
    Wf, d, rho = 3, 40, 0.5
    theta, _, h = _flat_inputs(Wf, d, 2)
    lam = Complex(torch.zeros(Wf, d), torch.zeros(Wf, d))
    s_flat = transport.modulate(theta, lam, h, rho)

    def split_c(c):
        return {"a": Complex(c.re[:, :15], c.im[:, :15]),
                "b": Complex(c.re[:, 15:], c.im[:, 15:])}

    s_tree = tree_ota._modulate_tree(
        {"a": theta[:, :15], "b": theta[:, 15:]}, split_c(lam), split_c(h),
        rho)
    assert tree_ota._tree_size(s_tree) == d
    np.testing.assert_allclose(
        tree_ota._tree_energy_per_worker(s_tree).numpy(),
        transport.worker_energy(s_flat).numpy(), rtol=1e-5)
