"""The port's cohort sampling (``core/cohort.py``) and ``AFadmm(cohort=...)``
against the JAX package's.

Every ``cohort.py`` function on JAX's draws for all three policies; flat
A-FADMM sampling 4 of 10 workers under ``urban-mobility`` with stragglers,
bursts and the evict-retransmit guard, 5 rounds replayed against JAX; port
against port: the non-sampled rows keep their θ and λ bits, ``cohort ==
population`` is the unsampled round bit for bit, and the structural pin of
``tests/test_cohort.py``: no compute op of a sampled round outputs O(N·d)
elements.  Last, the torch twin of ``benchmarks/scaleup.py`` at a sampled
point."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import faults as jfaults  # noqa: E402
from repro.core import cohort as jcohort  # noqa: E402
from repro.core import cplx as jcplx  # noqa: E402
from repro.core.aggregators import AFadmm as JAFadmm  # noqa: E402
from repro.core.channel import rayleigh as jrayleigh  # noqa: E402
from repro.phy import make_scenario as jmake_scenario  # noqa: E402

from repro_torch.benchmarks import scaleup  # noqa: E402
from repro_torch.core import cohort  # noqa: E402
from repro_torch.core.admm import AdmmConfig  # noqa: E402
from repro_torch.core.aggregators import AFadmm  # noqa: E402
from repro_torch.core.channel import ChannelConfig  # noqa: E402
from repro_torch.core.cohort import (COHORT_SALT, CohortConfig,  # noqa: E402
                                     channel_weight, cohort_active,
                                     draw_cohort, put_rows, sample_cohort,
                                     take_rows)
from repro_torch.core.cplx import Complex  # noqa: E402
from repro_torch.core.subcarrier import SubcarrierPlan  # noqa: E402
from repro_torch.faults import FaultPlan, GuardConfig  # noqa: E402
from repro_torch.phy import make_scenario  # noqa: E402

from helpers import default_cfgs  # noqa: E402
from torch_replay import (afadmm_full_state, afadmm_round_draws,  # noqa: E402
                          cohort_draw, t)

KEY = jax.random.PRNGKey(0)
POLICIES = ("uniform", "top-gain", "prop-h2")
#: 5 replayed rounds: the closed-form solve and the sums in another order
REPLAY_TOL = dict(rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# cohort.py against JAX's
# ---------------------------------------------------------------------------

def test_cohort_config_validation_and_salt():
    assert COHORT_SALT == jcohort.COHORT_SALT
    assert cohort.POLICIES == jcohort.POLICIES
    with pytest.raises(ValueError, match="cohort <= population"):
        CohortConfig(population=4, cohort=5)
    with pytest.raises(ValueError, match="cohort <= population"):
        CohortConfig(population=4, cohort=0)
    with pytest.raises(ValueError, match="unknown cohort policy"):
        CohortConfig(population=4, cohort=2, policy="vip-only")
    assert not cohort_active(None)
    assert not cohort_active(CohortConfig(population=4, cohort=4))
    assert cohort_active(CohortConfig(population=4, cohort=2))


@pytest.mark.parametrize("policy", POLICIES)
def test_sample_cohort_on_jax_draws_matches_jax(policy):
    """Eight round keys: the port's indices on JAX's plane equal JAX's,
    order included."""
    N, W, d = 37, 5, 12
    cfg_j = jcohort.CohortConfig(population=N, cohort=W, policy=policy)
    cfg = CohortConfig(population=N, cohort=W, policy=policy)
    for r in range(8):
        k = jax.random.fold_in(KEY, r)
        h = jrayleigh(jax.random.fold_in(k, 9), (N, d))
        wt_j = None if policy == "uniform" else jcohort.channel_weight(h)
        want = np.asarray(jcohort.sample_cohort(k, cfg_j, weight=wt_j))
        wt = None if wt_j is None else t(wt_j)
        got = sample_cohort(cfg, cohort_draw(k, cfg_j), wt)
        assert got.dtype == torch.int64 and got.shape == (W,)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(r))


def test_sample_cohort_needs_its_inputs():
    with pytest.raises(ValueError, match="channel weight"):
        sample_cohort(CohortConfig(8, 3, "top-gain"), None)
    with pytest.raises(ValueError, match="channel weight"):
        sample_cohort(CohortConfig(8, 3, "prop-h2"), torch.zeros(8))
    with pytest.raises(ValueError, match="Gumbel"):
        sample_cohort(CohortConfig(8, 3, "prop-h2"), None, torch.ones(8))
    with pytest.raises(ValueError, match="permutation"):
        sample_cohort(CohortConfig(8, 3), None)


def test_draw_cohort_is_the_salted_side_branch():
    """The port's own planes: a permutation for uniform (so the cohort has
    no repeats), a Gumbel plane for prop-h2, nothing for top-gain; a pure
    function of the round key."""
    cfg = CohortConfig(population=40, cohort=6)
    a, b = draw_cohort(3, cfg, "cpu"), draw_cohort(3, cfg, "cpu")
    assert torch.equal(a, b)
    assert sorted(a.tolist()) == list(range(40))
    assert not torch.equal(a, draw_cohort(4, cfg, "cpu"))
    g = draw_cohort(3, CohortConfig(40, 6, "prop-h2"), "cpu")
    assert g.shape == (40,) and g.dtype == torch.float32
    assert bool(torch.isfinite(g).all())
    assert draw_cohort(3, CohortConfig(40, 6, "top-gain"), "cpu") is None
    idx = sample_cohort(cfg, a)
    assert len(set(idx.tolist())) == 6


def test_prop_h2_is_weighted_without_replacement():
    """On the port's own draws: a dominant-weight worker is sampled (almost)
    every round, the rest share the leftover slots (JAX's test)."""
    cfg = CohortConfig(population=16, cohort=4, policy="prop-h2")
    wt = torch.ones(16)
    wt[0] = 50.0
    hits = np.zeros(16)
    for r in range(200):
        idx = sample_cohort(cfg, draw_cohort(r, cfg, "cpu"), wt).numpy()
        assert len(set(idx.tolist())) == 4
        hits[idx] += 1
    assert hits[0] >= 195
    assert hits[1:].max() <= 120


def test_channel_weight_and_rows_match_jax():
    h = jrayleigh(KEY, (6, 32))
    np.testing.assert_allclose(channel_weight(Complex(t(h.re), t(h.im)))
                               .numpy(), np.asarray(jcohort.channel_weight(h)),
                               rtol=1e-6)
    hf = jrayleigh(KEY, (6, 1))
    np.testing.assert_allclose(channel_weight(Complex(t(hf.re), t(hf.im)))
                               .numpy(), np.asarray(jcplx.abs2(hf))[:, 0],
                               rtol=1e-6)
    idx_j = jnp.asarray([2, 0], jnp.int32)
    idx = torch.tensor([2, 0])
    x = np.arange(12.0, dtype=np.float32).reshape(4, 3)
    c_j = jcplx.Complex(jnp.asarray(x), -jnp.asarray(x))
    c = Complex(t(x), -t(x))
    np.testing.assert_array_equal(take_rows(t(x), idx).numpy(),
                                  np.asarray(jcohort.take_rows(x, idx_j)))
    sub = take_rows(c, idx)
    np.testing.assert_array_equal(sub.im.numpy(),
                                  np.asarray(jcohort.take_rows(c_j, idx_j).im))
    assert take_rows(None, idx) is None
    assert take_rows(torch.tensor(3.0), idx).shape == ()
    assert take_rows(True, idx) is True
    rows = np.full((2, 3), -1.0, np.float32)
    np.testing.assert_array_equal(
        put_rows(t(x), idx, t(rows)).numpy(),
        np.asarray(jcohort.put_rows(jnp.asarray(x), idx_j, rows)))
    got = put_rows(c, idx, Complex(t(rows), t(rows)))
    want = jcohort.put_rows(c_j, idx_j, jcplx.Complex(rows, rows))
    np.testing.assert_array_equal(got.im.numpy(), np.asarray(want.im))
    assert put_rows(None, idx, t(rows)) is None
    assert torch.equal(c.re, t(x))          # put_rows leaves its input be
    m = cohort.cohort_metrics(CohortConfig(population=1000, cohort=250))
    m_j = jcohort.cohort_metrics(jcohort.CohortConfig(1000, 250))
    assert {k: float(v) for k, v in m.items()} == \
        {k: float(v) for k, v in m_j.items()}


# ---------------------------------------------------------------------------
# flat A-FADMM with a cohort
# ---------------------------------------------------------------------------

_prox_solver = scaleup.proximal_solver


def _jprox_solver(rho):
    def solve(theta, lam, h, Theta):
        h2 = jcplx.abs2(h)
        mu = jcplx.cmul_conj(h, lam).re
        return (2.0 * theta - mu + rho * h2 * Theta[None, :]) \
            / (2.0 + rho * h2)
    return solve


_FAULTS = dict(straggler_prob=0.3, straggler_delay=2, burst_prob=0.4,
               burst_std=3.0)
_GUARD = dict(policy="evict-retransmit", snr_floor_db=-60.0, max_retries=1)


def _flat_algs(N, W, d, policy, faults=True):
    acfg_j, ccfg_j, plan_j = default_cfgs(N, d, noisy=True, snr_db=30.0,
                                          flip=False, power_control=True)
    kw_j, kw = {}, {}
    if faults:
        kw_j = dict(faults=jfaults.FaultPlan(**_FAULTS),
                    guard=jfaults.GuardConfig(**_GUARD))
        kw = dict(faults=FaultPlan(**_FAULTS), guard=GuardConfig(**_GUARD))
    alg_j = JAFadmm(acfg_j, ccfg_j, plan_j,
                    scenario=jmake_scenario("urban-mobility", ccfg_j,
                                            freq_flat=True),
                    cohort=jcohort.CohortConfig(N, W, policy), **kw_j)
    ccfg = ChannelConfig(n_workers=N, n_subcarriers=d, snr_db=30.0,
                         noisy=True)
    alg = AFadmm(AdmmConfig(rho=0.5, flip_on_change=False), ccfg,
                 SubcarrierPlan.build(d, d),
                 scenario=make_scenario("urban-mobility", ccfg,
                                        freq_flat=True),
                 cohort=CohortConfig(N, W, policy), **kw)
    return alg_j, alg


@pytest.mark.parametrize("policy", POLICIES)
def test_sampled_faulted_guarded_rounds_match_jax(policy):
    """N = 10, cohort 4 under urban-mobility (frequency-flat), stragglers
    and bursts, the evict-retransmit guard: 5 rounds of the port on JAX's
    draws, state and metrics against JAX's jitted rounds."""
    N, W, d = 10, 4, 6
    alg_j, alg = _flat_algs(N, W, d, policy)
    st_j = alg_j.init(jax.random.PRNGKey(1), jax.random.normal(KEY, (N, d)))
    st = afadmm_full_state(st_j)
    step = jax.jit(lambda s, k: alg_j.round(k, s, _jprox_solver(0.5),
                                            jnp.zeros_like))
    solver = _prox_solver(0.5)
    for r in range(5):
        k = jax.random.fold_in(KEY, r)
        draws = afadmm_round_draws(k, st_j, alg_j)
        st_j, m_j = step(st_j, k)
        st, m = alg.round(0, st, solver, torch.zeros_like, draws=draws)
        msg = f"round {r}"
        for a, b in ((st.theta, st_j.theta), (st.Theta, st_j.Theta),
                     (st.lam.re, st_j.lam.re), (st.lam.im, st_j.lam.im),
                     (st.flt.stale, st_j.flt.stale),
                     (st.phys.h.re, st_j.phys.h.re)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=msg,
                                       **REPLAY_TOL)
        np.testing.assert_array_equal(st.flt.alive.numpy(),
                                      np.asarray(st_j.flt.alive))
        for key in ("guard/evicted", "guard/healthy", "guard/retries",
                    "fault/burst", "fault/stragglers"):
            assert float(m[key]) == float(m_j[key]), (msg, key)
        np.testing.assert_allclose(float(m["inv_alpha"]),
                                   float(m_j["inv_alpha"]), rtol=1e-5)
    assert bool(torch.isfinite(st.Theta).all())


def test_sampled_round_freezes_non_sampled_rows():
    """Port against port, on its own draws: the rows the round did not
    sample keep their θ and λ bits; the sampled rows move."""
    N, W, d = 12, 4, 6
    _, alg = _flat_algs(N, W, d, "uniform", faults=False)
    gen = torch.Generator().manual_seed(0)
    st = alg.init(1, torch.randn((N, d), generator=gen))
    solver = _prox_solver(0.5)
    for r in range(3):
        draws = alg.draw(r + 5, st, solver)
        idx = sample_cohort(alg.cohort, draws.cohort)
        st2, _ = alg.round(r + 5, st, solver, torch.zeros_like, draws=draws)
        on = torch.zeros(N, dtype=torch.bool)
        on[idx] = True
        for a, b in ((st2.theta, st.theta), (st2.lam.re, st.lam.re),
                     (st2.lam.im, st.lam.im)):
            assert torch.equal(a[~on], b[~on])
        assert not torch.equal(st2.theta[on], st.theta[on])
        if r:
            assert not torch.equal(st2.lam.re[on], st.lam.re[on])
        st = st2


def test_cohort_equals_population_is_the_unsampled_round_bitwise():
    """``cohort == population`` draws and gathers nothing: 4 rounds equal
    the cohort-free run bit for bit, on the port's own draws."""
    N, d = 6, 8
    ccfg = ChannelConfig(n_workers=N, n_subcarriers=d, snr_db=30.0)
    acfg = AdmmConfig(rho=0.5, flip_on_change=False)
    plan = SubcarrierPlan.build(d, d)
    theta0 = torch.randn((N, d), generator=torch.Generator().manual_seed(2))
    states = []
    for coh in (None, CohortConfig(population=N, cohort=N)):
        alg = AFadmm(acfg, ccfg, plan,
                     scenario=make_scenario("urban-mobility", ccfg),
                     cohort=coh)
        st = alg.init(1, theta0)
        for r in range(4):
            st, _ = alg.round(r + 10, st, _prox_solver(0.5),
                              torch.zeros_like)
        states.append(st)
    a, b = states
    for x, y in ((a.theta, b.theta), (a.lam.re, b.lam.re),
                 (a.lam.im, b.lam.im), (a.Theta, b.Theta)):
        assert torch.equal(x, y)


def test_sampled_round_compute_stays_cohort_sized():
    """``tests/test_cohort.py``'s pin: at N = 512, W = 8, d = 16 no compute
    op of a sampled round outputs N·d elements or more than
    max(16·W·d, 8·N); population-wide buffers appear only as carried state,
    (N,) phy planes and row gathers and scatters.  The same round unsampled
    does reach N·d, so the pin can fail."""
    N, W, d = 512, 8, 16
    alg = scaleup.make_alg(N, W, d=d)
    st = alg.init(1, torch.zeros(N, d))
    solve = scaleup.proximal_solver(0.5)
    worst, op = scaleup.max_compute_out_elems(
        lambda: alg.round(0, st, solve, scaleup.zero_grad))
    assert worst < N * d, op
    assert worst <= max(16 * W * d, 8 * N), op
    full = scaleup.make_alg(N, N, d=d)
    st = full.init(1, torch.zeros(N, d))
    worst_full, _ = scaleup.max_compute_out_elems(
        lambda: full.round(0, st, solve, scaleup.zero_grad))
    assert worst_full >= N * d


def test_scaleup_twin_sampled_point():
    """The torch twin of ``benchmarks/scaleup.py`` at a sampled point on the
    CPU: finite, the sampled flags, and consensus moves."""
    out = scaleup.run_point(2048, 32, rounds=3, iters=2, device="cpu")
    assert out["sampled"] and out["population"] == 2048
    assert out["cohort"] == out["workers"] == 32
    assert out["seconds_per_round"] > 0
    assert np.isfinite(out["consensus_gap_last"])
    assert out["consensus_gap_last"] < out["consensus_gap_first"]
    assert "peak_above_state_bytes" not in out
    assert (1_000_000, 256) in scaleup.SWEEP


def test_to_device_walks_the_flat_state_dataclasses():
    """``tree.to_device`` moves a flat A-FADMM state whole: its
    ``ChannelBlock`` (a dataclass) and the phy state, with aliases kept
    (the block's h is the scenario's)."""
    from repro_torch.tree import to_device

    alg = scaleup.make_alg(64, 8)
    st = alg.init(3, torch.zeros(64, scaleup.D))
    moved = to_device(st, "meta")
    assert moved.blk.h.re.device.type == "meta"
    assert moved.blk.h_prev.im.device.type == "meta"
    assert moved.blk.changed.device.type == "meta"
    assert moved.blk.h is moved.phys.h and moved.blk.age == st.blk.age
    assert st.blk.h.re.device.type == "cpu"


def test_scaleup_twin_entry_points_default_to_the_card():
    import inspect

    for fn in (scaleup.run_point, scaleup.scaleup):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
