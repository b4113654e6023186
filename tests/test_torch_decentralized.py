"""The port's decentralized analog GADMM (``core/decentralized.py``) against
the JAX package's, with JAX's link planes replayed: rounds unmasked, with a
dead interior worker and with a dead end; the paper's §6 ablation
(``ablation_decentralized``) over its 300 rounds; and, port against port,
what the reference pins bit for bit: ``mask=None`` ≡ all alive, the masked
chain ≡ the compacted alive-only chain, ``scan_rounds`` ≡ a loop of
``round``, and 2 channel uses a round whatever W is."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import ablation_noniid as jablation  # noqa: E402
from repro.core import decentralized as jdec  # noqa: E402
from repro.core.channel import ChannelConfig as JChannelConfig  # noqa: E402
from repro.core.subcarrier import SubcarrierPlan as JPlan  # noqa: E402
from repro.data.synthetic import linreg_dataset as jlinreg  # noqa: E402

from repro_torch import rng  # noqa: E402
from repro_torch.benchmarks import ablation_noniid  # noqa: E402
from repro_torch.core.channel import ChannelConfig  # noqa: E402
from repro_torch.core.decentralized import (AnalogGadmm,  # noqa: E402
                                            GadmmState,
                                            gadmm_quadratic_solver)
from repro_torch.core.subcarrier import SubcarrierPlan  # noqa: E402

from helpers import make_linreg  # noqa: E402
from torch_replay import gadmm_draws, t  # noqa: E402

#: a round: the same expressions; the 6 × 6 solves and the link's complex
#: products round alike up to LAPACK's and XLA's orders
ROUND_TOL = dict(rtol=1e-5, atol=1e-6)
#: the ablation's derived numbers after 300 rounds, relative
ABLATION_RTOL = 1e-3
#: ``final_gap`` is |f(Θ) − f(θ*)| of two f32 means of squares at f* ≈ 2.5e-3,
#: whose ulp is 2.3e-10: JAX's own f(θ*) sits 3.2e-10 off the exact mean
#: of its samples (and the port's matvec and sum round elsewhere), so
#: neither gap is known to better than ~4 ulps of f*; 1e-3 of the gap
#: (4.9e-10) is below that
FINAL_GAP_ATOL = 1e-9
ROUNDS = 5


def _algs(W, d, mask):
    kw = dict(n_workers=W, n_subcarriers=d, noisy=True, snr_db=30.0)
    jalg = jdec.AnalogGadmm(ccfg=JChannelConfig(**kw), plan=JPlan.build(d, d),
                            rho=1.0,
                            mask=None if mask is None else jnp.asarray(mask))
    alg = AnalogGadmm(ccfg=ChannelConfig(**kw), plan=SubcarrierPlan.build(d, d),
                      rho=1.0,
                      mask=None if mask is None else torch.tensor(mask))
    return jalg, alg


@pytest.mark.parametrize("mask", [None, [True, True, False, True, True, True],
                                  [True, True, True, True, True, False]],
                         ids=["unmasked", "dead_interior", "dead_end"])
def test_rounds_equal_jax_on_its_draws(mask):
    key = jax.random.PRNGKey(3)
    prob = make_linreg(key, W=6)
    W, d = prob["theta0"].shape
    jalg, alg = _algs(W, d, mask)
    jsolver = jdec.gadmm_quadratic_solver(prob["X"], prob["y"], 1.0)
    solver = gadmm_quadratic_solver(t(prob["X"]), t(prob["y"]), 1.0)
    keys = [jax.random.fold_in(key, i) for i in range(ROUNDS)]
    draws = gadmm_draws(keys, (W, d), jalg.ccfg)
    jst = jalg.init(key, prob["theta0"])
    st = alg.init(0, t(prob["theta0"]))
    step = jax.jit(lambda s, k: jalg.round(k, s, jsolver, None))
    for r, k in enumerate(keys):
        jst, jm = step(jst, k)
        st, m = alg.round(0, st, solver, None, draws=draws(r))
        np.testing.assert_allclose(st.theta.numpy(), np.asarray(jst.theta),
                                   err_msg=f"round {r}", **ROUND_TOL)
        np.testing.assert_allclose(st.lam.numpy(), np.asarray(jst.lam),
                                   err_msg=f"round {r}", **ROUND_TOL)
        np.testing.assert_allclose(float(m["consensus_gap"]),
                                   float(jm["consensus_gap"]), **ROUND_TOL)
        assert m["channel_uses"] == float(jm["channel_uses"]) == 2.0
    np.testing.assert_allclose(alg.global_model(st).numpy(),
                               np.asarray(jalg.global_model(jst)),
                               **ROUND_TOL)
    if mask is not None:
        dead = mask.index(False)
        assert torch.equal(st.theta[dead], t(prob["theta0"][dead]))
        assert float(m["gadmm_alive"]) == float(jm["gadmm_alive"]) == 5.0
        if dead < W - 1:
            assert not st.lam[dead].any()


def test_ablation_on_jax_draws_gives_jax_numbers(monkeypatch):
    """The §6 ablation (W = 8, d = 6, 40 dB, ρ = 1, 300 rounds) on JAX's
    samples, initial models and link planes: ``consensus_gap`` within
    rtol 1e-3 of JAX's, ``final_gap`` within rtol 1e-3 up to the f32
    resolution of f (``FINAL_GAP_ATOL``), 2 channel uses a round."""
    want = jablation.ablation_decentralized()
    key = jax.random.PRNGKey(11)
    W, d, rounds = 8, 6, 300
    X, y, _ = jlinreg(key, 2000, d)
    theta0 = jax.random.normal(key, (W, d))
    monkeypatch.setattr(ablation_noniid, "decentralized_task",
                        lambda k, W_, d_, dev: (t(X), t(y), t(theta0)))
    draws = gadmm_draws([jax.random.fold_in(key, i) for i in range(rounds)],
                        (W, d), JChannelConfig(n_workers=W, n_subcarriers=d,
                                               noisy=True, snr_db=40.0))
    # the port's round r runs on rng key fold_in(key, r + 1): map it back
    rounds_of = {rng.fold_in(ablation_noniid.DECENTRALIZED_KEY, r + 1): r
                 for r in range(rounds)}

    class Replayed(AnalogGadmm):
        def draw(self, key, st):
            return draws(rounds_of[key])

    monkeypatch.setattr(ablation_noniid, "AnalogGadmm", Replayed)
    got = ablation_noniid.ablation_decentralized(rounds, device="cpu")
    assert got["channel_uses_per_round"] == want[
        "channel_uses_per_round"] == 2.0
    np.testing.assert_allclose(got["consensus_gap"], want["consensus_gap"],
                               rtol=ABLATION_RTOL)
    np.testing.assert_allclose(got["final_gap"], want["final_gap"],
                               rtol=ABLATION_RTOL, atol=FINAL_GAP_ATOL)


def test_mask_none_is_all_alive_bit_for_bit():
    key = jax.random.PRNGKey(2)
    prob = make_linreg(key, W=5)
    W, d = prob["theta0"].shape
    solver = gadmm_quadratic_solver(t(prob["X"]), t(prob["y"]), 1.0)
    sts = []
    for mask in (None, torch.ones(W, dtype=torch.bool)):
        alg = AnalogGadmm(ccfg=ChannelConfig(n_workers=W, n_subcarriers=d,
                                             noisy=True, snr_db=30.0),
                          plan=SubcarrierPlan.build(d, d), rho=1.0, mask=mask)
        st = alg.init(0, t(prob["theta0"]))
        for i in range(ROUNDS):
            st, _ = alg.round(rng.fold_in(5, i), st, solver, None)
        sts.append(st)
    assert torch.equal(sts[0].theta, sts[1].theta)
    assert torch.equal(sts[0].lam, sts[1].lam)


def test_masked_chain_is_the_compacted_chain():
    """A dead worker is a pass-through hop: the masked W-chain is the
    alive-only chain elementwise, the dead row freezes, its edge dual is
    zero, and the chain still solves the alive workers' problem."""
    key = jax.random.PRNGKey(0)
    prob = make_linreg(key, W=6)
    W, d = prob["theta0"].shape
    X, y, theta0 = t(prob["X"]), t(prob["y"]), t(prob["theta0"])
    alive = torch.tensor([True, True, False, True, True, True])
    keep = torch.tensor([0, 1, 3, 4, 5])
    plan = SubcarrierPlan.build(d, d)
    algm = AnalogGadmm(ccfg=ChannelConfig(n_workers=W, n_subcarriers=d,
                                          noisy=False),
                       plan=plan, rho=1.0, mask=alive)
    algc = AnalogGadmm(ccfg=ChannelConfig(n_workers=5, n_subcarriers=d,
                                          noisy=False), plan=plan, rho=1.0)
    solverm = gadmm_quadratic_solver(X, y, 1.0)
    solverc = gadmm_quadratic_solver(X[keep], y[keep], 1.0)
    stm = algm.init(0, theta0)
    stc = GadmmState(theta=theta0[keep], lam=torch.zeros((4, d)), step=0)
    for i in range(20):
        stm, mm = algm.round(i, stm, solverm, None)
        stc, mc = algc.round(i, stc, solverc, None)
    assert torch.equal(stm.theta[keep], stc.theta)
    # edge (u, v) lives at its left endpoint u: the alive edges 0-1, 1-3,
    # 3-4, 4-5 are the masked rows 0, 1, 3, 4
    assert torch.equal(stm.lam[torch.tensor([0, 1, 3, 4])], stc.lam)
    assert float(mm["consensus_gap"]) == float(mc["consensus_gap"])
    assert float(mm["gadmm_alive"]) == 5.0
    assert torch.equal(stm.theta[2], theta0[2])
    assert not stm.lam[2].any()
    Xa, ya = X[keep].reshape(-1, d), y[keep].reshape(-1)
    th_star = torch.linalg.solve(Xa.T @ Xa + 1e-8 * torch.eye(d), Xa.T @ ya)
    assert float((algm.global_model(stm) - th_star).abs().max()) < 1e-2


@pytest.mark.parametrize("mask", [None, [True, False, True, True, True]],
                         ids=["unmasked", "masked"])
def test_scan_rounds_equal_the_loop_bit_for_bit(mask):
    prob = make_linreg(jax.random.PRNGKey(1), W=5)
    W, d = prob["theta0"].shape
    alg = AnalogGadmm(ccfg=ChannelConfig(n_workers=W, n_subcarriers=d,
                                         noisy=True, snr_db=30.0),
                      plan=SubcarrierPlan.build(d, d), rho=1.0,
                      mask=None if mask is None else torch.tensor(mask))
    solver = gadmm_quadratic_solver(t(prob["X"]), t(prob["y"]), 1.0)
    st0 = alg.init(9, t(prob["theta0"]))
    st_s, met = alg.scan_rounds(9, st0, solver, None, 7)
    st, gaps = st0, []
    for r in range(7):
        st, m = alg.round(rng.fold_in(9, r + 1), st, solver, None)
        gaps.append(m["consensus_gap"])
    assert torch.equal(st_s.theta, st.theta) and torch.equal(st_s.lam, st.lam)
    assert torch.equal(met["consensus_gap"], torch.stack(gaps))
    assert met["channel_uses"].tolist() == [2.0] * 7
    assert st_s.step == st.step == 7


@pytest.mark.parametrize("W", [4, 12])
def test_channel_uses_independent_of_w(W):
    prob = make_linreg(jax.random.PRNGKey(1), W=W)
    d = prob["theta0"].shape[1]
    alg = AnalogGadmm(ccfg=ChannelConfig(n_workers=W, n_subcarriers=d,
                                         noisy=False),
                      plan=SubcarrierPlan.build(d, d))
    solver = gadmm_quadratic_solver(t(prob["X"]), t(prob["y"]), alg.rho)
    _, met = alg.round(0, alg.init(0, t(prob["theta0"])), solver, None)
    assert met["channel_uses"] == 2.0   # spatial reuse: 2 slot groups
