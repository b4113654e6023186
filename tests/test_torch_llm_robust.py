"""The port's LLM trainer under scenarios, faults, the round guard, cohort
sampling and the leafwise state, against the JAX package's ``make_fl_train``
on reduced granite-8b (f32, W = 4, B = 2, S = 16, 2 local sgd steps): each
run starts from JAX's own ``init_fn`` state, replays JAX's draws (the
scenario's planes, the fault uniforms, the guard's planes, the cohort plane,
the per-leaf noise) and is held to JAX's jitted rounds.  Port against port:
``block-fading`` is the legacy channel, ``cohort == population`` the
unsampled trainer, an all-zero fault plan no faults and a healthy guarded
round the unguarded one, bit for bit.  Last, JAX's ValueErrors."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import faults as jfaults  # noqa: E402
from repro.core.admm import AdmmConfig as JAdmmConfig  # noqa: E402
from repro.core.channel import ChannelConfig as JChannelConfig  # noqa: E402
from repro.core.cohort import CohortConfig as JCohortConfig  # noqa: E402
from repro.core.cplx import Complex as JComplex  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.phy import make_scenario as jmake_scenario  # noqa: E402
from repro.train import llm_trainer as jtrainer  # noqa: E402

from repro_torch.core.admm import AdmmConfig  # noqa: E402
from repro_torch.core.channel import ChannelConfig  # noqa: E402
from repro_torch.core.cohort import CohortConfig, sample_cohort  # noqa: E402
from repro_torch.faults import FaultPlan, GuardConfig  # noqa: E402
from repro_torch.models import registry as reg  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.train.llm_trainer import (FLConfig, draw_round,  # noqa: E402
                                           make_fl_train)
from repro_torch.tree import tree_leaves  # noqa: E402

from torch_replay import (llm_round_draws, llm_state,  # noqa: E402,F401
                          one_thread)

pytestmark = pytest.mark.usefixtures("one_thread")

W, B, S = 4, 2, 16
ROUNDS = 3
KEY = jax.random.PRNGKey(0)
#: f32 on both sides, three replayed rounds: the local steps' sums run in
#: other orders (B11's plain version against JAX's einsum), and the round
#: divides by Σ|h|²
TOL = dict(rtol=1e-4, atol=1e-4)

_FAULTS = dict(straggler_prob=0.3, straggler_delay=2, nan_workers=1,
               burst_prob=0.5, burst_std=3.0)
_GUARD = dict(policy="evict-retransmit", snr_floor_db=-60.0, max_retries=2)


def _jax_cfg():
    return dataclasses.replace(jreg.get_config("granite-8b").reduced(),
                               param_dtype="float32")


def _configs(coherence_iters=10):
    kw = dict(n_workers=W, snr_db=40.0, coherence_iters=coherence_iters)
    admm = dict(rho=0.5, flip_on_change=False)
    return (JAdmmConfig(**admm), JChannelConfig(**kw), AdmmConfig(**admm),
            ChannelConfig(**kw))


def _jax_fl(fl: dict) -> dict:
    out = dict(fl)
    if "faults" in fl:
        out["faults"] = jfaults.FaultPlan(**fl["faults"])
    if "guard" in fl:
        out["guard"] = jfaults.GuardConfig(**fl["guard"])
    return out


def _port_fl(fl: dict) -> dict:
    out = dict(fl)
    if "faults" in fl:
        out["faults"] = FaultPlan(**fl["faults"])
    if "guard" in fl:
        out["guard"] = GuardConfig(**fl["guard"])
    return out


def _tokens(cfg, rows):
    return np.random.default_rng(1).integers(0, cfg.vocab_size, (rows, B, S),
                                             dtype=np.int32)


def _jax_run(fl: dict, coherence_iters=10, rounds=ROUNDS):
    """JAX's init state and ``rounds`` jitted rounds, with the draws of each
    round made from its key before it runs."""
    jcfg = _jax_cfg()
    jacfg, jccfg, _, _ = _configs(coherence_iters)
    flj = _jax_fl(fl)
    flcfg = jtrainer.FLConfig(mode="replicated", n_workers=W, local_steps=2,
                              local_lr=1e-2, **flj)
    init_fn, step = jtrainer.make_fl_train(jreg.build_model(jcfg), flcfg,
                                           jacfg, jccfg)
    tokens = _tokens(jcfg, W)
    st = init_fn(KEY)
    scn = None
    if fl.get("scenario") is not None:
        scn = jmake_scenario(fl["scenario"], jccfg,
                             csi_err=fl.get("csi_err"), h_min=fl.get("h_min"))
    coh = None
    if fl.get("population") is not None:
        coh = JCohortConfig(fl["population"], fl["cohort"],
                            fl.get("cohort_policy", "uniform"))
    step = jax.jit(step)
    states, metrics, draws = [st], [], []
    for r in range(rounds):
        key = jax.random.fold_in(KEY, r)
        draws.append(llm_round_draws(key, st, jccfg, scenario=scn,
                                     faults=flj.get("faults"),
                                     guard=flj.get("guard"), cohort=coh))
        st, m = step(st, {"tokens": jnp.asarray(tokens)}, key)
        states.append(st)
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(cfg=jcfg, tokens=tokens, states=states, metrics=metrics,
                draws=draws, coherence_iters=coherence_iters, fl=fl)


def _port_trainer(jcfg, fl: dict, coherence_iters=10, device="cpu"):
    _, _, acfg, ccfg = _configs(coherence_iters)
    model = reg.build_model(ModelConfig(**dataclasses.asdict(jcfg)))
    flcfg = FLConfig(mode="replicated", n_workers=W, local_steps=2,
                     local_lr=1e-2, **_port_fl(fl))
    return make_fl_train(model, flcfg, acfg, ccfg, device=device)


def _close(got, want, msg, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), err_msg=msg,
                               **tol)


def _close_state(got, want, msg):
    for g, w in zip(tree_leaves(got.theta),
                    jax.tree_util.tree_leaves(want.theta)):
        _close(g, w, msg)
    for g, w in zip(tree_leaves(got.Theta),
                    jax.tree_util.tree_leaves(want.Theta)):
        _close(g, w, msg)
    if isinstance(want.lam, JComplex):
        _close(got.lam.re, want.lam.re, msg)
        _close(got.lam.im, want.lam.im, msg)
    else:
        for g, w in zip(tree_leaves(got.lam), jax.tree_util.tree_leaves(
                want.lam, is_leaf=lambda x: isinstance(x, JComplex))):
            _close(g.re, w.re, msg)
            _close(g.im, w.im, msg)


def _replay(run, check=None):
    """The port's rounds on JAX's draws from JAX's initial state, each held
    to JAX's; ``check(r, st_before, st_after, metrics)`` adds its own."""
    _, step = _port_trainer(run["cfg"], run["fl"], run["coherence_iters"])
    st = llm_state(run["states"][0])
    rows = run["fl"].get("cohort", W)
    batch = {"tokens": torch.from_numpy(run["tokens"][:rows])}
    for r, draws in enumerate(run["draws"]):
        before = st
        st, m = step(st, batch, draws=draws)
        msg = f"round {r}"
        want = run["metrics"][r]
        for k in ("loss", "theta_drift", "inv_alpha"):
            np.testing.assert_allclose(float(m[k]), want[k], rtol=1e-4,
                                       err_msg=f"{msg} {k}")
        for k in want:
            if k.startswith(("guard/", "fault/")) and k != "guard/snr_db" \
                    or k == "participation":
                assert float(m[k]) == want[k], (msg, k)
        _close_state(st, run["states"][r + 1], msg)
        if check is not None:
            check(r, before, st, m, draws)
    return st


def test_deep_fade_truncation_matches_jax_with_frozen_duals():
    # h_min 0.8 drops a CN(0, 1) fade with probability 1 − e^{−0.64} = 47 %
    run = _jax_run(dict(scenario="deep-fade-truncation", h_min=0.8))
    masked = []

    def check(r, before, after, m, draws):
        mask = after.chan.mask
        masked.append(int((~mask).sum()))
        for a, b in ((after.lam.re, before.lam.re),
                     (after.lam.im, before.lam.im)):
            assert torch.equal(a[~mask], b[~mask]), f"round {r}"

    st = _replay(run, check)
    assert sum(masked) > 0, "no round masked a worker"
    np.testing.assert_array_equal(st.chan.mask.numpy(),
                                  np.asarray(run["states"][-1].chan.mask))


def test_markov_csi_faults_guard_match_jax():
    """markov-doppler with CSI error 0.1, stragglers, a NaN worker, bursts
    and the evict-retransmit guard: the NaN worker is evicted in round 0
    with its dual zeroed, the straggler snapshots match."""
    run = _jax_run(dict(scenario="markov-doppler", csi_err=0.1,
                        faults=_FAULTS, guard=_GUARD))
    st = _replay(run)
    want = run["states"][-1]
    _close(st.flt.stale, want.flt.stale, "stale")
    np.testing.assert_array_equal(st.flt.alive.numpy(),
                                  np.asarray(want.flt.alive))
    assert not bool(st.flt.alive[0]) and int(st.flt.n_evicted) == 1
    assert not bool(st.lam.re[0].any()) and not bool(st.lam.im[0].any())
    _close(st.chan.h_hat.re, want.chan.h_hat.re, "h_hat")


@pytest.mark.parametrize("policy", ["uniform", "top-gain"])
def test_population_cohort_matches_jax(policy):
    """Population 6, cohort 4: the cohort indices from JAX's plane, the
    unsampled rows' θ, optimizer and λ rows keep their bits."""
    run = _jax_run(dict(population=6, cohort=4, cohort_policy=policy))
    cfg = CohortConfig(6, 4, policy)

    def check(r, before, after, m, draws):
        wgt = None
        if policy != "uniform":
            wgt = (after.chan.h.re ** 2 + after.chan.h.im ** 2).mean(1)
        idx = sample_cohort(cfg, draws.cohort, wgt)
        off = torch.ones(6, dtype=torch.bool)
        off[idx] = False
        for a, b in zip(tree_leaves(after.theta), tree_leaves(before.theta)):
            assert torch.equal(a[off], b[off])
        for a, b in zip(tree_leaves(after.opt.mu), tree_leaves(before.opt.mu)):
            assert torch.equal(a[off], b[off])
        assert torch.equal(after.lam.re[off], before.lam.re[off])

    _replay(run, check)


def test_leafwise_state_matches_jax():
    """``packed_uplink=False``: per-leaf λ and h trees, the per-leaf redraw
    (round 1) and noise planes from JAX's split keys."""
    run = _jax_run(dict(packed_uplink=False), coherence_iters=2)
    assert run["draws"][1].h_fresh is not None
    assert isinstance(run["draws"][0].noise_re, list)
    st = _replay(run)
    assert isinstance(st.lam, dict)
    assert st.chan.age == int(run["states"][-1].chan.age) == 1


# ---------------------------------------------------------------------------
# port against port, bit for bit
# ---------------------------------------------------------------------------

def _own_run(fl, rounds=3, coherence_iters=2, rows=W):
    model = reg.get_model("granite-8b", reduced=True)
    _, _, acfg, ccfg = _configs(coherence_iters)
    init_fn, step = make_fl_train(
        model, FLConfig(n_workers=W, local_steps=1, local_lr=1e-2, **fl),
        acfg, ccfg, device="cpu")
    st = init_fn(5)
    tokens = torch.from_numpy(_tokens(model.cfg, rows))
    ms = []
    for r in range(rounds):
        st, m = step(st, {"tokens": tokens}, key=r + 1)
        ms.append(m)
    return st, ms


def _bit_equal(a, b):
    for x, y in zip(tree_leaves(a.theta), tree_leaves(b.theta)):
        assert torch.equal(x, y)
    for x, y in zip(tree_leaves(a.Theta), tree_leaves(b.Theta)):
        assert torch.equal(x, y)
    assert torch.equal(a.lam.re, b.lam.re) and torch.equal(a.lam.im,
                                                           b.lam.im)


def test_block_fading_scenario_is_the_legacy_trainer_bitwise():
    """The ``block-fading`` scenario over 3 rounds with a redraw in round 1
    (``tests/test_phy.py``'s pin, port against port)."""
    legacy, _ = _own_run({})
    scn, _ = _own_run(dict(scenario="block-fading"))
    _bit_equal(legacy, scn)
    assert torch.equal(legacy.chan.h.re, scn.chan.h.re)


def test_cohort_equals_population_is_the_unsampled_trainer_bitwise():
    plain, _ = _own_run({})
    pop, _ = _own_run(dict(population=W, cohort=W))
    _bit_equal(plain, pop)


def test_all_zero_fault_plan_is_no_faults_bitwise():
    """The fault key is a side branch: ``FaultPlan()`` changes no draw, and
    its all-alive mask no value."""
    plain, _ = _own_run({})
    nul, ms = _own_run(dict(faults=FaultPlan()))
    _bit_equal(plain, nul)
    assert float(ms[-1]["fault/alive"]) == W and nul.flt.round == 3


def test_healthy_guarded_trainer_is_the_unguarded_one_bitwise():
    plain, _ = _own_run({})
    guarded, ms = _own_run(dict(guard=GuardConfig(
        policy="evict-retransmit", snr_floor_db=-60.0)))
    _bit_equal(plain, guarded)
    assert all(float(m["guard/healthy"]) == 1.0 for m in ms)


def test_draw_round_makes_every_plane_the_round_reads():
    """The port's own draws: the scenario's planes, the population's fault
    uniforms, the guard's planes and the cohort permutation."""
    model = reg.get_model("granite-8b", reduced=True)
    _, _, acfg, ccfg = _configs()
    fl = FLConfig(n_workers=W, scenario="markov-doppler", csi_err=0.1,
                  faults=FaultPlan(**_FAULTS), guard=GuardConfig(**_GUARD),
                  population=6, cohort=4)
    init_fn, _ = make_fl_train(model, fl, acfg, ccfg, device="cpu")
    st = init_fn(0)
    from repro_torch.phy import make_scenario
    d = draw_round(3, st, ccfg, scenario=make_scenario(
        "markov-doppler", ccfg, csi_err=0.1), faults=fl.faults,
        guard=fl.guard, cohort=CohortConfig(6, 4))
    D = st.lam.re.shape[1]
    assert d.h_fresh is None and d.phy.w.re.shape == (6, D)
    assert d.phy.csi_err.re.shape == (6, D)
    assert d.faults.straggler.shape == (6,) and d.faults.burst.shape == ()
    assert d.noise_re.shape == (D,) and len(d.guard.retry_noise) == 2
    assert d.guard.burst.shape == (D,)
    assert sorted(d.cohort.tolist()) == list(range(6))
    assert st.flt.stale.shape == (6, D)


@pytest.mark.parametrize("fl", [
    dict(scenario="markov-doppler", packed_uplink=False),
    dict(faults=dict(straggler_prob=0.1), packed_uplink=False),
    dict(guard=dict(policy="skip"), packed_uplink=False),
    dict(population=8, cohort=4, packed_uplink=False),
    dict(population=8),
    dict(cohort=2),
], ids=["scenario", "faults", "guard", "cohort", "population", "cohort-only"])
def test_jax_value_errors(fl):
    """Where JAX's ``make_fl_train`` raises a ValueError, so does the
    port's."""
    jacfg, jccfg, acfg, ccfg = _configs()
    with pytest.raises(ValueError):
        jtrainer.make_fl_train(
            jreg.build_model(_jax_cfg()),
            jtrainer.FLConfig(n_workers=W, **_jax_fl(fl)), jacfg, jccfg)
    with pytest.raises(ValueError):
        make_fl_train(reg.get_model("granite-8b", reduced=True),
                      FLConfig(n_workers=W, **_port_fl(fl)), acfg, ccfg,
                      device="cpu")
