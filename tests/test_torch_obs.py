"""The port's observability (``repro_torch.obs``) and round telemetry,
against the JAX package's ``repro.obs``.

* Config plumbing: ``resolve``, ``merge_disjoint``.
* ``transport.round_telemetry`` and the fused round's telemetry on the same
  inputs and noise plane as JAX's; telemetry is a pure addition (the round's
  three outputs keep their bits), monolithic and streamed.
* A-FADMM: telemetry off is bitwise the round without it, on changes no bit
  of the state or the shared metrics; the flat round's keys and values on
  JAX's ``backend="pallas"`` route (its Pallas kernels in interpret mode),
  unguarded and faulted + guarded; a sampled round's ``obs/cohort_*`` keys
  on JAX's draws; ``scan_rounds`` is the round loop bit for bit with the
  (W,) leaf; deep-fade participation; the History's vector entries.
* The LLM trainer: 2 replayed rounds of reduced granite-8b with telemetry
  against JAX's jitted rounds; off is bitwise; the leafwise state refuses
  telemetry with JAX's wording.
* ``sink``, ``validate`` and ``report`` (the reference's cases; a run dir
  the port writes passes JAX's own validator), ``profiling``.

Tolerances: one round's telemetry on shared inputs, rtol 1e-5 (sums in
another order than XLA's); replayed rounds, slice 2's rtol 1e-4."""
import dataclasses
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import faults as jfaults  # noqa: E402
from repro.core import make as jmake  # noqa: E402
from repro.core import transport as jt  # noqa: E402
from repro.core.cplx import Complex as JComplex  # noqa: E402
from repro.obs import TelemetryConfig as JTelemetryConfig  # noqa: E402
from repro.obs import validate as jvalidate  # noqa: E402

from repro_torch import convert, obs  # noqa: E402
from repro_torch.core import transport  # noqa: E402
from repro_torch.core.admm import AdmmConfig  # noqa: E402
from repro_torch.core.aggregators import make  # noqa: E402
from repro_torch.core.channel import ChannelConfig  # noqa: E402
from repro_torch.core.cplx import Complex  # noqa: E402
from repro_torch.core.subcarrier import SubcarrierPlan  # noqa: E402
from repro_torch.faults import FaultPlan, GuardConfig  # noqa: E402
from repro_torch.obs import (TelemetryConfig, merge_disjoint,  # noqa: E402
                             resolve)
from repro_torch.obs import profiling, report  # noqa: E402
from repro_torch.obs.sink import (MetricsSink, read_events,  # noqa: E402
                                  run_manifest)
from repro_torch.obs.validate import (validate_bench,  # noqa: E402
                                      validate_run_dir)
from repro_torch.train.fl_trainer import train  # noqa: E402

from helpers import default_cfgs, make_linreg, make_solver  # noqa: E402
from test_torch_admm import _linreg_port, replay_draws  # noqa: E402
from test_torch_admm import state_to_numpy  # noqa: E402
from test_torch_faults import fault_to_numpy, replay_faulted  # noqa: E402

KEY = jax.random.PRNGKey(0)
#: one round's telemetry on shared inputs: sums in another order
TOL = dict(rtol=1e-5, atol=1e-6)
#: replayed rounds: solve and sum orders add up (slice 2's)
REPLAY_TOL = dict(rtol=1e-4, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got), np.float64),
                               np.asarray(want, np.float64), err_msg=msg,
                               **REPLAY_TOL)


# ---------------------------------------------------------------------------
# config plumbing
# ---------------------------------------------------------------------------

def test_resolve_normalises():
    assert resolve(None) is None and resolve(False) is None
    assert resolve(True) == TelemetryConfig()
    assert resolve(TelemetryConfig(per_worker=False)).per_worker is False
    assert resolve(TelemetryConfig(enabled=False)) is None
    assert obs.is_on(True) and not obs.is_on(None)
    with pytest.raises(TypeError):
        resolve("yes")


def test_merge_disjoint_rejects_collisions():
    assert merge_disjoint({"a": 1}, {"b": 2}, {"c": 3}) == \
        {"a": 1, "b": 2, "c": 3}
    with pytest.raises(ValueError, match="key collision.*'a'"):
        merge_disjoint({"a": 1}, {"a": 2})
    with pytest.raises(ValueError, match="who-test"):
        merge_disjoint({"x": 1}, {"y": 2}, {"y": 3}, who="who-test")


# ---------------------------------------------------------------------------
# round_telemetry and the fused round
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["masked", "all-masked", "scalars-only"])
def test_round_telemetry_matches_jax(case):
    rs = np.random.default_rng(3)
    y = rs.standard_normal(50).astype(np.float32)
    noise = rs.standard_normal(50).astype(np.float32)
    energy = rs.uniform(1.0, 9.0, 5).astype(np.float32)
    mask = np.array([True, False, True, True, False])
    ia = np.float32(0.0 if case == "all-masked" else 0.37)
    per_worker = case != "scalars-only"
    m_arg = None if case == "all-masked" else mask
    want = jt.round_telemetry(JTelemetryConfig(per_worker=per_worker),
                              jnp.asarray(y), jnp.asarray(noise),
                              jnp.asarray(ia), jnp.asarray(energy),
                              None if m_arg is None else jnp.asarray(m_arg),
                              5)
    got = transport.round_telemetry(
        TelemetryConfig(per_worker=per_worker), _t(y), _t(noise),
        torch.tensor(ia), _t(energy), None if m_arg is None else _t(m_arg), 5)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)
    if case == "all-masked":
        assert float(got["obs/min_alpha"]) == 0.0
        assert float(got["obs/active_workers"]) == 5.0


@pytest.mark.parametrize("worker_chunk", [0, 2])
def test_fused_round_telemetry_is_pure_addition(worker_chunk):
    """Port against port the three outputs keep their bits; the telemetry
    against JAX's jnp fused round on the same planes and noise."""
    W, d = 4, 32
    rs = np.random.default_rng(0)
    f = lambda *s: rs.standard_normal(s).astype(np.float32)  # noqa: E731
    theta, lr, li, hr, hi = f(W, d), 0.3 * f(W, d), 0.3 * f(W, d), \
        f(W, d), f(W, d)
    from repro.core.channel import ChannelConfig as JCC
    ccfg_j = JCC(n_workers=W, noisy=True, snr_db=20.0)
    ccfg = ChannelConfig(n_workers=W, noisy=True, snr_db=20.0)
    noise = _t(jt.matched_filter_noise_re(KEY, (d,), ccfg_j))
    args = (_t(theta), Complex(_t(lr), _t(li)), Complex(_t(hr), _t(hi)),
            noise, 0.5, ccfg)
    off = transport.ota_round_fused(*args, worker_chunk=worker_chunk)
    on = transport.ota_round_fused(*args, worker_chunk=worker_chunk,
                                   telemetry=True)
    assert len(off) == 3 and len(on) == 4
    assert torch.equal(off[0], on[0]) and torch.equal(off[1], on[1])
    want = jt.ota_round_fused(
        jnp.asarray(theta), JComplex(jnp.asarray(lr), jnp.asarray(li)),
        JComplex(jnp.asarray(hr), jnp.asarray(hi)), KEY, 0.5, ccfg_j,
        backend="jnp", worker_chunk=worker_chunk, telemetry=True)[3]
    assert sorted(on[3]) == sorted(want)
    for k in want:
        np.testing.assert_allclose(on[3][k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)
    assert float(on[3]["obs/min_alpha"]) * float(on[1]) == \
        pytest.approx(1.0, rel=1e-6)


# ---------------------------------------------------------------------------
# A-FADMM on the flat problem
# ---------------------------------------------------------------------------

_FAULTED = dict(crash_at=((5, 4),), straggler_prob=0.3, straggler_delay=2,
                nan_workers=1, burst_prob=0.3, burst_std=5.0)
_GUARD = dict(policy="evict-retransmit", snr_floor_db=-60.0, max_retries=2)


def _algs(W, d, faulted, telemetry=True, backend="pallas"):
    """(JAX's A-FADMM on ``backend``, the port's), both with telemetry."""
    acfg_j, ccfg_j, plan_j = default_cfgs(W, d, noisy=True, snr_db=30.0,
                                          power_control=True, flip=False)
    kw_j, kw = {}, {}
    if faulted:
        kw_j = dict(faults=jfaults.FaultPlan(**_FAULTED),
                    guard=jfaults.GuardConfig(**_GUARD))
        kw = dict(faults=FaultPlan(**_FAULTED), guard=GuardConfig(**_GUARD))
    alg_j = jmake("afadmm", acfg_j, ccfg_j, plan_j, backend=backend,
                  telemetry=telemetry, **kw_j)
    ccfg = ChannelConfig(n_workers=W, n_subcarriers=d, snr_db=30.0,
                         noisy=True)
    alg = make("afadmm", AdmmConfig(rho=0.5, flip_on_change=False), ccfg,
               SubcarrierPlan.build(d, d), telemetry=telemetry, **kw)
    return alg_j, alg


@pytest.mark.parametrize("faulted", [False, True])
def test_afadmm_telemetry_off_is_bitwise(faulted):
    """telemetry None vs True on the port's own draws: the same state bits
    and the same shared metrics; the obs/ keys are pure additions."""
    prob = make_linreg(KEY, W=6)
    solver, grad_fn = _linreg_port(prob, 0.5)
    theta0 = _t(prob["theta0"])

    def run(telemetry):
        alg = _algs(6, prob["d"], faulted, telemetry)[1]
        st = alg.init(0, theta0)
        for r in range(8):
            st, m = alg.round(r + 1, st, solver, grad_fn)
        return st, m

    (st0, m0), (st1, m1) = run(None), run(True)
    for a, b in ((st0.theta, st1.theta), (st0.Theta, st1.Theta),
                 (st0.lam.re, st1.lam.re), (st0.lam.im, st1.lam.im)):
        assert torch.equal(a, b)
    assert not any(k.startswith("obs/") for k in m0)
    assert "obs/theta_update_norm" in m1
    for k in m0:
        assert torch.equal(torch.as_tensor(m0[k]), torch.as_tensor(m1[k])), k


@pytest.mark.parametrize("faulted", [False, True])
def test_flat_round_telemetry_matches_jax_pallas_route(faulted):
    """JAX's AFadmm on ``backend="pallas"`` (interpret mode) with telemetry
    against the port on JAX's draws: the same key set (unguarded: the
    worker-free subset and the Θ-update norm; guarded: the full set, its
    SNR the guard's) and values."""
    W = 6
    prob = make_linreg(KEY, W=W)
    alg_j, alg = _algs(W, prob["d"], faulted)
    solver_j = make_solver(prob, 0.5)
    solver, grad_fn = _linreg_port(prob, 0.5)
    step = jax.jit(lambda st, k: alg_j.round(k, st, solver_j,
                                             prob["grad_fn"]))
    st_j = alg_j.init(KEY, prob["theta0"])
    leaves = state_to_numpy(st_j)
    if faulted:
        leaves["flt"] = fault_to_numpy(st_j.flt)
    st = convert.afadmm_state_from_numpy(leaves, device="cpu")
    for r in range(4):
        k = jax.random.fold_in(KEY, r + 1)
        draws = replay_faulted(k, st_j, alg_j) if faulted \
            else replay_draws(k, st_j, alg_j.ccfg)
        st_j, m_j = step(st_j, k)
        st, m = alg.round(0, st, solver, grad_fn, draws=draws)
        obs_j = sorted(k for k in m_j if k.startswith("obs/"))
        assert sorted(k for k in m if k.startswith("obs/")) == obs_j
        for key in obs_j:
            _close(m[key], m_j[key], f"round {r} {key}")
    if faulted:
        assert "obs/rx_snr_db" in obs_j
        assert torch.equal(m["obs/rx_snr_db"], m["guard/snr_db"])
        assert float(m["obs/tx_energy"][0]) == 0.0    # the evicted NaN row
    else:
        assert obs_j == ["obs/active_workers", "obs/min_alpha",
                         "obs/theta_update_norm"]


def test_cohort_round_telemetry_matches_jax():
    """A sampled round under urban-mobility, faults and the guard with
    telemetry: the cohort keys and the accepted attempt's keys on JAX's
    draws."""
    from test_torch_cohort import _flat_algs, _jprox_solver, _prox_solver
    from torch_replay import afadmm_full_state, afadmm_round_draws

    N, W, d = 10, 4, 6
    alg_j, alg = _flat_algs(N, W, d, "uniform")
    alg_j = dataclasses.replace(alg_j, telemetry=True)
    alg = dataclasses.replace(alg, telemetry=True)
    st_j = alg_j.init(jax.random.PRNGKey(1), jax.random.normal(KEY, (N, d)))
    st = afadmm_full_state(st_j)
    step = jax.jit(lambda s, k: alg_j.round(k, s, _jprox_solver(0.5),
                                            jnp.zeros_like))
    for r in range(2):
        k = jax.random.fold_in(KEY, r)
        draws = afadmm_round_draws(k, st_j, alg_j)
        st_j, m_j = step(st_j, k)
        st, m = alg.round(0, st, _prox_solver(0.5), torch.zeros_like,
                          draws=draws)
        obs_j = sorted(k for k in m_j if k.startswith("obs/"))
        assert sorted(k for k in m if k.startswith("obs/")) == obs_j
        for key in obs_j:
            _close(m[key], m_j[key], f"round {r} {key}")
    assert m["obs/cohort_size"] == 4.0
    assert m["obs/population_sampled_frac"] == pytest.approx(0.4)


def test_deep_fade_participation_oracle():
    """Deep-fade truncation: obs/active_workers == W · participation (the
    scenario mask is the only gate of a fault-free round)."""
    from repro_torch.phy import make_scenario
    W = 8
    prob = make_linreg(KEY, W=W)
    solver, grad_fn = _linreg_port(prob, 0.5)
    ccfg = ChannelConfig(n_workers=W, n_subcarriers=prob["d"], snr_db=30.0,
                         noisy=True)
    alg = make("afadmm", AdmmConfig(rho=0.5, flip_on_change=False), ccfg,
               SubcarrierPlan.build(prob["d"], prob["d"]),
               scenario=make_scenario("deep-fade-truncation", ccfg,
                                      h_min=0.6), telemetry=True)
    st = alg.init(0, _t(prob["theta0"]))
    saw = False
    for r in range(12):
        st, m = alg.round(r + 1, st, solver, grad_fn)
        part = float(m["participation"])
        assert float(m["obs/active_workers"]) == pytest.approx(W * part)
        saw |= part < 1.0
    assert saw, "h_min=0.6 never truncated anyone in 12 rounds"


def test_scan_rounds_equal_the_round_loop_with_telemetry():
    """obs/ leaves stack bit for bit (the (W,) leaf included)."""
    prob = make_linreg(KEY, W=6)
    solver, grad_fn = _linreg_port(prob, 0.5)
    alg = _algs(6, prob["d"], True)[1]
    theta0 = _t(prob["theta0"])
    st_s, ms = alg.scan_rounds(0, alg.init(0, theta0), solver, grad_fn, 10)
    st_l = alg.init(0, theta0)
    rows = []
    for r in range(10):
        from repro_torch import rng
        st_l, m = alg.round(rng.fold_in(0, r + 1), st_l, solver, grad_fn)
        rows.append(m)
    assert torch.equal(st_s.Theta, st_l.Theta)
    assert ms["obs/rx_snr_db"].shape == (10,)
    assert ms["obs/tx_energy"].shape == (10, 6)
    for r in range(10):
        for k, v in rows[r].items():
            assert torch.equal(ms[k][r], torch.as_tensor(v, dtype=ms[k].dtype
                                                         )), (k, r)


def test_history_records_vector_metrics():
    prob = make_linreg(KEY, W=4)
    solver, grad_fn = _linreg_port(prob, 0.5)
    alg = _algs(4, prob["d"], True)[1]
    theta0 = _t(prob["theta0"])
    h_s = train(alg, theta0, solver, grad_fn, 6, 0, driver="scan")
    h_l = train(alg, theta0, solver, grad_fn, 6, 0, driver="loop")
    for h in (h_s, h_l):
        assert len(h.extra["obs/rx_snr_db"]) == 6
        assert all(len(row) == 4 for row in h.extra["obs/tx_energy"])
    assert h_s.extra["obs/tx_energy"] == h_l.extra["obs/tx_energy"]


# ---------------------------------------------------------------------------
# the LLM trainer
# ---------------------------------------------------------------------------

def test_llm_trainer_telemetry_matches_jax_and_off_is_bitwise():
    """Reduced granite-8b (f32, W = 4, 2 sgd steps), 2 rounds with
    telemetry on JAX's draws against JAX's jitted rounds: the same obs/ key
    set, values within the replay tolerance, the Θ-update norm from the
    trainer's fallback.  Port against port, telemetry off is the same
    state bit for bit."""
    from test_torch_llm_robust import W, _configs, _jax_cfg, _tokens
    from test_torch_llm_robust import _port_trainer

    from repro.models import registry as jreg
    from repro.train import llm_trainer as jtrainer
    from torch_replay import llm_round_draws, llm_state

    jcfg = _jax_cfg()
    jacfg, jccfg, _, _ = _configs()
    flcfg = jtrainer.FLConfig(mode="replicated", n_workers=W, local_steps=2,
                              local_lr=1e-2, telemetry=True)
    init_fn, step = jtrainer.make_fl_train(jreg.build_model(jcfg), flcfg,
                                           jacfg, jccfg)
    step = jax.jit(step)
    tokens = _tokens(jcfg, W)
    # jitted: the same draws as the eager init, in a third of its time
    st_j = jax.jit(init_fn)(KEY)
    ports = {tel: _port_trainer(jcfg, dict(telemetry=tel))[1]
             for tel in (None, True)}
    sts = {tel: llm_state(st_j) for tel in ports}
    batch = {"tokens": torch.from_numpy(tokens)}
    for r in range(2):
        key = jax.random.fold_in(KEY, r)
        draws = llm_round_draws(key, st_j, jccfg)
        st_j, m_j = step(st_j, {"tokens": jnp.asarray(tokens)}, key)
        ms = {}
        for tel, stp in ports.items():
            sts[tel], ms[tel] = stp(sts[tel], batch, draws=draws)
        obs_j = sorted(k for k in m_j if k.startswith("obs/"))
        assert sorted(k for k in ms[True] if k.startswith("obs/")) == obs_j
        for k in obs_j:
            _close(ms[True][k], m_j[k], f"round {r} {k}")
        assert not any(k.startswith("obs/") for k in ms[None])
        for k in ms[None]:
            assert torch.equal(ms[None][k], ms[True][k]), k
    from repro_torch.tree import tree_leaves
    assert torch.equal(sts[None].lam.re, sts[True].lam.re)
    for a, b in zip(tree_leaves(sts[None].Theta),
                    tree_leaves(sts[True].Theta)):
        assert torch.equal(a, b)
    assert "obs/theta_update_norm" in obs_j and "obs/tx_energy" in obs_j


def test_leafwise_llm_state_refuses_telemetry():
    from repro_torch.models import get_model
    from repro_torch.train.llm_trainer import FLConfig, make_fl_train
    with pytest.raises(ValueError, match="packed state layout"):
        make_fl_train(get_model("granite-8b", reduced=True),
                      FLConfig(n_workers=2, telemetry=True,
                               packed_uplink=False), AdmmConfig(),
                      ChannelConfig(n_workers=2), device="cpu")


# ---------------------------------------------------------------------------
# sink, validate, report (the reference's cases)
# ---------------------------------------------------------------------------

def test_sink_roundtrip_resume_append(tmp_path):
    rd = str(tmp_path / "run")
    with MetricsSink(rd) as sink:
        sink.write_manifest(run_manifest(test="roundtrip"))
        for r in range(3):
            sink.log_round(r, {"loss": torch.tensor(1.0 / (r + 1)),
                               "obs/tx_energy": torch.tensor([1.0, 2.0]),
                               "bad": float("nan"), "_private": 7.0})
        sink.log_block(2, 0.5, 3)
    man0 = json.load(open(os.path.join(rd, "manifest.json")))
    assert man0["torch_version"] == torch.__version__
    with MetricsSink(rd, resume=True) as sink:
        sink.write_manifest(run_manifest(test="CLOBBER"))
        sink.log_resume(3)
        for r in range(3, 5):
            sink.log_round(r, {"loss": 0.1})
        sink.log_done(5, 1.0)
    assert json.load(open(os.path.join(rd, "manifest.json"))) == man0
    evs = read_events(rd)
    assert [e["round"] for e in evs if e["event"] == "round"] == \
        [0, 1, 2, 3, 4]
    assert [e["event"] for e in evs].count("resume") == 1
    r0 = next(e for e in evs if e["event"] == "round")
    assert r0["metrics"]["bad"] is None            # non-finite -> null
    assert r0["metrics"]["obs/tx_energy"] == [1.0, 2.0]
    assert "_private" not in r0["metrics"]
    assert validate_run_dir(rd) == []
    assert jvalidate.validate_run_dir(rd) == []    # JAX's own linter


def test_sink_log_rounds_emits_every_round(tmp_path):
    rd = str(tmp_path / "run")
    with MetricsSink(rd) as sink:
        sink.write_manifest({"x": 1})
        sink.log_rounds(10, {"loss": torch.tensor([3.0, 2.0, 1.0]),
                             "obs/tx_energy": torch.ones(3, 2),
                             "_fault_aux": torch.zeros(3)})
    evs = [e for e in read_events(rd) if e["event"] == "round"]
    assert [e["round"] for e in evs] == [10, 11, 12]
    assert evs[2]["metrics"]["loss"] == 1.0
    assert all("_fault_aux" not in e["metrics"] for e in evs)


def test_validate_catches_schema_violations(tmp_path):
    good = tmp_path / "BENCH_good.json"
    good.write_text(json.dumps({"optimised_metric": "x", "x": 1.5}))
    assert validate_bench(str(good)) == []
    bad = tmp_path / "BENCH_bad.json"
    bad.write_text(json.dumps({"optimised_metric": "nope", "x": 1.5}))
    assert validate_bench(str(bad))
    bad2 = tmp_path / "BENCH_bad2.json"
    bad2.write_text(json.dumps({"x": 1.5}))
    assert validate_bench(str(bad2))
    rd = tmp_path / "run"
    rd.mkdir()
    (rd / "manifest.json").write_text("{}")
    (rd / "metrics.jsonl").write_text(
        '{"event": "round", "round": 0, "metrics": {"loss": 1.0}}\n'
        '{"event": "party"}\n'
        '{"event": "round", "round": 1, "metrics": {"_leak": 1.0}}\n')
    errs = validate_run_dir(str(rd))
    assert any("party" in e for e in errs) and any("_leak" in e for e in errs)
    assert errs == jvalidate.validate_run_dir(str(rd))


def test_report_summarises_runs(tmp_path, capsys):
    rd = str(tmp_path / "run")
    with MetricsSink(rd) as sink:
        sink.write_manifest({"arch": "toy"})
        for r in range(5):
            sink.log_round(r, {"loss": 5.0 - r, "obs/rx_snr_db": 40.0 + r,
                               "participation": 1.0})
    text = "\n".join(report.summarise(rd, report.DEFAULT_KEYS))
    assert "5 rounds" in text and "loss" in text and "obs/rx_snr_db" in text
    assert report.main([rd]) == 0
    capsys.readouterr()
    assert report.main([rd, "--csv"]) == 0
    csv = capsys.readouterr().out.strip().splitlines()
    assert len(csv) == 6 and csv[0].startswith("run,round,loss")


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def test_profiling_trace_spans_and_refused_compile_report(tmp_path):
    with profiling.trace_session(None) as sess:
        pass
    assert sess.path is None
    timer = profiling.SpanTimer()
    with profiling.trace_session(str(tmp_path / "trace")) as sess:
        with timer.span("execute"):
            with profiling.annotate("block"):
                torch.ones(64).sum()
    assert sess.error is None and os.path.isfile(sess.path)
    assert json.load(open(sess.path))["traceEvents"]
    timer.add("execute", 0.5)
    assert timer.summary()["execute"]["count"] == 2.0
    assert len(timer.series["execute"]) == 2
    with pytest.raises(NotImplementedError, match="no HLO"):
        profiling.compile_report("HloModule m")
    assert math.isfinite(timer.summary()["execute"]["seconds"])
