"""The torch twins of the paper's figures (``repro_torch.benchmarks``) against
the JAX package's ``benchmarks/`` at the FAST scale, on JAX's data and with
every round's random planes replayed into the twin's ``train``: fig2a's
rounds and channel uses to the 1e-4 gap, fig5's gaps after the budget, and
fig3a's accuracies.  This is the main path's "derived numbers agree with the
reference" check."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import benchmarks.common as jcommon  # noqa: E402
from benchmarks import fig2_linreg as jfig2  # noqa: E402
from benchmarks import fig3_classification as jfig3  # noqa: E402
from benchmarks import fig5_rho as jfig5  # noqa: E402
from repro.data.federated import split_iid as jsplit_iid  # noqa: E402
from repro.data.synthetic import image_dataset as jimages  # noqa: E402
from repro.data.synthetic import linreg_dataset as jlinreg  # noqa: E402

from repro_torch.benchmarks import (ablation_noniid, common,  # noqa: E402
                                    fig2_linreg, fig5_rho)
from repro_torch.benchmarks import fig3_classification  # noqa: E402
from repro_torch.benchmarks import roofline  # noqa: E402
from repro_torch.benchmarks import run as bench_run  # noqa: E402
from repro_torch.train.fl_trainer import train  # noqa: E402

from torch_replay import one_thread, replay, t  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

#: the optimality gap cancels to a few ulps of f* ≈ 2.5e-3 (2.3e-10 each)
#: near the optimum; the rest is solve and sum order over 300 rounds
GAP_TOL = dict(rtol=1e-3, atol=1e-8)
#: fig3a: 800 test images, so one image is 0.00125 of accuracy; replayed
#: draws and minibatches leave float-order differences over 25 rounds of
#: Adam: |port − JAX| ≤ 0.02 (16 images), set before the first run
ACC_BAND = 0.02


def replaying_train(jkey, batch_idx=None):
    """The twin's ``train`` with the run's initial state and draws from
    JAX's key ``jkey`` (``batch_idx(name, r)``: round r's minibatch indices
    of algorithm ``name``)."""
    def run(alg, theta0, solver, grad_fn, rounds, key, **kw):
        init_state, draws = replay(
            alg, theta0, jkey,
            None if batch_idx is None else (lambda r: batch_idx(alg.name,
                                                                r)))
        return train(alg, theta0, solver, grad_fn, rounds, key,
                     init_state=init_state, draws=draws, **kw)
    return run


def _linreg_task_of_jax(key):
    X, y, _ = jlinreg(key, 2000, 6)
    return common.linreg_task(t(X), t(y),
                              t(jcommon.make_linreg_task(key).theta0))


def test_fig2a_twin_gives_jax_derived_numbers(monkeypatch):
    want = jfig2.fig2a_comm_efficiency()
    task = _linreg_task_of_jax(jfig2.KEY)
    monkeypatch.setattr(fig2_linreg, "make_linreg_task",
                        lambda key, **kw: task)
    monkeypatch.setattr(fig2_linreg, "train", replaying_train(
        jax.random.fold_in(jfig2.KEY, 1)))
    got = fig2_linreg.fig2a_comm_efficiency(device="cpu")
    assert set(got) == set(want) == {"afadmm", "dfadmm", "dfadmm-10x",
                                     "analog_gd"}
    for row in want:
        for k in ("rounds_to_1e-4", "channel_uses_to_1e-4"):
            assert got[row][k] == want[row][k], (row, k, got, want)
        np.testing.assert_allclose(got[row]["final_loss"],
                                   want[row]["final_loss"], err_msg=row,
                                   **GAP_TOL)
    # the paper's ranking: A-FADMM needs the fewest channel uses; A-GD stalls
    assert got["afadmm"]["channel_uses_to_1e-4"] < \
        got["dfadmm"]["channel_uses_to_1e-4"]
    assert got["analog_gd"]["rounds_to_1e-4"] is None


def test_fig5_twin_gives_jax_gaps(monkeypatch):
    want = jfig5.fig5_rho_sensitivity()
    task = _linreg_task_of_jax(jfig5.KEY)
    monkeypatch.setattr(fig5_rho, "make_linreg_task", lambda key, **kw: task)
    monkeypatch.setattr(fig5_rho, "train", replaying_train(
        jax.random.fold_in(jfig5.KEY, 1)))
    got = fig5_rho.fig5_rho_sensitivity(device="cpu")
    assert set(got) == set(want) == {"rho_0.1", "rho_0.5", "rho_2"}
    for row in want:
        np.testing.assert_allclose(got[row]["loss_at_budget"],
                                   want[row]["loss_at_budget"], err_msg=row,
                                   **GAP_TOL)


def test_fig3a_twin_accuracies_within_the_band(monkeypatch):
    """JAX's MLP task draws a minibatch each time its ``grad_fn`` is traced
    (``benchmarks/common.py`` advances a host counter in ``sample``): its
    compiled driver traces each algorithm's rounds once for the blocks of
    10 rounds (0–19) and once for the last block of 5 (20–24), so
    algorithm j (in fig3a's order) trains every local step of rounds 0–19
    on counter 2j + 1 and of rounds 20–24 on 2j + 2.  The replay follows
    that schedule, and the count of draws is checked."""
    drawn = []
    make_batch_fn = jcommon.make_batch_fn

    def counting_make_batch_fn(*a, **kw):
        fn = make_batch_fn(*a, **kw)
        return lambda key, step: (drawn.append(1), fn(key, step))[1]

    monkeypatch.setattr(jcommon, "make_batch_fn", counting_make_batch_fn)
    want = jfig3.fig3a_comm_efficiency()
    assert len(drawn) == 6

    key = jfig3.KEY
    scale = common.FAST_SCALE
    n_train, n_test = scale.mlp_samples
    W, B, n_steps = scale.mlp_workers, 100, scale.mlp_local_iters
    xtr, ytr, xte, yte = jimages(key, n_train, n_test, dim=scale.mlp_sizes[0],
                                 cluster_std=3.0)
    shards = jsplit_iid(jax.random.fold_in(key, 1), n_train, W)
    theta0 = jcommon.make_mlp_task(key).theta0
    task = common.mlp_task((t(xtr), t(ytr), t(xte), t(yte)), t(shards),
                           t(theta0), scale.mlp_sizes, local_iters=n_steps,
                           batch=B)
    order = ("afadmm", "dfadmm", "analog_gd")
    per = shards.shape[1]

    def batch_idx(name, r):
        i = 2 * order.index(name) + 1 + (r >= 20)
        idx = t(jax.random.randint(jax.random.fold_in(key, 10_000 + i),
                                   (W, B), 0, per)).long()
        return idx if name == "analog_gd" else idx.expand(n_steps, W, B)

    monkeypatch.setattr(fig3_classification, "make_mlp_task",
                        lambda key, **kw: task)
    monkeypatch.setattr(fig3_classification, "train", replaying_train(
        jax.random.fold_in(key, 1), batch_idx))
    got = fig3_classification.fig3a_comm_efficiency(device="cpu")
    assert set(got) == set(want) == {"A-SAFADMM", "dfadmm", "analog_gd"}
    for row in want:
        assert abs(got[row]["final_accuracy"]
                   - want[row]["final_accuracy"]) <= ACC_BAND, (row, got,
                                                                want)
        assert got[row]["uploads"] == pytest.approx(want[row]["uploads"],
                                                    rel=1e-9)


def test_run_cli_names_and_refusals(capsys, monkeypatch, tmp_path):
    """``run.py`` offers JAX's names, and the twin of JAX's stand-alone
    ``benchmarks/scaleup.py`` as ``scaleup``; none is refused any more:
    ``kernels_microbench`` runs its twin's B1 section."""
    assert set(bench_run._benchmarks()) == {
        "ablation_noniid", "ablation_decentralized", "fig2a_comm_efficiency",
        "fig2b_energy", "fig2c_scalability", "fig3a_comm_efficiency",
        "fig3b_energy", "fig3c_scalability", "fig5_rho_sensitivity",
        "serve_microbench", "kernels_microbench", "transport_microbench",
        "roofline_summary", "scaleup"}
    assert bench_run.main(["--only", "kernels_microbench", "--device",
                           "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert out[1].startswith("kernels_microbench,")
    assert not out[1].startswith("kernels_microbench,-1,")
    assert json.loads(out[1].split(",", 2)[2])["n_elements"] == 1 << 20
    # the roofline twin reads the dry run's results (none here)
    monkeypatch.setattr(roofline, "RESULTS_DIR", str(tmp_path))
    assert bench_run.main(["--only", "roofline", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[1].startswith("roofline_summary,")
    assert json.loads(out[1].split(",", 2)[2]) == {"n_results": 0}


def test_ota_backend_knob(monkeypatch):
    """``REPRO_OTA_BACKEND``: "pallas" is the port's route, "jnp" is
    refused by name."""
    task = common.make_linreg_task(0, n_workers=4, n_samples=80,
                                   device="cpu")
    monkeypatch.setenv("REPRO_OTA_BACKEND", "pallas")
    alg, _ = common.linreg_algorithm("afadmm", task)
    assert alg.name == "afadmm"
    monkeypatch.setenv("REPRO_OTA_BACKEND", "jnp")
    with pytest.raises(ValueError, match="'jnp'"):
        common.linreg_algorithm("afadmm", task)
    # the other algorithms never took a transport backend
    assert common.linreg_algorithm("dfadmm", task)[0].name == "dfadmm"


def test_ablation_noniid_runs_on_the_cpu():
    out = ablation_noniid.ablation_noniid(rounds=2, device="cpu")
    assert set(out) == {"iid", "dirichlet0.3"}
    for row in out.values():
        assert set(row) == {"afadmm", "analog_gd"}
        assert all(0.0 <= a <= 1.0 for a in row.values())
